from .segmentation import classical_ground_mask  # noqa: F401
