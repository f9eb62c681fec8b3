from .segmentation import (  # noqa: F401
    SegNetLite,
    classical_ground_mask,
    load_pretrained_segnet,
    predict_mask,
)
