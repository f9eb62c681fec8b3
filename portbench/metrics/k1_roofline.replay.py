"""k1_roofline.replay: ``k1_roofline`` in the chunked replay, where it
moves the device time a frame."""

from .k1_roofline import read  # noqa: F401
