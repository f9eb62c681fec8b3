"""Semi-dense inverse-depth fusion with pop-up plane depth."""

from .depth_fusion import (  # noqa: F401
    DepthFilter,
    align_scale,
    fuse_observation,
    init_from_popup,
    propagate_to_frame,
)
