from .offline import (  # noqa: F401
    FusedVOState,
    VOState,
    fused_vo_init,
    make_chunked_fused_vo_runner,
    make_chunked_runner,
    make_chunked_vo_runner,
    make_frame_fn,
    make_fused_vo_frame_fn,
    make_vo_frame_fn,
    run_masks_chunked,
    run_sequence_chunked,
    run_sequence_with,
    vo_init,
)
from .slam import (  # noqa: F401
    FrameDetections,
    SlamConfig,
    SlamState,
    current_pose,
    detections_from_popup,
    slam_init,
    slam_step,
)
