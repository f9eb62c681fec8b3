from .offline import (  # noqa: F401
    make_chunked_runner,
    make_frame_fn,
    run_sequence_chunked,
    run_sequence_with,
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
