from .batched import (  # noqa: F401
    dead_reckon,
    make_batched_runner,
    run_sequence_batched,
)
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
from .pipelined import make_stages, run_pipelined  # noqa: F401
from .sharded import (  # noqa: F401
    make_distributed_solve,
    make_sharded_runner,
    run_sequence_sharded,
)
