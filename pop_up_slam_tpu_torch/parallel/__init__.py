"""Multi-device strategies on ``torch.distributed`` (port of
``pop_up_slam_tpu/parallel``): factor-sharded, landmark-block and
keyframe-block Gauss-Newton, the data-parallel pop-up, and process
bring-up."""

from .distributed import (
    distributed_gn_solve,
    make_mesh,
    pad_factors_for_sharding,
    sharded_linearize,
    sharded_popup,
)
from .keyframe_blocks import (
    keyframe_sharded_gn_solve,
    keyframe_sharded_linearize,
    route_factors_by_keyframe,
)
from .map_blocks import map_block_gn_solve, partition_plane_factors
from .multihost import flat_mesh_axis, init_distributed, make_host_mesh

__all__ = [
    "make_mesh",
    "pad_factors_for_sharding",
    "sharded_linearize",
    "distributed_gn_solve",
    "sharded_popup",
    "map_block_gn_solve",
    "partition_plane_factors",
    "keyframe_sharded_gn_solve",
    "keyframe_sharded_linearize",
    "route_factors_by_keyframe",
    "flat_mesh_axis",
    "init_distributed",
    "make_host_mesh",
]
