from .export import (
    depth_to_pointcloud,
    plane_map_to_meshes,
    plot_topdown,
    write_ply,
)

__all__ = [
    "plane_map_to_meshes",
    "write_ply",
    "depth_to_pointcloud",
    "plot_topdown",
]
