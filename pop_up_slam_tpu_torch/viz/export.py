"""Map/trajectory visualization and 3D export.

Port of ``pop_up_slam_tpu/viz/export.py``: the reference publishes its
plane map as rviz marker arrays of wall polygons, the optimized path and
the popped-up point cloud; without ROS the equivalents are

- :func:`plane_map_to_meshes` — wall landmarks (plane + ground-line
  extent) -> quad meshes, ground -> one big quad,
- :func:`write_ply` — ASCII PLY of meshes + trajectory polyline +
  optional point cloud (opens in MeshLab/CloudCompare/Open3D),
- :func:`depth_to_pointcloud` — popped depth map -> world-frame cloud,
- :func:`plot_topdown` — matplotlib top-down map (wall segments +
  trajectory) as PNG.

Host-side numpy.  Each function takes numpy arrays or tensors on any
device; a tensor is copied to the host once, at the boundary.
"""

from __future__ import annotations

import numpy as np


def _host(x):
    """``x`` as a host numpy array (a tensor is detached and copied once)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plane_map_to_meshes(
    endpoints_w: np.ndarray,
    valid: np.ndarray,
    wall_height: float = 2.5,
    ground_margin: float = 1.0,
    include_ground: bool = True,
):
    """Wall landmark extents -> (vertices (V, 3), quads (Q, 4), colors).

    endpoints_w: (L, 2, 3) ground-line endpoints per landmark (z=0);
    valid: (L,) bool.  Each wall is a vertical quad from its ground
    line; the ground is one quad spanning the walls' bounding box.
    """
    endpoints_w = _host(endpoints_w).astype(np.float64)
    valid = _host(valid).astype(bool)
    verts, quads, colors = [], [], []
    palette = np.array(
        [
            [230, 88, 55],    # wall colors cycle
            [68, 140, 203],
            [96, 172, 87],
            [222, 168, 62],
            [142, 104, 191],
            [64, 180, 180],
        ],
        np.uint8,
    )
    k = 0
    for l in np.where(valid)[0]:
        e0, e1 = endpoints_w[l, 0], endpoints_w[l, 1]
        if not (np.isfinite(e0).all() and np.isfinite(e1).all()):
            continue
        base = len(verts)
        up = np.array([0.0, 0.0, wall_height])
        verts += [e0, e1, e1 + up, e0 + up]
        quads.append([base, base + 1, base + 2, base + 3])
        colors.append(palette[k % len(palette)])
        k += 1

    if include_ground and verts:
        pts = np.asarray(verts)[:, :2]
        lo = pts.min(axis=0) - ground_margin
        hi = pts.max(axis=0) + ground_margin
        base = len(verts)
        verts += [
            np.array([lo[0], lo[1], 0.0]),
            np.array([hi[0], lo[1], 0.0]),
            np.array([hi[0], hi[1], 0.0]),
            np.array([lo[0], hi[1], 0.0]),
        ]
        quads.append([base, base + 1, base + 2, base + 3])
        colors.append(np.array([120, 120, 120], np.uint8))

    if not verts:
        return (np.zeros((0, 3)), np.zeros((0, 4), int),
                np.zeros((0, 3), np.uint8))
    return np.asarray(verts), np.asarray(quads, int), np.asarray(colors)


def depth_to_pointcloud(
    depth: np.ndarray,
    K,
    R_wc: np.ndarray,
    t_wc: np.ndarray,
    stride: int = 4,
    max_depth: float = 30.0,
):
    """Depth map -> (N, 3) world points (subsampled by ``stride``)."""
    depth = _host(depth)
    H, W = depth.shape
    vs, us = np.mgrid[0:H:stride, 0:W:stride]
    d = depth[vs, us]
    ok = (d > 1e-3) & (d < max_depth)
    fx = float(_host(K.fx))
    fy = float(_host(K.fy))
    cx = float(_host(K.cx))
    cy = float(_host(K.cy))
    x = (us - cx) / fx * d
    y = (vs - cy) / fy * d
    pts_c = np.stack([x[ok], y[ok], d[ok]], axis=-1)
    return pts_c @ _host(R_wc).T + _host(t_wc)


def write_ply(
    path: str,
    vertices: np.ndarray,
    quads: np.ndarray | None = None,
    vertex_colors: np.ndarray | None = None,
    face_colors: np.ndarray | None = None,
    trajectory: np.ndarray | None = None,
    cloud: np.ndarray | None = None,
) -> None:
    """ASCII PLY with faces + a trajectory polyline (as edges) + cloud.

    All geometry is merged into one element table; the trajectory is
    written as ``edge`` elements, faces as quads.
    """
    vertices = _host(vertices).astype(np.float64).reshape(-1, 3)
    quads = (_host(quads).astype(int).reshape(-1, 4)
             if quads is not None else np.zeros((0, 4), int))
    vcol = None
    parts = [vertices]
    cols = []
    if vertex_colors is not None:
        cols.append(_host(vertex_colors).astype(np.uint8).reshape(-1, 3))
    elif face_colors is not None and len(quads):
        fc = _host(face_colors).astype(np.uint8).reshape(-1, 3)
        per_vert = np.zeros((len(vertices), 3), np.uint8)
        for q, c in zip(quads, fc):
            per_vert[q] = c
        cols.append(per_vert)
    else:
        cols.append(np.full((len(vertices), 3), 200, np.uint8))

    traj_edges = np.zeros((0, 2), int)
    if trajectory is not None and len(trajectory) > 1:
        traj = _host(trajectory).astype(np.float64).reshape(-1, 3)
        base = sum(len(p) for p in parts)
        parts.append(traj)
        cols.append(
            np.tile(np.array([255, 32, 32], np.uint8), (len(traj), 1))
        )
        traj_edges = np.stack(
            [np.arange(base, base + len(traj) - 1),
             np.arange(base + 1, base + len(traj))], axis=-1
        )

    if cloud is not None and len(cloud):
        parts.append(_host(cloud).astype(np.float64).reshape(-1, 3))
        cols.append(
            np.tile(np.array([90, 90, 230], np.uint8),
                    (len(parts[-1]), 1))
        )

    allv = np.concatenate(parts) if parts else np.zeros((0, 3))
    allc = np.concatenate(cols) if cols else np.zeros((0, 3), np.uint8)

    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(allv)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\n"
                "property uchar blue\n")
        f.write(f"element face {len(quads)}\n")
        f.write("property list uchar int vertex_indices\n")
        f.write(f"element edge {len(traj_edges)}\n")
        f.write("property int vertex1\nproperty int vertex2\n")
        f.write("end_header\n")
        for p, c in zip(allv, allc):
            f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f} "
                    f"{c[0]} {c[1]} {c[2]}\n")
        for q in quads:
            f.write(f"4 {q[0]} {q[1]} {q[2]} {q[3]}\n")
        for e in traj_edges:
            f.write(f"{e[0]} {e[1]}\n")


def plot_topdown(
    path: str,
    endpoints_w: np.ndarray,
    valid: np.ndarray,
    trajectory: np.ndarray | None = None,
    gt_trajectory: np.ndarray | None = None,
    title: str = "pop_up_slam_tpu map",
) -> None:
    """Top-down (x, y) map PNG: wall ground lines + trajectories.

    Needs matplotlib, imported here; without it this raises
    ``ImportError`` naming the package."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_topdown needs the matplotlib package, "
                          "which is not installed") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    endpoints_w = _host(endpoints_w)
    valid = _host(valid).astype(bool)
    fig, ax = plt.subplots(figsize=(7, 7))
    first = True
    for l in np.where(valid)[0]:
        e = endpoints_w[l]
        ax.plot(e[:, 0], e[:, 1], "-", color="#444444", lw=2.5,
                label="walls" if first else None)
        first = False
    if gt_trajectory is not None:
        gt = _host(gt_trajectory)
        ax.plot(gt[:, 0], gt[:, 1], "--", color="#60ac57", lw=1.5,
                label="ground truth")
    if trajectory is not None:
        tr = _host(trajectory)
        ax.plot(tr[:, 0], tr[:, 1], "-", color="#e65837", lw=1.5,
                label="estimate")
        ax.plot(tr[0, 0], tr[0, 1], "o", color="#e65837", ms=6)
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend(loc="best")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
