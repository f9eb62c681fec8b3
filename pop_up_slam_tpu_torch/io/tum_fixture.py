"""Write TUM-RGBD-format sequence directories.

Port of ``pop_up_slam_tpu/io/tum_fixture.py``, split in two:

- :func:`write_tum_tree` writes a tree from given ground masks, poses
  and stamps;
- :func:`write_tum_fixture` renders the synthetic corridor (or room
  orbit) with the port's renderer and writes it through
  :func:`write_tum_tree`.

The layout is TUM's::

    root/
      rgb.txt   depth.txt   groundtruth.txt
      rgb/<stamp>.png       (8-bit RGB)
      depth/<stamp>.png     (16-bit, 5000 counts/m)
      seg/<stamp>.png       (optional precomputed ground masks, 0/255)

so ``io.tum.load_sequence`` and ``runners.tum_runner.run_tum_sequence``
run the real-data code path end to end.  PNGs go through the port's
native codec (:mod:`.native_loader`), as the reference's writer does.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .native_loader import encode_png as write_png
from .tum import rotmat_to_quat_np

# the flat colors of a frame written without rgb (render_rgb's floor and
# wall colors, no noise)
_FLOOR_RGB8 = (77, 61, 51)
_WALL_RGB8 = (209, 204, 191)


def write_tum_tree(root: str, masks, R_wc, t_wc, stamps, rgb=None,
                   depth=None, write_seg: bool = True,
                   gt_stamp_jitter: float = 0.004) -> None:
    """Write a TUM tree from per-frame ground ``masks`` (N, H, W) bool,
    ground-truth poses ``R_wc`` (N, 3, 3), ``t_wc`` (N, 3) and frame
    ``stamps`` (N,).  ``rgb`` (N, H, W, 3) uint8 defaults to the flat
    floor color on the mask and the wall color elsewhere; ``depth`` (N,
    H, W) uint16 (5000 counts/m) is written with ``depth.txt`` when
    given.  Ground-truth stamps are the frame stamps plus
    ``gt_stamp_jitter``, so the nearest-stamp association is exercised.
    """
    masks = np.asarray(masks, bool)
    stamps = np.asarray(stamps, np.float64)
    dirs = ["rgb"] + (["depth"] if depth is not None else []) + (
        ["seg"] if write_seg else [])
    for d in dirs:
        os.makedirs(os.path.join(root, d), exist_ok=True)
    rgb_lines, depth_lines = [], []
    for i, s in enumerate(stamps):
        name = f"{s:.6f}.png"
        if rgb is not None:
            img = np.asarray(rgb[i], np.uint8)
        else:
            img = np.where(masks[i][..., None], np.uint8(_FLOOR_RGB8),
                           np.uint8(_WALL_RGB8))
        write_png(os.path.join(root, "rgb", name), img)
        rgb_lines.append(f"{s:.6f} rgb/{name}")
        if depth is not None:
            write_png(os.path.join(root, "depth", name),
                      np.asarray(depth[i], np.uint16))
            depth_lines.append(f"{s:.6f} depth/{name}")
        if write_seg:
            write_png(os.path.join(root, "seg", name),
                      masks[i].astype(np.uint8) * np.uint8(255))

    def _index(path, header, lines):
        with open(os.path.join(root, path), "w") as f:
            f.write(f"# {header}\n# synthetic corridor fixture\n")
            f.write("\n".join(lines) + "\n")

    _index("rgb.txt", "color images", rgb_lines)
    if depth is not None:
        _index("depth.txt", "depth maps", depth_lines)
    R_np = np.asarray(R_wc, np.float32)
    t_np = np.asarray(t_wc, np.float32)
    q = rotmat_to_quat_np(R_np)
    _index("groundtruth.txt", "ground truth trajectory", [
        f"{gs:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
        f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}"
        for gs, t, qi in zip(stamps + gt_stamp_jitter, t_np, q)])


def write_tum_fixture(
    root: str,
    n_frames: int = 24,
    height: int = 120,
    width: int = 160,
    fx: float = 120.0,
    fy: float = 120.0,
    seed: int = 0,
    write_seg: bool = True,
    write_depth: bool = True,
    fps: float = 30.0,
    gt_stamp_jitter: float = 0.004,
    scene: str = "corridor",
    device=None,
):
    """Render and write a TUM-format synthetic sequence, rendering on
    ``device`` (CUDA unless ``"cpu"`` is given).

    Returns a dict with the camera intrinsics and ground-truth poses
    (``R_wc`` (N,3,3), ``t_wc`` (N,3), ``stamps`` (N,)).  ``scene``:
    ``"corridor"`` (the straight swaying corridor walk) or
    ``"room_orbit"`` (a slow 1.5-pi turn inside a square room).  The rgb
    noise is drawn from a ``torch.Generator`` seeded with ``seed``: the
    reference's frames come from ``jax.random`` and differ in it.
    """
    from .._device import resolve_device
    from ..geometry.camera import Intrinsics
    from . import synthetic

    dev = resolve_device(device)
    cx, cy = width / 2.0, height / 2.0
    K = Intrinsics.create(fx, fy, cx, cy, device=dev)
    if scene == "corridor":
        world = synthetic.corridor_world(device=dev)
        Rs, ts = synthetic.corridor_trajectory(n_frames, sway=0.3,
                                               device=dev)
    elif scene == "room_orbit":
        s = 4.0
        world = synthetic.make_world(
            [((-s, -s), (s, -s)), ((s, -s), (s, s)),
             ((s, s), (-s, s)), ((-s, s), (-s, -s))],
            heights=2.5, device=dev)
        Rs, ts = synthetic.orbit_trajectory(n_frames, radius=0.8,
                                            cam_height=1.0, device=dev)
    else:
        raise ValueError(f"unknown scene {scene!r}")
    gen = torch.Generator().manual_seed(seed)
    labels, depth, rgb8 = [], [], []
    for i in range(n_frames):
        lab, dep = synthetic.render_frame(K, Rs[i], ts[i], world, height,
                                          width)
        rgb = synthetic.render_rgb(lab, generator=gen)
        labels.append(lab.cpu().numpy())
        depth.append(dep.cpu().numpy())
        rgb8.append((rgb.cpu().numpy() * 255.0 + 0.5).astype(np.uint8))
    labels = np.stack(labels)
    stamps = 1000.0 + np.arange(n_frames) / fps
    d16 = (np.clip(np.stack(depth) * 5000.0, 0, 65535).astype(np.uint16)
           if write_depth else None)
    R_np, t_np = Rs.cpu().numpy(), ts.cpu().numpy()
    write_tum_tree(root, labels == synthetic.LABEL_GROUND, R_np, t_np,
                   stamps, rgb=np.stack(rgb8), depth=d16,
                   write_seg=write_seg, gt_stamp_jitter=gt_stamp_jitter)
    return {
        "fx": fx, "fy": fy, "cx": cx, "cy": cy,
        "height": height, "width": width,
        "R_wc": R_np, "t_wc": t_np, "stamps": stamps,
    }
