"""TUM RGB-D dataset IO: sequence loading, association, trajectory IO.

Port of ``pop_up_slam_tpu/io/tum.py`` (numpy only): plain files, no
middleware.  PNGs are decoded by the port's native codec
(:mod:`.native_loader`, zlib only), as the reference's ``load_image``
routes to its native runtime.

A TUM sequence directory contains ``rgb.txt`` / ``depth.txt`` /
``groundtruth.txt`` index files (lines: ``timestamp path...`` or
``timestamp tx ty tz qx qy qz qw``) and the referenced PNGs.  The
camera intrinsics of the freiburg3 sequences (fr3_structure_notexture_*)
are the standard ROS-calibrated values below.

Ground segmentation: (a) precomputed mask PNGs in a ``seg/``
subdirectory (same filenames as rgb frames), or (b) the classical
floor-color segmenter in :mod:`pop_up_slam_tpu_torch.models.segmentation`
as fallback.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np

from ..evaluation.ate import associate
from . import native_loader

# Standard TUM freiburg intrinsics (ROS default calibration).
FR1_INTRINSICS = (517.3, 516.5, 318.6, 255.3)
FR2_INTRINSICS = (520.9, 521.0, 325.1, 249.7)
FR3_INTRINSICS = (535.4, 539.2, 320.1, 247.6)


class StampedPoses(NamedTuple):
    stamps: np.ndarray   # (N,) float64
    t: np.ndarray        # (N, 3)
    q: np.ndarray        # (N, 4) quaternion (x, y, z, w) — TUM order


class TumSequence(NamedTuple):
    root: str
    rgb_stamps: np.ndarray
    rgb_files: list
    depth_stamps: np.ndarray
    depth_files: list
    gt: StampedPoses | None
    seg_files: list | None   # aligned with rgb_files, or None


def _read_index(path: str):
    stamps, rest = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            stamps.append(float(parts[0]))
            rest.append(parts[1:])
    return np.asarray(stamps, np.float64), rest


def load_sequence(root: str) -> TumSequence:
    rgb_stamps, rgb_rest = _read_index(os.path.join(root, "rgb.txt"))
    rgb_files = [r[0] for r in rgb_rest]

    depth_path = os.path.join(root, "depth.txt")
    if os.path.exists(depth_path):
        depth_stamps, depth_rest = _read_index(depth_path)
        depth_files = [r[0] for r in depth_rest]
    else:
        depth_stamps, depth_files = np.zeros((0,)), []

    gt = None
    gt_path = os.path.join(root, "groundtruth.txt")
    if os.path.exists(gt_path):
        gt_stamps, gt_rest = _read_index(gt_path)
        vals = np.asarray([[float(x) for x in r] for r in gt_rest])
        gt = StampedPoses(gt_stamps, vals[:, :3], vals[:, 3:7])

    seg_dir = os.path.join(root, "seg")
    seg_files = None
    if os.path.isdir(seg_dir):
        seg_files = []
        for f in rgb_files:
            cand = os.path.join("seg", os.path.basename(f))
            seg_files.append(
                cand if os.path.exists(os.path.join(root, cand)) else None
            )
    return TumSequence(root, rgb_stamps, rgb_files, depth_stamps,
                       depth_files, gt, seg_files)


def load_image(seq: TumSequence, rel_path: str) -> np.ndarray:
    """Decode one frame: (H, W, 3) uint8 RGB, (H, W) uint8 gray or
    (H, W) uint16 depth."""
    return native_loader.decode_png(os.path.join(seq.root, rel_path))


def load_depth(seq: TumSequence, rel_path: str) -> np.ndarray:
    """TUM depth PNGs are uint16 with scale 5000 counts/m."""
    raw = load_image(seq, rel_path)
    return raw.astype(np.float32) / 5000.0


def quat_to_rotmat_np(q_xyzw: np.ndarray) -> np.ndarray:
    """TUM-order quaternion (x, y, z, w) -> rotation matrix, numpy."""
    x, y, z, w = (q_xyzw[..., 0], q_xyzw[..., 1],
                  q_xyzw[..., 2], q_xyzw[..., 3])
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
        ],
        -2,
    )


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> TUM-order quaternion (x, y, z, w), numpy."""
    w = np.sqrt(np.maximum(0.0, 1.0 + R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])) / 2.0
    w = np.maximum(w, 1e-12)
    x = (R[..., 2, 1] - R[..., 1, 2]) / (4 * w)
    y = (R[..., 0, 2] - R[..., 2, 0]) / (4 * w)
    z = (R[..., 1, 0] - R[..., 0, 1]) / (4 * w)
    return np.stack([x, y, z, w], axis=-1)


def gt_poses_at(seq: TumSequence, stamps: np.ndarray,
                max_difference: float = 0.02):
    """Interpolation-free gt lookup: nearest-stamp association.

    Returns (idx_pairs, R (M,3,3), t (M,3)) for matched frames.
    """
    assert seq.gt is not None
    pairs = associate(stamps, seq.gt.stamps, max_difference)
    if not pairs:
        return [], np.zeros((0, 3, 3)), np.zeros((0, 3))
    ii = [j for _, j in pairs]
    R = quat_to_rotmat_np(seq.gt.q[ii])
    t = seq.gt.t[ii]
    return pairs, R, t


def write_trajectory(path: str, stamps, R_wc, t_wc) -> None:
    """Write a TUM-format stamped trajectory (timestamp tx ty tz qx qy qz qw)."""
    R_wc = np.asarray(R_wc)
    t_wc = np.asarray(t_wc)
    q = rotmat_to_quat_np(R_wc)
    with open(path, "w") as f:
        for s, t, qi in zip(stamps, t_wc, q):
            f.write(
                f"{s:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                f"{qi[0]:.6f} {qi[1]:.6f} {qi[2]:.6f} {qi[3]:.6f}\n"
            )


def read_trajectory(path: str) -> StampedPoses:
    stamps, rest = _read_index(path)
    vals = np.asarray([[float(x) for x in r] for r in rest])
    return StampedPoses(stamps, vals[:, :3], vals[:, 3:7])
