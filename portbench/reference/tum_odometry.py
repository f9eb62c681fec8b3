"""The TUM runner's ``gt_perturb`` odometry, worked out again.

Reads the tree's ``rgb.txt`` and ``groundtruth.txt`` (the files the
program reads), associates each frame with the nearest ground-truth
stamp (TUM's greedy association, within 0.02 s), and forms frame k's
odometry as the runner documents it: the ground-truth relative pose
composed with exp(xi), xi = (N(0, sigma_t) x3, N(0, sigma_r) x3) drawn
in frame order from numpy's ``default_rng(seed)``; exp in f32.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from .geometry import se3


class GroundTruth(NamedTuple):
    R: np.ndarray     # (N, 3, 3) f64, one per associated frame
    t: np.ndarray     # (N, 3)


def _read(path: str):
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


def _associate(a, b, max_difference: float = 0.02):
    diffs = np.abs(a[:, None] - b[None, :])
    cand = np.argwhere(diffs < max_difference)
    order = np.argsort(diffs[cand[:, 0], cand[:, 1]])
    used_a, used_b, out = set(), set(), []
    for k in order:
        i, j = int(cand[k, 0]), int(cand[k, 1])
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    return sorted(out)


def _rotmat(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                  2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                  2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                  1 - 2 * (x * x + y * y)], -1)], -2)


def load_ground_truth(root: str) -> GroundTruth:
    rgb_stamps, _ = _read(os.path.join(root, "rgb.txt"))
    gt_stamps, rest = _read(os.path.join(root, "groundtruth.txt"))
    vals = np.asarray([[float(x) for x in r] for r in rest])
    pairs = _associate(rgb_stamps, gt_stamps)
    jj = [j for _, j in pairs]
    return GroundTruth(_rotmat(vals[jj, 3:7]), vals[jj, :3])


def odometry_at(gt: GroundTruth, seed: int, k: int, sigma_t: float,
                sigma_r: float):
    """Frame k's odometry (k >= 1) as f32 tensors (R (3, 3), t (3,))."""
    rng = np.random.default_rng(seed)
    for _ in range(k - 1):
        rng.normal(0, sigma_t, 3)
        rng.normal(0, sigma_r, 3)
    xi = np.concatenate([rng.normal(0, sigma_t, 3),
                         rng.normal(0, sigma_r, 3)])
    Ra, ta, Rb, tb = gt.R[k - 1], gt.t[k - 1], gt.R[k], gt.t[k]
    Rrel = Ra.T @ Rb
    trel = Ra.T @ (tb - ta)
    dR, dt = (x.numpy() for x in se3.se3_exp(
        torch.as_tensor(xi, dtype=torch.float32)))
    Rrel, trel = Rrel @ dR, Rrel @ dt + trel
    return (torch.as_tensor(np.asarray(Rrel, np.float32)),
            torch.as_tensor(np.asarray(trel, np.float32)))
