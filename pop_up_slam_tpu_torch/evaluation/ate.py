"""TUM-protocol trajectory evaluation: ATE (Horn alignment) and RPE.

The port's own copy of ``pop_up_slam_tpu/evaluation/ate.py`` (numpy
only; the port imports nothing of the JAX package).  The standard TUM
RGB-D tooling (associate.py / evaluate_ate.py style), vectorized numpy:

- timestamp association with a max-difference window,
- closed-form Horn/Umeyama SE(3) (or Sim(3) for monocular scale)
  alignment,
- ATE RMSE of translational residuals, RPE over fixed delta.

Kept numpy-friendly (works on python lists of stamped poses) because it
runs on host at end of sequence, not in the jit hot loop.
"""

from __future__ import annotations

import numpy as np


def associate(stamps_a, stamps_b, max_difference: float = 0.02):
    """Greedy nearest-timestamp association, mirroring TUM associate.py.

    Returns list of index pairs (i, j) with |ta - tb| < max_difference,
    each index used at most once, best matches first.
    """
    stamps_a = np.asarray(stamps_a, dtype=np.float64)
    stamps_b = np.asarray(stamps_b, dtype=np.float64)
    diffs = np.abs(stamps_a[:, None] - stamps_b[None, :])
    cand = np.argwhere(diffs < max_difference)
    if cand.size == 0:
        return []
    order = np.argsort(diffs[cand[:, 0], cand[:, 1]])
    used_a, used_b, out = set(), set(), []
    for k in order:
        i, j = int(cand[k, 0]), int(cand[k, 1])
        if i in used_a or j in used_b:
            continue
        used_a.add(i)
        used_b.add(j)
        out.append((i, j))
    out.sort()
    return out


def horn_align(model: np.ndarray, data: np.ndarray, with_scale: bool = False):
    """Closed-form alignment data ≈ s R model + t (Horn/Umeyama).

    model, data: (N, 3).  Returns (s, R, t) minimizing
    sum || data_i - (s R model_i + t) ||^2.
    """
    model = np.asarray(model, dtype=np.float64)
    data = np.asarray(data, dtype=np.float64)
    mu_m = model.mean(axis=0)
    mu_d = data.mean(axis=0)
    mc = model - mu_m
    dc = data - mu_d
    W = dc.T @ mc / model.shape[0]
    U, S, Vt = np.linalg.svd(W)
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1.0
    R = U @ D @ Vt
    if with_scale:
        var_m = (mc ** 2).sum() / model.shape[0]
        s = float(np.trace(np.diag(S) @ D) / max(var_m, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    return s, R, t


def ate_rmse(gt_xyz: np.ndarray, est_xyz: np.ndarray, with_scale: bool = False):
    """Absolute trajectory error RMSE after Horn alignment.

    gt_xyz, est_xyz: (N, 3), already timestamp-associated in order.
    Returns (rmse, aligned_est, (s, R, t)).
    """
    s, R, t = horn_align(est_xyz, gt_xyz, with_scale=with_scale)
    aligned = (s * (R @ np.asarray(est_xyz, dtype=np.float64).T)).T + t
    err = aligned - np.asarray(gt_xyz, dtype=np.float64)
    rmse = float(np.sqrt((err ** 2).sum(axis=1).mean()))
    return rmse, aligned, (s, R, t)


def rpe(gt_T: np.ndarray, est_T: np.ndarray, delta: int = 1):
    """Relative pose error over a fixed frame delta.

    gt_T, est_T: (N, 4, 4) homogeneous pose arrays (world-from-camera).
    Returns (trans_rmse, rot_rmse_rad).
    """
    gt_T = np.asarray(gt_T, dtype=np.float64)
    est_T = np.asarray(est_T, dtype=np.float64)
    n = gt_T.shape[0] - delta
    terrs, rerrs = [], []
    for i in range(n):
        gt_rel = np.linalg.inv(gt_T[i]) @ gt_T[i + delta]
        est_rel = np.linalg.inv(est_T[i]) @ est_T[i + delta]
        E = np.linalg.inv(gt_rel) @ est_rel
        terrs.append(np.linalg.norm(E[:3, 3]))
        c = np.clip((np.trace(E[:3, :3]) - 1.0) / 2.0, -1.0, 1.0)
        rerrs.append(np.arccos(c))
    return float(np.sqrt(np.mean(np.square(terrs)))), float(
        np.sqrt(np.mean(np.square(rerrs)))
    )
