"""Frozen copy of the port's ``pipeline/smoothing.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Full-trajectory smoothing: batch GN over the whole keyframe history.

Port of ``pop_up_slam_tpu/pipeline/smoothing.py``.  The sliding window
bounds the active problem, so the incremental trajectory is
filtering-only: poses leaving the window freeze.  This module re-solves
the whole keyframe graph once at the end:

- :class:`TrajectoryRecorder` rides along any frame loop and keeps the
  keyframe history on the host: per-keyframe pose estimates (refreshed
  with the latest in-window BA result every keyframe), the keyframe
  odometry chain, each keyframe's plane measurements and landmark
  assignments, and each frame's (keyframe, relative pose) anchor.
- :func:`smooth_trajectory` rebuilds the full pose graph (all N keyframe
  poses and the persistent landmark map) as one fixed-shape
  Window/Factors problem and re-solves it with ``gn_solve``: the
  closed-form plane terms (the plane-Jacobian kernel on CUDA, once an
  iteration) and the per-op reduced solve ``solve_schur``, as the
  reference's default; with ``mesh=`` it runs keyframe-block-sharded
  over the mesh's ranks (:func:`..parallel.keyframe_sharded_gn_solve`,
  the ``jacfwd`` terms, as the reference's mesh branch).
- :func:`emit_frames` republishes every frame by composing its anchor
  keyframe's smoothed pose with the recorded relative transform.

The batch problem holds a dense (N, N, 6, 6) Hpp, so smoothing is meant
for N up to ~512 keyframes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..factors.graph import (
    Factors,
    OdomFactors,
    PlaneFactors,
    PosePriors,
    Window,
)
from ..solver import gn_solve
from .slam import SlamConfig, _odom_sqrt_info, _plane_sqrt_info

def build_smoothing_problem(
    rec,
    state,
    cfg: SlamConfig,
    pad_multiple: int = 8,
    anchor_info: float | None = None,
):
    """Assemble the full-trajectory Window/Factors from a recorder, on
    the device of ``state``.

    Poses start at the recorder's (filtering) estimates, landmarks at
    the final map's.  Gauge: a strong prior on keyframe 0 at its
    recorded pose.  A factor whose landmark slot was recycled after the
    observation (its creation stamp changed: evicted, or merged away) is
    dropped, as the reference drops it.  Returns (window, factors, N)."""
    N, D = rec.n_kf, rec.D
    NP = -(-N // pad_multiple) * pad_multiple
    L = state.window.max_landmarks
    dev = state.window.t.device
    f32 = torch.float32

    def dev_t(x, dtype=None):
        return torch.as_tensor(x, dtype=dtype).to(dev)

    R = np.broadcast_to(np.eye(3, dtype=np.float32), (NP, 3, 3)).copy()
    t = np.zeros((NP, 3), np.float32)
    R[:N] = np.stack(rec.kf_R)
    t[:N] = np.stack(rec.kf_t)
    window = Window(
        R=dev_t(R), t=dev_t(t),
        planes=state.window.planes.to(f32),
        pose_valid=torch.arange(NP, device=dev) < N,
        pose_fixed=torch.zeros((NP,), dtype=torch.bool, device=dev),
        lm_valid=state.window.lm_valid,
    )

    O = max(N - 1, 1)
    oR = np.broadcast_to(np.eye(3, dtype=np.float32), (O, 3, 3)).copy()
    ot = np.zeros((O, 3), np.float32)
    if rec.odom_R:
        oR[: N - 1] = np.stack(rec.odom_R)
        ot[: N - 1] = np.stack(rec.odom_t)
    i32 = torch.int32
    odom = OdomFactors(
        i=torch.arange(O, dtype=i32, device=dev),
        j=torch.arange(1, O + 1, dtype=i32, device=dev),
        R_meas=dev_t(oR), t_meas=dev_t(ot),
        sqrt_info=_odom_sqrt_info(cfg, f32, dev).expand(O, 6, 6),
        valid=torch.arange(O, device=dev) < N - 1,
    )

    F = N * D
    lm_idx = np.stack(rec.pf_lm).reshape(F)
    valid = np.stack(rec.pf_valid).reshape(F)
    # drop factors whose landmark slot was recycled (evicted/merged)
    # after the observation: the slot's creation stamp changed
    created_now = state.store.created_kf.cpu().numpy().astype(np.int32)
    stamp = np.stack(rec.pf_stamp).reshape(F)
    fresh = created_now[np.clip(lm_idx, 0, L - 1)] == stamp
    pf = PlaneFactors(
        pose_idx=torch.arange(N, dtype=i32, device=dev).repeat_interleave(D),
        lm_idx=dev_t(lm_idx, torch.int32),
        pi_meas=dev_t(np.stack(rec.pf_pi).reshape(F, 4)),
        sqrt_info=_plane_sqrt_info(cfg, f32, dev).expand(F, 3, 3),
        valid=dev_t(valid & fresh),
    )

    info = cfg.init_prior_info if anchor_info is None else anchor_info
    priors = PosePriors(
        idx=torch.zeros((1,), dtype=i32, device=dev),
        R=dev_t(rec.kf_R[0])[None],
        t=dev_t(rec.kf_t[0])[None],
        sqrt_info=(info * torch.eye(6, dtype=f32, device=dev))[None],
        valid=torch.ones((1,), dtype=torch.bool, device=dev),
    )
    return window, Factors(odom=odom, planes=pf, priors=priors), N


def smooth_trajectory(rec, state, cfg: SlamConfig, iters: int = 8,
                      damping: float = 1e-5):
    """Batch-GN smooth the whole keyframe trajectory on the device of
    ``state``.  Returns (kf_R (N,3,3), kf_t (N,3), stats), numpy poses."""
    window, factors, N = build_smoothing_problem(rec, state, cfg,
                                                 pad_multiple=8)
    w_opt, stats = gn_solve(
        window, factors, iters=iters, damping=damping,
        analytic_planes=cfg.analytic_planes, robust=cfg.robust,
    )
    return (w_opt.R[:N].cpu().numpy(), w_opt.t[:N].cpu().numpy(), stats)


def emit_frames(rec, kf_R, kf_t):
    """Re-publish the per-frame trajectory off the smoothed keyframes:
    frame pose = smoothed anchor keyframe pose o recorded relative."""
    Rs, ts = [], []
    for k, rR, rt in zip(rec.frame_kf, rec.frame_relR, rec.frame_relt):
        Rk, tk = kf_R[k], kf_t[k]
        Rs.append(Rk @ rR)
        ts.append(Rk @ rt + tk)
    return np.stack(Rs), np.stack(ts)
