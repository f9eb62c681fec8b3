"""Full-trajectory smoothing: batch GN over the whole keyframe history.

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

class TrajectoryRecorder:
    """Host-side keyframe-history log for post-hoc smoothing.

    Call :meth:`record` once per processed frame with the post-step
    ``SlamState``.  It reads the device as the reference's does: ``n_kf``
    every frame, the accumulated motion on other frames, and the new
    keyframe's measurements and the window's poses on a keyframe;
    ``pulls`` counts those device-to-host reads."""

    def __init__(self, cfg: SlamConfig, R0, t0):
        self.W = cfg.window_size
        self.D = cfg.max_det
        self.kf_R = [np.asarray(R0, np.float32)]
        self.kf_t = [np.asarray(t0, np.float32)]
        self.odom_R: list = []      # measurement kf k-1 -> k
        self.odom_t: list = []
        self.pf_pi = [np.zeros((self.D, 4), np.float32)]
        self.pf_lm = [np.zeros((self.D,), np.int32)]
        self.pf_valid = [np.zeros((self.D,), bool)]
        # creation stamp of each factor's landmark at record time: a
        # slot recycled later (eviction/merge) carries a different
        # stamp, and the stale factor is dropped at smoothing time
        self.pf_stamp = [np.full((self.D,), -2, np.int32)]
        self.n_kf = 1
        self.frame_kf: list = []    # per frame: anchor kf index
        self.frame_relR: list = []  # pose = kf_pose o rel
        self.frame_relt: list = []
        self.pulls = 0

    def _pull(self, x: torch.Tensor, dtype) -> np.ndarray:
        self.pulls += 1
        return x.detach().cpu().numpy().astype(dtype)

    def record(self, state) -> None:
        n_kf_new = int(self._pull(state.n_kf, np.int64))
        if n_kf_new > self.n_kf:
            # a keyframe was just inserted: pull its measurements and
            # refresh every in-window keyframe's pose estimate
            slot = min(n_kf_new - 1, self.W - 1)
            oslot = max(slot - 1, 0)
            f32 = np.float32
            self.odom_R.append(self._pull(state.odom_R[oslot], f32))
            self.odom_t.append(self._pull(state.odom_t[oslot], f32))
            self.pf_pi.append(self._pull(state.pf_pi[slot], f32))
            lm = self._pull(state.pf_lm[slot], np.int32)
            self.pf_lm.append(lm)
            self.pf_valid.append(self._pull(state.pf_valid[slot], bool))
            created = self._pull(state.store.created_kf, np.int32)
            self.pf_stamp.append(
                created[np.clip(lm, 0, created.shape[0] - 1)])
            self.kf_R.append(self._pull(state.window.R[slot], f32))
            self.kf_t.append(self._pull(state.window.t[slot], f32))
            self.n_kf = n_kf_new
            self._refresh(state)
            rel_R, rel_t = np.eye(3, dtype=f32), np.zeros(3, f32)
        else:
            rel_R = self._pull(state.acc_R, np.float32)
            rel_t = self._pull(state.acc_t, np.float32)
        self.frame_kf.append(self.n_kf - 1)
        self.frame_relR.append(rel_R)
        self.frame_relt.append(rel_t)

    def _refresh(self, state) -> None:
        """Overwrite the last min(n_kf, W) keyframe estimates with the
        current window's (post-BA) poses."""
        win_R = self._pull(state.window.R, np.float32)
        win_t = self._pull(state.window.t, np.float32)
        nw = min(self.n_kf, self.W)
        base = self.n_kf - nw
        for s in range(nw):
            self.kf_R[base + s] = win_R[s]
            self.kf_t[base + s] = win_t[s]

    # --- checkpoint support (fixed-leaf-count tree) ---

    def snapshot(self) -> dict:
        def stack(xs, shape):
            return np.stack(xs) if xs else np.zeros(shape, np.float32)

        return {
            "kf_R": np.stack(self.kf_R),
            "kf_t": np.stack(self.kf_t),
            "odom_R": stack(self.odom_R, (0, 3, 3)),
            "odom_t": stack(self.odom_t, (0, 3)),
            "pf_pi": np.stack(self.pf_pi),
            "pf_lm": np.stack(self.pf_lm),
            "pf_valid": np.stack(self.pf_valid),
            "pf_stamp": np.stack(self.pf_stamp),
            "frame_kf": np.asarray(self.frame_kf, np.int32),
            "frame_relR": stack(self.frame_relR, (0, 3, 3)),
            "frame_relt": stack(self.frame_relt, (0, 3)),
        }

    @classmethod
    def restore(cls, cfg: SlamConfig, snap: dict) -> "TrajectoryRecorder":
        def arr(key, dtype):
            return list(np.asarray(snap[key], dtype))

        rec = cls(cfg, np.asarray(snap["kf_R"])[0],
                  np.asarray(snap["kf_t"])[0])
        f32 = np.float32
        rec.kf_R, rec.kf_t = arr("kf_R", f32), arr("kf_t", f32)
        rec.odom_R, rec.odom_t = arr("odom_R", f32), arr("odom_t", f32)
        rec.pf_pi, rec.pf_lm = arr("pf_pi", f32), arr("pf_lm", np.int32)
        rec.pf_valid = arr("pf_valid", bool)
        rec.pf_stamp = arr("pf_stamp", np.int32)
        rec.n_kf = len(rec.kf_R)
        rec.frame_kf = arr("frame_kf", np.int32)
        rec.frame_relR = arr("frame_relR", f32)
        rec.frame_relt = arr("frame_relt", f32)
        return rec


def build_smoothing_problem(
    rec: TrajectoryRecorder,
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


def smooth_trajectory(
    rec: TrajectoryRecorder,
    state,
    cfg: SlamConfig,
    iters: int = 8,
    damping: float = 1e-5,
    mesh=None,
    axis: str = "d",
):
    """Batch-GN smooth the whole keyframe trajectory on the device of
    ``state``.  Returns (kf_R (N,3,3), kf_t (N,3), stats), numpy poses.

    With ``mesh`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`)
    the linearization runs keyframe-block-sharded with a chain halo
    exchange (:mod:`..parallel.keyframe_blocks`), the window padded to a
    multiple of the mesh size; as the reference's mesh branch, it takes
    the ``jacfwd`` terms without robust weights (``cfg.analytic_planes``
    and ``cfg.robust`` are not read).  Otherwise the single-device
    ``gn_solve``."""
    if mesh is not None:
        from ..parallel.distributed import mesh_axis
        from ..parallel.keyframe_blocks import keyframe_sharded_gn_solve

        window, factors, N = build_smoothing_problem(
            rec, state, cfg, pad_multiple=mesh_axis(mesh, axis)[1])
        w_opt, stats = keyframe_sharded_gn_solve(
            window, factors, mesh, iters=iters, damping=damping, axis=axis)
        return (w_opt.R[:N].cpu().numpy(), w_opt.t[:N].cpu().numpy(),
                stats)
    window, factors, N = build_smoothing_problem(rec, state, cfg,
                                                 pad_multiple=8)
    w_opt, stats = gn_solve(
        window, factors, iters=iters, damping=damping,
        analytic_planes=cfg.analytic_planes, robust=cfg.robust,
    )
    return (w_opt.R[:N].cpu().numpy(), w_opt.t[:N].cpu().numpy(), stats)


def emit_frames(rec: TrajectoryRecorder, kf_R, kf_t):
    """Re-publish the per-frame trajectory off the smoothed keyframes:
    frame pose = smoothed anchor keyframe pose o recorded relative."""
    Rs, ts = [], []
    for k, rR, rt in zip(rec.frame_kf, rec.frame_relR, rec.frame_relt):
        Rk, tk = kf_R[k], kf_t[k]
        Rs.append(Rk @ rR)
        ts.append(Rk @ rt + tk)
    return np.stack(Rs), np.stack(ts)
