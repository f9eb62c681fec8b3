"""TUM sequence runner: full monocular plane SLAM on real data.

Port of ``pop_up_slam_tpu/runners/tum_runner.py``.  Odometry sources
(TUM provides no wheel odometry):

- ``gt_perturb`` (default): relative poses from ground truth with
  configurable noise, drawn from numpy's ``default_rng(cfg.seed)`` as
  the reference draws them; ATE then measures how much the plane map
  corrects the injected drift.
- ``constant_velocity``: dead-reckoning prior from the previous
  relative estimate (no external signal).
- ``plane_vo``: fully monocular, relative motion from frame-to-frame
  plane alignment (``pipeline.make_vo_frame_fn``); no ground truth is
  consumed anywhere.

Segmentation source, chosen frame by frame from what the tree holds:
the frame's precomputed mask in ``seg/`` when there is one, otherwise
the classical floor-color model on the frame's RGB image.  Each frame
decodes only the image its segmentation reads: a frame with a mask
never opens its RGB file (so a missing or broken RGB file beside a mask
raises nothing), and the RGB image is decoded only for the classical
segmenter.  The summary's ``decoded`` counts the images of each kind
the run decoded (``rgb``, ``seg``).  The frame step (pop-up,
detections, ``slam_step``) runs on the device the caller picks (CUDA
unless ``device="cpu"``); the trajectory bookkeeping, the recorder and
the evaluation run on the host, reading the device once a frame for the
pose as the reference does.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .._device import resolve_device
from ..evaluation import ate_rmse
from ..factors.graph import linearize
from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..io import tum
from ..models import classical_ground_mask
from ..pipeline import offline, slam_init, vo_init
from ..pipeline.slam import _build_factors
from ..pipeline.smoothing import (
    TrajectoryRecorder,
    emit_frames,
    smooth_trajectory,
)
from ..solver import recover_marginals
from ..utils import MetricsLogger, StageTimer, load_state, save_state


def _snapshot(carry_state, est_R, est_t, prev_rel, rec):
    """Checkpoint tree: solver carry + trajectory so far + the
    constant-velocity cache + the smoothing recorder."""
    return {
        "state": carry_state,
        "est_R": np.stack(est_R).astype(np.float32),
        "est_t": np.stack(est_t).astype(np.float32),
        "prev_R": np.asarray(prev_rel[0], np.float32),
        "prev_t": np.asarray(prev_rel[1], np.float32),
        "recorder": rec.snapshot(),
    }


def _sync(dev: torch.device) -> None:
    """Wait for the device before a stage's clock stops (the reference's
    ``block_until_ready``)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(x).to(dev, non_blocking=True)


def run_tum_sequence(cfg, odometry: str = "gt_perturb",
                     odom_sigma_t: float = 0.01,
                     odom_sigma_r: float = 0.003,
                     max_frames: int = 0,
                     smooth: bool = True,
                     device=None,
                     out: dict | None = None):
    """Run a TUM sequence end to end; returns the reference's summary
    dict and ``decoded``.  ``out``, when given, receives the run's
    internals for a caller that holds them against a reference:
    ``est_R`` / ``est_t`` (the filtering trajectory), ``recorder``,
    ``state`` (the final ``SlamState``), ``kf_R`` / ``kf_t`` (the
    smoothed keyframes, when smoothed), ``marginals`` and
    ``frame_ids``."""
    dev = resolve_device(device)
    seq = tum.load_sequence(cfg.sequence_dir)
    K = Intrinsics.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, device=dev)
    scfg = cfg.slam

    pairs, gt_R, gt_t = tum.gt_poses_at(seq, seq.rgb_stamps)
    frame_ids = [i for i, _ in pairs]
    if max_frames:
        frame_ids = frame_ids[:max_frames]
        gt_R, gt_t = gt_R[:len(frame_ids)], gt_t[:len(frame_ids)]
    n = len(frame_ids)
    if n < 2:
        raise RuntimeError("no gt-associated frames in sequence")

    rng = np.random.default_rng(cfg.seed)
    f32 = torch.float32
    state = slam_init(scfg, torch.as_tensor(gt_R[0], dtype=f32),
                      torch.as_tensor(gt_t[0], dtype=f32), device=dev)
    rec = TrajectoryRecorder(scfg, gt_R[0], gt_t[0])
    step = offline.make_frame_fn(K, cfg.popup, scfg)

    if odometry == "plane_vo":
        vo_frame = offline.make_vo_frame_fn(K, cfg.popup, scfg)
        vo_state = vo_init(state, scfg.max_det)

    logger = MetricsLogger(cfg.metrics_path or None)
    timer = StageTimer()
    est_R = [gt_R[0]]
    est_t = [gt_t[0]]
    prev_rel = (np.eye(3), np.zeros(3))
    decoded = {"rgb": 0, "seg": 0}

    def carry():
        return vo_state if odometry == "plane_vo" else state

    start_k = 1
    ckpt = cfg.checkpoint_path or None
    if cfg.resume:
        snap, meta = load_state(
            cfg.resume, _snapshot(carry(), est_R, est_t, prev_rel, rec))
        if meta.get("odometry") != odometry:
            raise ValueError(
                f"snapshot was taken in odometry mode "
                f"{meta.get('odometry')!r}, resuming in {odometry!r}")
        start_k = int(meta["next_k"])
        est_R = list(np.asarray(snap["est_R"]))
        est_t = list(np.asarray(snap["est_t"]))
        prev_rel = (np.asarray(snap["prev_R"]), np.asarray(snap["prev_t"]))
        if odometry == "plane_vo":
            vo_state = snap["state"]
            state = vo_state.slam
        else:
            state = snap["state"]
        rec = TrajectoryRecorder.restore(scfg, snap["recorder"])
        # keep the gt-perturbation noise stream aligned with an
        # uninterrupted run: replay the draws of the skipped frames
        for _ in range(start_k - 1):
            rng.normal(0, odom_sigma_t, 3)
            rng.normal(0, odom_sigma_r, 3)

    def maybe_checkpoint(k):
        if ckpt and cfg.checkpoint_every and k % cfg.checkpoint_every == 0:
            save_state(ckpt, _snapshot(carry(), est_R, est_t, prev_rel, rec),
                       meta={"next_k": k + 1, "odometry": odometry})

    t_start = time.perf_counter()
    for k in range(start_k, n):
        i = frame_ids[k]
        timer.start("io")
        if seq.seg_files and seq.seg_files[i]:
            mask = tum.load_image(seq, seq.seg_files[i]) > 127
            decoded["seg"] += 1
            if mask.ndim == 3:
                mask = mask[..., 0]
            mask = _to_device(np.ascontiguousarray(mask), dev)
        else:
            rgb = tum.load_image(seq, seq.rgb_files[i])
            decoded["rgb"] += 1
            mask = classical_ground_mask(_to_device(rgb, dev))
        _sync(dev)
        timer.stop()

        if odometry == "plane_vo":
            timer.start("slam")
            vo_state, (R, t) = vo_frame(vo_state, mask)
            state = vo_state.slam
            _sync(dev)
            timer.stop()
            est_R.append(R.cpu().numpy())
            est_t.append(t.cpu().numpy())
            rec.record(state)
            logger.log(frame=int(i), n_kf=rec.n_kf)
            maybe_checkpoint(k)
            continue

        if odometry == "gt_perturb":
            Ra, ta = gt_R[k - 1], gt_t[k - 1]
            Rb, tb = gt_R[k], gt_t[k]
            Rrel = Ra.T @ Rb
            trel = Ra.T @ (tb - ta)
            xi = np.concatenate([
                rng.normal(0, odom_sigma_t, 3),
                rng.normal(0, odom_sigma_r, 3),
            ])
            # on the host, in f32, as the reference's exp
            dR, dt = (x.numpy() for x in se3.se3_exp(
                torch.as_tensor(xi, dtype=f32)))
            Rrel, trel = Rrel @ dR, Rrel @ dt + trel
        elif odometry == "constant_velocity":
            Rrel, trel = prev_rel
        else:
            raise ValueError(odometry)

        timer.start("slam")
        state, (R, t) = step(state, (
            mask, _to_device(np.asarray(Rrel, np.float32), dev),
            _to_device(np.asarray(trel, np.float32), dev)))
        _sync(dev)
        timer.stop()

        R_np, t_np = R.cpu().numpy(), t.cpu().numpy()
        prev_rel = (est_R[-1].T @ R_np, est_R[-1].T @ (t_np - est_t[-1]))
        est_R.append(R_np)
        est_t.append(t_np)
        rec.record(state)
        logger.log(frame=int(i), n_kf=rec.n_kf)
        maybe_checkpoint(k)
    wall = time.perf_counter() - t_start

    if ckpt:
        save_state(ckpt, _snapshot(carry(), est_R, est_t, prev_rel, rec),
                   meta={"next_k": n, "odometry": odometry})

    # marginal covariance of the current keyframe pose, at the
    # reference's linearization (its default jacfwd plane terms)
    lin = linearize(state.window, _build_factors(state, scfg))
    marg = recover_marginals(lin, state.window)
    n_kf = int(state.n_kf)
    cur = int(np.clip(n_kf - 1, 0, scfg.window_size - 1))
    pose_cov = marg.pose_cov[cur].cpu().numpy()
    trans_std = float(np.sqrt(max(float(np.trace(pose_cov[:3, :3])), 0.0)))
    rot_std = float(np.sqrt(max(float(np.trace(pose_cov[3:, 3:])), 0.0)))

    ate_filter, _, _ = ate_rmse(gt_t[:n], np.stack(est_t))

    # full-trajectory smoothing over the whole keyframe history; the
    # incremental (filtering) ATE is reported alongside
    out_R, out_t = np.stack(est_R), np.stack(est_t)
    ate = ate_filter
    smoothed = bool(smooth and rec.n_kf >= 2)
    if smoothed:
        timer.start("smooth")
        kf_R, kf_t, _ = smooth_trajectory(rec, state, scfg, iters=8,
                                          damping=scfg.damping)
        fR, ft = emit_frames(rec, kf_R, kf_t)
        out_R = np.concatenate([kf_R[:1], fR], axis=0)
        out_t = np.concatenate([kf_t[:1], ft], axis=0)
        timer.stop()
        ate, _, _ = ate_rmse(gt_t[:n], out_t)
        if out is not None:
            out.update(kf_R=kf_R, kf_t=kf_t)

    if cfg.out_trajectory:
        stamps = [float(seq.rgb_stamps[i]) for i in frame_ids]
        tum.write_trajectory(cfg.out_trajectory, stamps, out_R, out_t)
    logger.close()
    if out is not None:
        out.update(est_R=np.stack(est_R), est_t=np.stack(est_t),
                   recorder=rec, state=state, marginals=marg,
                   frame_ids=frame_ids)
    return {
        "config": cfg.name,
        "sequence": cfg.sequence_dir,
        "frames": n,
        "odometry": odometry,
        "smoothed": smoothed,
        "ate_rmse_m": round(float(ate), 4),
        "ate_filter_rmse_m": round(float(ate_filter), 4),
        "n_keyframes": n_kf,
        "lm_overflow": int(state.n_overflow),
        "frames_per_s": round((n - start_k) / max(wall, 1e-9), 2),
        "pose_trans_std_m": round(trans_std, 5),
        "pose_rot_std_rad": round(rot_std, 5),
        "stage_timing": timer.summary(),
        "decoded": decoded,
    }
