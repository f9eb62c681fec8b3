"""Batched-front-end chunk runner: one batched pop-up + sequential back end.

Port of ``pop_up_slam_tpu/pipeline/batched.py``.  The camera-frame
detections of the pop-up depend on the pose prior only through gravity
alignment and camera height, so the front end can run on dead-reckoned
poses (state pose composed with the chunk's cumulated odometry), all C
frames of a chunk in one batched pass (``torch.func.vmap`` over
:func:`..popup.popup.pop_up`), while association and the windowed BA
(:func:`.slam.slam_step`, K1 on CUDA) stay a sequential loop.

Numerical note (the reference's): the per-frame path pops frame t up at
the BA-refined pose of the previous frame, this one at the dead-reckoned
pose including frame t's odometry, so the two differ by one odometry
delta plus the BA corrections accumulated inside the chunk; with noisy
odometry a larger ``chunk`` trades accuracy for throughput.
"""

from __future__ import annotations

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..popup import popup as pp
from .slam import (
    SlamConfig,
    SlamState,
    current_pose,
    detections_from_popup,
    slam_step,
)


def dead_reckon(base_R: torch.Tensor, base_t: torch.Tensor,
                odom_R: torch.Tensor, odom_t: torch.Tensor):
    """Cumulative compose of a chunk of relative motions onto a base pose.

    Returns (R (C,3,3), t (C,3)): the dead-reckoned pose after each
    relative measurement."""
    R, t = base_R, base_t
    Rs, ts = [], []
    for c in range(odom_R.shape[0]):
        R, t = se3.se3_compose(R, t, odom_R[c], odom_t[c])
        Rs.append(R)
        ts.append(t)
    if not Rs:
        return odom_R[:0].clone(), odom_t[:0].clone()
    return torch.stack(Rs), torch.stack(ts)


def batched_pop_up(K: Intrinsics, masks: torch.Tensor, R_wc: torch.Tensor,
                   t_wc: torch.Tensor, pcfg: pp.PopupConfig,
                   max_det: int):
    """The batched front end: every frame of ``masks`` (C, H, W) popped up
    at its pose (C, 3, 3), (C, 3) in one vmapped pass, then packed into
    detections.  Returns (PopupPlanes, FrameDetections), each field with
    a leading frame axis."""
    def one(m, R, t):
        res = pp.pop_up(K, m, R, t, pcfg)
        return res, detections_from_popup(res, R, t, max_det)

    return torch.func.vmap(one)(masks, R_wc, t_wc)


def make_batched_runner(K: Intrinsics, pcfg: pp.PopupConfig,
                        scfg: SlamConfig, depth: bool = False):
    """Runner over a chunk of frames with the signature of
    :func:`.offline.make_chunked_runner`: ``run(state, masks (C,H,W),
    odom_R (C,3,3), odom_t (C,3)) -> (state, (R (C,3,3), t (C,3)))``.
    It renders no depth, as the reference's batched runner renders none:
    ``depth=True`` raises."""
    if depth:
        raise ValueError("make_batched_runner renders no depth")

    def run(state: SlamState, masks, odom_R, odom_t):
        base_R, base_t = current_pose(state)
        dr_R, dr_t = dead_reckon(base_R, base_t, odom_R, odom_t)
        _, dets = batched_pop_up(K, masks, dr_R, dr_t, pcfg, scfg.max_det)
        Rs, ts = [], []
        for c in range(masks.shape[0]):
            det = type(dets)(*(x[c] for x in dets))
            state, (R, t) = slam_step(state, det, odom_R[c], odom_t[c], scfg)
            Rs.append(R)
            ts.append(t)
        if not Rs:
            return state, (dr_R, dr_t)
        return state, (torch.stack(Rs), torch.stack(ts))

    return run


def run_sequence_batched(state: SlamState, masks, odom_R, odom_t,
                         K: Intrinsics, pcfg: pp.PopupConfig,
                         scfg: SlamConfig, chunk: int = 16):
    """Run a whole sequence through the batched runner with the shared
    chunk loop (:func:`.offline.run_sequence_with`) on the state's
    device.  Returns (state, (R (N,3,3), t (N,3))).

    Within a chunk the front end sees no BA feedback, so with noisy
    odometry pick the chunk length to the odometry quality."""
    from .offline import run_sequence_with

    return run_sequence_with(make_batched_runner, state, masks, odom_R,
                             odom_t, K, pcfg, scfg, chunk=chunk)
