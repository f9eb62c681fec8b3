"""Distributed frame runner: data-parallel pop-up and factor-sharded BA.

Port of ``pop_up_slam_tpu/pipeline/sharded.py``.  Per block of ``B``
frames (``B`` a multiple of the mesh size), every rank:

1. **predicts** each frame's pose: the block's odometry composed onto the
   state's pose (:func:`.batched.dead_reckon`);
2. **pops up its B/n frames** at those poses (:func:`..parallel.
   sharded_popup`), packs them into detections, and gathers every
   rank's detections once a block (one ``all_gather`` per field: the
   reference's ``with_sharding_constraint(..., P())``);
3. **runs the sequential back end**, :func:`.slam.slam_step` over the
   block, with the windowed BA replaced (``solve_impl``) by the
   factor-sharded Gauss-Newton of :func:`..parallel.distributed_gn_solve`:
   each rank linearizes its block of the window's factors (the
   plane-Jacobian kernel on a CUDA rank, ``analytic_planes=True``), one
   ``all_reduce`` sums the normal equations, and the small reduced solve
   runs replicated.

The pop-up runs at the odometry-predicted pose, not the post-BA one: the
stale prediction of the batched runner.  Association, the window and the
marginalization are the single-device step's, so every rank holds the
same state.
"""

from __future__ import annotations

import warnings

import torch
from torch.distributed.device_mesh import DeviceMesh

from .._device import as_tensor
from ..geometry.camera import Intrinsics
from ..parallel.distributed import (
    all_gather_blocks,
    distributed_gn_solve,
    mesh_axis,
    sharded_popup,
)
from ..popup import popup as pp
from .batched import dead_reckon
from .slam import SlamConfig, current_pose, detections_from_popup, slam_step


def make_distributed_solve(scfg: SlamConfig, mesh: DeviceMesh,
                           axis: str = "d"):
    """A ``solve_impl`` for :func:`.slam.slam_step`: the factor-sharded
    Gauss-Newton solve on ``mesh`` with the configuration's iterations,
    damping, Jacobians and robust kernels."""

    def solve(window, factors):
        w, _ = distributed_gn_solve(
            window, factors, mesh, iters=scfg.gn_iters,
            damping=scfg.damping, axis=axis,
            analytic_planes=scfg.analytic_planes, robust=scfg.robust,
        )
        return w

    return solve


def make_sharded_runner(K: Intrinsics, pcfg: pp.PopupConfig,
                        scfg: SlamConfig, mesh: DeviceMesh, axis: str = "d"):
    """Distributed runner over a block of frames: ``run(state, masks
    (B,H,W), odom_R (B,3,3), odom_t (B,3)) -> (state, (R (B,3,3),
    t (B,3)))`` with B a multiple of the mesh size; every rank calls it
    with the same inputs and returns the same outputs."""
    group, n_dev, _ = mesh_axis(mesh, axis)
    solve_impl = make_distributed_solve(scfg, mesh, axis)

    def popup_fn(m, R, t):
        res = pp.pop_up(K, m, R, t, pcfg)
        return res, detections_from_popup(res, R, t, scfg.max_det)

    def run(state, masks, odom_R, odom_t):
        B = masks.shape[0]
        assert B % n_dev == 0, (B, n_dev)
        base_R, base_t = current_pose(state)
        pred_R, pred_t = dead_reckon(base_R, base_t, odom_R, odom_t)
        _, det_local = sharded_popup(popup_fn, masks, pred_R, pred_t, mesh,
                                     axis)
        det = all_gather_blocks(det_local, group)
        Rs, ts = [], []
        for c in range(B):
            d = type(det)(*(x[c] for x in det))
            state, (R, t) = slam_step(state, d, odom_R[c], odom_t[c], scfg,
                                      solve_impl=solve_impl)
            Rs.append(R)
            ts.append(t)
        return state, (torch.stack(Rs), torch.stack(ts))

    return run


def run_sequence_sharded(state, masks, odom_R, odom_t, K: Intrinsics,
                         pcfg: pp.PopupConfig, scfg: SlamConfig,
                         mesh: DeviceMesh, block: int = 0,
                         tail: str = "pad"):
    """Run a whole sequence through the sharded runner in blocks of
    ``block`` frames (default: one frame per rank) on the state's device
    (inputs numpy or tensors).

    A sequence whose length is not a block multiple is handled per
    ``tail``, never silently:

    - ``"pad"`` (default): the last block is padded with empty-mask,
      identity-odometry frames and the padded outputs are cut off, so
      every real frame is processed;
    - ``"drop"``: the tail frames are skipped with a ``UserWarning``
      giving their count.

    Returns (state, (R (N,3,3), t (N,3)))."""
    _, n_dev, _ = mesh_axis(mesh)
    block = block or n_dev
    assert block % n_dev == 0, (block, n_dev)
    if tail not in ("pad", "drop"):
        raise ValueError(f"tail must be 'pad' or 'drop', got {tail!r}")
    dev = state.window.t.device
    masks = as_tensor(masks, dev)
    odom_R = as_tensor(odom_R, dev, torch.float32)
    odom_t = as_tensor(odom_t, dev, torch.float32)
    n_total = masks.shape[0]
    n = (n_total // block) * block
    rem = n_total - n
    if rem and tail == "pad":
        pad = block - rem
        masks = torch.cat([masks, torch.zeros((pad,) + masks.shape[1:],
                                              dtype=masks.dtype,
                                              device=dev)])
        odom_R = torch.cat([odom_R, torch.eye(3, dtype=odom_R.dtype,
                                              device=dev).repeat(pad, 1, 1)])
        odom_t = torch.cat([odom_t, torch.zeros((pad, 3),
                                                dtype=odom_t.dtype,
                                                device=dev)])
        n = n_total + pad
    elif rem:
        warnings.warn(
            f"run_sequence_sharded: dropping {rem} tail frames (sequence "
            f"length {n_total}, block {block}); use tail='pad' to process "
            "every frame", stacklevel=2)
    run = make_sharded_runner(K, pcfg, scfg, mesh)
    Rs, ts = [], []
    for start in range(0, n, block):
        sl = slice(start, start + block)
        state, (R, t) = run(state, masks[sl], odom_R[sl], odom_t[sl])
        Rs.append(R)
        ts.append(t)
    if not Rs:
        return state, (odom_R[:0].clone(), odom_t[:0].clone())
    return state, (torch.cat(Rs)[:n_total], torch.cat(ts)[:n_total])
