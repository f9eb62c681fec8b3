"""Chunked frame processing (offline / batch mode).

Port of the chunked runner of ``pop_up_slam_tpu/pipeline/offline.py``.
The reference scans ``chunk`` frames inside one jit; here a chunk is a
Python loop over the same per-frame path (pop-up -> detections ->
``slam_step``), and the state stays on its device between chunks.

With ``depth=True`` each frame also renders the dense depth of its
pop-up (the reference ``entry()`` frame step), through the depth-render
kernel on CUDA.
"""

from __future__ import annotations

import torch

from .._device import as_tensor
from ..geometry.camera import Intrinsics
from ..popup import popup as pp
from .slam import (
    SlamConfig,
    SlamState,
    current_pose,
    detections_from_popup,
    slam_step,
)


def make_frame_fn(K: Intrinsics, pcfg: pp.PopupConfig, scfg: SlamConfig,
                  depth: bool = False):
    """One full SLAM frame: (state, (mask, odom_R, odom_t)) ->
    (state, (R_wc, t_wc)) — or (state, (R_wc, t_wc, depth)) with
    ``depth=True``."""

    def frame(state: SlamState, inp):
        mask, odom_R, odom_t = inp
        pred_R, pred_t = current_pose(state)
        res = pp.pop_up(K, mask, pred_R, pred_t, pcfg)
        det = detections_from_popup(res, pred_R, pred_t, scfg.max_det)
        state, (R, t) = slam_step(state, det, odom_R, odom_t, scfg)
        if depth:
            return state, (R, t, pp.render_depth(K, res, mask, pred_R,
                                                 pred_t))
        return state, (R, t)

    return frame


def make_chunked_runner(K: Intrinsics, pcfg: pp.PopupConfig,
                        scfg: SlamConfig, depth: bool = False):
    """Runner over a chunk of frames: ``run(state, masks (C,H,W),
    odom_R (C,3,3), odom_t (C,3)) -> (state, (R (C,3,3), t (C,3)))``
    (plus ``depth (C,H,W)`` with ``depth=True``).  Inputs must already
    lie on the state's device."""
    frame = make_frame_fn(K, pcfg, scfg, depth=depth)

    def run(state, masks, odom_R, odom_t):
        outs = []
        for c in range(masks.shape[0]):
            state, out = frame(state, (masks[c], odom_R[c], odom_t[c]))
            outs.append(out)
        return state, tuple(torch.stack(o) for o in zip(*outs))

    return run


def run_sequence_with(make_runner, state: SlamState, masks, odom_R, odom_t,
                      K: Intrinsics, pcfg: pp.PopupConfig, scfg: SlamConfig,
                      chunk: int = 16, depth: bool = False):
    """The chunk loop shared by the runners.  Inputs (numpy or tensors) are moved to
    the state's device once; returns (state, (R (N,3,3), t (N,3)[,
    depth (N,H,W)]))."""
    dev = state.window.t.device
    masks = as_tensor(masks, dev, torch.bool)
    odom_R = as_tensor(odom_R, dev, torch.float32)
    odom_t = as_tensor(odom_t, dev, torch.float32)
    n = masks.shape[0]
    if n == 0:
        outs = (torch.zeros((0, 3, 3), device=dev),
                torch.zeros((0, 3), device=dev))
        if depth:
            outs += (torch.zeros((0,) + tuple(masks.shape[1:]), device=dev),)
        return state, outs
    run = make_runner(K, pcfg, scfg, depth=depth)
    outs = []
    for start in range(0, n, chunk):
        sl = slice(start, min(start + chunk, n))
        state, out = run(state, masks[sl], odom_R[sl], odom_t[sl])
        outs.append(out)
    return state, tuple(torch.cat(o, dim=0) for o in zip(*outs))


def run_sequence_chunked(state: SlamState, masks, odom_R, odom_t,
                         K: Intrinsics, pcfg: pp.PopupConfig,
                         scfg: SlamConfig, chunk: int = 16,
                         depth: bool = False):
    """Run a whole sequence through the chunked runner on the state's
    device.  Returns (state, (R (N,3,3), t (N,3)[, depth (N,H,W)]))."""
    return run_sequence_with(make_chunked_runner, state, masks, odom_R,
                             odom_t, K, pcfg, scfg, chunk=chunk, depth=depth)
