"""Chunked frame processing (offline / batch mode).

Port of ``pop_up_slam_tpu/pipeline/offline.py``.  The reference scans
``chunk`` frames inside one jit; here a chunk is a Python loop over the
same per-frame path, and the state stays on its device between chunks.

- The odometry-driven runner: pop-up -> detections -> ``slam_step``.
  With ``depth=True`` each frame also renders the dense depth of its
  pop-up (the reference ``entry()`` frame step), through the
  depth-render kernel on CUDA.
- The fully monocular runners (``make_chunked_vo_runner``,
  ``make_chunked_fused_vo_runner``): no odometry input; the relative
  motion comes from frame-to-frame plane alignment
  (:mod:`..odometry.plane_vo`) seeded by a constant-velocity prior, and
  the fused variant keeps a per-pixel inverse-depth filter
  (:mod:`..fusion`) fed by each frame's rendered plane depth.
  :func:`run_masks_chunked` drives either over a sequence of masks.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_tensor, const
from ..fusion import DepthFilter
from ..geometry import se3
from ..geometry.camera import Intrinsics
from ..odometry import PlaneVOConfig, plane_vo_step
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


class VOState(NamedTuple):
    """Carry of the fully monocular (plane-VO) frame loop."""

    slam: SlamState
    prev_planes: torch.Tensor    # (D, 4) previous frame's camera planes
    prev_valid: torch.Tensor     # (D,) bool
    prev_support: torch.Tensor   # (D,) f32 boundary-column support
    prior_R: torch.Tensor        # (3, 3) constant-velocity motion prior
    prior_t: torch.Tensor        # (3,)


def _unit_planes(n: int, dtype, device) -> torch.Tensor:
    """``n`` copies of the placeholder plane (0, 0, 1, 0)."""
    return const([0.0, 0.0, 1.0, 0.0], dtype, device).expand(n, 4)


def vo_init(slam_state: SlamState, max_det: int) -> VOState:
    dev, dt = slam_state.window.t.device, slam_state.window.t.dtype
    return VOState(
        slam=slam_state,
        prev_planes=_unit_planes(max_det, dt, dev).contiguous(),
        prev_valid=torch.zeros((max_det,), dtype=torch.bool, device=dev),
        prev_support=torch.zeros((max_det,), dtype=dt, device=dev),
        prior_R=torch.eye(3, dtype=dt, device=dev),
        prior_t=torch.zeros((3,), dtype=dt, device=dev),
    )


def _vo_frame_core(vs: VOState, mask, K, pcfg, scfg, vcfg):
    """The shared fully monocular frame step.  Returns the next VOState,
    the pose, and what the fused variant builds on (pop-up result,
    pop-up pose, VO estimate)."""
    base_R, base_t = current_pose(vs.slam)
    # pop-up at the constant-velocity prediction (only gravity alignment
    # and height matter for the single-view geometry)
    pred_R, pred_t = se3.se3_compose(base_R, base_t, vs.prior_R, vs.prior_t)
    res = pp.pop_up(K, mask, pred_R, pred_t, pcfg)
    dt, dev = res.planes_c.dtype, res.planes_c.device
    planes = torch.cat([res.planes_c, res.ground_c[None]])
    pad = scfg.max_det - planes.shape[0]
    valid = [res.valid, torch.ones((1,), dtype=torch.bool, device=dev)]
    # observation support: boundary columns per wall; the ground (fit
    # from the whole mask) gets the count of valid boundary columns
    support = [res.n_points.to(dt), res.boundary_ok.sum().to(dt)[None]]
    if pad:
        planes = torch.cat([planes, _unit_planes(pad, dt, dev)])
        valid.append(torch.zeros((pad,), dtype=torch.bool, device=dev))
        support.append(torch.zeros((pad,), dtype=dt, device=dev))
    valid, support = torch.cat(valid), torch.cat(support)

    vo = plane_vo_step(vs.prev_planes, vs.prev_valid, planes, valid,
                       vs.prior_R, vs.prior_t, vcfg,
                       support_prev=vs.prev_support, support_cur=support)
    det = detections_from_popup(res, pred_R, pred_t, scfg.max_det)
    slam, (R, t) = slam_step(vs.slam, det, vo.R, vo.t, scfg)
    vs_next = VOState(slam, planes, valid, support, vo.R, vo.t)
    return vs_next, (R, t), (res, pred_R, pred_t, vo)


def make_vo_frame_fn(K: Intrinsics, pcfg: pp.PopupConfig, scfg: SlamConfig,
                     vcfg: PlaneVOConfig = PlaneVOConfig()):
    """Fully monocular frame step: mask -> pop-up -> plane-VO odometry ->
    SLAM.  ``frame(VOState, mask (H, W)) -> (VOState, (R_wc, t_wc))``."""

    def frame(vs: VOState, mask):
        vs_next, pose, _ = _vo_frame_core(vs, mask, K, pcfg, scfg, vcfg)
        return vs_next, pose

    return frame


class FusedVOState(NamedTuple):
    """Monocular VO carry + the per-pixel inverse-depth filter."""

    vo: VOState
    filt: DepthFilter


def fused_vo_init(slam_state: SlamState, max_det: int, height: int,
                  width: int) -> FusedVOState:
    dev, dt = slam_state.window.t.device, slam_state.window.t.dtype
    return FusedVOState(
        vo=vo_init(slam_state, max_det),
        filt=DepthFilter(
            inv_mu=torch.zeros((height, width), dtype=dt, device=dev),
            var=torch.full((height, width), 1e6, dtype=dt, device=dev),
            valid=torch.zeros((height, width), dtype=torch.bool, device=dev),
        ),
    )


def make_fused_vo_frame_fn(K: Intrinsics, pcfg: pp.PopupConfig,
                           scfg: SlamConfig,
                           vcfg: PlaneVOConfig = PlaneVOConfig(),
                           sigma0_rel: float = 0.05, motion_var: float = 1e-4,
                           max_depth: float = 40.0):
    """Monocular frame step with per-pixel depth fusion: each frame's
    rendered plane depth (the depth-render kernel on CUDA) is fused into
    the inverse-depth filter after the filter is forward-warped through
    the VO motion.  ``frame(FusedVOState, mask (H, W)) ->
    (FusedVOState, ((R_wc, t_wc), fused_depth (H, W)))``."""
    from ..fusion import fuse_observation, init_from_popup, propagate_to_frame

    def frame(fs: FusedVOState, mask):
        vs_next, (R, t), (res, pred_R, pred_t, vo) = _vo_frame_core(
            fs.vo, mask, K, pcfg, scfg, vcfg)
        plane_depth = pp.render_depth(K, res, mask, pred_R, pred_t,
                                      max_depth=max_depth)
        flt = propagate_to_frame(fs.filt, K, vo.R, vo.t,
                                 motion_var=motion_var, max_depth=max_depth)
        obs = init_from_popup(plane_depth, sigma0_rel=sigma0_rel,
                              max_depth=max_depth)
        flt = fuse_observation(flt, obs.inv_mu, obs.var)
        fused_depth = torch.where(
            flt.valid, 1.0 / torch.clamp(flt.inv_mu, 1e-3, 1e3), plane_depth)
        return FusedVOState(vs_next, flt), ((R, t), fused_depth)

    return frame


def _scan(frame, state, masks, empty):
    """Run ``frame`` over the masks in order; the per-frame outputs are
    stacked along a new leading axis (``empty`` for no frames)."""
    outs = []
    for c in range(masks.shape[0]):
        state, out = frame(state, masks[c])
        outs.append(out)
    if not outs:
        return state, empty
    return state, _stack(outs)


def _stack(outs):
    if isinstance(outs[0], torch.Tensor):
        return torch.stack(outs)
    return tuple(_stack(list(o)) for o in zip(*outs))


def make_chunked_vo_runner(K: Intrinsics, pcfg: pp.PopupConfig,
                           scfg: SlamConfig,
                           vcfg: PlaneVOConfig = PlaneVOConfig()):
    """Monocular runner over a chunk of masks: ``run(vo_state, masks
    (C, H, W)) -> (vo_state, (R (C,3,3), t (C,3)))``."""
    frame = make_vo_frame_fn(K, pcfg, scfg, vcfg)

    def run(vs, masks):
        dev = masks.device
        return _scan(frame, vs, masks, (torch.zeros((0, 3, 3), device=dev),
                                        torch.zeros((0, 3), device=dev)))

    return run


def make_chunked_fused_vo_runner(K: Intrinsics, pcfg: pp.PopupConfig,
                                 scfg: SlamConfig,
                                 vcfg: PlaneVOConfig = PlaneVOConfig(),
                                 **fusion_kwargs):
    """Fused monocular runner over a chunk of masks: ``run(fs, masks
    (C, H, W)) -> (fs, ((R (C,3,3), t (C,3)), depth (C, H, W)))``."""
    frame = make_fused_vo_frame_fn(K, pcfg, scfg, vcfg, **fusion_kwargs)

    def run(fs, masks):
        dev = masks.device
        return _scan(frame, fs, masks,
                     ((torch.zeros((0, 3, 3), device=dev),
                       torch.zeros((0, 3), device=dev)),
                      torch.zeros((0,) + tuple(masks.shape[1:]),
                                  device=dev)))

    return run


def _cat(outs):
    if isinstance(outs[0], torch.Tensor):
        return torch.cat(outs, dim=0)
    return tuple(_cat(list(o)) for o in zip(*outs))


def run_masks_chunked(run, state, masks, chunk: int = 16):
    """The chunk loop of the monocular runners (any ``run(state, masks
    (C, H, W)) -> (state, outputs)``): the masks (numpy or a tensor) go
    to the state's device once, ``run`` takes ``chunk`` frames at a
    time, and the outputs are concatenated along the frame axis.
    Returns (state, outputs over all frames)."""
    dev = state.slam.window.t.device if isinstance(state, VOState) else (
        state.vo.slam.window.t.device)
    masks = as_tensor(masks, dev, torch.bool)
    n = masks.shape[0]
    if n == 0:
        return run(state, masks)
    outs = []
    for start in range(0, n, chunk):
        state, out = run(state, masks[start:start + chunk])
        outs.append(out)
    return state, _cat(outs)
