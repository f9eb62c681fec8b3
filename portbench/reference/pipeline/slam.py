"""Frozen copy of the port's ``pipeline/slam.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

The per-frame plane-SLAM engine.

Port of ``pop_up_slam_tpu/pipeline/slam.py``.  :func:`slam_step` runs on
fixed-shape state:

1. accumulate odometry; predict the current pose,
2. transform the frame's plane detections into the world frame,
3. masked data association against the landmark store,
4. evict / insert landmarks,
5. on a keyframe: slide the window, record the odometry factor and the
   frame's plane factors, and re-solve the window: ``solver="gn"`` with
   the fused GN kernel on CUDA (the per-op Gauss-Newton path otherwise);
   ``"lm"`` / ``"dogleg"`` per-op, with the plane-Jacobian kernel in each
   linearization and the Schur kernels as the reduced solve
   (``make_solve_fn``),
6. update landmark extents / observation counts.

The reference's three ``lax.cond``s (merge, evict, keyframe) are host
``if``s on 0-d tensors: one device sync each on CUDA.  Every other
branch and scatter stays on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import as_tensor, const, resolve_device
from ..assoc import AssocConfig, associate_detections
from ..factors.graph import (
    Factors,
    OdomFactors,
    PlaneFactors,
    PosePriors,
    Window,
)
from ..factors.robust import RobustConfig
from ..geometry import plane as plane_mod
from ..geometry import se3
from ..mapping import (
    LandmarkStore,
    evict_landmarks,
    insert_landmarks,
    merge_landmarks,
    update_extents,
)
from ..popup.popup import PopupPlanes
from ..solver.gauss_newton import gn_solve
from ..solver.schur import make_solve_fn


class SlamConfig(NamedTuple):
    window_size: int = 8
    max_landmarks: int = 64
    max_det: int = 9              # wall detections + ground slot
    kf_trans: float = 0.25        # m — keyframe translation threshold
    kf_rot: float = 0.15          # rad — keyframe rotation threshold
    gn_iters: int = 2
    damping: float = 1e-5
    odom_sigma_t: float = 0.03    # m
    odom_sigma_r: float = 0.01    # rad
    plane_sigma_n: float = 0.015  # rad
    plane_sigma_d: float = 0.02   # m
    min_obs_for_extent: int = 1
    assoc: AssocConfig = AssocConfig()
    solver: str = "gn"            # gn | lm | dogleg
    analytic_planes: bool = True
    pallas: str = "auto"          # reduced-system solver (solver/schur.py)
    # Fused GN kernel (ops/fused_gn.py): "auto" = on CUDA when the window
    # passes the kernel's shape gate; "on" forces it (its plain version
    # on CPU tensors); "off" keeps the per-op gn_solve.
    fused: str = "auto"
    robust: RobustConfig = RobustConfig()
    marginalize: bool = True
    init_prior_info: float = 1e3
    marg_info_floor: float = 4.0
    lm_evict: bool = True
    lm_merge: bool = True
    merge_every: int = 4
    merge_gate_scale: float = 0.5
    merge_min_overlap: float = 0.0


class FrameDetections(NamedTuple):
    """planes_c (D,4), centroid_c (D,3), endpoints_c (D,2,3) in the
    camera frame; valid (D,) bool."""

    planes_c: torch.Tensor
    centroid_c: torch.Tensor
    endpoints_c: torch.Tensor
    valid: torch.Tensor


class SlamState(NamedTuple):
    window: Window
    store: LandmarkStore
    pf_pi: torch.Tensor          # (W, D, 4)
    pf_lm: torch.Tensor          # (W, D) int32
    pf_valid: torch.Tensor       # (W, D) bool
    odom_R: torch.Tensor         # (W-1, 3, 3)
    odom_t: torch.Tensor         # (W-1, 3)
    odom_valid: torch.Tensor     # (W-1,) bool
    acc_R: torch.Tensor          # (3, 3) odometry since the last kf
    acc_t: torch.Tensor          # (3,)
    n_kf: torch.Tensor           # () int32
    frame: torch.Tensor          # () int32
    mprior_R: torch.Tensor       # (3, 3) slot-0 prior mean
    mprior_t: torch.Tensor       # (3,)
    mprior_sqrt: torch.Tensor    # (6, 6) slot-0 prior sqrt-info
    n_overflow: torch.Tensor     # () int32


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without a host sync."""
    return x.index_select(0, i.reshape(1).long())[0]


def _put(x: torch.Tensor, i: torch.Tensor, v) -> torch.Tensor:
    """x.at[i].set(v) for a 0-d index tensor, without a host sync."""
    hit = torch.arange(x.shape[0], device=x.device) == i
    if isinstance(v, torch.Tensor):
        v = v.to(x.dtype)
    return torch.where(hit.reshape((-1,) + (1,) * (x.ndim - 1)), v, x)


def detections_from_popup(res: PopupPlanes, R_wc: torch.Tensor,
                          t_wc: torch.Tensor, max_det: int) -> FrameDetections:
    """Pack a pop-up result (walls + the ground plane in the last used
    slot) into camera-frame FrameDetections."""
    S = res.planes_c.shape[0]
    if max_det < S + 1:
        raise ValueError(f"max_det={max_det} < walls + ground = {S + 1}")
    pad = max_det - (S + 1)
    dt, dev = res.planes_c.dtype, res.planes_c.device
    R_cw, t_cw = se3.se3_inverse(R_wc, t_wc)
    n, d = plane_mod.to_hessian_normal(res.ground_c)
    foot_c = -d[..., None] * n
    ep_c = se3.se3_apply(R_cw, t_cw, res.endpoints_w)

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    planes = torch.cat([res.planes_c, res.ground_c[None], z(pad, 4)])
    centroids = torch.cat([res.centroid_c, foot_c[None], z(pad, 3)])
    eps = torch.cat([ep_c, torch.stack([foot_c, foot_c])[None], z(pad, 2, 3)])
    valid = torch.cat([res.valid,
                       torch.ones((1,), dtype=torch.bool, device=dev),
                       torch.zeros((pad,), dtype=torch.bool, device=dev)])
    return FrameDetections(planes, centroids, eps, valid)


def slam_init(cfg: SlamConfig, R0, t0, device=None) -> SlamState:
    """Fresh state anchored at the initial pose (a strong Gaussian prior
    on slot 0 with ``cfg.marginalize``, else slot 0 gauge-fixed).  The
    state lives on ``device``: the device of ``R0`` when it is a tensor,
    else ``cuda``."""
    dev = resolve_device(device, R0, t0)
    f32 = torch.float32
    W, L, D = cfg.window_size, cfg.max_landmarks, cfg.max_det
    R0 = as_tensor(R0, dev, f32)
    t0 = as_tensor(t0, dev, f32)
    w0 = Window.empty(W, L, dev)
    first = torch.arange(W, device=dev) == 0
    window = w0._replace(
        R=torch.where(first[:, None, None], R0, w0.R),
        t=torch.where(first[:, None], t0, w0.t),
        pose_valid=first,
        pose_fixed=first & (not cfg.marginalize),
    )
    eye3 = torch.eye(3, dtype=f32, device=dev)
    return SlamState(
        window=window,
        store=LandmarkStore.empty(L, dev),
        pf_pi=torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=f32,
                           device=dev).repeat(W, D, 1),
        pf_lm=torch.zeros((W, D), dtype=torch.int32, device=dev),
        pf_valid=torch.zeros((W, D), dtype=torch.bool, device=dev),
        odom_R=eye3.repeat(W - 1, 1, 1),
        odom_t=torch.zeros((W - 1, 3), dtype=f32, device=dev),
        odom_valid=torch.zeros((W - 1,), dtype=torch.bool, device=dev),
        acc_R=eye3.clone(),
        acc_t=torch.zeros((3,), dtype=f32, device=dev),
        n_kf=torch.tensor(1, dtype=torch.int32, device=dev),
        frame=torch.tensor(0, dtype=torch.int32, device=dev),
        mprior_R=R0.clone(),
        mprior_t=t0.clone(),
        mprior_sqrt=cfg.init_prior_info * torch.eye(6, dtype=f32, device=dev),
        n_overflow=torch.tensor(0, dtype=torch.int32, device=dev),
    )


def current_pose(state: SlamState):
    """Predicted world-from-camera pose of the current frame: the last
    keyframe's pose composed with the accumulated odometry."""
    W = state.window.window_size
    slot = torch.clamp(state.n_kf - 1, 0, W - 1)
    return se3.se3_compose(_take(state.window.R, slot),
                           _take(state.window.t, slot),
                           state.acc_R, state.acc_t)


def _odom_sqrt_info(cfg: SlamConfig, dtype, device) -> torch.Tensor:
    inv_t, inv_r = 1.0 / cfg.odom_sigma_t, 1.0 / cfg.odom_sigma_r
    return torch.diag(const([inv_t] * 3 + [inv_r] * 3, dtype, device))


def _plane_sqrt_info(cfg: SlamConfig, dtype, device) -> torch.Tensor:
    return torch.diag(const(
        [1.0 / cfg.plane_sigma_n, 1.0 / cfg.plane_sigma_n,
         1.0 / cfg.plane_sigma_d], dtype, device))


def _prior_factors(state: SlamState, cfg: SlamConfig) -> PosePriors:
    dev = state.mprior_t.device
    return PosePriors(
        idx=torch.zeros((1,), dtype=torch.int32, device=dev),
        R=state.mprior_R[None],
        t=state.mprior_t[None],
        sqrt_info=state.mprior_sqrt[None],
        valid=torch.full((1,), cfg.marginalize, dtype=torch.bool, device=dev),
    )


def _build_factors(state: SlamState, cfg: SlamConfig) -> Factors:
    W, D = state.pf_valid.shape
    dt, dev = state.window.t.dtype, state.window.t.device
    i32 = torch.int32
    odom = OdomFactors(
        i=torch.arange(W - 1, dtype=i32, device=dev),
        j=torch.arange(1, W, dtype=i32, device=dev),
        R_meas=state.odom_R,
        t_meas=state.odom_t,
        sqrt_info=_odom_sqrt_info(cfg, dt, dev).expand(W - 1, 6, 6),
        valid=state.odom_valid,
    )
    planes = PlaneFactors(
        pose_idx=torch.arange(W, dtype=i32, device=dev).repeat_interleave(D),
        lm_idx=state.pf_lm.reshape(-1),
        pi_meas=state.pf_pi.reshape(-1, 4),
        sqrt_info=_plane_sqrt_info(cfg, dt, dev).expand(W * D, 3, 3),
        valid=state.pf_valid.reshape(-1),
    )
    return Factors(odom=odom, planes=planes, priors=_prior_factors(state, cfg))


def _marg_static(cfg: SlamConfig):
    """(odometry sqrt-info diagonal, H00 regularizer, information floor)
    of the marginalization: the fused kernel's static parameters."""
    inv_t, inv_r = 1.0 / cfg.odom_sigma_t, 1.0 / cfg.odom_sigma_r
    return (inv_t,) * 3 + (inv_r,) * 3, 1e-6, cfg.marg_info_floor


def _marginalize_oldest(state: SlamState, cfg: SlamConfig):
    """(mean R, mean t, sqrt-info) of the 6-DOF marginal prior on slot 1:
    the slot-0 prior and the exiting odometry factor 0->1 (pose chain
    only) with p0 eliminated in closed form, floored by
    ``marg_info_floor``; mean = the current estimate of p1.  Computed
    from the pre-roll state; the same math is the fused kernel's."""
    from ..ops.fused_gn import marginal_sqrt

    w = state.window
    sqrt = marginal_sqrt(w.R[0], w.t[0], w.R[1], w.t[1], state.odom_R[0],
                         state.odom_t[0], state.odom_valid[0],
                         state.mprior_R, state.mprior_t, state.mprior_sqrt,
                         *_marg_static(cfg))
    return w.R[1], w.t[1], sqrt


def _use_fused(cfg: SlamConfig, device: torch.device) -> bool:
    """The fused solve's route: forced by ``"on"`` (shape gate
    permitting); under ``"auto"`` where the shapes pass the gate, as the
    program takes it on CUDA.  Its plain version runs on any device."""
    from ..ops.fused_gn import fused_gn_supported

    if cfg.fused == "off":
        return False
    ok = fused_gn_supported(cfg.window_size, cfg.max_landmarks,
                            cfg.window_size * cfg.max_det,
                            cfg.window_size - 1, 1)
    if cfg.fused == "on" and not ok:
        raise ValueError(
            "fused='on' but the window shape is outside the fused "
            f"kernel's supported sizes ({cfg.window_size}, "
            f"{cfg.max_landmarks}, {cfg.window_size * cfg.max_det})"
        )
    return ok


def _keyframe_update(state: SlamState, det: FrameDetections,
                     cfg: SlamConfig, solve_impl=None) -> SlamState:
    """Insert the current frame as a keyframe and re-solve the window.

    ``solve_impl(window, factors) -> window_opt`` replaces the whole
    windowed-BA stage when given (the hook of the sharded runner,
    :mod:`.sharded`): the fused solver is then off and the exiting
    keyframe is marginalized outside it."""
    if cfg.solver != "gn":
        raise ValueError(f"unknown solver '{cfg.solver}'")
    W, L = cfg.window_size, cfg.max_landmarks
    window, store = state.window, state.store
    dev = window.t.device

    # --- landmark merge, every merge_every-th keyframe (host sync) ---
    if cfg.lm_merge and bool(state.n_kf % cfg.merge_every == 0):
        store, lm_valid_m, remap, _ = merge_landmarks(
            store, window.planes, window.lm_valid,
            max_angle=cfg.assoc.max_angle * cfg.merge_gate_scale,
            max_dist=cfg.assoc.max_dist * cfg.merge_gate_scale,
            min_overlap=cfg.merge_min_overlap,
        )
        window = window._replace(lm_valid=lm_valid_m)
        state = state._replace(window=window, store=store,
                               pf_lm=remap[state.pf_lm.long()])

    pred_R, pred_t = current_pose(state)

    planes_w = plane_mod.transform_to_world(det.planes_c, pred_R, pred_t)
    centroid_w = se3.se3_apply(pred_R, pred_t, det.centroid_c)
    endpoints_w = se3.se3_apply(pred_R, pred_t, det.endpoints_c)

    assoc = associate_detections(
        planes_w, centroid_w, endpoints_w, det.valid,
        window.planes, store.endpoints_w, window.lm_valid, cfg.assoc,
    )

    # --- eviction when slots are short (host sync) ---
    if cfg.lm_evict:
        need = assoc.is_new.sum().to(torch.int32)
        if bool(need > (~store.valid).sum()):
            idx = torch.where(state.pf_valid, state.pf_lm,
                              torch.full_like(state.pf_lm, L))
            in_window = torch.zeros((L + 1,), dtype=torch.bool,
                                    device=dev).index_fill_(
                0, idx.reshape(-1).long(), True)
            store, evicted = evict_landmarks(store, in_window[:L], need)
            window = window._replace(lm_valid=window.lm_valid & (~evicted))

    # --- new landmark insertion ---
    store, new_slot = insert_landmarks(store, assoc.is_new, endpoints_w,
                                       state.n_kf)
    created = new_slot >= 0
    drop_new = torch.where(created, new_slot, torch.full_like(new_slot, L))
    # index_fill_, not `x[idx] = True`: a python value written through an
    # index is a host-to-device copy, and that is a sync
    lm_planes = torch.cat([window.planes, window.planes[:1]])
    lm_planes[drop_new.long()] = planes_w
    lm_valid = torch.cat([window.lm_valid, window.lm_valid[:1]]).index_fill_(
        0, drop_new.long(), True)
    window = window._replace(planes=lm_planes[:L], lm_valid=lm_valid[:L])
    safe_new = torch.clamp(new_slot, 0, L - 1)

    matched = assoc.match_lm >= 0
    lm_idx = torch.where(matched, assoc.match_lm, safe_new)
    factor_valid = det.valid & (matched | created)

    store = update_extents(store, torch.clamp(assoc.match_lm, 0, L - 1),
                           endpoints_w, matched, window.planes)

    # --- slide the window when full ---
    full = state.n_kf >= W
    fused = (solve_impl is None and cfg.solver == "gn"
             and _use_fused(cfg, dev))
    marg_block = None
    if cfg.marginalize and fused:
        from ..ops.fused_gn import pack_marg

        w0 = state.window
        marg_block = pack_marg(
            w0.R[0], w0.t[0], w0.R[1], w0.t[1],
            state.odom_R[0], state.odom_t[0], state.odom_valid[0],
            state.mprior_R, state.mprior_t, state.mprior_sqrt, full,
        )
        m_R, m_t, m_sqrt = w0.R[1], w0.t[1], state.mprior_sqrt
    elif cfg.marginalize:
        m_R, m_t, m_sqrt = _marginalize_oldest(state, cfg)

    def pick(a, b):
        return torch.where(full, a, b)

    def roll(x):
        return pick(torch.roll(x, -1, dims=0), x)

    def roll_clear_last(x):
        r = torch.roll(x, -1, dims=0)
        return pick(torch.cat([r[:-1], torch.zeros_like(r[-1:])]), x)

    window = window._replace(R=roll(window.R), t=roll(window.t),
                             pose_valid=roll(window.pose_valid))
    odom_R, odom_t = roll(state.odom_R), roll(state.odom_t)
    odom_valid = roll_clear_last(state.odom_valid)
    pf_pi, pf_lm = roll(state.pf_pi), roll(state.pf_lm)
    pf_valid = roll_clear_last(state.pf_valid)
    if cfg.marginalize:
        mprior_R = pick(m_R, state.mprior_R)
        mprior_t = pick(m_t, state.mprior_t)
        mprior_sqrt = pick(m_sqrt, state.mprior_sqrt)
    else:
        mprior_R, mprior_t, mprior_sqrt = (state.mprior_R, state.mprior_t,
                                           state.mprior_sqrt)

    # --- write the new keyframe into its slot ---
    slot = torch.clamp(state.n_kf, 0, W - 1)
    window = window._replace(
        R=_put(window.R, slot, pred_R),
        t=_put(window.t, slot, pred_t),
        pose_valid=_put(window.pose_valid, slot, True),
    )
    oslot = torch.clamp(slot - 1, 0, W - 2)
    odom_R = _put(odom_R, oslot, state.acc_R)
    odom_t = _put(odom_t, oslot, state.acc_t)
    odom_valid = _put(odom_valid, oslot, True)
    pf_pi = _put(pf_pi, slot, det.planes_c)
    pf_lm = _put(pf_lm, slot, lm_idx)
    pf_valid = _put(pf_valid, slot, factor_valid)

    state = state._replace(
        window=window, store=store,
        pf_pi=pf_pi, pf_lm=pf_lm, pf_valid=pf_valid,
        odom_R=odom_R, odom_t=odom_t, odom_valid=odom_valid,
        mprior_R=mprior_R, mprior_t=mprior_t, mprior_sqrt=mprior_sqrt,
        n_overflow=state.n_overflow
        + (assoc.is_new & (~created)).sum().to(torch.int32),
    )

    # --- windowed bundle adjustment ---
    factors = _build_factors(state, cfg)
    if solve_impl is not None:
        window_opt = solve_impl(state.window, factors)
    elif fused:
        from ..ops.fused_gn import fused_gn_solve

        if marg_block is not None:
            window_opt, _, m_sqrt_out = fused_gn_solve(
                state.window, factors, iters=cfg.gn_iters,
                damping=cfg.damping, robust=cfg.robust, marg=marg_block,
                marg_static=_marg_static(cfg),
            )
            state = state._replace(
                mprior_sqrt=pick(m_sqrt_out, state.mprior_sqrt))
        else:
            window_opt, _ = fused_gn_solve(
                state.window, factors, iters=cfg.gn_iters,
                damping=cfg.damping, robust=cfg.robust,
            )
    elif cfg.solver == "gn":
        window_opt, _ = gn_solve(
            state.window, factors, iters=cfg.gn_iters, damping=cfg.damping,
            solve_fn=make_solve_fn(cfg.pallas),
            analytic_planes=cfg.analytic_planes, robust=cfg.robust,
        )
    else:
        raise ValueError(f"solver '{cfg.solver}': the reference holds "
                         "the Gauss-Newton solve only")

    return state._replace(
        window=window_opt,
        acc_R=torch.eye(3, dtype=state.acc_R.dtype, device=dev),
        acc_t=torch.zeros((3,), dtype=state.acc_t.dtype, device=dev),
        n_kf=state.n_kf + 1,
    )


def slam_step(state: SlamState, det: FrameDetections, odom_R: torch.Tensor,
              odom_t: torch.Tensor, cfg: SlamConfig, solve_impl=None):
    """Process one frame.  Returns (state, (R_wc, t_wc) current pose).
    The keyframe decision is a host ``if`` (one device sync on CUDA).
    ``solve_impl`` optionally replaces the BA solve (see
    :func:`_keyframe_update`)."""
    acc_R, acc_t = se3.se3_compose(state.acc_R, state.acc_t, odom_R, odom_t)
    state = state._replace(acc_R=acc_R, acc_t=acc_t, frame=state.frame + 1)

    dist = torch.linalg.norm(acc_t)
    ang = torch.linalg.norm(se3.so3_log(acc_R))
    is_kf = (dist > cfg.kf_trans) | (ang > cfg.kf_rot)
    if bool(is_kf):
        state = _keyframe_update(state, det, cfg, solve_impl)
    R, t = current_pose(state)
    return state, (R, t)
