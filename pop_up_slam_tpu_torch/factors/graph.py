"""Fixed-capacity factor graph over SE(3) poses and plane landmarks.

Port of ``pop_up_slam_tpu/factors/graph.py``: the sliding window is a
fixed-shape tuple of capacity-padded tensors with validity masks.
Factor types: odometry (between two window poses), plane observations,
and absolute pose priors; residuals are whitened by per-factor
square-root information matrices.

Both linearizations are ported: the closed-form Jacobians
(``analytic_poses=True``, ``analytic_planes=True``, the production
configuration; the plane terms through the plane-Jacobian kernel on
CUDA) and the reference's per-factor ``jacfwd`` at a zero perturbation
(``torch.func.jacfwd`` under ``torch.func.vmap``), picked by
:func:`linearize`'s flags with the reference's defaults.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import plane, se3
from .robust import RobustConfig, apply_weights
from .robust import rho as _rho


class Window(NamedTuple):
    """R (W,3,3), t (W,3) world-from-camera poses; planes (L,4);
    pose_valid, pose_fixed (W,) bool; lm_valid (L,) bool."""

    R: torch.Tensor
    t: torch.Tensor
    planes: torch.Tensor
    pose_valid: torch.Tensor
    pose_fixed: torch.Tensor
    lm_valid: torch.Tensor

    @staticmethod
    def empty(window_size: int, max_landmarks: int, device) -> "Window":
        f32 = torch.float32
        return Window(
            R=torch.eye(3, dtype=f32, device=device).repeat(window_size, 1, 1),
            t=torch.zeros((window_size, 3), dtype=f32, device=device),
            planes=torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=f32,
                                device=device).repeat(max_landmarks, 1),
            pose_valid=torch.zeros((window_size,), dtype=torch.bool,
                                   device=device),
            pose_fixed=torch.zeros((window_size,), dtype=torch.bool,
                                   device=device),
            lm_valid=torch.zeros((max_landmarks,), dtype=torch.bool,
                                 device=device),
        )

    @property
    def window_size(self) -> int:
        return self.R.shape[0]

    @property
    def max_landmarks(self) -> int:
        return self.planes.shape[0]


class OdomFactors(NamedTuple):
    i: torch.Tensor          # (O,) int32
    j: torch.Tensor          # (O,) int32
    R_meas: torch.Tensor     # (O, 3, 3)
    t_meas: torch.Tensor     # (O, 3)
    sqrt_info: torch.Tensor  # (O, 6, 6)
    valid: torch.Tensor      # (O,) bool


class PlaneFactors(NamedTuple):
    pose_idx: torch.Tensor   # (F,) int32
    lm_idx: torch.Tensor     # (F,) int32
    pi_meas: torch.Tensor    # (F, 4) measured plane, camera frame
    sqrt_info: torch.Tensor  # (F, 3, 3)
    valid: torch.Tensor      # (F,) bool


class PosePriors(NamedTuple):
    idx: torch.Tensor        # (P,) int32
    R: torch.Tensor          # (P, 3, 3)
    t: torch.Tensor          # (P, 3)
    sqrt_info: torch.Tensor  # (P, 6, 6)
    valid: torch.Tensor      # (P,) bool


class Factors(NamedTuple):
    odom: OdomFactors
    planes: PlaneFactors
    priors: PosePriors


def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return (A @ x[..., None])[..., 0]


def odom_residual(Ri, ti, Rj, tj, R_meas, t_meas, sqrt_info, xi_i=None,
                  xi_j=None):
    """Whitened 6-dim residual log(meas^-1 (T_i e^xi_i)^-1 (T_j e^xi_j))."""
    if xi_i is not None:
        Ri, ti = se3.se3_retract(Ri, ti, xi_i)
    if xi_j is not None:
        Rj, tj = se3.se3_retract(Rj, tj, xi_j)
    R_rel, t_rel = se3.se3_between(Ri, ti, Rj, tj)
    R_err, t_err = se3.se3_between(R_meas, t_meas, R_rel, t_rel)
    return _mv(sqrt_info, se3.se3_log(R_err, t_err))


def plane_residual(R_wc, t_wc, pi_w, pi_meas_c, sqrt_info, xi=None,
                   delta=None):
    """Whitened Hessian-normal plane residual (2 normal-tangent radians +
    1 metric distance) with T_wc <- T_wc e^xi and pi_w <- pi_w ⊞ delta."""
    if xi is not None:
        R_wc, t_wc = se3.se3_retract(R_wc, t_wc, xi)
    if delta is not None:
        pi_w = plane.retract(pi_w, delta)
    R_cw, t_cw = se3.se3_inverse(R_wc, t_wc)
    pred = plane.transform(pi_w, R_cw, t_cw)
    return _mv(sqrt_info, plane.hessian_local(pred, pi_meas_c))


def prior_residual(R, t, R_prior, t_prior, sqrt_info, xi=None):
    """Whitened 6-dim residual log(P^-1 T e^xi) of an absolute prior."""
    if xi is not None:
        R, t = se3.se3_retract(R, t, xi)
    R_err, t_err = se3.se3_between(R_prior, t_prior, R, t)
    return _mv(sqrt_info, se3.se3_log(R_err, t_err))


class Linearization(NamedTuple):
    Hpp: torch.Tensor   # (W, W, 6, 6)
    Hpl: torch.Tensor   # (W, L, 6, 3)
    Hll: torch.Tensor   # (L, 3, 3)
    bp: torch.Tensor    # (W, 6)
    bl: torch.Tensor    # (L, 3)
    cost: torch.Tensor  # () 0.5 * sum rho(||r||^2)


def _mask(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """where-mask (not multiply): padded factors can be non-finite."""
    v = v.reshape(v.shape + (1,) * (x.ndim - v.ndim))
    return torch.where(v, x, torch.zeros_like(x))


def _zero(n: int, like: torch.Tensor) -> torch.Tensor:
    """A zero perturbation (1, n).  Each factor keeps a leading unit
    axis under ``vmap``: ``jacfwd`` through a 0-d tensor times a Python
    float promotes the tangent to f64 in ``torch.func``."""
    return torch.zeros((1, n), dtype=like.dtype, device=like.device)


def _unit(*xs):
    return tuple(x[None] for x in xs)


def _odom_terms(window: Window, f: OdomFactors):
    """Residuals + jacfwd Jacobians of all odometry factors at a zero
    perturbation: (r (O,6), Ji (O,6,6), Jj (O,6,6)), zero where
    invalid."""
    i, j = f.i.long(), f.j.long()

    def one(Ri, ti, Rj, tj, R_meas, t_meas, A, valid):
        Ri, ti, Rj, tj, R_meas, t_meas, A = _unit(Ri, ti, Rj, tj, R_meas,
                                                  t_meas, A)

        def res(xi_i, xi_j):
            return odom_residual(Ri, ti, Rj, tj, R_meas, t_meas, A, xi_i,
                                 xi_j)[0]

        z = _zero(6, ti)
        r = res(z, z)
        Ji = jacfwd(res, argnums=0)(z, z)[:, 0]
        Jj = jacfwd(res, argnums=1)(z, z)[:, 0]
        # where-mask (not multiply): a padded factor linearized at the
        # identity can give NaN Jacobians, and NaN * 0 == NaN
        return _mask(valid, r), _mask(valid, Ji), _mask(valid, Jj)

    return vmap(one)(window.R[i], window.t[i], window.R[j], window.t[j],
                     f.R_meas, f.t_meas, f.sqrt_info, f.valid)


def _plane_terms(window: Window, f: PlaneFactors):
    """Residuals + jacfwd Jacobians of all plane factors: (r (F,3),
    Jp (F,3,6), Jl (F,3,3)), zero where invalid."""
    p, l = f.pose_idx.long(), f.lm_idx.long()

    def one(R_wc, t_wc, pi_w, pi_meas, A, valid):
        R_wc, t_wc, pi_w, pi_meas, A = _unit(R_wc, t_wc, pi_w, pi_meas, A)

        def res(xi, delta):
            return plane_residual(R_wc, t_wc, pi_w, pi_meas, A, xi,
                                  delta)[0]

        z6, z3 = _zero(6, t_wc), _zero(3, t_wc)
        r = res(z6, z3)
        Jp = jacfwd(res, argnums=0)(z6, z3)[:, 0]
        Jl = jacfwd(res, argnums=1)(z6, z3)[:, 0]
        return _mask(valid, r), _mask(valid, Jp), _mask(valid, Jl)

    return vmap(one)(window.R[p], window.t[p], window.planes[l], f.pi_meas,
                     f.sqrt_info, f.valid)


def _prior_terms(window: Window, f: PosePriors):
    """Residuals + jacfwd Jacobians of all pose priors: (r (P,6),
    J (P,6,6)), zero where invalid."""
    idx = f.idx.long()

    def one(R, t, Rp, tp, A, valid):
        R, t, Rp, tp, A = _unit(R, t, Rp, tp, A)

        def res(xi):
            return prior_residual(R, t, Rp, tp, A, xi)[0]

        z = _zero(6, t)
        return _mask(valid, res(z)), _mask(valid, jacfwd(res)(z)[:, 0])

    return vmap(one)(window.R[idx], window.t[idx], f.R, f.t, f.sqrt_info,
                     f.valid)


def _odom_terms_analytic(window: Window, f: OdomFactors):
    """Closed-form residuals + Jacobians of all odometry factors:
    dr/dxi_j = A Jr^-1(r0), dr/dxi_i = -A Jr^-1(r0) Ad(T_j^-1 T_i)."""
    i, j = f.i.long(), f.j.long()
    Ri, ti = window.R[i], window.t[i]
    Rj, tj = window.R[j], window.t[j]
    R_rel, t_rel = se3.se3_between(Ri, ti, Rj, tj)
    R_err, t_err = se3.se3_between(f.R_meas, f.t_meas, R_rel, t_rel)
    r0 = se3.se3_log(R_err, t_err)
    AJ = f.sqrt_info @ se3.se3_right_jacobian_inv(r0)
    R_ji, t_ji = se3.se3_between(Rj, tj, Ri, ti)
    Ji = -(AJ @ se3.se3_adjoint(R_ji, t_ji))
    r = _mv(f.sqrt_info, r0)
    v = f.valid
    return _mask(v, r), _mask(v, Ji), _mask(v, AJ)


def _prior_terms_analytic(window: Window, f: PosePriors):
    """r = A log(P^-1 T exp(xi)), dr/dxi = A Jr^-1(r0)."""
    idx = f.idx.long()
    R, t = window.R[idx], window.t[idx]
    R_err, t_err = se3.se3_between(f.R, f.t, R, t)
    r0 = se3.se3_log(R_err, t_err)
    J = f.sqrt_info @ se3.se3_right_jacobian_inv(r0)
    r = _mv(f.sqrt_info, r0)
    return _mask(f.valid, r), _mask(f.valid, J)


def _hess(Ja, Jb):
    return torch.einsum("fab,fac->fbc", Ja, Jb)


def _grad(J, r):
    return torch.einsum("fab,fa->fb", J, r)


def linearize(window: Window, factors: Factors, analytic_planes: bool = False,
              robust: RobustConfig | None = None,
              analytic_poses: bool = True) -> Linearization:
    """Blocked Gauss-Newton normal equations of the window.

    ``analytic_planes=True`` takes the plane terms in closed form (the
    plane-Jacobian kernel on CUDA tensors), ``False`` by per-factor
    ``jacfwd``; ``analytic_poses`` picks the same for the odometry and
    prior terms.  The defaults are the reference's."""
    if robust is None:
        robust = RobustConfig()
    W = window.window_size
    L = window.max_landmarks
    dt, dev = window.t.dtype, window.t.device

    Hpp = torch.zeros((W, W, 6, 6), dtype=dt, device=dev)
    Hpl = torch.zeros((W, L, 6, 3), dtype=dt, device=dev)
    Hll = torch.zeros((L, 3, 3), dtype=dt, device=dev)
    bp = torch.zeros((W, 6), dtype=dt, device=dev)
    bl = torch.zeros((L, 3), dtype=dt, device=dev)

    # --- odometry ---
    odom_terms = _odom_terms_analytic if analytic_poses else _odom_terms
    r_o, Ji, Jj = odom_terms(window, factors.odom)
    r_o, Ji, Jj, rho_o = apply_weights(robust.odom, r_o, Ji, Jj)
    hij = _hess(Ji, Jj)
    oi, oj = factors.odom.i.long(), factors.odom.j.long()
    Hpp.index_put_((oi, oi), _hess(Ji, Ji), accumulate=True)
    Hpp.index_put_((oi, oj), hij, accumulate=True)
    Hpp.index_put_((oj, oi), hij.transpose(-1, -2), accumulate=True)
    Hpp.index_put_((oj, oj), _hess(Jj, Jj), accumulate=True)
    bp.index_put_((oi,), _grad(Ji, r_o), accumulate=True)
    bp.index_put_((oj,), _grad(Jj, r_o), accumulate=True)
    cost = 0.5 * torch.sum(rho_o)

    # --- plane observations (K5 on CUDA tensors when analytic) ---
    if analytic_planes:
        from ..ops.plane_jacobians import plane_terms

        r_f, Jp, Jl = plane_terms(window, factors.planes)
    else:
        r_f, Jp, Jl = _plane_terms(window, factors.planes)
    r_f, Jp, Jl, rho_f = apply_weights(robust.plane, r_f, Jp, Jl)
    pi_, li_ = factors.planes.pose_idx.long(), factors.planes.lm_idx.long()
    Hpp.index_put_((pi_, pi_), _hess(Jp, Jp), accumulate=True)
    Hpl.index_put_((pi_, li_), _hess(Jp, Jl), accumulate=True)
    Hll.index_put_((li_,), _hess(Jl, Jl), accumulate=True)
    bp.index_put_((pi_,), _grad(Jp, r_f), accumulate=True)
    bl.index_put_((li_,), _grad(Jl, r_f), accumulate=True)
    cost = cost + 0.5 * torch.sum(rho_f)

    # --- priors ---
    prior_terms = _prior_terms_analytic if analytic_poses else _prior_terms
    r_p, Jq = prior_terms(window, factors.priors)
    r_p, Jq, rho_p = apply_weights(robust.prior, r_p, Jq)
    qi = factors.priors.idx.long()
    Hpp.index_put_((qi, qi), _hess(Jq, Jq), accumulate=True)
    bp.index_put_((qi,), _grad(Jq, r_p), accumulate=True)
    cost = cost + 0.5 * torch.sum(rho_p)

    return Linearization(Hpp, Hpl, Hll, bp, bl, cost)


def total_cost(window: Window, factors: Factors,
               robust: RobustConfig | None = None) -> torch.Tensor:
    """0.5 * sum rho(||r||^2) of the whitened residuals."""
    if robust is None:
        robust = RobustConfig()
    od, pf, pr = factors.odom, factors.planes, factors.priors
    i, j = od.i.long(), od.j.long()
    r_o = _mask(od.valid, odom_residual(
        window.R[i], window.t[i], window.R[j], window.t[j],
        od.R_meas, od.t_meas, od.sqrt_info))
    p, l = pf.pose_idx.long(), pf.lm_idx.long()
    r_f = _mask(pf.valid, plane_residual(
        window.R[p], window.t[p], window.planes[l], pf.pi_meas,
        pf.sqrt_info))
    q = pr.idx.long()
    r_p = _mask(pr.valid, prior_residual(
        window.R[q], window.t[q], pr.R, pr.t, pr.sqrt_info))
    return 0.5 * (
        torch.sum(_rho(robust.odom, torch.sum(r_o * r_o, -1)))
        + torch.sum(_rho(robust.plane, torch.sum(r_f * r_f, -1)))
        + torch.sum(_rho(robust.prior, torch.sum(r_p * r_p, -1)))
    )
