"""Powell's dog-leg trust-region solver over poses + planes.

Port of ``pop_up_slam_tpu/solver/dogleg.py``: a fixed number of
iterations whose step choice, accept/reject and trust-radius update are
branch-free ``torch.where`` selects on 0-d device tensors (no host read
per iteration), with the Gauss-Newton subproblem solved by the same
reduced solve as the GN/LM drivers.

Step selection on the blocked system:

- ``dx_gn``: the Schur-eliminated Gauss-Newton step;
- ``dx_sd``: the Cauchy point -alpha g, alpha = g^T g / g^T H g;
- |dx_gn| <= Delta -> dx_gn; elif alpha |g| >= Delta -> (Delta/|g|)(-g);
  else dx_sd + beta (dx_gn - dx_sd) with |dx| = Delta.

Trust radius: shrink to a quarter of the step when the gain ratio rho <
0.25, double (up to ``delta_max``) when rho > 0.75 and the step hit the
boundary; clipped to [1e-8, ``delta_max``].
"""

from __future__ import annotations

import torch

from ..factors.graph import (Factors, Linearization, Window, linearize,
                             total_cost)
from .gauss_newton import apply_update, select_window, stack_stats
from .schur import solve_schur


def _masks(window: Window):
    free_p = (window.pose_valid & (~window.pose_fixed)).to(window.t.dtype)
    return free_p, window.lm_valid.to(window.t.dtype)


def _grad(lin: Linearization, window: Window):
    """Masked gradient g = (bp, bl) of 0.5||r||^2 (zero on fixed/invalid)."""
    free_p, free_l = _masks(window)
    return lin.bp * free_p[:, None], lin.bl * free_l[:, None]


def _hvp(lin: Linearization, window: Window, vp, vl):
    """Blocked Hessian-vector product H v with gauge masking."""
    free_p, free_l = _masks(window)
    vp = vp * free_p[:, None]
    vl = vl * free_l[:, None]
    hp = (torch.einsum("wvab,vb->wa", lin.Hpp, vp)
          + torch.einsum("wlab,lb->wa", lin.Hpl, vl))
    hl = (torch.einsum("wlab,wa->lb", lin.Hpl, vp)
          + torch.einsum("lab,lb->la", lin.Hll, vl))
    return hp * free_p[:, None], hl * free_l[:, None]


def _dot(ap, al, bp, bl):
    return torch.sum(ap * bp) + torch.sum(al * bl)


def _norm(ap, al):
    return torch.sqrt(torch.clamp(_dot(ap, al, ap, al), min=1e-30))


def dogleg_solve(window: Window, factors: Factors, iters: int = 10,
                 delta0: float = 1.0, delta_max: float = 100.0,
                 solve_fn=solve_schur, robust=None,
                 analytic_planes: bool = False):
    """Fixed-iteration Powell's dog-leg.  Returns (window, SolveStats);
    ``SolveStats.lambdas`` holds the trust radius of each iteration."""
    dev = window.t.device
    delta = torch.full((), delta0, dtype=torch.float32, device=dev)
    cost = total_cost(window, factors, robust=robust)
    costs, norms, deltas, accepted = [], [], [], []
    for _ in range(iters):
        lin = linearize(window, factors, analytic_planes=analytic_planes,
                        robust=robust)
        gp, gl = _grad(lin, window)

        # Gauss-Newton step (tiny damping only for numerical safety)
        sol = solve_fn(lin, window, 1e-9)
        gnp, gnl = sol.dxp, sol.dxl
        gn_norm = _norm(gnp, gnl)

        # Cauchy point -alpha g
        hp, hl = _hvp(lin, window, gp, gl)
        gTg = _dot(gp, gl, gp, gl)
        gHg = torch.clamp(_dot(gp, gl, hp, hl), min=1e-30)
        alpha = gTg / gHg
        sdp, sdl = -alpha * gp, -alpha * gl
        g_norm = torch.sqrt(torch.clamp(gTg, min=1e-30))

        # interpolation beta: |sd + beta (gn - sd)| = delta
        dp, dl = gnp - sdp, gnl - sdl
        a = torch.clamp(_dot(dp, dl, dp, dl), min=1e-30)
        b = 2.0 * _dot(sdp, sdl, dp, dl)
        c = _dot(sdp, sdl, sdp, sdl) - delta ** 2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        beta = torch.clamp((-b + torch.sqrt(disc)) / (2 * a), 0.0, 1.0)

        use_gn = gn_norm <= delta
        use_sc = (~use_gn) & (alpha * g_norm >= delta)
        scale_g = delta / g_norm
        dxp = torch.where(use_gn, gnp,
                          torch.where(use_sc, -scale_g * gp, sdp + beta * dp))
        dxl = torch.where(use_gn, gnl,
                          torch.where(use_sc, -scale_g * gl, sdl + beta * dl))
        hit_boundary = ~use_gn

        # gain ratio: actual vs model decrease m(0) - m(dx)
        hdp, hdl = _hvp(lin, window, dxp, dxl)
        model_dec = -(_dot(gp, gl, dxp, dxl)
                      + 0.5 * _dot(dxp, dxl, hdp, hdl))
        w_try = apply_update(window, dxp, dxl)
        cost_try = total_cost(w_try, factors, robust=robust)
        actual_dec = cost - cost_try
        rho = actual_dec / torch.clamp(model_dec, min=1e-30)

        accept = (actual_dec > 0.0) & (model_dec > 0.0)
        step_norm = _norm(dxp, dxl)
        costs.append(cost)
        norms.append(step_norm)
        deltas.append(delta)
        accepted.append(accept)
        window = select_window(accept, w_try, window)
        cost = torch.where(accept, cost_try, cost)
        delta = torch.where(
            rho < 0.25, 0.25 * step_norm,
            torch.where((rho > 0.75) & hit_boundary,
                        torch.clamp(2.0 * delta, max=delta_max), delta))
        delta = torch.clamp(delta, 1e-8, delta_max)
    return window, stack_stats(costs + [cost], norms, deltas, accepted, dev)
