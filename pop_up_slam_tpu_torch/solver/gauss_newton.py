"""Windowed Gauss-Newton / Levenberg-Marquardt over poses + planes.

Port of ``gn_solve``, ``lm_solve``, ``sanitize_step`` and
``apply_update`` from ``pop_up_slam_tpu/solver/gauss_newton.py``; the
reference's ``lax.scan`` over iterations is a Python loop.  LM's
accept/reject is branch-free (``torch.where``) and its lambda a 0-d
tensor on the window's device, so an iteration never reads the device
from the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.graph import Factors, Window, linearize, total_cost
from ..geometry import plane as plane_mod
from ..geometry import se3
from .schur import solve_schur


class SolveStats(NamedTuple):
    cost_history: torch.Tensor   # (K+1,)
    step_norms: torch.Tensor     # (K,)
    lambdas: torch.Tensor        # (K,)
    accepted: torch.Tensor       # (K,) bool


def sanitize_step(dxp: torch.Tensor, dxl: torch.Tensor,
                  max_norm: float = 1e3):
    """Zero a step that is non-finite or divergently large (a failed
    factorization keeps the current estimate).  Returns (dxp, dxl, ok);
    ``ok`` stays on the device (no host sync)."""
    sq = torch.sum(dxp * dxp) + torch.sum(dxl * dxl)
    ok = torch.isfinite(sq) & (sq < max_norm * max_norm)
    zero = torch.zeros((), dtype=dxp.dtype, device=dxp.device)
    return torch.where(ok, dxp, zero), torch.where(ok, dxl, zero), ok


def apply_update(window: Window, dxp: torch.Tensor, dxl: torch.Tensor,
                 presanitized: bool = False) -> Window:
    """Retract pose and landmark updates onto the manifold."""
    if not presanitized:
        dxp, dxl, _ = sanitize_step(dxp, dxl)
    R_new, t_new = se3.se3_retract(window.R, window.t, dxp)
    free = (window.pose_valid & (~window.pose_fixed))[:, None]
    R_new = torch.where(free[..., None], R_new, window.R)
    t_new = torch.where(free, t_new, window.t)
    planes_new = plane_mod.retract(window.planes, dxl)
    planes_new = torch.where(window.lm_valid[:, None], planes_new,
                             window.planes)
    return window._replace(R=R_new, t=t_new, planes=planes_new)


def gn_solve(window: Window, factors: Factors, iters: int = 5,
             damping: float = 1e-6, solve_fn=solve_schur,
             analytic_planes: bool = False, robust=None):
    """Fixed-iteration damped Gauss-Newton.  Returns (window, SolveStats).
    Only the analytic linearization is ported, so ``analytic_planes``
    must be True."""
    costs, norms = [], []
    for _ in range(iters):
        lin = linearize(window, factors, analytic_planes=analytic_planes,
                        robust=robust)
        sol = solve_fn(lin, window, damping)
        dxp, dxl, _ = sanitize_step(sol.dxp, sol.dxl)
        window = apply_update(window, dxp, dxl, presanitized=True)
        costs.append(lin.cost)
        norms.append(torch.sqrt(torch.sum(dxp ** 2) + torch.sum(dxl ** 2)))
    final_cost = total_cost(window, factors, robust=robust)
    dev = window.t.device
    return window, SolveStats(
        cost_history=torch.stack(costs + [final_cost]),
        step_norms=torch.stack(norms) if norms else torch.zeros((0,),
                                                              device=dev),
        lambdas=torch.full((iters,), damping, device=dev),
        accepted=torch.ones((iters,), dtype=torch.bool, device=dev),
    )


def stack_stats(costs, norms, lams, accepted, dev) -> SolveStats:
    """SolveStats from per-iteration lists of 0-d tensors."""
    def stack(xs, dtype=torch.float32):
        return (torch.stack(xs) if xs
                else torch.zeros((0,), dtype=dtype, device=dev))

    return SolveStats(torch.stack(costs), stack(norms), stack(lams),
                      stack(accepted, torch.bool))


def select_window(accept: torch.Tensor, a: Window, b: Window) -> Window:
    """``a`` where the 0-d bool ``accept`` holds, else ``b``, field by
    field, on the device."""
    return Window(*(torch.where(accept, x, y) for x, y in zip(a, b)))


def lm_solve(window: Window, factors: Factors, iters: int = 8,
             lam0: float = 1e-4, lam_up: float = 10.0, lam_down: float = 0.3,
             solve_fn=solve_schur, analytic_planes: bool = False,
             robust=None):
    """Levenberg-Marquardt with branch-free accept/reject: a step is kept
    when it lowers the cost (lambda x ``lam_down``), else the window is
    kept (lambda x ``lam_up``); lambda is clipped to [1e-9, 1e6].
    Returns (window, SolveStats)."""
    dev = window.t.device
    lam = torch.full((), lam0, dtype=torch.float32, device=dev)
    cost = total_cost(window, factors, robust=robust)
    costs, norms, lambdas, accepted = [], [], [], []
    for _ in range(iters):
        lin = linearize(window, factors, analytic_planes=analytic_planes,
                        robust=robust)
        sol = solve_fn(lin, window, lam)
        w_try = apply_update(window, sol.dxp, sol.dxl)
        cost_try = total_cost(w_try, factors, robust=robust)
        accept = cost_try < cost
        costs.append(cost)
        norms.append(torch.sqrt(torch.sum(sol.dxp ** 2)
                                + torch.sum(sol.dxl ** 2)))
        lambdas.append(lam)
        accepted.append(accept)
        window = select_window(accept, w_try, window)
        lam = torch.clamp(torch.where(accept, lam * lam_down, lam * lam_up),
                          1e-9, 1e6)
        cost = torch.where(accept, cost_try, cost)
    return window, stack_stats(costs + [cost], norms, lambdas, accepted, dev)
