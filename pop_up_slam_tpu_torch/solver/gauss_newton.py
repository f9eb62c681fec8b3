"""Windowed Gauss-Newton / Levenberg-Marquardt over poses + planes.

Port of ``gn_solve``, ``lm_solve``, ``sanitize_step`` and
``apply_update`` from ``pop_up_slam_tpu/solver/gauss_newton.py``; the
reference's ``lax.scan`` over iterations is a Python loop.  LM's
accept/reject is branch-free (``torch.where``) and its lambda a 0-d
tensor on the window's device, so an iteration never reads the device
from the host.  On CUDA tensors at K3a's sizes ``lm_solve`` runs an
iteration as four kernel launches (:func:`lm_solve_kernels`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.graph import Factors, Window, linearize, total_cost
from ..factors.robust import RobustConfig
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
    ``analytic_planes`` picks the closed-form plane Jacobians over the
    per-factor ``jacfwd`` ones (:func:`..factors.graph.linearize`)."""
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


def _lm_kernel_route(window: Window, factors: Factors, solve_fn,
                     analytic_planes: bool) -> bool:
    """Whether ``lm_solve``'s input takes the kernel route: f32 CUDA
    tensors, the analytic plane terms (K5), the Schur kernels' reduced
    solve (``make_solve_fn("auto")`` or ``"on"``) at 6W <= 128 (K3a), and
    shapes that fit the kernels' shared memory."""
    if (window.t.device.type != "cuda" or window.t.dtype != torch.float32
            or not analytic_planes):
        return False
    from ..ops import lm_step, schur
    from .schur import _auto_solve

    if solve_fn is not _auto_solve and solve_fn is not schur.schur_reduce:
        return False
    W = window.window_size
    return 6 * W <= schur.MAX_SMALL_N and lm_step.lm_step_supported(
        W, window.max_landmarks, factors.planes.valid.shape[0],
        factors.odom.valid.shape[0], factors.priors.valid.shape[0])


def lm_solve_kernels(window: Window, factors: Factors, iters: int = 8,
                     lam0: float = 1e-4, lam_up: float = 10.0,
                     lam_down: float = 0.3, robust=None):
    """``lm_solve``'s kernel route (same returns): each iteration K5, the
    assemble kernel K6, K3a and the trial kernel K7
    (:mod:`..ops.lm_step`), after one K7 launch for the first cost; the
    factors are packed once.  K5 and K3a are looked up on their modules
    at call time.  CPU tensors run each kernel's plain version: the same
    arithmetic as the per-op loop with the Schur kernels' plain solve
    (``make_solve_fn("on")``)."""
    from ..ops import lm_step, plane_jacobians, schur

    if robust is None:
        robust = RobustConfig()
    packed = lm_step.pack(window, factors, robust)
    stats = lm_step.new_stats(iters, window.t.device)
    lm_step.lm_trial(window, factors, stats, 0, lam0=lam0, robust=robust,
                     packed=packed)
    for k in range(iters):
        lam = stats.lams[k]
        terms = plane_jacobians.plane_terms(window, factors.planes)
        ops = lm_step.lm_assemble(window, factors, terms, lam, robust, packed)
        _, x = schur.schur_reduce_small(ops.Hpp, ops.B, ops.G, ops.rhs,
                                        ops.pm, lam)
        window = lm_step.lm_trial(window, factors, stats, k, (x, ops),
                                  lam_up=lam_up, lam_down=lam_down,
                                  robust=robust, packed=packed)
    return window, SolveStats(stats.costs, stats.norms, stats.lams[:iters],
                              stats.accepted)


def lm_solve(window: Window, factors: Factors, iters: int = 8,
             lam0: float = 1e-4, lam_up: float = 10.0, lam_down: float = 0.3,
             solve_fn=solve_schur, analytic_planes: bool = False,
             robust=None):
    """Levenberg-Marquardt with branch-free accept/reject: a step is kept
    when it lowers the cost (lambda x ``lam_down``), else the window is
    kept (lambda x ``lam_up``); lambda is clipped to [1e-9, 1e6].
    Returns (window, SolveStats).  Where :func:`_lm_kernel_route` admits
    the input it runs :func:`lm_solve_kernels`, four launches an
    iteration; elsewhere (CPU tensors, K3b + K4 at 6W > 128, ``pallas=
    "off"``, ``analytic_planes=False``) the per-op loop below."""
    if _lm_kernel_route(window, factors, solve_fn, analytic_planes):
        return lm_solve_kernels(window, factors, iters, lam0, lam_up,
                                lam_down, robust)
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
