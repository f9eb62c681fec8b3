"""Frozen copy of the port's Levenberg-Marquardt solve for the benchmark's
plain reference (kernels replaced by their plain versions).

``lm_solve``, ``select_window`` and ``stack_stats`` of the port's
``solver/gauss_newton.py``: the iterations are a Python loop; a step is
kept when it lowers the cost (lambda x ``lam_down``), else the window is
kept (lambda x ``lam_up``), branch-free on the window's device.  The
linearization takes the analytic plane terms in their plain form (K5's),
and :func:`route` picks the reduced solve the program's
``make_solve_fn`` picks on the program's device, in its plain form:
``schur_reduce_plain`` where the program launches the Schur kernels
(K3a at W=8), ``solve_schur`` where it does not.

:func:`solve_impl` is the whole windowed solve of a keyframe as the
program's frame step calls it with ``solver="lm"``; the reference's
frame step takes it through its ``solve_impl`` argument.
"""

from __future__ import annotations

import torch

from ..factors.graph import Factors, Window, linearize, total_cost
from ..ops.schur import schur_reduce_plain
from .gauss_newton import SolveStats, apply_update
from .schur import solve_schur


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
    """Levenberg-Marquardt with branch-free accept/reject; lambda is
    clipped to [1e-9, 1e6].  Returns (window, SolveStats)."""
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


def route(pallas: str, program_device: str):
    """The plain form of the reduced solve that the program's
    ``make_solve_fn(pallas)`` takes on a ``program_device`` tensor: the
    Schur kernels' (``"on"``, or ``"auto"`` on CUDA) or ``solve_schur``
    (``"off"``, or ``"auto"`` elsewhere)."""
    if pallas not in ("auto", "on", "off"):
        raise ValueError(f"pallas must be auto|on|off, got {pallas!r}")
    kernels = pallas == "on" or (pallas == "auto"
                                 and program_device == "cuda")
    return schur_reduce_plain if kernels else solve_schur


def solve_impl(cfg, program_device: str, record: list):
    """``(window, factors) -> window``: the keyframe's LM solve as the
    program's frame step runs it (``cfg.gn_iters`` iterations from
    lambda ``max(cfg.damping, 1e-6)``); each solve's SolveStats are
    appended to ``record``."""
    fn = route(cfg.pallas, program_device)

    def solve(window: Window, factors: Factors) -> Window:
        out, stats = lm_solve(window, factors, iters=cfg.gn_iters,
                              lam0=max(cfg.damping, 1e-6), solve_fn=fn,
                              analytic_planes=cfg.analytic_planes,
                              robust=cfg.robust)
        record.append(stats)
        return out

    return solve
