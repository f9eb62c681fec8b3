"""K6 and K7: the Levenberg-Marquardt iteration around K5 and K3a in two
CUDA kernels, and their plain PyTorch versions.

On CUDA tensors :func:`..solver.gauss_newton.lm_solve` runs an iteration
as four launches: K5 (:func:`.plane_jacobians.plane_terms`), **K6**
:func:`lm_assemble`, K3a (:func:`.schur.schur_reduce_small`) and **K7**
:func:`lm_trial`; one more K7 launch, with no step, takes the window's
first cost.  The kernels (``csrc/lm_step.cu``) replace no TPU kernel:
they replace the PyTorch glue between K5 and K3a, ~1,300-2,000 launches
an iteration for ~1 MFLOP of work, and are latency-bound like K1.

- K6 weights K5's plane terms (IRLS), linearizes the odometry and prior
  factors, assembles the normal equations by gathering (no atomics) and
  writes K3a's operands as :func:`.schur.reduce_operands` lays them out,
  plus Hll^-1 and bl for the back-substitution (:class:`Operands`).
- K7 takes K3a's solution: the back-substitution, the step norm,
  ``sanitize_step``, the retraction, the trial cost, the accept test and
  the lambda update; it writes iteration k's entries of the call's
  statistics in place (:class:`LMStats`) and the selected window to fresh
  buffers.  Lambda and the decision never leave the device.

Both receive the window and factors as K1 does (:func:`._problem.pack`,
once a call, and ``csrc/factor_graph.cuh``).

The plain versions compose the per-op functions they replace:
:func:`lm_assemble_plain` is ``reduce_operands(linearize(...))``, and
:func:`lm_trial_plain` is ``_reduce``'s back-substitution with
``apply_update``, ``total_cost`` and ``lm_solve``'s accept/reject.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.graph import Factors, Window, linearize, total_cost
from ..factors.robust import RobustConfig
from ..solver.gauss_newton import apply_update, select_window
from ._build import check_inputs, library
from ._problem import MAX_SMEM, Packed, _launch, check_window, pack
from .schur import reduce_operands


class Operands(NamedTuple):
    """K3a's operands (``reduce_operands``' layout, f32, contiguous) and
    what the back-substitution reads."""

    Hpp: torch.Tensor      # (6W, 6W)
    B: torch.Tensor        # (6W, 3L) Hpl (Hll + lambda I)^-1
    G: torch.Tensor        # (6W, 3L) Hpl
    rhs: torch.Tensor      # (6W,) -(bp - B bl)
    pm: torch.Tensor       # (6W,) the free-pose mask
    Hll_inv: torch.Tensor  # (L, 3, 3) (Hll + lambda I)^-1, I where invalid
    bl: torch.Tensor       # (L, 3)


class LMStats(NamedTuple):
    """One ``lm_solve`` call's statistics, written in place iteration by
    iteration: ``costs`` (K+1,), ``lams`` (K+1,) (each iteration's lambda,
    then the one after the last), ``norms`` (K,), ``accepted`` (K,)."""

    costs: torch.Tensor
    lams: torch.Tensor
    norms: torch.Tensor
    accepted: torch.Tensor


def new_stats(iters: int, device) -> LMStats:
    """Empty :class:`LMStats` buffers for ``iters`` iterations."""
    f32 = torch.float32
    return LMStats(torch.empty((iters + 1,), dtype=f32, device=device),
                   torch.empty((iters + 1,), dtype=f32, device=device),
                   torch.empty((iters,), dtype=f32, device=device),
                   torch.empty((iters,), dtype=torch.bool, device=device))


def lm_step_supported(W: int, L: int, F: int, O: int, P: int) -> bool:
    """Shape gate: the per-landmark observer masks are 64 bits wide, and
    each kernel's problem fits one block's shared memory, as the kernels'
    own layout (``popup_lm_smem_bytes``) sizes it.  Reads the kernel
    library: call it for CUDA tensors only."""
    if not (1 <= W <= 64 and L >= 1):
        return False
    smem = library().popup_lm_smem_bytes
    return max(smem(W, L, F, O, P, 0), smem(W, L, F, O, P, 1)) <= MAX_SMEM


def lm_assemble_plain(window: Window, factors: Factors, lam: torch.Tensor,
                      robust: RobustConfig | None = None) -> Operands:
    """Plain version of K6: the per-op linearization (K5's plain form for
    the plane terms) and ``reduce_operands``."""
    lin = linearize(window, factors, analytic_planes=True, robust=robust)
    Hll_inv, B, G, Hpp, pm, rp = reduce_operands(lin, window, lam)
    return Operands(Hpp, B, G, -rp, pm, Hll_inv, lin.bl)


def lm_assemble(window: Window, factors: Factors, terms, lam: torch.Tensor,
                robust: RobustConfig | None = None,
                packed: Packed | None = None) -> Operands:
    """K6: K3a's operands at ``window`` from K5's ``terms`` (r, Jp, Jl) and
    lambda (a 0-d device tensor).  CUDA tensors launch the kernel; CPU
    tensors run :func:`lm_assemble_plain` (which linearizes itself)."""
    dev = window.t.device
    if dev.type == "cpu":
        return lm_assemble_plain(window, factors, lam, robust)
    if dev.type != "cuda":
        raise ValueError(f"lm_assemble: unsupported device {dev}")
    if packed is None:
        packed = pack(window, factors, robust)
    W, L, F = packed.ints[:3]
    r, Jp, Jl = terms
    check_window("lm_assemble", window)
    check_inputs("lm_assemble", dev, (r, (F, 3)), (Jp, (F, 3, 6)),
                 (Jl, (F, 3, 3)), (lam, ()))
    n6, n3 = 6 * W, 3 * L
    f32 = torch.float32
    ops = Operands(*(torch.empty(s, dtype=f32, device=dev) for s in (
        (n6, n6), (n6, n3), (n6, n3), (n6,), (n6,), (L, 3, 3), (L, 3))))
    lm_assemble.launches += 1
    _launch(library().popup_lm_assemble, "lm_assemble", window, packed,
            (r, Jp, Jl, lam, *ops))
    return ops


lm_assemble.launches = 0


def lm_trial_plain(window: Window, factors: Factors, stats: LMStats, k: int,
                   step=None, lam0: float = 1e-4, lam_up: float = 10.0,
                   lam_down: float = 0.3,
                   robust: RobustConfig | None = None) -> Window | None:
    """Plain version of K7 (same arguments and returns)."""
    if step is None:
        stats.costs[0] = total_cost(window, factors, robust=robust)
        stats.lams[0] = lam0
        return None
    x, ops = step
    W, L = window.window_size, window.max_landmarks
    dt = window.t.dtype
    dxp = (x.reshape(W, 6) * ops.pm.reshape(W, 6)).to(dt)
    Hpl = ops.G.reshape(W, 6, L, 3).permute(0, 2, 1, 3).contiguous()
    rhs = ops.bl + torch.einsum("wlab,wa->lb", Hpl, dxp)
    dxl = -torch.einsum("lab,lb->la", ops.Hll_inv, rhs)
    dxl = dxl * window.lm_valid[:, None].to(dt)
    w_try = apply_update(window, dxp, dxl)
    cost_try = total_cost(w_try, factors, robust=robust)
    cost, lam = stats.costs[k], stats.lams[k]
    accept = cost_try < cost
    stats.norms[k] = torch.sqrt(torch.sum(dxp ** 2) + torch.sum(dxl ** 2))
    stats.accepted[k] = accept
    stats.lams[k + 1] = torch.clamp(
        torch.where(accept, lam * lam_down, lam * lam_up), 1e-9, 1e6)
    stats.costs[k + 1] = torch.where(accept, cost_try, cost)
    return select_window(accept, w_try, window)


def lm_trial(window: Window, factors: Factors, stats: LMStats, k: int,
             step=None, lam0: float = 1e-4, lam_up: float = 10.0,
             lam_down: float = 0.3, robust: RobustConfig | None = None,
             packed: Packed | None = None) -> Window | None:
    """K7.  With ``step`` = (x, operands), x K3a's solution at iteration
    ``k``: the trial step from ``window``, its cost against
    ``stats.costs[k]``, the accept decision and the next lambda and cost
    into ``stats`` (entries k of ``norms``, ``accepted``, k + 1 of
    ``costs``, ``lams``), and returns the selected window (fresh R, t,
    planes; the masks are ``window``'s).  With ``step`` None: the cost of
    ``window`` into ``stats.costs[0]`` and ``lam0`` into
    ``stats.lams[0]``; returns None.  CUDA tensors launch the kernel; CPU
    tensors run :func:`lm_trial_plain`."""
    dev = window.t.device
    if dev.type == "cpu":
        return lm_trial_plain(window, factors, stats, k, step, lam0, lam_up,
                              lam_down, robust)
    if dev.type != "cuda":
        raise ValueError(f"lm_trial: unsupported device {dev}")
    if packed is None:
        packed = pack(window, factors, robust)
    W, L = packed.ints[:2]
    K = stats.norms.shape[0]
    check_window("lm_trial", window)
    check_inputs("lm_trial", dev, (stats.costs, (K + 1,)),
                 (stats.lams, (K + 1,)), (stats.norms, (K,)),
                 (stats.accepted, (K,), torch.bool))
    if not 0 <= k < max(K, 1):
        raise ValueError(f"lm_trial: iteration {k} outside 0..{K - 1}")
    out = (None, None, None)
    if step is not None:
        x, ops = step
        check_inputs("lm_trial", dev, (x, (6 * W,)), (ops.G, (6 * W, 3 * L)),
                     (ops.Hll_inv, (L, 3, 3)), (ops.bl, (L, 3)))
        f32 = torch.float32
        out = tuple(torch.empty(s, dtype=f32, device=dev)
                    for s in ((W, 3, 3), (W, 3), (L, 4)))
        own = (x, ops.G, ops.Hll_inv, ops.bl)
    else:
        own = (None,) * 4
    lm_trial.launches += 1
    _launch(library().popup_lm_trial, "lm_trial", window, packed,
            own + tuple(stats) + out, ints=(k,),
            floats=(lam0, lam_up, lam_down))
    if step is None:
        return None
    return window._replace(R=out[0], t=out[1], planes=out[2])


lm_trial.launches = 0
