"""Frozen copy of the port's ``ops/schur.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Schur reduction of the landmarks and the reduced solve, plain PyTorch.

Frozen copy of the port's ``ops/schur.py`` plain route (K3a's and K3b's
plain versions): with B = Hpl Hll^-1 and G = Hpl flattened to (6W x 3L),
S = Hpp - B G^T, + lambda I, free-pose mask, S dxp = -(bp - B bl) solved
with the pivot-skip rule, dxl = -Hll^-1 (bl + Hpl^T dxp).
"""

from __future__ import annotations

import torch

from ..solver.schur import SchurSolution, inv3x3
from .cholesky import chol_solve_plain

MAX_SMALL_N = 128


def damp_mask(S: torch.Tensor, lam: torch.Tensor,
              pm: torch.Tensor) -> torch.Tensor:
    """S + lambda I, rows/columns of masked poses zeroed, identity on
    their diagonal (``schur_pallas.py:195-198``)."""
    S = S + lam * torch.eye(S.shape[0], dtype=S.dtype, device=S.device)
    S = S * pm[None, :] * pm[:, None]
    return S + torch.diag(1.0 - pm)


def schur_gemm_plain(Hpp: torch.Tensor, B: torch.Tensor,
                     G: torch.Tensor) -> torch.Tensor:
    """Plain version of K3b: Hpp - B G^T."""
    return Hpp - B @ G.T


def schur_reduce_small_plain(Hpp, B, G, rhs, pm, lam):
    """Plain version of K3a: (S, x) with S damped and masked and
    S x = rhs * pm solved with the pivot-skip rule."""
    S = damp_mask(schur_gemm_plain(Hpp, B, G), lam, pm)
    return S, chol_solve_plain(S, rhs * pm)


def _lam(damping, dev) -> torch.Tensor:
    """Damping as a 0-d f32 tensor on ``dev`` (a fill, not a host copy)."""
    if isinstance(damping, torch.Tensor):
        return damping.to(device=dev, dtype=torch.float32).reshape(())
    return torch.full((), float(damping), dtype=torch.float32, device=dev)


def reduce_operands(lin, window, lam: torch.Tensor):
    """The flattened operands of the reduction (``schur_pallas.py:
    137-152``): (Hll^-1 (L,3,3), B and G (6W,3L), Hpp (6W,6W), the
    free-pose mask pm (6W,), rp = bp - B bl (6W,)), f32, contiguous."""
    W, L = lin.bp.shape[0], lin.bl.shape[0]
    dt, dev = lin.bp.dtype, lin.bp.device
    f32 = torch.float32
    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hll = torch.where(window.lm_valid[:, None, None], lin.Hll + lam * eye3,
                      eye3)
    Hll_inv = inv3x3(Hll)
    Bw = torch.einsum("wlab,lbc->wlac", lin.Hpl, Hll_inv)
    B = Bw.permute(0, 2, 1, 3).reshape(6 * W, 3 * L).to(f32).contiguous()
    G = lin.Hpl.permute(0, 2, 1, 3).reshape(6 * W, 3 * L).to(f32).contiguous()
    Hpp = lin.Hpp.permute(0, 2, 1, 3).reshape(6 * W, 6 * W).to(f32)
    free = window.pose_valid & (~window.pose_fixed)
    pm = free.to(f32).repeat_interleave(6)
    rp = lin.bp.reshape(-1).to(f32) - B @ lin.bl.reshape(-1).to(f32)
    return Hll_inv, B, G, Hpp.contiguous(), pm, rp


def _reduce(lin, window, damping) -> SchurSolution:
    W = lin.bp.shape[0]
    dt = lin.bp.dtype
    lam = _lam(damping, lin.bp.device)
    Hll_inv, B, G, Hpp, pm, rp = reduce_operands(lin, window, lam)

    n = 6 * W
    if n <= MAX_SMALL_N:
        S, x = schur_reduce_small_plain(Hpp, B, G, -rp, pm, lam)
    else:
        S = damp_mask(schur_gemm_plain(Hpp, B, G), lam, pm)
        x = chol_solve_plain(S, -(rp * pm))

    dxp = (x.reshape(W, 6) * pm.reshape(W, 6)).to(dt)
    rhs = lin.bl + torch.einsum("wlab,wa->lb", lin.Hpl, dxp)
    dxl = -torch.einsum("lab,lb->la", Hll_inv, rhs)
    dxl = dxl * window.lm_valid[:, None].to(dt)
    return SchurSolution(dxp, dxl, S.to(dt))


def schur_reduce_plain(lin, window, damping=1e-6) -> SchurSolution:
    """Plain version of :func:`schur_reduce`, on any device."""
    return _reduce(lin, window, damping)
