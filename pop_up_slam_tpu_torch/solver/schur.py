"""Schur-complement elimination of plane landmarks + reduced-system solve.

Port of ``pop_up_slam_tpu/solver/schur.py``.  With
H = [[Hpp, Hpl], [Hpl^T, Hll]] and Hll block-diagonal 3x3 per plane:

    S  = Hpp - Hpl Hll^-1 Hpl^T
    rp = bp  - Hpl Hll^-1 bl
    S dxp = -rp ;   dxl = -Hll^-1 (bl + Hpl^T dxp)

This is the per-op path; the fused GN kernel (:mod:`..ops.fused_gn`)
runs the same chain in one launch and is held against it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.graph import Linearization, Window


def inv3x3(A: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate, |det| floored
    at 1e-12."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00 = e * i - f * h
    A01 = c * h - b * i
    A02 = b * f - c * e
    A10 = f * g - d * i
    A11 = a * i - c * g
    A12 = c * d - a * f
    A20 = d * h - e * g
    A21 = b * g - a * h
    A22 = a * e - b * d
    det = a * A00 + b * A10 + c * A20
    safe = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12),
                       det)
    adj = torch.stack(
        [
            torch.stack([A00, A01, A02], -1),
            torch.stack([A10, A11, A12], -1),
            torch.stack([A20, A21, A22], -1),
        ],
        -2,
    )
    return adj / safe[..., None, None]


class SchurSolution(NamedTuple):
    dxp: torch.Tensor  # (W, 6)
    dxl: torch.Tensor  # (L, 3)
    S: torch.Tensor    # (6W, 6W)


def cholesky_nan(S: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor whose lower triangle is NaN where S is not
    positive definite.

    ``jnp.linalg.cholesky`` returns that on a non-PD input and the
    solvers' ``sanitize_step`` relies on it; ``torch.linalg.cholesky``
    raises instead, so take ``cholesky_ex`` and fill on ``info != 0``."""
    L, info = torch.linalg.cholesky_ex(S)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.tril(torch.full_like(L, float("nan"))), L)


def solve_schur(lin: Linearization, window: Window,
                damping=1e-6) -> SchurSolution:
    """Eliminate landmarks, solve the reduced pose system, back-substitute.
    Gauge-fixed / invalid poses and invalid landmarks are masked to an
    identity diagonal (their update is 0)."""
    W, L = lin.bp.shape[0], lin.bl.shape[0]
    dt, dev = lin.bp.dtype, lin.bp.device
    lam = damping

    eye3 = torch.eye(3, dtype=dt, device=dev)
    Hll = lin.Hll + lam * eye3
    lm_mask = window.lm_valid
    Hll = torch.where(lm_mask[:, None, None], Hll, eye3)
    Hll_inv = inv3x3(Hll)

    HplWinv = torch.einsum("wlab,lbc->wlac", lin.Hpl, Hll_inv)
    S_blocks = lin.Hpp - torch.einsum("wlac,vlbc->wvab", HplWinv, lin.Hpl)
    rp = lin.bp - torch.einsum("wlab,lb->wa", HplWinv, lin.bl)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.eye(W, dtype=dt, device=dev)[:, :, None, None] * eye6
    S_blocks = S_blocks + lam * diag

    free = window.pose_valid & (~window.pose_fixed)
    pm = free.to(dt)
    S_blocks = S_blocks * pm[:, None, None, None] * pm[None, :, None, None]
    S_blocks = S_blocks + diag * (1.0 - pm)[:, None, None, None]
    rp = rp * pm[:, None]

    S = S_blocks.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    chol = cholesky_nan(S)
    y = torch.linalg.solve_triangular(chol, -rp.reshape(6 * W, 1),
                                      upper=False)
    dxp_flat = torch.linalg.solve_triangular(chol.T, y, upper=True)
    dxp = dxp_flat.reshape(W, 6) * pm[:, None]

    rhs = lin.bl + torch.einsum("wlab,wa->lb", lin.Hpl, dxp)
    dxl = -torch.einsum("lab,lb->la", Hll_inv, rhs)
    dxl = dxl * lm_mask[:, None].to(dt)
    return SchurSolution(dxp, dxl, S)


def spd_inv6_blocked(H: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Closed-form 6x6 SPD inverse via 3x3 block elimination."""
    A = H[..., :3, :3]
    B = H[..., :3, 3:]
    D = H[..., 3:, 3:]
    Ai = inv3x3(A, eps)
    AiB = Ai @ B
    S = D - B.transpose(-1, -2) @ AiB
    Si = inv3x3(S, eps)
    TR = -AiB @ Si
    TL = Ai - TR @ AiB.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def chol_small(A: torch.Tensor) -> torch.Tensor:
    """Unrolled right-looking Cholesky of a small SPD matrix (lower
    factor), pivots floored at 1e-12."""
    n = A.shape[-1]
    rows = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    for j in range(n):
        d = torch.sqrt(torch.clamp(A[..., j, j], min=1e-12))
        col = torch.where(rows >= j, A[..., :, j] / d[..., None],
                          torch.zeros_like(A[..., :, j]))
        L[..., :, j] = col
        A = A - col[..., :, None] * col[..., None, :]
    return L


def cho_solve_small(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve (L L^T) X = B by substitution; L (..., n, n), B (..., n, m)."""
    n = L.shape[-1]
    rows = torch.arange(n, device=L.device)
    Y = B.clone()
    for i in range(n):
        yi = Y[..., i, :] / L[..., i, i, None]
        upd = torch.where((rows > i)[:, None],
                          L[..., :, i, None] * yi[..., None, :],
                          torch.zeros_like(Y))
        Y = Y - upd
        Y[..., i, :] = yi
    X = Y
    for i in range(n - 1, -1, -1):
        xi = X[..., i, :] / L[..., i, i, None]
        upd = torch.where((rows < i)[:, None],
                          L[..., i, :, None] * xi[..., None, :],
                          torch.zeros_like(X))
        X = X - upd
        X[..., i, :] = xi
    return X


def make_solve_fn(pallas: str = "auto"):
    """Select the reduced-system solver.  ``"auto"`` and ``"off"`` give
    :func:`solve_schur`; the reference's ``"on"`` route is its
    Pallas-Schur kernel (K3), which is not ported yet (ROADMAP.md)."""
    if pallas in ("auto", "off"):
        return solve_schur
    if pallas == "on":
        raise NotImplementedError(
            "the Schur-reduction kernel (K3) is not ported yet; see "
            "ROADMAP.md"
        )
    raise ValueError(f"pallas must be auto|on|off, got {pallas!r}")
