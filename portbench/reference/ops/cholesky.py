"""Frozen copy of the port's ``ops/cholesky.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Cholesky solve with the pivot-skip rule, plain PyTorch.

Frozen copy of the port's ``ops/cholesky.py::chol_solve_plain`` (K4's
plain version): upper factor, a pivot at or below
1e-7 * max(max diag, 1) skips its direction (solution entry 0).
"""

from __future__ import annotations

import torch


def chol_solve_plain(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: unblocked right-looking
    factorization with the same pivot rule, forward solve fused in."""
    n = S.shape[0]
    A = S.to(torch.float32).clone()
    y = b.to(torch.float32).clone()
    zero = torch.zeros((), dtype=A.dtype, device=A.device)
    one = torch.ones((), dtype=A.dtype, device=A.device)
    thresh = 1e-7 * torch.clamp(torch.diagonal(A).max(), min=1.0)
    for g in range(n):
        pivot = A[g, g]
        good = pivot > thresh
        inv = torch.where(good, torch.rsqrt(torch.clamp(pivot, min=1e-20)),
                          zero)
        e_g = (torch.arange(n - g, device=A.device) == 0).to(A.dtype)
        A[g, g:] = torch.where(good, A[g, g:] * inv, e_g)
        yg = y[g] * inv
        y[g] = yg
        u = A[g, g + 1:]
        A[g + 1:, g + 1:] -= u[:, None] * u[None, :]
        y[g + 1:] -= u * yg
    x = torch.zeros_like(y)
    for g in range(n - 1, -1, -1):
        ukk = A[g, g]
        ukk = torch.where(torch.abs(ukk) < 1e-20, 1e-20 * one, ukk)
        x[g] = (y[g] - torch.dot(A[g, g + 1:], x[g + 1:])) / ukk
    return x
