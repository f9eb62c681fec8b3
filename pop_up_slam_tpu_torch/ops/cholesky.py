"""K4: Cholesky factorize + solve of one SPD system (CUDA) and its plain
PyTorch version.

Replaces ``pop_up_slam_tpu/ops/cholesky_pallas.py::chol_solve_pallas``
(kernel body ``chol_solve_body``).  The CUDA kernel (``csrc/chol_solve.cu``
over the panel-blocked device routine in ``csrc/chol.cuh``, which K1 and
K3a share) is bound by its chain of dependent stages (latency), not by
bytes or flops; the design runs each panel's pivots (16 rows; 32 on the
device-memory route) in one warp and updates the trailing matrix with
register tiles, three block barriers per panel.  Up to ``SHARED_MAX_N`` the system lives in one
block's shared memory (one launch); above it in a device-memory
workspace that the wrapper allocates (two launches per panel on the
caller's stream).  Any n >= 1 is taken.

Semantics (both versions): upper factor U with the modified pivot rule of
the reference — a pivot at or below 1e-7 * max(max diag, 1) skips its
direction (U row e_g, solution entry 0) instead of producing NaN.
"""

from __future__ import annotations

import torch

from ._build import check, library

SHARED_MAX_N = 224   # csrc/chol_solve.cu kSharedMaxN: the one-block route


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


def chol_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for SPD S (n, n), b (n,) f32.  CUDA tensors launch
    the kernel; CPU tensors run :func:`chol_solve_plain`."""
    if S.device.type == "cpu" and b.device.type == "cpu":
        return chol_solve_plain(S, b)
    n = S.shape[0]
    if S.device.type != "cuda" or b.device != S.device:
        raise ValueError("chol_solve: S and b must lie on one CUDA device")
    if S.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"chol_solve: shapes {tuple(S.shape)}, "
                         f"{tuple(b.shape)}; want (n, n), (n,)")
    if S.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError("chol_solve: float32 only")
    if not (S.is_contiguous() and b.is_contiguous()):
        raise ValueError("chol_solve: inputs must be contiguous")
    if n < 1:
        raise ValueError("chol_solve: empty system")
    x = torch.empty_like(b)
    work = (torch.empty((n * n + 1,), dtype=torch.float32, device=S.device)
            if n > SHARED_MAX_N else None)
    lib = library()
    stream = torch.cuda.current_stream(S.device).cuda_stream
    chol_solve.launches += 1
    check(lib.popup_chol_solve(S.data_ptr(), b.data_ptr(), x.data_ptr(),
                               work.data_ptr() if work is not None else None,
                               n, stream), "chol_solve")
    return x


chol_solve.launches = 0
