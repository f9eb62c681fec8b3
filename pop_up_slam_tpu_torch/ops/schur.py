"""K3a and K3b: the Schur reduction of the landmarks and the reduced
solve (CUDA), and their plain PyTorch versions.

Replaces ``pop_up_slam_tpu/ops/schur_pallas.py::schur_reduce_pallas``.
With B = Hpl Hll^-1 and G = Hpl flattened to (6W x 3L):

    S = Hpp - B G^T,  + lambda I,  free-pose mask (identity diagonal on
    masked rows),  S dxp = -(bp - B bl),  dxl = -Hll^-1 (bl + Hpl^T dxp)

The work the reference does outside its kernels stays PyTorch here: the
damped 3x3 inverses, B, the flattening, rp and the back-substitution.
The route keeps the reference's split (``schur_pallas.py:154``):

- 6W <= 128: **K3a** :func:`schur_reduce_small` (``csrc/schur_reduce.cu``),
  one launch: the product, damping, mask and the Cholesky solve with S
  in one block's shared memory (the ``chol.cuh`` routine, K4's
  pivot-skip rule).  The product sums each pose pair only over the
  landmarks both observe (observer sets built in the kernel), in the
  dense sum's order, so S keeps the dense ordered sum's bits.  Bound by
  latency; lambda is read from device memory, so LM and dog-leg
  iterations never wait on the host.
- 6W > 128: **K3b** :func:`schur_gemm`, the product alone over tiles of
  whole poses, each entry summed only over the landmarks both poses
  observe in the dense order (f32 on the CUDA cores, the dense sum's
  bits), then damping and mask as PyTorch ops and **K4**
  :func:`..cholesky.chol_solve` (one block's shared memory up to
  n = 224, a device-memory workspace above).

The plain version, :func:`schur_reduce_plain`, is the same reduction with
the kernels' plain versions; it solves with the pivot-skip rule (an
indefinite direction gets 0), unlike ``solve_schur`` (NaN, then a zeroed
step).
"""

from __future__ import annotations

import torch

from ..solver.schur import SchurSolution, inv3x3
from ._build import check, check_inputs, check_stamps, library
from .cholesky import chol_solve, chol_solve_plain

MAX_SMALL_N = 128   # the reference's single-tile route: 6W <= 128
# K3a's phase stamps: start, observer sets built, product, damping and
# mask, Cholesky solve
N_SMALL_STAMPS = 5


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


def schur_gemm(Hpp: torch.Tensor, B: torch.Tensor,
               G: torch.Tensor) -> torch.Tensor:
    """K3b: S = Hpp - B G^T with Hpp (n, n), B and G (n, C) f32.  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    dev = B.device
    if dev.type == "cpu":
        return schur_gemm_plain(Hpp, B, G)
    if dev.type != "cuda":
        raise ValueError(f"schur_gemm: unsupported device {dev}")
    n, C = B.shape
    check_inputs("schur_gemm", dev, (Hpp, (n, n)), (B, (n, C)), (G, (n, C)))
    S = torch.empty((n, n), dtype=torch.float32, device=dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    schur_gemm.launches += 1
    check(lib.popup_schur_gemm(
        Hpp.data_ptr(), B.data_ptr(), G.data_ptr(), S.data_ptr(), n, C,
        stream), "schur_gemm")
    return S


schur_gemm.launches = 0


def schur_reduce_small(Hpp, B, G, rhs, pm, lam, stamps=None):
    """K3a: (S (n, n), x (n,)) — S = Hpp - B G^T damped by ``lam`` (a 0-d
    device tensor) and masked by ``pm``, x solving S x = rhs * pm, for
    n <= 128.  CUDA tensors launch the kernel; CPU tensors run the plain
    version.  ``stamps``, an int64 CUDA tensor of ``N_SMALL_STAMPS``
    slots, receives the kernel's ``%globaltimer`` at its phase
    boundaries (ns; for the profile script)."""
    dev = B.device
    if dev.type == "cpu":
        return schur_reduce_small_plain(Hpp, B, G, rhs, pm, lam)
    if dev.type != "cuda":
        raise ValueError(f"schur_reduce_small: unsupported device {dev}")
    n, C = B.shape
    check_inputs("schur_reduce_small", dev, (Hpp, (n, n)), (B, (n, C)),
           (G, (n, C)), (rhs, (n,)), (pm, (n,)), (lam, ()))
    if not 1 <= n <= MAX_SMALL_N:
        raise ValueError(f"schur_reduce_small: n={n} outside "
                         f"1..{MAX_SMALL_N}")
    check_stamps("schur_reduce_small", stamps, dev, N_SMALL_STAMPS)
    S = torch.empty((n, n), dtype=torch.float32, device=dev)
    x = torch.empty((n,), dtype=torch.float32, device=dev)
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    schur_reduce_small.launches += 1
    check(lib.popup_schur_reduce_small(
        Hpp.data_ptr(), B.data_ptr(), G.data_ptr(), rhs.data_ptr(),
        pm.data_ptr(), lam.data_ptr(), S.data_ptr(), x.data_ptr(), n, C,
        stamps.data_ptr() if stamps is not None else None, stream),
        "schur_reduce_small")
    return S, x


schur_reduce_small.launches = 0


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


def _reduce(lin, window, damping, plain: bool) -> SchurSolution:
    W = lin.bp.shape[0]
    dt = lin.bp.dtype
    lam = _lam(damping, lin.bp.device)
    Hll_inv, B, G, Hpp, pm, rp = reduce_operands(lin, window, lam)

    n = 6 * W
    if n <= MAX_SMALL_N:
        small = schur_reduce_small_plain if plain else schur_reduce_small
        S, x = small(Hpp, B, G, -rp, pm, lam)
    else:
        gemm = schur_gemm_plain if plain else schur_gemm
        S = damp_mask(gemm(Hpp, B, G), lam, pm)
        solve = chol_solve_plain if plain else chol_solve
        x = solve(S, -(rp * pm))

    dxp = (x.reshape(W, 6) * pm.reshape(W, 6)).to(dt)
    rhs = lin.bl + torch.einsum("wlab,wa->lb", lin.Hpl, dxp)
    dxl = -torch.einsum("lab,lb->la", Hll_inv, rhs)
    dxl = dxl * window.lm_valid[:, None].to(dt)
    return SchurSolution(dxp, dxl, S.to(dt))


def schur_reduce(lin, window, damping=1e-6) -> SchurSolution:
    """Schur-reduce and solve through K3a (6W <= 128) or K3b + K4 on CUDA
    tensors; CPU tensors run :func:`schur_reduce_plain`.  ``damping`` is
    a python float or a 0-d tensor (LM's lambda stays on the device)."""
    dev = lin.bp.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"schur_reduce: unsupported device {dev}")
    return _reduce(lin, window, damping, plain=dev.type == "cpu")


def schur_reduce_plain(lin, window, damping=1e-6) -> SchurSolution:
    """Plain version of :func:`schur_reduce`, on any device."""
    return _reduce(lin, window, damping, plain=True)
