"""K5: analytic, factor-batched Jacobians of the pose-plane measurement
(CUDA) and their plain PyTorch version.

:func:`plane_terms_analytic` ports ``plane_terms_analytic`` from
``pop_up_slam_tpu/ops/plane_jacobians.py`` (the closed form the reference
linearizes with) and is the plain version of :func:`plane_terms`, whose
CUDA kernel (``csrc/plane_terms.cu`` over ``csrc/plane_factor.cuh``, the
routine the fused GN kernel shares) replaces the reference's Pallas
kernel ``plane_terms_pallas`` (``plane_jacobians.py:315``, kernel
``_plane_kernel``).  Each block stages the window and its 32 factors'
rows in shared memory in one wave of loads, one thread per factor runs
the closed form there, and the block writes r, Jp and Jl as contiguous
runs of one output buffer; the Pallas wrapper's 42-channel lane packing
is not carried over.  At F = 72 factors (~530 operations and ~180 bytes
each) the kernel is bound by latency (its launch, one round trip, the
closed form's dependent chain), not by bytes or operations.

With pose retraction ``T' = T_wc e^xi`` the camera-frame plane linearizes
as n_c(phi) = n_c0 + hat(n_c0) phi, d_c(rho) = d_c0 + n_c0 . rho; with
the S^3 landmark retraction pi_w' = pi_w + B4 delta,
dn_c/ddelta = R_cw N and dd_c/ddelta = b - N^T R_cw^T t_cw.
"""

from __future__ import annotations

import torch

from ..geometry import plane as plane_mod
from ..geometry import se3
from ._build import check, check_inputs, check_stamps, library

# K5's phase stamps: start, loads staged, closed form, stores issued
N_STAMPS = 4


def plane_terms_analytic(window, factors):
    """Closed-form residuals + Jacobians for all plane factors.
    Returns (r (F,3), Jp (F,3,6), Jl (F,3,3)), zero where invalid."""
    p = factors.pose_idx.long()
    R_wc = window.R[p]
    t_wc = window.t[p]
    pi_w = window.planes[factors.lm_idx.long()]
    A = factors.sqrt_info
    valid = factors.valid

    R_cw = R_wc.transpose(-1, -2)
    t_cw = -(R_cw @ t_wc[..., None])[..., 0]

    n_w, d_w = pi_w[..., :3], pi_w[..., 3]
    n_c = (R_cw @ n_w[..., None])[..., 0]
    d_c = d_w - torch.sum(t_cw * n_c, dim=-1)

    # plane.normalize's canonical sign on the prediction, held constant
    raw = torch.cat([n_c, d_c[..., None]], dim=-1)
    pred_unit = plane_mod.normalize(raw)
    sgn = torch.where(torch.sum(pred_unit * raw, dim=-1) >= 0.0, 1.0, -1.0)
    n_c = sgn[..., None] * n_c
    d_c = sgn * d_c

    c = torch.clamp(torch.linalg.norm(n_c, dim=-1), min=1e-9)
    n_p = n_c / c[..., None]
    d_p = d_c / c

    n_m, d_m = plane_mod.to_hessian_normal(factors.pi_meas)
    s = torch.where(torch.sum(n_p * n_m, dim=-1) >= 0.0, 1.0, -1.0)
    n_m = s[..., None] * n_m
    d_m = s * d_m
    Bt = plane_mod.normal_tangent_basis(n_m).transpose(-1, -2)  # (F, 2, 3)

    r_n = (Bt @ n_p[..., None])[..., 0]
    r = torch.cat([r_n, (d_p - d_m)[..., None]], dim=-1)

    # pose Jacobian (3x6), tangent order (rho, phi)
    hat_np = se3.hat(n_p)
    Jn_phi = Bt @ hat_np
    top = torch.cat([torch.zeros_like(Jn_phi), Jn_phi], dim=-1)
    bot = torch.cat([n_p[..., None, :], torch.zeros_like(n_p)[..., None, :]],
                    dim=-1)
    Jp = torch.cat([top, bot], dim=-2)

    # landmark Jacobian (3x3)
    B4 = plane_mod.tangent_basis(pi_w)
    N = B4[..., :3, :]
    b_off = B4[..., 3, :]
    RN = R_cw @ N
    dn_c = sgn[..., None, None] * RN
    dd_c = sgn[..., None] * (
        b_off - (RN.transpose(-1, -2) @ t_cw[..., None])[..., 0]
    )
    eye = torch.eye(3, dtype=n_p.dtype, device=n_p.device)
    proj = eye - n_p[..., :, None] * n_p[..., None, :]
    dn_p = (proj @ dn_c) / c[..., None, None]
    np_dnc = (n_p[..., None, :] @ dn_c)[..., 0, :]
    dd_p = dd_c / c[..., None] - d_p[..., None] * np_dnc / c[..., None]
    Jl = torch.cat([Bt @ dn_p, dd_p[..., None, :]], dim=-2)

    # whiten + mask (where, not multiply: padded factors can be NaN)
    r = (A @ r[..., None])[..., 0]
    Jp = A @ Jp
    Jl = A @ Jl
    v = valid[..., None]
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    return (torch.where(v, r, zero), torch.where(v[..., None], Jp, zero),
            torch.where(v[..., None], Jl, zero))


def _int32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.int32 else x.to(torch.int32)


def plane_terms(window, factors, stamps=None):
    """(r (F,3), Jp (F,3,6), Jl (F,3,3)) of every plane factor, whitened,
    zero where invalid: three contiguous views of one buffer.  CUDA
    tensors launch K5; CPU tensors run :func:`plane_terms_analytic`.
    ``stamps``, an int64 CUDA tensor of ``N_STAMPS`` slots, receives the
    kernel's ``%globaltimer`` at its phase boundaries (ns; for the
    profile script)."""
    dev = window.t.device
    if dev.type == "cpu":
        return plane_terms_analytic(window, factors)
    if dev.type != "cuda":
        raise ValueError(f"plane_terms: unsupported device {dev}")
    W, L = window.window_size, window.max_landmarks
    F = factors.valid.shape[0]
    i32 = torch.int32
    # one sqrt-info matrix broadcast over the factors (the SLAM step's) is
    # read as one matrix, not copied out F times
    A = factors.sqrt_info
    a_stride = 0 if A.stride() == (0, 3, 1) and F > 0 else 9
    ins = ((window.R, (W, 3, 3)), (window.t, (W, 3)), (window.planes, (L, 4)),
           (_int32(factors.pose_idx), (F,), i32),
           (_int32(factors.lm_idx), (F,), i32),
           (factors.pi_meas, (F, 4)),
           (A[:1] if a_stride == 0 else A, (1 if a_stride == 0 else F, 3, 3)),
           (factors.valid, (F,), torch.bool))
    check_inputs("plane_terms", dev, *ins)
    check_stamps("plane_terms", stamps, dev, N_STAMPS)
    out = torch.empty(30 * F, dtype=torch.float32, device=dev)
    r = out[:3 * F].view(F, 3)
    Jp = out[3 * F:21 * F].view(F, 3, 6)
    Jl = out[21 * F:].view(F, 3, 3)
    if F == 0:
        return r, Jp, Jl
    lib = library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    plane_terms.launches += 1
    check(lib.popup_plane_terms(
        *(spec[0].data_ptr() for spec in ins), out.data_ptr(), F, W, L,
        a_stride, stamps.data_ptr() if stamps is not None else None, stream),
        "plane_terms")
    return r, Jp, Jl


plane_terms.launches = 0
