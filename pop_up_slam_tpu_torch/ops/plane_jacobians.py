"""Analytic, factor-batched Jacobians of the pose-plane measurement.

Port of ``plane_terms_analytic`` from
``pop_up_slam_tpu/ops/plane_jacobians.py`` (the closed form production
uses).  The reference's Pallas twin of the same math, K5
(``plane_terms_pallas``), is not ported yet; see ROADMAP.md.

With pose retraction ``T' = T_wc e^xi`` the camera-frame plane linearizes
as n_c(phi) = n_c0 + hat(n_c0) phi, d_c(rho) = d_c0 + n_c0 . rho; with
the S^3 landmark retraction pi_w' = pi_w + B4 delta,
dn_c/ddelta = R_cw N and dd_c/ddelta = b - N^T R_cw^T t_cw.
"""

from __future__ import annotations

import torch

from ..geometry import plane as plane_mod
from ..geometry import se3


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
