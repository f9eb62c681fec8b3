"""Homogeneous plane landmarks on S^3 with a minimal 3-DOF chart.

Port of ``pop_up_slam_tpu/geometry/plane.py``.  A plane is the unit
4-vector ``pi = (n, d)`` with ``n . p + d = 0`` and a canonical sign;
updates live in the 3-dim tangent space of a Householder basis.  All
functions are branch-free and batched over leading dims.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.sign(x)


def normalize(pi: torch.Tensor) -> torch.Tensor:
    """Unit 4-norm and canonical sign: by d if |d| > 1e-6, else by the
    first significant of nz, ny, nx."""
    pi = pi / torch.clamp(torch.linalg.norm(pi, dim=-1, keepdim=True),
                          min=_EPS)
    d = pi[..., 3]
    nx, ny, nz = pi[..., 0], pi[..., 1], pi[..., 2]
    tol = 1e-6
    s = torch.where(
        torch.abs(d) > tol,
        _sign(d),
        torch.where(
            torch.abs(nz) > tol,
            _sign(nz),
            torch.where(torch.abs(ny) > tol, _sign(ny), _sign(nx + 1e-30)),
        ),
    )
    return pi * s[..., None]


def from_normal_distance(n: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Unit plane from an (unnormalized) normal and offset: n.p + d = 0."""
    return normalize(torch.cat([n, d[..., None]], dim=-1))


def to_hessian_normal(pi: torch.Tensor):
    """(unit normal n, signed distance d) with ||n|| = 1."""
    n = pi[..., :3]
    nn = torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=_EPS)
    return n / nn, pi[..., 3] / nn[..., 0]


def _householder_basis(x: torch.Tensor, keep: int) -> torch.Tensor:
    """Columns != k of the Householder reflector mapping e_k -> x,
    k = argmax |x_k| (first index on ties), in ascending index order.
    The ``argsort`` of the shifted indices is stable, as in the
    reference."""
    m = x.shape[-1]
    k = torch.argmax(torch.abs(x), dim=-1)
    all_idx = torch.arange(m, device=x.device)
    e_k = (all_idx == k[..., None]).to(x.dtype)   # one-hot, no host check
    s = torch.gather(x, -1, k[..., None])[..., 0]
    s = torch.where(s >= 0, 1.0, -1.0).to(x.dtype)
    v = x - s[..., None] * e_k
    vv = torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_EPS)
    eye = torch.eye(m, dtype=x.dtype, device=x.device)
    H = eye - 2.0 * v[..., :, None] * v[..., None, :] / vv[..., None]
    shifted = all_idx + m * (all_idx == k[..., None]).to(all_idx.dtype)
    kept = torch.argsort(shifted, dim=-1, stable=True)[..., :keep]
    idx = kept[..., None, :].expand(*kept.shape[:-1], m, keep)
    return torch.gather(H, -1, idx)


def tangent_basis(pi: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis B (..., 4, 3) of the tangent space of S^3 at pi."""
    return _householder_basis(pi, 3)


def retract(pi: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """pi ⊞ delta: move along the tangent basis, renormalize to S^3."""
    B = tangent_basis(pi)
    return normalize(pi + (B @ delta[..., None])[..., 0])


def local(pi_ref: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Minimal 3-dim difference of pi w.r.t. pi_ref (inverse of
    :func:`retract` to first order), taking the sign of pi closest to
    pi_ref."""
    sign = torch.where(
        torch.sum(pi_ref * pi, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0)
    d = sign * pi - pi_ref
    B = tangent_basis(pi_ref)
    return (B.transpose(-1, -2) @ d[..., None])[..., 0]


def normal_tangent_basis(n: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis B (..., 3, 2) of the tangent plane of S^2 at n."""
    return _householder_basis(n, 2)


def hessian_local(pi_pred: torch.Tensor, pi_meas: torch.Tensor):
    """2 normal-tangent components + 1 signed-distance difference."""
    n_p, d_p = to_hessian_normal(pi_pred)
    n_m, d_m = to_hessian_normal(pi_meas)
    s = torch.where(
        torch.sum(n_p * n_m, dim=-1, keepdim=True) >= 0.0, 1.0, -1.0
    )
    n_m = s * n_m
    d_m = s[..., 0] * d_m
    B = normal_tangent_basis(n_m)
    r_n = torch.einsum("...ij,...i->...j", B, n_p)
    return torch.cat([r_n, (d_p - d_m)[..., None]], dim=-1)


def transform(pi_w: torch.Tensor, R_cw: torch.Tensor, t_cw: torch.Tensor):
    """World plane -> frame c given x_c = R_cw x_w + t_cw (unit, signed)."""
    n_w = pi_w[..., :3]
    d_w = pi_w[..., 3]
    n_c = (R_cw @ n_w[..., None])[..., 0]
    d_c = d_w - torch.sum(t_cw * n_c, dim=-1)
    return normalize(torch.cat([n_c, d_c[..., None]], dim=-1))


def transform_to_world(pi_c: torch.Tensor, R_wc: torch.Tensor,
                       t_wc: torch.Tensor):
    """Inverse of :func:`transform` given the world-from-c pose."""
    n_c = pi_c[..., :3]
    d_c = pi_c[..., 3]
    n_w = (R_wc @ n_c[..., None])[..., 0]
    d_w = d_c - torch.sum(t_wc * n_w, dim=-1)
    return normalize(torch.cat([n_w, d_w[..., None]], dim=-1))


def point_to_plane_distance(pi: torch.Tensor, p: torch.Tensor):
    n, d = to_hessian_normal(pi)
    return torch.sum(n * p, dim=-1) + d


def normal_angle(pi_a: torch.Tensor, pi_b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle between plane normals, antipodal-invariant."""
    na, _ = to_hessian_normal(pi_a)
    nb, _ = to_hessian_normal(pi_b)
    c = torch.abs(torch.sum(na * nb, dim=-1))
    return torch.arccos(torch.clamp(c, 0.0, 1.0))


def line_direction(n: torch.Tensor):
    """The horizontal in-plane direction z_hat x n of planes with normals
    n (..., 3): (wall_like (...,) bool, unit direction (..., 3)).  For a
    near-horizontal plane (the ground) the direction is degenerate and
    ``wall_like`` is False."""
    d_line = torch.stack([-n[..., 1], n[..., 0], torch.zeros_like(n[..., 0])],
                         dim=-1)
    d_norm = torch.linalg.norm(d_line, dim=-1, keepdim=True)
    return d_norm[..., 0] > 1e-3, d_line / torch.clamp(d_norm, min=1e-9)
