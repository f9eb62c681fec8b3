"""SO(3)/SE(3) Lie-group operations on torch tensors.

Port of ``pop_up_slam_tpu/geometry/se3.py`` with the same conventions:

- rotations are 3x3 matrices ``R``; poses are ``(R, t)`` pairs acting on
  points as ``x_world = R @ x_local + t`` (world-from-local);
- tangent vectors are 6-vectors ``xi = (rho, phi)``, translation first;
- everything is branch-free (``torch.where`` with safe denominators) and
  batched over leading dims.

The f32 small-angle Taylor switches below ``_SMALL`` are kept exactly:
the exact forms of these coefficients cancel catastrophically in f32.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
_SMALL = 0.1


def _eye(n, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _safe_norm(x: torch.Tensor) -> torch.Tensor:
    """||x|| over the last axis, 0 at the origin without a 0/0."""
    sq = torch.sum(x * x, dim=-1)
    positive = sq > 0
    safe = torch.where(positive, sq, torch.ones_like(sq))
    return torch.where(positive, torch.sqrt(safe), torch.zeros_like(sq))


def _hat_sq(phi: torch.Tensor) -> torch.Tensor:
    """Closed form K(phi)^2 = phi phi^T - |phi|^2 I."""
    outer = phi[..., :, None] * phi[..., None, :]
    n2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    return outer - n2 * _eye(3, phi)


def hat(phi: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    x, y, z = phi[..., 0], phi[..., 1], phi[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def vee(M: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`hat`."""
    return torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)


def _where_small(x, small_val, exact_fn):
    small = torch.abs(x) < _SMALL
    safe = torch.where(small, torch.ones_like(x), x)
    return torch.where(small, small_val, exact_fn(safe))


def _sinc(x: torch.Tensor) -> torch.Tensor:
    """sin(x)/x, Taylor below _SMALL."""
    x2 = x * x
    return _where_small(x, 1.0 - x2 / 6.0 + x2 * x2 / 120.0,
                        lambda s: torch.sin(s) / s)


def _cosc(x: torch.Tensor) -> torch.Tensor:
    """(1 - cos(x)) / x**2 == 0.5 * sinc(x/2)^2."""
    s = _sinc(0.5 * x)
    return 0.5 * s * s


def _sincc(x: torch.Tensor) -> torch.Tensor:
    """(x - sin(x)) / x**3, Taylor below _SMALL."""
    x2 = x * x
    return _where_small(x, 1.0 / 6.0 - x2 / 120.0 + x2 * x2 / 5040.0,
                        lambda s: (s - torch.sin(s)) / (s * s * s))


def so3_exp(phi: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula. phi: (..., 3) -> R: (..., 3, 3)."""
    theta = _safe_norm(phi)
    a = _sinc(theta)[..., None, None]
    b = _cosc(theta)[..., None, None]
    return _eye(3, phi) + a * hat(phi) + b * _hat_sq(phi)


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0.

    Shepperd's method on all four candidates, selected by the first
    maximum of the diagonal terms (``torch.argmax`` keeps the first
    index on ties, as ``jnp.argmax`` does)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)

    cands = torch.stack([qw, qx, qy, qz], dim=-2)            # (..., 4, 4)
    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    gather_idx = idx[..., None, None].expand(*idx.shape, 1, 4)
    q = torch.gather(cands, -2, gather_idx)[..., 0, :]
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    sign = torch.where(q[..., :1] < 0.0, -1.0, 1.0)
    return q * sign


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    ww, xx, yy, zz = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([ww + xx - yy - zz, 2 * (xy - wz), 2 * (xz + wy)],
                        dim=-1),
            torch.stack([2 * (xy + wz), ww - xx + yy - zz, 2 * (yz - wx)],
                        dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), ww - xx - yy + zz],
                        dim=-1),
        ],
        dim=-2,
    )


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Log map of SO(3) via the quaternion route, (..., 3)."""
    q = rotmat_to_quat(R)
    w = q[..., 0]
    v = q[..., 1:]
    vn = _safe_norm(v)
    small = vn < 1e-3
    w_safe = torch.clamp(w, min=_EPS)
    taylor = 2.0 / w_safe - 2.0 * vn * vn / (3.0 * w_safe ** 3)
    angle = 2.0 * torch.atan2(vn, w)
    exact = angle / torch.clamp(vn, min=_EPS)
    scale = torch.where(small, taylor, exact)
    return scale[..., None] * v


def se3_V(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)
    b = _cosc(theta)[..., None, None]
    c = _sincc(theta)[..., None, None]
    return _eye(3, phi) + b * hat(phi) + c * _hat_sq(phi)


def _cot_term(theta: torch.Tensor) -> torch.Tensor:
    """(1 - (t/2) cot(t/2)) / t^2, Taylor below _SMALL; the sin clamp
    keeps it finite as t -> 2 pi."""
    t2 = theta * theta
    small = theta < _SMALL
    safe = torch.where(small, torch.ones_like(theta), theta)
    half_s = 0.5 * safe
    exact = (1.0 - half_s * torch.cos(half_s)
             / torch.clamp(torch.sin(half_s), min=_EPS)) / (safe * safe)
    return torch.where(small, 1.0 / 12.0 + t2 / 720.0 + t2 * t2 / 30240.0,
                       exact)


def se3_V_inv(phi: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(phi)
    ct = _cot_term(theta)[..., None, None]
    return _eye(3, phi) - 0.5 * hat(phi) + ct * _hat_sq(phi)


def se3_exp(xi: torch.Tensor):
    """SE(3) exp. xi = (rho, phi): (..., 6) -> (R, t)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    t = (se3_V(phi) @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    phi = so3_log(R)
    rho = (se3_V_inv(phi) @ t[..., None])[..., 0]
    return torch.cat([rho, phi], dim=-1)


def _c2_coeff(theta: torch.Tensor) -> torch.Tensor:
    """(theta^2 + 2 cos theta - 2) / (2 theta^4), Taylor below _SMALL."""
    t2 = theta * theta
    small = theta < _SMALL
    safe = torch.where(small, torch.ones_like(theta), theta)
    exact = (safe * safe + 2.0 * torch.cos(safe) - 2.0) / (2.0 * safe ** 4)
    return torch.where(small, 1.0 / 24.0 - t2 / 720.0 + t2 * t2 / 40320.0,
                       exact)


def _c3_coeff(theta: torch.Tensor) -> torch.Tensor:
    """(2 theta - 3 sin theta + theta cos theta) / (2 theta^5)."""
    t2 = theta * theta
    small = theta < _SMALL
    safe = torch.where(small, torch.ones_like(theta), theta)
    exact = ((2.0 * safe - 3.0 * torch.sin(safe) + safe * torch.cos(safe))
             / (2.0 * safe ** 5))
    return torch.where(small, 1.0 / 120.0 - t2 / 2520.0 + t2 * t2 / 120960.0,
                       exact)


def se3_Q(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(xi), the coupling block of the SE(3) left Jacobian."""
    theta = _safe_norm(phi)
    rx = hat(rho)
    px = hat(phi)
    c1 = _sincc(theta)[..., None, None]
    c2 = _c2_coeff(theta)[..., None, None]
    c3 = _c3_coeff(theta)[..., None, None]
    pr = px @ rx
    rp = rx @ px
    prp = pr @ px
    return (
        0.5 * rx
        + c1 * (pr + rp + prp)
        + c2 * (px @ pr + rp @ px - 3.0 * prp)
        + c3 * (prp @ px + px @ pr @ px)
    )


def _blocks(TL, TR, BL, BR) -> torch.Tensor:
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, BR], dim=-1)
    return torch.cat([top, bot], dim=-2)


def se3_left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """[[V^-1, -V^-1 Q V^-1], [0, V^-1]], (..., 6, 6)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    Vi = se3_V_inv(phi)
    Q = se3_Q(rho, phi)
    return _blocks(Vi, -Vi @ Q @ Vi, torch.zeros_like(Vi), Vi)


def se3_right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """J_r^-1(xi) = J_l^-1(-xi)."""
    return se3_left_jacobian_inv(-xi)


def se3_right_jacobian_inv_approx(xi: torch.Tensor) -> torch.Tensor:
    """First-order J_r^-1(xi) ~= I + 0.5 ad(xi), with
    ad(xi) = [[phi^, rho^], [0, phi^]]."""
    rho, phi = xi[..., :3], xi[..., 3:]
    px = hat(phi)
    ad = _blocks(px, hat(rho), torch.zeros_like(px), px)
    return _eye(6, xi) + 0.5 * ad


def se3_adjoint(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[[R, t^ R], [0, R]] for translation-first xi."""
    return _blocks(R, hat(t) @ R, torch.zeros_like(R), R)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_between(Ra, ta, Rb, tb):
    """Relative pose a^-1 o b."""
    Ri, ti = se3_inverse(Ra, ta)
    return se3_compose(Ri, ti, Rb, tb)


def se3_apply(R, t, x):
    """Transform points x (..., 3) by pose (R, t)."""
    return (R @ x[..., None])[..., 0] + t


def se3_retract(R, t, xi):
    """Right-multiplicative retraction (R, t) * exp(xi)."""
    dR, dt = se3_exp(xi)
    return se3_compose(R, t, dR, dt)


def se3_matrix(R, t):
    """(R, t) -> 4x4 homogeneous matrix (batched)."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(R.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([R, t[..., None]], dim=-1), bottom], dim=-2)


def se3_from_matrix(T):
    return T[..., :3, :3], T[..., :3, 3]
