"""Frozen copy of the port's ``geometry/camera.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

Pinhole camera model: projection, ray casting, ray-plane intersection.

Port of ``pop_up_slam_tpu/geometry/camera.py``.  Camera frame: +x right,
+y down, +z forward; world frame gravity aligned with +z up and the
ground plane at z = 0.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import resolve_device


class Intrinsics(NamedTuple):
    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor

    @staticmethod
    def create(fx, fy, cx, cy, dtype=torch.float32,
               device=None) -> "Intrinsics":
        dev = resolve_device(device)
        return Intrinsics(*(torch.as_tensor(v, dtype=dtype, device=dev)
                            for v in (fx, fy, cx, cy)))


def pixel_rays(K: Intrinsics, uv: torch.Tensor) -> torch.Tensor:
    """Pixels (..., 2) -> unit-z rays (..., 3) in the camera frame.

    Scales by the f32 reciprocal of the focal length rather than dividing
    by it: the reference's runners close over their intrinsics, and XLA
    compiles a division by a constant as that product, which rounds
    differently (the pop-up's boundary branches on it)."""
    x = (uv[..., 0] - K.cx) * (1.0 / K.fx)
    y = (uv[..., 1] - K.cy) * (1.0 / K.fy)
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


def project(K: Intrinsics, p_cam: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Camera-frame points (..., 3) -> pixels (..., 2); no validity check
    (callers mask on z > 0)."""
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < eps, torch.full_like(z, eps), z)
    u = K.fx * p_cam[..., 0] / z + K.cx
    v = K.fy * p_cam[..., 1] / z + K.cy
    return torch.stack([u, v], dim=-1)


def ray_plane_depth(rays: torch.Tensor, pi_cam: torch.Tensor,
                    eps: float = 1e-6):
    """Intersect unit-z rays (..., 3) with plane pi (..., 4), camera
    frame.  Returns (depth_z, valid)."""
    n = pi_cam[..., :3]
    d = pi_cam[..., 3]
    denom = torch.sum(n * rays, dim=-1)
    safe = torch.where(torch.abs(denom) < eps, torch.full_like(denom, eps),
                       denom)
    s = -d / safe
    valid = (torch.abs(denom) >= eps) & (s > 0)
    return s, valid


def backproject_to_world_plane(K: Intrinsics, uv, R_wc, t_wc, pi_w,
                               eps: float = 1e-6):
    """Intersect pixel rays with a world-frame plane (the pop-up step).
    Returns (p_world (..., 3), valid).  Rounds as XLA's CPU code for the
    reference's runners does: rays by the reciprocal focal length
    (:func:`pixel_rays`), and ``t + s * r`` as one fused multiply-add in
    x and y (emulated in f64, which holds the f32 product exactly) but as
    a product then a sum in z."""
    r_cam = pixel_rays(K, uv)
    r_w = (R_wc @ r_cam[..., None])[..., 0]
    n = pi_w[..., :3]
    d = pi_w[..., 3]
    denom = torch.sum(n * r_w, dim=-1)
    num = -(torch.sum(n * t_wc, dim=-1) + d)
    safe = torch.where(torch.abs(denom) < eps, torch.full_like(denom, eps),
                       denom)
    s = num / safe
    valid = (torch.abs(denom) >= eps) & (s > eps)
    p_xy = (s[..., None].double() * r_w[..., :2].double()
            + t_wc[..., :2].double()).to(s.dtype)
    p_z = t_wc[..., 2] + s * r_w[..., 2]
    return torch.cat([p_xy, p_z[..., None]], dim=-1), valid
