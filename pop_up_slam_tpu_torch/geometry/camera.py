"""Pinhole camera model: projection, ray casting, ray-plane intersection.

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
    """Pixels (..., 2) -> unit-z rays (..., 3) in the camera frame."""
    x = (uv[..., 0] - K.cx) / K.fx
    y = (uv[..., 1] - K.cy) / K.fy
    return torch.stack([x, y, torch.ones_like(x)], dim=-1)


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
    Returns (p_world (..., 3), valid)."""
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
    p = t_wc + s[..., None] * r_w
    return p, valid
