"""Synthetic plane-world generator: corridors/rooms with ground truth.

Port of ``pop_up_slam_tpu/io/synthetic.py``: a world of vertical wall
segments on a flat ground plane, a ground-truth camera trajectory, exact
per-frame plane observations (optionally noisy), noisy odometry, and a
ray-cast label/depth image per frame.  Everything is fixed-capacity
(``max_walls``) and batched.

Where the reference draws from ``jax.random``, the port takes the draws
themselves (tensors) or an explicit ``torch.Generator``: the two
frameworks give different numbers from one seed, so tests hand the same
draws to both.

World frame: +z up, ground plane z = 0.  Camera frame: +x right, +y
down, +z forward; a camera looking along horizontal unit direction f
has R_wc columns (right, down, forward) =
([f_y, -f_x, 0], [0, 0, -1], [f_x, f_y, 0]).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .._device import resolve_device
from ..geometry import camera, plane, se3
from ..geometry.camera import Intrinsics


class WallWorld(NamedTuple):
    """Fixed-capacity set of vertical wall segments: ground-line
    endpoints p0, p1 (M, 2) in world XY, heights (M,), valid (M,)."""

    p0: torch.Tensor
    p1: torch.Tensor
    height: torch.Tensor
    valid: torch.Tensor

    @property
    def max_walls(self) -> int:
        return self.p0.shape[0]

    def planes(self) -> torch.Tensor:
        """World-frame homogeneous plane per wall, (M, 4), unit."""
        d = self.p1 - self.p0
        n = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], -1)
        p0 = torch.cat([self.p0, torch.zeros_like(self.p0[:, :1])], -1)
        off = -torch.sum(n * p0, dim=-1)
        return plane.normalize(torch.cat([n, off[:, None]], dim=-1))


def make_world(segments, heights=2.5, max_walls: int = 16,
               device=None) -> WallWorld:
    """A WallWorld from a python list of ((x0, y0), (x1, y1)) segments."""
    dev = resolve_device(device)
    n = len(segments)
    if n > max_walls:
        raise ValueError(f"{n} segments > max_walls={max_walls}")
    p0 = torch.zeros((max_walls, 2))
    p1 = torch.zeros((max_walls, 2))
    scalar = isinstance(heights, (int, float))
    h = torch.full((max_walls,), float(heights) if scalar else 0.0)
    if not scalar:
        h[:n] = torch.as_tensor(heights, dtype=torch.float32)
    for i, (a, b) in enumerate(segments):
        p0[i] = torch.as_tensor(a)
        p1[i] = torch.as_tensor(b)
    # keep invalid walls far away and degenerate-free
    p0[n:] = 1e6
    p1[n:] = 1e6 + 1.0
    valid = torch.arange(max_walls) < n
    return WallWorld(p0.to(dev), p1.to(dev), h.to(dev), valid.to(dev))


def corridor_world(length: float = 10.0, width: float = 2.0,
                   height: float = 2.5, max_walls: int = 16,
                   device=None) -> WallWorld:
    """A straight corridor along +y with an end wall."""
    hw = width / 2.0
    return make_world(
        [((-hw, 0.0), (-hw, length)),        # left wall
         ((hw, 0.0), (hw, length)),          # right wall
         ((-hw, length), (hw, length))],     # end wall
        heights=height, max_walls=max_walls, device=device)


def room_world(size: float = 6.0, height: float = 2.5, max_walls: int = 16,
               device=None) -> WallWorld:
    """A square room with an interior partition."""
    s = size / 2.0
    return make_world(
        [((-s, -s), (s, -s)), ((s, -s), (s, s)), ((s, s), (-s, s)),
         ((-s, s), (-s, -s)), ((-s / 2, 0.0), (s / 2, 0.0))],
        heights=height, max_walls=max_walls, device=device)


def look_along(direction_xy: torch.Tensor) -> torch.Tensor:
    """R_wc for a camera at horizontal forward direction (fx, fy)."""
    f = direction_xy / torch.clamp(
        torch.linalg.norm(direction_xy, dim=-1, keepdim=True), min=1e-9)
    fx, fy = f[..., 0], f[..., 1]
    z = torch.zeros_like(fx)
    right = torch.stack([fy, -fx, z], dim=-1)
    down = torch.stack([z, z, -torch.ones_like(fx)], dim=-1)
    fwd = torch.stack([fx, fy, z], dim=-1)
    return torch.stack([right, down, fwd], dim=-1)  # columns


def _linspace(start: float, stop: float, n: int, dev) -> torch.Tensor:
    """``jnp.linspace`` in f32: start (1 - s) + stop s at s = i / (n - 1),
    the last point exactly ``stop``."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=dev)
    s = torch.arange(n - 1, dtype=torch.float32, device=dev) / (n - 1)
    a = torch.tensor(start, dtype=torch.float32, device=dev)
    b = torch.tensor(stop, dtype=torch.float32, device=dev)
    return torch.cat([a * (1 - s) + b * s, b[None]])


def corridor_trajectory(n_frames: int, length: float = 10.0,
                        cam_height: float = 1.4, sway: float = 0.0,
                        device=None):
    """Straight walk down the corridor.  Returns (R_wc (N,3,3), t_wc
    (N,3))."""
    dev = resolve_device(device)
    ys = _linspace(0.5, length - 1.5, n_frames, dev)
    xs = sway * torch.sin(ys * 2.0)
    t = torch.stack([xs, ys, torch.full_like(ys, cam_height)], dim=-1)
    d = torch.stack([torch.zeros_like(ys), torch.ones_like(ys)], dim=-1)
    return look_along(d), t


def orbit_trajectory(n_frames: int, radius: float = 1.5,
                     cam_height: float = 1.4, device=None):
    """Slow turn inside a room: position on a small circle, looking
    outward."""
    dev = resolve_device(device)
    th = _linspace(0.0, 1.5 * math.pi, n_frames, dev)
    t = torch.stack([radius * torch.cos(th), radius * torch.sin(th),
                     torch.full_like(th, cam_height)], dim=-1)
    d = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)
    return look_along(d), t


# ---------------------------------------------------------------------------
# Ray-cast renderer (label + depth images)
# ---------------------------------------------------------------------------

LABEL_SKY = 0
LABEL_GROUND = 1
LABEL_WALL_BASE = 2  # wall i has label LABEL_WALL_BASE + i


def render_frame(K: Intrinsics, R_wc: torch.Tensor, t_wc: torch.Tensor,
                 world: WallWorld, h: int, w: int, max_depth: float = 50.0):
    """Ray-cast one frame.  Returns (labels (h,w) int32, depth (h,w)
    f32): the camera-frame z of the first hit (sky -> max_depth)."""
    dev = R_wc.device
    vv, uu = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    rays_c = camera.pixel_rays(K, torch.stack([uu, vv], dim=-1))
    rays_w = torch.einsum("ij,hwj->hwi", R_wc, rays_c)

    # ground: t_wc_z + s * ray_z = 0
    rz = rays_w[..., 2]
    tiny = torch.abs(rz) < 1e-9
    s_ground = -t_wc[2] / torch.where(tiny, torch.full_like(rz, 1e-9), rz)
    ground_ok = (s_ground > 1e-6) & ~tiny
    s_ground = torch.where(ground_ok, s_ground,
                           torch.full_like(s_ground, math.inf))

    # walls: plane hit + inside-rectangle test
    pis = world.planes()
    n, d = pis[:, :3], pis[:, 3]
    denom = torch.einsum("mi,hwi->hwm", n, rays_w)
    num = -(torch.einsum("mi,i->m", n, t_wc) + d)
    flat = torch.abs(denom) < 1e-9
    s_wall = num / torch.where(flat, torch.full_like(denom, 1e-9), denom)
    hit = t_wc + s_wall[..., None] * rays_w[:, :, None, :]
    seg = world.p1 - world.p0
    seg_len2 = torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12)
    rel = hit[..., :2] - world.p0
    u_par = torch.einsum("hwmi,mi->hwm", rel, seg) / seg_len2
    z_ok = (hit[..., 2] >= -1e-3) & (hit[..., 2] <= world.height + 1e-3)
    wall_ok = ((s_wall > 1e-6) & ~flat & (u_par >= 0.0) & (u_par <= 1.0)
               & z_ok & world.valid)
    s_wall = torch.where(wall_ok, s_wall, torch.full_like(s_wall, math.inf))
    s_best_wall, best_wall = torch.min(s_wall, dim=-1)

    s_all = torch.minimum(s_ground, s_best_wall)
    sky = torch.isinf(s_all)
    labels = torch.where(
        sky, LABEL_SKY,
        torch.where(s_best_wall < s_ground, LABEL_WALL_BASE + best_wall,
                    LABEL_GROUND)).to(torch.int32)
    depth = torch.where(sky, torch.full_like(s_all, max_depth), s_all)
    return labels, depth


def render_rgb(labels: torch.Tensor, generator: torch.Generator | None = None,
               tint_u: torch.Tensor | None = None,
               noise_n: torch.Tensor | None = None,
               floor_rgb=(0.30, 0.24, 0.20),
               wall_rgb=(0.82, 0.80, 0.75),
               sky_rgb=(0.95, 0.95, 0.97),
               wall_tint: float = 0.06,
               noise: float = 0.02) -> torch.Tensor:
    """Colorize a label image (H, W) into a low-texture RGB frame (H, W,
    3) f32 in [0, 1]: per-wall tints plus pixel noise.  ``tint_u`` (64,
    3) uniform in [0, 1) and ``noise_n`` (H, W, 3) standard normal are
    the reference's two draws; each one not given is drawn from
    ``generator``."""
    H, W = labels.shape
    dev = labels.device
    if tint_u is None:
        tint_u = torch.rand((64, 3), generator=generator).to(dev)
    if noise_n is None:
        noise_n = torch.randn((H, W, 3), generator=generator).to(dev)
    floor = torch.tensor(floor_rgb, device=dev)
    wall = torch.tensor(wall_rgb, device=dev)
    sky = torch.tensor(sky_rgb, device=dev)
    tints = wall_tint * (tint_u.to(dev) - 0.5)
    wall_idx = torch.clamp(labels - LABEL_WALL_BASE, 0, 63).long()
    wall_col = wall + tints[wall_idx]
    img = torch.where(
        (labels == LABEL_GROUND)[..., None], floor,
        torch.where((labels == LABEL_SKY)[..., None], sky, wall_col))
    img = img + noise * noise_n.to(dev)
    return torch.clamp(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# Ground-truth plane observations + noisy odometry
# ---------------------------------------------------------------------------

class FrameObservations(NamedTuple):
    """Per-frame plane detections in the camera frame, fixed capacity:
    planes_c (D, 4), centroid_c (D, 3), endpoints_c (D, 2, 3), wall_id
    (D,) int32 (world wall index; -1 none, -2 ground), valid (D,)."""

    planes_c: torch.Tensor
    centroid_c: torch.Tensor
    endpoints_c: torch.Tensor
    wall_id: torch.Tensor
    valid: torch.Tensor


def _halfspace_interval(fa, fb, lo, hi):
    """f(s) = fa + s (fb - fa) >= 0 on [lo', hi'] within [lo, hi]."""
    df = fb - fa
    tiny = torch.abs(df) < 1e-12
    s_cross = -fa / torch.where(tiny, torch.full_like(df, 1e-12), df)
    new_lo = torch.where(df > 0, torch.maximum(lo, s_cross), lo)
    new_hi = torch.where(df < 0, torch.minimum(hi, s_cross), hi)
    new_hi = torch.where(tiny & (fa < 0), new_lo - 1.0, new_hi)
    return new_lo, new_hi


def observe_frame(world: WallWorld, R_wc, t_wc,
                  noise: torch.Tensor | None = None,
                  max_det: int = 8, max_range: float = 12.0,
                  tan_half_fov: float = 1.1, znear: float = 0.2,
                  min_vis_len: float = 0.3, noise_plane: float = 0.0,
                  include_ground: bool = True) -> FrameObservations:
    """Simulate the pop-up front end's output for one pose (no
    rendering): each wall's ground line clipped to z > znear and the
    horizontal FOV, visible when at least ``min_vis_len`` long within
    ``max_range``.  With ``noise_plane`` > 0 the camera-frame planes are
    perturbed in the tangent space by ``noise_plane`` times ``noise``,
    the (M, 3) standard-normal draws (the reference's ``key``)."""
    R_cw, t_cw = se3.se3_inverse(R_wc, t_wc)
    M = world.max_walls
    zero = torch.zeros_like(world.p0[:, :1])
    a = se3.se3_apply(R_cw, t_cw, torch.cat([world.p0, zero], -1))
    b = se3.se3_apply(R_cw, t_cw, torch.cat([world.p1, zero], -1))
    d = b - a

    s_lo = torch.zeros((M,), device=a.device)
    s_hi = torch.ones((M,), device=a.device)
    s_lo, s_hi = _halfspace_interval(a[:, 2] - znear, b[:, 2] - znear,
                                     s_lo, s_hi)
    s_lo, s_hi = _halfspace_interval(
        tan_half_fov * a[:, 2] - a[:, 0], tan_half_fov * b[:, 2] - b[:, 0],
        s_lo, s_hi)
    s_lo, s_hi = _halfspace_interval(
        tan_half_fov * a[:, 2] + a[:, 0], tan_half_fov * b[:, 2] + b[:, 0],
        s_lo, s_hi)
    pa = a + s_lo[:, None] * d
    pb = a + s_hi[:, None] * d
    vis_len = torch.where(s_hi > s_lo, torch.linalg.norm(pb - pa, dim=-1),
                          torch.zeros_like(s_hi))
    near_dist = torch.minimum(torch.linalg.norm(pa, dim=-1),
                              torch.linalg.norm(pb, dim=-1))
    vis = world.valid & (vis_len >= min_vis_len) & (near_dist < max_range)

    # range-clip the far end so reported extents stay local
    def clip(p, q):
        far = torch.linalg.norm(p, dim=-1) > max_range
        scale = max_range / torch.clamp(
            torch.linalg.norm(p - q, dim=-1, keepdim=True), min=1e-9)
        return torch.where(far[:, None], q + (p - q) * scale, p)

    pb = clip(pb, pa)
    pa = clip(pa, pb)
    mid_c = (pa + pb) / 2.0

    pis_c = plane.transform(world.planes(), R_cw, t_cw)
    if noise_plane > 0.0 and noise is not None:
        pis_c = plane.retract(pis_c, noise_plane * noise.to(pis_c.device))

    # visible walls first (stable), then the ground in the last slot
    take = torch.argsort((~vis).to(torch.int32), stable=True)[:max_det]
    planes_c = pis_c[take]
    centroid_c = mid_c[take]
    endpoints_c = torch.stack([pa[take], pb[take]], dim=1)
    wall_id = torch.where(vis[take], take,
                          torch.full_like(take, -1)).to(torch.int32)
    valid = vis[take]

    if include_ground:
        ground_w = torch.tensor([0.0, 0.0, 1.0, 0.0], device=a.device)
        ground_c = plane.transform(ground_w, R_cw, t_cw)
        gpt_w = t_wc * torch.tensor([1.0, 1.0, 0.0], device=a.device)
        gpt_c = se3.se3_apply(R_cw, t_cw, gpt_w)
        last = torch.arange(planes_c.shape[0], device=a.device) == \
            planes_c.shape[0] - 1
        planes_c = torch.where(last[:, None], ground_c, planes_c)
        centroid_c = torch.where(last[:, None], gpt_c, centroid_c)
        endpoints_c = torch.where(last[:, None, None],
                                  torch.stack([gpt_c, gpt_c]), endpoints_c)
        wall_id = torch.where(last, torch.full_like(wall_id, -2), wall_id)
        valid = valid | last
    return FrameObservations(planes_c, centroid_c, endpoints_c, wall_id,
                             valid)


def noisy_odometry(R_wc, t_wc, xi: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   sigma_t: float = 0.0, sigma_r: float = 0.0):
    """Relative poses between consecutive frames with tangent-space
    noise: T_i^-1 T_{i+1} composed with exp(xi_i * sigma), sigma =
    (sigma_t x3, sigma_r x3).  ``xi`` (N-1, 6) standard normal, drawn
    from ``generator`` when not given.  Returns (R_rel, t_rel)."""
    Rr, tr = se3.se3_between(R_wc[:-1], t_wc[:-1], R_wc[1:], t_wc[1:])
    if xi is None:
        xi = torch.randn((Rr.shape[0], 6), generator=generator)
    sig = torch.tensor([sigma_t] * 3 + [sigma_r] * 3)
    dR, dt = se3.se3_exp((xi.cpu() * sig).to(Rr.device))
    return se3.se3_compose(Rr, tr, dR, dt)
