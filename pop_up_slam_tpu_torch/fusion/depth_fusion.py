"""Semi-dense depth fusion with popped-up plane depth.

Port of ``pop_up_slam_tpu/fusion/depth_fusion.py``: a per-pixel
inverse-depth Gaussian filter (mu, sigma^2, valid) seeded from pop-up
plane depth, scale alignment of a scale-ambiguous inverse-depth map
against plane depth (masked median of ratios), Bayesian fusion of new
observations with an outlier gate, and forward propagation of the filter
into the next frame (a z-buffer splat).  Fixed-shape tensor code over
(H, W) maps with no host reads.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.camera import Intrinsics, pixel_rays


class DepthFilter(NamedTuple):
    """Per-pixel inverse-depth Gaussian state in the current keyframe."""

    inv_mu: torch.Tensor    # (H, W) inverse depth mean [1/m]
    var: torch.Tensor       # (H, W) inverse-depth variance
    valid: torch.Tensor     # (H, W) bool


def init_from_popup(depth: torch.Tensor, valid: torch.Tensor | None = None,
                    sigma0_rel: float = 0.05,
                    max_depth: float = 40.0) -> DepthFilter:
    """Seed the filter from a popped-up plane depth map: inverse depth
    with prior std ``sigma0_rel * inv_depth`` (floor 1e-4)."""
    d = torch.clamp(depth, 1e-3, max_depth)
    inv = 1.0 / d
    ok = (depth > 1e-3) & (depth < max_depth)
    if valid is not None:
        ok = ok & valid
    sig = torch.clamp(sigma0_rel * inv, min=1e-4)
    return DepthFilter(
        inv_mu=torch.where(ok, inv, 0.0),
        var=torch.where(ok, sig * sig, 1e6),
        valid=ok,
    )


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmedian`` of a flat tensor: the mean of the two middle
    values when the count of non-NaN entries is even (``torch.nanmedian``
    takes the lower one), NaN when there is none.  Sorted with NaN last;
    the middle positions are gathered on the device."""
    a = torch.sort(x).values
    count = torch.sum(~torch.isnan(a)).to(a.dtype)
    q = 0.5 * (count - 1.0)
    last = count - 1.0
    low = torch.clamp(torch.minimum(torch.floor(q), last), min=0.0)
    high = torch.clamp(torch.minimum(torch.ceil(q), last), min=0.0)
    lo_v = torch.gather(a, 0, low.long()[None])[0]
    hi_v = torch.gather(a, 0, high.long()[None])[0]
    return (lo_v + hi_v) * 0.5


def align_scale(ambiguous_inv_depth: torch.Tensor, plane_depth: torch.Tensor,
                weight: torch.Tensor | None = None,
                eps: float = 1e-6) -> torch.Tensor:
    """Scale s with s * ambiguous_inv_depth ~= 1 / plane_depth: the
    median of per-pixel ratios over the pixels where both are valid."""
    plane_inv = 1.0 / torch.clamp(plane_depth, 1e-3, 1e3)
    ok = (ambiguous_inv_depth > eps) & (plane_depth > 1e-3)
    if weight is not None:
        ok = ok & (weight > 0)
    ratio = plane_inv / torch.clamp(ambiguous_inv_depth, min=eps)
    ratio = torch.where(ok, ratio, float("nan"))
    return _nanmedian(ratio.reshape(-1))


def fuse_observation(flt: DepthFilter, obs_inv: torch.Tensor,
                     obs_var: torch.Tensor,
                     gate_sigma: float = 2.0) -> DepthFilter:
    """Bayesian product of the filter with a new inverse-depth map;
    observations outside ``gate_sigma`` combined standard deviations are
    rejected, pixels with no prior adopt the observation."""
    obs_ok = torch.isfinite(obs_inv) & (obs_inv > 0) & (obs_var > 0)

    innov = obs_inv - flt.inv_mu
    s2 = flt.var + obs_var
    gate = innov * innov <= gate_sigma * gate_sigma * s2
    fuse = flt.valid & obs_ok & gate

    var_new = (flt.var * obs_var) / torch.clamp(s2, min=1e-12)
    mu_new = (flt.inv_mu * obs_var + obs_inv * flt.var) / torch.clamp(
        s2, min=1e-12)

    adopt = (~flt.valid) & obs_ok
    inv_mu = torch.where(fuse, mu_new,
                         torch.where(adopt, obs_inv, flt.inv_mu))
    var = torch.where(fuse, var_new, torch.where(adopt, obs_var, flt.var))
    return DepthFilter(inv_mu, var, flt.valid | adopt)


def propagate_to_frame(flt: DepthFilter, K: Intrinsics, R_rel: torch.Tensor,
                       t_rel: torch.Tensor, motion_var: float = 1e-4,
                       max_depth: float = 40.0) -> DepthFilter:
    """Warp the filter into the next frame; (R_rel, t_rel) is the
    old-from-new camera motion.  Each source pixel's point is moved into
    the new frame and splatted to its nearest pixel; the nearest depth
    wins (scatter-min z-buffer), and among sources within 1e-6 of it the
    last in row-major order, as the reference's in-order scatter on the
    CPU gives.  That winner is made explicit (an ``amax`` scatter of the
    source index, then a gather) because ``index_put_`` with duplicate
    indices picks an unspecified one.  Dropped pixels go to the sentinel
    bucket ``H*W``; no index is clipped.  Variance is transported by
    (d_old / d_new)^4 plus ``motion_var``; pixels nothing lands on are
    invalid."""
    H, W = flt.inv_mu.shape
    dt, dev = flt.inv_mu.dtype, flt.inv_mu.device
    vv, uu = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(W, dtype=dt, device=dev),
                            indexing="ij")
    rays = pixel_rays(K, torch.stack([uu, vv], dim=-1))   # (H, W, 3), z=1
    depth = 1.0 / torch.clamp(flt.inv_mu, 1e-3, 1e3)
    pts_old = rays * depth[..., None]

    R_no, t_no = se3.se3_inverse(R_rel, t_rel)            # new-from-old
    pts_new = torch.einsum("ij,hwj->hwi", R_no, pts_old) + t_no

    z = pts_new[..., 2]
    ok = flt.valid & (z > 1e-3) & (z < max_depth)
    zs = torch.clamp(z, min=1e-6)
    u = K.fx * pts_new[..., 0] / zs + K.cx
    v = K.fy * pts_new[..., 1] / zs + K.cy
    # dropped pixels can project anywhere: bound them before the integer
    # cast (an in-image pixel is far inside the bound)
    ui = torch.clamp(torch.round(u), -2.0 ** 30, 2.0 ** 30).long()
    vi = torch.clamp(torch.round(v), -2.0 ** 30, 2.0 ** 30).long()
    inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    ok = ok & inb

    n = H * W
    flat = torch.where(ok, vi * W + ui, n).reshape(-1)
    inf = torch.full_like(z, float("inf"))
    zbuf = torch.full((n + 1,), float("inf"), dtype=dt, device=dev)
    zbuf.scatter_reduce_(0, flat, torch.where(ok, z, inf).reshape(-1),
                         reduce="amin", include_self=True)
    won = (ok & (z <= zbuf[flat].reshape(H, W) + 1e-6)).reshape(-1)

    src = torch.arange(n, device=dev)
    winner = torch.full((n + 1,), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(0, torch.where(won, flat, n),
                           torch.where(won, src, -1), reduce="amax",
                           include_self=True)
    winner = winner[:n]
    landed = winner >= 0
    pick = torch.clamp(winner, min=0)

    inv_z = 1.0 / zs
    src_inv = torch.where(won, inv_z.reshape(-1), 0.0)
    scale2 = (depth * torch.where(won.reshape(H, W), inv_z, 0.0)) ** 2
    src_var = (flt.var * scale2 * scale2 + motion_var).reshape(-1)
    inv_new = torch.where(landed, src_inv[pick], 0.0)
    var_new = torch.where(landed, src_var[pick], 1e6)
    return DepthFilter(inv_mu=inv_new.reshape(H, W),
                       var=var_new.reshape(H, W),
                       valid=landed.reshape(H, W))
