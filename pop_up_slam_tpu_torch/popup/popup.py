"""Single-image "pop-up": ground-wall boundary -> 3D wall planes + depth.

Port of ``pop_up_slam_tpu/popup/popup.py``: a fixed-shape,
column-parallel program on tensors.

1. Boundary extraction: per column, the topmost ground pixel with enough
   ground support below it.
2. Inverse projection of the boundary onto the world ground plane z=0.
3. Polyline segmentation: corners of the smoothed world-space tangent
   direction with windowed non-max suppression; segment ids by a
   cumulative sum of break flags (capacity ``max_segments``).
4. Per-segment total-least-squares line fit -> vertical wall planes.
5. Depth recovery (:func:`depth_from_popup`, the plain version of the
   depth-render kernel in :mod:`..ops.depth_render`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .._device import const
from ..geometry import camera as cam
from ..geometry import plane as plane_mod
from ..geometry import se3
from ..geometry.camera import Intrinsics


class PopupConfig(NamedTuple):
    max_segments: int = 8
    smooth_radius: int = 7          # columns, tangent estimation half-window
    corner_angle: float = 0.5       # rad, break threshold on direction change
    nms_radius: int = 9             # columns, corner non-max suppression
    range_jump: float = 0.6         # m, occlusion break threshold
    max_range: float = 15.0         # m, boundary points beyond are invalid
    min_cols: int = 12              # min columns for a valid wall segment
    wall_height: float = 2.5        # m, for output polygons only
    min_boundary_rows: int = 2      # min ground pixels per column
    levels: int = 1                 # ground-run boundary levels per column


class PopupPlanes(NamedTuple):
    """Fixed-capacity pop-up result for one frame (S = levels *
    max_segments wall slots); field meanings as in the reference."""

    planes_w: torch.Tensor      # (S, 4)
    planes_c: torch.Tensor      # (S, 4)
    endpoints_w: torch.Tensor   # (S, 2, 3)
    centroid_c: torch.Tensor    # (S, 3)
    n_points: torch.Tensor      # (S,) int32
    valid: torch.Tensor         # (S,) bool
    clipped: torch.Tensor       # (S, 2) bool
    ground_c: torch.Tensor      # (4,)
    boundary_v: torch.Tensor    # (W,) f32; (B, W) when B > 1
    boundary_ok: torch.Tensor   # (W,) bool; (B, W) when B > 1
    seg_id: torch.Tensor        # (W,) int32; (B*W,) when B > 1


def _window_sum_rows(x: torch.Tensor, win: int) -> torch.Tensor:
    """sum x[v : v + win] per row v of an int (H + win - 1, W) array."""
    P = torch.cumsum(x, dim=0)
    P = torch.cat([torch.zeros_like(P[:1]), P], dim=0)
    return P[win:] - P[:-win]


def extract_boundary(ground_mask: torch.Tensor, min_rows: int = 2,
                     noise_win: int = 8, noise_min: int = 6):
    """Per-column topmost *supported* ground pixel.

    ground_mask (H, W) bool -> (v_boundary (W,) f32, ok (W,) bool).  The
    boundary is the topmost row whose ``noise_win``-row window below
    holds at least ``noise_min`` ground pixels; columns where no row
    qualifies fall back to the plain topmost ground pixel.  The window
    sum is an integer cumsum (exact)."""
    H, W = ground_mask.shape
    dev = ground_mask.device
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    big = torch.full((), H + 1, dtype=torch.int32, device=dev)
    v_top = torch.amin(torch.where(ground_mask, rows, big), dim=0)
    count = torch.sum(ground_mask, dim=0)
    ok = (count >= min_rows) & (v_top < H)

    mi = torch.cat(
        [ground_mask, ground_mask[-1:].expand(noise_win - 1, W)], dim=0
    ).to(torch.int32)
    support = _window_sum_rows(mi, noise_win)                # (H, W)
    supported = ground_mask & (support >= noise_min)
    v_rob = torch.amin(torch.where(supported, rows, big), dim=0)
    v = torch.where(v_rob < H, v_rob, v_top)
    return v.to(torch.float32), ok


def extract_boundaries(ground_mask: torch.Tensor, min_rows: int = 2,
                       levels: int = 2):
    """Tops of the first ``levels`` ground runs per column, top-down.
    Returns (v (levels, W) f32, ok (levels, W) bool)."""
    H, W = ground_mask.shape
    dev = ground_mask.device
    rows = torch.arange(H, dtype=torch.int32, device=dev)[:, None]
    above = torch.cat([torch.zeros_like(ground_mask[:1]), ground_mask[:-1]])
    is_top = ground_mask & ~above
    mr = max(min_rows, 1)
    m = torch.cat(
        [ground_mask, torch.zeros((mr - 1, W), dtype=torch.bool, device=dev)]
    ).to(torch.int32)
    run_ok = _window_sum_rows(m, mr) == mr                   # window-AND
    top_ok = is_top & run_ok
    cand = torch.where(top_ok, rows,
                       torch.full((), H + 1, dtype=torch.int32, device=dev))
    v = torch.sort(cand, dim=0).values[:levels]
    ok = v <= H - 1
    return v.to(torch.float32), ok


def _window_reduce_max(x: torch.Tensor, radius: int) -> torch.Tensor:
    """'SAME' windowed max over a 1-D tensor, -inf padded."""
    pad = torch.full((radius,), float("-inf"), dtype=x.dtype,
                     device=x.device)
    xp = torch.cat([pad, x, pad])
    return xp.unfold(0, 2 * radius + 1, 1).amax(dim=-1)


def _xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 prefix sum along the last dim, in the order of the
    reference's ``jnp.cumsum`` as XLA runs it on the CPU: a recursive
    blocked scan with base 16.  The rows of 16 (the tail zero-padded) are
    summed left to right, their totals are scanned the same way, and each
    row then adds the total of the rows before it.

    The port reproduces the reference's arithmetic, it does not fix it:
    where a box sum is empty its value is the residue of this order, and
    that residue decides which columns a corner falls on (the reference
    trajectories were made with it).  ``torch.cumsum`` sums in double on
    the CPU and in a parallel order on the card.  f32 adds round
    correctly on both devices, so these 15 column adds and the offset add
    give the reference's bits on either."""
    n = x.shape[-1]
    m = -(-n // 16)
    # pad copies, so the in-place adds never write into x
    y = torch.nn.functional.pad(x, (0, 16 * m - n)).reshape(
        *x.shape[:-1], m, 16)
    cols = y.unbind(-1)  # views of y's 16 columns
    for j in range(1, 16):
        cols[j].add_(cols[j - 1])
    if m > 1:
        off = _xla_cumsum(cols[15])
        y[..., 1:, :] += off[..., :-1, None]
    return y.reshape(*x.shape[:-1], 16 * m)[..., :n]


def _angle_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.abs(torch.atan2(torch.sin(d), torch.cos(d)))


def segment_boundary(pts_w: torch.Tensor, pt_ok: torch.Tensor,
                     cfg: PopupConfig) -> torch.Tensor:
    """Split the world-space boundary polyline into straight segments.
    pts_w (W, 2), pt_ok (W,) -> seg_id (W,) int32 in [-1, max_segments)."""
    Wd = pts_w.shape[0]
    k = cfg.smooth_radius
    ok_f = pt_ok.to(pts_w.dtype)

    # box sums of ok, x*ok, y*ok as one (3, Wd) scan:
    # sum x[i-k..i+k] = P[i+2k+1] - P[i], P = cumsum(pad(x, (k+1, k)))
    X = torch.stack([ok_f, pts_w[:, 0] * ok_f, pts_w[:, 1] * ok_f])
    P = _xla_cumsum(torch.nn.functional.pad(X, (k + 1, k)))
    box = P[:, 2 * k + 1:] - P[:, :Wd]
    den = torch.clamp(box[0], min=1e-6)
    sx = box[1] / den
    sy = box[2] / den
    dx = torch.roll(sx, -k) - torch.roll(sx, k)
    dy = torch.roll(sy, -k) - torch.roll(sy, k)
    theta = torch.atan2(dy, dx)

    dtheta = _angle_diff(torch.roll(theta, -k), torch.roll(theta, k))
    step = torch.linalg.norm(pts_w - torch.roll(pts_w, 1, dims=0), dim=-1)
    jump = step > cfg.range_jump
    prev_ok = torch.roll(pt_ok, 1)
    fresh = pt_ok & (~prev_ok)

    local_max = dtheta >= _window_reduce_max(dtheta, cfg.nms_radius) - 1e-6
    corner = (dtheta > cfg.corner_angle) & local_max & pt_ok

    brk = (corner | jump | fresh) & pt_ok
    brk = torch.cat([pt_ok[:1], brk[1:]])
    seg_raw = torch.cumsum(brk.to(torch.int32), dim=0, dtype=torch.int32) - 1
    keep = pt_ok & (seg_raw >= 0) & (seg_raw < cfg.max_segments)
    return torch.where(keep, seg_raw, torch.full_like(seg_raw, -1))


def fit_wall_planes(pts_w: torch.Tensor, seg_id: torch.Tensor,
                    cfg: PopupConfig, pt_ok: torch.Tensor | None = None):
    """Per-segment TLS line fit in world XY -> vertical wall planes.

    Returns (planes_w (S,4), endpoints_w (S,2,3), n_points (S,) int32,
    valid (S,), clipped (S,2) bool)."""
    S = cfg.max_segments
    Wd = pts_w.shape[0]
    dev, dt = pts_w.device, pts_w.dtype

    member = seg_id[None, :] == torch.arange(S, dtype=seg_id.dtype,
                                             device=dev)[:, None]
    Mf = member.to(dt)

    x, y = pts_w[:, 0], pts_w[:, 1]
    vals = torch.stack([torch.ones_like(x), x, y, x * x, y * y, x * y],
                       dim=-1)                              # (Wd, 6)
    sums = Mf @ vals                                        # (S, 6)
    n, sx, sy, sxx, syy, sxy = (sums[:, k] for k in range(6))

    n_safe = torch.clamp(n, min=1.0)
    mx, my = sx / n_safe, sy / n_safe
    cxx = sxx / n_safe - mx * mx
    cyy = syy / n_safe - my * my
    cxy = sxy / n_safe - mx * my

    tr = cxx + cyy
    dlt = torch.sqrt(torch.clamp((cxx - cyy) ** 2 + 4 * cxy ** 2, min=0.0))
    lam = 0.5 * (tr + dlt)
    v1 = torch.stack([cxy, lam - cxx], dim=-1)
    v2 = torch.stack([lam - cyy, cxy], dim=-1)
    use2 = torch.linalg.norm(v1, dim=-1) < 1e-9
    d = torch.where(use2[:, None], v2, v1)
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    xdir = const([1.0, 0.0], dt, dev)
    d = torch.where(dn < 1e-9, xdir, d / torch.clamp(dn, min=1e-9))

    nrm = torch.stack([d[:, 1], -d[:, 0], torch.zeros_like(d[:, 0])], dim=-1)
    off = -(nrm[:, 0] * mx + nrm[:, 1] * my)
    planes_w = plane_mod.normalize(torch.cat([nrm, off[:, None]], dim=-1))

    d_cols = torch.einsum("sw,sk->wk", Mf, d)               # (Wd, 2)
    proj = x * d_cols[:, 0] + y * d_cols[:, 1]
    big = torch.full((), 1e9, dtype=dt, device=dev)
    pmin = torch.amin(torch.where(member, proj[None, :], big), dim=1)
    pmax = torch.amax(torch.where(member, proj[None, :], -big), dim=1)
    mid_proj = mx * d[:, 0] + my * d[:, 1]
    empty = n < 0.5
    pmin = torch.where(empty, mid_proj, pmin)
    pmax = torch.where(empty, mid_proj, pmax)
    c = torch.stack([mx, my], dim=-1)
    e0 = c + (pmin - mid_proj)[:, None] * d
    e1 = c + (pmax - mid_proj)[:, None] * d
    pad0 = torch.nn.functional.pad
    endpoints_w = torch.stack([pad0(e0, (0, 1)), pad0(e1, (0, 1))], dim=1)

    cols = torch.arange(Wd, dtype=torch.int32, device=dev)
    bigi = torch.full((), Wd + 1, dtype=torch.int32, device=dev)
    umin = torch.amin(torch.where(member, cols[None, :], bigi), dim=1)
    umax = torch.amax(torch.where(member, cols[None, :],
                                  torch.full_like(bigi, -1)), dim=1)
    if pt_ok is None:
        pt_ok = seg_id >= 0
    false1 = torch.zeros((1,), dtype=torch.bool, device=dev)
    ok_pad = torch.cat([false1, pt_ok, false1])
    umin_c = torch.clamp(umin, 0, Wd - 1).long()
    umax_c = torch.clamp(umax, 0, Wd - 1).long()
    clip_left = ~ok_pad[umin_c]
    clip_right = ~ok_pad[umax_c + 2]
    proj_at_umin = proj[umin_c]
    left_is_pmin = (torch.abs(proj_at_umin - pmin)
                    <= torch.abs(proj_at_umin - pmax))
    clip_pmin = torch.where(left_is_pmin, clip_left, clip_right)
    clip_pmax = torch.where(left_is_pmin, clip_right, clip_left)
    clipped = torch.stack([clip_pmin, clip_pmax], dim=-1)

    valid = n >= cfg.min_cols
    return planes_w, endpoints_w, n.to(torch.int32), valid, clipped


def pop_up(K: Intrinsics, ground_mask: torch.Tensor, R_wc: torch.Tensor,
           t_wc: torch.Tensor,
           cfg: PopupConfig = PopupConfig()) -> PopupPlanes:
    """Full single-image pop-up.  ground_mask: (H, W) bool on the device
    the pop-up runs on; (R_wc, t_wc): the pose prior."""
    H, Wd = ground_mask.shape
    dev = ground_mask.device
    dt = t_wc.dtype
    if cfg.levels > 1:
        v_bs, b_oks = extract_boundaries(
            ground_mask, cfg.min_boundary_rows, cfg.levels
        )
    else:
        v_b1, b_ok1 = extract_boundary(ground_mask, cfg.min_boundary_rows)
        v_bs, b_oks = v_b1[None], b_ok1[None]

    R_cw, t_cw = se3.se3_inverse(R_wc, t_wc)
    ground_w = const([0.0, 0.0, 1.0, 0.0], dt, dev)
    ground_c = plane_mod.transform(ground_w, R_cw, t_cw)
    u = torch.arange(Wd, dtype=torch.float32, device=dev)
    S = cfg.max_segments

    def level(v_b, b_ok):
        # sample the junction between the last wall pixel and the first
        # ground pixel (v_b - 0.5)
        uv = torch.stack([u, v_b - 0.5], dim=-1)
        pts3, proj_ok = cam.backproject_to_world_plane(
            K, uv, R_wc, t_wc, ground_w
        )
        rng = torch.linalg.norm(pts3 - t_wc, dim=-1)
        pt_ok = b_ok & proj_ok & (rng < cfg.max_range)
        pts_w = pts3[:, :2]

        seg_id = segment_boundary(pts_w, pt_ok, cfg)
        planes_w, endpoints_w, n_pts, valid, clipped = fit_wall_planes(
            pts_w, seg_id, cfg, pt_ok
        )
        planes_c = plane_mod.transform(planes_w, R_cw, t_cw)

        pts_c = se3.se3_apply(R_cw, t_cw, pts3)
        Mf = (seg_id[None, :] == torch.arange(S, dtype=seg_id.dtype,
                                              device=dev)[:, None]).to(dt)
        csum = Mf @ pts_c
        centroid_c = csum / torch.clamp(n_pts[:, None].to(dt), min=1.0)
        return (planes_w, planes_c, endpoints_w, centroid_c, n_pts,
                valid, clipped, seg_id)

    if cfg.levels > 1:
        per = [level(v_bs[b], b_oks[b]) for b in range(cfg.levels)]
        outs = [torch.stack([p[k] for p in per]) for k in range(8)]
        sid = outs[7]
        off = torch.arange(cfg.levels, dtype=sid.dtype,
                           device=dev)[:, None] * S
        outs[7] = torch.where(sid >= 0, sid + off, torch.full_like(sid, -1))
        (planes_w, planes_c, endpoints_w, centroid_c, n_pts, valid,
         clipped, seg_id) = (o.reshape((-1,) + o.shape[2:]) for o in outs)
        boundary_v, boundary_ok = v_bs, b_oks
    else:
        (planes_w, planes_c, endpoints_w, centroid_c, n_pts, valid,
         clipped, seg_id) = level(v_bs[0], b_oks[0])
        boundary_v, boundary_ok = v_bs[0], b_oks[0]

    return PopupPlanes(
        planes_w=planes_w, planes_c=planes_c, endpoints_w=endpoints_w,
        centroid_c=centroid_c, n_points=n_pts, valid=valid, clipped=clipped,
        ground_c=ground_c, boundary_v=boundary_v, boundary_ok=boundary_ok,
        seg_id=seg_id,
    )


def depth_from_popup(K: Intrinsics, res: PopupPlanes,
                     ground_mask: torch.Tensor, R_wc: torch.Tensor,
                     t_wc: torch.Tensor, max_depth: float = 50.0,
                     wall_height: float = 2.5,
                     extent_pad: float = 0.5) -> torch.Tensor:
    """Dense depth from the popped-up plane model: a z-buffer render of
    every valid wall (hit inside the wall's padded ground-line extent
    and height band), ground pixels taking the ground-plane depth.  The
    plain version of the depth-render kernel (:mod:`..ops.depth_render`).
    """
    H, Wd = ground_mask.shape
    dev, dt = t_wc.device, t_wc.dtype
    vv, uu = torch.meshgrid(torch.arange(H, dtype=dt, device=dev),
                            torch.arange(Wd, dtype=dt, device=dev),
                            indexing="ij")
    rays_c = cam.pixel_rays(K, torch.stack([uu, vv], dim=-1))  # (H, W, 3)
    rays_w = torch.einsum("ij,hwj->hwi", R_wc, rays_c)

    s_g, ok_g = cam.ray_plane_depth(rays_c, res.ground_c)

    n = res.planes_w[:, :3]
    d = res.planes_w[:, 3]
    denom = torch.einsum("si,hwi->hws", n, rays_w)
    num = -(torch.einsum("si,i->s", n, t_wc) + d)
    safe_den = torch.where(torch.abs(denom) < 1e-9,
                           torch.full_like(denom, 1e-9), denom)
    s_w = num[None, None, :] / safe_den                       # (H, W, S)
    hit = t_wc + s_w[..., None] * rays_w[:, :, None, :]

    e0 = res.endpoints_w[:, 0, :2]
    e1 = res.endpoints_w[:, 1, :2]
    seg = e1 - e0
    seg_len = torch.sqrt(torch.clamp(torch.sum(seg * seg, dim=-1), min=1e-12))
    d_unit = seg / seg_len[:, None]
    u_par = torch.einsum("hwsi,si->hws", hit[..., :2] - e0, d_unit)
    far = torch.full((), max_depth, dtype=dt, device=dev)
    pad = torch.full((), extent_pad, dtype=dt, device=dev)
    lo_pad = torch.where(res.clipped[:, 0], far, pad)
    hi_pad = torch.where(res.clipped[:, 1], far, pad)
    in_extent = (u_par >= -lo_pad) & (u_par <= seg_len + hi_pad)
    z_ok = (hit[..., 2] >= -0.1) & (hit[..., 2] <= wall_height + 0.1)
    wall_ok = ((s_w > 1e-6) & (torch.abs(denom) >= 1e-9) & in_extent
               & z_ok & res.valid)
    s_w = torch.where(wall_ok, s_w, torch.full_like(s_w, float("inf")))
    s_wall = torch.amin(s_w, dim=-1)

    ground_px = ground_mask & ok_g
    depth = torch.where(
        ground_px, s_g,
        torch.where(torch.isinf(s_wall), far, s_wall),
    )
    return torch.clamp(depth, 0.0, max_depth)


def render_depth(K: Intrinsics, res: PopupPlanes, ground_mask: torch.Tensor,
                 R_wc: torch.Tensor, t_wc: torch.Tensor,
                 max_depth: float = 50.0, wall_height: float = 2.5,
                 extent_pad: float = 0.5, pallas: str = "auto"):
    """Dense depth, dispatching on the tensors' device.

    ``pallas`` keeps the reference's field name: ``"auto"`` and ``"on"``
    go through the depth-render kernel wrapper, which launches the CUDA
    kernel on CUDA tensors and runs :func:`depth_from_popup` on CPU
    tensors; ``"off"`` always runs :func:`depth_from_popup`."""
    if pallas not in ("auto", "on", "off"):
        raise ValueError(f"pallas must be auto|on|off, got {pallas!r}")
    if pallas == "off":
        return depth_from_popup(K, res, ground_mask, R_wc, t_wc,
                                max_depth=max_depth, wall_height=wall_height,
                                extent_pad=extent_pad)
    from ..ops.depth_render import depth_render

    return depth_render(K, res, ground_mask, R_wc, t_wc, max_depth=max_depth,
                        wall_height=wall_height, extent_pad=extent_pad)
