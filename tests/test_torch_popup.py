"""Parity of the port's pop-up front-end with the JAX package on corridor
masks (committed inputs) downsampled 4x to 120x160 with the intrinsics
scaled by 1/4, clean and with salt noise.  Discrete outputs (boundary
rows, seg_id, valid, clipped, boundary_ok, n_points) must match exactly;
planes, endpoints and centroids to 1e-4 (f32 sums over ~160 columns) on
the valid wall slots of at least 12 columns (the production ``min_cols``)
and to 1e-3 on shorter ones: the reference's one-pass covariance
(sxx/n - mx^2) cancels in f32 for a short segment 10 m away, so the two
frameworks' summation orders already differ there at ~3e-4.  An invalid
slot (a 1-3 column segment) carries a fit whose direction is set by
rounding, and nothing downstream reads it (detections, association and
depth all mask by ``valid``).  A wall's two endpoints (with their
``clipped`` flags) are compared as an unordered pair: for a wall exactly
along a world axis the sign of the fitted direction is set by rounding,
and every consumer (overlap gates, extent unions, the depth render) is
symmetric in the pair."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_close, corridor_K, corridor_inputs, salt
from pop_up_slam_tpu.geometry import camera as jcam
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch.geometry import camera as tcam
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.popup import popup as tpp

STEP = 4
PCFG = dict(smooth_radius=3, nms_radius=5, min_cols=6)
TOL = 1e-4

_DISCRETE = ("n_points", "valid", "clipped", "boundary_v", "boundary_ok",
             "seg_id")

# the reference pop-up, compiled once per configuration for the module
_pop_up_jit = jax.jit(jpp.pop_up, static_argnames=("cfg",))
_jax_cumsum = jax.jit(jnp.cumsum)


def _pop_up_both(mask, R, t, cfg):
    """(port, reference) pop-up of one frame at the 120x160 intrinsics."""
    res_j = _pop_up_jit(JK.create(*corridor_K(STEP)), jnp.asarray(mask),
                        jnp.asarray(R), jnp.asarray(t),
                        cfg=jpp.PopupConfig(**cfg))
    res_t = tpp.pop_up(TK.create(*corridor_K(STEP), device="cpu"),
                       torch.as_tensor(mask), torch.as_tensor(R),
                       torch.as_tensor(t), tpp.PopupConfig(**cfg))
    return res_t, res_j


def _frame(i, noise):
    masks, _, _, _, _ = corridor_inputs(STEP)
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref.npz")
    mask = masks[i]
    if noise:
        mask = salt(mask, 0.01, seed=i)
    return mask, ref["R"][i], ref["t"][i]


def _pair_order(res_t, res_j):
    """Port endpoints and clipped flags, each pair put in the reference's
    order."""
    ep = res_t.endpoints_w.numpy().copy()
    cl = res_t.clipped.numpy().copy()
    ref = np.asarray(res_j.endpoints_w)
    swap = (np.abs(ep[:, ::-1] - ref).sum((1, 2))
            < np.abs(ep - ref).sum((1, 2)))
    ep[swap] = ep[swap][:, ::-1]
    cl[swap] = cl[swap][:, ::-1]
    return res_t._replace(endpoints_w=torch.as_tensor(ep),
                          clipped=torch.as_tensor(cl))


def _compare(res_t, res_j):
    res_t = _pair_order(res_t, res_j)
    valid = np.asarray(res_j.valid)
    tol = np.where(np.asarray(res_j.n_points) >= 12, TOL, 1e-3)
    for name in res_j._fields:
        a, b = getattr(res_t, name).numpy(), np.asarray(getattr(res_j, name))
        if name in _DISCRETE:
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        assert np.isfinite(a).all(), name
        if name == "ground_c":
            assert_close(a, b, TOL, rtol=1e-5, what=name)
            continue
        for s in np.flatnonzero(valid):
            assert_close(a[s], b[s], tol[s], rtol=1e-5, what=f"{name}[{s}]")


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("i", [0, 50, 100, 130])
def test_pop_up_matches_reference(i, noise):
    res_t, res_j = _pop_up_both(*_frame(i, noise), PCFG)
    assert bool(res_t.valid.any())
    _compare(res_t, res_j)


def test_pop_up_two_levels():
    """levels=2: run tops of the first two ground runs per column."""
    mask, R, t = _frame(70, noise=False)
    mask = mask.copy()
    mask[80:84, 40:120] = False        # an occluder splits the ground runs
    _compare(*_pop_up_both(mask, R, t, dict(PCFG, levels=2)))


@pytest.mark.parametrize("noise", [False, True])
def test_extract_boundary_full_width(noise):
    """The noise-robust boundary rule at the full 480x640 width."""
    masks, _, _, _, _ = corridor_inputs(1)
    mask = salt(masks[30], 0.02, seed=3) if noise else masks[30]
    v_j, ok_j = jpp.extract_boundary(jnp.asarray(mask))
    v_t, ok_t = tpp.extract_boundary(torch.as_tensor(mask))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))


def test_depth_from_popup_matches_reference():
    """The depth-render kernel's plain version against the reference's
    at 120x160 (rtol 1e-4 / atol 1e-3, as the reference's own kernel
    test)."""
    mask, R, t = _frame(60, noise=False)
    Kj = JK.create(*corridor_K(STEP))
    Kt = TK.create(*corridor_K(STEP), device="cpu")
    res_t, res_j = _pop_up_both(mask, R, t, PCFG)
    d_j = jpp.depth_from_popup(Kj, res_j, jnp.asarray(mask), jnp.asarray(R),
                               jnp.asarray(t))
    d_t = tpp.render_depth(Kt, res_t, torch.as_tensor(mask),
                           torch.as_tensor(R), torch.as_tensor(t))
    assert_close(d_t, d_j, 1e-3, rtol=1e-4, what="depth")


def _empty_window_case():
    """Frame 134 of the corridor at the pose the reference's LM run
    predicted for it (its frame-133 output), full width."""
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref_solvers.npz")
    masks, _, _, _, _ = corridor_inputs(1)
    return masks[134], ref["lm_R"][133], ref["lm_t"][133]


@jax.jit
def _jax_boundary_points(mask, R, t):
    """The reference pop-up's boundary points, validity and segments."""
    cfg = jpp.PopupConfig()
    v_b, b_ok = jpp.extract_boundary(mask, cfg.min_boundary_rows)
    uv = jnp.stack([jnp.arange(mask.shape[1], dtype=jnp.float32),
                    v_b - 0.5], -1)
    K = JK.create(*corridor_K(1))
    pts3, proj_ok = jcam.backproject_to_world_plane(
        K, uv, R, t, jnp.array([0.0, 0.0, 1.0, 0.0]))
    ok = b_ok & proj_ok & (jnp.linalg.norm(pts3 - t, axis=-1)
                           < cfg.max_range)
    return pts3[:, :2], ok, jpp.segment_boundary(pts3[:, :2], ok, cfg)


def test_segment_boundary_empty_window_branch():
    """Where a column's +-smooth_radius window holds no valid boundary
    column, its box-filtered point is an empty sum over the 1e-6 floor:
    the residue of the cumsum difference there, whose value depends on
    the order of the sum.  The tangent at the last valid columns of a run
    reads that point, so the corner between two walls moves by a few
    columns with it and a short wall's column count crosses its
    threshold: the pop-up at frame 134 of the LM and dog-leg corridor
    runs (PERF.md).  The port's box sums take the reference's order
    (``_xla_cumsum``), so at the reference's own pose both frameworks
    split the same points into the same walls, column for column."""
    mask, R, t = _empty_window_case()
    pts, ok, seg_j = (np.array(x) for x in _jax_boundary_points(
        jnp.asarray(mask), jnp.asarray(R), jnp.asarray(t)))
    seg_t = tpp.segment_boundary(torch.as_tensor(pts), torch.as_tensor(ok),
                                 tpp.PopupConfig()).numpy()
    np.testing.assert_array_equal(seg_t, seg_j)
    assert (np.bincount(seg_j[seg_j >= 0]).tolist()
            == [12, 322, 7])                       # wall 2: 7 columns
    assert (np.bincount(seg_t[seg_t >= 0]).tolist() == [12, 322, 7])
    # the first column whose window is empty: 7 past the run's end; its
    # box sum is a non-zero residue, the same in both
    k = tpp.PopupConfig().smooth_radius
    last = int(np.flatnonzero(ok)[-1])
    x = np.pad(pts[:, 0] * ok, (k + 1, k)).astype(np.float32)
    P_j = np.asarray(_jax_cumsum(jnp.asarray(x)))
    P_t = tpp._xla_cumsum(torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(P_t, P_j)
    i = last + k + 1
    assert P_t[i + 2 * k + 1] - P_t[i] == P_j[i + 2 * k + 1] - P_j[i] != 0.0


@pytest.mark.parametrize("n", [1, 15, 16, 17, 175, 655, 1000])
def test_xla_cumsum_matches_jax(n):
    """The port's box-sum scan equals the reference's ``jnp.cumsum`` bit
    for bit: lengths within one row of 16, at its edges, the 120x160 and
    480x640 frames' padded widths (160 + 15, 640 + 15) and three levels
    of rows (1000)."""
    x = (np.random.default_rng(n).normal(size=n) * 10).astype(np.float32)
    want = np.asarray(_jax_cumsum(jnp.asarray(x)))
    np.testing.assert_array_equal(tpp._xla_cumsum(torch.as_tensor(x)).numpy(),
                                  want)



def _divided_backprojection(K, uv, R_wc, t_wc, pi_w, eps=1e-6):
    """The back-projection rounded as plain f32 arithmetic does (the
    focal lengths divided, ``t + s * r`` rounded twice): the rounding
    that parts from the reference's runners."""
    x = (uv[..., 0] - K.cx) / K.fx
    y = (uv[..., 1] - K.cy) / K.fy
    r_w = (R_wc @ torch.stack([x, y, torch.ones_like(x)], -1)[..., None])[
        ..., 0]
    denom = torch.sum(pi_w[:3] * r_w, dim=-1)
    num = -(torch.sum(pi_w[:3] * t_wc, dim=-1) + pi_w[3])
    s = num / torch.where(denom.abs() < eps, torch.full_like(denom, eps),
                          denom)
    return t_wc + s[..., None] * r_w, (denom.abs() >= eps) & (s > eps)


def test_pop_up_at_the_reference_poses_matches_its_record(monkeypatch):
    """The port's pop-up at 480x640, given the pose the reference gave its
    own pop-up on a corridor frame of the main path (``popup_R`` /
    ``popup_t`` in ``corridor_ref.npz``), finds the reference's valid
    walls and column counts: on frames 7 and 77, where the plain f32
    rounding of the back-projection (the focal lengths divided, ``t + s *
    r`` rounded twice, see the next test) parts from the reference, and on
    six others (``chip_smoke.py`` and tests/test_torch_cuda.py hold all
    144 frames on the card)."""
    masks, _, _, _, _ = corridor_inputs(1)
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref.npz")
    K = TK.create(*corridor_K(1), device="cpu")

    def parted():
        out = []
        for i in (0, 7, 40, 47, 77, 80, 120, 134):
            res = tpp.pop_up(K, torch.as_tensor(masks[i]),
                             torch.as_tensor(ref["popup_R"][i]),
                             torch.as_tensor(ref["popup_t"][i]))
            if not (np.array_equal(res.valid.numpy(), ref["popup_valid"][i])
                    and np.array_equal(res.n_points.numpy(),
                                       ref["popup_n_points"][i])):
                out.append(i)
        return out

    assert parted() == []
    monkeypatch.setattr(tcam, "backproject_to_world_plane",
                        _divided_backprojection)
    assert parted() == [7, 77]


def test_backprojection_rounds_as_the_reference_runner():
    """The reference's runners close over their intrinsics, so XLA
    compiles ``(u - cx) / fx`` as a product with the f32 reciprocal, and
    ``t + s * r`` as one fused multiply-add in x and y.  The port's rays
    and ground points equal the jitted reference bit for bit on frame 7's
    boundary; the plain f32 rounding (the quotient, the twice-rounded sum)
    does not."""
    masks, _, _, _, _ = corridor_inputs(1)
    ref = np.load("pop_up_slam_tpu_torch/data/corridor_ref.npz")
    Kj = JK.create(*corridor_K(1))
    Kt = TK.create(*corridor_K(1), device="cpu")
    v_b, _ = tpp.extract_boundary(torch.as_tensor(masks[7]))
    uv = torch.stack([torch.arange(640, dtype=torch.float32), v_b - 0.5], -1)
    R, t = ref["popup_R"][7], ref["popup_t"][7]
    ground = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    rays_j, (p_j, ok_j) = jax.jit(lambda uv, R, t: (
        jcam.pixel_rays(Kj, uv),
        jcam.backproject_to_world_plane(Kj, uv, R, t, jnp.asarray(ground))))(
            uv.numpy(), R, t)
    rays_t = tcam.pixel_rays(Kt, uv)
    p_t, ok_t = tcam.backproject_to_world_plane(
        Kt, uv, torch.as_tensor(R), torch.as_tensor(t),
        torch.as_tensor(ground))
    np.testing.assert_array_equal(rays_t.numpy(), np.asarray(rays_j))
    np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    # the plain f32 rounding: each step parts from the reference
    assert not torch.equal((uv[:, 0] - Kt.cx) / Kt.fx, rays_t[:, 0])
    r_w = (torch.as_tensor(R) @ rays_t[..., None])[..., 0]
    s = -(torch.as_tensor(t)[2]) / r_w[:, 2]
    twice = torch.as_tensor(t)[:2] + s[:, None] * r_w[:, :2]
    assert not torch.equal(twice, p_t[:, :2])
