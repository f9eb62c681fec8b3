"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)  Tolerances are
the CPU parity tests' own: K4 2e-4 (absolute and relative), K2 rtol 1e-4 / atol 1e-3, K1 5e-3 on
the window (1e-3 relative on the marginal), K5 rtol 1e-5 / atol 1e-5,
K3a rtol 1e-4 / atol 1e-4 on the steps (rtol 1e-5 / atol 1e-4 on S), K3b
with K4, and K3a at n = 126, rtol 1e-3 / atol 5e-3.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (REPO, assert_close, ba_problem, corridor_K,
                           corridor_inputs, cuda_device, ground_mask_ties,
                           indefinite, random_problem,
                           random_system, spd_system)
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors.robust import RobustConfig, RobustKernel
from pop_up_slam_tpu_torch.geometry import se3
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
from pop_up_slam_tpu_torch.factors import graph
from pop_up_slam_tpu_torch.ops import cholesky, depth_render, fused_gn
from pop_up_slam_tpu_torch.ops import plane_jacobians, schur
from pop_up_slam_tpu_torch.pipeline import slam as tslam
from pop_up_slam_tpu_torch.pipeline.offline import run_sequence_chunked
from pop_up_slam_tpu_torch.popup import popup as tpp

pytestmark = pytest.mark.cuda
_ = cuda_device  # fixture

ROBUST = RobustConfig(odom=RobustKernel("huber", 2.0),
                      plane=RobustKernel("cauchy", 3.0))
MARG_STATIC = ((1 / 0.03,) * 3 + (1 / 0.01,) * 3, 1e-6, 4.0)


# n: partial panels (1, 7, 225), the K1/K3a size (48), the lm24 size
# (144), the largest one-block system (224) and the device-memory route
# (225, 240, 384)
@pytest.mark.parametrize("n", [1, 7, 48, 144, 224, 225, 240, 384])
def test_chol_solve_kernel_matches_plain(cuda_device, n):
    S, b = (torch.as_tensor(x, device=cuda_device) for x in spd_system(n, n))
    before = cholesky.chol_solve.launches
    x_k = cholesky.chol_solve(S, b)
    assert cholesky.chol_solve.launches == before + 1
    x_p = cholesky.chol_solve_plain(S, b)
    torch.cuda.synchronize()
    assert_close(x_k, x_p, 2e-4, rtol=2e-4, what="x")


@pytest.mark.parametrize("n", [3, 240])
def test_chol_solve_kernel_skips_indefinite(cuda_device, n):
    """A negative pivot (one-block route at n=3, device-memory route at
    n=240) skips its direction: that entry exactly 0, the rest solved."""
    d = np.full(n, 2.0, np.float32)
    d[:3] = [4.0, -1.0, 9.0]
    rhs = np.ones(n, np.float32)
    rhs[:3] = [8.0, 5.0, 27.0]
    S = torch.diag(torch.as_tensor(d, device=cuda_device))
    b = torch.as_tensor(rhs, device=cuda_device)
    x = cholesky.chol_solve(S, b).cpu().numpy()
    assert x[1] == 0.0
    want = np.where(d > 0, rhs / d, 0.0)
    np.testing.assert_allclose(x, want, atol=1e-5)


@pytest.mark.parametrize("n", [144, 384])
def test_chol_solve_kernel_is_deterministic(cuda_device, n):
    """No atomics on either route: two launches agree bit for bit."""
    S, b = (torch.as_tensor(x, device=cuda_device) for x in spd_system(n, 3))
    assert torch.equal(cholesky.chol_solve(S, b), cholesky.chol_solve(S, b))


def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    S = torch.eye(225, device=cuda_device)
    with pytest.raises(ValueError):
        cholesky.chol_solve(S, torch.ones(224, device=cuda_device))
    with pytest.raises(ValueError):
        cholesky.chol_solve(S[:, :224].contiguous(),
                            torch.ones(225, device=cuda_device))
    with pytest.raises(ValueError):
        cholesky.chol_solve(S[:8, :8].double(),
                            torch.ones(8, device=cuda_device).double())
    d = cuda_device
    res = SimpleNamespace(
        planes_w=torch.zeros(2, 4, device=d),
        endpoints_w=torch.zeros(2, 2, 3, device=d),
        clipped=torch.zeros(2, 2, dtype=torch.bool, device=d),
        valid=torch.zeros(2, dtype=torch.bool, device=d),
        ground_c=torch.zeros(4, device=d))
    K = Intrinsics.create(1.0, 1.0, 0.0, 0.0, device=d)
    m = torch.ones(4, 4, dtype=torch.bool, device=d)
    with pytest.raises(ValueError):
        depth_render.depth_render(K, res, m, torch.eye(3, device=d).double(),
                                  torch.zeros(3, device=d))
    with pytest.raises(ValueError):
        depth_render.depth_render(K, res, m, torch.eye(3, device=d),
                                  torch.zeros(3))


@pytest.mark.parametrize("step,frame", [(1, 40), (1, 120), (4, 60)])
def test_depth_render_kernel_matches_plain(cuda_device, step, frame):
    _depth_render_case(cuda_device, step, frame, None)


def test_depth_render_kernel_ragged_crop(cuda_device):
    """479x161: pixel quads that cross rows and a 3-pixel scalar tail."""
    _depth_render_case(cuda_device, 1, 40, (479, 161))


def _depth_render_case(cuda_device, step, frame, crop):
    masks, _, _, _, _ = corridor_inputs(step)
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/corridor_ref.npz")
    K = Intrinsics.create(*corridor_K(step), device=cuda_device)
    mask = masks[frame] if crop is None else masks[frame][:crop[0], :crop[1]]
    m = torch.as_tensor(np.ascontiguousarray(mask), device=cuda_device)
    R = torch.as_tensor(ref["R"][frame], device=cuda_device)
    t = torch.as_tensor(ref["t"][frame], device=cuda_device)
    cfg = tpp.PopupConfig() if step == 1 else tpp.PopupConfig(
        smooth_radius=3, nms_radius=5, min_cols=6)
    res = tpp.pop_up(K, m, R, t, cfg)
    before = depth_render.depth_render.launches
    d_k = depth_render.depth_render(K, res, m, R, t)
    assert depth_render.depth_render.launches == before + 1
    d_p = tpp.depth_from_popup(K, res, m, R, t)
    torch.cuda.synchronize()
    assert_close(d_k, d_p, 1e-3, rtol=1e-4, what="depth")


def _problem(seed, dev):
    w, f = ba_problem(seed, prior_gauge=True)
    return (convert.window_from_numpy(w, dev),
            convert.factors_from_numpy(f, dev))


def _marg(w, f, full):
    pr = f.priors
    return fused_gn.pack_marg(
        w.R[0], w.t[0], w.R[1], w.t[1], f.odom.R_meas[0], f.odom.t_meas[0],
        f.odom.valid[0], pr.R[0], pr.t[0], pr.sqrt_info[0] * 0.5,
        torch.tensor(full, device=w.t.device))


@pytest.mark.parametrize("marg,full,robust", [
    (False, False, False), (False, False, True), (True, True, True),
    (True, False, False),
])
def test_fused_gn_kernel_matches_plain(cuda_device, marg, full, robust):
    w, f = _problem(5, cuda_device)
    kw = dict(iters=2, damping=1e-5,
              robust=ROBUST if robust else RobustConfig())
    if marg:
        kw.update(marg=_marg(w, f, full), marg_static=MARG_STATIC)
    before = fused_gn.fused_gn_solve.launches
    out_k = fused_gn.fused_gn_solve(w, f, **kw)
    assert fused_gn.fused_gn_solve.launches == before + 1
    out_p = fused_gn.fused_gn_plain(w, f, kw["iters"], kw["damping"],
                                    kw["robust"], kw.get("marg"),
                                    kw.get("marg_static"))
    torch.cuda.synchronize()
    assert_close(out_k[0], out_p[0], 5e-3, what="window")
    assert_close(out_k[1], out_p[1], 1e-2, rtol=5e-3, what="costs")
    if marg:
        assert_close(out_k[2], out_p[2], 1e-3 * float(out_p[2].abs().max()),
                     what="m_sqrt")


def test_fused_gn_kernel_skips_unobserved_landmarks(cuda_device):
    """Landmark 3 observed by no pose and landmark 4 by pose 2 alone: the
    S product skips the landmarks a pose pair does not share."""
    w, f = _problem(5, cuda_device)
    pf = f.planes
    valid = pf.valid.clone()
    valid[pf.lm_idx == 3] = False
    valid[(pf.lm_idx == 4) & (pf.pose_idx != 2)] = False
    valid[(pf.lm_idx == 4) & (pf.pose_idx == 2)] = True
    f = f._replace(planes=pf._replace(valid=valid))
    kw = dict(iters=2, damping=1e-5, robust=ROBUST,
              marg=_marg(w, f, True), marg_static=MARG_STATIC)
    out_k = fused_gn.fused_gn_solve(w, f, **kw)
    out_p = fused_gn.fused_gn_plain(w, f, 2, 1e-5, ROBUST, kw["marg"],
                                    MARG_STATIC)
    torch.cuda.synchronize()
    assert_close(out_k[0], out_p[0], 5e-3, what="window")
    assert_close(out_k[1], out_p[1], 1e-2, rtol=5e-3, what="costs")
    assert_close(out_k[2], out_p[2], 1e-3 * float(out_p[2].abs().max()),
                 what="m_sqrt")


@pytest.mark.parametrize("shape", [(8, 64, 72, 7, 1), (4, 16, 20, 3, 1),
                                   (12, 96, 108, 11, 1)])
def test_fused_gn_gate_matches_kernel_layout(cuda_device, shape):
    """The Python shape gate sizes the same shared-memory layout as the
    kernel's make_layout."""
    from pop_up_slam_tpu_torch.ops import _build

    lib = _build.library()
    assert lib.popup_fused_gn_smem_bytes(*shape) == fused_gn.smem_bytes(*shape)


def test_fused_gn_kernel_is_deterministic(cuda_device):
    """No atomics: two launches agree bit for bit."""
    w, f = _problem(6, cuda_device)
    a = fused_gn.fused_gn_solve(w, f, iters=2, damping=1e-5)
    b = fused_gn.fused_gn_solve(w, f, iters=2, damping=1e-5)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1])


def test_main_path_prefix_on_the_card(cuda_device):
    """16 production frames through the kernels: every frame launches
    K1 and K2 once, and the trajectory stays on the JAX reference."""
    masks, oR, ot, R0, t0 = corridor_inputs(1)
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/corridor_ref.npz")
    cfg = tslam.SlamConfig(max_det=9, kf_trans=0.0, kf_rot=0.0)
    st = tslam.slam_init(cfg, R0, t0, device=cuda_device)
    k1 = fused_gn.fused_gn_solve.launches
    k2 = depth_render.depth_render.launches
    st, (R, t, depth) = run_sequence_chunked(
        st, masks[:16], oR[:16], ot[:16],
        Intrinsics.create(*corridor_K(1), device=cuda_device),
        tpp.PopupConfig(), cfg, depth=True)
    assert fused_gn.fused_gn_solve.launches - k1 == 16
    assert depth_render.depth_render.launches - k2 == 16
    assert depth.shape == (16, 480, 640) and torch.isfinite(depth).all()
    assert_close(t, ref["t"][:16], 0.015, what="t")


def _window_factors(w, f, dev):
    return (convert.window_from_numpy(w, dev),
            convert.factors_from_numpy(f, dev))


@pytest.mark.parametrize("shape", [(8, 64, 72), (6, 10, 37), (8, 64, 300)])
def test_plane_terms_kernel_matches_plain(cuda_device, shape):
    """The chip-smoke shapes (W, L, F) and F = 300, random problems with
    invalid factors (the reference kernel test's problem), plus three
    extra rows that are valid but index outside the window (pose W, pose
    -1, landmark L): the kernel writes zeros there, which the plain
    version (that cannot index out of range) gets as invalid rows.
    So the kernel runs F + 3 factors: 40, 75 and 303, ragged last blocks of
    32.  Every row is held at 1e-5 against the plain version, except the
    residual rows of factors whose measured normal lies within 2.6
    degrees of an axis (1 - max |n_k| < 1e-3): the tangent basis (the
    reference's Householder reflector) divides by 1 - |n_k|, so there the
    f32 rounding of the normal exceeds 1e-5 in any order (the kernel, the
    plain version on either device and the f64 closed form part by up to
    8e-5).  Those rows are held against the closed form in f64 (the plain
    version on f64 tensors) at 1e-5 / (1 - max |n_k|), capped at 5e-3
    (about three times the largest parting measured, 1.6e-3 on the
    corridor state in chip_smoke.py), relative to 1 + |r|.  F = 300 has
    three such factors, F = 72 and 37 none."""
    W, L, F = shape
    tol = 1e-5
    w, pf = random_problem(3, W, L, F)
    pf["valid"][:3] = False
    pf = {k: np.concatenate([v, v[3:6]]) for k, v in pf.items()}
    pf["valid"][F:] = False
    pf_out = {k: v.copy() for k, v in pf.items()}
    pf_out["pose_idx"][F:F + 2] = W, -1
    pf_out["lm_idx"][F + 2] = L
    pf_out["valid"][F:] = True
    n_m = pf["pi_meas"][:, :3].astype(np.float64)
    n_m /= np.linalg.norm(n_m, axis=1, keepdims=True)
    gap = 1.0 - np.abs(n_m).max(1)
    near_axis = pf["valid"] & (gap < 1e-3)

    def factors(d, dtype=None):
        return graph.PlaneFactors(*(
            torch.as_tensor(d[k], device=cuda_device,
                            dtype=dtype if d[k].dtype == np.float32
                            else None)
            for k in graph.PlaneFactors._fields))
    window = convert.window_from_numpy(w, cuda_device)
    window64 = graph.Window(*(x.double() if x.is_floating_point() else x
                              for x in window))
    pf64 = factors(pf, torch.float64)
    pf, pf_out = factors(pf), factors(pf_out)
    before = plane_jacobians.plane_terms.launches
    out_k = plane_jacobians.plane_terms(window, pf_out)
    assert plane_jacobians.plane_terms.launches == before + 1
    out_p = plane_jacobians.plane_terms_analytic(window, pf)
    r64 = plane_jacobians.plane_terms_analytic(window64, pf64)[0]
    torch.cuda.synchronize()
    near = torch.as_tensor(near_axis, device=cuda_device)
    for a, b, what in zip(out_k, out_p, ("r", "Jp", "Jl")):
        assert a.is_contiguous() and a.shape == b.shape, what
        assert torch.isfinite(a).all(), what
        rows = ~near if what == "r" else slice(None)
        assert_close(a[rows], b[rows], tol, rtol=tol, what=what)
        assert not a[~pf.valid].any(), what
    tol_r = torch.as_tensor(np.minimum(tol / gap[near_axis], 5e-3),
                            device=cuda_device)
    err = (out_k[0][near].double() - r64[near]).abs()
    assert (err <= tol_r[:, None] * (1.0 + r64[near].abs())).all(), (
        err.max(), tol_r)
    assert int(near.sum()) == (3 if F == 300 else 0)


def _plane_state(dev):
    w, pf = random_problem(3, 8, 64, 72)
    pf["valid"][:3] = False
    return (convert.window_from_numpy(w, dev),
            graph.PlaneFactors(*(torch.as_tensor(pf[k], device=dev)
                                 for k in graph.PlaneFactors._fields)))


def test_plane_terms_kernel_is_deterministic(cuda_device):
    """Two K5 launches agree bit for bit."""
    window, pf = _plane_state(cuda_device)
    a = plane_jacobians.plane_terms(window, pf)
    b = plane_jacobians.plane_terms(window, pf)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_plane_terms_kernel_broadcast_sqrt_info(cuda_device):
    """One sqrt-info matrix broadcast over the factors (the SLAM step's
    layout, read as one matrix) gives the bits of its contiguous copy."""
    window, pf = _plane_state(cuda_device)
    A = pf.sqrt_info[0].expand(pf.valid.shape[0], 3, 3)
    a = plane_jacobians.plane_terms(window, pf._replace(sqrt_info=A))
    b = plane_jacobians.plane_terms(
        window, pf._replace(sqrt_info=A.contiguous()))
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_plane_terms_stamps(cuda_device):
    """K5's optional phase stamps: four non-decreasing device times, and
    the outputs are those of an unstamped launch."""
    window, pf = _plane_state(cuda_device)
    st = torch.zeros(plane_jacobians.N_STAMPS, dtype=torch.int64,
                     device=cuda_device)
    a = plane_jacobians.plane_terms(window, pf, stamps=st)
    b = plane_jacobians.plane_terms(window, pf)
    assert bool((st > 0).all()) and bool((st.diff() >= 0).all())
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# K3a at the paths' W=8, L=64, at the route's widest n = 126 (W=21, L=100,
# two 52-landmark chunks), past one 64-landmark chunk (L=80) and with
# 3L = 27 columns (no 16-byte staging); the last two landmarks of every
# random_system are observed by no pose
@pytest.mark.parametrize("case", ["spd_W8", "indefinite_W8", "spd_W21_L100",
                                  "spd_W8_L80", "spd_W5_L9", "tiled_W23",
                                  "tiled_W24", "tiled_W40"])
def test_schur_reduce_kernels_match_plain(cuda_device, case):
    W, L, F = {"spd_W8": (8, 64, 72), "indefinite_W8": (8, 64, 72),
               "spd_W21_L100": (21, 100, 200), "spd_W8_L80": (8, 80, 90),
               "spd_W5_L9": (5, 9, 40), "tiled_W23": (23, 9, 40),
               "tiled_W24": (24, 64, 216), "tiled_W40": (40, 64, 240)}[case]
    window, factors = _window_factors(*random_system(11, W, L, F),
                                      cuda_device)
    lin = graph.linearize(window, factors, analytic_planes=True)
    if case.startswith("indefinite"):
        lin = indefinite(lin)
    lam = torch.full((), 1e-3, device=cuda_device)
    counts = (schur.schur_reduce_small.launches, schur.schur_gemm.launches,
              cholesky.chol_solve.launches)
    sol_k = schur.schur_reduce(lin, window, lam)
    sol_p = schur.schur_reduce_plain(lin, window, lam)
    torch.cuda.synchronize()
    after = (schur.schur_reduce_small.launches, schur.schur_gemm.launches,
             cholesky.chol_solve.launches)
    tiled = case.startswith("tiled")
    assert after == tuple(c + d for c, d in zip(
        counts, (0, 1, 1) if tiled else (1, 0, 0)))
    # n = 126 is held as the tiled route's 138-240-dim factorizations
    wide = tiled or W > 20
    tol = dict(rtol=1e-3, atol=5e-3) if wide else dict(rtol=1e-4,
                                                       atol=1e-4)
    s_tol = tol if wide else dict(rtol=1e-5, atol=1e-4)
    assert_close(sol_k.S, sol_p.S, what="S", **s_tol)
    assert_close(sol_k.dxp, sol_p.dxp, what="dxp", **tol)
    assert_close(sol_k.dxl, sol_p.dxl, what="dxl", **tol)
    if case.startswith("indefinite"):
        assert float(sol_k.dxp[2, 0]) == 0.0


def test_make_solve_fn_auto_at_w40(cuda_device):
    """W=40 (n = 240) on the card: "auto" takes K3b + K4 and returns
    finite steps, with one K4 launch."""
    from pop_up_slam_tpu_torch.solver import schur as solver_schur

    window, factors = _window_factors(*random_system(13, 40, 64, 240),
                                      cuda_device)
    lin = graph.linearize(window, factors, analytic_planes=True)
    before = (cholesky.chol_solve.launches, schur.schur_gemm.launches)
    sol = solver_schur.make_solve_fn("auto")(lin, window, 1e-3)
    torch.cuda.synchronize()
    assert (cholesky.chol_solve.launches, schur.schur_gemm.launches) == (
        before[0] + 1, before[1] + 1)
    assert sol.dxp.shape == (40, 6) and sol.dxl.shape == (64, 3)
    assert torch.isfinite(sol.dxp).all() and torch.isfinite(sol.dxl).all()
    assert_close(sol, schur.schur_reduce_plain(lin, window, 1e-3), 5e-3,
                 rtol=1e-3, what="auto")


def _gemm_operands(dev, W, L, F, edit=None):
    window, factors = _window_factors(*random_system(11, W, L, F), dev)
    if edit is not None:
        factors = factors._replace(planes=edit(factors.planes))
    lin = graph.linearize(window, factors, analytic_planes=True)
    _, B, G, Hpp, _, _ = schur.reduce_operands(
        lin, window, torch.full((), 1e-3, device=dev))
    return Hpp, B, G


# K3b alone: an odd L (W=23, L=9: 3L = 27 columns, no 16-byte staging),
# lm24's W=24, L=64, W=40 (n = 240, a ragged last tile) and past one
# 64-landmark chunk (L=100)
@pytest.mark.parametrize("shape", [(23, 9, 40), (24, 64, 216),
                                   (40, 64, 240), (24, 100, 216)])
def test_schur_gemm_kernel_matches_plain(cuda_device, shape):
    Hpp, B, G = _gemm_operands(cuda_device, *shape)
    before = schur.schur_gemm.launches
    S = schur.schur_gemm(Hpp, B, G)
    assert schur.schur_gemm.launches == before + 1
    S2 = schur.schur_gemm(Hpp, B, G)
    torch.cuda.synchronize()
    assert torch.equal(S, S2), "two launches differ"
    assert torch.isfinite(S).all()
    assert_close(S, schur.schur_gemm_plain(Hpp, B, G), 5e-3, rtol=1e-3,
                 what="S")


def test_schur_gemm_kernel_skips_unobserved_landmarks(cuda_device):
    """W=24, L=64 with landmark 3 observed by no pose and landmark 4 by
    pose 2 alone: the product skips the landmarks a pose pair does not
    share."""
    def edit(pf):
        pose, lm, valid = pf.pose_idx.clone(), pf.lm_idx.clone(), \
            pf.valid.clone()
        pose[0], lm[0] = 2, 4
        valid[lm == 3] = False
        valid[(lm == 4) & (pose != 2)] = False
        valid[0] = True
        return pf._replace(pose_idx=pose, lm_idx=lm, valid=valid)
    Hpp, B, G = _gemm_operands(cuda_device, 24, 64, 216, edit)
    obs = G.reshape(24, 6, 64, 3).abs().sum(dim=(1, 3)) > 0   # (W, L)
    assert not obs[:, 3].any() and obs[:, 4].nonzero().flatten().tolist() \
        == [2]
    S = schur.schur_gemm(Hpp, B, G)
    torch.cuda.synchronize()
    assert_close(S, schur.schur_gemm_plain(Hpp, B, G), 5e-3, rtol=1e-3,
                 what="S")


def test_schur_gemm_kernel_nan_in_B_reaches_S(cuda_device):
    """A NaN in B counts as observed: it reaches every entry of its row
    whose column pose observes that landmark; the rest of S is unchanged
    (the terms a pose pair does not share are skipped, not multiplied by
    zero)."""
    Hpp, B, G = _gemm_operands(cuda_device, 24, 64, 216)
    obs = G.reshape(24, 6, 64, 3).abs().sum(dim=(1, 3)) > 0   # (W, L)
    lm = int(obs[5].nonzero()[0])
    i, k = 6 * 5 + 1, 3 * lm + 2
    Bn = B.clone()
    Bn[i, k] = float("nan")
    S0 = schur.schur_gemm(Hpp, B, G)
    S = schur.schur_gemm(Hpp, Bn, G)
    torch.cuda.synchronize()
    cols = obs[:, lm].repeat_interleave(6)
    rows = torch.arange(S.shape[0], device=cuda_device) != i
    assert torch.isnan(S[i, cols]).all()
    assert torch.isfinite(S[i, ~cols]).all()
    assert torch.equal(S[rows], S0[rows])


def test_schur_reduce_small_is_deterministic(cuda_device):
    """No atomics: two K3a launches agree bit for bit."""
    window, factors = _window_factors(*random_system(5, 8, 64, 72),
                                      cuda_device)
    lin = graph.linearize(window, factors, analytic_planes=True)
    lam = torch.full((), 1e-5, device=cuda_device)
    _, B, G, Hpp, pm, rp = schur.reduce_operands(lin, window, lam)
    a = schur.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    b = schur.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _k3a_vs_k3b_operands(case, dev):
    if case in ("dense", "ragged"):  # every term non-zero: none skipped
        # ragged: n = 100 (a partial pose, a ragged K3b tile), C = 50 (not
        # whole landmarks, no 16-byte staging)
        n, C = (48, 192) if case == "dense" else (100, 50)
        rng = np.random.default_rng(7)
        Hpp, B, G, rhs = (torch.as_tensor(
            rng.normal(size=sh).astype(np.float32), device=dev)
            for sh in ((n, n), (n, C), (n, C), (n,)))
        return Hpp, B, G, rhs, torch.ones(n, device=dev)
    W, L, F = (8, 64, 72) if case == "random_W8" else (21, 100, 200)
    window, factors = _window_factors(*random_system(11, W, L, F), dev)
    window = window._replace(pose_fixed=torch.zeros_like(window.pose_fixed))
    lin = graph.linearize(window, factors, analytic_planes=True)
    _, B, G, Hpp, pm, rp = schur.reduce_operands(
        lin, window, torch.zeros((), device=dev))
    return Hpp, B, G, -rp, pm


@pytest.mark.parametrize("case", ["random_W8", "random_W21", "dense",
                                  "ragged"])
def test_schur_small_S_equals_schur_gemm(cuda_device, case):
    """At lambda = 0 with every pose free K3a's S is K3b's bit for bit (-0
    taken as +0): both sum each entry over k in ascending order with fmaf
    from 0, and the terms K3a skips (landmarks a pose pair does not both
    observe) are exact zeros."""
    Hpp, B, G, rhs, pm = _k3a_vs_k3b_operands(case, cuda_device)
    assert bool((pm == 1).all())
    S_a, _ = schur.schur_reduce_small(Hpp, B, G, rhs, pm,
                                      torch.zeros((), device=cuda_device))
    S_b = schur.schur_gemm(Hpp, B, G)
    assert torch.equal(S_a + 0.0, S_b + 0.0)


def test_schur_small_stamps(cuda_device):
    """K3a's optional phase stamps: five non-decreasing device times, and
    the outputs are those of an unstamped launch."""
    window, factors = _window_factors(*random_system(5, 8, 64, 72),
                                      cuda_device)
    lin = graph.linearize(window, factors, analytic_planes=True)
    lam = torch.full((), 1e-5, device=cuda_device)
    _, B, G, Hpp, pm, rp = schur.reduce_operands(lin, window, lam)
    st = torch.zeros(schur.N_SMALL_STAMPS, dtype=torch.int64,
                     device=cuda_device)
    a = schur.schur_reduce_small(Hpp, B, G, -rp, pm, lam, stamps=st)
    b = schur.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    assert bool((st > 0).all()) and bool((st.diff() >= 0).all())
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("n", [175, 655, 1000])
def test_xla_cumsum_on_the_card(cuda_device, n):
    """The pop-up's box-sum scan gives the same bits on the card as on the
    CPU (where tests/test_torch_popup.py holds it to the reference's
    ``jnp.cumsum``), for the three signals as one (3, n) tensor."""
    x = (np.random.default_rng(n).normal(size=(3, n)) * 10).astype(
        np.float32)
    on_card = tpp._xla_cumsum(torch.as_tensor(x, device=cuda_device))
    assert torch.equal(on_card.cpu(), tpp._xla_cumsum(torch.as_tensor(x)))


def test_solver_prefix_on_the_card(cuda_device):
    """16 production frames with ``solver="lm"``: K3a and K5 twice per
    keyframe, no K1, and the trajectory on the JAX reference."""
    masks, oR, ot, R0, t0 = corridor_inputs(1)
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/"
                  "corridor_ref_solvers.npz")
    cfg = tslam.SlamConfig(max_det=9, kf_trans=0.0, kf_rot=0.0, solver="lm")
    st = tslam.slam_init(cfg, R0, t0, device=cuda_device)
    before = (schur.schur_reduce_small.launches,
              plane_jacobians.plane_terms.launches,
              fused_gn.fused_gn_solve.launches)
    st, (R, t) = run_sequence_chunked(
        st, masks[:16], oR[:16], ot[:16],
        Intrinsics.create(*corridor_K(1), device=cuda_device),
        tpp.PopupConfig(), cfg)
    after = (schur.schur_reduce_small.launches,
             plane_jacobians.plane_terms.launches,
             fused_gn.fused_gn_solve.launches)
    assert tuple(a - b for a, b in zip(after, before)) == (32, 32, 0)
    assert_close(t, ref["lm_t"][:16], 0.015, what="t")


# ---- the monocular slice on the card ----

def _divided_backprojection(K, uv, R_wc, t_wc, pi_w, eps=1e-6):
    """The back-projection rounded as plain f32 arithmetic does (the
    focal lengths divided, ``t + s * r`` rounded twice)."""
    x = (uv[..., 0] - K.cx) / K.fx
    y = (uv[..., 1] - K.cy) / K.fy
    r_w = (R_wc @ torch.stack([x, y, torch.ones_like(x)], -1)[..., None])[
        ..., 0]
    denom = torch.sum(pi_w[:3] * r_w, dim=-1)
    num = -(torch.sum(pi_w[:3] * t_wc, dim=-1) + pi_w[3])
    s = num / torch.where(denom.abs() < eps, torch.full_like(denom, eps),
                          denom)
    return t_wc + s[..., None] * r_w, (denom.abs() >= eps) & (s > eps)


def test_pop_up_at_the_reference_poses_on_the_card(cuda_device,
                                                   monkeypatch):
    """The pop-up on the card (its rays scaled by the reciprocal focal
    length and its ground points as one fused multiply-add in x and y, as
    XLA's CPU code for the reference's runners rounds them), from the pose
    the reference gave its own pop-up on each of the 144 main-path
    frames, finds the reference's valid walls and column counts; with the
    plain f32 rounding of the back-projection (the focal lengths divided,
    ``t + s * r`` rounded twice) it parts on some (frames 7 and 77 on the
    CPU and on the H100)."""
    from pop_up_slam_tpu_torch.geometry import camera as tcam

    masks, _, _, _, _ = corridor_inputs(1)
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/corridor_ref.npz")
    K = Intrinsics.create(*corridor_K(1), device=cuda_device)
    masks_d = torch.as_tensor(masks, device=cuda_device)

    def parted():
        out = []
        for i in range(masks.shape[0]):
            res = tpp.pop_up(
                K, masks_d[i],
                torch.as_tensor(ref["popup_R"][i], device=cuda_device),
                torch.as_tensor(ref["popup_t"][i], device=cuda_device))
            if not (np.array_equal(res.valid.cpu().numpy(),
                                   ref["popup_valid"][i])
                    and np.array_equal(res.n_points.cpu().numpy(),
                                       ref["popup_n_points"][i])):
                out.append(i)
        return out

    assert parted() == []
    monkeypatch.setattr(tcam, "backproject_to_world_plane",
                        _divided_backprojection)
    assert parted(), "the plain rounding should part on some frame"


def test_propagate_ties_on_the_card(cuda_device):
    """The filter's forward splat with exact z-buffer ties (a wall at
    3 m seen from 1 m further back) gives the CPU's bits on the card: the
    last source of each target wins on both (an ``amax`` scatter of the
    source index, not ``index_put_``, whose winner is unspecified)."""
    from pop_up_slam_tpu_torch.fusion import depth_fusion as fus

    H, W = 60, 80
    var = np.random.default_rng(0).uniform(1e-4, 1e-3, (H, W)).astype(
        np.float32)
    d = dict(inv_mu=np.full((H, W), 1.0 / 3.0, np.float32), var=var,
             valid=np.ones((H, W), bool))
    R = torch.eye(3)
    t = torch.tensor([0.0, 0.0, -1.0])
    out = [fus.propagate_to_frame(convert.depth_filter_from_numpy(d, dev),
                                  Intrinsics.create(40.0, 40.0, 40.0, 30.0,
                                                    device=dev),
                                  R.to(dev), t.to(dev))
           for dev in ("cpu", cuda_device)]
    assert int(out[0].valid.sum()) < 0.7 * H * W
    for a, b in zip(out[0], out[1]):
        assert torch.equal(a, b.cpu())


def test_vo_step_and_fusion_do_not_sync(cuda_device):
    """The plane-VO step and the four fusion functions read nothing back
    to the host (torch's sync debug mode raises on any synchronizing
    call), and the VO step agrees with the CPU: matches exact, R and t
    within 1e-5."""
    from pop_up_slam_tpu_torch.fusion import depth_fusion as fus
    from pop_up_slam_tpu_torch.geometry import plane
    from pop_up_slam_tpu_torch.odometry import plane_vo

    rng = np.random.default_rng(1)
    pa = plane.normalize(torch.as_tensor(
        rng.normal(size=(9, 4)).astype(np.float32)))
    xi = torch.as_tensor((0.05 * rng.normal(size=6)).astype(np.float32))
    R, t = se3.se3_exp(xi)
    R_ba, t_ba = se3.se3_inverse(R, t)
    pb = plane.transform_to_world(pa, R_ba, t_ba)
    valid = torch.ones(9, dtype=torch.bool)
    sup = torch.as_tensor(rng.uniform(10, 300, 9).astype(np.float32))
    args = (pa, valid, pb, valid, R, t)      # the motion as its own prior
    on_cpu = plane_vo.plane_vo_step(*args, support_prev=sup, support_cur=sup)
    dev_args = [a.to(cuda_device) for a in args]
    sup_d = sup.to(cuda_device)
    depth = torch.as_tensor(rng.uniform(1, 30, (48, 64)).astype(np.float32),
                            device=cuda_device)
    K = Intrinsics.create(40.0, 40.0, 32.0, 24.0, device=cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        on_card = plane_vo.plane_vo_step(*dev_args, support_prev=sup_d,
                                         support_cur=sup_d)
        flt = fus.init_from_popup(depth)
        flt = fus.propagate_to_frame(flt, K, on_card.R, on_card.t)
        flt = fus.fuse_observation(flt, 1.0 / depth, flt.var + 1e-4)
        scale = fus.align_scale(flt.inv_mu, depth)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(on_card.n_matches) == int(on_cpu.n_matches) >= 6
    assert bool(on_card.used_prior) == bool(on_cpu.used_prior)
    assert_close(on_card.R, on_cpu.R, 1e-5, what="R")
    assert_close(on_card.t, on_cpu.t, 1e-5, what="t")
    assert_close(on_card.R, R, 1e-4, what="R recovered")
    assert torch.isfinite(scale) and torch.isfinite(flt.inv_mu).all()


def test_jacfwd_linearize_on_the_card(cuda_device):
    """The per-factor jacfwd linearization runs on the card and matches
    the CPU's at 1e-5 of each output's largest entry."""
    w, f = random_system(4, 6, 12, 40)
    out = [graph.linearize(*_window_factors(w, f, dev), analytic_planes=False,
                           analytic_poses=False)
           for dev in ("cpu", cuda_device)]
    for name, a, b in zip(out[0]._fields, out[0], out[1]):
        assert b.is_cuda and torch.isfinite(b).all(), name
        assert_close(b, a, 1e-5 * max(1.0, float(a.abs().max())), what=name)


def _to_device(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return type(x)(*(_to_device(v, dev) for v in x))


@pytest.mark.parametrize("fused", [False, True])
def test_vo_runners_on_the_card(cuda_device, fused):
    """Eight 120x160 corridor frames through the monocular runners on the
    card: K1 once a keyframe (at kf_trans = kf_rot = 0 a frame whose VO
    motion is exactly zero is none: the first, which has no previous
    planes, and a static camera's), K2 once a frame on the fused runner
    only, no other kernel.  Then each frame again on the card from the CPU run's state
    before it: the pose within 1e-3 of the CPU's (a free monocular run
    amplifies rounding without bound, PERF.md; from equal states the two
    devices agree)."""
    from pop_up_slam_tpu_torch.pipeline import offline

    masks, _, _, R0, t0 = corridor_inputs(4)
    # "on": K1 on the card, its plain version (the same pivot-skip solve)
    # on the CPU
    cfg = tslam.SlamConfig(max_det=9, kf_trans=0.0, kf_rot=0.0, fused="on",
                           window_size=4, max_landmarks=16)
    pcfg = tpp.PopupConfig(smooth_radius=3, nms_radius=5, min_cols=6)
    runs, states = {}, {}
    for dev in ("cpu", cuda_device):
        K = Intrinsics.create(*corridor_K(4), device=dev)
        if fused:
            runs[dev] = offline.make_chunked_fused_vo_runner(K, pcfg, cfg)
        else:
            runs[dev] = offline.make_chunked_vo_runner(K, pcfg, cfg)
        st = tslam.slam_init(cfg, R0, t0, device=dev)
        states[dev] = (offline.fused_vo_init(st, cfg.max_det,
                                             *masks.shape[1:])
                       if fused else offline.vo_init(st, cfg.max_det))
    counters = (fused_gn.fused_gn_solve, depth_render.depth_render,
                schur.schur_reduce_small, plane_jacobians.plane_terms)
    before = [fn.launches for fn in counters]
    end, _ = offline.run_masks_chunked(runs[cuda_device], states[cuda_device],
                                       masks[:8], chunk=4)
    launches = [fn.launches - b for fn, b in zip(counters, before)]
    keyframes = int((end.vo.slam if fused else end.slam).n_kf) - 1
    assert 1 <= keyframes <= 7
    assert launches == [keyframes, 8 if fused else 0, 0, 0]
    st = states["cpu"]
    masks_g = torch.as_tensor(masks[:8], device=cuda_device)
    for i in range(8):
        st_g, out_g = runs[cuda_device](_to_device(st, cuda_device),
                                        masks_g[i:i + 1])
        st, out_c = runs["cpu"](st, torch.as_tensor(masks[i:i + 1]))
        (R_g, t_g), (R_c, t_c) = ((o[0] if fused else o)
                                  for o in (out_g, out_c))
        assert_close(t_g, t_c, 1e-3, what=f"t {i}")
        assert_close(R_g, R_c, 1e-3, what=f"R {i}")
        if fused:
            assert torch.isfinite(out_g[1]).all()


# ---- the TUM slice: K5 at the smoother's shape, the segmenter, the
# marginals ----

@pytest.mark.parametrize("shape", [(64, 64, 576), (1024, 64, 64)])
def test_plane_terms_kernel_at_the_smoothers_shape(cuda_device, shape):
    """K5 over a whole keyframe trajectory: W = 64 keyframes with 9
    factors each (F = 576, the smoother's layout: W = N rounded up to 8,
    F = 9 N), and W = 1024, whose 54 KB of staged window takes the
    dynamic shared memory opt-in above 48 KB.  The Jacobians at 1e-5
    against the plain version; every residual row, as ``chip_smoke.py``
    holds them at the smoother's shape, against the f64 closed form at
    1e-5 / (1 - max |n_k|), capped at 5e-3: the Householder tangent basis
    scales the f32 rounding of each row by that factor (above)."""
    W, L, F = shape
    tol = 1e-5
    w, pf = random_problem(5, W, L, F)
    pf["valid"][:5] = False
    n_m = pf["pi_meas"][:, :3].astype(np.float64)
    n_m /= np.linalg.norm(n_m, axis=1, keepdims=True)
    gap = 1.0 - np.abs(n_m).max(1)
    near = torch.as_tensor(pf["valid"], device=cuda_device)
    window = convert.window_from_numpy(w, cuda_device)
    factors = graph.PlaneFactors(*(torch.as_tensor(pf[k], device=cuda_device)
                                   for k in graph.PlaneFactors._fields))
    window64 = graph.Window(*(x.double() if x.is_floating_point() else x
                              for x in window))
    factors64 = factors._replace(pi_meas=factors.pi_meas.double(),
                                 sqrt_info=factors.sqrt_info.double())
    assert (plane_jacobians.smem_bytes(W, L) > 48 * 1024) == (W == 1024)
    before = plane_jacobians.plane_terms.launches
    out_k = plane_jacobians.plane_terms(window, factors)
    assert plane_jacobians.plane_terms.launches == before + 1
    out_p = plane_jacobians.plane_terms_analytic(window, factors)
    r64 = plane_jacobians.plane_terms_analytic(window64, factors64)[0]
    torch.cuda.synchronize()
    for a, b, what in zip(out_k, out_p, ("r", "Jp", "Jl")):
        assert torch.isfinite(a).all(), what
        rows = ~near if what == "r" else slice(None)
        assert_close(a[rows], b[rows], tol, rtol=tol, what=what)
        assert not a[~factors.valid].any(), what
    tol_r = torch.as_tensor(np.minimum(tol / gap, 5e-3),
                            device=cuda_device)[near]
    err = (out_k[0][near].double() - r64[near]).abs()
    assert (err <= tol_r[:, None] * (1.0 + r64[near].abs())).all()


def test_plane_terms_kernel_refuses_a_window_past_shared_memory(
        cuda_device):
    """A window too wide for one block's shared memory raises before any
    launch."""
    w, pf = random_problem(5, 5000, 64, 32)
    window = convert.window_from_numpy(w, cuda_device)
    factors = graph.PlaneFactors(*(torch.as_tensor(pf[k], device=cuda_device)
                                   for k in graph.PlaneFactors._fields))
    before = plane_jacobians.plane_terms.launches
    with pytest.raises(ValueError, match="shared memory"):
        plane_jacobians.plane_terms(window, factors)
    assert plane_jacobians.plane_terms.launches == before


def test_classical_ground_mask_on_the_card(cuda_device):
    """The segmenter on the card against the CPU on rendered 8-bit
    frames: exact but at ties (``ground_mask_ties``, band 0.02), where
    the two devices' f32 sums may decide differently."""
    from pop_up_slam_tpu_torch.io import synthetic
    from pop_up_slam_tpu_torch.models import classical_ground_mask

    cpu = torch.device("cpu")
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device=cpu)
    world = synthetic.corridor_world(device=cpu)
    R, t = synthetic.corridor_trajectory(12, sway=0.3, device=cpu)
    gen = torch.Generator().manual_seed(0)
    for i in (0, 5, 11):
        labels, _ = synthetic.render_frame(K, R[i], t[i], world, 480, 640)
        rgb8 = (synthetic.render_rgb(labels, generator=gen).numpy() * 255.0
                + 0.5).astype(np.uint8)
        out_c = classical_ground_mask(torch.as_tensor(rgb8))
        out_g = classical_ground_mask(torch.as_tensor(rgb8,
                                                      device=cuda_device))
        assert out_g.device.type == "cuda" and out_g.dtype == torch.bool
        tie = ground_mask_ties(rgb8, 0.02)
        np.testing.assert_array_equal(out_g.cpu().numpy()[~tie],
                                      out_c.numpy()[~tie])


def test_recover_marginals_on_the_card(cuda_device):
    """Marginals of a corridor BA problem on the card against the CPU,
    within 1e-3 of each output's largest entry (two f32 inverses of the
    reduced system); gauge-fixed and invalid blocks exactly zero."""
    from pop_up_slam_tpu_torch.solver import recover_marginals

    w, f = ba_problem(2, W=8, L=12)
    w["lm_valid"][-2:] = False
    f["planes"]["valid"] &= f["planes"]["lm_idx"] < 10
    win_c = convert.window_from_numpy(w, "cpu")
    lin_c = graph.linearize(win_c, convert.factors_from_numpy(f, "cpu"),
                            analytic_planes=True)
    win_g = convert.window_from_numpy(w, cuda_device)
    lin_g = graph.Linearization(*(x.to(cuda_device) for x in lin_c))
    out_c = recover_marginals(lin_c, win_c, 1e-6)
    out_g = recover_marginals(lin_g, win_g, 1e-6)
    for a, b in zip(out_g, out_c):
        assert torch.isfinite(a).all()
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=0.0,
                                   atol=1e-3 * float(b.abs().max()))
    assert not out_g.pose_cov[0].any()
    assert not out_g.plane_cov[-2:].any()


# ---------------------------------------------------------------------------
# the slice of the batched and pipelined runners and the learned segmenter
# ---------------------------------------------------------------------------

SEGNET_TOL, SEGNET_MARGIN = 1e-2, 0.1     # chip_smoke.py's


def test_segnet_on_card_matches_cpu(cuda_device):
    """The pretrained SegNetLite (bf16 cuDNN convolutions) against the
    same module on the CPU: logits within SEGNET_TOL (1 + |l|), masks
    equal off SEGNET_MARGIN."""
    from pop_up_slam_tpu_torch.models import load_pretrained_segnet

    rgb = torch.rand((2, 64, 96, 3), generator=torch.Generator()
                     .manual_seed(3))
    cpu_model, _, _ = load_pretrained_segnet(device="cpu")
    model, _, _ = load_pretrained_segnet(device=cuda_device)
    with torch.no_grad():
        want = cpu_model(rgb).numpy()
        got = model(rgb.to(cuda_device)).cpu().numpy()
    assert np.isfinite(got).all()
    assert (np.abs(got - want) <= SEGNET_TOL * (1 + np.abs(want))).all()
    differ = (got > 0) != (want > 0)
    assert (np.abs(want[differ]) < SEGNET_MARGIN).all()


def test_batched_pop_up_on_card_matches_cpu(cuda_device):
    """The vmapped pop-up of a chunk on the card: valid walls and column
    counts equal to the CPU's, planes within 1e-4."""
    from _torch_parity import port_corridor
    from pop_up_slam_tpu_torch.pipeline.batched import batched_pop_up

    Rs, ts, masks, _, _ = port_corridor(9, sway=0.2)
    pcfg = tpp.PopupConfig(min_cols=4, smooth_radius=2, nms_radius=3)
    outs = []
    for dev in ("cpu", cuda_device):
        K = Intrinsics.create(64.0, 64.0, 64.0, 48.0, device=dev)
        res, det = batched_pop_up(
            K, torch.as_tensor(masks, device=dev),
            torch.as_tensor(Rs, device=dev), torch.as_tensor(ts, device=dev),
            pcfg, pcfg.max_segments + 1)
        outs.append((res, det))
    (rc, dc), (rk, dk) = outs
    assert torch.equal(rk.valid.cpu(), rc.valid)
    assert torch.equal(rk.n_points.cpu(), rc.n_points)
    assert_close(dk.planes_c, dc.planes_c, 1e-4, what="planes_c")


def test_pipelined_on_card_bit_equal_to_sequential(cuda_device):
    """The front end on a side stream, ``stale_prediction=False``: poses
    equal bit for bit to the sequential frame loop, on three runs (a
    missing event or a freed cross-stream tensor shows as a run that
    differs); the stale schedule finite."""
    from _torch_parity import port_corridor
    from pop_up_slam_tpu_torch.pipeline import make_frame_fn, run_pipelined

    Rs, ts, masks, oR, ot = port_corridor(11, sway=0.2)
    masks, oR, ot = (torch.as_tensor(x, device=cuda_device)
                     for x in (masks, oR, ot))
    pcfg = tpp.PopupConfig(min_cols=6, smooth_radius=3, nms_radius=5)
    scfg = tslam.SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.05,
                            kf_rot=0.05)
    K = Intrinsics.create(64.0, 64.0, 64.0, 48.0, device=cuda_device)
    frame = make_frame_fn(K, pcfg, scfg)
    st = tslam.slam_init(scfg, Rs[0], ts[0], device=cuda_device)
    seq = []
    for i in range(10):
        st, (_, t) = frame(st, (masks[i + 1], oR[i], ot[i]))
        seq.append(t)
    seq = torch.stack(seq)
    for stale in (False, False, False, True):
        st = tslam.slam_init(scfg, Rs[0], ts[0], device=cuda_device)
        pipe = torch.stack([t for _, t in run_pipelined(
            st, ((masks[i + 1], oR[i], ot[i]) for i in range(10)), K, pcfg,
            scfg, stale_prediction=stale)])
        torch.cuda.synchronize()
        assert torch.isfinite(pipe).all()
        if not stale:
            assert torch.equal(pipe, seq)


# ---- the multi-device slice (ranks spawned by _torch_dist.run_ranks) ----

def _recorded_problem():
    """The reference's ``build_corridor_problem`` output recorded in
    ``corridor_ref_batched.npz``: (window, factors) numpy dicts."""
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/"
                  "corridor_ref_batched.npz")
    w = {k: ref[f"problem.window.{k}"][0] for k in graph.Window._fields}
    f = {g: {k: ref[f"problem.factors.{g}.{k}"][0] for k in cls._fields}
         for g, cls in (("odom", graph.OdomFactors),
                        ("planes", graph.PlaneFactors),
                        ("priors", graph.PosePriors))}
    return w, f


def test_nccl_world_of_one_sharded_linearize(cuda_device):
    """NCCL at a world of one: the sharded linearization (K5 on the whole
    factor set, launched once) equals the single-device one bit for
    bit."""
    from _torch_dist import run_ranks

    w, f = _recorded_problem()
    (out,) = run_ranks(1, [("lin", "linearize", dict(
        window=w, factors=f, analytic_planes=True))], backend="nccl",
        device="cuda")
    *lin, k5 = out["lin"]
    assert k5 == 1
    ref = graph.linearize(convert.window_from_numpy(w, cuda_device),
                          convert.factors_from_numpy(f, cuda_device),
                          analytic_planes=True)
    for a, b in zip(lin, ref):
        np.testing.assert_array_equal(a, b.cpu().numpy())


def test_gloo_two_ranks_distributed_gn_on_card(cuda_device):
    """Two gloo ranks on the one card: ``distributed_gn_solve`` with K5 on
    each rank's block (once a GN iteration on each rank), held against
    the single-device ``gn_solve`` on the card at tests/test_parallel.py's
    1e-3."""
    from _torch_dist import run_ranks

    from pop_up_slam_tpu_torch.solver import gn_solve

    w, f = _recorded_problem()
    res = run_ranks(2, [("gn", "gn", dict(window=w, factors=f, iters=3,
                                          damping=1e-6,
                                          analytic_planes=True))],
                    backend="gloo", device="cuda:0")
    ref, _ = gn_solve(convert.window_from_numpy(w, cuda_device),
                      convert.factors_from_numpy(f, cuda_device), iters=3,
                      damping=1e-6, analytic_planes=True)
    for out in res:
        assert out["gn"]["k5"] == 3
        for k in ("t", "planes"):
            assert_close(out["gn"][k], getattr(ref, k).cpu().numpy(), 1e-3,
                         what=k)


def test_segnet_train_step_on_card_matches_cpu(cuda_device):
    """One ``train_step`` from the same initial parameters and batch on
    the card and on the CPU (bf16 convolutions in both): the loss within
    5e-3 relative, every gradient within 5e-2 of its largest entry."""
    from pop_up_slam_tpu_torch.models import create_train_state, train_step

    gen = torch.Generator().manual_seed(0)
    rgb = torch.rand((8, 96, 128, 3), generator=gen)
    gt = torch.rand((8, 96, 128), generator=gen) > 0.5
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        model, params, tx = create_train_state(1, device=dev)
        loss = train_step(model, params, tx, rgb.to(dev), gt.to(dev))
        out[dev.type] = (float(loss), {k: p.grad.cpu().numpy()
                                       for k, p in params.items()})
    (l_gpu, g_gpu), (l_cpu, g_cpu) = out["cuda"], out["cpu"]
    assert abs(l_gpu - l_cpu) <= 5e-3 * abs(l_cpu), (l_gpu, l_cpu)
    for k, g in g_cpu.items():
        assert_close(g_gpu[k], g, 5e-2 * float(np.abs(g).max()), what=k)
