"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)  Tolerances are
the CPU parity tests' own: K4 2e-4, K2 rtol 1e-4 / atol 1e-3, K1 5e-3 on
the window (1e-3 relative on the marginal), K5 rtol 1e-5 / atol 1e-5,
K3a rtol 1e-4 / atol 1e-4 on the steps (rtol 1e-5 / atol 1e-4 on S), K3b
with K4 rtol 1e-3 / atol 5e-3.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (REPO, assert_close, ba_problem, corridor_K,
                           corridor_inputs, cuda_device, indefinite,
                           random_problem,
                           random_system, spd_system)
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors.robust import RobustConfig, RobustKernel
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


@pytest.mark.parametrize("n", [48, 96, 224])
def test_chol_solve_kernel_matches_plain(cuda_device, n):
    S, b = (torch.as_tensor(x, device=cuda_device) for x in spd_system(n, n))
    before = cholesky.chol_solve.launches
    x_k = cholesky.chol_solve(S, b)
    assert cholesky.chol_solve.launches == before + 1
    x_p = cholesky.chol_solve_plain(S, b)
    torch.cuda.synchronize()
    assert_close(x_k, x_p, 2e-4, rtol=2e-4, what="x")


def test_chol_solve_kernel_skips_indefinite(cuda_device):
    S = torch.diag(torch.tensor([4.0, -1.0, 9.0], device=cuda_device))
    b = torch.tensor([8.0, 5.0, 27.0], device=cuda_device)
    x = cholesky.chol_solve(S, b).cpu().numpy()
    np.testing.assert_allclose(x, [2.0, 0.0, 3.0], atol=1e-5)


def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    S = torch.eye(225, device=cuda_device)
    with pytest.raises(ValueError):
        cholesky.chol_solve(S, torch.ones(225, device=cuda_device))
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
    masks, _, _, _, _ = corridor_inputs(step)
    ref = np.load(f"{REPO}/pop_up_slam_tpu_torch/data/corridor_ref.npz")
    K = Intrinsics.create(*corridor_K(step), device=cuda_device)
    m = torch.as_tensor(masks[frame], device=cuda_device)
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


@pytest.mark.parametrize("shape", [(8, 64, 72), (6, 10, 37)])
def test_plane_terms_kernel_matches_plain(cuda_device, shape):
    """The chip-smoke shapes (W, L, F), random problems with invalid
    factors (the reference kernel test's problem: on a 10 m corridor at
    1/0.02 whitening the distance residual cancels in f32 far above
    1e-5 in either version)."""
    W, L, F = shape
    w, pf = random_problem(3, W, L, F)
    pf["valid"][:3] = False
    window = convert.window_from_numpy(w, cuda_device)
    pf = graph.PlaneFactors(*(torch.as_tensor(pf[k], device=cuda_device)
                              for k in graph.PlaneFactors._fields))
    before = plane_jacobians.plane_terms.launches
    out_k = plane_jacobians.plane_terms(window, pf)
    assert plane_jacobians.plane_terms.launches == before + 1
    out_p = plane_jacobians.plane_terms_analytic(window, pf)
    torch.cuda.synchronize()
    for a, b, what in zip(out_k, out_p, ("r", "Jp", "Jl")):
        assert_close(a, b, 1e-5, rtol=1e-5, what=what)
        assert not a[~pf.valid].any(), what


@pytest.mark.parametrize("case", ["spd_W8", "indefinite_W8", "tiled_W23",
                                  "tiled_W24"])
def test_schur_reduce_kernels_match_plain(cuda_device, case):
    W, L, F = {"spd_W8": (8, 64, 72), "indefinite_W8": (8, 64, 72),
               "tiled_W23": (23, 9, 40), "tiled_W24": (24, 64, 216)}[case]
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
    tol = dict(rtol=1e-3, atol=5e-3) if tiled else dict(rtol=1e-4,
                                                        atol=1e-4)
    s_tol = tol if tiled else dict(rtol=1e-5, atol=1e-4)
    assert_close(sol_k.S, sol_p.S, what="S", **s_tol)
    assert_close(sol_k.dxp, sol_p.dxp, what="dxp", **tol)
    assert_close(sol_k.dxl, sol_p.dxl, what="dxl", **tol)
    if case.startswith("indefinite"):
        assert float(sol_k.dxp[2, 0]) == 0.0


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
