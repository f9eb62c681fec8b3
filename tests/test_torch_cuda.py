"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one.  The
file imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest configures JAX.)  Tolerances are
the CPU parity tests' own: K4 2e-4, K2 rtol 1e-4 / atol 1e-3, K1 5e-3 on
the window (1e-3 relative on the marginal).
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import (REPO, assert_close, ba_problem, corridor_K,
                           corridor_inputs, cuda_device, spd_system)
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors.robust import RobustConfig, RobustKernel
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
from pop_up_slam_tpu_torch.ops import cholesky, depth_render, fused_gn
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
