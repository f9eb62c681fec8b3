"""The exiting keyframe's marginal: K8 (``ops/marginal.py``,
``csrc/marginal.cu``) and its plain per-op version.

CPU cases (tier-1): ``pipeline/slam.py::_marginalize_oldest`` on CPU
tensors is the plain ``marginal_sqrt`` bit for bit, and no kernel is
built or launched there.

CUDA cases (marked ``cuda``, skipped without a card): K8 against the
plain version over 8 pre-roll states (the odometry factor 0->1 invalid,
the initial prior, a window not yet full among them); K8 within one
unit in the last place of the largest entry of K1's marginal
(``fused_gn_solve`` with the MARG block, window full) on the same state,
which holds the shared device code (``csrc/marginal.cuh``) together; one launch, no host sync, inputs untouched, two launches
bit-identical; a float64 state on the card takes the plain route.  The
file imports no JAX; on the GPU machine:

    python -m pytest --noconftest -q tests/test_torch_marginal.py
"""

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device
from pop_up_slam_tpu_torch.geometry import se3
from pop_up_slam_tpu_torch.ops import _build, fused_gn, marginal
from pop_up_slam_tpu_torch.pipeline import slam as tslam

_ = cuda_device  # fixture

CFG = tslam.SlamConfig()
SEEDS = range(8)


def marg_state(seed: int, device="cpu", dtype=torch.float32):
    """A pre-roll frame-step state as the marginal reads it, from the
    seed: a W=8 window down a corridor, the odometry between its slots
    and the slot-0 prior.  ``seed % 4``: 0 a full window and a prior left
    by an earlier marginal; 1 the same with the odometry factor 0->1
    invalid; 2 the initial prior (``init_prior_info``) on a moved slot 0;
    3 a window not yet full (slam_init's, with ``seed // 4 + 1``
    keyframes: slot 1 at the identity on the first)."""
    rng = np.random.default_rng(seed)
    W = CFG.window_size
    f64 = torch.float64

    def t_(x):
        return torch.as_tensor(np.asarray(x), dtype=f64)

    xi = t_(rng.normal(size=(W, 6)) * [0.05, 0.05, 0.05, 0.02, 0.02, 0.2])
    xi[:, 1] += 0.35 * torch.arange(W, dtype=f64)
    R, t = se3.se3_exp(xi)
    t = t + t_([0.0, 0.0, 1.4])
    kind = seed % 4
    n_kf = W if kind != 3 else seed // 4 + 1
    st = tslam.slam_init(CFG, R[0].float(), t[0].float(), device="cpu")
    live = torch.arange(W) < n_kf
    R = torch.where(live[:, None, None], R, torch.eye(3, dtype=f64))
    t = torch.where(live[:, None], t, torch.zeros(3, dtype=f64))
    oR, ot = se3.se3_between(R[:-1], t[:-1], R[1:], t[1:])
    oR, ot = se3.se3_retract(oR, ot, t_(rng.normal(size=(W - 1, 6)) * 0.01))
    ov = torch.arange(W - 1) < n_kf - 1
    if kind == 1:
        ov[0] = False
    if kind <= 1:
        pR, pt = se3.se3_retract(R[:1], t[:1],
                                 t_(rng.normal(size=(1, 6)) * 0.02))
        G = t_(rng.normal(size=(6, 6)))
        info = G @ G.T + t_(np.diag([3e3] * 3 + [2e4] * 3))
        psq = torch.linalg.cholesky(info).T
    else:
        pR, pt = R[:1], t[:1]
        if kind == 2:
            pR, pt = se3.se3_retract(pR, pt,
                                     t_(rng.normal(size=(1, 6)) * 0.01))
        psq = CFG.init_prior_info * torch.eye(6, dtype=f64)
    st = st._replace(
        window=st.window._replace(R=R, t=t, pose_valid=live),
        odom_R=oR, odom_t=ot, odom_valid=ov, mprior_R=pR[0], mprior_t=pt[0],
        mprior_sqrt=psq, n_kf=torch.tensor(n_kf, dtype=torch.int32))

    def cast(x):
        if isinstance(x, torch.Tensor):
            return x.to(device, dtype if x.is_floating_point() else x.dtype)
        if isinstance(x, tuple):
            return type(x)(*(cast(v) for v in x))
        return x

    return cast(st)


def plain(st):
    w = st.window
    return marginal.marginal_sqrt(
        w.R[0], w.t[0], w.R[1], w.t[1], st.odom_R[0], st.odom_t[0],
        st.odom_valid[0], st.mprior_R, st.mprior_t, st.mprior_sqrt,
        *tslam._marg_static(CFG))


def k8(st):
    w = st.window
    return marginal.exiting_marginal(
        w.R, w.t, st.odom_R, st.odom_t, st.odom_valid, st.mprior_R,
        st.mprior_t, st.mprior_sqrt, *tslam._marg_static(CFG))


# ---- CPU ----

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_marginalize_oldest_on_cpu_is_the_plain_marginal(seed, monkeypatch):
    """Off the card the frame step's marginal is the per-op chain bit for
    bit: no kernel library is loaded and K8's counter does not move."""
    def no_library():
        raise AssertionError("the kernel library was loaded on the CPU")

    monkeypatch.setattr(marginal, "library", no_library)
    monkeypatch.setattr(_build, "library", no_library)
    st = marg_state(seed)
    before = marginal.exiting_marginal.launches
    R1, t1, sqrt = tslam._marginalize_oldest(st, CFG)
    assert marginal.exiting_marginal.launches == before
    assert torch.equal(sqrt, plain(st))
    assert torch.equal(R1, st.window.R[1]) and torch.equal(t1, st.window.t[1])
    assert sqrt.dtype == torch.float32 and torch.isfinite(sqrt).all()


# ---- CUDA ----

# K8 against the plain version: entries within K8_TOL of the largest
# entry of the plain sqrt.  Both are f32 and sum in other orders; the
# plain version's own rounding, against itself in float64, reaches
# 1.6e-7 of that entry on these states (CPU): K8_TOL leaves six times
# two such roundings.
K8_TOL = 2e-6


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
def test_marginal_kernel_matches_plain(cuda_device, seed):
    st = marg_state(seed, cuda_device)
    before = marginal.exiting_marginal.launches
    _, _, got = tslam._marginalize_oldest(st, CFG)
    assert marginal.exiting_marginal.launches == before + 1
    want = plain(st)
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= K8_TOL * scale, (err, scale)
    assert torch.equal(got, torch.triu(got))


# K8 against K1's marginal: both run csrc/marginal.cuh, but nvcc contracts
# some multiply-adds of the SE(3) Jacobian (lie.cuh) otherwise in the two
# kernels, so the small coupling entries (i, i + 3) may differ in their
# last bits: over 120 full-window states (H100) 30 differ, by at most
# 2e-11 of the largest entry.  The test holds the two within one unit in
# the last place of the largest entry, far below what a fault in the
# shared code would move.
K8_K1_TOL = 2.0 ** -23


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 1, 2, 4, 5, 6, 96, 130])
def test_marginal_kernel_agrees_with_k1_marginal(cuda_device, seed):
    """On the same pre-roll state, window full, K8's sqrt is K1's m_sqrt
    to its last bits: both run csrc/marginal.cuh."""
    st = marg_state(seed, cuda_device)
    full = st.n_kf >= CFG.window_size
    assert bool(full)
    factors = tslam._build_factors(st, CFG)
    w = st.window
    marg = fused_gn.pack_marg(
        w.R[0], w.t[0], w.R[1], w.t[1], st.odom_R[0], st.odom_t[0],
        st.odom_valid[0], st.mprior_R, st.mprior_t, st.mprior_sqrt, full)
    _, _, m_k1 = fused_gn.fused_gn_solve(
        w, factors, iters=CFG.gn_iters, damping=CFG.damping,
        robust=CFG.robust, marg=marg, marg_static=tslam._marg_static(CFG))
    gap = float((k8(st) - m_k1).abs().max())
    assert gap <= K8_K1_TOL * float(m_k1.abs().max()), gap


@pytest.mark.cuda
def test_marginal_kernel_one_launch_no_sync(cuda_device):
    """One kernel on the device, no host sync, the inputs untouched, two
    launches bit-identical."""
    from torch.profiler import ProfilerActivity, profile

    st = marg_state(0, cuda_device)
    k8(st)                                   # build and load
    inputs = [x.clone() for x in (st.window.R, st.window.t, st.odom_R,
                                  st.odom_t, st.odom_valid, st.mprior_R,
                                  st.mprior_t, st.mprior_sqrt)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            a = k8(st)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events()
               if e.device_type.name == "CUDA"]
    assert len(kernels) == 1 and "marginal_kernel" in kernels[0], kernels
    b = k8(st)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    after = (st.window.R, st.window.t, st.odom_R, st.odom_t, st.odom_valid,
             st.mprior_R, st.mprior_t, st.mprior_sqrt)
    assert all(torch.equal(x, y) for x, y in zip(inputs, after))


@pytest.mark.cuda
def test_marginal_float64_on_the_card_takes_the_plain_route(cuda_device):
    st = marg_state(0, cuda_device, torch.float64)
    before = marginal.exiting_marginal.launches
    got = k8(st)
    assert marginal.exiting_marginal.launches == before
    assert got.dtype == torch.float64 and torch.equal(got, plain(st))
