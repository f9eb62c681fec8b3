"""The LM solve's kernel route (K5, K6 assemble, K3a, K7 trial an
iteration; ``ops/lm_step.py``) against the per-op loop.

CPU cases (tier-1): which inputs take the route, ``lm_solve`` on CPU
tensors bit for bit the per-op loop, the route with each kernel's plain
version bit for bit the per-op loop with the Schur kernels' plain solve,
and the plain versions against the functions they compose.

CUDA cases (marked ``cuda``, skipped without a card), at the LM cell's
sizes (W=8, L=64, F=72, O=7, P=1) over 8 seeds and the robust kinds none,
huber and cauchy: K6's operands against ``reduce_operands(linearize())``,
K7 against its plain version, the route against the per-op loop (accept
decisions equal but at rounding ties, lambdas bit for bit up to the first
tie, windows inside the LM cell's lowest ``pose_gap`` / ``map_gap``
readings), launch counts, no host sync, inputs untouched.  The file
imports no JAX; on the GPU machine:

    python -m pytest --noconftest -q tests/test_torch_lm_fused.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _torch_parity import cuda_device
from pop_up_slam_tpu_torch.factors.graph import (Factors, OdomFactors,
                                                 PlaneFactors, PosePriors,
                                                 Window, linearize,
                                                 total_cost)
from pop_up_slam_tpu_torch.factors.robust import RobustConfig, RobustKernel
from pop_up_slam_tpu_torch.geometry import plane, se3
from pop_up_slam_tpu_torch.ops import lm_step, plane_jacobians, schur
from pop_up_slam_tpu_torch.solver import gauss_newton as gn
from pop_up_slam_tpu_torch.solver.schur import make_solve_fn

_ = cuda_device  # fixture

SEEDS = range(8)
ROBUST = {
    "none": RobustConfig(),
    "huber": RobustConfig(*(RobustKernel("huber", 2.0),) * 3),
    "cauchy": RobustConfig(*(RobustKernel("cauchy", 3.0),) * 3),
}
# the LM cell's lowest pose_gap / map_gap readings (PERF.md section 2)
POSE_GAP, MAP_GAP = 5.03e-4, 5.68e-4
# a decision the two sides take differently is a rounding tie: the step
# changes the cost by less than this share of max(cost, 1)
TIE = 1e-4


def lm_problem(seed: int, W: int = 8, L: int = 64, D: int = 9,
               full: bool = True):
    """A windowed LM problem shaped as the LM cell's frame step builds it:
    W keyframes down a corridor, D plane-factor slots each (~85 % valid)
    on ~24 live landmarks of L, odometry between neighbours, one prior on
    slot 0 (marginalization's gauge), the frame step's broadcast
    sqrt-info matrices; the estimate perturbed from the truth.  With
    ``full`` False the last two slots are empty.  CPU tensors."""
    rng = np.random.default_rng(seed)
    f32 = torch.float32

    def t_(x):
        return torch.as_tensor(np.asarray(x, np.float32))

    R0 = t_([[1, 0, 0], [0, 0, 1], [0, -1, 0]])
    xi = np.zeros((W, 6), np.float32)
    xi[:, 5] = 0.2 * np.sin(np.arange(W) * 0.9 + rng.uniform(0, 3))
    Rz, _ = se3.se3_exp(t_(xi))
    gt_R = Rz @ R0
    gt_t = t_(np.stack([0.3 * np.sin(np.arange(W) + rng.uniform(0, 3)),
                        0.35 * np.arange(W), np.full(W, 1.4)], -1))
    n_live = 24
    nrm = rng.normal(size=(n_live, 3))
    nrm[:, 2] *= 0.3
    gt_pl = plane.normalize(t_(np.concatenate(
        [nrm, rng.uniform(-4, 4, size=(n_live, 1))], -1)))
    planes_gt = torch.tensor([0.0, 0.0, 1.0, 0.0]).repeat(L, 1)
    slots = rng.choice(L, n_live, replace=False)
    planes_gt[slots] = gt_pl
    lm_valid = torch.zeros(L, dtype=torch.bool)
    lm_valid[slots] = True
    pose_valid = torch.ones(W, dtype=torch.bool)
    if not full:
        pose_valid[W - 2:] = False

    pose_idx = torch.arange(W, dtype=torch.int32).repeat_interleave(D)
    lm_idx = torch.as_tensor(np.stack(
        [rng.choice(slots, D, replace=False) for _ in range(W)]).reshape(-1)
        .astype(np.int32))
    pf_valid = torch.as_tensor(rng.random(W * D) < 0.85)
    pf_valid &= pose_valid[pose_idx.long()]
    R_cw, t_cw = se3.se3_inverse(gt_R[pose_idx.long()],
                                 gt_t[pose_idx.long()])
    pi_c = plane.transform(planes_gt[lm_idx.long()], R_cw, t_cw)
    pi_meas = plane.retract(pi_c, t_(0.01 * rng.normal(size=(W * D, 3))))
    plane_A = torch.diag(t_([1 / 0.015, 1 / 0.015, 1 / 0.02]))

    i = torch.arange(W - 1, dtype=torch.int32)
    j = i + 1
    Rm, tm = se3.se3_between(gt_R[:-1], gt_t[:-1], gt_R[1:], gt_t[1:])
    nR, nt = se3.se3_exp(t_(np.concatenate(
        [0.02 * rng.normal(size=(W - 1, 3)),
         0.005 * rng.normal(size=(W - 1, 3))], -1)))
    Rm, tm = se3.se3_compose(Rm, tm, nR, nt)
    odom_A = torch.diag(t_([1 / 0.03] * 3 + [1 / 0.01] * 3))

    dR, dt = se3.se3_exp(t_(np.concatenate(
        [0.05 * rng.normal(size=(W, 3)), 0.02 * rng.normal(size=(W, 3))],
        -1)))
    R, t = se3.se3_compose(gt_R, gt_t, dR, dt)
    planes = torch.where(lm_valid[:, None], plane.retract(
        planes_gt, t_(0.02 * rng.normal(size=(L, 3)))), planes_gt)
    window = Window(R=R, t=t, planes=planes, pose_valid=pose_valid,
                    pose_fixed=torch.zeros(W, dtype=torch.bool),
                    lm_valid=lm_valid)
    factors = Factors(
        odom=OdomFactors(i=i, j=j, R_meas=Rm, t_meas=tm,
                         sqrt_info=odom_A.expand(W - 1, 6, 6),
                         valid=pose_valid[1:].clone()),
        planes=PlaneFactors(pose_idx=pose_idx, lm_idx=lm_idx,
                            pi_meas=pi_meas,
                            sqrt_info=plane_A.expand(W * D, 3, 3),
                            valid=pf_valid),
        priors=PosePriors(idx=torch.zeros(1, dtype=torch.int32),
                          R=gt_R[:1].clone(), t=gt_t[:1].clone(),
                          sqrt_info=1000.0 * torch.eye(6, dtype=f32)[None],
                          valid=torch.ones(1, dtype=torch.bool)))
    return window, factors


def to(tree, dev):
    """A (nested) tuple of tensors on ``dev``, broadcast views kept."""
    if isinstance(tree, torch.Tensor):
        if tree.stride(0) == 0:
            return tree[:1].to(dev).expand(tree.shape)
        return tree.to(dev)
    parts = (to(x, dev) for x in tree)
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def per_op_lm(window, factors, iters, lam0, solve_fn, analytic_planes,
              robust):
    """The per-op LM loop as ``lm_solve`` runs it off the kernel route."""
    lam = torch.full((), lam0, dtype=torch.float32, device=window.t.device)
    cost = total_cost(window, factors, robust=robust)
    costs, norms, lambdas, accepted = [], [], [], []
    for _ in range(iters):
        lin = linearize(window, factors, analytic_planes=analytic_planes,
                        robust=robust)
        sol = solve_fn(lin, window, lam)
        w_try = gn.apply_update(window, sol.dxp, sol.dxl)
        cost_try = total_cost(w_try, factors, robust=robust)
        accept = cost_try < cost
        costs.append(cost)
        norms.append(torch.sqrt(torch.sum(sol.dxp ** 2)
                                + torch.sum(sol.dxl ** 2)))
        lambdas.append(lam)
        accepted.append(accept)
        window = gn.select_window(accept, w_try, window)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0),
                          1e-9, 1e6)
        cost = torch.where(accept, cost_try, cost)
    return window, gn.stack_stats(costs + [cost], norms, lambdas, accepted,
                                  window.t.device)


def assert_equal_tree(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


# ---------------------------------------------------------------- CPU


@pytest.mark.parametrize("case", ["cuda", "cpu", "w24", "pallas_off",
                                  "jacfwd", "f64"])
def test_kernel_route_choice(monkeypatch, case):
    """The route needs f32 CUDA tensors, analytic plane terms and the
    Schur kernels' solve at 6W <= 128, then the kernels' shape gate;
    decided on the host from shapes, dtypes and devices (a CUDA device
    stands in on the CPU, and the gate, which reads the kernel library,
    is recorded in its place)."""
    asked, fits = [], [True]

    def gate(*dims):
        asked.append(dims)
        return fits[0]

    monkeypatch.setattr(lm_step, "lm_step_supported", gate)
    W = 24 if case == "w24" else 8
    window, factors = lm_problem(0, W=W)
    dt = torch.float64 if case == "f64" else torch.float32
    dev = torch.device("cpu" if case == "cpu" else "cuda")
    window = window._replace(t=SimpleNamespace(device=dev, dtype=dt))
    solve_fn = make_solve_fn("off" if case == "pallas_off" else "auto")
    want = case == "cuda"
    assert gn._lm_kernel_route(window, factors, solve_fn,
                               case != "jacfwd") == want
    if case != "cuda":
        assert asked == []
        return
    assert asked == [(8, 64, 72, 7, 1)]
    assert gn._lm_kernel_route(window, factors, make_solve_fn("on"), True)
    fits[0] = False
    assert not gn._lm_kernel_route(window, factors, solve_fn, True)


@pytest.mark.parametrize("pallas,analytic", [("auto", True), ("on", True),
                                             ("off", True), ("on", False)])
def test_lm_solve_on_cpu_is_the_per_op_loop(monkeypatch, pallas, analytic):
    """On CPU tensors ``lm_solve`` never enters the kernel route and
    returns what the per-op loop returns, bit for bit."""
    def refuse(*a, **k):
        raise AssertionError("kernel route taken on CPU tensors")

    monkeypatch.setattr(gn, "lm_solve_kernels", refuse)
    window, factors = lm_problem(1)
    robust = ROBUST["huber"]
    got = gn.lm_solve(window, factors, iters=3, lam0=1e-5,
                      solve_fn=make_solve_fn(pallas),
                      analytic_planes=analytic, robust=robust)
    want = per_op_lm(window, factors, 3, 1e-5, make_solve_fn(pallas),
                     analytic, robust)
    assert_equal_tree(got[0], want[0])
    assert_equal_tree(got[1], want[1])


@pytest.mark.parametrize("kind", list(ROBUST))
@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_route_plain_matches_per_op_loop(seed, kind):
    """The route with the kernels' plain versions (CPU tensors) is the
    per-op loop with the Schur kernels' plain solve, bit for bit: the
    statistics' layout, the lambda and cost carried in the buffers, the
    selection."""
    window, factors = to(lm_problem(seed, full=seed == 0), "cpu")
    assert factors.planes.sqrt_info.stride(0) == 0
    robust = ROBUST[kind]
    got = gn.lm_solve_kernels(window, factors, iters=3, lam0=1e-5,
                              robust=robust)
    want = per_op_lm(window, factors, 3, 1e-5, make_solve_fn("on"), True,
                     robust)
    assert_equal_tree(got[0], want[0])
    assert_equal_tree(got[1], want[1])
    assert got[1].accepted.any()


def test_plain_versions_compose_the_per_op_functions():
    """K6's plain version is ``reduce_operands(linearize())`` with rhs =
    -rp; K7's is ``_reduce``'s back-substitution, ``apply_update`` and
    ``total_cost``; the dispatching wrappers take them on CPU tensors."""
    window, factors = lm_problem(2)
    robust = ROBUST["cauchy"]
    lam = torch.full((), 1e-3)
    ops = lm_step.lm_assemble(window, factors, None, lam, robust)
    lin = linearize(window, factors, analytic_planes=True, robust=robust)
    Hll_inv, B, G, Hpp, pm, rp = schur.reduce_operands(lin, window, lam)
    assert_equal_tree(ops, (Hpp, B, G, -rp, pm, Hll_inv, lin.bl))
    assert lm_step.pack(window, factors, robust) is None

    stats = lm_step.new_stats(1, "cpu")
    assert lm_step.lm_trial(window, factors, stats, 0, lam0=1e-3,
                            robust=robust) is None
    cost = total_cost(window, factors, robust=robust)
    assert torch.equal(stats.costs[0], cost)
    assert stats.lams[0] == torch.tensor(1e-3)

    S, x = schur.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    sol = schur.schur_reduce_plain(lin, window, lam)
    w = lm_step.lm_trial(window, factors, stats, 0, (x, ops), robust=robust)
    w_try = gn.apply_update(window, sol.dxp, sol.dxl)
    c_try = total_cost(w_try, factors, robust=robust)
    accept = c_try < cost
    assert bool(stats.accepted[0]) == bool(accept)
    assert torch.equal(stats.costs[1], torch.where(accept, c_try, cost))
    assert torch.equal(stats.norms[0], torch.sqrt(
        torch.sum(sol.dxp ** 2) + torch.sum(sol.dxl ** 2)))
    assert_equal_tree(w, gn.select_window(accept, w_try, window))


def test_shared_memory_gate(monkeypatch):
    """A window past the 64-bit observer masks, or with no landmark slot,
    is refused before the kernels' layout is read."""
    def no_library():
        raise AssertionError("the kernel library was read")

    monkeypatch.setattr(lm_step, "library", no_library)
    assert not lm_step.lm_step_supported(65, 64, 72, 64, 1)
    assert not lm_step.lm_step_supported(0, 64, 72, 0, 1)
    assert not lm_step.lm_step_supported(8, 0, 72, 7, 1)


# --------------------------------------------------------------- CUDA


def _route_and_per_op(dev, seed, kind, iters):
    window, factors = to(lm_problem(seed, full=seed % 4 != 3), dev)
    robust = ROBUST[kind]
    got = gn.lm_solve(window, factors, iters=iters, lam0=1e-5,
                      solve_fn=make_solve_fn("auto"), analytic_planes=True,
                      robust=robust)
    want = per_op_lm(window, factors, iters, 1e-5, make_solve_fn("auto"),
                     True, robust)
    return got, want


def _gap(a, b, rows=None):
    d = (a.double() - b.double()).abs()
    if rows is not None:
        d = d[rows]
    return float(d.max()) if d.numel() else 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ROBUST))
@pytest.mark.parametrize("seed", SEEDS)
def test_assemble_kernel_matches_per_op(cuda_device, seed, kind):
    window, factors = to(lm_problem(seed, full=seed % 4 != 3), cuda_device)
    robust = ROBUST[kind]
    lam = torch.full((), 1e-5, device=cuda_device)
    terms = plane_jacobians.plane_terms(window, factors.planes)
    before = lm_step.lm_assemble.launches
    ops = lm_step.lm_assemble(window, factors, terms, lam, robust)
    assert lm_step.lm_assemble.launches == before + 1
    lin = linearize(window, factors, analytic_planes=True, robust=robust)
    Hll_inv, B, G, Hpp, pm, rp = schur.reduce_operands(lin, window, lam)
    want = (Hpp, B, G, -rp, pm, Hll_inv, lin.bl)
    for name, x, y in zip(ops._fields, ops, want):
        assert x.shape == y.shape and x.is_contiguous(), name
        scale = float(y.abs().max().clamp(min=1.0))
        assert _gap(x, y) <= 1e-5 * scale, (name, _gap(x, y), scale)
    assert torch.equal(ops.pm, pm)
    again = lm_step.lm_assemble(window, factors, terms, lam, robust)
    assert_equal_tree(ops, again)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ROBUST))
@pytest.mark.parametrize("seed", SEEDS)
def test_trial_kernel_matches_per_op(cuda_device, seed, kind):
    """K7 against its plain version on the same operands and solution:
    the window and the trial cost to rounding, the decision and lambda
    exactly unless the cost change is a tie."""
    window, factors = to(lm_problem(seed, full=seed % 4 != 3), cuda_device)
    robust = ROBUST[kind]
    stats_k = lm_step.new_stats(1, cuda_device)
    before = lm_step.lm_trial.launches
    lm_step.lm_trial(window, factors, stats_k, 0, lam0=1e-5, robust=robust)
    cost = total_cost(window, factors, robust=robust)
    assert abs(float(stats_k.costs[0] - cost)) <= 1e-5 * float(cost)
    assert float(stats_k.lams[0]) == float(torch.tensor(1e-5))
    lam = stats_k.lams[0]
    terms = plane_jacobians.plane_terms(window, factors.planes)
    ops = lm_step.lm_assemble(window, factors, terms, lam, robust)
    _, x = schur.schur_reduce_small(ops.Hpp, ops.B, ops.G, ops.rhs, ops.pm,
                                    lam)
    stats_p = lm_step.LMStats(*(s.clone() for s in stats_k))
    w_k = lm_step.lm_trial(window, factors, stats_k, 0, (x, ops),
                           robust=robust)
    assert lm_step.lm_trial.launches == before + 2
    w_p = lm_step.lm_trial_plain(window, factors, stats_p, 0, (x, ops),
                                 robust=robust)
    assert w_k.pose_valid is window.pose_valid
    assert abs(float(stats_k.norms[0] - stats_p.norms[0])) <= 1e-5 * float(
        stats_p.norms[0]) + 1e-7
    margin = abs(float(stats_p.costs[0] - stats_p.costs[1])) / max(
        float(stats_p.costs[0]), 1.0)
    if bool(stats_k.accepted[0]) != bool(stats_p.accepted[0]):
        assert margin < TIE
        return
    assert torch.equal(stats_k.lams, stats_p.lams)
    assert abs(float(stats_k.costs[1] - stats_p.costs[1])) <= 1e-5 * float(
        stats_p.costs[1])
    assert _gap(w_k.R, w_p.R) <= 1e-5 and _gap(w_k.t, w_p.t) <= 1e-5
    assert _gap(w_k.planes, w_p.planes) <= 1e-5

    # a cost no step can lower: rejected, the window kept bit for bit,
    # lambda x 10, the cost carried
    stats_k.costs[0] = 0.5
    w_r = lm_step.lm_trial(window, factors, stats_k, 0, (x, ops),
                           robust=robust)
    assert not bool(stats_k.accepted[0])
    assert float(stats_k.costs[1]) == 0.5
    assert torch.equal(stats_k.lams[1], torch.clamp(lam * 10.0, 1e-9, 1e6))
    for a, b in zip(w_r, window):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ROBUST))
@pytest.mark.parametrize("seed", SEEDS)
def test_kernel_route_matches_per_op_loop(cuda_device, seed, kind):
    # the cell's 2 iterations; 5 on half the seeds, where steps shrink to
    # rounding and some are rejected
    iters = 2 if seed < 4 else 5
    (w, s), (w_ref, s_ref) = _route_and_per_op(cuda_device, seed, kind, iters)
    for x, y in zip(s, s_ref):
        assert x.shape == y.shape and x.dtype == y.dtype
    acc, acc_ref = s.accepted.cpu(), s_ref.accepted.cpu()
    for k in range(acc.shape[0]):
        assert torch.equal(s.lambdas[k].cpu(), s_ref.lambdas[k].cpu())
        if bool(acc[k]) != bool(acc_ref[k]):
            c = (s if bool(acc[k]) else s_ref).cost_history.double().cpu()
            assert abs(float((c[k] - c[k + 1]) / c[k].abs().clamp(
                min=1))) < TIE
            break
    pv, lv = w_ref.pose_valid, w_ref.lm_valid
    assert max(_gap(w.R, w_ref.R, pv), _gap(w.t, w_ref.t, pv)) <= POSE_GAP
    assert _gap(w.planes, w_ref.planes, lv) <= MAP_GAP
    assert torch.equal(w.pose_valid, w_ref.pose_valid)
    assert torch.equal(w.lm_valid, w_ref.lm_valid)


@pytest.mark.cuda
def test_kernel_route_launches(cuda_device):
    """At 2 iterations: K5 and K3a twice, K6 twice, K7 three times, at
    most 16 device launches in all, no host sync, inputs untouched, and
    two calls agree bit for bit."""
    window, factors = to(lm_problem(5), cuda_device)
    robust = ROBUST["huber"]
    kw = dict(iters=2, lam0=1e-5, solve_fn=make_solve_fn("auto"),
              analytic_planes=True, robust=robust)
    gn.lm_solve(window, factors, **kw)   # build, warm up
    inputs = [x.clone() for x in (*window, *(t for f in factors for t in f))]
    counters = (plane_jacobians.plane_terms, schur.schur_reduce_small,
                lm_step.lm_assemble, lm_step.lm_trial)
    before = [c.launches for c in counters]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            out = gn.lm_solve(window, factors, **kw)
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 2, 2, 3]
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    assert 0 < len(kernels) <= 16, [e.name for e in kernels]
    after = [x for x in (*window, *(t for f in factors for t in f))]
    for x, y in zip(inputs, after):
        assert torch.equal(x, y)
    again = gn.lm_solve(window, factors, **kw)
    assert_equal_tree(out[0], again[0])
    assert_equal_tree(out[1], again[1])


@pytest.mark.cuda
def test_shared_memory_gate_reads_the_kernels_layout(cuda_device):
    """The cell's sizes fit one block (K6 under the default 48 KB); a
    factor set past shared memory does not."""
    from pop_up_slam_tpu_torch.ops._build import library

    assert lm_step.lm_step_supported(8, 64, 72, 7, 1)
    assert library().popup_lm_smem_bytes(8, 64, 72, 7, 1, 0) < 48 * 1024
    assert not lm_step.lm_step_supported(8, 64, 8000, 7, 1)
