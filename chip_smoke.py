#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pop_up_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and builds the CUDA kernels from ``pop_up_slam_tpu_torch/ops/
   csrc`` (nvcc, sm_90a, one process per source), printing the build time
   and ptxas resource usage.
2. Holds every kernel against its plain PyTorch version on the card, on
   the same inputs, at the paths' shapes: K4 (Cholesky solve) at n=48
   and n=96 plus an indefinite system; K2 (depth render) on real 480x640
   pop-ups of corridor frames; K1 (fused GN) at W=8, L=64, F=72, O=7, P=1,
   2 iterations, with the marginal block, on a state captured mid-sequence
   with the window full; K5 (plane Jacobians) on that state's 72 factors
   and a random F=37 set with invalid factors; K3a (Schur reduction +
   solve) on that state's linearization and on a system with a
   gauge-fixed pose, invalid landmarks and an indefinite direction; K3b
   (tiled Schur GEMM, then K4) at W=23, L=9 and W=24, L=64.  One JSON line
   per case.
3. Drives the main path: ``run_sequence_chunked`` over all 144 frames of
   ``bench_data/corridor_inputs.npz`` at 480x640 with the production
   ``SlamConfig`` (every frame a keyframe, chunks of 16), rendering each
   frame's depth as the reference ``entry()`` does.  Kernel launch counters
   are zeroed just before and read just after; the trajectory is held
   against the committed JAX reference ``pop_up_slam_tpu_torch/data/
   corridor_ref.npz``.
4. Drives the solver paths the same way, each against its committed JAX
   run in ``corridor_ref_solvers.npz``: ``solver="lm"`` and
   ``solver="dogleg"`` over the 144 frames at the production widths (K3a
   and K5 twice per keyframe), and ``solver="lm"`` with ``window_size=24``
   over the first 48 frames (6W = 144: K3b, K4 and K5 twice per keyframe).
   Prints how many accept decisions differ from the reference's.
5. Prints the ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, f32 outside the
# tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

TRAJ_BOUND_M = 0.015      # the reference's own cross-path bound (15 mm)
K4_TOL = 2e-4             # as tests/test_ops.py chol_solve_pallas
K2_RTOL, K2_ATOL = 1e-4, 1e-3   # as tests/test_ops.py depth render
K1_TOL = 5e-3             # fused vs per-op GN (tests/test_fused_gn.py)
K5_TOL = 1e-5             # rtol = atol, as tests/test_ops.py plane terms
K3A_TOL = (1e-4, 1e-4)    # (rtol, atol) on the steps, tests/test_ops.py
K3A_S_TOL = (1e-5, 1e-4)  # (rtol, atol) on S
K3B_TOL = (1e-3, 5e-3)    # tiled route: a 138-144-dim f32 factorization


def _gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, n: int = 50, warm: int = 5) -> float:
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(n):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / n


def _to(x, dev):
    """Move a (nested) NamedTuple of tensors to ``dev``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple):
        return type(x)(*(_to(v, dev) for v in x))
    return x


def _bound(nbytes: float, ops: float):
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = ops / F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


# ---- operation counts for the bounds ----
# Arithmetic operations (add, subtract, multiply, divide, square root,
# transcendental: one each; compares, selects and sign flips: none) of the
# work these inputs need, counted from the kernels' sources.  Where a
# helper branches on the data (small-angle series), the cheaper branch is
# counted; a symmetric product counts its upper triangle once; only valid
# factors, free poses and landmarks that are observed do work.  So the
# counts never exceed what the inputs need.

def _chol_ops(n: int) -> float:
    """Cholesky of an n x n SPD matrix plus the two triangular solves."""
    return n ** 3 / 3 + n ** 2 / 2 + n / 6 + n + 2 * n * n


# lie.cuh helpers, composed as there
_DOT3, _MV3, _MM3, _HAT3_SQ, _EYE_PLUS = 5, 15, 45, 17, 36
_SINC, _COSC, _SERIES = 3, 6, 6          # sincc/cot_term/c2/c3: 6 each
_SO3_EXP = 6 + _HAT3_SQ + _SINC + _COSC + _EYE_PLUS
_SO3_LOG = 20 + 6 + 3 + 3                # quaternion, |v|, scale, phi
_V = 6 + _HAT3_SQ + _COSC + _SERIES + _EYE_PLUS
_V_INV = 6 + _HAT3_SQ + _SERIES + _EYE_PLUS
_Q = 6 + 3 * _SERIES + 7 * _MM3 + 9 * 13
_JR_INV = _V_INV + _Q + 2 * _MM3
_ADJOINT = _MM3
_SE3_LOG = _SO3_LOG + _V_INV + _MV3
_SE3_EXP = _SO3_EXP + _V + _MV3
_COMPOSE = _MM3 + _MV3 + 3
_BETWEEN = _MV3 + _COMPOSE
_INV3 = 27 + 5 + 9
_SPD_INV6 = 2 * _INV3 + 3 * _MM3 + 54 + 18
_TANGENT4 = 1 + 7 + 48
_NORMAL_COLS = 1 + 5 + 24
_PLANE_NORMALIZE = 12
_ROBUST = {"none": 0, "huber": 6, "cauchy": 9}   # rho + IRLS weight


def _mm(n: int, k: int, m: int) -> int:
    return 2 * n * k * m


def _sym(n: int, k: int) -> int:
    """A^T A with A (k x n): upper triangle only."""
    return n * (n + 1) // 2 * 2 * k


# one plane factor's terms (plane_factor.cuh plane_terms_one, K5's whole
# work per valid factor): prediction 51, measured plane 19, tangent
# columns, residual 11, Jp 30, S^3 basis, dnc 54, Jl 102, whitening (A r,
# A Jp, A Jl)
_PLANE_TERMS = (51 + 19 + _NORMAL_COLS + 11 + 30 + _TANGENT4 + 54 + 102
                + _MV3 + _mm(3, 3, 6) + _mm(3, 3, 3))
# K1's plane factor adds the IRLS weight (|r|^2, sqrt, scale 30)
_PLANE_FACTOR = _PLANE_TERMS + 5 + 1 + 30
# one odometry factor (pose_factor); a prior skips the measurement between
_ODOM_FACTOR = (2 * _BETWEEN + _SE3_LOG + _JR_INV + _mm(6, 6, 6) + _BETWEEN
                + _ADJOINT + _mm(6, 6, 6) + _mm(6, 6, 1) + 12 + 1 + 78)
_PRIOR_FACTOR = _ODOM_FACTOR - _BETWEEN
# the exiting keyframe's marginal (marginal()), once per launch: four
# betweens, two logs and J_r^-1, A J, the adjoint; A J Ad, A_p J_r,
# J0^T J1, H01^T H00^-1 (full); J0^T J0, Jq^T Jq, J1^T J1, T H01
# (symmetric); H00 sums, the 6x6 inverse, Hm, symmetrize + floor, the 6x6
# Cholesky, and the blend into the prior
_MARGINAL = (4 * _BETWEEN + 2 * _SE3_LOG + 2 * _JR_INV + 36 + _ADJOINT
             + 4 * _mm(6, 6, 6) + 4 * _sym(6, 6) + 27 + _SPD_INV6 + 21 + 48
             + (_chol_ops(6) - 2 * 36) + 192)


def k1_ops(window, factors, iters: int, robust) -> float:
    """Operations of one K1 launch on these inputs (see above)."""
    W = window.window_size
    free = (window.pose_valid & ~window.pose_fixed).cpu().numpy()
    lm_valid = window.lm_valid.cpu().numpy()
    pf, od, pr = factors.planes, factors.odom, factors.priors
    pv = pf.valid.cpu().numpy()
    pp, pl = pf.pose_idx.cpu().numpy(), pf.lm_idx.cpu().numpy()
    L = lm_valid.shape[0]
    pv = pv & (pp >= 0) & (pp < W) & (pl >= 0) & (pl < L)
    n_pf = int(pv.sum())
    n_od = int(od.valid.cpu().numpy().sum())
    n_pr = int(pr.valid.cpu().numpy().sum())
    # distinct free poses observing each landmark: the sparse Hpl blocks
    n_l = np.zeros(L, np.int64)
    for l in range(L):
        n_l[l] = len({int(p) for p in pp[pv & (pl == l)] if free[p]})
    n_lm = int((n_l > 0).sum())
    n = 6 * int(free.sum())

    lin = (n_pf * (_PLANE_FACTOR + _ROBUST[robust.plane.kind])
           + n_od * (_ODOM_FACTOR + _ROBUST[robust.odom.kind])
           + n_pr * (_PRIOR_FACTOR + _ROBUST[robust.prior.kind]))
    # normal equations: Hpp (diag + off-diag blocks), Hpl, Hll, gradients
    normal = (n_od * (2 * _sym(6, 6) + _mm(6, 6, 6) + 2 * _mm(6, 6, 1))
              + n_pr * (_sym(6, 6) + _mm(6, 6, 1))
              + n_pf * (_sym(6, 3) + _mm(6, 3, 3) + _sym(3, 3)
                        + _mm(6, 3, 1) + _mm(3, 3, 1))
              + n_lm * (3 + _INV3) + n_pf + n_od + n_pr + 1)
    # Schur: per landmark B_l = Hpl_l Hll^-1, S -= B_l Hpl_l^T, rhs
    m = 6 * n_l
    schur = float((_mm(1, 3, 3) * m + m * (m + 1) // 2 * 6
                   + _mm(1, 3, 1) * m).sum()) + 2 * n
    back = float((12 * 3 * n_l + 3 + 15)[n_l > 0].sum())
    step = 2 * (n + 3 * n_lm)
    retract = (n // 6) * (_SE3_EXP + _COMPOSE) + int(lm_valid.sum()) * (
        _TANGENT4 + 24 + _PLANE_NORMALIZE)
    per_it = lin + normal + schur + _chol_ops(n) + back + step + retract
    return iters * per_it + _MARGINAL


def k2_ops(H: int, W: int, n_walls: int) -> float:
    """Operations of one K2 launch: per pixel the ray, its rotation and
    the ground hit (21); per valid wall the hit, its extent and height
    tests (19); per wall once the staged terms (14)."""
    return H * W * (21 + 19 * n_walls) + 14 * n_walls


def k5_work(window, pf):
    """(bytes, operations) of one K5 launch: the window and each factor's
    inputs read once, r/Jp/Jl written once; operations per valid factor
    with both indices in range (``_PLANE_TERMS``)."""
    W, L = window.window_size, window.max_landmarks
    F = pf.valid.shape[0]
    p, l = pf.pose_idx.cpu().numpy(), pf.lm_idx.cpu().numpy()
    ok = pf.valid.cpu().numpy() & (p >= 0) & (p < W) & (l >= 0) & (l < L)
    nbytes = 4 * (12 * W + 4 * L) + F * (4 + 4 + 16 + 36 + 1) + F * 4 * 30
    return nbytes, int(ok.sum()) * _PLANE_TERMS


def schur_product_ops(lin, window):
    """(operations, free-pose rows) of S = Hpp - B G^T that these inputs
    need: per landmark, the product of its B and G rows over the free
    poses observing it (symmetric: upper triangle, depth 3), plus one
    subtraction per upper-triangle entry of the blocks those products
    touch."""
    obs = (lin.Hpl.abs().sum(dim=(-1, -2)) > 0).cpu().numpy()     # (W, L)
    free = (window.pose_valid & ~window.pose_fixed).cpu().numpy()
    obs = obs & free[:, None]
    m = 6 * obs.sum(0)
    prod = float((m * (m + 1) // 2 * 2 * 3).sum())
    touched = (obs.astype(np.int64) @ obs.T.astype(np.int64)) > 0
    sub = (21 * int(np.diag(touched).sum())
           + 36 * int(np.triu(touched, 1).sum()))
    return prod + sub, 6 * int(free.sum())


def random_system(torch, W, L, F, seed, dev):
    """A random window and factors drawn with numpy (the reference's own
    kernel-test problem, ``tests/test_ops.py::_random_spd_system``):
    random poses and planes, F plane factors on random (pose, landmark)
    pairs with noisy measurements and sqrt-info diag(20, 20, 10), ~15% of
    them and the last two landmarks invalid, pose 0 fixed, an odometry
    chain with random measurements and a prior on pose 0."""
    from pop_up_slam_tpu_torch.factors import graph
    from pop_up_slam_tpu_torch.geometry import plane, se3

    rng = np.random.default_rng(seed)
    f32, i32 = torch.float32, torch.int32

    def t_(x, dtype=f32):
        return torch.as_tensor(np.asarray(x), dtype=dtype)

    R = se3.so3_exp(t_(0.3 * rng.normal(size=(W, 3))))
    t = t_(rng.normal(size=(W, 3)))
    planes = plane.normalize(t_(rng.normal(size=(L, 4))))
    p = rng.integers(0, W, size=F)
    lm = rng.integers(0, L - 2, size=F)
    R_cw, t_cw = se3.se3_inverse(R[p], t[p])
    pi_c = plane.transform(planes[lm], R_cw, t_cw)
    pi_meas = plane.retract(pi_c, t_(0.05 * rng.normal(size=(F, 3))))
    window = graph.Window(R, t, planes, torch.ones(W, dtype=torch.bool),
                          t_(np.arange(W) == 0, torch.bool),
                          t_(np.arange(L) < L - 2, torch.bool))
    pf = graph.PlaneFactors(
        t_(p, i32), t_(lm, i32), pi_meas,
        torch.diag(t_([20.0, 20.0, 10.0])).expand(F, 3, 3).contiguous(),
        t_(rng.random(F) < 0.85, torch.bool))
    odom = graph.OdomFactors(
        torch.arange(W - 1, dtype=i32), torch.arange(1, W, dtype=i32),
        se3.so3_exp(t_(0.1 * rng.normal(size=(W - 1, 3)))),
        t_(rng.normal(size=(W - 1, 3))),
        torch.eye(6).expand(W - 1, 6, 6).contiguous(),
        torch.ones(W - 1, dtype=torch.bool))
    priors = graph.PosePriors(torch.zeros(1, dtype=i32), R[:1], t[:1],
                              torch.eye(6)[None], torch.ones(1,
                                                             dtype=torch.bool))
    return (_to(window, dev),
            _to(graph.Factors(odom=odom, planes=pf, priors=priors), dev))


def _err(a, b, rtol, atol):
    """(max abs difference, entries outside atol + rtol |b|)."""
    d = (a - b).abs()
    return float(d.max()), int((d > atol + rtol * b.abs()).sum())


def check_k5(torch, pj, window, pf, torch_dev):
    """K5 vs plane_terms_analytic on the state's 72 factors and on a
    random F=37 set with invalid factors."""
    rw, rf = random_system(torch, 6, 10, 37, 3, torch_dev)
    rpf = rf.planes._replace(valid=rf.planes.valid.clone())
    rpf.valid[:3] = False
    worst, timing = 0.0, None
    for name, w, f in (("state_F72", window, pf), ("random_F37", rw, rpf)):
        out_k = pj.plane_terms(w, f)
        out_p = pj.plane_terms_analytic(w, f)
        torch.cuda.synchronize()
        err, bad = 0.0, 0
        for a, b in zip(out_k, out_p):
            assert torch.isfinite(a).all(), name
            e, n_bad = _err(a, b, K5_TOL, K5_TOL)
            err, bad = max(err, e), bad + n_bad
        zero_ok = all(not a[~f.valid].any() for a in out_k)
        print(json.dumps({"check": "K5", "case": name,
                          "F": int(f.valid.shape[0]), "max_abs_err": err,
                          "entries_out_of_tol": bad, "rtol": K5_TOL,
                          "atol": K5_TOL, "invalid_rows_zero": zero_ok,
                          "pass": bad == 0 and zero_ok}))
        assert bad == 0 and zero_ok, f"K5 {name}"
        worst = max(worst, err)
        if timing is None:
            timing = dict(
                ms=_time_ms(lambda: pj.plane_terms(w, f)),
                plain_ms=_time_ms(lambda: pj.plane_terms_analytic(w, f),
                                  n=20),
                library_ms=None, work=k5_work(w, f))
    return worst, timing


def _indefinite(lin, p=2):
    """Decouple direction 0 of free pose ``p`` and give it negative
    curvature: its reduced pivot is indefinite and must be skipped."""
    Hpp, Hpl = lin.Hpp.clone(), lin.Hpl.clone()
    Hpp[p, :, 0, :] = 0.0
    Hpp[:, p, :, 0] = 0.0
    Hpp[p, p, 0, 0] = -1.0
    Hpl[p, :, 0, :] = 0.0
    return lin._replace(Hpp=Hpp, Hpl=Hpl)


def _compare_schur(torch, tag, name, sol_k, sol_p, tol, s_tol):
    torch.cuda.synchronize()
    for x in sol_k:
        assert torch.isfinite(x).all(), (tag, name)
    e_p, b_p = _err(sol_k.dxp, sol_p.dxp, *tol)
    e_l, b_l = _err(sol_k.dxl, sol_p.dxl, *tol)
    e_s, b_s = _err(sol_k.S, sol_p.S, *s_tol)
    ok = b_p == 0 and b_l == 0 and b_s == 0
    print(json.dumps({"check": tag, "case": name, "max_abs_err": max(e_p,
                                                                     e_l),
                      "S_max_abs_err": e_s, "rtol": tol[0], "atol": tol[1],
                      "S_rtol": s_tol[0], "S_atol": s_tol[1],
                      "entries_out_of_tol": b_p + b_l + b_s, "pass": ok}))
    assert ok, f"{tag} {name}"
    return max(e_p, e_l)


def check_k3a(torch, ks, graph, solver_schur, window, factors, robust):
    """K3a (through schur_reduce) vs schur_reduce_plain on the state's
    linearization with LM's first lambda, and on a system with a
    gauge-fixed pose, invalid landmarks and an indefinite direction."""
    dev = window.t.device
    lin = graph.linearize(window, factors, analytic_planes=True,
                          robust=robust)
    lam = torch.full((), 1e-5, device=dev)
    gauge = window._replace(pose_fixed=window.pose_fixed.clone())
    gauge.pose_fixed[0] = True
    assert not bool(gauge.lm_valid.all())
    worst = 0.0
    for name, lin_c, w in (("state_W8_L64", lin, window),
                           ("gauge_invalid_indefinite", _indefinite(lin),
                            gauge)):
        sol_k = ks.schur_reduce(lin_c, w, lam)
        sol_p = ks.schur_reduce_plain(lin_c, w, lam)
        worst = max(worst, _compare_schur(torch, "K3a", name, sol_k, sol_p,
                                          K3A_TOL, K3A_S_TOL))
        if name.startswith("gauge"):
            assert float(sol_k.dxp[2, 0]) == 0.0 == float(sol_p.dxp[2, 0])
            assert not bool(sol_k.dxp[0].any())
    ops_ = ks.reduce_operands(lin, window, lam)
    _, B, G, Hpp, pm, rp = ops_
    a = ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    b = ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    print(json.dumps({"check": "K3a", "case": "two launches bit-identical",
                      "pass": same}))
    assert same
    n, C = B.shape
    prod, n_free = schur_product_ops(lin, window)
    timing = dict(
        ms=_time_ms(lambda: ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam)),
        plain_ms=_time_ms(lambda: ks.schur_reduce_small_plain(
            Hpp, B, G, -rp, pm, lam), n=10, warm=2),
        library_ms=None,
        per_op_ms=_time_ms(lambda: solver_schur.solve_schur(lin, window,
                                                            lam)),
        reduce_ms=_time_ms(lambda: ks.schur_reduce(lin, window, lam)),
        work=(4 * (n * n + 2 * n * C + 2 * n + 1) + 4 * (n * n + n),
              prod + n_free + _chol_ops(n_free)),
    )
    return worst, timing


def check_k3b(torch, ks, cholesky, graph, dev):
    """K3b (+ damping, mask and K4) vs the plain tiled route at W=23, L=9
    and W=24, L=64; the GEMM alone against its plain version."""
    worst, timing = 0.0, None
    for W, L, F in ((23, 9, 40), (24, 64, 216)):
        window, factors = random_system(torch, W, L, F, 11, dev)
        lin = graph.linearize(window, factors, analytic_planes=True)
        name = f"W{W}_L{L}"
        sol_k = ks.schur_reduce(lin, window, 1e-3)
        sol_p = ks.schur_reduce_plain(lin, window, 1e-3)
        worst = max(worst, _compare_schur(torch, "K3b+K4", name, sol_k,
                                          sol_p, K3B_TOL, K3B_TOL))
        lam = torch.full((), 1e-3, device=dev)
        _, B, G, Hpp, pm, rp = ks.reduce_operands(lin, window, lam)
        S_k, S_p = ks.schur_gemm(Hpp, B, G), ks.schur_gemm_plain(Hpp, B, G)
        torch.cuda.synchronize()
        e, bad = _err(S_k, S_p, *K3B_TOL)
        print(json.dumps({"check": "K3b", "case": name, "max_abs_err": e,
                          "rtol": K3B_TOL[0], "atol": K3B_TOL[1],
                          "entries_out_of_tol": bad, "pass": bad == 0}))
        assert bad == 0, f"K3b {name}"
        worst = max(worst, e)
        if W == 24:
            n, C = B.shape
            S = ks.damp_mask(S_k, lam, pm)
            rhs = -(rp * pm)
            timing = dict(
                ms=_time_ms(lambda: ks.schur_gemm(Hpp, B, G)),
                plain_ms=_time_ms(lambda: ks.schur_gemm_plain(Hpp, B, G)),
                library_ms=_time_ms(lambda: torch.addmm(Hpp, B, G.T,
                                                        alpha=-1)),
                k4_n144_ms=_time_ms(lambda: cholesky.chol_solve(S, rhs)),
                work=(4 * (n * n + 2 * n * C) + 4 * n * n,
                      schur_product_ops(lin, window)[0]),
            )
    return worst, timing


def _load_inputs():
    z = np.load(os.path.join(REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    return masks, z["odom_R"], z["odom_t"], z["R0"], z["t0"]


def check_k4(torch, cholesky):
    """K4 vs its plain version at n=48, 96 and an indefinite system."""
    rng = np.random.default_rng(0)
    cases = []
    for n in (48, 96):
        A = rng.normal(size=(n, n)).astype(np.float32)
        S = A @ A.T + n * np.eye(n, dtype=np.float32)
        b = rng.normal(size=(n,)).astype(np.float32)
        cases.append((f"spd_n{n}", S, b))
    S = np.diag(np.array([4.0, -1.0, 9.0] + [2.0] * 45, np.float32))
    b = np.array([8.0, 5.0, 27.0] + [1.0] * 45, np.float32)
    cases.append(("indefinite_n48", S, b))

    worst, timing = 0.0, None
    for name, S_np, b_np in cases:
        S = torch.as_tensor(S_np, device="cuda")
        b = torch.as_tensor(b_np, device="cuda")
        x = cholesky.chol_solve(S, b)
        x_plain = cholesky.chol_solve_plain(S, b)
        torch.cuda.synchronize()
        assert torch.isfinite(x).all(), name
        err = float((x - x_plain).abs().max())
        scale = float(x_plain.abs().max())
        ok = err <= K4_TOL * max(1.0, scale)
        if name.startswith("indefinite"):
            ok = ok and float(x[1]) == 0.0 and abs(float(x[0]) - 2.0) < 1e-5
        print(json.dumps({"check": "K4", "case": name, "max_abs_err": err,
                          "tol": K4_TOL * max(1.0, scale), "pass": ok}))
        assert ok, f"K4 {name}: err {err}"
        worst = max(worst, err)
        if name == "spd_n48":
            n = S.shape[0]
            timing = dict(
                ms=_time_ms(lambda: cholesky.chol_solve(S, b)),
                plain_ms=_time_ms(lambda: cholesky.chol_solve_plain(S, b),
                                  n=10, warm=2),
                library_ms=_time_ms(lambda: torch.cholesky_solve(
                    b[:, None], torch.linalg.cholesky(S))),
                work=(4 * (n * n + 2 * n), _chol_ops(n)),
            )
    return worst, timing


def check_k2(torch, pp, depth_render, K, masks, ref):
    """K2 vs depth_from_popup on real 480x640 pop-ups."""
    worst, timing = 0.0, None
    pcfg = pp.PopupConfig()
    for i in (0, 40, 80, 120):
        mask = torch.as_tensor(masks[i], device="cuda")
        R = torch.as_tensor(ref["R"][i], device="cuda")
        t = torch.as_tensor(ref["t"][i], device="cuda")
        res = pp.pop_up(K, mask, R, t, pcfg)
        d_k = depth_render.depth_render(K, res, mask, R, t)
        d_p = pp.depth_from_popup(K, res, mask, R, t)
        torch.cuda.synchronize()
        assert d_k.shape == mask.shape and torch.isfinite(d_k).all()
        diff = (d_k - d_p).abs()
        err = float(diff.max())
        n_bad = int((diff > K2_ATOL + K2_RTOL * d_p.abs()).sum())
        print(json.dumps({"check": "K2", "frame": i, "max_abs_err": err,
                          "pixels_out_of_tol": n_bad,
                          "rtol": K2_RTOL, "atol": K2_ATOL,
                          "pass": n_bad == 0}))
        assert n_bad == 0, f"K2 frame {i}: {n_bad} pixels out of tolerance"
        worst = max(worst, err)
        if timing is None:
            H, W = mask.shape
            S = res.planes_w.shape[0]
            # mask, depth, camera/pose/ground, planes, endpoints, flags
            nbytes = H * W * (1 + 4) + 4 * (4 + 9 + 3 + 4) + S * (
                4 * 4 + 4 * 6 + 3)
            ops = k2_ops(H, W, int(res.valid.sum()))
            timing = dict(
                ms=_time_ms(lambda: depth_render.depth_render(
                    K, res, mask, R, t)),
                plain_ms=_time_ms(lambda: pp.depth_from_popup(
                    K, res, mask, R, t), n=20),
                library_ms=None,
                work=(nbytes, ops),
            )
    return worst, timing


def check_k1(torch, _build, fused_gn, slam_mod, state, scfg):
    """K1 vs its plain version on a mid-sequence state (window full)."""
    W = scfg.window_size
    factors = slam_mod._build_factors(state, scfg)
    w0 = state.window
    full = state.n_kf >= W
    assert bool(full)
    marg = fused_gn.pack_marg(
        w0.R[0], w0.t[0], w0.R[1], w0.t[1], state.odom_R[0],
        state.odom_t[0], state.odom_valid[0], state.mprior_R,
        state.mprior_t, state.mprior_sqrt, full)
    ms = slam_mod._marg_static(scfg)
    kw = dict(iters=scfg.gn_iters, damping=scfg.damping, robust=scfg.robust,
              marg=marg, marg_static=ms)
    wk, ck, mk = fused_gn.fused_gn_solve(w0, factors, **kw)
    wp, cp, mp = fused_gn.fused_gn_plain(w0, factors, scfg.gn_iters,
                                         scfg.damping, scfg.robust, marg, ms)
    torch.cuda.synchronize()
    for x in (wk.R, wk.t, wk.planes, ck, mk):
        assert torch.isfinite(x).all()
    err = max(float((a - b).abs().max())
              for a, b in ((wk.R, wp.R), (wk.t, wp.t),
                           (wk.planes, wp.planes)))
    cost_err = float(((ck - cp).abs() / cp.abs().clamp(min=1.0)).max())
    m_err = float(((mk - mp).abs() / mp.abs().clamp(min=1.0)).max())
    ok = err <= K1_TOL and cost_err <= K1_TOL and m_err <= 1e-3
    print(json.dumps({"check": "K1", "max_abs_err": err, "tol": K1_TOL,
                      "cost_rel_err": cost_err, "marg_rel_err": m_err,
                      "pass": ok}))
    assert ok, "K1 disagrees with its plain version"

    Wn, L = w0.window_size, w0.max_landmarks
    F = factors.planes.valid.shape[0]
    O = factors.odom.valid.shape[0]
    P = factors.priors.valid.shape[0]
    # the Python shape gate's layout size is the kernel's own
    smem_c = _build.library().popup_fused_gn_smem_bytes(Wn, L, F, O, P)
    assert smem_c == fused_gn.smem_bytes(Wn, L, F, O, P), smem_c
    # inputs read once + outputs written once
    nbytes = 4 * (12 * Wn + 4 * L + 48 * P + 13 * F + 48 * O + 128
                  + 2 * F + 2 * O + P) + (2 * Wn + L + F + O + P) \
        + 4 * (12 * Wn + 4 * L + scfg.gn_iters + 36)
    ops = k1_ops(w0, factors, scfg.gn_iters, scfg.robust)
    timing = dict(
        ms=_time_ms(lambda: fused_gn.fused_gn_solve(w0, factors, **kw)),
        plain_ms=_time_ms(lambda: fused_gn.fused_gn_plain(
            w0, factors, scfg.gn_iters, scfg.damping, scfg.robust, marg, ms),
            n=10, warm=2),
        library_ms=None,
        work=(nbytes, ops),
    )
    return err, timing


ACCEPT_TIE = 1e-4   # relative cost change below which an accept is a tie
MIN_HELD = 0.9      # a pop-up branch must not come before 90 % of a path


def accept_diffs(acc, cost, ref_acc, ref_cost):
    """(decisions that differ from the reference, those that are not f32
    ties).  A differing decision is a tie when the side that accepted
    lowered its cost by less than ACCEPT_TIE relative (or 1e-9)."""
    diff = acc != ref_acc
    dec = np.where(acc, cost[:, :-1] - cost[:, 1:],
                   ref_cost[:, :-1] - ref_cost[:, 1:])
    base = np.where(acc, cost[:, :-1], ref_cost[:, :-1])
    tie = dec <= ACCEPT_TIE * np.abs(base) + 1e-9
    return int(diff.sum()), int((diff & ~tie).sum())


def run_path(torch, name, slam_mod, pp, run, counters, ref, gpu, scfg, n,
             inputs, warm_frames=4, depth=False):
    """One path through ``run_sequence_chunked``: a short warm-up, then
    the launch counters zeroed, ``n`` frames run and the counters read.
    Holds the trajectory and discrete state against ``ref`` (keys
    prefixed ``name``); returns the launches.

    Where the reference records each frame's pop-up outcome, the
    trajectory is held over the frames before the first frame whose set
    of valid walls differs from the reference's, and that frame is
    reported: past it the two runs follow different wall sets (PERF.md,
    "pop-up branch")."""
    masks_d, oR, ot, R0, t0, K, pcfg = inputs
    solver = scfg.solver
    rec, pops = [], []
    pop_up = pp.pop_up

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        pops.append((res.valid, res.n_points))
        return res

    if solver != "gn":
        solve = getattr(slam_mod, f"{solver}_solve")

        def recording(*args, **kwargs):
            window, stats = solve(*args, **kwargs)
            rec.append((stats.accepted, stats.cost_history))
            return window, stats

        setattr(slam_mod, f"{solver}_solve", recording)
    pp.pop_up = recording_pop_up
    try:
        warm = slam_mod.slam_init(scfg, R0, t0, device=masks_d.device)
        run(warm, masks_d[:warm_frames], oR[:warm_frames], ot[:warm_frames],
            K, pcfg, scfg, depth=depth)
        torch.cuda.synchronize()
        rec.clear()
        pops.clear()
        state = slam_mod.slam_init(scfg, R0, t0, device=masks_d.device)
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        t0_run = time.perf_counter()
        state, outs = run(state, masks_d[:n], oR[:n], ot[:n], K, pcfg, scfg,
                          chunk=16, depth=depth)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0_run
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        pp.pop_up = pop_up
        if solver != "gn":
            setattr(slam_mod, f"{solver}_solve", solve)
    Rs, ts = outs[0], outs[1]
    assert ts.shape == (n, 3) and Rs.shape == (n, 3, 3)
    for x in outs:
        assert torch.isfinite(x).all()
    if depth:
        assert outs[2].shape == masks_d[:n].shape
        assert float(outs[2].min()) >= 0.0 and float(outs[2].max()) <= 50.0
    key = "" if name == "gn" else name + "_"
    t_ref, R_ref = ref[key + "t"][:n], ref[key + "R"][:n]
    t_frame = np.abs(ts.cpu().numpy() - t_ref).max(-1)
    R_err = float(np.abs(Rs.cpu().numpy() - R_ref).max())
    discrete = {
        "n_kf": int(state.n_kf) == int(ref[key + "n_kf"]),
        "n_overflow": int(state.n_overflow) == int(ref[key + "n_overflow"]),
        "store_valid": bool((state.store.valid.cpu().numpy()
                             == ref[key + "store_valid"]).all()),
    }
    held = n
    if key + "popup_valid" in ref:
        valid = torch.stack([v for v, _ in pops]).cpu().numpy()
        n_pts = torch.stack([c for _, c in pops]).cpu().numpy()
        same = (valid == ref[key + "popup_valid"][:n]).all(-1)
        if not same.all():
            held = int(np.argmin(same))
    out = {
        "path": name, "solver": solver, "window_size": scfg.window_size,
        "frames": n, "seconds": dt, "frames_per_s": n / dt, "card": gpu,
        "launches": launches, "traj_max_abs_err_m": float(t_frame.max()),
        "traj_bound_m": TRAJ_BOUND_M, "frames_held": held,
        "traj_held_max_abs_err_m": float(t_frame[:held].max()),
        "frames_over_bound": [int(i) for i in
                              np.nonzero(t_frame > TRAJ_BOUND_M)[0]],
        "R_max_abs_err": R_err, "discrete_match": discrete,
    }
    if held < n:
        out["popup_branch"] = {
            "frame": held,
            "valid": valid[held].astype(int).tolist(),
            "ref_valid": ref[key + "popup_valid"][held].astype(int).tolist(),
            "n_points": n_pts[held].tolist(),
            "ref_n_points": ref[key + "popup_n_points"][held].tolist(),
        }
    n_clear = 0
    if rec:
        acc = torch.stack([a for a, _ in rec]).cpu().numpy()[:held]
        cost = torch.stack([c for _, c in rec]).cpu().numpy()[:held]
        n_diff, n_clear = accept_diffs(acc, cost,
                                       ref[key + "accepted"][:held],
                                       ref[key + "cost"][:held])
        out.update(accept_decisions_held=int(acc.size),
                   accept_diff_from_reference=n_diff,
                   accept_diff_not_ties=n_clear)
    print(json.dumps(out))
    assert held >= MIN_HELD * n, f"{name}: pop-up branch at frame {held}"
    assert n_clear == 0, f"{name}: {n_clear} accept decisions differ"
    assert float(t_frame[:held].max()) <= TRAJ_BOUND_M, (
        f"{name}: trajectory off the reference: "
        f"{float(t_frame[:held].max())} m")
    assert all(discrete.values()), (name, discrete)
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pop_up_slam_tpu_torch  # noqa: F401  (full-f32 numerics)
    from pop_up_slam_tpu_torch.factors import graph
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import _build, cholesky, depth_render
    from pop_up_slam_tpu_torch.ops import fused_gn
    from pop_up_slam_tpu_torch.ops import plane_jacobians as pj
    from pop_up_slam_tpu_torch.ops import schur as ks
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.pipeline import slam as slam_mod
    from pop_up_slam_tpu_torch.popup import popup as pp
    from pop_up_slam_tpu_torch.solver import schur as solver_schur

    t_start = time.perf_counter()
    gpu = _gpu_line()
    print(gpu)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ----
    _build.library()
    print(json.dumps({"build_s": round(_build.build_info["seconds"], 3),
                      "built": _build.build_info["built"]}))
    log = os.path.join(os.path.dirname(_build.build_info["path"]),
                       "build.log")
    if os.path.exists(log):
        for line in open(log).read().splitlines():
            if "registers" in line or "smem" in line or line.startswith("=="):
                print("ptxas", line.strip())

    masks, oR, ot, R0, t0 = _load_inputs()
    ref_dir = os.path.join(REPO, "pop_up_slam_tpu_torch", "data")
    ref = np.load(os.path.join(ref_dir, "corridor_ref.npz"))
    ref_solvers = np.load(os.path.join(ref_dir, "corridor_ref_solvers.npz"))
    pcfg = pp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cuda")
    phase_s = {}

    # ---- 2. every kernel against its plain version ----
    t_ph = time.perf_counter()
    k4_err, k4_t = check_k4(torch, cholesky)
    k2_err, k2_t = check_k2(torch, pp, depth_render, K, masks, ref)
    K_cpu = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cpu")
    st_cpu = slam_init(scfg, R0, t0, device="cpu")
    st_cpu, _ = run_sequence_chunked(st_cpu, masks[:24], oR[:24], ot[:24],
                                     K_cpu, pcfg, scfg)
    st_mid = _to(st_cpu, "cuda")
    k1_err, k1_t = check_k1(torch, _build, fused_gn, slam_mod, st_mid, scfg)
    f_mid = slam_mod._build_factors(st_mid, scfg)
    k5_err, k5_t = check_k5(torch, pj, st_mid.window, f_mid.planes,
                            torch.device("cuda"))
    k3a_err, k3a_t = check_k3a(torch, ks, graph, solver_schur, st_mid.window,
                               f_mid, scfg.robust)
    k3b_err, k3b_t = check_k3b(torch, ks, cholesky, graph,
                               torch.device("cuda"))
    phase_s["kernel_checks"] = time.perf_counter() - t_ph

    # ---- 3. the main path, 4. the solver paths ----
    counters = {"fused_gn_solve": fused_gn.fused_gn_solve,
                "depth_render": depth_render.depth_render,
                "chol_solve": cholesky.chol_solve,
                "schur_reduce_small": ks.schur_reduce_small,
                "schur_gemm": ks.schur_gemm,
                "plane_terms": pj.plane_terms}
    masks_d = torch.as_tensor(masks, device="cuda")
    inputs = (masks_d, oR, ot, R0, t0, K, pcfg)
    n = masks.shape[0]
    paths = {}
    t_ph = time.perf_counter()
    paths["gn"] = run_path(torch, "gn", slam_mod, pp, run_sequence_chunked,
                           counters, ref, gpu, scfg, n, inputs,
                           warm_frames=16, depth=True)
    phase_s["gn_path"] = time.perf_counter() - t_ph
    assert paths["gn"]["fused_gn_solve"] == n, paths["gn"]
    assert paths["gn"]["depth_render"] == n, paths["gn"]
    for k in ("schur_reduce_small", "schur_gemm", "plane_terms"):
        assert paths["gn"][k] == 0, paths["gn"]
    for name in ("lm", "dogleg"):
        t_ph = time.perf_counter()
        paths[name] = run_path(torch, name, slam_mod, pp, run_sequence_chunked,
                               counters, ref_solvers, gpu,
                               scfg._replace(solver=name), n, inputs)
        phase_s[f"{name}_path"] = time.perf_counter() - t_ph
        c = paths[name]
        assert c["schur_reduce_small"] == c["plane_terms"] == 2 * n, c
        assert c["fused_gn_solve"] == 0 and c["schur_gemm"] == 0, c
    n24 = 48
    t_ph = time.perf_counter()
    paths["lm24"] = run_path(torch, "lm24", slam_mod, pp,
                             run_sequence_chunked,
                             counters, ref_solvers, gpu,
                             scfg._replace(solver="lm", window_size=24), n24,
                             inputs)
    phase_s["lm24_path"] = time.perf_counter() - t_ph
    c = paths["lm24"]
    assert c["schur_gemm"] == c["chol_solve"] == 2 * n24, c
    assert c["plane_terms"] == 2 * n24 and c["schur_reduce_small"] == 0, c
    assert c["fused_gn_solve"] == 0, c

    # ---- 5. summary ----
    def row(name, counter, own_path, source, replaces, err, tm):
        b_ms, b_by = _bound(*tm["work"])
        by_path = {p: paths[p][counter] for p in paths}
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": by_path[own_path],
             "launches_path": own_path, "launches_by_path": by_path,
             "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
             "bound_ms": b_ms, "bound_by": b_by,
             "library_ms": tm["library_ms"], "bytes": tm["work"][0],
             "operations": tm["work"][1],
             "launched_on_path": any(by_path.values())}
        r.update({k: v for k, v in tm.items()
                  if k not in r and k != "work"})
        return r

    src = "pop_up_slam_tpu_torch/ops/csrc/"
    kernels = [
        row("K1 fused_gn_solve", "fused_gn_solve", "gn", src + "fused_gn.cu",
            "pop_up_slam_tpu/ops/fused_gn.py:795", k1_err, k1_t),
        row("K2 depth_render", "depth_render", "gn", src + "depth_render.cu",
            "pop_up_slam_tpu/ops/depth_render.py:117", k2_err, k2_t),
        row("K4 chol_solve", "chol_solve", "lm24", src + "chol_solve.cu",
            "pop_up_slam_tpu/ops/cholesky_pallas.py:134", k4_err, k4_t),
        row("K3a schur_reduce_small", "schur_reduce_small", "lm",
            src + "schur_reduce.cu",
            "pop_up_slam_tpu/ops/schur_pallas.py:117", k3a_err, k3a_t),
        row("K3b schur_gemm", "schur_gemm", "lm24", src + "schur_reduce.cu",
            "pop_up_slam_tpu/ops/schur_pallas.py:81", k3b_err, k3b_t),
        row("K5 plane_terms", "plane_terms", "lm", src + "plane_terms.cu",
            "pop_up_slam_tpu/ops/plane_jacobians.py:315", k5_err, k5_t),
    ]
    print(json.dumps({"kernels": kernels,
                      "note": "K4's routine also runs inside K1 and K3a; "
                              "its standalone kernel follows K3b",
                      "phase_s": phase_s,
                      "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
