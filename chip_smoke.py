#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pop_up_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and builds the CUDA kernels from ``pop_up_slam_tpu_torch/ops/
   csrc`` (nvcc, sm_90a), printing the build time and ptxas resource usage.
2. Holds every kernel against its plain PyTorch version on the card, on
   the same inputs, at the main path's shapes: K4 (Cholesky solve) at n=48
   and n=96 plus an indefinite system; K2 (depth render) on real 480x640
   pop-ups of corridor frames; K1 (fused GN) at W=8, L=64, F=72, O=7, P=1,
   2 iterations, with the marginal block, on a state captured mid-sequence
   with the window full.  One JSON line per case.
3. Drives the main path: ``run_sequence_chunked`` over all 144 frames of
   ``bench_data/corridor_inputs.npz`` at 480x640 with the production
   ``SlamConfig`` (every frame a keyframe, chunks of 16), rendering each
   frame's depth as the reference ``entry()`` does.  Kernel launch counters
   are zeroed just before and read just after; the trajectory is held
   against the committed JAX reference ``pop_up_slam_tpu_torch/data/
   corridor_ref.npz``.
4. Prints the ``{"kernels": [...]}`` line, the card line, and last
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


# one plane factor (fused_gn.cu plane_factor): prediction 51, measured
# plane 19, tangent columns, residual 11, Jp 30, S^3 basis, dnc 54, Jl 102,
# whitening (A r, A Jp, A Jl, |r|^2, sqrt, scale 30)
_PLANE_FACTOR = (51 + 19 + _NORMAL_COLS + 11 + 30 + _TANGENT4 + 54 + 102
                 + _MV3 + _mm(3, 3, 6) + _mm(3, 3, 3) + 5 + 1 + 30)
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pop_up_slam_tpu_torch  # noqa: F401  (full-f32 numerics)
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import _build, cholesky, depth_render
    from pop_up_slam_tpu_torch.ops import fused_gn
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.pipeline import slam as slam_mod
    from pop_up_slam_tpu_torch.popup import popup as pp

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
    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref.npz"))
    pcfg = pp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cuda")

    # ---- 2. every kernel against its plain version ----
    k4_err, k4_t = check_k4(torch, cholesky)
    k2_err, k2_t = check_k2(torch, pp, depth_render, K, masks, ref)
    K_cpu = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device="cpu")
    st_cpu = slam_init(scfg, R0, t0, device="cpu")
    st_cpu, _ = run_sequence_chunked(st_cpu, masks[:24], oR[:24], ot[:24],
                                     K_cpu, pcfg, scfg)
    k1_err, k1_t = check_k1(torch, _build, fused_gn, slam_mod,
                            _to(st_cpu, "cuda"), scfg)

    # ---- 3. the main path ----
    warm = slam_init(scfg, R0, t0)
    run_sequence_chunked(warm, masks[:16], oR[:16], ot[:16], K, pcfg, scfg,
                         depth=True)
    torch.cuda.synchronize()
    state = slam_init(scfg, R0, t0)
    masks_d = torch.as_tensor(masks, device="cuda")
    torch.cuda.synchronize()
    for fn in (fused_gn.fused_gn_solve, depth_render.depth_render,
               cholesky.chol_solve):
        fn.launches = 0
    t0_run = time.perf_counter()
    state, (Rs, ts, depth) = run_sequence_chunked(
        state, masks_d, oR, ot, K, pcfg, scfg, chunk=16, depth=True)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0_run
    launches = {"fused_gn_solve": fused_gn.fused_gn_solve.launches,
                "depth_render": depth_render.depth_render.launches,
                "chol_solve": cholesky.chol_solve.launches}
    n = masks.shape[0]
    assert launches["fused_gn_solve"] == n, launches
    assert launches["depth_render"] == n, launches
    assert ts.shape == (n, 3) and Rs.shape == (n, 3, 3)
    assert depth.shape == masks.shape
    for x in (Rs, ts, depth):
        assert torch.isfinite(x).all()
    assert float(depth.min()) >= 0.0 and float(depth.max()) <= 50.0
    t_err = float(np.abs(ts.cpu().numpy() - ref["t"]).max())
    R_err = float(np.abs(Rs.cpu().numpy() - ref["R"]).max())
    discrete = {
        "n_kf": int(state.n_kf) == int(ref["n_kf"]),
        "n_overflow": int(state.n_overflow) == int(ref["n_overflow"]),
        "store_valid": bool((state.store.valid.cpu().numpy()
                             == ref["store_valid"]).all()),
    }
    print(json.dumps({
        "main_path": "run_sequence_chunked+render_depth", "frames": n,
        "seconds": dt, "frames_per_s": n / dt, "card": gpu,
        "launches": launches, "traj_max_abs_err_m": t_err,
        "traj_bound_m": TRAJ_BOUND_M, "R_max_abs_err": R_err,
        "discrete_match": discrete,
    }))
    assert t_err <= TRAJ_BOUND_M, f"trajectory off the reference: {t_err} m"
    assert all(discrete.values()), discrete

    # ---- 4. summary ----
    def row(name, source, replaces, err, tm, n_launch, on_path=True):
        b_ms, b_by = _bound(*tm["work"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": tm["ms"], "plain_ms": tm["plain_ms"],
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": tm["library_ms"], "bytes": tm["work"][0],
                "operations": tm["work"][1], "launched_on_path": on_path}

    src = "pop_up_slam_tpu_torch/ops/csrc/"
    kernels = [
        row("K1 fused_gn_solve", src + "fused_gn.cu",
            "pop_up_slam_tpu/ops/fused_gn.py:795", k1_err, k1_t,
            launches["fused_gn_solve"]),
        row("K2 depth_render", src + "depth_render.cu",
            "pop_up_slam_tpu/ops/depth_render.py:117", k2_err, k2_t,
            launches["depth_render"]),
        row("K4 chol_solve", src + "chol_solve.cu",
            "pop_up_slam_tpu/ops/cholesky_pallas.py:134", k4_err, k4_t,
            launches["chol_solve"], on_path=False),
    ]
    print(json.dumps({"kernels": kernels,
                      "note": "K4's routine runs inside K1 on the main path; "
                              "its standalone kernel is not launched there",
                      "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
