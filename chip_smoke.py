#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``pop_up_slam_tpu_torch``) on one GPU.

    python3 chip_smoke.py

1. Prints the card (``nvidia-smi`` name and power limit), the torch/CUDA
   versions, and builds the CUDA kernels from ``pop_up_slam_tpu_torch/ops/
   csrc`` (nvcc, sm_90a, one process per source), printing the build time
   and ptxas resource usage.
2. Holds every kernel against its plain PyTorch version on the card, on
   the same inputs, at the paths' shapes: K4 (Cholesky solve) at
   n = 1, 7, 48, 144, 224 (one-block route) and 225, 240, 384 (device-
   memory route), two launches bit-identical, plus indefinite systems at
   n=48 and n=240, timed at n=48, 144 and 384 beside
   ``torch.linalg.cholesky`` / ``cholesky_ex`` + ``cholesky_solve``; K2
   (depth render) on real 480x640 pop-ups of four corridor frames (each
   output's sha256 printed), the 120x160 test frame and a 479x161 crop;
   K1 (fused GN) at W=8, L=64, F=72, O=7, P=1, 2 iterations, with the
   marginal block, on a state captured mid-sequence with the window
   full, two launches bit-identical, its in-kernel time from its
   ``%globaltimer`` stamps; K5 (plane Jacobians) on that state's 72
   factors and a random F=37 set with invalid factors (the sha256 of its
   outputs on both, two launches bit-identical, its in-kernel time from
   its stamps; the count of factors whose measured normal lies within
   2.6 degrees of an axis, whose residual rows are held against the f64
   closed form at 1e-5 / (1 - max|n_k|), capped at 5e-3); K3a (Schur
   reduction + solve) on that state's linearization, on a system with a
   gauge-fixed pose, invalid landmarks and an indefinite direction, and
   on random systems at W=21, L=100 (n = 126), W=8, L=80 and W=5, L=9;
   its S equal bit for bit to K3b's at lambda = 0 with every pose free
   (a random system and dense B, G); two launches bit-identical; the
   sha256 of its (S, x) on a seeded random system; its in-kernel time
   from its stamps; K3b (sparse Schur product, then K4) at W=23, L=9,
   W=24, L=64 and W=40, L=64, two launches bit-identical, the sha256 of
   its S at L=64; K2 also at ``max_depth=40`` (the fused monocular
   path's clip) on the four 480x640 frames; the per-factor ``jacfwd``
   linearization (``analytic_planes=False, analytic_poses=False``)
   against the closed form on the mid-sequence state and a random
   system (its gradients against the f64 closed form).  One JSON line
   per case.
   Then the pop-up on the card from the pose the reference gave its own
   pop-up on each main-path frame (``popup_R`` / ``popup_t``): per frame,
   whether ``valid`` and ``n_points`` equal the reference's (held on all
   144, at the end).
3. Drives the main path: ``run_sequence_chunked`` over all 144 frames of
   ``bench_data/corridor_inputs.npz`` at 480x640 with the production
   ``SlamConfig`` (every frame a keyframe, chunks of 16), rendering each
   frame's depth as the reference ``entry()`` does.  Kernel launch counters
   are zeroed just before and read just after; the run is held against
   the committed JAX reference ``pop_up_slam_tpu_torch/data/
   corridor_ref.npz`` as ``run_path`` says: the free run up to its first
   pop-up branch, and every one of the 144 frames again from the
   reference's own state before it (``anchor.*`` in the file).
4. Drives the solver paths the same way, each against its committed JAX
   run in ``corridor_ref_solvers.npz``: ``solver="lm"`` and
   ``solver="dogleg"`` over the 144 frames at the production widths (K3a
   and K5 twice per keyframe), and ``solver="lm"`` with ``window_size=24``
   over the first 48 frames (6W = 144: K3b, K4 and K5 twice per keyframe).
   Each is held as ``run_path`` says: the free run over ``frames_held``
   (the frames before its pop-up first finds another set of valid walls
   than the reference's), its accept decisions before the pop-up's
   column counts first differ; and the anchored run (each frame from
   the reference's state) on every frame, its accept decisions on every
   frame whose pop-up equals the reference's (no decision may differ
   except at an f32 tie).  Every path's keyframe decisions are held
   frame by frame in both runs.
5. Drives the monocular paths over the 144 masks alone, against
   ``corridor_ref_vo.npz``: ``vo`` (``make_chunked_vo_runner``: pop-up,
   plane-VO odometry, K1) and ``fused_vo`` (``make_chunked_fused_vo_runner``:
   also K2 at ``max_depth=40`` and the inverse-depth filter), each once
   free from ``slam_init`` through ``run_masks_chunked`` with the launch
   counters zeroed (K1 once a keyframe of the run, at least 90 % of the
   frames, each frame's keyframe decision the reference's up to a tie;
   on ``fused_vo`` K2 once a frame; no other kernel; the trajectory
   error per frame reported), and once frame by frame from the
   reference's own state (held: see ``run_vo_path``).
6. Drives the TUM entry point against ``corridor_ref_tum.npz``: the
   ``tum`` path (``cli.main(["run", "--config", "tum_fr3", ...])``
   in-process over a TUM tree of the 144 masks written by the port's
   ``write_tum_tree``: ``gt_perturb``, smoothed; K1 once a keyframe solve,
   K5 8 times; the free run, the anchored smoother and the marginals
   held as ``run_tum_path`` says), the ``tum_vo`` path
   (``odometry="plane_vo"`` over the first 48 frames) and the
   ``popup_demo`` path (``cli`` at 480x640: K2 once, the wall count the
   reference CLI's); K5 held against its plain version at the
   smoother's shape (W = N rounded up to 8, F = 9 N).
7. Drives the slice of the batched and pipelined runners and the learned
   segmenter (and, inside the TUM phase, the native loader):
   ``batched`` (``run_sequence_batched`` over the 144 frames, chunks of
   16: the pop-up of a chunk in one vmapped pass at dead-reckoned poses;
   against ``corridor_ref_batched.npz`` as ``run_batched_path`` says: K1
   144, the free run to its pop-up branch, each chunk from the
   reference's state, the batched pop-up at the reference's poses on all
   144 frames), ``pipelined`` (``run_pipelined``, the front end on a side
   stream, ``stale_prediction=False``: sha256-equal to the sequential
   frame loop twice, K1 144) and ``pipelined_stale`` (ATE within the
   reference test's bound, K1 144), each with frames/s and launches a
   frame beside the chunked runner's and the main path's; ``segnet`` (the
   pretrained SegNetLite on four 480x640 renders: IoU > 0.9, its logits
   against the CPU module's and flax's recorded ones, K2 once a frame
   through ``pop_up`` and ``render_depth``); ``native`` (the TUM tree
   through ``NativeSequence.stream``, equal to ``io/png.py``'s decode, and
   the libpng-written fixtures with every row filter; decode ms a frame
   of both codecs).  K5's device time at the smoother's shape, from the
   profiler.
8. Drives the multi-device slice and SegNetLite's training, against
   ``corridor_ref_sharded.npz`` (the JAX package's multi-device paths on
   a 2-device CPU mesh): ``sharded`` (``run_sequence_sharded`` over the
   144 frames, blocks of 16, on a NCCL world of one on this card: the
   DP pop-up and the factor-sharded GN, K5 twice a keyframe and no other
   kernel; held as ``run_sharded_path`` says), ``sharded_gloo2`` (two
   spawned gloo ranks on ``cuda:0``: ``distributed_gn_solve`` with K5 on
   each rank's block and ``map_block_gn_solve`` on the recorded corridor
   problem, against the single-device ``gn_solve``), ``single_host``
   (``cli run --config single_host`` in-process at a world of one, 64
   frames at 480x640; its ATE against the JAX CLI's) and ``multi_host``
   once, ``smoother_mesh`` (``smooth_trajectory(mesh=)`` on the TUM
   reference's recorder and state, against the single-device smoother
   and the JAX mesh smoother) and ``segnet_train``
   (``scripts/train_segnet_torch.py``'s loop, 400 steps: held-out IoU,
   the first loss against the CPU module's, the checkpoint round trip).
9. Prints the ``{"kernels": [...]}`` line (one row per kernel; K4's row
   is lm24's n=144, its other timed sizes, which no path launches, are
   nested under ``other_n`` with 0 launches; K5's row also carries its
   time at the smoother's shape), the card line, and last
   ``{"ok": true, "device": {...}}``.

Any failed check raises and the script exits non-zero without the last
line.  Without a CUDA device it exits non-zero at once.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile
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
K3B_TOL = (1e-3, 5e-3)    # tiled route: a 138-240-dim f32 factorization
# jacfwd vs closed-form linearization: each output within JACFWD_TOL of
# its largest entry.  A plane factor whose measured normal lies within
# 2.6 degrees of an axis (1 - max|n_k| < NEAR_AXIS) has residual rows
# good to K5_TOL / (1 - max|n_k|) only (the Householder tangent basis):
# they are held against the f64 closed form at that tolerance, capped at
# NEAR_AXIS_CAP (about three times the largest parting measured, 1.6e-3
# on the H100, PERF.md), relative to 1 + |r|
JACFWD_TOL = 1e-5
NEAR_AXIS = 1e-3
NEAR_AXIS_CAP = 5e-3
# the smoother's factors are the whole corridor trajectory's: every one of
# its 172 valid factors lies within 8.3 degrees of an axis (1 - max|n_k|
# <= 0.0106), where the f32 closed form itself parts from f64 by up to
# 1.7e-3 in the residual rows (its plain version on the CPU), 3.6e-5 at
# the two farthest; so every residual row takes the near-axis rule (the
# row tolerance K5_TOL / (1 - max|n_k|), capped, against f64)
NEAR_AXIS_SMOOTHER = 1.0


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
    inputs read once (a sqrt-info broadcast over the factors, which the
    wrapper passes as one matrix, once), r/Jp/Jl written once; operations
    per valid factor with both indices in range (``_PLANE_TERMS``)."""
    W, L = window.window_size, window.max_landmarks
    F = pf.valid.shape[0]
    p, l = pf.pose_idx.cpu().numpy(), pf.lm_idx.cpu().numpy()
    ok = pf.valid.cpu().numpy() & (p >= 0) & (p < W) & (l >= 0) & (l < L)
    a_bytes = 36 if pf.sqrt_info.stride() == (0, 3, 1) else 36 * F
    nbytes = (4 * (12 * W + 4 * L) + F * (4 + 4 + 16 + 1) + a_bytes
              + F * 4 * 30)
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


def near_axis_rows(torch, pf, band=NEAR_AXIS):
    """(near-axis mask (F,), per-factor residual-row tolerance (F,) f64):
    min(K5_TOL / (1 - max|n_k|), NEAR_AXIS_CAP) for valid factors whose
    measured normal lies within ``band`` of an axis, K5_TOL for the
    others.  1 - max|n_k| is taken in f64 from the f32 measurement."""
    n = pf.pi_meas[:, :3].double()
    gap = 1.0 - (n / n.norm(dim=1, keepdim=True)).abs().max(dim=1).values
    near = pf.valid & (gap < band)
    tau = torch.where(near, (K5_TOL / gap).clamp(max=NEAR_AXIS_CAP),
                      torch.full_like(gap, K5_TOL))
    return near, tau


def near_axis_rows_held(r, r64, near, tau):
    """(max |r - r64| over the near-axis rows, rows outside tau (1 +
    |r64|))."""
    if not bool(near.any()):
        return 0.0, 0
    d = (r[near].double() - r64[near]).abs()
    return (float(d.max()),
            int((d > tau[near, None] * (1.0 + r64[near].abs())).sum()))


def _double(torch, x):
    """A (nested) NamedTuple of tensors with its floating tensors in
    f64."""
    if isinstance(x, torch.Tensor):
        return x.double() if x.is_floating_point() else x
    return type(x)(*(_double(torch, v) for v in x))


def hold_k5(torch, pj, name, w, f, band=NEAR_AXIS):
    """K5 vs plane_terms_analytic on one factor set, every entry at K5_TOL
    except the residual rows of near-axis factors (``near_axis_rows`` with
    ``band``), which are held against the closed form in f64 at their row
    tolerance; the sha256 of its (r, Jp, Jl); two launches bit-identical.
    Returns the max abs error."""
    out_k = pj.plane_terms(w, f)
    out_k2 = pj.plane_terms(w, f)
    out_p = pj.plane_terms_analytic(w, f)
    # the closed form in f64, for the residual rows of near-axis factors
    # (held at K5_TOL / (1 - max|n_k|), not dropped)
    r64 = pj.plane_terms_analytic(_double(torch, w), _double(torch, f))[0]
    near, tau = near_axis_rows(torch, f, band)
    torch.cuda.synchronize()
    err, bad_by = 0.0, []
    for i, (a, b) in enumerate(zip(out_k, out_p)):
        assert torch.isfinite(a).all(), name
        rows = ~near if i == 0 else slice(None)
        e, n_bad = _err(a[rows], b[rows], K5_TOL, K5_TOL)
        err = max(err, e)
        bad_by.append(n_bad)
    e_near, n_bad = near_axis_rows_held(out_k[0], r64, near, tau)
    bad_by.append(n_bad)
    bad = sum(bad_by)
    zero_ok = all(not a[~f.valid].any() for a in out_k)
    same = all(torch.equal(a, b) for a, b in zip(out_k, out_k2))
    print(json.dumps({"check": "K5", "case": name,
                      "W": w.window_size, "L": w.max_landmarks,
                      "F": int(f.valid.shape[0]),
                      "smem_bytes": pj.smem_bytes(w.window_size,
                                                  w.max_landmarks),
                      "valid_factors": int(f.valid.sum()),
                      "near_axis_band": band,
                      "near_axis_factors": int(near.sum()),
                      "max_abs_err": err,
                      "near_axis_r_max_abs_err_f64": e_near,
                      "near_axis_r_tol_max": float(
                          tau[near].max()) if bool(near.any()) else 0.0,
                      "near_axis_r_tol_form": "tol (1 + |r_f64|)",
                      "entries_out_of_tol": bad,
                      "out_of_tol_r_Jp_Jl_near": bad_by, "rtol": K5_TOL,
                      "atol": K5_TOL, "invalid_rows_zero": zero_ok,
                      "two_launches_bit_identical": same,
                      "sha256": sha256_of(*out_k),
                      "pass": bad == 0 and zero_ok and same}))
    assert bad == 0 and zero_ok and same, f"K5 {name}"
    return err


def k5_timing(torch, pj, w, f):
    """K5's and its plain version's times, and its work, on one set."""
    return dict(ms=_time_ms(lambda: pj.plane_terms(w, f)),
                plain_ms=_time_ms(lambda: pj.plane_terms_analytic(w, f),
                                  n=20),
                library_ms=None, work=k5_work(w, f))


def check_k5(torch, pj, window, pf, torch_dev):
    """K5 (``hold_k5``) on the state's 72 factors and on a random F=37
    set with invalid factors; its in-kernel time from its stamps on the
    state."""
    rw, rf = random_system(torch, 6, 10, 37, 3, torch_dev)
    rpf = rf.planes._replace(valid=rf.planes.valid.clone())
    rpf.valid[:3] = False
    worst = max(hold_k5(torch, pj, "state_F72", window, pf),
                hold_k5(torch, pj, "random_F37", rw, rpf))
    stamps = torch.zeros((50, pj.N_STAMPS), dtype=torch.int64,
                         device=torch_dev)
    for r in range(stamps.shape[0]):
        pj.plane_terms(window, pf, stamps=stamps[r])
    torch.cuda.synchronize()
    assert bool((stamps.diff(dim=1) >= 0).all()), "K5 stamps"
    timing = k5_timing(torch, pj, window, pf)
    timing["kernel_ms_stamped"] = float(
        (stamps[:, -1] - stamps[:, 0]).double().mean()) / 1e6
    return worst, timing


def check_jacfwd(torch, graph, pj, window, factors, robust, tag):
    """The per-factor jacfwd linearization (``analytic_planes=False,
    analytic_poses=False``) against the closed-form one (K5 in its plane
    terms) on the card: Hpp, Hpl, Hll and the cost within JACFWD_TOL of
    each one's largest entry.  Its plane residual rows against the closed
    form at K5_TOL, near-axis rows against it in f64 (``near_axis_rows``,
    as K5's), and bp,
    bl against the f64 closed form's within the parting of each factor's
    f32 residual and Jacobian from f64 carried into them (the gradient of
    a near-axis factor is only as good as its residual row in f32), plus
    JACFWD_TOL of the summed magnitudes."""
    lin_j = graph.linearize(window, factors, analytic_planes=False,
                            analytic_poses=False, robust=robust)
    lin_a = graph.linearize(window, factors, analytic_planes=True,
                            analytic_poses=True, robust=robust)
    # the f64 closed form on the host (K5 takes f32 only)
    lin_64 = graph.linearize(
        _double(torch, _to(window, "cpu")),
        type(factors)(*(_double(torch, _to(f, "cpu")) for f in factors)),
        analytic_planes=True, analytic_poses=True, robust=robust)
    dev = window.t.device
    lin_64 = _to(lin_64, dev)
    pf = factors.planes
    w64 = _double(torch, window)
    r, Jp, Jl = graph._plane_terms(window, pf)
    r64 = pj.plane_terms_analytic(w64, _double(torch, pf))[0]
    near, tau = near_axis_rows(torch, pf)
    e_near, bad_near = near_axis_rows_held(r, r64, near, tau)
    # the other rows against the closed form in f32, as K5's
    r32 = pj.plane_terms_analytic(window, pf)[0]
    e_far, bad_far = _err(r[~near], r32[~near], K5_TOL, K5_TOL)
    # the gradient's parting from f64, factor by factor: J r - J64 r64
    # = J (r - r64) + (J - J64) r64, so |J| |r - r64| + |J - J64| |r64|
    # bounds it, and JACFWD_TOL (|J| |r| + |J64| |r64|) the rounding of
    # the f32 products and sums
    W, L = window.window_size, window.max_landmarks
    carried = {
        "bp": torch.zeros((W, 6), dtype=torch.float64, device=dev),
        "bl": torch.zeros((L, 3), dtype=torch.float64, device=dev)}

    def carry(b, idx, J, r32, J64, r_64):
        J, dr = J.double(), (r32.double() - r_64).abs()
        term = (torch.einsum("fab,fa->fb", J.abs(), dr)
                + torch.einsum("fab,fa->fb", (J - J64).abs(), r_64.abs())
                + JACFWD_TOL * torch.einsum("fab,fa->fb", J.abs(),
                                            r32.double().abs())
                + JACFWD_TOL * torch.einsum("fab,fa->fb", J64.abs(),
                                            r_64.abs()))
        b.index_add_(0, idx.long(), term)

    _, Jp64, Jl64 = pj.plane_terms_analytic(w64, _double(torch, pf))
    carry(carried["bp"], pf.pose_idx, Jp, r, Jp64, r64)
    carry(carried["bl"], pf.lm_idx, Jl, r, Jl64, r64)
    od, pr = factors.odom, factors.priors
    r_o, Ji, Jj = graph._odom_terms(window, od)
    r_o64, Ji64, Jj64 = graph._odom_terms_analytic(w64, _double(torch, od))
    carry(carried["bp"], od.i, Ji, r_o, Ji64, r_o64)
    carry(carried["bp"], od.j, Jj, r_o, Jj64, r_o64)
    r_p, Jq = graph._prior_terms(window, pr)
    r_p64, Jq64 = graph._prior_terms_analytic(w64, _double(torch, pr))
    carry(carried["bp"], pr.idx, Jq, r_p, Jq64, r_p64)
    _sync(torch)
    out = {"check": "jacfwd linearize", "case": tag, "tol": JACFWD_TOL,
           "near_axis_factors": int(near.sum()),
           "r_max_abs_err": e_far,
           "near_axis_r_max_abs_err_f64": e_near,
           "near_axis_r_tol_max": float(tau[near].max())
           if bool(near.any()) else 0.0}
    ok = bad_near == 0 and bad_far == 0
    for name, a, b, b64 in zip(lin_a._fields, lin_j, lin_a, lin_64):
        assert torch.isfinite(a).all(), name
        if name in carried:
            lim = carried[name]
            d = (a.double() - b64).abs()
            out[f"{name}_max_abs_err_f64"] = float(d.max())
            out[f"{name}_max_abs_f64"] = float(b64.abs().max())
            out[f"{name}_bound_max"] = float(lim.max())
            pos = lim > 0
            out[f"{name}_over_bound_max"] = float(
                (d[pos] / lim[pos]).max()) if bool(pos.any()) else 0.0
        else:
            lim = JACFWD_TOL * max(1.0, float(b.abs().max()))
            d = (a - b).abs()
            out[f"{name}_max_abs_err"] = float(d.max())
            out[f"{name}_bound"] = lim
        ok &= int((d > lim).sum()) == 0
    out["pass"] = ok
    print(json.dumps(out))
    assert ok, f"jacfwd linearization off the closed form ({tag})"


def check_popup_at_reference_poses(torch, pp, K, masks_d, ref):
    """The port's pop-up on the card from the pose the reference gave
    its own pop-up on each frame of the main path (``popup_R`` /
    ``popup_t``): whether ``valid`` and ``n_points`` equal the
    reference's ``popup_valid`` / ``popup_n_points``, per frame (held on
    every frame: the boundary back-projection rounds as XLA's CPU code
    for the reference rounds it, ``camera.backproject_to_world_plane``).
    Equal on every frame means a run's partings come from its pose chain,
    not from the pop-up."""
    valid, n_pts = [], []
    for i in range(masks_d.shape[0]):
        R = torch.as_tensor(ref["popup_R"][i], device=masks_d.device)
        t = torch.as_tensor(ref["popup_t"][i], device=masks_d.device)
        res = pp.pop_up(K, masks_d[i], R, t)
        valid.append(res.valid)
        n_pts.append(res.n_points)
    same_v = (_stack_np(valid) == ref["popup_valid"]).all(-1)
    same_n = (_stack_np(n_pts) == ref["popup_n_points"]).all(-1)
    same = same_v & same_n
    line = {"check": "pop-up at the reference's poses",
            "frames": int(masks_d.shape[0]),
            "valid_equal_frames": int(same_v.sum()),
            "n_points_equal_frames": int(same_n.sum()),
            "frames_differ": [int(i) for i in np.nonzero(~same)[0]],
            "pass": bool(same.all())}
    print(json.dumps(line))
    return line["pass"]


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
    # the widest window of the route (n = 126), more landmarks than one
    # 64-landmark chunk, 3L = 27 columns (no 16-byte staging), and the two
    # landmarks random_system leaves unobserved; n = 126 is held as the
    # tiled route's 138-240-dim systems
    lam3 = torch.full((), 1e-3, device=dev)
    for W_, L_, F_, tol, s_tol in ((21, 100, 200, K3B_TOL, K3B_TOL),
                                   (8, 80, 90, K3A_TOL, K3A_S_TOL),
                                   (5, 9, 40, K3A_TOL, K3A_S_TOL)):
        w_r, f_r = random_system(torch, W_, L_, F_, 13, dev)
        lin_r = graph.linearize(w_r, f_r, analytic_planes=True)
        worst = max(worst, _compare_schur(
            torch, "K3a", f"random_W{W_}_L{L_}",
            ks.schur_reduce(lin_r, w_r, lam3),
            ks.schur_reduce_plain(lin_r, w_r, lam3), tol, s_tol))
    check_k3a_equals_k3b(torch, ks, graph, dev)
    ops_ = ks.reduce_operands(lin, window, lam)
    _, B, G, Hpp, pm, rp = ops_
    a = ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    b = ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam)
    same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    print(json.dumps({"check": "K3a", "case": "two launches bit-identical",
                      "pass": same}))
    assert same
    # output hashes on a seeded problem, for a bit-for-bit comparison with
    # another build of the kernel (-0 taken as +0)
    w_h, f_h = random_system(torch, 8, 64, 72, 5, dev)
    lam_h = torch.full((), 1e-5, device=dev)
    _, B_h, G_h, Hpp_h, pm_h, rp_h = ks.reduce_operands(
        graph.linearize(w_h, f_h, analytic_planes=True), w_h, lam_h)
    S_h, x_h = ks.schur_reduce_small(Hpp_h, B_h, G_h, -rp_h, pm_h, lam_h)
    print(json.dumps({"check": "K3a", "case": "sha256 random_W8_L64 seed 5",
                      "S_sha256": sha256_of(S_h),
                      "x_sha256": sha256_of(x_h)}))
    stamps = torch.zeros((50, ks.N_SMALL_STAMPS), dtype=torch.int64,
                         device=dev)
    for r in range(stamps.shape[0]):
        ks.schur_reduce_small(Hpp, B, G, -rp, pm, lam, stamps=stamps[r])
    torch.cuda.synchronize()
    assert bool((stamps.diff(dim=1) >= 0).all()), "K3a stamps"
    kernel_ms = float((stamps[:, -1] - stamps[:, 0]).double().mean()) / 1e6
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
        kernel_ms_stamped=kernel_ms,
        work=(4 * (n * n + 2 * n * C + 2 * n + 1) + 4 * (n * n + n),
              prod + n_free + _chol_ops(n_free)),
    )
    return worst, timing


def sha256_of(*tensors) -> str:
    """sha256 of the tensors' f32 bytes, with -0 taken as +0."""
    h = hashlib.sha256()
    for t in tensors:
        h.update((t.float() + 0.0).cpu().numpy().tobytes())
    return h.hexdigest()


def check_k3a_equals_k3b(torch, ks, graph, dev):
    """At lambda = 0 with every pose free, K3a's S equals K3b's bit for bit
    (-0 taken as +0): both sum each entry over k in ascending order with
    fmaf from 0, K3a skipping only exact-zero terms.  On random_system
    and on dense B and G (every term non-zero)."""
    lam0 = torch.zeros((), device=dev)
    w, f = random_system(torch, 8, 64, 72, 11, dev)
    w = w._replace(pose_fixed=torch.zeros_like(w.pose_fixed))
    _, B, G, Hpp, pm, rp = ks.reduce_operands(
        graph.linearize(w, f, analytic_planes=True), w, lam0)
    rng = np.random.default_rng(7)
    n, C = 48, 192
    dense = [torch.as_tensor(rng.normal(size=sh).astype(np.float32),
                             device=dev) for sh in ((n, n), (n, C), (n, C),
                                                    (n,))]
    for name, (Hpp_, B_, G_, pm_, rhs) in (
            ("random_W8_L64_all_free", (Hpp, B, G, pm, -rp)),
            ("dense_n48_C192", (dense[0], dense[1], dense[2],
                                torch.ones(n, device=dev), dense[3]))):
        assert bool((pm_ == 1).all())
        S_a, _ = ks.schur_reduce_small(Hpp_, B_, G_, rhs, pm_, lam0)
        S_b = ks.schur_gemm(Hpp_, B_, G_)
        torch.cuda.synchronize()
        same = torch.equal(S_a + 0.0, S_b + 0.0)
        print(json.dumps({"check": "K3a", "case": f"S equals K3b's {name}",
                          "max_abs_diff": float((S_a - S_b).abs().max()),
                          "pass": same}))
        assert same, f"K3a S differs from K3b's on {name}"


def check_k3b(torch, ks, cholesky, graph, dev):
    """K3b (+ damping, mask and K4) vs the plain tiled route at W=23, L=9,
    W=24, L=64 and W=40, L=64 (n = 240: K4's device-memory route); the
    product alone against its plain version, two launches bit-identical,
    and the sha256 of its S at W=24 and W=40."""
    worst, timing = 0.0, None
    for W, L, F in ((23, 9, 40), (24, 64, 216), (40, 64, 240)):
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
        S_k2 = ks.schur_gemm(Hpp, B, G)
        torch.cuda.synchronize()
        e, bad = _err(S_k, S_p, *K3B_TOL)
        same = torch.equal(S_k, S_k2)
        line = {"check": "K3b", "case": name, "max_abs_err": e,
                "rtol": K3B_TOL[0], "atol": K3B_TOL[1],
                "entries_out_of_tol": bad,
                "two_launches_bit_identical": same}
        if L == 64:   # for a bit-for-bit comparison with another build
            line["S_sha256"] = sha256_of(S_k)
        print(json.dumps({**line, "pass": bad == 0 and same}))
        assert bad == 0 and same, f"K3b {name}"
        worst = max(worst, e)
        if W == 24:
            n, C = B.shape
            timing = dict(
                ms=_time_ms(lambda: ks.schur_gemm(Hpp, B, G)),
                plain_ms=_time_ms(lambda: ks.schur_gemm_plain(Hpp, B, G)),
                library_ms=_time_ms(lambda: torch.addmm(Hpp, B, G.T,
                                                        alpha=-1)),
                work=(4 * (n * n + 2 * n * C) + 4 * n * n,
                      schur_product_ops(lin, window)[0]),
            )
    return worst, timing


def _load_inputs():
    z = np.load(os.path.join(REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    return masks, z["odom_R"], z["odom_t"], z["R0"], z["t0"]


K4_SWEEP = (1, 7, 48, 144, 224, 225, 240, 384)   # both routes, partial panels
K4_TIMED = (48, 144, 384)    # K1/K3a's size, lm24's, the device-memory route


def _indefinite_system(n):
    """diag(4, -1, 9, 2, ...), b = (8, 5, 27, 1, ...): the negative pivot's
    entry must come out exactly 0, the others b / d."""
    d = np.full(n, 2.0, np.float32)
    d[:3] = [4.0, -1.0, 9.0]
    b = np.ones(n, np.float32)
    b[:3] = [8.0, 5.0, 27.0]
    return np.diag(d), b, np.where(d > 0, b / d, 0.0).astype(np.float32)


def check_k4(torch, cholesky):
    """K4 vs its plain version over K4_SWEEP (one-block route up to
    cholesky.SHARED_MAX_N, the device-memory route above) and on
    indefinite systems at n=48 and n=240; two launches bit-identical on
    both routes; times at K4_TIMED beside both library calls.  Returns
    the largest error at each n and the timings."""
    rng = np.random.default_rng(0)
    errs, timing = {}, {}
    for n in K4_SWEEP:
        A = rng.normal(size=(n, n)).astype(np.float32)
        S_np = A @ A.T + n * np.eye(n, dtype=np.float32)
        b_np = rng.normal(size=(n,)).astype(np.float32)
        S = torch.as_tensor(S_np, device="cuda")
        b = torch.as_tensor(b_np, device="cuda")
        x = cholesky.chol_solve(S, b)
        x2 = cholesky.chol_solve(S, b)
        x_plain = cholesky.chol_solve_plain(S, b)
        torch.cuda.synchronize()
        assert torch.isfinite(x).all(), n
        err = float((x - x_plain).abs().max())
        scale = float(x_plain.abs().max())
        same = torch.equal(x, x2)
        ok = err <= K4_TOL * max(1.0, scale) and same
        route = "shared" if n <= cholesky.SHARED_MAX_N else "device_memory"
        print(json.dumps({"check": "K4", "case": f"spd_n{n}", "route": route,
                          "max_abs_err": err,
                          "tol": K4_TOL * max(1.0, scale),
                          "two_launches_bit_identical": same, "pass": ok}))
        assert ok, f"K4 n={n}: err {err}, bit-identical {same}"
        errs[n] = max(errs.get(n, 0.0), err)
        if n in K4_TIMED:
            timing[n] = dict(
                ms=_time_ms(lambda: cholesky.chol_solve(S, b)),
                plain_ms=_time_ms(lambda: cholesky.chol_solve_plain(S, b),
                                  n=3 if n > 200 else 10, warm=1),
                library_ms=_time_ms(lambda: torch.cholesky_solve(
                    b[:, None], torch.linalg.cholesky(S))),
                library_ex_ms=_time_ms(lambda: torch.cholesky_solve(
                    b[:, None], torch.linalg.cholesky_ex(S)[0])),
                work=(4 * (n * n + 2 * n), _chol_ops(n)),
                n=n, route=route,
            )
    for n in (48, 240):
        S_np, b_np, want = _indefinite_system(n)
        S = torch.as_tensor(S_np, device="cuda")
        b = torch.as_tensor(b_np, device="cuda")
        x = cholesky.chol_solve(S, b)
        x_plain = cholesky.chol_solve_plain(S, b)
        torch.cuda.synchronize()
        err = float((x - x_plain).abs().max())
        ok = (float(x[1]) == 0.0 and float(x_plain[1]) == 0.0
              and float((x.cpu() - torch.as_tensor(want)).abs().max()) < 1e-5
              and err <= K4_TOL)
        print(json.dumps({"check": "K4", "case": f"indefinite_n{n}",
                          "max_abs_err": err, "skipped_entry": float(x[1]),
                          "pass": ok}))
        assert ok, f"K4 indefinite n={n}"
        errs[n] = max(errs.get(n, 0.0), err)
    return errs, timing


def check_k2(torch, pp, depth_render, K, K_120x160, masks, ref):
    """K2 vs depth_from_popup on real 480x640 pop-ups (with the sha256 of
    each output), the 120x160 test frame, and a 479x161 crop (rows
    crossing quads, a 3-pixel scalar tail); timed on frame 0."""
    worst, timing = 0.0, None
    pcfg = pp.PopupConfig()
    small = pp.PopupConfig(smooth_radius=3, nms_radius=5, min_cols=6)
    cases = [(str(i), masks[i], K, pcfg, i, 50.0) for i in (0, 40, 80, 120)]
    cases += [("120x160 frame 60", masks[60, ::4, ::4], K_120x160, small, 60,
               50.0),
              ("479x161 frame 40", masks[40, :479, :161], K, pcfg, 40, 50.0)]
    # the fused monocular path's clip (make_fused_vo_frame_fn)
    cases += [(f"{i} max_depth=40", masks[i], K, pcfg, i, 40.0)
              for i in (0, 40, 80, 120)]
    for name, m, K_, cfg, i, max_depth in cases:
        mask = torch.as_tensor(np.ascontiguousarray(m), device="cuda")
        R = torch.as_tensor(ref["R"][i], device="cuda")
        t = torch.as_tensor(ref["t"][i], device="cuda")
        res = pp.pop_up(K_, mask, R, t, cfg)
        d_k = depth_render.depth_render(K_, res, mask, R, t,
                                        max_depth=max_depth)
        d_p = pp.depth_from_popup(K_, res, mask, R, t, max_depth=max_depth)
        torch.cuda.synchronize()
        assert d_k.shape == mask.shape and torch.isfinite(d_k).all()
        diff = (d_k - d_p).abs()
        err = float(diff.max())
        n_bad = int((diff > K2_ATOL + K2_RTOL * d_p.abs()).sum())
        assert float(d_k.max()) <= max_depth
        print(json.dumps({"check": "K2", "frame": name,
                          "max_depth": max_depth, "max_abs_err": err,
                          "pixels_out_of_tol": n_bad,
                          "rtol": K2_RTOL, "atol": K2_ATOL,
                          "sha256": sha256_of(d_k), "pass": n_bad == 0}))
        assert n_bad == 0, f"K2 {name}: {n_bad} pixels out of tolerance"
        worst = max(worst, err)
        if name != "0":
            continue
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
    wk2, ck2, mk2 = fused_gn.fused_gn_solve(w0, factors, **kw)
    same = all(torch.equal(a, b) for a, b in
               ((wk.R, wk2.R), (wk.t, wk2.t), (wk.planes, wk2.planes),
                (ck, ck2), (mk, mk2)))
    ok = err <= K1_TOL and cost_err <= K1_TOL and m_err <= 1e-3 and same
    print(json.dumps({"check": "K1", "max_abs_err": err, "tol": K1_TOL,
                      "cost_rel_err": cost_err, "marg_rel_err": m_err,
                      "two_launches_bit_identical": same, "pass": ok}))
    assert ok, "K1 disagrees with its plain version or is not deterministic"
    # the kernel's own time: its first and last %globaltimer stamps
    n_st = 50
    stamps = torch.zeros((n_st, fused_gn.n_stamps(scfg.gn_iters)),
                         dtype=torch.int64, device="cuda")
    for r in range(n_st):
        fused_gn.fused_gn_solve(w0, factors, **kw, stamps=stamps[r])
    torch.cuda.synchronize()
    kernel_ms = float((stamps[:, -1] - stamps[:, 0]).double().mean()) / 1e6

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
        kernel_ms_stamped=kernel_ms,
        work=(nbytes, ops),
    )
    return err, timing


ACCEPT_TIE = 1e-4   # relative cost change below which an accept is a tie
MIN_HELD = 0.9      # a pop-up branch must not come before 90 % of a path
# a solver path must hold the accept decisions of at least this many
# keyframes (the production window's length)
ACCEPT_MIN_FRAMES = 8
# a frame is a keyframe when its motion since the last keyframe exceeds
# kf_trans (m) or kf_rot (rad); a keyframe decision that differs from the
# reference's is a tie when the port's motion lies within KF_TIE of those
# thresholds (at the production kf_trans = kf_rot = 0: a static camera,
# whose motion is zero to rounding, PERF.md)
KF_TIE = 1e-6


def accept_diffs(acc, cost, ref_acc, ref_cost, held=True):
    """(decisions that differ from the reference, those that are not f32
    ties, where those are).  A differing decision is a tie when the side
    that accepted lowered its cost by less than ACCEPT_TIE relative (or
    1e-9).  ``held`` masks the decisions compared."""
    diff = (acc != ref_acc) & held
    dec = np.where(acc, cost[:, :-1] - cost[:, 1:],
                   ref_cost[:, :-1] - ref_cost[:, 1:])
    base = np.where(acc, cost[:, :-1], ref_cost[:, :-1])
    tie = dec <= ACCEPT_TIE * np.abs(base) + 1e-9
    return int(diff.sum()), int((diff & ~tie).sum()), np.argwhere(diff & ~tie)


def same_start(cost, ref_cost):
    """Per decision (frames, iterations): whether every iteration up to
    it started from the reference's cost to within ACCEPT_TIE relative
    (or 1e-9), i.e. the two iterates have not parted yet."""
    start, ref_start = cost[:, :-1], ref_cost[:, :-1]
    same = np.abs(start - ref_start) <= ACCEPT_TIE * np.abs(ref_start) + 1e-9
    return np.logical_and.accumulate(same, axis=1)


def _first_false(ok) -> int:
    """Index of the first False in a 1-D bool array, else its length."""
    return int(np.argmin(ok)) if not ok.all() else len(ok)


def logging_slam_step(offline, log):
    """A stand-in for ``offline.slam_step`` (which both runners call) that
    logs each frame's keyframe inputs: the accumulated motion, the
    odometry and ``n_kf`` before and after."""
    step = offline.slam_step

    def logged(state, det, odom_R, odom_t, cfg, **kwargs):
        nxt, pose = step(state, det, odom_R, odom_t, cfg, **kwargs)
        log.append((state.acc_R, state.acc_t, odom_R, odom_t, state.n_kf,
                    nxt.n_kf))
        return nxt, pose

    return logged


def keyframe_decisions(torch, se3, log, cfg):
    """Per logged frame: (a keyframe was made, the margin of its motion
    over the thresholds, max(|t| - kf_trans, |log R| - kf_rot), computed
    as ``slam_step`` computes it)."""
    kf, margin = [], []
    for acc_R, acc_t, odom_R, odom_t, before, after in log:
        R, t = se3.se3_compose(acc_R, acc_t, odom_R, odom_t)
        margin.append(torch.maximum(
            torch.linalg.norm(t) - cfg.kf_trans,
            torch.linalg.norm(se3.so3_log(R)) - cfg.kf_rot))
        kf.append(after > before)
    return (torch.stack(kf).cpu().numpy(),
            torch.stack(margin).double().cpu().numpy())


def reference_keyframes(ref, anchor_key, end_key, n):
    """The reference's keyframe decision on each of the first ``n``
    frames: its ``n_kf`` after the frame (the next frame's recorded start
    state, or the end state's) above its ``n_kf`` before."""
    n_kf = np.append(ref[anchor_key], ref[end_key])[:n + 1]
    return n_kf[1:] > n_kf[:-1]


def hold_keyframes(kf, margin, ref_kf):
    """The keyframe decisions against the reference's: those that differ,
    each tie (``KF_TIE``) printed with its margin, and those that are not
    ties (held empty)."""
    diff = kf != ref_kf
    tie = diff & (np.abs(margin) <= KF_TIE)
    return {"keyframes": int(kf.sum()), "ref_keyframes": int(ref_kf.sum()),
            "tie_m_rad": KF_TIE,
            "ties": [{"frame": int(i), "keyframe": bool(kf[i]),
                      "ref_keyframe": bool(ref_kf[i]),
                      "margin": float(margin[i])}
                     for i in np.nonzero(tie)[0]],
            "differ_not_ties": [int(i) for i in np.nonzero(diff & ~tie)[0]]}


def _stack_np(xs):
    """A list of equal-shaped tensors as one numpy array."""
    return np.stack([x.cpu().numpy() for x in xs])


def _popup_same(pops, ref, key, n):
    """Per frame: (valid walls equal the reference's, and their column
    counts too)."""
    valid = _stack_np([v for v, _ in pops])
    n_pts = _stack_np([c for _, c in pops])
    ref_valid = ref[key + "popup_valid"][:n]
    same = (valid == ref_valid).all(-1)
    same_pts = same & ((n_pts == ref[key + "popup_n_points"][:n])
                       | ~ref_valid).all(-1)
    return same, same_pts, valid, n_pts


def run_path(torch, name, slam_mod, offline, se3, pp, run, counters, ref,
             gpu, scfg, n, inputs, convert, warm_frames=4, depth=False):
    """One path through ``run_sequence_chunked``, twice.  Returns the free
    run's launches.

    The free run: a short warm-up, then the launch counters zeroed, ``n``
    frames run from ``slam_init`` and the counters read.  Its trajectory
    is held over ``frames_held`` (the frames before the first frame whose
    set of valid walls differs from the reference's, at least MIN_HELD of
    the run; past it the two runs follow different wall sets, PERF.md
    "pop-up branch"), its end state's discrete fields and every frame's
    keyframe decision (up to a ``KF_TIE`` tie) against the reference's;
    a solver path's accept decisions may differ from the reference's only
    at an f32 tie (``ACCEPT_TIE``) over ``accept_frames_held`` (before
    its valid walls or their column counts first differ).

    The anchored run: every frame alone from the reference's own state
    before it (``anchor.*``), so each frame's inputs are the reference's.
    Each frame's pose within TRAJ_BOUND_M, each keyframe decision as
    above, the end state's discrete fields equal; a solver path's accept
    decisions may differ only at a tie on every frame whose pop-up equals
    the reference's in valid walls and column counts (at least MIN_HELD
    of the run and ACCEPT_MIN_FRAMES), each iteration's decision while
    the iterate still starts from the reference's cost (``same_start``:
    past that the two decide on different iterates; those that differ
    there are reported).  Each range that ends early, the
    frames whose pop-up differs and the error of every frame are
    reported, and the free run's accept differences over all of
    ``frames_held``."""
    masks_d, oR, ot, R0, t0, K, pcfg = inputs
    solver = scfg.solver
    rec, pops, kf_log = [], [], []
    pop_up, slam_step = pp.pop_up, offline.slam_step
    key = "" if name == "gn" else name + "_"

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
    offline.slam_step = logging_slam_step(offline, kf_log)
    try:
        warm = slam_mod.slam_init(scfg, R0, t0, device=masks_d.device)
        run(warm, masks_d[:warm_frames], oR[:warm_frames], ot[:warm_frames],
            K, pcfg, scfg, depth=depth)
        torch.cuda.synchronize()
        rec.clear(), pops.clear(), kf_log.clear()
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
        free = list(rec), list(pops), list(kf_log)
        rec.clear(), pops.clear(), kf_log.clear()
        # each frame again from the reference's own state before it
        t_a = []
        t0_run = time.perf_counter()
        for i in range(n):
            st_i = convert.slam_state_from_numpy(_anchor(ref, key, i),
                                                 masks_d.device)
            st_a, out_a = run(st_i, masks_d[i:i + 1], oR[i:i + 1],
                              ot[i:i + 1], K, pcfg, scfg, depth=depth)
            t_a.append(out_a[1])
        torch.cuda.synchronize()
        dt_anchored = time.perf_counter() - t0_run
        anchored_rec, anchored_pops, anchored_log = rec, pops, kf_log
        rec, pops, kf_log = free
    finally:
        pp.pop_up, offline.slam_step = pop_up, slam_step
        if solver != "gn":
            setattr(slam_mod, f"{solver}_solve", solve)
    Rs, ts = outs[0], outs[1]
    assert ts.shape == (n, 3) and Rs.shape == (n, 3, 3)
    for x in outs:
        assert torch.isfinite(x).all()
    if depth:
        assert outs[2].shape == masks_d[:n].shape
        assert float(outs[2].min()) >= 0.0 and float(outs[2].max()) <= 50.0

    def discrete_match(st):
        return {
            "n_kf": int(st.n_kf) == int(ref[key + "n_kf"]),
            "n_overflow": int(st.n_overflow) == int(ref[key + "n_overflow"]),
            "store_valid": bool((st.store.valid.cpu().numpy()
                                 == ref[key + "store_valid"]).all()),
        }

    ref_kf = reference_keyframes(ref, key + "anchor.n_kf", key + "n_kf", n)
    kf_free = hold_keyframes(*keyframe_decisions(torch, se3, kf_log, scfg),
                             ref_kf)
    kf_anch = hold_keyframes(
        *keyframe_decisions(torch, se3, anchored_log, scfg), ref_kf)
    # the free run
    t_ref, R_ref = ref[key + "t"][:n], ref[key + "R"][:n]
    t_frame = np.abs(ts.cpu().numpy() - t_ref).max(-1)
    R_err = float(np.abs(Rs.cpu().numpy() - R_ref).max())
    discrete = discrete_match(state)
    same, same_pts, valid, n_pts = _popup_same(pops, ref, key, n)
    held = _first_false(same)
    acc_held = _first_false(same_pts)
    # the anchored run
    t_a = torch.cat(t_a).cpu().numpy()
    anchored = np.abs(t_a - t_ref).max(-1)
    anchored_end = discrete_match(st_a)
    _, a_same_pts, _, _ = _popup_same(anchored_pops, ref, key, n)
    out = {
        "path": name, "solver": solver, "window_size": scfg.window_size,
        "frames": n, "seconds": dt, "frames_per_s": n / dt, "card": gpu,
        "launches": launches, "traj_max_abs_err_m": float(t_frame.max()),
        "traj_bound_m": TRAJ_BOUND_M, "frames_held": held,
        "accept_frames_held": acc_held,
        "traj_held_max_abs_err_m": float(t_frame[:held].max()),
        "frames_over_bound": [int(i) for i in
                              np.nonzero(t_frame > TRAJ_BOUND_M)[0]],
        "R_max_abs_err": R_err, "discrete_match": discrete,
        "keyframe_decisions": kf_free,
        "traj_abs_err_m_per_frame": t_frame.tolist(),
        "popup_frames_differ": [int(i) for i in np.nonzero(~same_pts)[0]],
        "anchored_seconds": dt_anchored,
        "anchored_traj_max_abs_err_m": float(anchored.max()),
        "anchored_discrete_match": anchored_end,
        "anchored_keyframe_decisions": kf_anch,
        "anchored_popup_frames_differ": [
            int(i) for i in np.nonzero(~a_same_pts)[0]],
        "anchored_traj_abs_err_m_per_frame": anchored.tolist(),
    }
    for what, f in (("popup_branch", held), ("popup_points_differ",
                                              acc_held)):
        if f < n:
            out[what] = {
                "frame": f,
                "valid": valid[f].astype(int).tolist(),
                "ref_valid": ref[key + "popup_valid"][f].astype(int)
                .tolist(),
                "n_points": n_pts[f].tolist(),
                "ref_n_points": ref[key + "popup_n_points"][f].tolist(),
            }

    def accept_line(acc, cost, on, frames, from_same_start=False):
        ref_cost = ref[key + "cost"][:n][on]
        held = same_start(cost[on], ref_cost) if from_same_start else True
        n_diff, n_clear, where = accept_diffs(
            acc[on], cost[on], ref[key + "accepted"][:n][on], ref_cost,
            held)
        line = {"frames": int(on.sum()),
                "decisions": int(np.broadcast_to(held, acc[on].shape).sum()),
                "differ": n_diff, "differ_not_ties": n_clear}
        if from_same_start:   # decisions after the iterates parted
            line["not_compared"] = int((~held).sum())
            line["differ_after_iterates_parted"] = int(
                ((acc[on] != ref[key + "accepted"][:n][on]) & ~held).sum())
        if n_clear:   # each differing decision that is not a tie
            line["not_ties_at"] = [
                {"frame": int(frames[f]), "iteration": int(k),
                 "accepted": bool(acc[on][f, k]),
                 "cost": cost[on][f].tolist(),
                 "ref_accepted": bool(ref[key + "accepted"][:n][on][f, k]),
                 "ref_cost": ref[key + "cost"][:n][on][f].tolist()}
                for f, k in where]
        return line

    if rec:
        acc = _stack_np([a for a, _ in rec])
        cost = _stack_np([c for _, c in rec])
        frame = np.arange(n)
        out["accept"] = accept_line(acc, cost, frame < acc_held,
                                    frame[:acc_held])
        out["accept_over_frames_held"] = accept_line(
            acc, cost, frame < held, frame[:held])
        acc_a = _stack_np([a for a, _ in anchored_rec])
        cost_a = _stack_np([c for _, c in anchored_rec])
        out["anchored_accept"] = accept_line(acc_a, cost_a, a_same_pts,
                                             np.nonzero(a_same_pts)[0],
                                             from_same_start=True)
    print(json.dumps(out))
    PATH_LINES[name] = out
    assert held >= MIN_HELD * n, f"{name}: pop-up branch at frame {held}"
    assert float(t_frame[:held].max()) <= TRAJ_BOUND_M, (
        f"{name}: trajectory off the reference: "
        f"{float(t_frame[:held].max())} m")
    assert all(discrete.values()), (name, discrete)
    assert not kf_free["differ_not_ties"], (name, "keyframes", kf_free)
    assert float(anchored.max()) <= TRAJ_BOUND_M, (
        f"{name}: a frame from the reference's state lands "
        f"{float(anchored.max())} m off it")
    assert all(anchored_end.values()), (name, anchored_end)
    assert not kf_anch["differ_not_ties"], (name, "keyframes", kf_anch)
    if rec:
        assert out["accept"]["differ_not_ties"] == 0, (
            f"{name}: accept decisions differ before the pop-up parts")
        a = out["anchored_accept"]
        assert a["frames"] >= max(MIN_HELD * n, ACCEPT_MIN_FRAMES), (
            f"{name}: the anchored pop-up parts on {n - a['frames']} frames")
        assert a["differ_not_ties"] == 0, (
            f"{name}: anchored accept decisions that are not ties differ")
    return launches


# fused depth on the stride-16 grid, over the frames whose pop-up equals
# the reference's in valid walls and column counts (at least MIN_HELD of
# the run; the depth render reads the walls' extents): the share of grid
# pixels within max(1 mm, 1e-3 relative) of the reference must be at
# least FUSED_GRID_FLOOR, and each frame's count of valid filter pixels
# within FUSED_VALID_COUNT of the reference's
FUSED_GRID_TOL_M, FUSED_GRID_TOL_REL = 1e-3, 1e-3
FUSED_GRID_FLOOR = 0.95
FUSED_VALID_COUNT = 3072          # 1 % of a 480x640 frame
VO_GRID = 16                      # make_torch_reference.py's grid stride
VO_CHUNK = 16                     # the runners' chunk in the free run


def _anchor(ref, key, i):
    """The reference's VO state before frame ``i`` (the ``anchor.*`` keys
    of corridor_ref_vo.npz) as nested dicts."""
    return _tree(ref, key + "anchor.", i)


def run_vo_path(torch, name, slam_mod, offline, se3, pp, fusion, convert,
                counters, ref, gpu, scfg, inputs, fused, warm_frames=4):
    """One monocular path (``make_chunked_vo_runner``, or with ``fused``
    ``make_chunked_fused_vo_runner``) on the masks alone, twice.

    The free run: ``run_masks_chunked`` over all frames from
    ``slam_init``, the launch counters zeroed just before and read just
    after; every frame's keyframe decision is held against the
    reference's (up to a ``KF_TIE`` tie, each printed), its per-frame
    trajectory error is reported, not held: the reference's own run parts
    from itself by 131 mm at frame 48 when its start moves by 1e-7 m, and
    the run follows another window from its first tie (PERF.md), so no
    run that is not bit-equal to it follows it over 144 frames.

    The anchored run, which is held: each frame runs through the same
    runner from the reference's own VO state before that frame
    (``anchor.*``; the fused runner carries its own filter from frame to
    frame).  Held as a solver path is held, over ``frames_held`` (the
    frames whose pop-up finds the reference's set of valid walls; at
    least MIN_HELD of them): the pose within TRAJ_BOUND_M, the VO step's
    ``n_matches`` and ``used_prior`` equal; on every frame the keyframe
    decision as in the free run, and the end state's discrete fields
    equal; with ``fused`` the fused depth on the stride-16 grid
    and the filter's valid-pixel count by the rule above, over the held
    frames whose pop-up column counts equal the reference's too.
    Returns the free run's launches and keyframes."""
    masks_d, _, _, R0, t0, K, pcfg = inputs
    n = masks_d.shape[0]
    dev = masks_d.device
    pops, vos, counts, kf_log = [], [], [], []
    pop_up, vo_step = pp.pop_up, offline.plane_vo_step
    slam_step = offline.slam_step
    fuse = fusion.fuse_observation

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        pops.append((res.valid, res.n_points))
        return res

    def recording_vo(*args, **kwargs):
        res = vo_step(*args, **kwargs)
        vos.append((res.n_matches, res.used_prior))
        return res

    def recording_fuse(*args, **kwargs):
        flt = fuse(*args, **kwargs)
        counts.append(flt.valid.sum())
        return flt

    def runner():
        if fused:
            return offline.make_chunked_fused_vo_runner(K, pcfg, scfg)
        return offline.make_chunked_vo_runner(K, pcfg, scfg)

    def fresh():
        slam = slam_mod.slam_init(scfg, R0, t0, device=dev)
        if fused:
            return offline.fused_vo_init(slam, scfg.max_det, *masks_d.shape[1:])
        return offline.vo_init(slam, scfg.max_det)

    def clear():
        pops.clear(), vos.clear(), counts.clear(), kf_log.clear()

    pp.pop_up, offline.plane_vo_step = recording_pop_up, recording_vo
    fusion.fuse_observation = recording_fuse
    offline.slam_step = logging_slam_step(offline, kf_log)
    try:
        offline.run_masks_chunked(runner(), fresh(), masks_d[:warm_frames])
        _sync(torch)
        # the free run
        run, st = runner(), fresh()
        _sync(torch)
        clear()
        for fn in counters.values():
            fn.launches = 0
        t0_run = time.perf_counter()
        st, outs = offline.run_masks_chunked(run, st, masks_d,
                                             chunk=VO_CHUNK)
        _sync(torch)
        dt = time.perf_counter() - t0_run
        launches = {k: fn.launches for k, fn in counters.items()}
        free_slam = st.vo.slam if fused else st.slam
        free_keyframes = int(free_slam.n_kf) - 1
        free_pops = [v for v, _ in pops]
        free_log = list(kf_log)
        # the anchored run
        clear()
        filt = fresh().filt if fused else None
        anch = []
        t0_run = time.perf_counter()
        for i in range(n):
            vs = convert.vo_state_from_numpy(_anchor(ref, name + "_", i),
                                             dev)
            st_a = offline.FusedVOState(vs, filt) if fused else vs
            st_a, out_a = run(st_a, masks_d[i:i + 1])
            if fused:
                filt = st_a.filt
            anch.append(out_a)
        _sync(torch)
        dt_anchored = time.perf_counter() - t0_run
    finally:
        pp.pop_up, offline.plane_vo_step = pop_up, vo_step
        fusion.fuse_observation = fuse
        offline.slam_step = slam_step
    key = name + "_"
    ref_kf = reference_keyframes(ref, key + "anchor.slam.n_kf",
                                 key + "n_kf", n)
    kf_free = hold_keyframes(*keyframe_decisions(torch, se3, free_log, scfg),
                             ref_kf)
    kf_anch = hold_keyframes(*keyframe_decisions(torch, se3, kf_log, scfg),
                             ref_kf)

    def traj(outs_):
        (Rs, ts), depth = outs_ if fused else (outs_, None)
        assert ts.shape == (n, 3) and Rs.shape == (n, 3, 3)
        assert torch.isfinite(ts).all() and torch.isfinite(Rs).all()
        if fused:
            assert depth.shape == masks_d.shape
            assert torch.isfinite(depth).all()
            assert float(depth.min()) >= 0.0 and float(depth.max()) <= 40.0
        return (np.abs(ts.cpu().numpy() - ref[key + "t"]).max(-1),
                np.abs(Rs.cpu().numpy() - ref[key + "R"]).max((-1, -2)),
                depth)

    # the free run: reported
    t_free, _, _ = traj(outs)
    free_valid = torch.stack(free_pops).cpu().numpy()
    free_part = _first_false((free_valid == ref[key + "popup_valid"])
                             .all(-1))
    # the anchored run: held
    t_frame, R_frame, depth = traj(offline._cat(anch))
    slam = st_a.vo.slam if fused else st_a.slam
    discrete = {
        "n_kf": int(slam.n_kf) == int(ref[key + "n_kf"]),
        "n_overflow": int(slam.n_overflow) == int(ref[key + "n_overflow"]),
        "store_valid": bool((slam.store.valid.cpu().numpy()
                             == ref[key + "store_valid"]).all()),
    }
    valid = torch.stack([v for v, _ in pops]).cpu().numpy()
    n_pts = torch.stack([c for _, c in pops]).cpu().numpy()
    ref_valid = ref[key + "popup_valid"]
    same = (valid == ref_valid).all(-1)
    same_pts = same & ((n_pts == ref[key + "popup_n_points"])
                       | ~ref_valid).all(-1)
    held = same
    n_match = torch.stack([m for m, _ in vos]).cpu().numpy()
    used = torch.stack([u for _, u in vos]).cpu().numpy()
    match_ok = ((n_match == ref[key + "n_matches"])
                & (used == ref[key + "used_prior"]))
    out = {
        "path": name, "solver": scfg.solver, "window_size": scfg.window_size,
        "frames": n, "seconds": dt, "frames_per_s": n / dt, "card": gpu,
        "launches": launches,
        "free_run": {
            "keyframes": free_keyframes,
            "keyframe_decisions": kf_free,
            "traj_max_abs_err_m": float(t_free.max()),
            "first_frame_over_bound": _first_false(t_free <= TRAJ_BOUND_M),
            "first_popup_branch": free_part,
            "traj_abs_err_m_per_frame": t_free.tolist()},
        "anchored_seconds": dt_anchored,
        "traj_bound_m": TRAJ_BOUND_M, "frames_held": int(held.sum()),
        "traj_held_max_abs_err_m": float(t_frame[held].max()),
        "R_held_max_abs_err": float(R_frame[held].max()),
        "frames_over_bound": [int(i) for i in
                              np.nonzero(t_frame > TRAJ_BOUND_M)[0]],
        "discrete_match": discrete,
        "keyframe_decisions": kf_anch,
        "vo_frames_differ": [int(i) for i in np.nonzero(~match_ok)[0]],
        "popup_frames_differ": [int(i) for i in np.nonzero(~same_pts)[0]],
        "popup_branch_frames": [int(i) for i in np.nonzero(~same)[0]],
        "traj_abs_err_m_per_frame": t_frame.tolist(),
    }
    grid_ok = cnt_ok = True
    if fused:
        grid = depth[:, ::VO_GRID, ::VO_GRID].cpu().numpy()
        ref_grid = ref[key + "depth_grid"]
        near = (np.abs(grid - ref_grid)
                <= np.maximum(FUSED_GRID_TOL_M,
                              FUSED_GRID_TOL_REL * np.abs(ref_grid)))
        cnt = torch.stack(counts).cpu().numpy()
        cnt_diff = np.abs(cnt.astype(np.int64)
                          - ref[key + "filter_valid_count"])
        on = same_pts
        share = float(near[on].mean())
        grid_ok = share >= FUSED_GRID_FLOOR and on.sum() >= MIN_HELD * n
        cnt_ok = int(cnt_diff[on].max()) <= FUSED_VALID_COUNT
        out.update(
            depth_grid_share_within=share,
            depth_grid_floor=FUSED_GRID_FLOOR,
            depth_grid_tol_m=FUSED_GRID_TOL_M,
            depth_grid_tol_rel=FUSED_GRID_TOL_REL,
            depth_grid_share_per_frame=near.mean(axis=(1, 2)).tolist(),
            depth_frames_held=int(on.sum()),
            filter_valid_count_max_diff=int(cnt_diff[on].max()),
            filter_valid_count_diff_per_frame=cnt_diff.tolist(),
            filter_valid_count_bound=FUSED_VALID_COUNT)
    print(json.dumps(out))
    assert held.sum() >= MIN_HELD * n, (
        f"{name}: pop-up branches leave {int(held.sum())} frames held")
    assert float(t_frame[held].max()) <= TRAJ_BOUND_M, (
        f"{name}: trajectory off the reference: "
        f"{float(t_frame[held].max())} m")
    assert match_ok[held].all(), (
        f"{name}: n_matches / used_prior differ at frames "
        f"{np.nonzero(~match_ok & held)[0].tolist()}")
    assert all(discrete.values()), (name, discrete)
    assert not kf_free["differ_not_ties"], (name, "free run", kf_free)
    assert not kf_anch["differ_not_ties"], (name, "anchored", kf_anch)
    assert grid_ok and cnt_ok, (f"{name}: fused depth off the reference",
                                out.get("depth_grid_share_within"),
                                out.get("filter_valid_count_max_diff"))
    return launches, free_keyframes


# ---- the TUM entry point (corridor_ref_tum.npz) ----

TUM_INTRINSICS = ("320", "320", "320", "240")   # the masks' camera
# the anchored smoother: keyframe poses of smooth_trajectory on the
# reference's recorder and final state (1.4e-6 m from the reference on the
# CPU, scripts/make_torch_reference.py's inputs; the card sums in another
# order)
SMOOTH_TOL_M = 1e-4
# the marginals: relative to each output's largest entry.  The port
# forms and inverts the reduced system in f64; the reference's own f32
# pose covariance lies 1.8e-3 from the f64 evaluation of the same formula
# on this state (the CPU), so the port is held against that f64
# evaluation (from the state in f64), within the larger of MARG_TOL and
# the reference's own distance from it, and its distance from the
# reference is reported
MARG_TOL = 1e-3
TUM_VO_FRAMES = 48


def _tree(ref, prefix, i=0):
    """The keys ``prefix...`` of a reference file as nested dicts, entry
    ``i`` of each."""
    tree = {}
    for k in ref.files:
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[k][i]
    return tree


def _rel_err(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _cli_json(main, argv):
    """(exit code, printed JSON) of an in-process CLI call."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, json.loads(buf.getvalue())


def run_tum_path(torch, se3, pp, offline, convert, counters, ref, gpu,
                 masks, root, dev="cuda"):
    """The ``tum`` path: ``cli.main(["run", "--config", "tum_fr3", ...])``
    in-process on the card over a TUM tree of the 144 masks written by
    the port's ``write_tum_tree`` (``gt_perturb``, smoothed), the launch
    counters zeroed just before and read just after.

    Held: the free run's trajectory within TRAJ_BOUND_M over the frames
    before its pop-up first finds another set of valid walls than the
    reference's (at least MIN_HELD of the run), ``n_kf`` exactly, every
    keyframe decision the reference's up to a printed ``KF_TIE`` tie; K1
    once a keyframe solve, K5 8 times (the smoother's iterations), no
    other kernel.  Then from the reference's recorded recorder and final
    state: ``smooth_trajectory`` (anchored) within SMOOTH_TOL_M of the
    reference's keyframes with K5 launched 8 times and no Schur or
    Cholesky kernel (the per-op ``solve_schur``), K5 held against its
    plain version at the smoother's shape, and ``recover_marginals`` as
    MARG_TOL says.  Reports frames/s, the smoother's ms and the host
    syncs per frame (``torch.cuda`` sync debug warnings, the recorder's
    device reads among them).  Returns (launches, K5's check at the
    smoother's shape)."""
    import warnings

    from pop_up_slam_tpu_torch import cli
    from pop_up_slam_tpu_torch.config import get_config
    from pop_up_slam_tpu_torch.factors.graph import linearize
    from pop_up_slam_tpu_torch.io.tum_fixture import write_tum_tree
    from pop_up_slam_tpu_torch.pipeline import smoothing
    from pop_up_slam_tpu_torch.pipeline.slam import _build_factors
    from pop_up_slam_tpu_torch.runners import tum_runner
    from pop_up_slam_tpu_torch.solver import recover_marginals

    seq = os.path.join(root, "tum")
    t0 = time.perf_counter()
    write_tum_tree(seq, masks, ref["gt_R"], ref["gt_t"], ref["stamps"])
    write_s = time.perf_counter() - t0
    n = masks.shape[0]
    scfg = get_config("tum_fr3").slam
    pops, kf_log, captured = [], [], {}
    pop_up, slam_step = pp.pop_up, offline.slam_step
    run_tum = tum_runner.run_tum_sequence

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        pops.append(res.valid)
        return res

    pp.pop_up = recording_pop_up
    offline.slam_step = logging_slam_step(offline, kf_log)
    tum_runner.run_tum_sequence = (
        lambda *a, **k: run_tum(*a, out=captured, **k))
    argv = ["run", "--config", "tum_fr3", "--device", dev,
            "--sequence-dir", seq, "--height", "480", "--width", "640",
            "--intrinsics", *TUM_INTRINSICS]
    try:
        torch.cuda.synchronize()
        for fn in counters.values():
            fn.launches = 0
        with warnings.catch_warnings(record=True) as syncs:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                rc, summary = _cli_json(cli.main, argv)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        pp.pop_up, offline.slam_step = pop_up, slam_step
        tum_runner.run_tum_sequence = run_tum
    n_syncs = sum("synchroniz" in str(w.message) for w in syncs)
    assert rc == 0, rc
    est_t, est_R = captured["est_t"], captured["est_R"]
    assert est_t.shape == (n, 3) and np.isfinite(est_t).all()
    assert np.isfinite(est_R).all() and np.isfinite(captured["kf_t"]).all()
    for x in captured["marginals"]:
        assert bool(torch.isfinite(x).all())
    rec, state = captured["recorder"], captured["state"]

    # the free run: frame k's estimate follows frame k-1's pop-up record
    valid = _stack_np(pops)
    same = (valid == ref["popup_valid"]).all(-1)
    held = 1 + _first_false(same)
    t_frame = np.abs(est_t - ref["est_t"]).max(-1)
    kf_ref = np.diff(np.concatenate([[0], ref["frame_kf"]])) > 0
    kf = hold_keyframes(*keyframe_decisions(torch, se3, kf_log, scfg),
                        kf_ref)
    solves = int(kf["keyframes"])
    out = {"path": "tum", "frames": n, "card": gpu, "summary": summary,
           "tree_write_s": write_s, "launches": launches,
           "keyframe_solves": solves, "n_kf": int(state.n_kf),
           "ref_n_kf": int(ref["n_kf"]),
           "frames_per_s": summary["frames_per_s"],
           "smooth_ms": summary["stage_timing"]["smooth"]["total_s"] * 1e3,
           "host_syncs": n_syncs, "host_syncs_per_frame": n_syncs / (n - 1),
           "recorder_pulls": rec.pulls,
           "recorder_pulls_per_frame": rec.pulls / (n - 1),
           "frames_held": held, "traj_bound_m": TRAJ_BOUND_M,
           "traj_held_max_abs_err_m": float(t_frame[:held].max()),
           "traj_max_abs_err_m": float(t_frame.max()),
           "traj_abs_err_m_per_frame": t_frame.tolist(),
           "keyframe_decisions": kf,
           "ate_rmse_m": summary["ate_rmse_m"],
           "ref_ate_rmse_m": float(ref["ate_rmse_m"]),
           "ate_filter_rmse_m": summary["ate_filter_rmse_m"],
           "ref_ate_filter_rmse_m": float(ref["ate_filter_rmse_m"])}
    if held < n:
        out["popup_branch"] = {
            "frame": held, "valid": valid[held - 1].astype(int).tolist(),
            "ref_valid": ref["popup_valid"][held - 1].astype(int).tolist()}

    # anchored: the smoother and the marginals on the reference's state
    dev = torch.device(dev)
    rec_a = smoothing.TrajectoryRecorder.restore(scfg, _tree(ref, "rec.",
                                                             slice(None)))
    st_a = convert.slam_state_from_numpy(_tree(ref, "state."), dev)
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    kf_R, kf_t, _ = smoothing.smooth_trajectory(rec_a, st_a, scfg, iters=8,
                                                damping=scfg.damping)
    torch.cuda.synchronize()
    smooth_ms = (time.perf_counter() - t0) * 1e3
    anchored_launches = {k: fn.launches for k, fn in counters.items()}
    smooth_err = float(np.abs(kf_t - ref["kf_t"]).max())
    smooth_R_err = float(np.abs(kf_R - ref["kf_R"]).max())
    marg = recover_marginals(linearize(st_a.window, _build_factors(st_a,
                                                                   scfg)),
                             st_a.window)
    st64 = _double(torch, st_a)
    marg64 = recover_marginals(linearize(st64.window, _build_factors(
        st64, scfg)), st64.window)
    marg_line = {}
    for name, a, b in zip(marg._fields, marg, marg64):
        r = torch.as_tensor(ref[name], device=dev)
        marg_line[name] = {
            "vs_ref": _rel_err(a, r), "vs_f64": _rel_err(a.double(), b),
            "ref_vs_f64": _rel_err(r.double(), b)}
    window, factors, N = smoothing.build_smoothing_problem(rec_a, st_a, scfg)
    out.update(
        anchored_smooth_launches=anchored_launches,
        anchored_smooth_ms=smooth_ms, anchored_keyframes=N,
        anchored_smooth_window=window.window_size,
        anchored_smooth_factors=int(factors.planes.valid.shape[0]),
        anchored_smooth_max_abs_err_m=smooth_err,
        anchored_smooth_R_max_abs_err=smooth_R_err,
        anchored_smooth_tol_m=SMOOTH_TOL_M, marginals=marg_line,
        marginals_tol=MARG_TOL)
    print(json.dumps(out))
    assert held >= MIN_HELD * n, f"tum: pop-up branch at frame {held}"
    assert out["traj_held_max_abs_err_m"] <= TRAJ_BOUND_M, out[
        "traj_held_max_abs_err_m"]
    assert out["n_kf"] == out["ref_n_kf"], (out["n_kf"], out["ref_n_kf"])
    assert not kf["differ_not_ties"], ("tum keyframes", kf)
    assert launches["fused_gn_solve"] == solves == out["n_kf"] - 1, launches
    assert launches["plane_terms"] == 8, launches
    for k in ("depth_render", "chol_solve", "schur_reduce_small",
              "schur_gemm"):
        assert launches[k] == 0, launches
    assert anchored_launches["plane_terms"] == 8, anchored_launches
    assert sum(anchored_launches.values()) == 8, anchored_launches
    assert smooth_err <= SMOOTH_TOL_M, smooth_err
    for name, m in marg_line.items():
        assert m["vs_f64"] <= max(MARG_TOL, m["ref_vs_f64"]), (name, m)
    return launches, (window, factors.planes)


def run_tum_vo_path(torch, counters, gpu, root, dev="cuda"):
    """The ``tum_vo`` path: ``run_tum_sequence(odometry="plane_vo")`` over
    the first TUM_VO_FRAMES frames of the tree ``run_tum_path`` wrote (no
    ground truth consumed), smoothed.  Held: K1 once a keyframe solve, K5
    8 times, no other kernel, every output finite; the ATE and ``n_kf``
    reported.  The plane-VO frame function itself is held frame by frame
    on the ``vo`` path."""
    from pop_up_slam_tpu_torch.config import get_config
    from pop_up_slam_tpu_torch.runners import tum_runner

    fx, fy, cx, cy = (float(v) for v in TUM_INTRINSICS)
    cfg = get_config("tum_fr3", sequence_dir=os.path.join(root, "tum"),
                     fx=fx, fy=fy, cx=cx, cy=cy)
    out = {}
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    summary = tum_runner.run_tum_sequence(cfg, odometry="plane_vo",
                                          max_frames=TUM_VO_FRAMES,
                                          device=dev, out=out)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    solves = int(out["state"].n_kf) - 1
    line = {"path": "tum_vo", "frames": TUM_VO_FRAMES, "card": gpu,
            "summary": summary, "launches": launches,
            "keyframe_solves": solves}
    print(json.dumps(line))
    for k in ("est_t", "est_R", "kf_t", "kf_R"):
        assert np.isfinite(out[k]).all(), k
    for x in out["marginals"]:
        assert bool(torch.isfinite(x).all())
    assert np.isfinite(summary["ate_rmse_m"]), summary
    assert launches["fused_gn_solve"] == solves >= 1, launches
    assert launches["plane_terms"] == 8, launches
    for k in ("depth_render", "chol_solve", "schur_reduce_small",
              "schur_gemm"):
        assert launches[k] == 0, launches
    return launches


def run_popup_demo_path(torch, pp, depth_render, counters, ref, gpu,
                        dev="cuda"):
    """The ``popup_demo`` path: ``cli.main(["run", "--config",
    "popup_demo"])`` on the card (480x640), counters zeroed around it: K2
    renders the depth once; ``n_wall_planes`` equals the reference CLI's,
    the depth error's median and p95 printed beside the reference's.
    Then K2 on that frame against its plain version.  Returns (launches,
    K2's max abs error)."""
    from pop_up_slam_tpu_torch import cli
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.io import synthetic

    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    rc, summary = _cli_json(cli.main, ["run", "--config", "popup_demo",
                                       "--device", dev])
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counters.items()}
    ref_line = {k: float(ref[f"popup_demo_{k}"]) for k in (
        "n_wall_planes", "depth_median_rel_err", "depth_p95_rel_err")}
    # K2 against its plain version on the same frame
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device=dev)
    R, t = synthetic.corridor_trajectory(1, device=dev)
    labels, _ = synthetic.render_frame(K, R[0], t[0],
                                       synthetic.corridor_world(device=dev),
                                       480, 640)
    mask = labels == synthetic.LABEL_GROUND
    res = pp.pop_up(K, mask, R[0], t[0], pp.PopupConfig())
    d_k = depth_render.depth_render(K, res, mask, R[0], t[0])
    d_p = pp.depth_from_popup(K, res, mask, R[0], t[0])
    torch.cuda.synchronize()
    diff = (d_k - d_p).abs()
    n_bad = int((diff > K2_ATOL + K2_RTOL * d_p.abs()).sum())
    line = {"path": "popup_demo", "card": gpu, "summary": summary,
            "reference": ref_line, "launches": launches,
            "k2_max_abs_err": float(diff.max()), "k2_pixels_out_of_tol":
            n_bad}
    print(json.dumps(line))
    assert rc == 0 and n_bad == 0, line
    assert summary["n_wall_planes"] == int(ref_line["n_wall_planes"]), line
    assert launches["depth_render"] == 1, launches
    assert sum(launches.values()) == 1, launches
    return launches, float(diff.max())


# ---- the slice of the batched and pipelined runners, the learned
# segmenter and the native loader ----

PATH_LINES = {}           # each run_path line by path name (frames/s)
PROFILE_FRAMES = 16       # frames profiled for the launches a frame


def launches_per_frame(torch, fn, frames: int) -> float:
    """Device kernels launched per frame by ``fn()`` (which runs
    ``frames`` frames and synchronizes), counted by the profiler: every
    kernel of the run, PyTorch's and the port's, no copies or memsets."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    return len(kernels) / frames


def k5_device_ms(torch, pj, window, pf, n: int = 50) -> float:
    """K5's device time per call (ms), from the profiler: the kernel's own
    span, summed over ``n`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    pj.plane_terms(window, pf)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            pj.plane_terms(window, pf)
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == DeviceType.CUDA
             and "plane_terms_kernel" in e.name]
    assert len(spans) == n, len(spans)
    return sum(spans) / n / 1e3


def run_batched_path(torch, batched, offline, se3, convert, counters, ref,
                     gpu, scfg, inputs, n):
    """The ``batched`` path: ``run_sequence_batched`` over the ``n``
    frames (chunks of 16, depth off), against ``corridor_ref_batched.npz``
    (the JAX batched runner, fused GN body on).

    Held: the free run (counters zeroed just before, read just after) to
    its first pop-up branch (the first frame whose valid walls differ from
    the reference's batched pop-up; not before MIN_HELD of the run) within
    TRAJ_BOUND_M, its end state's ``n_kf``, ``n_overflow``, ``store.valid``
    exactly, every keyframe decision the reference's (up to a KF_TIE
    tie); K1 once a frame and no other kernel.  Anchored: each chunk from
    the reference's recorded chunk-start state, every frame within
    TRAJ_BOUND_M.  The batched pop-up at the reference's dead-reckoned
    poses equal to the reference's (valid walls, column counts) on every
    frame.  Reports frames/s and launches a frame beside the chunked
    runner's (depth off) in this run.  Returns the free run's launches."""
    masks_d, oR, ot, R0, t0, K, pcfg = inputs
    pops, kf_log = [], []
    pop_up, step = batched.batched_pop_up, batched.slam_step

    def recording_pop_up(*args, **kwargs):
        res, det = pop_up(*args, **kwargs)
        pops.append((res.valid, res.n_points))
        return res, det

    from pop_up_slam_tpu_torch.pipeline import slam_init

    def run(frames):
        st = slam_init(scfg, R0, t0, device=masks_d.device)
        out = batched.run_sequence_batched(st, masks_d[:frames],
                                           oR[:frames], ot[:frames], K,
                                           pcfg, scfg, chunk=16)
        torch.cuda.synchronize()
        return out

    def chunked(frames):
        st = slam_init(scfg, R0, t0, device=masks_d.device)
        out = offline.run_sequence_chunked(st, masks_d[:frames],
                                           oR[:frames], ot[:frames], K,
                                           pcfg, scfg, chunk=16)
        torch.cuda.synchronize()
        return out

    run(16)
    batched.batched_pop_up = recording_pop_up
    batched.slam_step = logging_slam_step(batched, kf_log)
    try:
        for fn in counters.values():
            fn.launches = 0
        t0_run = time.perf_counter()
        state, (Rs, ts) = run(n)
        dt = time.perf_counter() - t0_run
        launches = {k: fn.launches for k, fn in counters.items()}
    finally:
        batched.batched_pop_up, batched.slam_step = pop_up, step
    assert torch.isfinite(ts).all() and torch.isfinite(Rs).all()
    # the chunked runner and the batched one again, in turns, on this card
    fps = {"batched": [n / dt], "chunked_no_depth": []}
    for name, fn in (("chunked_no_depth", chunked), ("batched", run),
                     ("chunked_no_depth", chunked)):
        t0_run = time.perf_counter()
        fn(n)
        fps[name].append(n / (time.perf_counter() - t0_run))
    per_frame = {
        "batched": launches_per_frame(torch, lambda: run(PROFILE_FRAMES),
                                      PROFILE_FRAMES),
        "chunked_no_depth": launches_per_frame(
            torch, lambda: chunked(PROFILE_FRAMES), PROFILE_FRAMES)}

    valid = torch.cat([v for v, _ in pops]).cpu().numpy()
    same = (valid == ref["popup_valid"][:n]).all(-1)
    held = _first_false(same)
    t_err = np.abs(ts.cpu().numpy() - ref["t"][:n]).max(-1)
    discrete = {
        "n_kf": int(state.n_kf) == int(ref["n_kf"]),
        "n_overflow": int(state.n_overflow) == int(ref["n_overflow"]),
        "store_valid": bool((state.store.valid.cpu().numpy()
                             == ref["store_valid"]).all())}
    n_kf = ref["frame_n_kf"][:n]
    ref_kf = n_kf > np.append(ref["chunk.n_kf"][0], n_kf[:-1])
    kf = hold_keyframes(*keyframe_decisions(torch, se3, kf_log, scfg),
                        ref_kf)
    # each chunk from the reference's state at its start
    run_chunk = batched.make_batched_runner(K, pcfg, scfg)
    t_a = []
    for c in range(0, n, 16):
        st = convert.slam_state_from_numpy(_tree(ref, "chunk.", c // 16),
                                           masks_d.device)
        st, (_, t_c) = run_chunk(st, masks_d[c:c + 16],
                                 torch.as_tensor(oR[c:c + 16],
                                                 device=masks_d.device),
                                 torch.as_tensor(ot[c:c + 16],
                                                 device=masks_d.device))
        t_a.append(t_c)
    anchored = np.abs(torch.cat(t_a).cpu().numpy() - ref["t"][:n]).max(-1)
    # the batched pop-up at the reference's dead-reckoned poses
    differ = []
    for c in range(0, n, 16):
        res, _ = batched.batched_pop_up(
            K, masks_d[c:c + 16],
            torch.as_tensor(ref["dr_R"][c:c + 16], device=masks_d.device),
            torch.as_tensor(ref["dr_t"][c:c + 16], device=masks_d.device),
            pcfg, scfg.max_det)
        same_c = ((res.valid.cpu().numpy() == ref["popup_valid"][c:c + 16])
                  & (res.n_points.cpu().numpy()
                     == ref["popup_n_points"][c:c + 16])).all(-1)
        differ += [c + int(i) for i in np.nonzero(~same_c)[0]]
    out = {"path": "batched", "frames": n, "chunk": 16, "card": gpu,
           "launches": launches, "frames_per_s": fps,
           "launches_per_frame": per_frame,
           "main_path_frames_per_s": PATH_LINES["gn"]["frames_per_s"],
           "traj_bound_m": TRAJ_BOUND_M, "frames_held": held,
           "traj_held_max_abs_err_m": float(t_err[:held].max()),
           "traj_max_abs_err_m": float(t_err.max()),
           "discrete_match": discrete, "keyframe_decisions": kf,
           "anchored_traj_max_abs_err_m": float(anchored.max()),
           "popup_at_reference_poses_differ": differ,
           "traj_abs_err_m_per_frame": t_err.tolist()}
    print(json.dumps(out))
    assert held >= MIN_HELD * n, f"batched: pop-up branch at frame {held}"
    assert float(t_err[:held].max()) <= TRAJ_BOUND_M, out[
        "traj_held_max_abs_err_m"]
    assert all(discrete.values()), discrete
    assert not kf["differ_not_ties"], kf
    assert float(anchored.max()) <= TRAJ_BOUND_M, float(anchored.max())
    assert not differ, f"batched pop-up parts at frames {differ}"
    return launches


def run_pipelined_paths(torch, pipelined, offline, ate_rmse, synthetic,
                        counters, gpu, scfg, inputs, n):
    """The ``pipelined`` (``stale_prediction=False``) and
    ``pipelined_stale`` paths over the ``n`` frames: the front end on a
    side stream.  Held: the non-stale run's poses equal bit for bit
    (sha256) to the sequential frame loop (``offline.make_frame_fn``) on
    the card, twice, K1 once a frame; the stale run's poses finite, its
    ATE against the ground truth (the masks' own poses) below max(2
    ATE_seq, 0.05 m) (``tests/test_pipelined.py:82``), its ``n_kf`` and
    K1's launches the sequential run's.  Returns both runs' launches."""
    from pop_up_slam_tpu_torch.pipeline import slam_init

    masks_d, oR, ot, R0, t0, K, pcfg = inputs
    dev = masks_d.device
    oR_d = torch.as_tensor(oR, device=dev)
    ot_d = torch.as_tensor(ot, device=dev)
    # the masks' own poses (scripts/gen_bench_inputs.py rendered frame i
    # at pose i + 1 of the walk)
    gt_t = synthetic.corridor_trajectory(masks_d.shape[0] + 1,
                                         device="cpu")[1][1:n + 1]

    def frames(k):
        return ((masks_d[i], oR_d[i], ot_d[i]) for i in range(k))

    def sequential(k):
        frame = offline.make_frame_fn(K, pcfg, scfg)
        st = slam_init(scfg, R0, t0, device=dev)
        Rs, ts = [], []
        for i in range(k):
            st, (R, t) = frame(st, (masks_d[i], oR_d[i], ot_d[i]))
            Rs.append(R)
            ts.append(t)
        torch.cuda.synchronize()
        return st, torch.stack(Rs), torch.stack(ts)

    def piped(k, stale):
        st = slam_init(scfg, R0, t0, device=dev)
        poses = list(pipelined.run_pipelined(st, frames(k), K, pcfg, scfg,
                                             stale_prediction=stale))
        torch.cuda.synchronize()
        return (torch.stack([R for R, _ in poses]),
                torch.stack([t for _, t in poses]))

    piped(16, False)
    piped(16, True)
    seq_state, R_seq, t_seq = sequential(n)
    sha_seq = sha256_of(R_seq, t_seq)
    runs, launches, fps = [], {}, {}
    for name, stale in (("pipelined", False), ("pipelined", False),
                        ("pipelined_stale", True)):
        for fn in counters.values():
            fn.launches = 0
        t0_run = time.perf_counter()
        R, t = piped(n, stale)
        fps.setdefault(name, []).append(n / (time.perf_counter() - t0_run))
        launches[name] = {k: fn.launches for k, fn in counters.items()}
        runs.append((R, t))
    shas = [sha256_of(R, t) for R, t in runs[:2]]
    R_st, t_st = runs[2]
    ate_seq = ate_rmse(gt_t.numpy(), t_seq.cpu().numpy())[0]
    ate_stale = ate_rmse(gt_t.numpy(), t_st.cpu().numpy())[0]
    ate_bound = max(2.0 * ate_seq, 0.05)
    t0_run = time.perf_counter()
    sequential(n)
    fps["sequential"] = [n / (time.perf_counter() - t0_run)]
    per_frame = {
        "pipelined_stale": launches_per_frame(
            torch, lambda: piped(PROFILE_FRAMES, True), PROFILE_FRAMES),
        "sequential": launches_per_frame(
            torch, lambda: sequential(PROFILE_FRAMES), PROFILE_FRAMES)}
    k1_seq = int(seq_state.n_kf) - 1
    out = {"path": "pipelined", "frames": n, "card": gpu,
           "sha256_sequential": sha_seq, "sha256_pipelined": shas,
           "bit_equal": [s == sha_seq for s in shas],
           "launches": launches, "frames_per_s": fps,
           "launches_per_frame": per_frame,
           "main_path_frames_per_s": PATH_LINES["gn"]["frames_per_s"],
           "stale_ate_m": float(ate_stale), "sequential_ate_m":
           float(ate_seq), "stale_ate_bound_m": ate_bound,
           "stale_traj_max_abs_diff_m": float(
               (t_st - t_seq).abs().max()),
           "sequential_keyframes": k1_seq}
    print(json.dumps(out))
    assert all(out["bit_equal"]), out["bit_equal"]
    for name in ("pipelined", "pipelined_stale"):
        c = launches[name]
        assert c["fused_gn_solve"] == k1_seq == n, (name, c, k1_seq)
        for k in counters:
            if k != "fused_gn_solve":
                assert c[k] == 0, (name, c)
    assert torch.isfinite(R_st).all() and torch.isfinite(t_st).all()
    assert ate_stale < ate_bound, (ate_seq, ate_stale)
    return launches["pipelined"], launches["pipelined_stale"]


SEGNET_FRAMES = 4
SEGNET_SEED = 8
SEGNET_IOU = 0.9          # tests/test_models.py:109
# the card's logits (cuDNN, bf16) against flax's recorded ones and the
# CPU evaluation's: |d| <= SEGNET_TOL * (1 + |l|) (measured on the H100:
# 5.3e-3 against the CPU, 1.3e-3 against flax, PERF.md); masks may differ
# only where the CPU logit lies within SEGNET_MARGIN of the threshold,
# ten times the largest difference that tolerance allows near it
SEGNET_TOL = 1e-2
SEGNET_MARGIN = 0.1


def run_segnet_path(torch, seg, synthetic, pp, counters, ref, gpu,
                    dev="cuda"):
    """The ``segnet`` path: the pretrained SegNetLite on the card over
    SEGNET_FRAMES synthetic 480x640 corridor renders (the port's renderer,
    colour draws from a seeded ``torch.Generator``).  Held: IoU against
    the renders' ground truth above SEGNET_IOU; the card's logits against
    the same module on the CPU (f32 parameters, bf16 compute) and against
    flax's logits recorded on two 64x96 frames, as SEGNET_TOL and
    SEGNET_MARGIN say (the largest logit difference and the largest
    |logit| where the masks differ are printed); each mask then through
    ``pop_up`` and ``render_depth``: K2 once a frame.  Returns the
    launches of the pop-up and depth loop."""
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics

    model, params, meta = seg.load_pretrained_segnet(device=dev)
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0, device=dev)
    world = synthetic.corridor_world(device=dev)
    Rs, ts = synthetic.corridor_trajectory(SEGNET_FRAMES + 2, device=dev)
    g = torch.Generator().manual_seed(SEGNET_SEED)
    labels = torch.stack([
        synthetic.render_frame(K, Rs[i + 1], ts[i + 1], world, 480, 640)[0]
        for i in range(SEGNET_FRAMES)])
    rgb = torch.stack([synthetic.render_rgb(lab, generator=g)
                       for lab in labels])
    gt = labels == synthetic.LABEL_GROUND
    with torch.no_grad():
        ms = (_time_ms(lambda: model(rgb), n=5, warm=2) / SEGNET_FRAMES
              if dev == "cuda" else None)
        logits = model(rgb)
        cpu_model, _, _ = seg.load_pretrained_segnet(device="cpu")
        t0_cpu = time.perf_counter()
        logits_cpu = cpu_model(rgb.cpu())
        cpu_ms = (time.perf_counter() - t0_cpu) * 1e3 / SEGNET_FRAMES
        small = torch.as_tensor(ref["segnet_rgb8"], device=dev) / 255.0
        logits_small = model(small.float()).cpu().numpy()
    mask = logits > 0
    assert torch.equal(mask, seg.predict_mask(model, params, rgb))
    iou = [float((mask[i] & gt[i]).sum() / (mask[i] | gt[i]).sum())
           for i in range(SEGNET_FRAMES)]
    l_card, l_cpu = logits.cpu().numpy(), logits_cpu.numpy()
    rel = np.abs(l_card - l_cpu) / (1 + np.abs(l_cpu))
    differ = (l_card > 0) != (l_cpu > 0)
    flax = ref["segnet_logits"]
    rel_flax = np.abs(logits_small - flax) / (1 + np.abs(flax))
    differ_flax = (logits_small > 0) != (flax > 0)
    for fn in counters.values():
        fn.launches = 0
    depths = []
    for i in range(SEGNET_FRAMES):
        res = pp.pop_up(K, mask[i], Rs[i + 1], ts[i + 1], pp.PopupConfig())
        depths.append(pp.render_depth(K, res, mask[i], Rs[i + 1], ts[i + 1]))
    _sync(torch)
    launches = {k: fn.launches for k, fn in counters.items()}
    depth = torch.stack(depths)
    out = {"path": "segnet", "frames": SEGNET_FRAMES, "shape": [480, 640],
           "card": gpu, "meta": meta, "iou": iou, "iou_gate": SEGNET_IOU,
           "card_ms_per_frame": ms, "cpu_ms_per_frame": cpu_ms,
           "vs_cpu_max_rel_diff": float(rel.max()),
           "vs_cpu_max_abs_diff": float(np.abs(l_card - l_cpu).max()),
           "vs_cpu_mask_pixels_differ": int(differ.sum()),
           "vs_cpu_max_abs_logit_where_differ": float(
               np.abs(l_cpu[differ]).max()) if differ.any() else 0.0,
           "vs_flax_max_rel_diff": float(rel_flax.max()),
           "vs_flax_max_abs_diff": float(np.abs(logits_small - flax).max()),
           "vs_flax_mask_pixels_differ": int(differ_flax.sum()),
           "tol_rel": SEGNET_TOL, "mask_margin": SEGNET_MARGIN,
           "launches": launches}
    print(json.dumps(out))
    assert np.isfinite(l_card).all() and torch.isfinite(depth).all()
    assert depth.shape == (SEGNET_FRAMES, 480, 640)
    assert min(iou) > SEGNET_IOU, iou
    assert rel.max() <= SEGNET_TOL and rel_flax.max() <= SEGNET_TOL, out
    assert (np.abs(l_cpu[differ]) < SEGNET_MARGIN).all(), out
    assert (np.abs(flax[differ_flax]) < SEGNET_MARGIN).all(), out
    assert launches["depth_render"] == SEGNET_FRAMES, launches
    assert sum(launches.values()) == SEGNET_FRAMES, launches
    return launches


def run_native_path(native_loader, png, tree, gpu):
    """The ``native`` phase: the TUM tree of the ``tum`` path read through
    ``NativeSequence.stream(num_threads=2)``, each frame's pixels equal to
    ``io/png.py``'s decode of the same file; the committed libpng-written
    fixtures (every row filter) decoded by both codecs equal to their
    stored pixels.  Reports decode ms a frame of both codecs on each."""
    data = os.path.join(REPO, "pop_up_slam_tpu_torch", "data")
    with native_loader.NativeSequence(tree) as seq:
        paths = [seq.rgb_path(i) for i in range(seq.num_rgb)]
        t0 = time.perf_counter()
        frames = [img for _, img in seq.stream(num_threads=2)]
        stream_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    t0 = time.perf_counter()
    for p in paths:
        native_loader.decode_png(p)
    native_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    t0 = time.perf_counter()
    plain = [png.read_png(p) for p in paths]
    plain_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    tree_equal = len(frames) == len(plain) and all(
        np.array_equal(a, b) for a, b in zip(frames, plain))
    stored = np.load(os.path.join(data, "png_fixture_pixels.npz"))
    fixtures = {}
    for name in ("rgb", "gray16"):
        p = os.path.join(data, f"png_fixture_{name}.png")
        t0 = time.perf_counter()
        a = native_loader.decode_png(p)
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = png.read_png(p)
        t_plain = time.perf_counter() - t0
        fixtures[name] = {
            "shape": list(a.shape), "dtype": str(a.dtype),
            "row_filters": np.bincount(stored[f"{name}_filters"],
                                       minlength=5).tolist(),
            "native_equal": bool(np.array_equal(a, stored[name])),
            "plain_equal": bool(np.array_equal(b, stored[name])),
            "native_ms": t_nat * 1e3, "plain_ms": t_plain * 1e3}
    out = {"path": "native", "card": gpu, "frames": len(paths),
           "frame_shape": list(frames[0].shape), "tree_equal": tree_equal,
           "stream_ms_per_frame": stream_ms,
           "native_decode_ms_per_frame": native_ms,
           "plain_decode_ms_per_frame": plain_ms, "fixtures": fixtures}
    print(json.dumps(out))
    assert tree_equal
    for f in fixtures.values():
        assert f["native_equal"] and f["plain_equal"], fixtures

# ---- the multi-device slice ----

SHARDED_BLOCK = 16        # frames a block of the sharded runner
# the two gloo ranks' device: PyTorch's gloo backend takes CUDA tensors
# for all_reduce (the only collective of the two strategies held there)
GLOO2_DEVICE = "cuda:0"
GLOO2_TIMEOUT_S = 300
GLOO2_ITERS, GLOO2_DAMPING = 3, 1e-6     # tests/test_parallel.py's solve
GLOO2_TOL = 1e-3          # tests/test_parallel.py:54-58
GLOO2_MAP_BLOCK_TOL = 2e-3   # tests/test_parallel_ext.py:50-59
# the CLI's single_host ATE against the JAX CLI's (recorded): the odometry
# noise comes from another generator, and over seeds 0-5 the port's own
# ATE on the CPU spans 0.1525-0.319 m (PERF.md); the bound takes that
# spread
SINGLE_HOST_ATE_BOUND_M = 0.12
SMOOTHER_MESH_TOL = 1e-4
SEGNET_TRAIN_STEPS = 400
SEGNET_TRAIN_IOU = 0.9    # tests/test_models.py:81, :112-118
# the first step's loss on the card against the CPU module's: one mean
# over 98,304 bf16 logits (cuDNN's bf16 convolutions against the CPU's)
SEGNET_TRAIN_LOSS_RTOL = 5e-3


def _recorded_problem(convert, ref_b, dev):
    """The reference's ``build_corridor_problem`` output recorded in
    ``corridor_ref_batched.npz``: (window, factors) on ``dev``."""
    return (convert.window_from_numpy(_tree(ref_b, "problem.window."), dev),
            convert.factors_from_numpy(_tree(ref_b, "problem.factors."),
                                       dev))


def run_sharded_path(torch, sharded, pp, offline, se3, convert, counters,
                     ref, gpu, scfg, inputs, n, mesh):
    """The ``sharded`` path: ``run_sequence_sharded`` over the ``n``
    frames (blocks of SHARDED_BLOCK) on ``mesh`` (NCCL, a world of one on
    this card), against ``corridor_ref_sharded.npz`` (the JAX sharded
    runner on a 2-device CPU mesh).

    Held: the free run (counters and collectives zeroed just before, read
    just after) to its first pop-up branch (not before MIN_HELD of the
    run) within TRAJ_BOUND_M; every frame's keyframe decision, the end
    state's ``n_kf``, ``n_overflow`` and ``store.valid`` exactly; K5 twice
    a keyframe (each GN iteration of the factor-sharded solve, on the
    rank's block) and no other kernel.  Anchored: each block from the
    reference's recorded block-start state, every frame within
    TRAJ_BOUND_M.  The DP pop-up at the reference's predicted poses equal
    to its recorded walls (valid, column counts) on every frame.  Reports
    ``all_reduce`` calls a frame, frames/s and launches a frame beside the
    chunked runner's (depth off) in this call.  Returns the free run's
    launches."""
    from pop_up_slam_tpu_torch.parallel import distributed
    from pop_up_slam_tpu_torch.pipeline import slam_init

    masks_d, oR, ot, R0, t0, K, pcfg = inputs
    dev = masks_d.device
    pops, kf_log = [], []
    sharded_popup, step = sharded.sharded_popup, sharded.slam_step

    def recording_popup(*args, **kwargs):
        res, det = sharded_popup(*args, **kwargs)
        pops.append(res.valid)
        return res, det

    def run(frames):
        st = slam_init(scfg, R0, t0, device=dev)
        out = sharded.run_sequence_sharded(st, masks_d[:frames], oR[:frames],
                                           ot[:frames], K, pcfg, scfg, mesh,
                                           block=SHARDED_BLOCK)
        _sync(torch)
        return out

    def chunked(frames):
        st = slam_init(scfg, R0, t0, device=dev)
        out = offline.run_sequence_chunked(st, masks_d[:frames],
                                           oR[:frames], ot[:frames], K,
                                           pcfg, scfg, chunk=SHARDED_BLOCK)
        _sync(torch)
        return out

    run(SHARDED_BLOCK)
    sharded.sharded_popup = recording_popup
    sharded.slam_step = logging_slam_step(sharded, kf_log)
    try:
        for fn in counters.values():
            fn.launches = 0
        for k in distributed.collective_calls:
            distributed.collective_calls[k] = 0
        t0_run = time.perf_counter()
        state, (Rs, ts) = run(n)
        dt = time.perf_counter() - t0_run
        launches = {k: fn.launches for k, fn in counters.items()}
        collectives = dict(distributed.collective_calls)
    finally:
        sharded.sharded_popup, sharded.slam_step = sharded_popup, step
    assert torch.isfinite(ts).all() and torch.isfinite(Rs).all()
    fps = {"sharded": [n / dt], "chunked_no_depth": []}
    for name, fn in (("chunked_no_depth", chunked), ("sharded", run),
                     ("chunked_no_depth", chunked)):
        t0_run = time.perf_counter()
        fn(n)
        fps[name].append(n / (time.perf_counter() - t0_run))
    per_frame = {
        "sharded": launches_per_frame(torch, lambda: run(PROFILE_FRAMES),
                                      PROFILE_FRAMES),
        "chunked_no_depth": launches_per_frame(
            torch, lambda: chunked(PROFILE_FRAMES), PROFILE_FRAMES)}

    valid = torch.cat(pops).cpu().numpy()
    held = _first_false((valid == ref["popup_valid"][:n]).all(-1))
    t_err = np.abs(ts.cpu().numpy() - ref["t"][:n]).max(-1)
    discrete = {
        "n_kf": int(state.n_kf) == int(ref["n_kf"]),
        "n_overflow": int(state.n_overflow) == int(ref["n_overflow"]),
        "store_valid": bool((state.store.valid.cpu().numpy()
                             == ref["store_valid"]).all())}
    n_kf = ref["frame_n_kf"][:n]
    ref_kf = n_kf > np.append(ref["block.n_kf"][0], n_kf[:-1])
    kf_dec, margin = keyframe_decisions(torch, se3, kf_log, scfg)
    kf = hold_keyframes(kf_dec, margin, ref_kf)
    keyframes = int(kf_dec.sum())
    # each block from the reference's state at its start
    run_block = sharded.make_sharded_runner(K, pcfg, scfg, mesh)
    oR_d = torch.as_tensor(oR, device=dev)
    ot_d = torch.as_tensor(ot, device=dev)
    t_a = []
    for c in range(0, n, SHARDED_BLOCK):
        sl = slice(c, c + SHARDED_BLOCK)
        st = convert.slam_state_from_numpy(
            _tree(ref, "block.", c // SHARDED_BLOCK), dev)
        st, (_, t_c) = run_block(st, masks_d[sl], oR_d[sl], ot_d[sl])
        t_a.append(t_c)
    anchored = np.abs(torch.cat(t_a).cpu().numpy() - ref["t"][:n]).max(-1)
    # the DP pop-up at the reference's predicted poses
    differ = []
    for c in range(0, n, SHARDED_BLOCK):
        sl = slice(c, c + SHARDED_BLOCK)
        res = sharded.sharded_popup(
            lambda m, R_, t_: pp.pop_up(K, m, R_, t_, pcfg), masks_d[sl],
            torch.as_tensor(ref["popup_R"][sl], device=dev),
            torch.as_tensor(ref["popup_t"][sl], device=dev), mesh)
        same_c = ((res.valid.cpu().numpy() == ref["popup_valid"][sl])
                  & (res.n_points.cpu().numpy()
                     == ref["popup_n_points"][sl])).all(-1)
        differ += [c + int(i) for i in np.nonzero(~same_c)[0]]
    out = {"path": "sharded", "frames": n, "block": SHARDED_BLOCK,
           "world_size": mesh.size(), "backend": "nccl", "card": gpu,
           "launches": launches, "keyframes": keyframes,
           "collectives": collectives,
           "all_reduce_per_frame": collectives["all_reduce"] / n,
           "frames_per_s": fps, "launches_per_frame": per_frame,
           "traj_bound_m": TRAJ_BOUND_M, "frames_held": held,
           "traj_held_max_abs_err_m": float(t_err[:held].max()),
           "traj_max_abs_err_m": float(t_err.max()),
           "discrete_match": discrete, "keyframe_decisions": kf,
           "anchored_traj_max_abs_err_m": float(anchored.max()),
           "popup_at_reference_poses_differ": differ,
           "traj_abs_err_m_per_frame": t_err.tolist()}
    print(json.dumps(out))
    assert held >= MIN_HELD * n, f"sharded: pop-up branch at frame {held}"
    assert float(t_err[:held].max()) <= TRAJ_BOUND_M, out[
        "traj_held_max_abs_err_m"]
    assert all(discrete.values()), discrete
    assert (kf_dec == ref_kf).all(), kf
    assert float(anchored.max()) <= TRAJ_BOUND_M, float(anchored.max())
    assert not differ, f"sharded pop-up parts at frames {differ}"
    assert launches["plane_terms"] == scfg.gn_iters * keyframes, launches
    assert sum(launches.values()) == launches["plane_terms"], launches
    assert collectives["all_reduce"] == scfg.gn_iters * keyframes, out
    return launches


def _gloo2_rank(rank, port, device, q):
    """One of the two gloo ranks of the ``sharded_gloo2`` phase: the
    factor-sharded GN (``analytic_planes=True``: K5 on its block) and the
    map-block GN on the recorded corridor problem."""
    try:
        import datetime

        import torch
        import torch.distributed as dist

        sys.path.insert(0, REPO)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            "gloo", init_method=f"tcp://localhost:{port}", world_size=2,
            rank=rank, timeout=datetime.timedelta(seconds=GLOO2_TIMEOUT_S))
        from pop_up_slam_tpu_torch import convert
        from pop_up_slam_tpu_torch.ops import plane_jacobians as pj
        from pop_up_slam_tpu_torch.parallel import (
            distributed, distributed_gn_solve, make_mesh,
            map_block_gn_solve)

        mesh = make_mesh(2, device=dev)
        ref_b = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                                     "corridor_ref_batched.npz"))
        w, f = _recorded_problem(convert, ref_b, dev)
        pj.plane_terms.launches = 0
        w_d, _ = distributed_gn_solve(w, f, mesh, iters=GLOO2_ITERS,
                                      damping=GLOO2_DAMPING,
                                      analytic_planes=True)
        k5 = pj.plane_terms.launches
        w_m, _ = map_block_gn_solve(w, f, mesh, iters=GLOO2_ITERS,
                                    damping=GLOO2_DAMPING)
        out = {"k5": k5, "collectives": dict(distributed.collective_calls),
               "device": str(w_d.t.device)}
        for name, w_ in (("gn", w_d), ("map_block", w_m)):
            out[name] = {k: getattr(w_, k).cpu().numpy()
                         for k in ("R", "t", "planes")}
        q.put((rank, True, out))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the parent)
        import traceback

        q.put((rank, False, traceback.format_exc()))


def run_gloo2_path(torch, convert, solver, pj, ref_b, gpu):
    """The ``sharded_gloo2`` phase: two spawned ranks over gloo, both on
    GLOO2_DEVICE (NCCL will not put two ranks on one card), run
    ``distributed_gn_solve`` (K5 on each rank's block) and
    ``map_block_gn_solve`` on the recorded corridor problem; held against
    the port's single-device ``gn_solve`` on the card (GLOO2_TOL,
    GLOO2_MAP_BLOCK_TOL), K5 once a GN iteration on each rank.  A rank
    that fails or exceeds GLOO2_TIMEOUT_S fails the phase."""
    import multiprocessing as mp
    import queue
    import socket

    ctx = mp.get_context("spawn")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    q = ctx.Queue()
    procs = [ctx.Process(target=_gloo2_rank,
                         args=(r, port, GLOO2_DEVICE, q), daemon=True)
             for r in range(2)]
    t0_run = time.perf_counter()
    for p in procs:
        p.start()
    results = {}
    try:
        while len(results) < 2:
            left = GLOO2_TIMEOUT_S - (time.perf_counter() - t0_run)
            assert left > 0, f"gloo ranks: no result in {GLOO2_TIMEOUT_S} s"
            try:
                rank, ok, payload = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                assert not dead, f"gloo rank(s) {dead} exited, no result"
                continue
            assert ok, f"gloo rank {rank} failed:\n{payload}"
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    seconds = time.perf_counter() - t0_run
    dev = torch.device(GLOO2_DEVICE)
    w, f = _recorded_problem(convert, ref_b, dev)
    ref_gn, _ = solver.gn_solve(w, f, iters=GLOO2_ITERS,
                                damping=GLOO2_DAMPING, analytic_planes=True)
    ref_mb, _ = solver.gn_solve(w, f, iters=GLOO2_ITERS,
                                damping=GLOO2_DAMPING)
    err = {}
    for name, ref_w in (("gn", ref_gn), ("map_block", ref_mb)):
        for k in ("t", "planes"):
            r = getattr(ref_w, k).cpu().numpy()
            err[f"{name}_{k}"] = max(
                float(np.abs(results[q_][name][k] - r).max())
                for q_ in range(2))
    out = {"path": "sharded_gloo2", "world_size": 2, "backend": "gloo",
           "device": GLOO2_DEVICE, "card_path": dev.type == "cuda",
           "card": gpu, "seconds": seconds,
           "k5_launches_per_rank": [results[r]["k5"] for r in range(2)],
           "collectives_per_rank": [results[r]["collectives"]
                                    for r in range(2)],
           "max_abs_err": err, "tol": GLOO2_TOL,
           "map_block_tol": GLOO2_MAP_BLOCK_TOL}
    print(json.dumps(out))
    for r in range(2):
        assert results[r]["device"] == str(dev), results[r]["device"]
        assert results[r]["k5"] == GLOO2_ITERS, out
        for name in ("gn", "map_block"):
            for k in ("R", "t", "planes"):
                assert np.isfinite(results[r][name][k]).all(), (r, name, k)
                assert np.array_equal(results[r][name][k],
                                      results[0][name][k]), (r, name, k)
    assert err["gn_t"] <= GLOO2_TOL and err["gn_planes"] <= GLOO2_TOL, out
    assert max(err["map_block_t"], err["map_block_planes"]) <= \
        GLOO2_MAP_BLOCK_TOL, out
    return out


def run_single_host_paths(torch, cli, counters, ref, gpu, dev="cuda"):
    """The ``single_host`` path: ``cli run --config single_host``
    in-process, a world of one on this card (64 frames at 480x640, the
    sharded runner, K5 in each GN iteration).  Held: exit code 0, the
    summary's keys and frame count the JAX CLI's (recorded), its ATE
    within SINGLE_HOST_ATE_BOUND_M of the JAX CLI's, K5 twice a keyframe
    solve and no other kernel.  Then ``multi_host`` once (the same
    runner over a (1, 1) host mesh's flattened axis, 128 frames, W=12,
    L=128): exit code 0, the keys, finite poses.  Returns the
    ``single_host`` launches."""
    from pop_up_slam_tpu_torch.parallel import distributed

    keys = {k.split(".", 1)[1] for k in ref.files
            if k.startswith("cli_single_host.")}
    out = {}
    for preset in ("single_host", "multi_host"):
        for fn in counters.values():
            fn.launches = 0
        for k in distributed.collective_calls:
            distributed.collective_calls[k] = 0
        t0_run = time.perf_counter()
        rc, summary = _cli_json(cli.main, ["run", "--config", preset,
                                           "--device", dev])
        seconds = time.perf_counter() - t0_run
        launches = {k: fn.launches for k, fn in counters.items()}
        out[preset] = {"rc": rc, "summary": summary, "launches": launches,
                       "collectives": dict(distributed.collective_calls),
                       "seconds": seconds}
    sh = out["single_host"]["summary"]
    ref_ate = float(ref["cli_single_host.ate_rmse_m"])
    line = {"path": "single_host", "card": gpu, **out,
            "ref_summary": {k: ref[f"cli_single_host.{k}"].item()
                            for k in sorted(keys)},
            "ate_bound_m": SINGLE_HOST_ATE_BOUND_M,
            "ate_diff_m": abs(sh["ate_rmse_m"] - ref_ate)}
    print(json.dumps(line))
    for preset in ("single_host", "multi_host"):
        s = out[preset]["summary"]
        assert out[preset]["rc"] == 0 and set(s) == keys, line
        assert s["finite"] and s["n_devices"] == 1, line
        c = out[preset]["launches"]
        assert c["plane_terms"] == 2 * (s["n_keyframes"] - 1), line
        assert sum(c.values()) == c["plane_terms"], line
    assert sh["frames"] == int(ref["cli_single_host.frames"]), line
    assert abs(sh["ate_rmse_m"] - ref_ate) <= SINGLE_HOST_ATE_BOUND_M, line
    return out["single_host"]["launches"]


def run_smoother_mesh_path(torch, smoothing, convert, counters, ref_tum,
                           ref, gpu, mesh, dev="cuda"):
    """The ``smoother_mesh`` phase: ``smooth_trajectory(mesh=)`` (the
    keyframe-sharded GN, ``jacfwd`` terms) at a world of one on the
    ``tum`` path's recorded recorder and state (``corridor_ref_tum.npz``),
    held within SMOOTHER_MESH_TOL of the port's single-device smoother on
    the same inputs and of the JAX 2-device mesh smoother (recorded)."""
    from pop_up_slam_tpu_torch.config import get_config

    scfg = get_config("tum_fr3").slam
    rec = smoothing.TrajectoryRecorder.restore(
        scfg, _tree(ref_tum, "rec.", slice(None)))
    st = convert.slam_state_from_numpy(_tree(ref_tum, "state."), dev)
    for fn in counters.values():
        fn.launches = 0
    t0_run = time.perf_counter()
    kf_R, kf_t, _ = smoothing.smooth_trajectory(rec, st, scfg, iters=8,
                                                damping=scfg.damping,
                                                mesh=mesh)
    ms = (time.perf_counter() - t0_run) * 1e3
    launches = {k: fn.launches for k, fn in counters.items()}
    R1, t1, _ = smoothing.smooth_trajectory(rec, st, scfg, iters=8,
                                            damping=scfg.damping)
    err = {"vs_single_device_t": float(np.abs(kf_t - t1).max()),
           "vs_single_device_R": float(np.abs(kf_R - R1).max()),
           "vs_jax_mesh_t": float(np.abs(kf_t - ref["mesh_kf_t"]).max()),
           "vs_jax_mesh_R": float(np.abs(kf_R - ref["mesh_kf_R"]).max())}
    out = {"path": "smoother_mesh", "world_size": mesh.size(), "card": gpu,
           "keyframes": int(kf_t.shape[0]), "ms": ms, "launches": launches,
           "max_abs_err": err, "tol": SMOOTHER_MESH_TOL}
    print(json.dumps(out))
    assert np.isfinite(kf_t).all() and np.isfinite(kf_R).all()
    assert max(err.values()) <= SMOOTHER_MESH_TOL, out
    return launches


def run_segnet_train_path(torch, seg, counters, gpu, dev="cuda"):
    """The ``segnet_train`` path: ``scripts/train_segnet_torch.py``'s loop
    on the card (SEGNET_TRAIN_STEPS steps of 8 frames at 96x128).  Held:
    held-out IoU at least SEGNET_TRAIN_IOU on the script's 5 batches; the
    first step's loss against the CPU module's from the same initial
    parameters and batch within SEGNET_TRAIN_LOSS_RTOL; the checkpoint
    through ``save_segnet`` and ``load_pretrained_segnet`` gives the same
    parameters and IoU; no kernel of the port runs.  Prints ms a step
    (the loop, batch rendering included) and ``train_step``'s alone."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_segnet_torch", os.path.join(REPO, "scripts",
                                           "train_segnet_torch.py"))
    tr = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tr)
    for fn in counters.values():
        fn.launches = 0
    model, params, tx, losses, loop_ms, (rgb0, gt0) = tr.train(
        SEGNET_TRAIN_STEPS, dev, seed=0, log_every=0)
    launches = {k: fn.launches for k, fn in counters.items()}
    ious = tr.holdout_ious(model, params, dev)
    m_cpu, p_cpu, tx_cpu = seg.create_train_state(
        torch.Generator().manual_seed(0), lr=tr.LR, image_hw=(tr.H, tr.W),
        device="cpu")
    loss_cpu = float(seg.train_step(m_cpu, p_cpu, tx_cpu, rgb0.cpu(),
                                    gt0.cpu()))
    loss0 = float(losses[0])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "segnet_torch.npz")
        seg.save_segnet(path, params, {"steps": SEGNET_TRAIN_STEPS,
                                       "min_holdout_iou": min(ious)})
        m2, p2, meta2 = seg.load_pretrained_segnet(path, device=dev)
        same = all(torch.equal(params[k].detach(), p2[k]) for k in params)
        ious2 = tr.holdout_ious(m2, p2, dev)
    step_ms = _time_ms(lambda: seg.train_step(model, params, tx, rgb0, gt0),
                       n=20, warm=3)
    out = {"path": "segnet_train", "steps": SEGNET_TRAIN_STEPS,
           "batch": tr.BATCH, "shape": [tr.H, tr.W], "card": gpu,
           "holdout_iou": ious, "iou_gate": SEGNET_TRAIN_IOU,
           "loss_first": loss0, "loss_first_cpu": loss_cpu,
           "loss_first_rel_diff": abs(loss0 - loss_cpu) / abs(loss_cpu),
           "loss_rtol": SEGNET_TRAIN_LOSS_RTOL,
           "loss_last": float(losses[-1]), "loop_ms_per_step": loop_ms,
           "train_step_ms": step_ms, "checkpoint_params_equal": same,
           "checkpoint_holdout_iou": ious2, "checkpoint_meta": meta2,
           "launches": launches}
    print(json.dumps(out))
    assert torch.isfinite(losses).all()
    assert min(ious) >= SEGNET_TRAIN_IOU, ious
    assert out["loss_first_rel_diff"] <= SEGNET_TRAIN_LOSS_RTOL, out
    assert same and ious2 == ious, out
    assert sum(launches.values()) == 0, launches
    return launches


def _sync(torch):
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import pop_up_slam_tpu_torch  # noqa: F401  (full-f32 numerics)
    from pop_up_slam_tpu_torch import convert, fusion
    from pop_up_slam_tpu_torch.factors import graph
    from pop_up_slam_tpu_torch.geometry import se3
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
    from pop_up_slam_tpu_torch.ops import _build, cholesky, depth_render
    from pop_up_slam_tpu_torch.ops import fused_gn
    from pop_up_slam_tpu_torch.ops import plane_jacobians as pj
    from pop_up_slam_tpu_torch.ops import schur as ks
    from pop_up_slam_tpu_torch.pipeline import (
        SlamConfig, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu_torch.pipeline import offline
    from pop_up_slam_tpu_torch.pipeline import slam as slam_mod
    from pop_up_slam_tpu_torch.popup import popup as pp
    from pop_up_slam_tpu_torch.solver import schur as solver_schur
    from pop_up_slam_tpu_torch.evaluation import ate_rmse
    from pop_up_slam_tpu_torch.io import native_loader, png, synthetic
    from pop_up_slam_tpu_torch.models import segmentation
    from pop_up_slam_tpu_torch.pipeline import batched, pipelined
    from pop_up_slam_tpu_torch import cli, solver
    from pop_up_slam_tpu_torch.parallel import make_mesh
    from pop_up_slam_tpu_torch.pipeline import sharded, smoothing

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
    k2_err, k2_t = check_k2(torch, pp, depth_render, K,
                            Intrinsics.create(80.0, 80.0, 80.0, 60.0,
                                              device="cuda"), masks, ref)
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
    check_jacfwd(torch, graph, pj, st_mid.window, f_mid, scfg.robust,
                 "state_W8_L64")
    check_jacfwd(torch, graph, pj, *random_system(torch, 8, 64, 72, 5,
                                                  torch.device("cuda")),
                 None, "random_W8_L64")
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
    t_ph = time.perf_counter()
    popup_ok = check_popup_at_reference_poses(torch, pp, K, masks_d, ref)
    phase_s["popup_at_reference_poses"] = time.perf_counter() - t_ph
    paths = {}
    t_ph = time.perf_counter()
    paths["gn"] = run_path(torch, "gn", slam_mod, offline, se3, pp,
                           run_sequence_chunked, counters, ref, gpu, scfg, n,
                           inputs, convert, warm_frames=16, depth=True)
    phase_s["gn_path"] = time.perf_counter() - t_ph
    assert paths["gn"]["fused_gn_solve"] == n, paths["gn"]
    assert paths["gn"]["depth_render"] == n, paths["gn"]
    for k in ("schur_reduce_small", "schur_gemm", "plane_terms"):
        assert paths["gn"][k] == 0, paths["gn"]
    for name in ("lm", "dogleg"):
        t_ph = time.perf_counter()
        paths[name] = run_path(torch, name, slam_mod, offline, se3, pp,
                               run_sequence_chunked, counters, ref_solvers,
                               gpu, scfg._replace(solver=name), n, inputs,
                               convert)
        phase_s[f"{name}_path"] = time.perf_counter() - t_ph
        c = paths[name]
        assert c["schur_reduce_small"] == c["plane_terms"] == 2 * n, c
        assert c["fused_gn_solve"] == 0 and c["schur_gemm"] == 0, c
    n24 = 48
    t_ph = time.perf_counter()
    paths["lm24"] = run_path(torch, "lm24", slam_mod, offline, se3, pp,
                             run_sequence_chunked, counters, ref_solvers, gpu,
                             scfg._replace(solver="lm", window_size=24), n24,
                             inputs, convert)
    phase_s["lm24_path"] = time.perf_counter() - t_ph
    c = paths["lm24"]
    assert c["schur_gemm"] == c["chol_solve"] == 2 * n24, c
    assert c["plane_terms"] == 2 * n24 and c["schur_reduce_small"] == 0, c
    assert c["fused_gn_solve"] == 0, c

    # ---- 5. the monocular paths ----
    ref_vo = np.load(os.path.join(ref_dir, "corridor_ref_vo.npz"))
    for name, fused in (("vo", False), ("fused_vo", True)):
        t_ph = time.perf_counter()
        paths[name], keyframes = run_vo_path(
            torch, name, slam_mod, offline, se3, pp, fusion, convert,
            counters, ref_vo, gpu, scfg, inputs, fused)
        phase_s[f"{name}_path"] = time.perf_counter() - t_ph
        c = paths[name]
        # K1 once a keyframe of the run; each frame's keyframe decision is
        # held against the reference's in run_vo_path (at kf_trans =
        # kf_rot = 0 a frame whose VO motion is zero is none: the first,
        # with no previous planes, in both runs: 143 of 144)
        assert c["fused_gn_solve"] == keyframes >= MIN_HELD * n, (
            c, keyframes)
        assert c["depth_render"] == (n if fused else 0), c
        for k in ("chol_solve", "schur_reduce_small", "schur_gemm",
                  "plane_terms"):
            assert c[k] == 0, c
    assert popup_ok, "the pop-up at the reference's poses parts from it"

    # ---- 6. the TUM entry point, its monocular mode, popup_demo ----
    ref_tum = np.load(os.path.join(ref_dir, "corridor_ref_tum.npz"))
    with tempfile.TemporaryDirectory() as root:
        t_ph = time.perf_counter()
        paths["tum"], (w_smooth, pf_smooth) = run_tum_path(
            torch, se3, pp, offline, convert, counters, ref_tum, gpu, masks,
            root)
        phase_s["tum_path"] = time.perf_counter() - t_ph
        t_ph = time.perf_counter()
        paths["tum_vo"] = run_tum_vo_path(torch, counters, gpu, root)
        phase_s["tum_vo_path"] = time.perf_counter() - t_ph
        t_ph = time.perf_counter()
        run_native_path(native_loader, png, os.path.join(root, "tum"), gpu)
        phase_s["native"] = time.perf_counter() - t_ph
    k5_err = max(k5_err, hold_k5(torch, pj, "smoother", w_smooth,
                                 pf_smooth, band=NEAR_AXIS_SMOOTHER))
    k5_smooth_t = k5_timing(torch, pj, w_smooth, pf_smooth)
    k5_smooth_t["device_ms"] = k5_device_ms(torch, pj, w_smooth, pf_smooth)
    t_ph = time.perf_counter()
    paths["popup_demo"], k2_demo_err = run_popup_demo_path(
        torch, pp, depth_render, counters, ref_tum, gpu)
    phase_s["popup_demo_path"] = time.perf_counter() - t_ph
    k2_err = max(k2_err, k2_demo_err)

    # ---- 7. the batched and pipelined runners, the learned segmenter ----
    ref_b = np.load(os.path.join(ref_dir, "corridor_ref_batched.npz"))
    t_ph = time.perf_counter()
    paths["batched"] = run_batched_path(torch, batched, offline, se3,
                                        convert, counters, ref_b, gpu, scfg,
                                        inputs, n)
    phase_s["batched_path"] = time.perf_counter() - t_ph
    c = paths["batched"]
    assert c["fused_gn_solve"] == n and sum(c.values()) == n, c
    t_ph = time.perf_counter()
    paths["pipelined"], paths["pipelined_stale"] = run_pipelined_paths(
        torch, pipelined, offline, ate_rmse, synthetic, counters, gpu, scfg,
        inputs, n)
    phase_s["pipelined_paths"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    paths["segnet"] = run_segnet_path(torch, segmentation, synthetic, pp,
                                      counters, ref_b, gpu)
    phase_s["segnet_path"] = time.perf_counter() - t_ph

    # ---- 8. the multi-device slice, SegNetLite's training ----
    ref_s = np.load(os.path.join(ref_dir, "corridor_ref_sharded.npz"))
    mesh = make_mesh(device="cuda")      # NCCL, a world of one
    t_ph = time.perf_counter()
    paths["sharded"] = run_sharded_path(torch, sharded, pp, offline, se3,
                                        convert, counters, ref_s, gpu, scfg,
                                        inputs, n, mesh)
    phase_s["sharded_path"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    run_gloo2_path(torch, convert, solver, pj, ref_b, gpu)
    phase_s["sharded_gloo2"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    paths["single_host"] = run_single_host_paths(torch, cli, counters, ref_s,
                                                 gpu)
    phase_s["single_host_paths"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    run_smoother_mesh_path(torch, smoothing, convert, counters, ref_tum,
                           ref_s, gpu, mesh)
    phase_s["smoother_mesh"] = time.perf_counter() - t_ph
    t_ph = time.perf_counter()
    paths["segnet_train"] = run_segnet_train_path(torch, segmentation,
                                                  counters, gpu)
    phase_s["segnet_train_path"] = time.perf_counter() - t_ph
    torch.distributed.destroy_process_group()

    # ---- 9. summary ----
    def row(name, counter, own_path, source, replaces, err, tm,
            on_path=True):
        b_ms, b_by = _bound(*tm["work"])
        by_path = {p: paths[p][counter] if on_path else 0 for p in paths}
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
    k4_path_n = 6 * 24    # lm24's reduced system: every K4 launch there

    def k4_row(n, on_path=True):
        return row(f"K4 chol_solve n={n}", "chol_solve", "lm24",
                   src + "chol_solve.cu",
                   "pop_up_slam_tpu/ops/cholesky_pallas.py:134", k4_err[n],
                   k4_t[n], on_path)

    k4 = k4_row(k4_path_n)
    k4["other_n"] = [k4_row(n, on_path=False) for n in K4_TIMED
                     if n != k4_path_n]
    kernels = [
        row("K1 fused_gn_solve", "fused_gn_solve", "gn", src + "fused_gn.cu",
            "pop_up_slam_tpu/ops/fused_gn.py:795", k1_err, k1_t),
        row("K2 depth_render", "depth_render", "gn", src + "depth_render.cu",
            "pop_up_slam_tpu/ops/depth_render.py:117", k2_err, k2_t),
        k4,
        row("K3a schur_reduce_small", "schur_reduce_small", "lm",
            src + "schur_reduce.cu",
            "pop_up_slam_tpu/ops/schur_pallas.py:117", k3a_err, k3a_t),
        row("K3b schur_gemm", "schur_gemm", "lm24", src + "schur_reduce.cu",
            "pop_up_slam_tpu/ops/schur_pallas.py:81", k3b_err, k3b_t),
        row("K5 plane_terms", "plane_terms", "lm", src + "plane_terms.cu",
            "pop_up_slam_tpu/ops/plane_jacobians.py:315", k5_err, k5_t),
    ]
    b_ms, b_by = _bound(*k5_smooth_t["work"])
    kernels[-1]["smoother_shape"] = {
        "W": w_smooth.window_size, "F": int(pf_smooth.valid.shape[0]),
        "launches_tum": paths["tum"]["plane_terms"],
        "ms": k5_smooth_t["ms"], "device_ms": k5_smooth_t["device_ms"],
        "plain_ms": k5_smooth_t["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by,
        "bytes": k5_smooth_t["work"][0],
        "operations": k5_smooth_t["work"][1]}
    print(json.dumps({"kernels": kernels,
                      "note": "K4's routine also runs inside K1 and K3a; "
                              "its standalone kernel follows K3b (lm24 "
                              "launches it at n=144); K4's other_n rows are "
                              "timed sizes that no path launches",
                      "phase_s": phase_s,
                      "total_s": time.perf_counter() - t_start}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
