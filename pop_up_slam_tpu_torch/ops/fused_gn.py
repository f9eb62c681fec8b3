"""K1: the whole windowed Gauss-Newton solve in one CUDA launch, and its
plain PyTorch version.

Replaces ``pop_up_slam_tpu/ops/fused_gn.py::fused_gn_solve`` (Pallas
kernel ``_fused_kernel``, body ``fused_gn_iterations``).  The CUDA kernel
(``csrc/fused_gn.cu``, with ``csrc/lie.cuh`` and the K4 routine in
``csrc/chol.cuh``) runs all ``iters`` iterations — analytic linearization
with IRLS, normal equations, Schur elimination with closed-form 3x3
inverses, the reduced Cholesky solve, back-substitution, step
sanitization, SE(3)/S^3 retraction — plus the exiting keyframe's
marginal (``csrc/marginal.cuh``, which K8 also runs), in one thread
block.  At ~1 MFLOP per iteration it is latency-bound; the design keeps
the whole problem resident in shared memory across iterations,
assembles the normal equations by gathering (no atomics:
deterministic), and launches once per keyframe.  It receives
the window and factors as K6 and K7 do (:func:`._problem.pack` and
``csrc/factor_graph.cuh``, which holds the factor arithmetic the three
share).

The plain version (CPU tensors) is the per-op chain the reference pins
its fused body against: the marginal from the MARG block
(:func:`.marginal.marginal_sqrt`), substituted into the prior factor
when the window is full, then ``gn_solve`` with analytic Jacobians.
"""

from __future__ import annotations

import torch

from ..factors.graph import Factors, Window
from ..factors.robust import RobustConfig
from ._build import check_inputs, check_stamps, library
from ._problem import MAX_SMEM, _as, _launch, check_window, pack
from .marginal import marginal_sqrt


def smem_bytes(W: int, L: int, F: int, O: int, P: int) -> int:
    """Shared memory of the kernel at these sizes: the total of
    ``make_layout`` in csrc/fused_gn.cu, kept here so the gate works
    without the built library (tests/test_torch_cuda.py and chip_smoke.py
    hold the two equal)."""
    ldh = 3 * L | 1          # padded row stride of Hpl and B
    words = (36 * W * W + 12 * W * ldh + 31 * W + 22 * L + 33 * F
             + 81 * (O + P) + 48 * P + W * (W + 1) // 2
             + (L + 1) + (W + 1) + 2 * F + 14 * 36 + 16 + 8)
    return 4 * words


def fused_gn_supported(W: int, L: int, F: int, O: int, P: int) -> bool:
    """Shape gate: the whole problem must fit one block's shared memory
    (and the per-landmark observer masks are 64 bits wide)."""
    return (1 <= W <= 64 and L >= 1
            and smem_bytes(W, L, F, O, P) <= MAX_SMEM)


def pack_marg(R0, t0, R1, t1, odom_R0, odom_t0, odom_valid0, mprior_R,
              mprior_t, mprior_sqrt, full) -> torch.Tensor:
    """The (8, 16) MARG block: pre-roll slot-0/slot-1 poses, the exiting
    odometry measurement, the old slot-0 prior and the window-full flag
    (selects the new marginal or the old prior inside the solve)."""
    f32 = torch.float32
    z4 = torch.zeros((4,), dtype=f32, device=t0.device)

    def row(R, t):
        return torch.cat([R.reshape(9), t, z4]).to(f32)

    flags = torch.zeros((16,), dtype=f32, device=t0.device)
    flags[0] = odom_valid0.to(f32)
    flags[1] = full
    a = mprior_sqrt.reshape(36).to(f32)
    return torch.stack([
        row(R0, t0), row(R1, t1), row(odom_R0, odom_t0), flags,
        row(mprior_R, mprior_t), a[0:16], a[16:32],
        torch.cat([a[32:36], torch.zeros((12,), dtype=f32, device=t0.device)]),
    ])


def fused_gn_plain(window: Window, factors: Factors, iters: int, damping,
                   robust: RobustConfig, marg=None, marg_static=None):
    """Plain PyTorch version of the kernel (same returns).  Its reduced
    system is solved as the kernel and the reference's fused body solve
    it: Schur elimination, then a Cholesky that skips an indefinite pivot
    (:func:`..ops.schur.schur_reduce_plain`), where the per-op
    ``solve_schur`` would return NaN and so a zero step."""
    from ..solver import gn_solve
    from .schur import schur_reduce_plain

    m_sqrt = None
    if marg is not None:
        M = marg
        full = M[3, 1] > 0.5
        prA = M[5:8].reshape(-1)[:36].reshape(6, 6)
        R1, t1 = M[1, :9].reshape(3, 3), M[1, 9:12]
        prR, prt = M[4, :9].reshape(3, 3), M[4, 9:12]
        adiag, eps, floor = marg_static
        m_sqrt = marginal_sqrt(
            M[0, :9].reshape(3, 3), M[0, 9:12], R1, t1,
            M[2, :9].reshape(3, 3), M[2, 9:12], M[3, 0] > 0.5,
            prR, prt, prA, adiag, eps, floor,
        )
        pr = factors.priors
        P = pr.valid.shape[0]
        factors = factors._replace(priors=pr._replace(
            R=torch.where(full, R1, prR).expand(P, 3, 3),
            t=torch.where(full, t1, prt).expand(P, 3),
            sqrt_info=torch.where(full, m_sqrt, prA).expand(P, 6, 6),
        ))
    w_opt, stats = gn_solve(window, factors, iters=iters, damping=damping,
                            solve_fn=schur_reduce_plain,
                            analytic_planes=True, robust=robust)
    costs = stats.cost_history[:iters]
    if m_sqrt is not None:
        return w_opt, costs, m_sqrt
    return w_opt, costs


def n_stamps(iters: int) -> int:
    """Slots of the kernel's phase-stamp buffer: start, load, marginal,
    then 8 phases per iteration (``stamp`` in csrc/fused_gn.cu)."""
    return 3 + 8 * iters


def fused_gn_solve(window: Window, factors: Factors, iters: int = 2,
                   damping: float = 1e-5, robust: RobustConfig | None = None,
                   marg: torch.Tensor | None = None, marg_static=None,
                   stamps: torch.Tensor | None = None):
    """Fused windowed GN: returns (window_opt, costs (iters,)), plus the
    marginal sqrt-info m_sqrt (6, 6) when ``marg`` (a :func:`pack_marg`
    block) and ``marg_static`` ((adiag 6-tuple, eps, floor)) are given.
    CUDA tensors launch the kernel (one launch); CPU tensors run
    :func:`fused_gn_plain`.  ``stamps``, an int64 CUDA tensor of
    :func:`n_stamps` slots, receives the kernel's phase timestamps (ns,
    ``%globaltimer``); the profile script passes it, the main path not."""
    if robust is None:
        robust = RobustConfig()
    if marg is not None:
        if factors.priors.valid.shape[0] != 1:
            raise ValueError("fused marginalization needs exactly one prior")
        if marg_static is None:
            raise ValueError("marg needs marg_static")
    dev = window.t.device
    if dev.type == "cpu":
        return fused_gn_plain(window, factors, iters, damping, robust, marg,
                              marg_static)
    if dev.type != "cuda":
        raise ValueError(f"fused_gn_solve: unsupported device {dev}")
    if not isinstance(damping, (int, float)):
        raise TypeError("fused_gn_solve: damping must be a python float")

    od, pf, pr = factors.odom, factors.planes, factors.priors
    W, L = window.window_size, window.max_landmarks
    F, O, P = pf.valid.shape[0], od.valid.shape[0], pr.valid.shape[0]
    if not fused_gn_supported(W, L, F, O, P):
        raise ValueError(f"fused_gn_solve: shape (W={W}, L={L}, F={F}, "
                         f"O={O}, P={P}) exceeds the shared-memory budget")
    f32 = torch.float32
    window = window._replace(R=_as(window.R, f32), t=_as(window.t, f32),
                             planes=_as(window.planes, f32))
    check_window("fused_gn_solve", window)
    packed = pack(window, factors, robust)
    static = (0.0,) * 8
    if marg is not None:
        marg = _as(marg, f32)
        check_inputs("fused_gn_solve", dev, (marg, (8, 16)))
        adiag, eps, floor = marg_static
        static = (*adiag, eps, floor)
    check_stamps("fused_gn_solve", stamps, dev, n_stamps(iters))
    R_out = torch.empty((W, 3, 3), dtype=f32, device=dev)
    t_out = torch.empty((W, 3), dtype=f32, device=dev)
    planes_out = torch.empty((L, 4), dtype=f32, device=dev)
    costs = torch.empty((iters,), dtype=f32, device=dev)
    m_sqrt = torch.empty((6, 6), dtype=f32, device=dev)
    fused_gn_solve.launches += 1
    _launch(library().popup_fused_gn, "fused_gn_solve", window, packed,
            (marg, R_out, t_out, planes_out, costs, m_sqrt, stamps),
            ints=(iters,), floats=(float(damping), *static))
    w_opt = window._replace(R=R_out, t=t_out, planes=planes_out)
    if marg is not None:
        return w_opt, costs, m_sqrt
    return w_opt, costs


fused_gn_solve.launches = 0
