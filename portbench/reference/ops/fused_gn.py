"""Frozen copy of the port's ``ops/fused_gn.py`` for the benchmark's plain
reference (kernels replaced by their plain versions).

The windowed Gauss-Newton solve with the exiting keyframe's marginal,
plain PyTorch.

Frozen copy of the port's ``ops/fused_gn.py`` plain version (K1's): the
marginal from the MARG block, substituted into the prior factor when the
window is full, then ``gn_solve`` with analytic Jacobians and the
pivot-skip Schur solve.  ``fused_gn_solve`` runs it on any device.
"""

from __future__ import annotations

import torch

from .._device import const
from ..factors.graph import Factors, Window
from ..factors.robust import RobustConfig
from ..geometry import se3

MAX_SMEM = 232448   # bytes of shared memory one H100 block may use


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


def marginal_sqrt(R0, t0, R1, t1, odom_R0, odom_t0, odom_valid0, prior_R,
                  prior_t, prior_sqrt, adiag, eps: float,
                  floor: float) -> torch.Tensor:
    """Sqrt-info of the exiting keyframe's 6-DOF marginal on slot 1.

    Folds the slot-0 prior and the exiting odometry factor 0->1 (whitened
    by ``diag(adiag)``), eliminates p0 in closed form, floors the
    information by ``floor`` and returns ``chol(Hm)^T``."""
    from ..solver.schur import chol_small, spd_inv6_blocked

    dt, dev = t0.dtype, t0.device
    A_o = torch.diag(const(list(adiag), dt, dev))
    R_rel, t_rel = se3.se3_between(R0, t0, R1, t1)
    R_err, t_err = se3.se3_between(odom_R0, odom_t0, R_rel, t_rel)
    AJ = A_o @ se3.se3_right_jacobian_inv(se3.se3_log(R_err, t_err))
    R_10, t_10 = se3.se3_between(R1, t1, R0, t0)
    zero = torch.zeros((), dtype=dt, device=dev)
    J0 = torch.where(odom_valid0, -(AJ @ se3.se3_adjoint(R_10, t_10)), zero)
    J1 = torch.where(odom_valid0, AJ, zero)
    R_pe, t_pe = se3.se3_between(prior_R, prior_t, R0, t0)
    Jq = prior_sqrt @ se3.se3_right_jacobian_inv(se3.se3_log(R_pe, t_pe))

    eye6 = torch.eye(6, dtype=dt, device=dev)
    H00 = J0.T @ J0 + Jq.T @ Jq + eps * eye6
    H01 = J0.T @ J1
    H11 = J1.T @ J1
    Hm = H11 - H01.T @ spd_inv6_blocked(H00) @ H01
    Hm = 0.5 * (Hm + Hm.T) + floor * eye6
    return chol_small(Hm).T


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



def fused_gn_solve(window: Window, factors: Factors, iters: int = 2,
                   damping: float = 1e-5, robust: RobustConfig | None = None,
                   marg: torch.Tensor | None = None, marg_static=None):
    """:func:`fused_gn_plain` on the tensors' device."""
    if robust is None:
        robust = RobustConfig()
    return fused_gn_plain(window, factors, iters, damping, robust, marg,
                          marg_static)
