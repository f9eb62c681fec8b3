"""K1's work on the inputs of one launch: operations and bytes.

Frozen copy of ``chip_smoke.py``'s ``k1_ops`` and of its byte count in
``check_k1``: the windowed Gauss-Newton solve with the exiting
keyframe's marginal, whatever kernel implements it.  A roofline share is
the least time these need on the chip (the larger of operations over
the f32 peak and bytes over the HBM peak) over the measured device time.
"""

from __future__ import annotations

import numpy as np

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


def k1_bytes(window, factors, iters: int) -> float:
    """Bytes of one launch: its inputs read once and its outputs written
    once (the window, the factors, the MARG block; the optimized window,
    the costs and the marginal)."""
    W, L = window.window_size, window.max_landmarks
    F = factors.planes.valid.shape[0]
    O = factors.odom.valid.shape[0]
    P = factors.priors.valid.shape[0]
    return (4 * (12 * W + 4 * L + 48 * P + 13 * F + 48 * O + 128
                 + 2 * F + 2 * O + P) + (2 * W + L + F + O + P)
            + 4 * (12 * W + 4 * L + iters + 36))
