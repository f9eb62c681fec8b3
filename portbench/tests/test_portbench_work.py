"""K1's and K2's work counts against hand counts at small shapes."""

from types import SimpleNamespace as NS

import torch

from _portbench_cpu import ROOT  # noqa: F401
from portbench.work import k1, k2, load_peaks


def _inputs(plane_valid, lm_valid, odom_valid, pose_fixed=(False,)):
    W = len(pose_fixed)
    window = NS(window_size=W,
                pose_valid=torch.ones(W, dtype=torch.bool),
                pose_fixed=torch.tensor(pose_fixed),
                lm_valid=torch.tensor(lm_valid))
    F = len(plane_valid)
    factors = NS(
        planes=NS(valid=torch.tensor(plane_valid),
                  pose_idx=torch.zeros(F, dtype=torch.int32),
                  lm_idx=torch.zeros(F, dtype=torch.int32)),
        odom=NS(valid=torch.tensor(odom_valid)),
        priors=NS(valid=torch.tensor([True])))
    return window, factors


def test_k1_one_free_pose_and_its_prior():
    window, factors = _inputs([False], [False], [False])
    robust = NS(odom=NS(kind="none"), plane=NS(kind="none"),
                prior=NS(kind="none"))
    n = 6
    lin = k1._PRIOR_FACTOR
    normal = (21 * 2 * 6 + 2 * 6 * 6) + 1 + 1     # sym(6,6) + mm(6,6,1)
    schur = 2 * n
    chol = n ** 3 / 3 + n ** 2 / 2 + n / 6 + n + 2 * n * n
    step = 2 * n
    retract = k1._SE3_EXP + k1._COMPOSE
    per_it = lin + normal + schur + chol + step + retract
    got = k1.k1_ops(window, factors, 2, robust)
    assert got == 2 * per_it + k1._MARGINAL


def test_k1_counts_only_valid_factors_and_observed_landmarks():
    robust = NS(odom=NS(kind="none"), plane=NS(kind="none"),
                prior=NS(kind="none"))
    w0, f0 = _inputs([False, False], [True], [False])
    w1, f1 = _inputs([True, False], [True], [False])
    # one plane factor on a free pose observing one landmark: its terms,
    # its normal equations, the landmark's 3x3 block and inverse, the
    # Schur update of its 6 pose rows, the back-substitution
    d = (k1._PLANE_FACTOR
         + (k1._sym(6, 3) + k1._mm(6, 3, 3) + k1._sym(3, 3)
            + k1._mm(6, 3, 1) + k1._mm(3, 3, 1)) + 1
         + 3 + k1._INV3
         + k1._mm(1, 3, 3) * 6 + 6 * 7 // 2 * 6 + k1._mm(1, 3, 1) * 6
         + 12 * 3 + 3 + 15
         + 2 * 3)
    assert k1.k1_ops(w1, f1, 1, robust) - k1.k1_ops(w0, f0, 1, robust) == d


def test_k1_bytes():
    W, L, F, O, P = 8, 64, 72, 7, 1
    window = NS(window_size=W, max_landmarks=L)
    factors = NS(planes=NS(valid=torch.zeros(F)), odom=NS(valid=torch.zeros(O)),
                 priors=NS(valid=torch.zeros(P)))
    want = (4 * (12 * W + 4 * L + 48 * P + 13 * F + 48 * O + 128 + 2 * F
                 + 2 * O + P) + (2 * W + L + F + O + P)
            + 4 * (12 * W + 4 * L + 2 + 36))
    assert k1.k1_bytes(window, factors, 2) == want


def test_k2_counts():
    assert k2.k2_ops(2, 3, 1) == 6 * (21 + 19) + 14
    assert k2.k2_ops(480, 640, 0) == 480 * 640 * 21
    # mask + depth per pixel, camera/pose/ground, 2 wall slots
    assert k2.k2_bytes(2, 3, 2) == 6 * 5 + 4 * 20 + 2 * 43


def test_peaks_table():
    p = load_peaks()
    assert p["f32_flops_per_s"] == 67e12 and p["hbm_bytes_per_s"] == 3.35e12
