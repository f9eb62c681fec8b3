"""K8: the exiting keyframe's marginal sqrt-info in one CUDA launch, and
its plain PyTorch version.

Every keyframe forms the marginal of the keyframe that leaves the window
(``pipeline/slam.py::_marginalize_oldest``; the frame step keeps it once
the window is full): the slot-0 prior and the exiting odometry factor
0->1 are folded, p0 is eliminated in closed form, the information is
floored, and the new prior on slot 1 takes ``chol(Hm)^T`` as its
sqrt-info.  :func:`marginal_sqrt` is the per-op
chain (the plain version: CPU tensors and other dtypes, and
``fused_gn_plain``); on the card it was ~734 launches a keyframe for a
few 6x6 products, one 6x6 SPD inverse and one 6x6 Cholesky.

:func:`exiting_marginal` takes the frame step's pre-roll state whole and
routes on it: f32 CUDA tensors launch **K8** (``csrc/marginal.cu``: one
warp, the state read where it lies, no packing), anything else runs
:func:`marginal_sqrt` on slots 0 and 1.  K8's device code is
``csrc/marginal.cuh``, which K1 (``csrc/fused_gn.cu``) also runs on its
MARG block; on the same state the two agree to the last bits (nvcc
contracts some multiply-adds otherwise in the two kernels).
"""

from __future__ import annotations

import ctypes

import torch

from .._device import const
from ..geometry import se3
from ._build import check, check_inputs, library


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


def exiting_marginal(R, t, odom_R, odom_t, odom_valid, prior_R, prior_t,
                     prior_sqrt, adiag, eps: float,
                     floor: float) -> torch.Tensor:
    """:func:`marginal_sqrt` of the pre-roll state: the window's ``R``
    (W, 3, 3) and ``t`` (W, 3) (slots 0 and 1 are read), ``odom_R``
    (W-1, 3, 3), ``odom_t`` (W-1, 3) and ``odom_valid`` (W-1,) (factor 0
    is read), the slot-0 prior's ``prior_R`` (3, 3), ``prior_t`` (3,) and
    ``prior_sqrt`` (6, 6).  f32 CUDA tensors launch K8 (one launch, no
    host sync, a fresh (6, 6) output); any other device or dtype runs
    :func:`marginal_sqrt`."""
    f32 = torch.float32
    dev = t.device
    pose = (R, t, odom_R, odom_t, prior_R, prior_t, prior_sqrt)
    if dev.type != "cuda" or any(x.dtype != f32 for x in pose):
        return marginal_sqrt(R[0], t[0], R[1], t[1], odom_R[0], odom_t[0],
                             odom_valid[0], prior_R, prior_t, prior_sqrt,
                             adiag, eps, floor)
    W = R.shape[0]
    if W < 2:
        raise ValueError("exiting_marginal: the window needs two slots")
    R, t, odom_R, odom_t, odom_valid, prior_R, prior_t, prior_sqrt = (
        x.contiguous() for x in (R, t, odom_R, odom_t, odom_valid, prior_R,
                                 prior_t, prior_sqrt))
    check_inputs("exiting_marginal", dev, (R, (W, 3, 3)), (t, (W, 3)),
                 (odom_R, (W - 1, 3, 3)), (odom_t, (W - 1, 3)),
                 (odom_valid, (W - 1,), torch.bool), (prior_R, (3, 3)),
                 (prior_t, (3,)), (prior_sqrt, (6, 6)))
    out = torch.empty((6, 6), dtype=f32, device=dev)
    ptrs = (ctypes.c_void_p * 9)(*(x.data_ptr() for x in (
        R, t, odom_R, odom_t, odom_valid, prior_R, prior_t, prior_sqrt,
        out)))
    x = (ctypes.c_float * 8)(*adiag, eps, floor)
    exiting_marginal.launches += 1
    check(library().popup_marginal(
        ctypes.addressof(ptrs), ctypes.addressof(x),
        torch.cuda.current_stream(dev).cuda_stream), "exiting_marginal")
    return out


exiting_marginal.launches = 0
