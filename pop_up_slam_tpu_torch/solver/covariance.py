"""Marginal covariance recovery for poses and plane landmarks.

Port of ``pop_up_slam_tpu/solver/covariance.py``.  With

    H = [[Hpp, Hpl], [Hpl^T, Hll]],   S = Hpp - Hpl Hll^-1 Hpl^T

the marginals of the (free) poses are the 6x6 diagonal blocks of S^-1,
and the landmark marginals follow from the block-inverse identity

    Cov_ll = Hll^-1 + Hll^-1 Hpl^T S^-1 Hpl Hll^-1   (diagonal blocks).

S is small (6W x 6W): one dense inverse, ``torch.linalg.inv_ex`` (no
host check of the result, so no sync on CUDA).  Gauge-fixed / invalid
blocks are masked to zero covariance.

The port forms S and inverts it in f64 and returns the input's dtype.
The reference works in f32, where forming S cancels: on the corridor
TUM run's final window (W=8, L=64) an f32 evaluation loses 3.6e-3 of
the largest pose covariance entry against the f64 one (the reference's
own loss there is 1.8e-3), the f64 evaluation of the f32 inputs 9e-5.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..factors.graph import Linearization, Window
from .schur import inv3x3


class Marginals(NamedTuple):
    pose_cov: torch.Tensor   # (W, 6, 6) — zero for fixed/invalid poses
    plane_cov: torch.Tensor  # (L, 3, 3) — zero for invalid landmarks


def recover_marginals(lin: Linearization, window: Window,
                      damping: float = 1e-9) -> Marginals:
    """Pose and plane marginal covariances at the current linearization.

    Mirrors the masking of ``solver.schur.solve_schur``: gauge-fixed
    poses act as perfectly known anchors (their rows/cols leave the
    system; their own covariance is reported as zero)."""
    W = lin.bp.shape[0]
    dt_in = lin.bp.dtype
    lin = type(lin)(*(x.double() for x in lin))
    dt, dev = lin.bp.dtype, lin.bp.device

    eye3 = torch.eye(3, dtype=dt, device=dev)
    lm_mask = window.lm_valid
    Hll = torch.where(lm_mask[:, None, None], lin.Hll + damping * eye3, eye3)
    Hll_inv = inv3x3(Hll)

    HplWinv = torch.einsum("wlab,lbc->wlac", lin.Hpl, Hll_inv)
    S_blocks = lin.Hpp - torch.einsum("wlac,vlbc->wvab", HplWinv, lin.Hpl)

    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = torch.eye(W, dtype=dt, device=dev)[:, :, None, None] * eye6
    S_blocks = S_blocks + damping * diag

    free = window.pose_valid & (~window.pose_fixed)
    pm = free.to(dt)
    S_blocks = S_blocks * pm[:, None, None, None] * pm[None, :, None, None]
    S_blocks = S_blocks + diag * (1.0 - pm)[:, None, None, None]

    S = S_blocks.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
    Sinv = torch.linalg.inv_ex(S)[0]
    Sinv_blocks = Sinv.reshape(W, 6, W, 6).permute(0, 2, 1, 3)

    idx = torch.arange(W, device=dev)
    pose_cov = Sinv_blocks[idx, idx] * pm[:, None, None]

    # Landmark marginals: Hll^-1 + Hll^-1 (sum_wv Hpl_w^T Sinv_wv Hpl_v)
    # Hll^-1.  Couplings through gauge-fixed poses are exact knowledge
    # and must not inflate the landmark uncertainty: zero those Hpl rows.
    Hpl_m = lin.Hpl * pm[:, None, None, None]
    M = torch.einsum("wlab,wvac,vlcd->lbd", Hpl_m, Sinv_blocks, Hpl_m)
    plane_cov = Hll_inv + torch.einsum("lab,lbc,lcd->lad", Hll_inv, M,
                                       Hll_inv)
    plane_cov = plane_cov * lm_mask[:, None, None].to(dt)
    return Marginals(pose_cov.to(dt_in), plane_cov.to(dt_in))
