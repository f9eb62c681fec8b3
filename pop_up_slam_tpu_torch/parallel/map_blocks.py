"""Map-block-partitioned distributed BA: landmark slots owned per rank.

Port of ``pop_up_slam_tpu/parallel/map_blocks.py``.  Where
:mod:`.distributed` splits the factors arbitrarily and reduces the whole
(W, L) system, here each rank **owns a contiguous block of landmark
slots** and everything about them: the plane factors observing them
(routed on the host), their Hll and bl, the pose-landmark coupling Hpl
restricted to the block, the block's Schur contribution
``-Hpl_blk Hll_blk^-1 Hpl_blk^T``, and the back-substituted landmark steps
and plane retraction.  Only the reduced camera system (6W x 6W), the pose
gradient, the plane cost and the step's squared norm are summed across
ranks (``all_reduce``); the pose-only odometry and prior factors are
cheap, so every rank evaluates them identically instead of paying a
collective.  The plane terms are the per-factor ``jacfwd`` ones, as the
reference's.

Cost note (the reference's): :func:`partition_plane_factors` routes the
factors with a host numpy pass per call.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from ..factors.graph import (
    Factors,
    PlaneFactors,
    Window,
    _grad,
    _hess,
    _odom_terms,
    _plane_terms,
    _prior_terms,
)
from ..geometry import plane as plane_mod
from ..geometry import se3
from ..solver.schur import cholesky_nan, inv3x3
from .distributed import all_reduce_sum, mesh_axis, solve_stats


def partition_plane_factors(planes: PlaneFactors, L: int,
                            n_shards: int) -> tuple[PlaneFactors, int]:
    """Host-side routing: group plane factors by landmark owner shard.

    Landmark slot l belongs to shard l // (L/n).  Returns a PlaneFactors
    (on the factors' device) whose leading axis is ordered [shard 0 block
    | shard 1 block | ...], each block padded to the largest per-shard
    count (padding ``valid=False``, zero-filled as the reference pads),
    with ``lm_idx`` rewritten to block-local indices, and that count.
    Invalid factors are routed to shard 0 as padding."""
    assert L % n_shards == 0, (L, n_shards)
    Lb = L // n_shards
    dev = planes.valid.device
    lm = planes.lm_idx.cpu().numpy()
    valid = planes.valid.cpu().numpy()
    owner = np.where(valid, lm // Lb, 0)

    per_shard = [np.where(owner == s)[0] for s in range(n_shards)]
    cap = max(1, max(len(ix) for ix in per_shard))

    def gather_pad(x):
        x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
        out = np.zeros((n_shards * cap,) + x.shape[1:], x.dtype)
        for s, ix in enumerate(per_shard):
            out[s * cap: s * cap + len(ix)] = x[ix]
        return torch.as_tensor(out, device=dev)

    new = PlaneFactors(
        pose_idx=gather_pad(planes.pose_idx),
        lm_idx=gather_pad(np.where(valid, lm % Lb, 0).astype(lm.dtype)),
        pi_meas=gather_pad(planes.pi_meas),
        sqrt_info=gather_pad(planes.sqrt_info),
        valid=gather_pad(planes.valid),
    )
    return new, cap


def _pad_landmarks(window: Window, L_new: int) -> Window:
    """The window with invalid unit-plane landmark slots up to ``L_new``."""
    pad = L_new - window.max_landmarks
    if pad == 0:
        return window
    unit = torch.tensor([0.0, 0.0, 1.0, 0.0], dtype=window.planes.dtype,
                        device=window.planes.device)
    return window._replace(
        planes=torch.cat([window.planes, unit.repeat(pad, 1)]),
        lm_valid=torch.cat([window.lm_valid,
                            torch.zeros((pad,), dtype=torch.bool,
                                        device=window.lm_valid.device)]),
    )


def _scatter(shape, idx, vals, like):
    out = torch.zeros(shape, dtype=like.dtype, device=like.device)
    return out.index_put_(idx, vals, accumulate=True)


def map_block_gn_solve(window: Window, factors: Factors, mesh: DeviceMesh,
                       iters: int = 5, damping: float = 1e-6,
                       axis: str = "d"):
    """Gauss-Newton with landmark map blocks owned per rank.

    Returns (window, SolveStats), equal to ``solver.gn_solve``'s on the
    same problem to f32 tolerance.  The iterations run on each rank's
    own landmark block; the reference returns the planes sharded by its
    ``out_specs``, the port gathers them once after the loop, as a sum of
    zero-filled blocks (so every collective of the solve is an
    ``all_reduce``)."""
    group, n, r = mesh_axis(mesh, axis)
    L0 = window.max_landmarks
    Lp = -(-L0 // n) * n
    Lb = Lp // n
    window_p = _pad_landmarks(window, Lp)
    planes_sh, cap = partition_plane_factors(factors.planes, Lp, n)
    pf = PlaneFactors(*(x[r * cap:(r + 1) * cap] for x in planes_sh))
    odom, priors = factors.odom, factors.priors

    own = slice(r * Lb, (r + 1) * Lb)
    w = window_p._replace(planes=window_p.planes[own],
                          lm_valid=window_p.lm_valid[own])
    W = w.R.shape[0]
    dtype, dev = w.t.dtype, w.t.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    diag = torch.eye(W, dtype=dtype, device=dev)[:, :, None, None] * eye6
    free = w.pose_valid & (~w.pose_fixed)
    pm = free.to(dtype)
    lam = damping
    zero = torch.zeros((), dtype=dtype, device=dev)

    costs, norms = [], []
    for _ in range(iters):
        # local plane-factor linearization over the owned block
        r_f, Jp, Jl = _plane_terms(w, pf)
        pi_, li_ = pf.pose_idx.long(), pf.lm_idx.long()
        Hpp_f = _scatter((W, W, 6, 6), (pi_, pi_), _hess(Jp, Jp), w.t)
        Hpl = _scatter((W, Lb, 6, 3), (pi_, li_), _hess(Jp, Jl), w.t)
        Hll = _scatter((Lb, 3, 3), (li_,), _hess(Jl, Jl), w.t)
        bp_f = _scatter((W, 6), (pi_,), _grad(Jp, r_f), w.t)
        bl = _scatter((Lb, 3), (li_,), _grad(Jl, r_f), w.t)
        cost_f = 0.5 * torch.sum(r_f * r_f)

        # replicated pose-only factors (the same on every rank)
        r_o, Ji, Jj = _odom_terms(w, odom)
        oi, oj = odom.i.long(), odom.j.long()
        hij = _hess(Ji, Jj)
        Hpp_op = _scatter((W, W, 6, 6), (oi, oi), _hess(Ji, Ji), w.t)
        Hpp_op.index_put_((oi, oj), hij, accumulate=True)
        Hpp_op.index_put_((oj, oi), hij.transpose(-1, -2), accumulate=True)
        Hpp_op.index_put_((oj, oj), _hess(Jj, Jj), accumulate=True)
        bp_op = _scatter((W, 6), (oi,), _grad(Ji, r_o), w.t)
        bp_op.index_put_((oj,), _grad(Jj, r_o), accumulate=True)
        r_q, Jq = _prior_terms(w, priors)
        qi = priors.idx.long()
        Hpp_op.index_put_((qi, qi), _hess(Jq, Jq), accumulate=True)
        bp_op.index_put_((qi,), _grad(Jq, r_q), accumulate=True)
        cost_op = 0.5 * (torch.sum(r_o * r_o) + torch.sum(r_q * r_q))

        # local Schur contribution of the owned landmark block
        Hll_d = torch.where(w.lm_valid[:, None, None], Hll + lam * eye3,
                            eye3)
        Hll_inv = inv3x3(Hll_d)
        HplWinv = torch.einsum("wlab,lbc->wlac", Hpl, Hll_inv)
        S_part = Hpp_f - torch.einsum("wlac,vlbc->wvab", HplWinv, Hpl)
        rp_part = bp_f - torch.einsum("wlab,lb->wa", HplWinv, bl)

        # the reduced camera system and the plane cost, summed
        S_sum, rp_sum, cost_sum = all_reduce_sum(
            [S_part, rp_part, cost_f.reshape(1)], group)
        S_blocks = S_sum + Hpp_op
        rp = rp_sum + bp_op
        cost = cost_sum[0] + cost_op

        # replicated reduced solve (S is small)
        S_blocks = S_blocks + lam * diag
        S_blocks = S_blocks * pm[:, None, None, None] * pm[None, :, None,
                                                            None]
        S_blocks = S_blocks + diag * (1.0 - pm)[:, None, None, None]
        rp = rp * pm[:, None]
        S = S_blocks.permute(0, 2, 1, 3).reshape(6 * W, 6 * W)
        chol = cholesky_nan(S)
        y = torch.linalg.solve_triangular(chol, -rp.reshape(6 * W, 1),
                                          upper=False)
        dxp = torch.linalg.solve_triangular(chol.T, y, upper=True).reshape(
            W, 6) * pm[:, None]

        # local landmark back-substitution
        rhs = bl + torch.einsum("wlab,wa->lb", Hpl, dxp)
        dxl = -torch.einsum("lab,lb->la", Hll_inv, rhs)
        dxl = dxl * w.lm_valid[:, None].to(dtype)

        # the step guard (sanitize_step's rule) on the summed squared norm,
        # so every rank takes the same decision
        (sq_l,) = all_reduce_sum([torch.sum(dxl * dxl).reshape(1)], group)
        sq = torch.sum(dxp * dxp) + sq_l[0]
        ok = torch.isfinite(sq) & (sq < 1e6)
        dxp = torch.where(ok, dxp, zero)
        dxl = torch.where(ok, dxl, zero)

        R_new, t_new = se3.se3_retract(w.R, w.t, dxp)
        fr = free[:, None]
        w = w._replace(
            R=torch.where(fr[..., None], R_new, w.R),
            t=torch.where(fr, t_new, w.t),
            planes=torch.where(w.lm_valid[:, None],
                               plane_mod.retract(w.planes, dxl), w.planes),
        )
        # the guarded step's landmark norm is the summed one, or zero
        costs.append(cost)
        norms.append(torch.sqrt(torch.sum(dxp ** 2)
                                + torch.where(ok, sq_l[0], zero)))

    # gather the landmark blocks: each rank's block in place, zeros
    # elsewhere, summed (lm_valid does not change)
    planes = torch.zeros((Lp, 4), dtype=dtype, device=dev)
    planes[own] = w.planes
    (planes,) = all_reduce_sum([planes], group)
    w_opt = w._replace(planes=planes[:L0], lm_valid=window.lm_valid)
    return w_opt, solve_stats(costs, norms, iters, damping, dev)
