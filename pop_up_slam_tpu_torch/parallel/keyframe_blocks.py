"""Keyframe-block-partitioned linearization: poses owned per rank.

Port of ``pop_up_slam_tpu/parallel/keyframe_blocks.py``.  Each rank owns
a contiguous block of the window's keyframes, holds only its block's
poses, and evaluates every factor that lands on its block: odometry
factors go to the owner of their later pose, plane factors and priors to
the owner of their pose.  A cross-boundary odometry factor needs the last
pose of the left neighbour, which arrives by one halo exchange
(``batch_isend_irecv``, the reference's ``ppermute``) along a **chain**:
rank k sends to rank k + 1, and rank 0, which has no left neighbour,
takes the identity pose in its halo slot (never indexed by a routed
factor).  Landmark planes are replicated, the dual of :mod:`.map_blocks`.
The per-rank blocked systems are summed (``all_reduce``), so the result
equals ``factors.graph.linearize``'s to f32 tolerance.  The terms are the
per-factor ``jacfwd`` ones, without robust weights, as the reference's.

Cost note (the reference's): :func:`route_factors_by_keyframe` routes
with a host numpy pass per call.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..factors.graph import (
    Factors,
    Linearization,
    OdomFactors,
    PlaneFactors,
    PosePriors,
    Window,
    _grad,
    _hess,
    _odom_terms,
    _plane_terms,
    _prior_terms,
)
from ..solver.gauss_newton import apply_update, sanitize_step
from ..solver.schur import solve_schur
from .distributed import (all_reduce_sum, collective_calls, mesh_axis,
                          solve_stats)


class RoutedFactors(NamedTuple):
    """Host-routed factors: per-shard blocks with halo-local pose indices
    (slot 0 = the left neighbour's boundary pose) and the global indices
    for the scatter back."""

    odom: OdomFactors       # i/j halo-local
    odom_gi: torch.Tensor   # (Oc,) global i
    odom_gj: torch.Tensor   # (Oc,) global j
    planes: PlaneFactors    # pose_idx halo-local; lm_idx global
    plane_gp: torch.Tensor  # (Fc,) global pose index
    priors: PosePriors      # idx halo-local
    prior_gi: torch.Tensor  # (Pc,) global index


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def route_factors_by_keyframe(factors: Factors, W: int,
                              n_shards: int) -> RoutedFactors:
    """Group factors by keyframe-block owner (host numpy, static), on the
    factors' device.  Odometry factors must satisfy
    i >= owner_block_start - 1 (the halo holds one boundary pose, which a
    sliding-window odometry chain always satisfies)."""
    assert W % n_shards == 0, (W, n_shards)
    Wb = W // n_shards
    dev = factors.odom.valid.device

    def owners(idx, valid):
        own = np.where(valid, idx // Wb, 0)
        per = [np.where(own == s)[0] for s in range(n_shards)]
        return own, per, max(1, max(len(ix) for ix in per))

    def pack(x, per, cap):
        x = _np(x)
        out = np.zeros((n_shards * cap,) + x.shape[1:], dtype=x.dtype)
        for s, ix in enumerate(per):
            out[s * cap: s * cap + len(ix)] = x[ix]
        return torch.as_tensor(out, device=dev)

    def local_idx(g, per, cap):
        out = np.zeros((n_shards * cap,), np.int32)
        for s, ix in enumerate(per):
            out[s * cap: s * cap + len(ix)] = g[ix] - s * Wb + 1
        return torch.as_tensor(out, device=dev)

    # odometry: owner = block of j
    od = factors.odom
    i_np, j_np, v_np = _np(od.i), _np(od.j), _np(od.valid)
    owner, per, cap = owners(j_np, v_np)
    for f in np.where(v_np)[0]:
        assert i_np[f] >= owner[f] * Wb - 1, (
            f"odom factor {f} spans more than one boundary "
            f"(i={i_np[f]}, j={j_np[f]}); keyframe sharding needs "
            "chain-structured odometry")
    odom_local = OdomFactors(
        i=local_idx(i_np, per, cap), j=local_idx(j_np, per, cap),
        R_meas=pack(od.R_meas, per, cap), t_meas=pack(od.t_meas, per, cap),
        sqrt_info=pack(od.sqrt_info, per, cap),
        valid=pack(od.valid, per, cap))
    odom_gi, odom_gj = pack(i_np, per, cap), pack(j_np, per, cap)

    # plane factors: owner = block of pose_idx
    pf = factors.planes
    p_np = _np(pf.pose_idx)
    _, per_p, cap_p = owners(p_np, _np(pf.valid))
    planes_local = PlaneFactors(
        pose_idx=local_idx(p_np, per_p, cap_p),
        lm_idx=pack(pf.lm_idx, per_p, cap_p),
        pi_meas=pack(pf.pi_meas, per_p, cap_p),
        sqrt_info=pack(pf.sqrt_info, per_p, cap_p),
        valid=pack(pf.valid, per_p, cap_p))
    plane_gp = pack(p_np, per_p, cap_p)

    # priors: owner = block of idx
    pr = factors.priors
    q_np = _np(pr.idx)
    _, per_q, cap_q = owners(q_np, _np(pr.valid))
    priors_local = PosePriors(
        idx=local_idx(q_np, per_q, cap_q), R=pack(pr.R, per_q, cap_q),
        t=pack(pr.t, per_q, cap_q),
        sqrt_info=pack(pr.sqrt_info, per_q, cap_q),
        valid=pack(pr.valid, per_q, cap_q))
    prior_gi = pack(q_np, per_q, cap_q)

    return RoutedFactors(odom=odom_local, odom_gi=odom_gi, odom_gj=odom_gj,
                         planes=planes_local, plane_gp=plane_gp,
                         priors=priors_local, prior_gi=prior_gi)


def _halo(R_last: torch.Tensor, t_last: torch.Tensor, group, n: int,
          r: int):
    """The left neighbour's last pose (rank r - 1's), along the chain
    rank k -> k + 1; the identity on rank 0."""
    send = torch.cat([R_last.reshape(9), t_last.reshape(3)]).contiguous()
    recv = torch.zeros_like(send)
    ops = []
    if r + 1 < n:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, r + 1), group))
    if r > 0:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, r - 1), group))
    if ops:
        collective_calls["batch_isend_irecv"] += 1
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    if r == 0:
        return (torch.eye(3, dtype=R_last.dtype, device=R_last.device),
                torch.zeros_like(t_last))
    return recv[:9].view(3, 3), recv[9:]


def keyframe_sharded_linearize(window: Window, routed: RoutedFactors,
                               mesh: DeviceMesh,
                               axis: str = "d") -> Linearization:
    """Linearize with the poses sharded per keyframe block and one halo
    exchange.  ``routed`` comes from :func:`route_factors_by_keyframe` at
    the same mesh size.  Returns the replicated Linearization, equal to
    ``linearize(window, factors)``'s (``jacfwd`` terms) to f32
    tolerance."""
    group, n, r = mesh_axis(mesh, axis)
    W, L = window.window_size, window.max_landmarks
    Wb = W // n
    dtype, dev = window.t.dtype, window.t.device
    own = slice(r * Wb, (r + 1) * Wb)
    R_own, t_own = window.R[own], window.t[own]
    halo_R, halo_t = _halo(R_own[-1], t_own[-1], group, n, r)
    view = window._replace(R=torch.cat([halo_R[None], R_own]),
                           t=torch.cat([halo_t[None], t_own]))

    def block(x):
        c = x.shape[0] // n
        return x[r * c:(r + 1) * c]

    rf = RoutedFactors(*(type(v)(*(block(x) for x in v))
                         if isinstance(v, tuple) else block(v)
                         for v in routed))
    # an invalid factor routed to rank 0 keeps its global pose index + 1,
    # which can lie past the view: clamp, as the reference's gather does
    # (its terms are masked out)
    rf = rf._replace(
        odom=rf.odom._replace(i=rf.odom.i.clamp(0, Wb),
                              j=rf.odom.j.clamp(0, Wb)),
        planes=rf.planes._replace(pose_idx=rf.planes.pose_idx.clamp(0, Wb)),
        priors=rf.priors._replace(idx=rf.priors.idx.clamp(0, Wb)))
    r_o, Ji, Jj = _odom_terms(view, rf.odom)
    r_f, Jp, Jl = _plane_terms(view, rf.planes)
    r_q, Jq = _prior_terms(view, rf.priors)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=dev)

    Hpp, Hpl, Hll, bp, bl = z(W, W, 6, 6), z(W, L, 6, 3), z(L, 3, 3), \
        z(W, 6), z(L, 3)
    oi, oj = rf.odom_gi.long(), rf.odom_gj.long()
    hij = _hess(Ji, Jj)
    Hpp.index_put_((oi, oi), _hess(Ji, Ji), accumulate=True)
    Hpp.index_put_((oi, oj), hij, accumulate=True)
    Hpp.index_put_((oj, oi), hij.transpose(-1, -2), accumulate=True)
    Hpp.index_put_((oj, oj), _hess(Jj, Jj), accumulate=True)
    bp.index_put_((oi,), _grad(Ji, r_o), accumulate=True)
    bp.index_put_((oj,), _grad(Jj, r_o), accumulate=True)

    pi_, li_ = rf.plane_gp.long(), rf.planes.lm_idx.long()
    Hpp.index_put_((pi_, pi_), _hess(Jp, Jp), accumulate=True)
    Hpl.index_put_((pi_, li_), _hess(Jp, Jl), accumulate=True)
    Hll.index_put_((li_,), _hess(Jl, Jl), accumulate=True)
    bp.index_put_((pi_,), _grad(Jp, r_f), accumulate=True)
    bl.index_put_((li_,), _grad(Jl, r_f), accumulate=True)

    qi = rf.prior_gi.long()
    Hpp.index_put_((qi, qi), _hess(Jq, Jq), accumulate=True)
    bp.index_put_((qi,), _grad(Jq, r_q), accumulate=True)

    cost = 0.5 * (torch.sum(r_o * r_o) + torch.sum(r_f * r_f)
                  + torch.sum(r_q * r_q))
    Hpp, Hpl, Hll, bp, bl, c = all_reduce_sum(
        [Hpp, Hpl, Hll, bp, bl, cost.reshape(1)], group)
    return Linearization(Hpp, Hpl, Hll, bp, bl, c[0])


def keyframe_sharded_gn_solve(window: Window, factors: Factors,
                              mesh: DeviceMesh, iters: int = 5,
                              damping: float = 1e-6, axis: str = "d"):
    """Gauss-Newton over the keyframe-sharded linearization (replicated
    reduced solve).  ``W`` must divide by the mesh size.  Equal to
    ``solver.gn_solve``'s (``jacfwd`` terms) to f32 tolerance."""
    _, n, _ = mesh_axis(mesh, axis)
    routed = route_factors_by_keyframe(factors, window.window_size, n)
    dev = window.t.device
    costs, norms = [], []
    for _ in range(iters):
        lin = keyframe_sharded_linearize(window, routed, mesh, axis)
        sol = solve_schur(lin, window, damping)
        dxp, dxl, _ = sanitize_step(sol.dxp, sol.dxl)
        window = apply_update(window, dxp, dxl, presanitized=True)
        costs.append(lin.cost)
        norms.append(torch.sqrt(torch.sum(dxp ** 2) + torch.sum(dxl ** 2)))
    return window, solve_stats(costs, norms, iters, damping, dev)
