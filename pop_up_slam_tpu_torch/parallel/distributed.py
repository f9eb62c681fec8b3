"""Distributed plane SLAM: factor-sharded Schur assembly and a
data-parallel front end, on ``torch.distributed``.

Port of ``pop_up_slam_tpu/parallel/distributed.py``.  A mesh is a 1-D
:class:`~torch.distributed.device_mesh.DeviceMesh` with a named axis, one
process (rank) per device; the reference's ``shard_map`` regions become
code that every rank runs on its own block:

- **DP over frames** (:func:`sharded_popup`): each rank pops up its
  contiguous block of the frame batch, vmapped.
- **Factor-sharded Schur assembly** (:func:`sharded_linearize`): each rank
  linearizes a contiguous block of every (padded) factor batch into its
  share of the normal equations (Hpp, Hpl, Hll, bp, bl, cost), and one
  ``all_reduce`` (the reference's ``psum``) sums them into the replicated
  blocked system.  With ``analytic_planes=True`` the plane terms of a
  CUDA rank are the plane-Jacobian kernel's, launched on its block.
- :func:`distributed_gn_solve`: fixed-iteration Gauss-Newton whose
  linearization is the sharded one; the small reduced solve runs
  replicated on every rank.

Every rank holds the replicated inputs (window, factors, frames) in full
and computes on its block; the collectives are counted in
:data:`collective_calls`.
"""

from __future__ import annotations

import socket

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
    linearize,
)
from ..solver.gauss_newton import SolveStats, apply_update, sanitize_step
from ..solver.schur import solve_schur
from .multihost import _backend, _mesh, init_distributed, rank_device

# collectives issued by this package, by kind (instrumentation: a caller
# zeroes them around a run and reads them after)
collective_calls = {"all_reduce": 0, "all_gather": 0,
                    "batch_isend_irecv": 0}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: int | None = None, axis: str = "d",
              device=None) -> DeviceMesh:
    """1-D mesh over every rank of the process group.

    Joins ``torchrun``'s group when its environment is set; with no
    process group and no launcher it starts a world of one on a free
    localhost port, so a single-process caller needs nothing else.  The
    backend is NCCL for a CUDA ``device`` (the default; each rank on
    ``cuda:{LOCAL_RANK}``), gloo for the CPU.  Raises when ``n_devices``
    is given and differs from the world size."""
    dev = rank_device(device)
    init_distributed(device=dev)
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(
                f"make_mesh: {n_devices} devices asked, but no process "
                "group exists (start one process per device, e.g. with "
                "torchrun)")
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            _backend(dev), init_method=f"tcp://localhost:{_free_port()}",
            world_size=1, rank=0)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices asked, the "
                         f"process group has {world} ranks")
    return _mesh(dev.type, torch.arange(world), (axis,))


def mesh_axis(mesh: DeviceMesh, axis: str = "d"):
    """(process group, size, this rank's index) of ``mesh``'s ``axis``."""
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group), dist.get_rank(group)


def _rebuild(tree, vals):
    """``vals`` in the type of ``tree`` (a NamedTuple or a tuple)."""
    return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)


def all_reduce_sum(xs, group) -> list:
    """The element-wise sum over ``group`` of each tensor of ``xs`` (all
    of one dtype and device), in one ``all_reduce`` of a flat buffer."""
    flat = torch.cat([x.reshape(-1) for x in xs])
    collective_calls["all_reduce"] += 1
    dist.all_reduce(flat, group=group)
    out, o = [], 0
    for x in xs:
        out.append(flat[o:o + x.numel()].view(x.shape))
        o += x.numel()
    return out


def all_gather_blocks(tree, group):
    """Each leaf of ``tree`` (this rank's contiguous block of a leading
    axis) gathered into the whole axis, rank blocks in order: one
    ``all_gather`` per leaf (booleans travel as uint8).  The list form:
    ``all_gather_into_tensor`` is deprecated in newer PyTorch releases."""
    n = dist.get_world_size(group)
    vals = []
    for x in tree:
        src = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
        parts = [torch.empty_like(src) for _ in range(n)]
        collective_calls["all_gather"] += 1
        dist.all_gather(parts, src, group=group)
        out = torch.cat(parts)
        vals.append(out.to(torch.bool) if x.dtype == torch.bool else out)
    return _rebuild(tree, vals)


def _block(tree, n: int, r: int):
    """Block ``r`` of ``n`` of every leaf's leading axis."""
    size = tree[0].shape[0]
    assert size % n == 0, (size, n)
    s = size // n
    return _rebuild(tree, [x[r * s:(r + 1) * s] for x in tree])


def _pad_batch(batch, empty_fn, n: int):
    pad = (-batch[0].shape[0]) % n
    if pad == 0:
        return batch
    filler = empty_fn(pad, device=batch[0].device)
    return type(batch)(*(torch.cat([a, b.to(a.dtype)])
                         for a, b in zip(batch, filler)))


def pad_factors_for_sharding(factors: Factors, n_shards: int) -> Factors:
    """Pad every factor batch to a multiple of the mesh size with each
    type's ``empty()`` (``valid=False``, identity-valued measurements).
    Zero filler is not safe: the masked linearization evaluates every
    entry, and ``jacfwd`` through ``so3_log`` or the plane normalization
    at an all-zero rotation or plane gives NaN, which the 0/1 mask keeps
    (the reference's note)."""
    return Factors(
        odom=_pad_batch(factors.odom, OdomFactors.empty, n_shards),
        planes=_pad_batch(factors.planes, PlaneFactors.empty, n_shards),
        priors=_pad_batch(factors.priors, PosePriors.empty, n_shards),
    )


def sharded_linearize(window: Window, factors: Factors, mesh: DeviceMesh,
                      axis: str = "d", analytic_planes: bool = False,
                      robust=None) -> Linearization:
    """Each rank linearizes its block of the factors; one ``all_reduce``
    sums the blocks' normal equations.

    ``factors`` must already be padded to the mesh size
    (:func:`pad_factors_for_sharding`).  The window is replicated, and so
    is the result.  ``analytic_planes`` / ``robust`` thread through to
    :func:`..factors.graph.linearize` as in the single-device solver (IRLS
    weights are per factor, so sharding commutes with them)."""
    group, n, r = mesh_axis(mesh, axis)
    local = Factors(*(_block(b, n, r) for b in factors))
    lin = linearize(window, local, analytic_planes=analytic_planes,
                    robust=robust)
    return Linearization(*all_reduce_sum(list(lin), group))


def solve_stats(costs, norms, iters: int, damping: float, dev) -> SolveStats:
    """The fixed-iteration solvers' SolveStats, as the reference's: each
    iteration's linearization cost (the last repeated), step norms,
    constant damping, every step accepted."""
    costs = torch.stack(costs) if costs else torch.zeros((0,), device=dev)
    return SolveStats(
        cost_history=torch.cat([costs, costs[-1:]]),
        step_norms=torch.stack(norms) if norms else torch.zeros((0,),
                                                              device=dev),
        lambdas=torch.full((iters,), damping, device=dev),
        accepted=torch.ones((iters,), dtype=torch.bool, device=dev),
    )


def distributed_gn_solve(window: Window, factors: Factors, mesh: DeviceMesh,
                         iters: int = 5, damping: float = 1e-6,
                         axis: str = "d", analytic_planes: bool = False,
                         robust=None):
    """Gauss-Newton with the factor-sharded Schur assembly; the reduced
    solve (``solve_schur``) runs replicated on every rank.  Returns
    (window, SolveStats) equal to ``solver.gn_solve``'s to f32 tolerance
    (the reference's cost history: each iteration's linearization cost,
    the last repeated)."""
    _, n, _ = mesh_axis(mesh, axis)
    factors = pad_factors_for_sharding(factors, n)
    dev = window.t.device
    costs, norms = [], []
    for _ in range(iters):
        lin = sharded_linearize(window, factors, mesh, axis,
                                analytic_planes=analytic_planes,
                                robust=robust)
        sol = solve_schur(lin, window, damping)
        dxp, dxl, _ = sanitize_step(sol.dxp, sol.dxl)
        window = apply_update(window, dxp, dxl, presanitized=True)
        costs.append(lin.cost)
        norms.append(torch.sqrt(torch.sum(dxp ** 2) + torch.sum(dxl ** 2)))
    return window, solve_stats(costs, norms, iters, damping, dev)


def sharded_popup(popup_fn, masks: torch.Tensor, R_wc: torch.Tensor,
                  t_wc: torch.Tensor, mesh: DeviceMesh, axis: str = "d"):
    """DP front end: this rank's contiguous block of the frame batch
    (B / mesh size frames; B a multiple of the mesh size) through the
    single-frame pop-up ``popup_fn(mask, R, t) -> tuple``, vmapped.

    Returns this rank's block of the outputs, frames ``[r B/n, (r+1) B/n)``
    (the reference's frame-sharded ``out_specs``); a caller that needs
    every frame gathers them (:func:`all_gather_blocks`)."""
    _, n, r = mesh_axis(mesh, axis)
    m, R, t = _block((masks, R_wc, t_wc), n, r)
    return torch.func.vmap(popup_fn)(m, R, t)
