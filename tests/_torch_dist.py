"""Multi-rank harness of the port's distributed tests (no JAX here).

:func:`run_ranks` starts ``world`` processes, joins them into one
process group on a free localhost port (gloo on the CPU by default, each
rank with one CPU thread; the card's tests name NCCL or a CUDA device),
and
runs a list of cases in every rank, in order; each case returns
numpy arrays, which come back per rank.  A rank that fails, dies or does
not finish within the time limit fails the call (the ranks are killed):
a hung rendezvous cannot hang the suite.  The ranks are spawned (a
fresh interpreter each: about 5 s to import PyTorch and make the first
``torch.func`` transform); they import this module and the port only,
never JAX or the tests that import this module.
"""

from __future__ import annotations

import contextlib
import datetime
import io
import json
import multiprocessing as mp
import queue
import socket
import time
import traceback
import warnings

import numpy as np
import torch

TIMEOUT_S = 120


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(world: int, cases, timeout: float = TIMEOUT_S,
              backend: str = "gloo", device: str = "cpu") -> list:
    """Run every ``(key, name, kwargs)`` of ``cases`` (``name`` names this
    module's function ``case_<name>``) on ``world`` ranks of ``backend``,
    every rank's tensors on ``device``.  Returns, per rank, a dict of each
    case's result by ``key`` (and ``_seconds``: each case's time)."""
    ctx = mp.get_context("spawn")
    port = free_port()
    q = ctx.Queue()
    procs = [ctx.Process(target=_worker,
                         args=(r, world, port, backend, device, cases, q),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    results = {}
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{world} ranks: no result within "
                                   f"{timeout} s (ranks {sorted(results)} "
                                   "finished)")
            try:
                rank, ok, payload = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited without a "
                                       "result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                   f"{payload}")
            results[rank] = payload
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [results[r] for r in range(world)]


def _worker(rank, world, port, backend, device, cases, q):
    global DEVICE
    try:
        torch.set_num_threads(1)
        import torch.distributed as dist

        from pop_up_slam_tpu_torch.parallel.multihost import rank_device

        DEVICE = rank_device(device)     # "cuda": this rank's card
        if DEVICE.type == "cuda":
            torch.cuda.set_device(DEVICE)
        dist.init_process_group(
            backend, init_method=f"tcp://localhost:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=TIMEOUT_S))
        from pop_up_slam_tpu_torch.parallel import make_mesh

        mesh = make_mesh(world, device=DEVICE)
        out, seconds = {}, {}
        for key, name, kw in cases:
            t0 = time.perf_counter()
            out[key] = globals()[f"case_{name}"](mesh, **kw)
            seconds[key] = time.perf_counter() - t0
        out["_seconds"] = seconds
        q.put((rank, True, out))
        dist.destroy_process_group()
    except Exception:  # noqa: BLE001  (reported to the parent)
        q.put((rank, False, traceback.format_exc()))


# ---------------------------------------------------------------------------
# cases: numpy in, numpy out
# ---------------------------------------------------------------------------

DEVICE = torch.device("cpu")     # the rank's device (set by _worker)


def _np(x):
    if isinstance(x, tuple):
        vals = [_np(v) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _problem(window, factors):
    from pop_up_slam_tpu_torch import convert

    return (convert.window_from_numpy(window, DEVICE),
            convert.factors_from_numpy(factors, DEVICE))


def _k5():
    from pop_up_slam_tpu_torch.ops import plane_jacobians

    return plane_jacobians.plane_terms.launches


def case_linearize(mesh, window, factors, analytic_planes=False):
    """The sharded linearization's fields, and the K5 launches it made
    (in the key ``k5``, appended)."""
    from pop_up_slam_tpu_torch.parallel import (pad_factors_for_sharding,
                                                sharded_linearize)

    w, f = _problem(window, factors)
    f = pad_factors_for_sharding(f, mesh.size())
    k5 = _k5()
    lin = sharded_linearize(w, f, mesh, analytic_planes=analytic_planes)
    return _np(tuple(lin)) + (_k5() - k5,)


def _solved(w, stats):
    return {"R": _np(w.R), "t": _np(w.t), "planes": _np(w.planes),
            "cost": _np(stats.cost_history),
            "step_norms": _np(stats.step_norms)}


def case_gn(mesh, window, factors, iters=3, damping=1e-6,
            analytic_planes=False):
    from pop_up_slam_tpu_torch.parallel import distributed_gn_solve

    w, f = _problem(window, factors)
    k5 = _k5()
    out = _solved(*distributed_gn_solve(w, f, mesh, iters=iters,
                                        damping=damping,
                                        analytic_planes=analytic_planes))
    out["k5"] = _k5() - k5
    return out


def case_map_block(mesh, window, factors, iters=3, damping=1e-6):
    from pop_up_slam_tpu_torch.parallel import map_block_gn_solve

    w, f = _problem(window, factors)
    return _solved(*map_block_gn_solve(w, f, mesh, iters=iters,
                                       damping=damping))


def case_kf_linearize(mesh, window, factors):
    from pop_up_slam_tpu_torch.parallel import (keyframe_sharded_linearize,
                                                route_factors_by_keyframe)

    w, f = _problem(window, factors)
    routed = route_factors_by_keyframe(f, w.window_size, mesh.size())
    return _np(tuple(keyframe_sharded_linearize(w, routed, mesh)))


def case_kf_solve(mesh, window, factors, iters=3, damping=1e-6):
    from pop_up_slam_tpu_torch.parallel import keyframe_sharded_gn_solve

    w, f = _problem(window, factors)
    return _solved(*keyframe_sharded_gn_solve(w, f, mesh, iters=iters,
                                              damping=damping))


def _K(K):
    from pop_up_slam_tpu_torch.geometry.camera import Intrinsics

    return Intrinsics.create(*K, device=DEVICE)


def case_popup(mesh, masks, R, t, K, pcfg):
    """The DP pop-up, every rank's block gathered."""
    from pop_up_slam_tpu_torch.parallel import sharded_popup
    from pop_up_slam_tpu_torch.parallel.distributed import (
        all_gather_blocks, mesh_axis)
    from pop_up_slam_tpu_torch.popup import popup as pp

    K, cfg = _K(K), pp.PopupConfig(**pcfg)
    local = sharded_popup(lambda m, R_, t_: pp.pop_up(K, m, R_, t_, cfg),
                          torch.as_tensor(masks, device=DEVICE),
                          torch.as_tensor(R, device=DEVICE),
                          torch.as_tensor(t, device=DEVICE), mesh)
    return {"local": _np(local),
            "all": _np(all_gather_blocks(local, mesh_axis(mesh)[0]))}


def case_runner(mesh, masks, odom_R, odom_t, R0, t0, K, pcfg, scfg, block,
                tail="pad"):
    """``run_sequence_sharded`` with each frame's ``n_kf`` logged, the
    collectives counted and the warnings recorded."""
    from pop_up_slam_tpu_torch.parallel import distributed
    from pop_up_slam_tpu_torch.pipeline import SlamConfig, sharded, slam_init
    from pop_up_slam_tpu_torch.popup import popup as pp

    cfg = SlamConfig(**scfg)
    step, n_kf = sharded.slam_step, []

    def logging_step(*args, **kwargs):
        st, pose = step(*args, **kwargs)
        n_kf.append(int(st.n_kf))
        return st, pose

    for k in distributed.collective_calls:
        distributed.collective_calls[k] = 0
    sharded.slam_step = logging_step
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            st = slam_init(cfg, R0, t0, device=DEVICE)
            st, (R, t) = sharded.run_sequence_sharded(
                st, masks, odom_R, odom_t, _K(K), pp.PopupConfig(**pcfg),
                cfg, mesh, block=block, tail=tail)
    finally:
        sharded.slam_step = step
    return {"R": _np(R), "t": _np(t), "frame_n_kf": np.asarray(n_kf),
            "n_kf": int(st.n_kf), "n_overflow": int(st.n_overflow),
            "store_valid": _np(st.store.valid),
            "collectives": dict(distributed.collective_calls),
            "warnings": [f"{w.category.__name__}: {w.message}"
                         for w in caught]}


def case_smoother(mesh, rec, state, scfg, iters=8, damping=1e-5):
    from pop_up_slam_tpu_torch import convert
    from pop_up_slam_tpu_torch.pipeline import SlamConfig
    from pop_up_slam_tpu_torch.pipeline.smoothing import (
        TrajectoryRecorder, smooth_trajectory)

    cfg = SlamConfig(**scfg)
    kf_R, kf_t, stats = smooth_trajectory(
        TrajectoryRecorder.restore(cfg, rec),
        convert.slam_state_from_numpy(state, DEVICE), cfg, iters=iters,
        damping=damping, mesh=mesh)
    return {"kf_R": kf_R, "kf_t": kf_t, "cost": _np(stats.cost_history)}


def case_cli(mesh, argv):
    """``cli.main(argv)``'s exit code and printed JSON (rank 0 prints)."""
    from pop_up_slam_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    return {"rc": rc, "summary": json.loads(text) if text else None}
