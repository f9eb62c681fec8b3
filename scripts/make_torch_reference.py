"""Write the JAX reference trajectories that the PyTorch port is held against.

Runs the JAX package's chunked frame runner (``run_sequence_chunked``) on
the CPU over the frames of ``bench_data/corridor_inputs.npz`` at
480x640, every frame a keyframe, chunks of 16 frames, and saves the
per-frame pose and the final discrete state.

``gn`` (``pop_up_slam_tpu_torch/data/corridor_ref.npz``): all 144 frames
at the production configuration, ``SlamConfig()`` widths (W=8, L=64,
D=9, 2 GN iterations), fused GN body forced on, with each frame's
``popup_valid`` / ``popup_n_points`` as below, ``popup_R`` /
``popup_t``: the pose each frame's pop-up was given (``current_pose``),
and ``anchor.*``: the ``SlamState`` each frame starts from, one key per
leaf (``anchor.window.R`` ...), stacked over the frames.

``solvers`` (``pop_up_slam_tpu_torch/data/corridor_ref_solvers.npz``),
three runs, keys prefixed ``lm_``, ``dogleg_`` and ``lm24_``:

- ``lm``: ``solver="lm"``, all 144 frames at the production widths;
- ``dogleg``: ``solver="dogleg"``, the same;
- ``lm24``: ``solver="lm"``, ``window_size=24`` (L=64, D=9), the first 48
  frames, so the window fills and slides; 6W = 144 > 128 takes the
  tiled Schur route.

Each run holds ``R``, ``t`` per frame, the final ``n_kf``,
``n_overflow`` and ``store_valid``, ``accepted`` (frames x iterations):
the accept decision of every iteration of every keyframe's solve,
``cost`` (frames x iterations + 1): its cost history, and
``popup_valid`` / ``popup_n_points`` (frames x wall slots): each frame's
pop-up wall validity and column counts, all recorded with host callbacks
around the solver and the pop-up, and ``anchor.*``: the ``SlamState``
each frame starts from, as for ``gn``.  The runs use
``pallas="on"``, the Schur-kernel route (``schur_reduce_pallas``,
interpret mode on the CPU): it solves the reduced system with the
pivot-skip rule, as the port's Schur kernels do, whereas the
``"auto"``/``"off"`` route (``solve_schur``) turns an indefinite system
into NaN and a zero step.  Interpret mode is fast enough here: the three
runs took 27.7 s, 22.8 s and 40.6 s, compiles included, on an 8-vCPU
x86-64 host (the ``gn`` run about 30 s).

``vo`` (``pop_up_slam_tpu_torch/data/corridor_ref_vo.npz``), the fully
monocular runners over the 144 masks alone (no odometry input), from
``slam_init(scfg, R0, t0)``, chunks of 16, the production
``SlamConfig`` with the fused GN body forced on; keys prefixed ``vo_``
(``make_chunked_vo_runner``) and ``fused_vo_``
(``make_chunked_fused_vo_runner``, default fusion arguments:
``max_depth=40``).  Each holds ``R``, ``t``, ``popup_valid`` /
``popup_n_points`` per frame, ``n_matches`` / ``used_prior`` (the
plane-VO step's) per frame, and the end state's ``n_kf``, ``n_overflow``
and ``store_valid``; ``fused_vo_`` also ``filter_valid_count`` (the
valid pixels of the fused filter after each frame) and ``depth_grid``
(the fused depth on a stride-16 grid, frames x 30 x 40), and
``anchor.*``: the VO state (``VOState``, the fused runner's without its
filter) that each frame starts from, one key per leaf
(``anchor.slam.window.R`` ...), stacked over the frames.

Run from the repository root (no argument writes all three files):

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [gn] [solvers] [vo]
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

DATA = os.path.join(_REPO, "pop_up_slam_tpu_torch", "data")
OUT = os.path.join(DATA, "corridor_ref.npz")
OUT_SOLVERS = os.path.join(DATA, "corridor_ref_solvers.npz")
OUT_VO = os.path.join(DATA, "corridor_ref_vo.npz")
VO_GRID = 16      # stride of the recorded fused-depth grid

# name -> (SlamConfig overrides, frames)
SOLVER_RUNS = {
    "lm": (dict(solver="lm"), 144),
    "dogleg": (dict(solver="dogleg"), 144),
    "lm24": (dict(solver="lm", window_size=24), 48),
}


def load_inputs():
    z = np.load(os.path.join(_REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    return masks, z["odom_R"], z["odom_t"], z["R0"], z["t0"]


def _run(n: int, **overrides):
    """The JAX chunked runner over the first ``n`` corridor frames."""
    import jax

    import pop_up_slam_tpu  # noqa: F401  (full-f32 matmul)
    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.pipeline import (
        SlamConfig, run_sequence_chunked, slam_init,
    )
    from pop_up_slam_tpu.popup import popup as pp

    masks, oR, ot, R0, t0 = load_inputs()
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0)
    pcfg = pp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0, **overrides)
    state = slam_init(scfg, R0, t0)
    t_start = time.perf_counter()
    state, (Rs, ts) = run_sequence_chunked(
        state, masks[:n], oR[:n], ot[:n], K, pcfg, scfg, chunk=16,
        donate=False,
    )
    jax.block_until_ready(ts)
    seconds = time.perf_counter() - t_start
    print(f"jax backend={jax.default_backend()} {overrides} {n} frames: "
          f"{seconds:.1f} s (compile included)")
    out = dict(
        R=np.asarray(Rs, np.float32),
        t=np.asarray(ts, np.float32),
        n_kf=np.asarray(state.n_kf, np.int32),
        n_overflow=np.asarray(state.n_overflow, np.int32),
        store_valid=np.asarray(state.store.valid, bool),
        pf_lm=np.asarray(state.pf_lm, np.int32),
    )
    assert np.isfinite(out["t"]).all() and np.isfinite(out["R"]).all()
    return out


def _record_pop_ups():
    """Wrap the reference's ``pop_up`` so that each frame's wall validity,
    column counts and input pose (R_wc, t_wc) are appended, in order, to
    the returned list."""
    import jax

    from pop_up_slam_tpu.popup import popup as jpp

    popups = []
    pop_up = jpp.pop_up

    def recording_pop_up(K, mask, R_wc, t_wc, *args, **kwargs):
        res = pop_up(K, mask, R_wc, t_wc, *args, **kwargs)
        jax.debug.callback(
            lambda *a: popups.append(tuple(np.asarray(x) for x in a)),
            res.valid, res.n_points, R_wc, t_wc, ordered=True)
        return res

    jpp.pop_up = recording_pop_up
    return popups


def _pop_up_keys(popups, n, poses=False):
    out = dict(
        popup_valid=np.stack([p[0] for p in popups]).astype(bool),
        popup_n_points=np.stack([p[1] for p in popups]).astype(np.int32))
    if poses:
        out["popup_R"] = np.stack([p[2] for p in popups]).astype(np.float32)
        out["popup_t"] = np.stack([p[3] for p in popups]).astype(np.float32)
    assert out["popup_valid"].shape[0] == n
    return out


def _record_states(module, name):
    """Wrap ``module.name`` (a step taking the state first) so that the
    state each call starts from is appended, in order, to the returned
    list (as a NamedTuple of numpy arrays), and the wrapper's undo."""
    import jax

    states = []
    step = getattr(module, name)

    def recording(state, *args, **kwargs):
        treedef = jax.tree.structure(state)
        jax.debug.callback(
            lambda *leaves: states.append(
                jax.tree.unflatten(treedef, [np.asarray(x) for x in leaves])),
            *jax.tree.leaves(state), ordered=True)
        return step(state, *args, **kwargs)

    setattr(module, name, recording)
    return states, lambda: setattr(module, name, step)


def write_gn():
    from pop_up_slam_tpu.pipeline import offline

    popups = _record_pop_ups()
    anchors, undo = _record_states(offline, "slam_step")
    try:
        out = _run(144, fused="on")
    finally:
        undo()
    out.update(_pop_up_keys(popups, 144, poses=True))
    assert len(anchors) == 144
    out.update(_flatten("anchor", anchors))
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: n_kf={int(out['n_kf'])} "
          f"n_overflow={int(out['n_overflow'])} "
          f"valid={int(out['store_valid'].sum())} t[-1]={out['t'][-1]}")


def write_solvers():
    import jax

    from pop_up_slam_tpu.pipeline import slam as jslam

    accepted, cost = [], []

    def record(a, c):
        accepted.append(np.asarray(a))
        cost.append(np.asarray(c))

    def recording(solve):
        def wrapped(*args, **kwargs):
            window, stats = solve(*args, **kwargs)
            jax.debug.callback(record, stats.accepted, stats.cost_history,
                               ordered=True)
            return window, stats
        return wrapped

    from pop_up_slam_tpu.pipeline import offline

    popups = _record_pop_ups()
    jslam.lm_solve = recording(jslam.lm_solve)
    jslam.dogleg_solve = recording(jslam.dogleg_solve)
    out = {}
    for name, (overrides, n) in SOLVER_RUNS.items():
        accepted.clear()
        cost.clear()
        popups.clear()
        anchors, undo = _record_states(offline, "slam_step")
        try:
            run = _run(n, pallas="on", **overrides)
        finally:
            undo()
        assert len(anchors) == n
        run.update(_flatten("anchor", anchors))
        run.pop("pf_lm")
        run["accepted"] = np.stack(accepted).astype(bool)
        run["cost"] = np.stack(cost).astype(np.float32)
        run.update(_pop_up_keys(popups, n))
        assert run["accepted"].shape[0] == n, run["accepted"].shape
        out.update({f"{name}_{k}": v for k, v in run.items()})
        print(f"{name}: n_kf={int(run['n_kf'])} "
              f"n_overflow={int(run['n_overflow'])} "
              f"valid={int(run['store_valid'].sum())} "
              f"accepted {int(run['accepted'].sum())}/"
              f"{run['accepted'].size} t[-1]={run['t'][-1]}")
    np.savez_compressed(OUT_SOLVERS, **out)
    print(f"wrote {OUT_SOLVERS}")


def _run_vo(fused: bool):
    """One monocular runner over all 144 corridor masks (see above)."""
    import jax

    import pop_up_slam_tpu  # noqa: F401  (full-f32 matmul)
    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.pipeline import offline, slam_init
    from pop_up_slam_tpu.pipeline.slam import SlamConfig
    from pop_up_slam_tpu.popup import popup as jpp

    masks, _, _, R0, t0 = load_inputs()
    n, H, W = masks.shape
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0)
    pcfg = jpp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0, fused="on")
    vo_rec, filt_rec = [], []
    plane_vo_step = offline.plane_vo_step

    def recording_vo(*args, **kwargs):
        res = plane_vo_step(*args, **kwargs)
        jax.debug.callback(
            lambda m, u: vo_rec.append((np.asarray(m), np.asarray(u))),
            res.n_matches, res.used_prior, ordered=True)
        return res

    offline.plane_vo_step = recording_vo
    anchors, undo = _record_states(offline, "_vo_frame_core")
    slam = slam_init(scfg, R0, t0)
    if fused:
        import pop_up_slam_tpu.fusion as jfusion

        fuse = jfusion.fuse_observation

        def recording_fuse(*args, **kwargs):
            flt = fuse(*args, **kwargs)
            jax.debug.callback(
                lambda v: filt_rec.append(int(np.asarray(v).sum())),
                flt.valid, ordered=True)
            return flt

        jfusion.fuse_observation = recording_fuse
        state = offline.fused_vo_init(slam, scfg.max_det, H, W)
        run = offline.make_chunked_fused_vo_runner(K, pcfg, scfg,
                                                   donate=False)
    else:
        state = offline.vo_init(slam, scfg.max_det)
        run = offline.make_chunked_vo_runner(K, pcfg, scfg, donate=False)
    popups = _record_pop_ups()
    t_start = time.perf_counter()
    Rs, ts, grids = [], [], []
    try:
        for s0 in range(0, n, 16):
            state, out = run(state, masks[s0:s0 + 16])
            (R, t), depth = (out if fused else (out, None))
            Rs.append(np.asarray(R))
            ts.append(np.asarray(t))
            if fused:
                grids.append(np.asarray(depth)[:, ::VO_GRID, ::VO_GRID])
    finally:
        offline.plane_vo_step = plane_vo_step
        undo()
        if fused:
            jfusion.fuse_observation = fuse
    jax.effects_barrier()
    print(f"{'fused_vo' if fused else 'vo'} {n} frames: "
          f"{time.perf_counter() - t_start:.1f} s (compile included)")
    slam = state.vo.slam if fused else state.slam
    out = dict(
        R=np.concatenate(Rs).astype(np.float32),
        t=np.concatenate(ts).astype(np.float32),
        n_kf=np.asarray(slam.n_kf, np.int32),
        n_overflow=np.asarray(slam.n_overflow, np.int32),
        store_valid=np.asarray(slam.store.valid, bool),
        n_matches=np.stack([m for m, _ in vo_rec]).astype(np.int32),
        used_prior=np.stack([u for _, u in vo_rec]).astype(bool),
    )
    out.update(_pop_up_keys(popups, n))
    out.update(_flatten("anchor", anchors))
    assert out["n_matches"].shape == (n,) and len(anchors) == n
    if fused:
        out["filter_valid_count"] = np.asarray(filt_rec, np.int32)
        out["depth_grid"] = np.concatenate(grids).astype(np.float32)
        assert out["filter_valid_count"].shape == (n,)
        assert np.isfinite(out["depth_grid"]).all()
    assert np.isfinite(out["t"]).all() and np.isfinite(out["R"]).all()
    return out


def _flatten(prefix, trees):
    """Stack the leaves of a list of (nested) NamedTuples: one key per
    leaf, ``prefix.field.subfield``."""
    out = {}
    for name in trees[0]._fields:
        leaves = [getattr(t, name) for t in trees]
        key = f"{prefix}.{name}"
        if hasattr(leaves[0], "_fields"):
            out.update(_flatten(key, leaves))
        else:
            out[key] = np.stack(leaves)
    return out


def write_vo():
    from pop_up_slam_tpu.popup import popup as jpp

    pop_up = jpp.pop_up
    out = {}
    for name, fused in (("vo", False), ("fused_vo", True)):
        try:
            run = _run_vo(fused)
        finally:
            jpp.pop_up = pop_up
        out.update({f"{name}_{k}": v for k, v in run.items()})
        print(f"{name}: n_kf={int(run['n_kf'])} "
              f"n_overflow={int(run['n_overflow'])} "
              f"valid={int(run['store_valid'].sum())} "
              f"matches {run['n_matches'].min()}-{run['n_matches'].max()} "
              f"prior {int(run['used_prior'].sum())} t[-1]={run['t'][-1]}")
    np.savez_compressed(OUT_VO, **out)
    print(f"wrote {OUT_VO}: {os.path.getsize(OUT_VO)} bytes")


def main(argv):
    which = set(argv) or {"gn", "solvers", "vo"}
    unknown = which - {"gn", "solvers", "vo"}
    if unknown:
        raise SystemExit(f"unknown reference(s) {sorted(unknown)}; "
                         "choose from gn, solvers, vo")
    os.makedirs(DATA, exist_ok=True)
    if "gn" in which:
        write_gn()
    if "solvers" in which:
        write_solvers()
    if "vo" in which:
        write_vo()


if __name__ == "__main__":
    main(sys.argv[1:])
