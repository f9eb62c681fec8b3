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

``tum`` (``pop_up_slam_tpu_torch/data/corridor_ref_tum.npz``): the
TUM entry point.  A TUM tree is written with the port's
``write_tum_tree``: seg PNGs are the 144 masks, ground truth their own
poses (``synthetic.corridor_trajectory(145)[1:]``, as
``scripts/gen_bench_inputs.py`` rendered them), stamps 30 fps with the
fixture's ground-truth jitter.  The JAX ``run_tum_sequence`` runs on it
with the ``tum_fr3`` preset at intrinsics (320, 320, 320, 240), 480x640,
the fused GN body forced on (as the port runs K1 on the GPU),
``gt_perturb``, ``smooth=True``, seed 0, checkpointing at the end (the
snapshot gives its filtering trajectory, recorder and final state).
Keys: ``gt_R`` / ``gt_t`` / ``stamps`` (the tree's inputs), ``est_R`` /
``est_t`` (every frame's estimate), ``frame_kf`` (each frame's keyframe
index) and ``n_kf``, ``rec.*`` (the recorder's ``snapshot()``),
``state.*`` (the final ``SlamState``, one key per leaf with a leading
axis of 1), ``popup_valid`` / ``popup_n_points`` (frames 1-143),
``kf_R`` / ``kf_t`` (the smoothed keyframes: ``smooth_trajectory`` on
that recorder and state, as the runner calls it), ``pose_cov`` /
``plane_cov`` (``recover_marginals`` of the final window, as the runner
calls it), ``ate_rmse_m``, ``ate_filter_rmse_m``, ``pose_trans_std_m``,
``pose_rot_std_rad`` (the summary's), and ``popup_demo_*``: the JAX
CLI's ``popup_demo`` summary (``n_wall_planes``, the depth's median and
p95 relative error).

``batched`` (``pop_up_slam_tpu_torch/data/corridor_ref_batched.npz``):
the JAX ``run_sequence_batched`` over the 144 frames at the ``gn``
configuration (fused GN body on), chunks of 16.  Keys: ``R`` / ``t`` per
frame, the end state's ``n_kf``, ``n_overflow``, ``store_valid``,
``frame_n_kf`` (``n_kf`` after each frame: its keyframe decisions),
``chunk.*`` (the ``SlamState`` each chunk starts from, one key per leaf,
stacked over the chunks), ``dr_R`` / ``dr_t`` (each frame's dead-reckoned
pop-up pose), ``popup_valid`` / ``popup_n_points`` (each frame's batched
pop-up, recorded inside the runner's ``vmap``), and the pretrained
SegNetLite's logits on two 64x96 synthetic frames: ``segnet_rgb8`` (the
frames as uint8; the network reads ``rgb8 / 255``) and ``segnet_logits``
(flax's ``apply`` on the CPU), and ``problem.*``: the reference's
``build_corridor_problem`` at ``PROBLEM_KW`` (``problem.draws.*``: its
``jax.random`` draws, ``problem.window.*`` / ``problem.factors.*``: its
output).  It also writes two PNG fixtures with the
reference's libpng codec (``native/``, adaptive row filters):
``png_fixture_rgb.png`` (120x160 RGB) and ``png_fixture_gray16.png``
(120x160 16-bit gray), and their pixels into
``png_fixture_pixels.npz`` (``rgb``, ``gray16``, and ``*_filters``: the
filter byte of each row).

``sharded`` (``pop_up_slam_tpu_torch/data/corridor_ref_sharded.npz``):
the JAX package's multi-device paths on a 2-device CPU mesh
(``--xla_force_host_platform_device_count``, set by this script before
JAX starts), compiled once each:

- ``run_sequence_sharded`` over the 144 corridor frames at the ``gn``
  configuration, block 16: ``R`` / ``t`` per frame, ``frame_n_kf``
  (``n_kf`` after each frame), the end state's ``n_kf``, ``n_overflow``
  and ``store_valid``, ``block.*`` (the ``SlamState`` each block starts
  from, one key per leaf, stacked over the blocks), and the DP pop-up:
  ``popup_R`` / ``popup_t`` (each frame's predicted pose) and
  ``popup_valid`` / ``popup_n_points``;
- the same runner on the small stream of
  ``tests/test_sharded_runner.py``'s fast test (48x64, 10 frames, W=4,
  L=16, block 4, the tail padded), keys prefixed ``small.``: its inputs
  (``masks``, ``gt_R`` / ``gt_t``, ``odom_R`` / ``odom_t``) and the
  same outputs;
- ``smooth_trajectory(mesh=)`` on the TUM recorder and state of
  ``corridor_ref_tum.npz``: ``mesh_kf_R`` / ``mesh_kf_t``;
- the JAX CLI's ``run --config single_host`` (64 frames, 480x640, the
  mesh's two devices): its summary, keys prefixed ``cli_single_host.``.

Run from the repository root (no argument writes every file):

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [gn] [solvers] [vo] [tum] [batched] [sharded]
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
OUT_TUM = os.path.join(DATA, "corridor_ref_tum.npz")
OUT_BATCHED = os.path.join(DATA, "corridor_ref_batched.npz")
OUT_PNG = os.path.join(DATA, "png_fixture_pixels.npz")
OUT_SHARDED = os.path.join(DATA, "corridor_ref_sharded.npz")
SHARDED_DEVICES = 2    # the CPU mesh of the ``sharded`` references
TUM_INTRINSICS = (320.0, 320.0, 320.0, 240.0)
VO_GRID = 16      # stride of the recorded fused-depth grid
PROBLEM_KW = dict(noise_odom_t=0.05, noise_odom_r=0.02, noise_plane=0.01,
                  seed=3, lm_perturb=0.05)

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


def tum_inputs():
    """(masks, gt_R, gt_t, stamps) of the TUM tree: the committed masks,
    their own poses, 30 fps from t = 1000 s (the fixture's stamps)."""
    import pop_up_slam_tpu  # noqa: F401  (full-f32 matmul)
    from pop_up_slam_tpu.io import synthetic

    masks = load_inputs()[0]
    Rs, ts = synthetic.corridor_trajectory(masks.shape[0] + 1)
    stamps = 1000.0 + np.arange(masks.shape[0]) / 30.0
    return (masks, np.asarray(Rs[1:], np.float32),
            np.asarray(ts[1:], np.float32), stamps)


def write_tum():
    import contextlib
    import io
    import json
    import tempfile

    import jax

    from pop_up_slam_tpu import cli as jcli
    from pop_up_slam_tpu.config import get_config
    from pop_up_slam_tpu.factors.graph import linearize
    from pop_up_slam_tpu.pipeline.slam import _build_factors
    from pop_up_slam_tpu.pipeline.smoothing import (
        TrajectoryRecorder, smooth_trajectory)
    from pop_up_slam_tpu.pipeline import slam_init
    from pop_up_slam_tpu.runners.tum_runner import (
        _snapshot, run_tum_sequence)
    from pop_up_slam_tpu.solver import recover_marginals
    from pop_up_slam_tpu.utils.checkpoint import load_state
    from pop_up_slam_tpu_torch.io.tum_fixture import write_tum_tree

    masks, gt_R, gt_t, stamps = tum_inputs()
    fx, fy, cx, cy = TUM_INTRINSICS
    popups = _record_pop_ups()
    with tempfile.TemporaryDirectory() as root:
        write_tum_tree(os.path.join(root, "seq"), masks, gt_R, gt_t, stamps)
        ck = os.path.join(root, "ck.npz")
        cfg = get_config("tum_fr3", sequence_dir=os.path.join(root, "seq"),
                         fx=fx, fy=fy, cx=cx, cy=cy, height=480, width=640,
                         checkpoint_path=ck)
        # the fused GN body, as the reference runs on its accelerator and
        # the port on the GPU (K1); "auto" on the CPU is the per-op solve
        cfg = cfg._replace(slam=cfg.slam._replace(fused="on"))
        t_start = time.perf_counter()
        summary = run_tum_sequence(cfg, odometry="gt_perturb", smooth=True)
        jax.effects_barrier()
        print(f"tum run: {time.perf_counter() - t_start:.1f} s "
              f"{json.dumps(summary)}")
        scfg = cfg.slam
        like = _snapshot(slam_init(scfg, gt_R[0], gt_t[0]), [gt_R[0]],
                         [gt_t[0]], (np.eye(3), np.zeros(3)),
                         TrajectoryRecorder(scfg, gt_R[0], gt_t[0]))
        snap, meta = load_state(ck, like)
    assert int(meta["next_k"]) == masks.shape[0]
    state = snap["state"]
    rec = TrajectoryRecorder.restore(scfg, snap["recorder"])
    kf_R, kf_t, _ = smooth_trajectory(rec, state, scfg, iters=8,
                                      damping=scfg.damping)
    marg = recover_marginals(linearize(state.window,
                                       _build_factors(state, scfg)),
                             state.window)
    n = masks.shape[0]
    out = dict(
        gt_R=gt_R, gt_t=gt_t, stamps=stamps,
        est_R=np.asarray(snap["est_R"], np.float32),
        est_t=np.asarray(snap["est_t"], np.float32),
        frame_kf=np.asarray(rec.frame_kf, np.int32),
        n_kf=np.asarray(state.n_kf, np.int32),
        n_overflow=np.asarray(state.n_overflow, np.int32),
        kf_R=np.asarray(kf_R, np.float32), kf_t=np.asarray(kf_t, np.float32),
        pose_cov=np.asarray(marg.pose_cov, np.float32),
        plane_cov=np.asarray(marg.plane_cov, np.float32),
    )
    for k in ("ate_rmse_m", "ate_filter_rmse_m", "pose_trans_std_m",
              "pose_rot_std_rad"):
        out[k] = np.asarray(summary[k], np.float64)
    out.update({f"rec.{k}": np.asarray(v)
                for k, v in rec.snapshot().items()})
    out.update(_flatten("state", [jax.tree.map(np.asarray, state)]))
    out.update(_pop_up_keys(popups, n - 1))
    assert out["est_t"].shape == (n, 3) and out["frame_kf"].shape == (n - 1,)
    assert int(out["n_kf"]) == int(summary["n_keyframes"]) == rec.n_kf
    for k in ("est_t", "kf_t", "pose_cov", "plane_cov"):
        assert np.isfinite(out[k]).all(), k
    # the popup_demo entry point (its summary as the CLI prints it)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(["run", "--config", "popup_demo"]) == 0
    demo = json.loads(buf.getvalue())
    for k in ("n_wall_planes", "depth_median_rel_err", "depth_p95_rel_err"):
        out[f"popup_demo_{k}"] = np.asarray(demo[k])
    np.savez_compressed(OUT_TUM, **out)
    print(f"wrote {OUT_TUM}: {os.path.getsize(OUT_TUM)} bytes; n_kf="
          f"{int(out['n_kf'])} smoothed ATE {summary['ate_rmse_m']} "
          f"filter {summary['ate_filter_rmse_m']} popup_demo {demo}")


def _segnet_frames():
    """Two 64x96 synthetic corridor frames (uint8) and the pretrained
    SegNetLite's logits on them (flax's ``apply``, jitted, on the CPU)."""
    import jax

    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.io import synthetic
    from pop_up_slam_tpu.models import load_pretrained_segnet

    H, W = 64, 96
    K = Intrinsics.create(48.0, 48.0, 48.0, 32.0)
    world = synthetic.corridor_world()
    R, t = synthetic.corridor_trajectory(8)
    labels, _ = jax.vmap(lambda R_, t_: synthetic.render_frame(
        K, R_, t_, world, H, W))(R[2:4], t[2:4])
    rgb = jax.vmap(synthetic.render_rgb)(
        labels, jax.random.split(jax.random.PRNGKey(11), 2))
    rgb8 = np.round(np.asarray(rgb) * 255.0).astype(np.uint8)
    model, params, _ = load_pretrained_segnet()
    logits = jax.jit(model.apply)(params, rgb8.astype(np.float32) / 255.0)
    return rgb8, np.asarray(logits, np.float32)


def _problem():
    """The reference's ``build_corridor_problem`` at ``PROBLEM_KW`` and its
    draws (the keys split as the builder splits them; default window 6
    and 8 walls)."""
    import jax

    from pop_up_slam_tpu.io.problems import build_corridor_problem

    W, M = 6, 8
    k_odom, k_obs, k_lm = jax.random.split(
        jax.random.PRNGKey(PROBLEM_KW["seed"]), 3)
    draws = dict(
        odom=np.asarray(jax.random.normal(k_odom, (W - 1, 6))),
        obs=np.stack([np.asarray(jax.random.normal(k, (M, 3)))
                      for k in jax.random.split(k_obs, W)]),
        lm=np.asarray(jax.random.normal(k_lm, (M + 1, 3))))
    window, factors, _, _ = build_corridor_problem(**PROBLEM_KW)
    out = {f"problem.draws.{k}": v for k, v in draws.items()}
    out.update(_flatten("problem.window",
                        [jax.tree.map(np.asarray, window)]))
    out.update(_flatten("problem.factors",
                        [jax.tree.map(np.asarray, factors)]))
    return out


def _row_filters(path):
    """The filter byte of each row of a non-interlaced PNG."""
    import zlib

    from pop_up_slam_tpu_torch.io import png

    data = open(path, "rb").read()
    idat, hdr = b"", None
    for kind, body in png._chunks(data):
        if kind == b"IHDR":
            hdr = body
        elif kind == b"IDAT":
            idat += body
    w, h = int.from_bytes(hdr[:4], "big"), int.from_bytes(hdr[4:8], "big")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8)
    return raw.reshape(h, -1)[:, 0].copy()


def write_png_fixtures():
    """The filtered PNG fixtures, written by the reference's libpng codec
    (adaptive filters).  Each image is five bands of 24 rows, made so
    that libpng's heuristic picks every filter type: small signed noise
    around 0 (None), a ramp along the row (Sub), repeated rows (Up), a
    ramp both ways with noise (Average, Paeth) and noise."""
    from pop_up_slam_tpu.io import native_loader as jnl

    assert jnl.available(), jnl.load_error()
    rng = np.random.default_rng(8)
    H, W = 120, 160
    v, u = np.mgrid[0:H, 0:W]
    band = v // 24
    base = np.select(
        [band == 1, band == 2, band == 3],
        [u * 1.5, np.sin(u / 9.0) * 60 + 100, (u + v) * 0.9],
        default=rng.normal(128, 30, (H, W)))
    small = rng.integers(-3, 4, (H, W, 3))       # None: bytes near 0 / 255
    rgb = np.stack([base, base * 0.8 + 20, 255 - base], -1)
    rgb = np.clip(rgb + rng.normal(0, 1.2, rgb.shape) * (band >= 3)[..., None],
                  0, 255).astype(np.int64)
    rgb = np.where((band == 0)[..., None], small % 256, rgb).astype(np.uint8)
    gray16 = np.clip(base * 250.0 + rng.normal(0, 40, (H, W)) * (band >= 3),
                     0, 65535).astype(np.int64)
    gray16 = np.where(band == 0, small[..., 0] % 65536,
                      gray16).astype(np.uint16)
    out = {}
    for name, img in (("rgb", rgb), ("gray16", gray16)):
        path = os.path.join(DATA, f"png_fixture_{name}.png")
        jnl.encode_png(path, img)
        assert np.array_equal(jnl.decode_png(path), img)
        out[name] = img
        out[f"{name}_filters"] = _row_filters(path)
        print(f"wrote {path}: {os.path.getsize(path)} bytes, row filters "
              f"{np.bincount(out[name + '_filters'], minlength=5).tolist()}")
    np.savez_compressed(OUT_PNG, **out)
    print(f"wrote {OUT_PNG}: {os.path.getsize(OUT_PNG)} bytes")


def write_batched():
    """The JAX batched runner over the 144 frames (see above)."""
    import jax

    import pop_up_slam_tpu  # noqa: F401  (full-f32 matmul)
    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.pipeline import batched as jbatched
    from pop_up_slam_tpu.pipeline import SlamConfig, slam_init
    from pop_up_slam_tpu.popup import popup as jpp

    masks, oR, ot, R0, t0 = load_inputs()
    n = masks.shape[0]
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0)
    pcfg = jpp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0, fused="on")
    dr, pops = [], []
    dead_reckon, pop_up = jbatched.dead_reckon, jpp.pop_up

    def recording_dead_reckon(*args):
        Rs, ts = dead_reckon(*args)
        jax.debug.callback(lambda a, b: dr.append((np.asarray(a),
                                                   np.asarray(b))),
                           Rs, ts, ordered=True)
        return Rs, ts

    def recording_pop_up(K_, mask, R_wc, t_wc, *args, **kwargs):
        # inside the runner's vmap: an ordered callback runs once per
        # frame, in frame order (the pose is recorded too and checked
        # against the dead reckoning)
        res = pop_up(K_, mask, R_wc, t_wc, *args, **kwargs)
        jax.debug.callback(
            lambda *a: pops.append(tuple(np.asarray(x) for x in a)),
            res.valid, res.n_points, R_wc, t_wc, ordered=True)
        return res

    def run():
        state = slam_init(scfg, R0, t0)
        t_start = time.perf_counter()
        state, (Rs, ts) = jbatched.run_sequence_batched(
            state, masks, oR, ot, K, pcfg, scfg, chunk=16, donate=False)
        jax.block_until_ready(ts)
        jax.effects_barrier()
        print(f"batched runner, {n} frames: "
              f"{time.perf_counter() - t_start:.1f} s (compile included)")
        return state, np.asarray(Rs, np.float32), np.asarray(ts, np.float32)

    _, R_plain, t_plain = run()     # the same program without recording
    jbatched.dead_reckon, jpp.pop_up = recording_dead_reckon, recording_pop_up
    states, undo = _record_states(jbatched, "slam_step")
    try:
        state, Rs, ts = run()
    finally:
        undo()
        jbatched.dead_reckon, jpp.pop_up = dead_reckon, pop_up
    # recording leaves the program's results as they were
    assert np.array_equal(Rs, R_plain) and np.array_equal(ts, t_plain)
    assert len(states) == n and len(pops) == n and len(dr) == n // 16
    dr_R = np.concatenate([a for a, _ in dr]).astype(np.float32)
    dr_t = np.concatenate([b for _, b in dr]).astype(np.float32)
    assert np.array_equal(np.stack([p[2] for p in pops]), dr_R)
    assert np.array_equal(np.stack([p[3] for p in pops]), dr_t)
    frame_n_kf = np.append([int(s.n_kf) for s in states[1:]],
                           int(state.n_kf)).astype(np.int32)
    out = dict(
        R=Rs, t=ts,
        n_kf=np.asarray(state.n_kf, np.int32),
        n_overflow=np.asarray(state.n_overflow, np.int32),
        store_valid=np.asarray(state.store.valid, bool),
        frame_n_kf=frame_n_kf, dr_R=dr_R, dr_t=dr_t,
        popup_valid=np.stack([p[0] for p in pops]).astype(bool),
        popup_n_points=np.stack([p[1] for p in pops]).astype(np.int32))
    out.update(_flatten("chunk", states[::16]))
    rgb8, logits = _segnet_frames()
    out.update(segnet_rgb8=rgb8, segnet_logits=logits)
    out.update(_problem())
    assert np.isfinite(out["t"]).all() and np.isfinite(logits).all()
    np.savez_compressed(OUT_BATCHED, **out)
    print(f"wrote {OUT_BATCHED}: {os.path.getsize(OUT_BATCHED)} bytes; "
          f"n_kf={int(out['n_kf'])} n_overflow={int(out['n_overflow'])} "
          f"valid={int(out['store_valid'].sum())} t[-1]={out['t'][-1]}")
    write_png_fixtures()


def _unflatten(template, ref, prefix, i=0):
    """``template`` (a nested NamedTuple) with each leaf replaced by entry
    ``i`` of the key ``prefix.field.subfield`` of ``ref``."""
    vals = []
    for name in template._fields:
        v = getattr(template, name)
        key = f"{prefix}.{name}"
        vals.append(_unflatten(v, ref, key, i) if hasattr(v, "_fields")
                    else np.asarray(ref[key][i]))
    return type(template)(*vals)


def _run_sharded(state, masks, oR, ot, K, pcfg, scfg, mesh, block):
    """The JAX ``run_sequence_sharded`` with each block's start state,
    each frame's ``n_kf`` and the DP pop-up's walls and poses recorded."""
    import jax

    from pop_up_slam_tpu.pipeline import sharded as jsharded

    blocks, kf, pops = [], {}, []
    make_runner, slam_step = jsharded.make_sharded_runner, jsharded.slam_step
    sharded_popup = jsharded.sharded_popup

    def recording_step(st, *args, **kwargs):
        st, pose = slam_step(st, *args, **kwargs)
        # unordered (the runner is a multi-device program): keyed by frame
        jax.debug.callback(lambda f, k: kf.__setitem__(int(f), int(k)),
                           st.frame, st.n_kf)
        return st, pose

    def recording_popup(fn, m, R, t, *args, **kwargs):
        res = sharded_popup(fn, m, R, t, *args, **kwargs)
        jax.debug.callback(
            lambda *a: pops.append(tuple(np.asarray(x) for x in a)),
            res.valid, res.n_points, R, t)
        return res

    def recording_runner(*args, **kwargs):
        run = make_runner(*args, **kwargs)

        def rec(st, *a):
            blocks.append(jax.tree.map(np.asarray, st))
            out = run(st, *a)
            jax.block_until_ready(out)
            jax.effects_barrier()
            return out

        return rec

    jsharded.make_sharded_runner = recording_runner
    jsharded.slam_step = recording_step
    jsharded.sharded_popup = recording_popup
    try:
        t_start = time.perf_counter()
        state, (Rs, ts) = jsharded.run_sequence_sharded(
            state, masks, oR, ot, K, pcfg, scfg, mesh, block=block,
            donate=False)
        jax.block_until_ready(ts)
        jax.effects_barrier()
        seconds = time.perf_counter() - t_start
    finally:
        jsharded.make_sharded_runner = make_runner
        jsharded.slam_step = slam_step
        jsharded.sharded_popup = sharded_popup
    n = masks.shape[0]
    assert len(pops) == len(blocks), (len(pops), len(blocks))
    out = dict(
        R=np.asarray(Rs, np.float32), t=np.asarray(ts, np.float32),
        frame_n_kf=np.asarray([kf[f] for f in range(1, n + 1)], np.int32),
        n_kf=np.asarray(state.n_kf, np.int32),
        n_overflow=np.asarray(state.n_overflow, np.int32),
        store_valid=np.asarray(state.store.valid, bool),
        popup_valid=np.concatenate([p[0] for p in pops])[:n].astype(bool),
        popup_n_points=np.concatenate([p[1] for p in pops])[:n].astype(
            np.int32),
        popup_R=np.concatenate([p[2] for p in pops])[:n].astype(np.float32),
        popup_t=np.concatenate([p[3] for p in pops])[:n].astype(np.float32))
    out.update(_flatten("block", blocks))
    assert np.isfinite(out["t"]).all() and np.isfinite(out["R"]).all()
    print(f"sharded runner, {n} frames, block {block}: {seconds:.1f} s "
          f"(compile included); n_kf={int(out['n_kf'])} "
          f"n_overflow={int(out['n_overflow'])} t[-1]={out['t'][-1]}")
    return out


def _small_stream():
    """The fast sharded-runner test's stream (48x64, 10 frames)."""
    import jax

    from pop_up_slam_tpu.geometry import se3
    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.io import synthetic

    K = Intrinsics.create(32.0, 32.0, 32.0, 24.0)
    world = synthetic.corridor_world()
    Rs, ts = synthetic.corridor_trajectory(11)
    labels, _ = jax.vmap(lambda R_, t_: synthetic.render_frame(
        K, R_, t_, world, 48, 64))(Rs, ts)
    masks = labels[1:] == synthetic.LABEL_GROUND
    oR, ot = se3.se3_between(Rs[:-1], ts[:-1], Rs[1:], ts[1:])
    return K, tuple(np.asarray(x) for x in (masks, Rs, ts, oR, ot))


def write_sharded():
    import contextlib
    import io
    import json

    import jax

    import pop_up_slam_tpu  # noqa: F401  (full-f32 matmul)
    from pop_up_slam_tpu import cli as jcli
    from pop_up_slam_tpu.config import get_config
    from pop_up_slam_tpu.geometry.camera import Intrinsics
    from pop_up_slam_tpu.parallel import make_mesh
    from pop_up_slam_tpu.pipeline import SlamConfig, slam_init
    from pop_up_slam_tpu.pipeline.smoothing import (
        TrajectoryRecorder, smooth_trajectory)
    from pop_up_slam_tpu.popup import popup as jpp

    assert len(jax.devices()) >= SHARDED_DEVICES, jax.devices()
    mesh = make_mesh(SHARDED_DEVICES)
    out = {}

    # the small stream (the CPU tests')
    K, (masks, Rs, ts, oR, ot) = _small_stream()
    pcfg = jpp.PopupConfig(min_cols=4, smooth_radius=2, nms_radius=3)
    scfg = SlamConfig(window_size=4, max_landmarks=16,
                      max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    small = _run_sharded(slam_init(scfg, Rs[0], ts[0]), masks, oR, ot, K,
                         pcfg, scfg, mesh, block=4)
    small.update(masks=masks, gt_R=Rs, gt_t=ts, odom_R=oR, odom_t=ot)
    out.update({f"small.{k}": v for k, v in small.items()})

    # the 144 corridor frames at full width
    masks, oR, ot, R0, t0 = load_inputs()
    K = Intrinsics.create(320.0, 320.0, 320.0, 240.0)
    pcfg = jpp.PopupConfig()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    out.update(_run_sharded(slam_init(scfg, R0, t0), masks, oR, ot, K, pcfg,
                            scfg, mesh, block=16))

    # the mesh smoother on the TUM reference's recorder and state
    tum = np.load(OUT_TUM)
    tcfg = get_config("tum_fr3").slam
    rec = TrajectoryRecorder.restore(
        tcfg, {k[4:]: tum[k] for k in tum.files if k.startswith("rec.")})
    state = _unflatten(slam_init(tcfg, tum["gt_R"][0], tum["gt_t"][0]),
                       tum, "state")
    t_start = time.perf_counter()
    kf_R, kf_t, _ = smooth_trajectory(rec, state, tcfg, iters=8,
                                      damping=tcfg.damping, mesh=mesh)
    print(f"mesh smoother: {time.perf_counter() - t_start:.1f} s; "
          f"{kf_t.shape[0]} keyframes, "
          f"{np.abs(kf_t - tum['kf_t']).max():.3g} m from the single-device "
          "smoother")
    out.update(mesh_kf_R=np.asarray(kf_R, np.float32),
               mesh_kf_t=np.asarray(kf_t, np.float32))

    # the CLI's distributed preset
    buf = io.StringIO()
    t_start = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        assert jcli.main(["run", "--config", "single_host"]) == 0
    summary = json.loads(buf.getvalue())
    print(f"cli single_host: {time.perf_counter() - t_start:.1f} s "
          f"{json.dumps(summary)}")
    assert summary["n_devices"] == SHARDED_DEVICES
    out.update({f"cli_single_host.{k}": np.asarray(v)
                for k, v in summary.items()})

    np.savez_compressed(OUT_SHARDED, **out)
    print(f"wrote {OUT_SHARDED}: {os.path.getsize(OUT_SHARDED)} bytes")


def main(argv):
    names = ("gn", "solvers", "vo", "tum", "batched", "sharded")
    which = set(argv) or set(names)
    unknown = which - set(names)
    if unknown:
        raise SystemExit(f"unknown reference(s) {sorted(unknown)}; "
                         f"choose from {', '.join(names)}")
    os.makedirs(DATA, exist_ok=True)
    if "sharded" in which:
        # before JAX starts: the sharded references' CPU mesh
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={SHARDED_DEVICES}")
    if "gn" in which:
        write_gn()
    if "solvers" in which:
        write_solvers()
    if "vo" in which:
        write_vo()
    if "tum" in which:
        write_tum()
    if "batched" in which:
        write_batched()
    if "sharded" in which:
        write_sharded()


if __name__ == "__main__":
    main(sys.argv[1:])
