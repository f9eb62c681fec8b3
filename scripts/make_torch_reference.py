"""Write the JAX reference trajectories that the PyTorch port is held against.

Runs the JAX package's chunked frame runner (``run_sequence_chunked``) on
the CPU over the frames of ``bench_data/corridor_inputs.npz`` at
480x640, every frame a keyframe, chunks of 16 frames, and saves the
per-frame pose and the final discrete state.

``gn`` (``pop_up_slam_tpu_torch/data/corridor_ref.npz``): all 144 frames
at the production configuration, ``SlamConfig()`` widths (W=8, L=64,
D=9, 2 GN iterations), fused GN body forced on.

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
around the solver and the pop-up.  The runs use
``pallas="on"``, the Schur-kernel route (``schur_reduce_pallas``,
interpret mode on the CPU): it solves the reduced system with the
pivot-skip rule, as the port's Schur kernels do, whereas the
``"auto"``/``"off"`` route (``solve_schur``) turns an indefinite system
into NaN and a zero step.  Interpret mode is fast enough here: the three
runs took 27.7 s, 22.8 s and 40.6 s, compiles included, on an 8-vCPU
x86-64 host (the ``gn`` run about 30 s).

Run from the repository root (no argument writes both files):

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py [gn] [solvers]
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


def write_gn():
    out = _run(144, fused="on")
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: n_kf={int(out['n_kf'])} "
          f"n_overflow={int(out['n_overflow'])} "
          f"valid={int(out['store_valid'].sum())} t[-1]={out['t'][-1]}")


def write_solvers():
    import jax

    from pop_up_slam_tpu.pipeline import slam as jslam
    from pop_up_slam_tpu.popup import popup as jpp

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

    popups = []
    pop_up = jpp.pop_up

    def recording_pop_up(*args, **kwargs):
        res = pop_up(*args, **kwargs)
        jax.debug.callback(
            lambda v, n: popups.append((np.asarray(v), np.asarray(n))),
            res.valid, res.n_points, ordered=True)
        return res

    jslam.lm_solve = recording(jslam.lm_solve)
    jslam.dogleg_solve = recording(jslam.dogleg_solve)
    jpp.pop_up = recording_pop_up
    out = {}
    for name, (overrides, n) in SOLVER_RUNS.items():
        accepted.clear()
        cost.clear()
        popups.clear()
        run = _run(n, pallas="on", **overrides)
        run.pop("pf_lm")
        run["accepted"] = np.stack(accepted).astype(bool)
        run["cost"] = np.stack(cost).astype(np.float32)
        run["popup_valid"] = np.stack([v for v, _ in popups]).astype(bool)
        run["popup_n_points"] = np.stack([c for _, c in popups]).astype(
            np.int32)
        assert run["popup_valid"].shape[0] == n
        assert run["accepted"].shape[0] == n, run["accepted"].shape
        out.update({f"{name}_{k}": v for k, v in run.items()})
        print(f"{name}: n_kf={int(run['n_kf'])} "
              f"n_overflow={int(run['n_overflow'])} "
              f"valid={int(run['store_valid'].sum())} "
              f"accepted {int(run['accepted'].sum())}/"
              f"{run['accepted'].size} t[-1]={run['t'][-1]}")
    np.savez_compressed(OUT_SOLVERS, **out)
    print(f"wrote {OUT_SOLVERS}")


def main(argv):
    which = set(argv) or {"gn", "solvers"}
    unknown = which - {"gn", "solvers"}
    if unknown:
        raise SystemExit(f"unknown reference(s) {sorted(unknown)}; "
                         "choose from gn, solvers")
    os.makedirs(DATA, exist_ok=True)
    if "gn" in which:
        write_gn()
    if "solvers" in which:
        write_solvers()


if __name__ == "__main__":
    main(sys.argv[1:])
