"""Write the JAX reference trajectory that the PyTorch port is held against.

Runs the JAX package's chunked frame runner (``run_sequence_chunked``,
fused GN body forced on) on the CPU over all 144 frames of
``bench_data/corridor_inputs.npz`` at the production configuration:
480x640 masks, ``SlamConfig()`` widths (W=8, L=64, D=9, 2 GN
iterations), every frame a keyframe, chunks of 16 frames.  Saves the
per-frame pose and the final discrete state to
``pop_up_slam_tpu_torch/data/corridor_ref.npz``.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_reference.py
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _REPO)

OUT = os.path.join(_REPO, "pop_up_slam_tpu_torch", "data", "corridor_ref.npz")


def load_inputs():
    z = np.load(os.path.join(_REPO, "bench_data", "corridor_inputs.npz"))
    n, h, w = z["shape"]
    masks = np.unpackbits(z["masks_packed"], axis=-1)[..., :w].astype(bool)
    return masks, z["odom_R"], z["odom_t"], z["R0"], z["t0"]


def main():
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
                      kf_rot=0.0, fused="on")
    state = slam_init(scfg, R0, t0)
    t_start = time.perf_counter()
    state, (Rs, ts) = run_sequence_chunked(
        state, masks, oR, ot, K, pcfg, scfg, chunk=16, donate=False,
    )
    jax.block_until_ready(ts)
    print(f"jax backend={jax.default_backend()} "
          f"run {time.perf_counter() - t_start:.1f} s (compile included)")
    out = dict(
        R=np.asarray(Rs, np.float32),
        t=np.asarray(ts, np.float32),
        n_kf=np.asarray(state.n_kf, np.int32),
        n_overflow=np.asarray(state.n_overflow, np.int32),
        store_valid=np.asarray(state.store.valid, bool),
        pf_lm=np.asarray(state.pf_lm, np.int32),
    )
    assert np.isfinite(out["t"]).all() and np.isfinite(out["R"]).all()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}: n_kf={int(out['n_kf'])} "
          f"n_overflow={int(out['n_overflow'])} "
          f"valid={int(out['store_valid'].sum())} "
          f"t[-1]={out['t'][-1]}")


if __name__ == "__main__":
    main()
