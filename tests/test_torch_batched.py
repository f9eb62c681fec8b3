"""The port's batched runner against the JAX package on the CPU
(``pipeline/batched.py``; the pipelined runner is in
``tests/test_torch_pipelined.py``).

Inputs: ``tests/test_batched.py``'s synthetic corridor (96x128, 8
frames), rendered by the port (its renderer is held against the
reference's in ``tests/test_torch_tum.py``) and handed to both as numpy;
the full-width holds read the committed
``corridor_ref_batched.npz`` (``scripts/make_torch_reference.py
batched``).

- ``dead_reckon`` at 1e-5;
- the batched runner (chunk 4, 8 frames) against the JAX
  batched runner: every pose within 15 mm (the reference's own
  cross-path bound), every frame's keyframe decision exactly, and the
  port's batched pop-up at the reference's dead-reckoned poses (recorded
  inside the reference's ``vmap``) equal in valid walls and column
  counts; the port's batched runner against the port's chunked runner
  within the reference's 2.5 cm (``tests/test_batched.py:66``);
- at 480x640: the batched pop-up equal to the reference's at its
  recorded poses on all 144 frames, and the first 8 frames from
  ``slam_init`` within 15 mm with the reference's keyframe decisions.

The JAX batched runner is compiled once (two chunks of 4 frames).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, REPO, assert_close, corridor_inputs,
                           port_corridor)
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.pipeline import SlamConfig as JSC
from pop_up_slam_tpu.pipeline import batched as jbatched
from pop_up_slam_tpu.pipeline import slam_init as jslam_init
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.pipeline import (SlamConfig,
                                            run_sequence_chunked, slam_init)
from pop_up_slam_tpu_torch.pipeline import batched as tbatched
from pop_up_slam_tpu_torch.popup.popup import PopupConfig as TPC

H, W = 96, 128
N = 8                      # two chunks of 4: one JAX compile
TRAJ_TOL = 0.015           # the reference's cross-path bound
CHUNKED_TOL = 2.5e-2       # tests/test_batched.py:66


def _cfgs(jax_side: bool):
    pc = jpp.PopupConfig if jax_side else TPC
    sc = JSC if jax_side else SlamConfig
    pcfg = pc(min_cols=4, smooth_radius=2, nms_radius=3)
    scfg = sc(max_det=pcfg.max_segments + 1, kf_trans=0.05, kf_rot=0.02,
              window_size=4, max_landmarks=16, gn_iters=2)
    return pcfg, scfg


@pytest.fixture(scope="module")
def sequence():
    """tests/test_batched.py's corridor (the masks of frames 1..N)."""
    Rs, ts, masks, oR, ot = port_corridor(N + 1)
    return Rs, ts, masks[1:], oR, ot


def _record(module, name, log, what):
    """Wrap ``module.name`` so that ``what(args, result)`` is appended to
    ``log`` (host numpy, ordered: also inside ``vmap``); returns the
    undo."""
    fn = getattr(module, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        jax.debug.callback(lambda *a: log.append(tuple(map(np.asarray, a))),
                           *what(args, out), ordered=True)
        return out

    setattr(module, name, wrapped)
    return lambda: setattr(module, name, fn)


@pytest.fixture(scope="module")
def reference(sequence):
    """The JAX batched runner (chunk 4) with each frame's ``n_kf`` after
    its step, the dead-reckoned poses and the batched pop-up recorded."""
    Rs, ts, masks, oR, ot = sequence
    pcfg, scfg = _cfgs(True)
    K = JK.create(64.0, 64.0, 64.0, 48.0)
    n_kf, dr, pops = [], [], []
    undo = [
        _record(jbatched, "slam_step", n_kf, lambda a, o: (o[0].n_kf,)),
        _record(jbatched, "dead_reckon", dr, lambda a, o: o),
        _record(jpp, "pop_up", pops, lambda a, o: (o.valid, o.n_points)),
    ]
    try:
        state = jax.jit(jslam_init, static_argnums=0)(scfg, Rs[0], ts[0])
        _, (R, t) = jbatched.run_sequence_batched(
            state, masks, oR, ot, K, pcfg, scfg, chunk=4, donate=False)
        jax.effects_barrier()
    finally:
        for u in undo:
            u()
    return dict(
        R=np.asarray(R), t=np.asarray(t),
        n_kf=np.array([int(x[0]) for x in n_kf]),
        dr_R=np.concatenate([a for a, _ in dr]),
        dr_t=np.concatenate([b for _, b in dr]),
        valid=np.stack([p[0] for p in pops]),
        n_points=np.stack([p[1] for p in pops]))


def _port_batched(Rs, ts, masks, oR, ot, scfg, pcfg, K, chunk):
    """The port's batched runner, with each frame's ``n_kf`` after its
    step recorded."""
    n_kf = []
    step = tbatched.slam_step

    def logged(*args):
        out = step(*args)
        n_kf.append(int(out[0].n_kf))
        return out

    tbatched.slam_step = logged
    try:
        _, (R, t) = tbatched.run_sequence_batched(
            slam_init(scfg, Rs[0], ts[0], device=CPU), masks, oR, ot, K,
            pcfg, scfg, chunk=chunk)
    finally:
        tbatched.slam_step = step
    return R, t, np.array(n_kf)


def test_dead_reckon_matches_reference(sequence):
    Rs, ts, _, oR, ot = sequence
    jR, jt = jbatched.dead_reckon(jnp.asarray(Rs[0]), jnp.asarray(ts[0]),
                                  jnp.asarray(oR), jnp.asarray(ot))
    tR, tt = tbatched.dead_reckon(*(torch.as_tensor(x) for x in
                                    (Rs[0], ts[0], oR, ot)))
    assert_close(tR, jR, 1e-5, what="R")
    assert_close(tt, jt, 1e-5, what="t")


def test_batched_matches_reference(sequence, reference):
    Rs, ts, masks, oR, ot = sequence
    pcfg, scfg = _cfgs(False)
    K = TK.create(64.0, 64.0, 64.0, 48.0, device=CPU)
    R, t, n_kf = _port_batched(Rs, ts, masks, oR, ot, scfg, pcfg, K, 4)
    assert_close(t, reference["t"], TRAJ_TOL, what="t")
    assert_close(R, reference["R"], TRAJ_TOL, what="R")
    np.testing.assert_array_equal(n_kf, reference["n_kf"])
    # the batched pop-up at the reference's dead-reckoned poses
    res, det = tbatched.batched_pop_up(
        K, torch.as_tensor(masks), torch.as_tensor(reference["dr_R"]),
        torch.as_tensor(reference["dr_t"]), pcfg, scfg.max_det)
    np.testing.assert_array_equal(res.valid.numpy(), reference["valid"])
    np.testing.assert_array_equal(res.n_points.numpy(),
                                  reference["n_points"])
    for x in det:
        assert torch.isfinite(x.float()).all()


def test_batched_matches_port_chunked(sequence):
    Rs, ts, masks, oR, ot = sequence
    pcfg, scfg = _cfgs(False)
    K = TK.create(64.0, 64.0, 64.0, 48.0, device=CPU)
    R_b, t_b, _ = _port_batched(Rs, ts, masks, oR, ot, scfg, pcfg, K, 4)
    _, (R_c, t_c) = run_sequence_chunked(
        slam_init(scfg, Rs[0], ts[0], device=CPU), masks, oR, ot, K, pcfg,
        scfg, chunk=4)
    assert_close(t_b, t_c, CHUNKED_TOL, what="t")
    assert_close(R_b, R_c, CHUNKED_TOL, what="R")


def test_batched_full_width_prefix():
    """At 480x640 with the production configuration (every frame a
    keyframe): the batched pop-up at the reference's recorded poses on all
    144 frames, and the first 8 frames from ``slam_init`` (a chunk's
    frames depend only on its start state and its odometry)."""
    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref_batched.npz"))
    masks, oR, ot, R0, t0 = corridor_inputs()
    pcfg = TPC()
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.0,
                      kf_rot=0.0)
    K = TK.create(320.0, 320.0, 320.0, 240.0, device=CPU)
    masks_t = torch.as_tensor(masks)
    for c in range(0, masks.shape[0], 16):
        res, _ = tbatched.batched_pop_up(
            K, masks_t[c:c + 16], torch.as_tensor(ref["dr_R"][c:c + 16]),
            torch.as_tensor(ref["dr_t"][c:c + 16]), pcfg, scfg.max_det)
        np.testing.assert_array_equal(res.valid.numpy(),
                                      ref["popup_valid"][c:c + 16])
        np.testing.assert_array_equal(res.n_points.numpy(),
                                      ref["popup_n_points"][c:c + 16])
    n = 8                      # the first half of the first chunk
    R, t, n_kf = _port_batched(np.asarray(R0)[None], np.asarray(t0)[None],
                               masks[:n], oR[:n], ot[:n], scfg, pcfg, K, 16)
    assert_close(t, ref["t"][:n], TRAJ_TOL, what="t")
    assert_close(R, ref["R"][:n], TRAJ_TOL, what="R")
    np.testing.assert_array_equal(n_kf, ref["frame_n_kf"][:n])
