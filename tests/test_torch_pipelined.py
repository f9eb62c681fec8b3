"""The port's pipelined runner (``pipeline/pipelined.py``) on the CPU.

Input: ``tests/test_pipelined.py``'s corridor (96x128, 10 frames after
the first), rendered by the port and handed to both packages as numpy.
As the reference's tests hold its runner against its own sequential
loop (``tests/test_pipelined.py``):

- ``stale_prediction=False`` bit-equal to the port's sequential frame
  loop (``offline.make_frame_fn``), on one device and placed on two
  (``cpu``/``cpu``);
- ``stale_prediction=True`` finite and within the reference test's ATE
  bound (below max(2 ATE_seq, 0.05 m)), and against the JAX package's
  stale run (``run_pipelined(stale_prediction=True)``): every pose
  within 15 mm (the reference's cross-path bound) and every frame's
  keyframe decision exactly;
- ``make_stages``' two stages, called in turn, bit-equal to that loop.

The card's side-stream schedule is held in ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, port_corridor
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.pipeline import SlamConfig as JSC
from pop_up_slam_tpu.pipeline import pipelined as jpipelined
from pop_up_slam_tpu.pipeline import slam_init as jslam_init
from pop_up_slam_tpu.popup import popup as jpp
from pop_up_slam_tpu_torch.evaluation import ate_rmse
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.pipeline import (SlamConfig, make_frame_fn,
                                            make_stages, run_pipelined,
                                            slam_init)
from pop_up_slam_tpu_torch.pipeline import pipelined as tpipelined
from pop_up_slam_tpu_torch.popup.popup import PopupConfig as TPC

N = 11                     # tests/test_pipelined.py's frames + 1
TRAJ_TOL = 0.015           # the reference's cross-path bound


@pytest.fixture(scope="module")
def scene():
    """tests/test_pipelined.py's corridor and the port's sequential frame
    loop over it."""
    Rs, ts, masks, oR, ot = port_corridor(N, sway=0.2)
    pcfg = TPC(min_cols=6, smooth_radius=3, nms_radius=5)
    scfg = SlamConfig(max_det=pcfg.max_segments + 1, kf_trans=0.05,
                      kf_rot=0.05)
    Kt = TK.create(64.0, 64.0, 64.0, 48.0, device=CPU)
    frame = make_frame_fn(Kt, pcfg, scfg)
    state = slam_init(scfg, Rs[0], ts[0], device=CPU)
    seq = []
    for i in range(N - 1):
        state, (_, t) = frame(state, (torch.as_tensor(masks[i + 1]),
                                      torch.as_tensor(oR[i]),
                                      torch.as_tensor(ot[i])))
        seq.append(t)
    return Kt, pcfg, scfg, Rs, ts, masks, oR, ot, torch.stack(seq)


def _pipelined(scene, stale, fe_device=None, be_device=None):
    Kt, pcfg, scfg, Rs, ts, masks, oR, ot, _ = scene
    state = slam_init(scfg, Rs[0], ts[0], device=CPU)
    frames = ((torch.as_tensor(masks[i + 1]), torch.as_tensor(oR[i]),
               torch.as_tensor(ot[i])) for i in range(N - 1))
    return torch.stack([t for _, t in run_pipelined(
        state, frames, Kt, pcfg, scfg, fe_device=fe_device,
        be_device=be_device, stale_prediction=stale)])


@pytest.mark.parametrize("devices", [(None, None), ("cpu", "cpu")],
                         ids=["one_device", "two_devices"])
def test_non_stale_bit_equal_to_sequential(scene, devices):
    pipe = _pipelined(scene, False, *devices)
    assert torch.isfinite(pipe).all()
    assert torch.equal(pipe, scene[-1])


def test_stale_stays_accurate(scene):
    ts, seq = scene[4], scene[-1]
    pipe = _pipelined(scene, True)
    assert torch.isfinite(pipe).all()
    ate_seq = ate_rmse(ts[1:], seq.numpy())[0]
    ate_pipe = ate_rmse(ts[1:], pipe.numpy())[0]
    assert ate_pipe < max(2.0 * ate_seq, 0.05), (ate_seq, ate_pipe)


def _record(module, log, monkeypatch):
    """Make ``module.run_pipelined``'s stages append their calls to
    ``log`` in order: ("front", the state read) and ("back", the state
    read, the state returned)."""
    make = module.make_stages

    def make_stages(*args, **kwargs):
        front, back = make(*args, **kwargs)

        def front_rec(state, mask):
            log.append(("front", state))
            return front(state, mask)

        def back_rec(state, *a):
            out = back(state, *a)
            log.append(("back", state, out[0]))
            return out

        return front_rec, back_rec

    monkeypatch.setattr(module, "make_stages", make_stages)


def _schedule(log):
    """The calls in order, each front end named by the back-end calls
    whose input ("in k") or output ("out k") state it read."""
    backs = [e for e in log if e[0] == "back"]
    out, k = [], 0
    for e in log:
        if e[0] == "back":
            out.append(f"back {k}")
            k += 1
            continue
        src = [f"in {j}" for j, b in enumerate(backs) if b[1] is e[1]]
        src += [f"out {j}" for j, b in enumerate(backs) if b[2] is e[1]]
        out.append("front " + " ".join(src))
    return out


def test_stale_matches_reference(scene, monkeypatch):
    """The port's stale schedule against the JAX package's on the same
    inputs: the same order of stage calls, each front end reading the
    same (one update stale) state, every pose within 15 mm and every
    frame's keyframe decision exact."""
    _, _, _, Rs, ts, masks, oR, ot, _ = scene
    pcfg = jpp.PopupConfig(min_cols=6, smooth_radius=3, nms_radius=5)
    scfg = JSC(max_det=pcfg.max_segments + 1, kf_trans=0.05, kf_rot=0.05)
    j_log, t_log = [], []
    _record(jpipelined, j_log, monkeypatch)
    _record(tpipelined, t_log, monkeypatch)
    frames = ((jnp.asarray(masks[i + 1]), jnp.asarray(oR[i]),
               jnp.asarray(ot[i])) for i in range(N - 1))
    ref = np.stack([np.asarray(t) for _, t in jpipelined.run_pipelined(
        jslam_init(scfg, jnp.asarray(Rs[0]), jnp.asarray(ts[0])), frames,
        JK.create(64.0, 64.0, 64.0, 48.0), pcfg, scfg,
        stale_prediction=True)])
    pipe = _pipelined(scene, True).numpy()
    assert np.isfinite(pipe).all() and np.isfinite(ref).all()
    sched = _schedule(j_log)
    assert sched[:4] == ["front in 0", "front in 0", "back 0",
                         "front in 1 out 0"], sched
    assert _schedule(t_log) == sched
    err = np.linalg.norm(pipe - ref, axis=-1)
    assert err.max() < TRAJ_TOL, err
    n_kf = [[int(e[2].n_kf) for e in log if e[0] == "back"]
            for log in (j_log, t_log)]
    assert len(n_kf[0]) == N - 1 and n_kf[1] == n_kf[0], n_kf


def test_stages_compose_to_the_sequential_loop(scene):
    """``make_stages``'s front and back ends, called in turn, are the
    sequential frame step."""
    Kt, pcfg, scfg, Rs, ts, masks, oR, ot, seq = scene
    front, back = make_stages(Kt, pcfg, scfg)
    state = slam_init(scfg, Rs[0], ts[0], device=CPU)
    out = []
    for i in range(N - 1):
        det = front(state, masks[i + 1])
        state, (_, t) = back(state, det, oR[i], ot[i])
        out.append(t)
    assert torch.equal(torch.stack(out), seq)
