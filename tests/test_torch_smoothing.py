"""The port's full-trajectory smoothing (``pipeline/smoothing.py``) and
marginal covariance recovery (``solver/covariance.py``) against the JAX
package on the CPU.

- ``TrajectoryRecorder``: the port's recorder and the reference's, fed
  the same post-step states of a 40-frame port run (a noisy orbit in the
  partitioned room, W=6, L=12), take equal snapshots, exactly; the
  snapshot round-trips through ``restore``; ``pulls`` counts the
  reference's reads (one a frame, three more on other frames, eleven on
  a keyframe);
- ``build_smoothing_problem``: equal to the reference's on every field
  (integer and boolean fields exactly, floats exactly: both copy the
  same values), also after a landmark slot is recycled (its creation
  stamp changed: the stale factors are dropped, the reference's fault
  mirrored);
- ``smooth_trajectory`` (8 iterations) and ``emit_frames``: keyframe and
  frame poses within 1e-4; ``mesh=`` with something other than a device
  mesh raises;
- ``recover_marginals`` on noisy corridor BA systems at
  ``tests/test_solver_ext.py``'s sizes (``_torch_parity.ba_problem``,
  seeds 9, 10, 11, W=6, nine landmark slots: pose 0 gauge-fixed, three
  slots invalid with their factors; built with numpy: the suite's
  ``build_corridor_problem`` costs 22 s of per-op JAX dispatch here; the
  same linearization handed to both): within 5e-4 of each output's
  largest entry, and within 1e-6 of the f64 evaluation of the same
  formula (the port forms and inverts S in f64); gauge-fixed and
  invalid blocks exactly zero.  The reference's f32 evaluation lies up
  to 1.44e-4 of that scale from the f64 one on ``build_corridor_problem``'s
  systems, so the two cannot agree to 1e-4.

The reference's solver and marginals are compiled once each with
``jax.jit`` (module scope); the reference calls them eagerly.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, ba_problem, to_jax
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.pipeline import slam as jslam
from pop_up_slam_tpu.pipeline import smoothing as jsm
from pop_up_slam_tpu.solver import covariance as jcov
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors.graph import Linearization
from pop_up_slam_tpu_torch.io import synthetic
from pop_up_slam_tpu_torch.pipeline import slam as tslam
from pop_up_slam_tpu_torch.pipeline import smoothing as tsm
from pop_up_slam_tpu_torch.solver import recover_marginals

N_FRAMES = 40
CFG = dict(window_size=6, max_landmarks=12, max_det=9, kf_trans=0.2,
           kf_rot=0.12, gn_iters=3)
TOL = 1e-4
MARG_TOL = 5e-4

_gn_solve = jax.jit(jsm.gn_solve, static_argnames=(
    "iters", "solve_fn", "analytic_planes", "robust"))
_linearize = jax.jit(jgraph.linearize, static_argnames=("analytic_planes",))
_marginals = jax.jit(jcov.recover_marginals)


@pytest.fixture(scope="module")
def orbit():
    """A port run with both recorders fed the same states."""
    cfg_t, cfg_j = tslam.SlamConfig(**CFG), jslam.SlamConfig(**CFG)
    world = synthetic.room_world(device=CPU)
    R, t = synthetic.orbit_trajectory(N_FRAMES, device=CPU)
    rng = np.random.default_rng(5)
    xi = torch.as_tensor(rng.normal(size=(N_FRAMES - 1, 6)).astype(
        np.float32))
    oR, ot = synthetic.noisy_odometry(R, t, xi=xi, sigma_t=0.05,
                                      sigma_r=0.012)
    st = tslam.slam_init(cfg_t, R[0], t[0], device=CPU)
    rec_t = tsm.TrajectoryRecorder(cfg_t, R[0].numpy(), t[0].numpy())
    rec_j = jsm.TrajectoryRecorder(cfg_j, R[0].numpy(), t[0].numpy())
    pulls = []
    for i in range(1, N_FRAMES):
        noise = torch.as_tensor(rng.normal(size=(16, 3)).astype(np.float32))
        o = synthetic.observe_frame(world, R[i], t[i], noise=noise,
                                    noise_plane=0.01, max_det=9)
        det = tslam.FrameDetections(o.planes_c, o.centroid_c,
                                    o.endpoints_c, o.valid)
        st, _ = tslam.slam_step(st, det, oR[i - 1], ot[i - 1], cfg_t)
        before = rec_t.pulls
        rec_t.record(st)
        rec_j.record(convert.slam_state_to_numpy(st))
        pulls.append(rec_t.pulls - before)
    return dict(cfg_t=cfg_t, cfg_j=cfg_j, state=st, rec_t=rec_t,
                rec_j=rec_j, pulls=pulls, R=R.numpy(), t=t.numpy())


def _same_snapshot(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_recorder_matches_reference(orbit):
    rec_t, rec_j = orbit["rec_t"], orbit["rec_j"]
    assert rec_t.n_kf == rec_j.n_kf == int(orbit["state"].n_kf) >= 8
    _same_snapshot(rec_t.snapshot(), rec_j.snapshot())
    # the reference's reads: n_kf every frame, then acc_R/acc_t, or the
    # keyframe's eight fields and the window's R and t
    kf = np.diff(np.concatenate([[0], rec_t.frame_kf])) > 0
    assert orbit["pulls"] == [11 if k else 3 for k in kf]


def test_recorder_snapshot_roundtrip(orbit):
    rec = orbit["rec_t"]
    rec2 = tsm.TrajectoryRecorder.restore(orbit["cfg_t"], rec.snapshot())
    assert rec2.n_kf == rec.n_kf
    _same_snapshot(rec2.snapshot(), rec.snapshot())


def _state_np(orbit):
    return convert.slam_state_to_numpy(orbit["state"])


@pytest.mark.parametrize("recycled", [False, True])
def test_build_smoothing_problem_matches_reference(orbit, recycled):
    st = orbit["state"]
    st_np = _state_np(orbit)
    if recycled:
        # a landmark slot observed by recorded factors takes a new
        # creation stamp (evicted and reused, or merged away)
        lm = np.stack(orbit["rec_t"].pf_lm)[np.stack(orbit["rec_t"]
                                                     .pf_valid)]
        slot = int(np.bincount(lm).argmax())
        created = st.store.created_kf.clone()
        created[slot] = 10_000
        st = st._replace(store=st.store._replace(created_kf=created))
        st_np = convert.slam_state_to_numpy(st)
    w_t, f_t, n_t = tsm.build_smoothing_problem(orbit["rec_t"], st,
                                                orbit["cfg_t"])
    w_j, f_j, n_j = jsm.build_smoothing_problem(orbit["rec_j"], st_np,
                                                orbit["cfg_j"])
    assert n_t == n_j
    assert_close(w_t, jax.tree.map(np.asarray, w_j), 0.0, what="window")
    assert_close(f_t, jax.tree.map(np.asarray, f_j), 0.0, what="factors")
    valid = np.stack(orbit["rec_t"].pf_valid).reshape(-1)
    dropped = valid & ~f_t.planes.valid.numpy()
    assert dropped.any() == recycled


def test_smooth_trajectory_matches_reference(orbit, monkeypatch):
    monkeypatch.setattr(jsm, "gn_solve", _gn_solve)
    kR_j, kt_j, stats_j = jsm.smooth_trajectory(
        orbit["rec_j"], _state_np(orbit), orbit["cfg_j"], iters=8)
    kR_t, kt_t, stats_t = tsm.smooth_trajectory(
        orbit["rec_t"], orbit["state"], orbit["cfg_t"], iters=8)
    assert kR_t.shape == (orbit["rec_t"].n_kf, 3, 3)
    assert_close(kt_t, np.asarray(kt_j), TOL, what="kf_t")
    assert_close(kR_t, np.asarray(kR_j), TOL, what="kf_R")
    assert_close(stats_t.cost_history, np.asarray(stats_j.cost_history),
                 0.0, rtol=TOL, what="cost")
    fR_t, ft_t = tsm.emit_frames(orbit["rec_t"], kR_t, kt_t)
    fR_j, ft_j = jsm.emit_frames(orbit["rec_j"], np.asarray(kR_j),
                                 np.asarray(kt_j))
    assert ft_t.shape == (N_FRAMES - 1, 3)
    assert_close(ft_t, ft_j, TOL, what="frame t")
    assert_close(fR_t, fR_j, TOL, what="frame R")


def test_smooth_trajectory_mesh_raises(orbit):
    """``mesh=`` takes the keyframe-sharded solve (held against the
    reference's in ``tests/test_torch_sharded.py``): an object that is
    not a device mesh raises, with no fall back to one device."""
    with pytest.raises(AttributeError, match="get_group"):
        tsm.smooth_trajectory(orbit["rec_t"], orbit["state"],
                              orbit["cfg_t"], mesh=object())


@pytest.mark.parametrize("seed", [9, 10, 11])
def test_recover_marginals_matches_reference(seed):
    w, f = ba_problem(seed)
    w["lm_valid"][-3:] = False
    f["planes"]["valid"] &= f["planes"]["lm_idx"] < 6
    window = to_jax(jgraph.Window, w)
    factors = jgraph.Factors(**{k: to_jax(cls, f[k]) for k, cls in (
        ("odom", jgraph.OdomFactors), ("planes", jgraph.PlaneFactors),
        ("priors", jgraph.PosePriors))})
    lin = _linearize(window, factors, analytic_planes=True)
    for damping in (1e-9, 1e-6):
        ref = jax.tree.map(np.asarray, _marginals(lin, window, damping))
        lin_t = Linearization(*(torch.tensor(np.asarray(x)) for x in lin))
        win_t = convert.window_from_numpy(jax.tree.map(np.asarray, window),
                                          CPU)
        out = recover_marginals(lin_t, win_t, damping)
        lin64 = Linearization(*(x.double() for x in lin_t))
        out64 = recover_marginals(lin64, win_t, damping)
        for name, a, b, c in zip(out._fields, out, ref, out64):
            a = a.numpy()
            assert np.isfinite(a).all() and a.dtype == np.float32, name
            np.testing.assert_allclose(a, b, rtol=0.0,
                                       atol=MARG_TOL * np.abs(b).max(),
                                       err_msg=f"{name} damping {damping}")
            np.testing.assert_allclose(a, c.numpy(), rtol=0.0,
                                       atol=1e-6 * np.abs(b).max(),
                                       err_msg=f"{name} f64 {damping}")
        free = np.asarray(window.pose_valid & ~window.pose_fixed)
        assert not out.pose_cov.numpy()[~free].any()
        assert not out.plane_cov.numpy()[~np.asarray(window.lm_valid)].any()
