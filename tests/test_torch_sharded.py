"""The port's sharded runner (``pipeline/sharded.py``), the BA hook it
runs through (``slam_step(solve_impl=)``), the mesh smoother and the
CLI's distributed presets, against the JAX package on the CPU.

The reference's sharded runner and mesh smoother are not called live:
their outputs on a 2-device CPU mesh are recorded in
``corridor_ref_sharded.npz`` (``scripts/make_torch_reference.py
sharded``).  The port's ranks are spawned gloo processes
(``_torch_dist.run_ranks``), once per world size for the file:

- ``slam_step(solve_impl=)``: the JAX ``slam_step`` and the port's with
  the same hook (each package's ``gn_solve``) over the first six frames
  of the small stream (W=4: the window fills and slides, the exiting
  keyframe marginalized outside the fused solver), from the same
  detections: every pose within 1e-4, ``n_kf`` and the window's validity
  exactly;
- ``run_sequence_sharded`` at 1 and 2 ranks on the small stream of
  ``tests/test_sharded_runner.py`` (48x64, 10 frames, W=4, L=16, block 4,
  the tail padded) against the recorded JAX run: every pose within the
  reference's cross-path bound (15 mm), each frame's ``n_kf`` (its
  keyframe decisions), the end state's ``n_kf``, ``n_overflow`` and
  ``store.valid`` exactly; ``all_reduce`` once a GN iteration of each
  keyframe and one ``all_gather`` per detection field a block;
- the tail, as ``tests/test_sharded_runner.py:85-117``: padding does not
  warn and its first 8 frames equal the block-aligned run's (atol
  1e-6); ``tail="drop"`` warns "dropping 2 tail frames" and returns 8;
- ``smooth_trajectory(mesh=)`` at 1 and 2 ranks on the TUM reference's
  recorder and state (``corridor_ref_tum.npz``, 46 keyframes) within
  1e-4 of the recorded JAX mesh smoother;
- the CLI's ``single_host`` and ``multi_host`` presets at one rank on the
  CPU, 16 frames at 240x320 (the chip check runs them at 480x640): the
  reference's summary keys, the frame count, finite poses.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_parity import CPU, REPO
from pop_up_slam_tpu.pipeline import slam as jslam
from pop_up_slam_tpu.solver import gn_solve as j_gn_solve
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
from pop_up_slam_tpu_torch.pipeline import slam as tslam
from pop_up_slam_tpu_torch.popup import popup as tpp
from pop_up_slam_tpu_torch.solver import gn_solve as t_gn_solve

DATA = os.path.join(REPO, "pop_up_slam_tpu_torch", "data")
REF = np.load(os.path.join(DATA, "corridor_ref_sharded.npz"))
REF_TUM = np.load(os.path.join(DATA, "corridor_ref_tum.npz"))
TRAJ_BOUND_M = 0.015
K_SMALL = (32.0, 32.0, 32.0, 24.0)
PCFG = dict(min_cols=4, smooth_radius=2, nms_radius=3)
SCFG = dict(window_size=4, max_landmarks=16, max_det=9, kf_trans=0.0,
            kf_rot=0.0)
CLI_FRAMES = 16


def _small(key):
    return REF[f"small.{key}"]


def _tree(ref, prefix, i=0):
    """The keys ``prefix...`` of a reference file as nested dicts, entry
    ``i`` of each."""
    tree = {}
    for k in ref.files:
        if k.startswith(prefix):
            node = tree
            *path, leaf = k[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = ref[k][i]
    return tree


def _runner(frames, tail="pad"):
    return dict(masks=_small("masks")[:frames],
                odom_R=_small("odom_R")[:frames],
                odom_t=_small("odom_t")[:frames], R0=_small("gt_R")[0],
                t0=_small("gt_t")[0], K=K_SMALL, pcfg=PCFG, scfg=SCFG,
                block=4, tail=tail)


def _smoother():
    from pop_up_slam_tpu_torch.config import get_config

    return dict(rec=_tree(REF_TUM, "rec.", slice(None)),
                state=_tree(REF_TUM, "state."),
                scfg=get_config("tum_fr3").slam._asdict())


def _cli(preset):
    return dict(argv=["run", "--config", preset, "--device", "cpu",
                      "--frames", str(CLI_FRAMES), "--height", "240",
                      "--width", "320"])


@functools.cache
def _ranks(n):
    """Every case of ``n`` ranks, run once for the file."""
    cases = [("run", "runner", _runner(10)),
             ("smoother", "smoother", _smoother())]
    if n == 1:
        cases += [("single_host", "cli", _cli("single_host")),
                  ("multi_host", "cli", _cli("multi_host"))]
    else:
        cases += [("run8", "runner", _runner(8)),
                  ("drop", "runner", _runner(10, tail="drop"))]
    return run_ranks(n, cases)


def test_slam_step_solve_impl_matches_reference():
    cfg_t, cfg_j = tslam.SlamConfig(**SCFG), jslam.SlamConfig(**SCFG)
    K = Intrinsics.create(*K_SMALL, device=CPU)
    pcfg = tpp.PopupConfig(**PCFG)

    def hook_t(w, f):
        return t_gn_solve(w, f, iters=cfg_t.gn_iters, damping=cfg_t.damping,
                          analytic_planes=cfg_t.analytic_planes,
                          robust=cfg_t.robust)[0]

    def hook_j(w, f):
        return j_gn_solve(w, f, iters=cfg_j.gn_iters, damping=cfg_j.damping,
                          analytic_planes=cfg_j.analytic_planes,
                          robust=cfg_j.robust)[0]

    step_j = jax.jit(lambda s, d, oR, ot: jslam.slam_step(
        s, d, oR, ot, cfg_j, solve_impl=hook_j))
    st_t = tslam.slam_init(cfg_t, _small("gt_R")[0], _small("gt_t")[0],
                           device=CPU)
    st_j = jslam.slam_init(cfg_j, _small("gt_R")[0], _small("gt_t")[0])
    for i in range(6):
        R_p, t_p = (torch.as_tensor(_small(k)[i]) for k in ("popup_R",
                                                           "popup_t"))
        res = tpp.pop_up(K, torch.as_tensor(_small("masks")[i]), R_p, t_p,
                         pcfg)
        det = tslam.detections_from_popup(res, R_p, t_p, cfg_t.max_det)
        oR, ot = (torch.as_tensor(_small(k)[i]) for k in ("odom_R",
                                                          "odom_t"))
        st_t, (R_t, t_t) = tslam.slam_step(st_t, det, oR, ot, cfg_t,
                                           solve_impl=hook_t)
        st_j, (R_j, t_j) = step_j(
            st_j, jslam.FrameDetections(*(x.numpy() for x in det)),
            oR.numpy(), ot.numpy())
        assert int(st_t.n_kf) == int(st_j.n_kf) == i + 2
        np.testing.assert_array_equal(st_t.window.pose_valid.numpy(),
                                      np.asarray(st_j.window.pose_valid))
        np.testing.assert_array_equal(st_t.window.lm_valid.numpy(),
                                      np.asarray(st_j.window.lm_valid))
        for a, b in ((t_t, t_j), (R_t, R_j), (st_t.window.t, st_j.window.t),
                     (st_t.mprior_t, st_j.mprior_t),
                     (st_t.mprior_sqrt, st_j.mprior_sqrt)):
            a = a.numpy()
            assert np.isfinite(a).all()
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("n", (1, 2))
def test_run_sequence_sharded_matches_reference(n):
    res = _ranks(n)
    for r, out in enumerate(res):
        run = out["run"]
        assert run["t"].shape == (10, 3) and np.isfinite(run["t"]).all()
        err = np.abs(run["t"] - _small("t")).max()
        assert err <= TRAJ_BOUND_M, (r, err)
        np.testing.assert_array_equal(run["frame_n_kf"][:10],
                                      _small("frame_n_kf"))
        assert run["n_kf"] == int(_small("n_kf"))
        assert run["n_overflow"] == int(_small("n_overflow"))
        np.testing.assert_array_equal(run["store_valid"],
                                      _small("store_valid"))
        # every rank holds the same state
        np.testing.assert_array_equal(run["t"], res[0]["run"]["t"])
        # one all_reduce a GN iteration of each keyframe solve (the tail
        # pad's identity frames are none), four gathers a block
        solves = int(_small("n_kf")) - 1
        assert run["collectives"]["all_reduce"] == 2 * solves, run
        assert run["collectives"]["all_gather"] == 4 * 3, run


def test_run_sequence_sharded_tail():
    """At 2 ranks (block 4)."""
    for out in _ranks(2):
        assert out["run"]["warnings"] == []        # padding does not warn
        np.testing.assert_allclose(out["run"]["t"][:8], out["run8"]["t"],
                                   atol=1e-6)
        drop = out["drop"]
        assert drop["t"].shape == (8, 3)
        assert any("dropping 2 tail frames" in w for w in drop["warnings"])


@pytest.mark.parametrize("n", (1, 2))
def test_mesh_smoother_matches_reference(n):
    for out in _ranks(n):
        sm = out["smoother"]
        assert sm["kf_t"].shape == REF["mesh_kf_t"].shape
        assert np.isfinite(sm["kf_t"]).all()
        np.testing.assert_allclose(sm["kf_t"], REF["mesh_kf_t"], atol=1e-4)
        np.testing.assert_allclose(sm["kf_R"], REF["mesh_kf_R"], atol=1e-4)


def test_cli_distributed_presets():
    """At one rank."""
    res = _ranks(1)
    keys = {k.split(".", 1)[1] for k in REF.files
            if k.startswith("cli_single_host.")}
    for preset in ("single_host", "multi_host"):
        out = res[0][preset]
        assert out["rc"] == 0, out
        s = out["summary"]
        assert set(s) == keys, sorted(s)
        assert s["config"] == preset and s["mode"] == "distributed"
        assert s["n_devices"] == 1 and s["block"] == 16
        assert s["frames"] == CLI_FRAMES and s["finite"]
        assert np.isfinite(s["ate_rmse_m"])
