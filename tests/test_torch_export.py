"""The port's export (``viz/export.py``) and problem builder
(``io/problems.py``) against the JAX package on the CPU.

- ``plane_map_to_meshes`` equal to the reference's on a map with an
  invalid and a non-finite landmark, from numpy and from tensors;
  ``write_ply`` writes the reference's file byte for byte and its counts
  round-trip; ``depth_to_pointcloud`` within 1e-6 (f64 on the host);
  ``plot_topdown`` writes a PNG, and without matplotlib raises
  ``ImportError`` naming it;
- ``build_corridor_problem`` given the reference's ``jax.random`` draws
  equal to the reference's output (recorded by
  ``scripts/make_torch_reference.py batched`` into
  ``corridor_ref_batched.npz``: the reference builds it eagerly, ~20 s
  of per-op compiles here) at 1e-6, integer and boolean fields exactly;
  the port's problems solved by its ``gn_solve`` as
  ``tests/test_solver.py`` solves the reference's (the noiseless one a
  fixed point; noisy odometry, from a ``torch.Generator``, corrected
  below half its error and 2 cm).
"""

import os
import sys

import numpy as np
import pytest
import torch

from _torch_parity import CPU, REPO, assert_close
from pop_up_slam_tpu.geometry.camera import Intrinsics as JK
from pop_up_slam_tpu.viz import export as jexport
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.evaluation import ate_rmse
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics as TK
from pop_up_slam_tpu_torch.io.problems import (CorridorDraws,
                                               build_corridor_problem)
from pop_up_slam_tpu_torch.solver import gn_solve
from pop_up_slam_tpu_torch.viz import export as texport

PROBLEM_KW = dict(noise_odom_t=0.05, noise_odom_r=0.02, noise_plane=0.01,
                  seed=3, lm_perturb=0.05)   # make_torch_reference.py's


def _demo_map():
    endpoints = np.zeros((6, 2, 3))
    endpoints[0] = [[0, 0, 0], [4, 0, 0]]
    endpoints[1] = [[4, 0, 0], [4, 3, 0]]
    endpoints[2] = [[0, 3, 0], [4, 3, 0]]
    endpoints[3] = [[1, 1, 0], [2, 2, 0]]
    endpoints[4] = [[np.nan, 0, 0], [1, 0, 0]]
    valid = np.array([True, True, True, False, True, True])
    return endpoints, valid


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "tensor"])
@pytest.mark.parametrize("include_ground", [True, False])
def test_meshes_match_reference(as_tensor, include_ground):
    endpoints, valid = _demo_map()
    args = ((torch.as_tensor(endpoints), torch.as_tensor(valid))
            if as_tensor else (endpoints, valid))
    got = texport.plane_map_to_meshes(*args, wall_height=2.0,
                                      include_ground=include_ground)
    want = jexport.plane_map_to_meshes(endpoints, valid, wall_height=2.0,
                                       include_ground=include_ground)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.isfinite(g).all()
        np.testing.assert_array_equal(g, w)


def test_write_ply_matches_reference(tmp_path):
    endpoints, valid = _demo_map()
    verts, quads, colors = jexport.plane_map_to_meshes(endpoints, valid)
    traj = np.array([[0.5, 1.0, 1.2], [1.0, 1.1, 1.2], [1.5, 1.3, 1.2]])
    cloud = np.random.default_rng(0).uniform(0, 3, (50, 3))
    pj, pt = str(tmp_path / "ref.ply"), str(tmp_path / "port.ply")
    jexport.write_ply(pj, verts, quads, face_colors=colors, trajectory=traj,
                      cloud=cloud)
    texport.write_ply(pt, torch.as_tensor(verts), torch.as_tensor(quads),
                      face_colors=torch.as_tensor(colors),
                      trajectory=torch.as_tensor(traj),
                      cloud=torch.as_tensor(cloud))
    text = open(pt).read()
    assert text == open(pj).read()
    lines = text.splitlines()
    count = {l.split()[1]: int(l.split()[2]) for l in lines
             if l.startswith("element")}
    assert count == {"vertex": len(verts) + len(traj) + len(cloud),
                     "face": len(quads), "edge": len(traj) - 1}
    body = lines[lines.index("end_header") + 1:]
    assert len(body) == sum(count.values())
    xyz = np.array([[float(v) for v in l.split()[:3]]
                    for l in body[:count["vertex"]]])
    np.testing.assert_allclose(xyz, np.concatenate([verts, traj, cloud]),
                               atol=1e-5)


def test_depth_to_pointcloud_matches_reference():
    rng = np.random.default_rng(1)
    depth = rng.uniform(0.5, 40.0, (32, 40)).astype(np.float32)
    depth[3:6, 4:9] = 0.0
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    t = np.array([1.0, 2.0, 3.0])
    got = texport.depth_to_pointcloud(
        torch.as_tensor(depth), TK.create(40.0, 40.0, 20.0, 16.0,
                                          device=CPU),
        torch.as_tensor(R), torch.as_tensor(t), stride=2)
    want = jexport.depth_to_pointcloud(
        depth, JK.create(40.0, 40.0, 20.0, 16.0), R, t, stride=2)
    assert got.shape == want.shape and len(got) > 0
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_plot_topdown_writes_png(tmp_path):
    pytest.importorskip("matplotlib")
    endpoints, valid = _demo_map()
    traj = torch.tensor([[0.5, 1.0, 0], [1.0, 1.1, 0], [1.5, 1.3, 0]])
    p = str(tmp_path / "map.png")
    texport.plot_topdown(p, endpoints[:3], valid[:3], trajectory=traj,
                         gt_trajectory=traj + 0.05)
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    assert os.path.getsize(p) > 1000


def test_plot_topdown_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    endpoints, valid = _demo_map()
    with pytest.raises(ImportError, match="matplotlib"):
        texport.plot_topdown(str(tmp_path / "map.png"), endpoints, valid)


def test_build_corridor_problem_matches_reference():
    ref = np.load(os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                               "corridor_ref_batched.npz"))
    draws = CorridorDraws(*(torch.as_tensor(ref[f"problem.draws.{k}"])
                            for k in CorridorDraws._fields))
    window, factors, gt_R, gt_t = build_corridor_problem(
        **PROBLEM_KW, draws=draws, device=CPU)
    w_ref = {k: ref[f"problem.window.{k}"][0] for k in window._fields}
    assert_close(window, convert.window_from_numpy(w_ref, CPU), 1e-6,
                 what="window")
    f_ref = {g: {k: ref[f"problem.factors.{g}.{k}"][0]
                 for k in getattr(factors, g)._fields}
             for g in factors._fields}
    assert_close(factors, convert.factors_from_numpy(f_ref, CPU), 1e-6,
                 what="factors")
    assert gt_R.shape == (6, 3, 3) and torch.isfinite(gt_t).all()


def test_exact_corridor_problem_stays_at_truth():
    """As ``tests/test_solver.py``: the noiseless problem is a fixed point
    of ``gn_solve``."""
    window, factors, gt_R, gt_t = build_corridor_problem(device=CPU)
    out, stats = gn_solve(window, factors, iters=3, analytic_planes=True)
    assert torch.isfinite(out.t).all()
    assert float((out.t - gt_t).abs().max()) < 1e-3
    assert float(stats.cost_history[-1]) < 1e-6


@pytest.mark.parametrize("seed", [0, 1])
def test_noisy_odometry_corrected_by_planes(seed):
    """As ``tests/test_solver.py``, on the port's own draws: noiseless
    planes pull GN well below the odometry-only error."""
    window, factors, gt_R, gt_t = build_corridor_problem(
        noise_odom_t=0.05, noise_odom_r=0.02, seed=seed, device=CPU)
    ate_init = ate_rmse(gt_t.numpy(), window.t.numpy())[0]
    out, _ = gn_solve(window, factors, iters=5, damping=1e-6,
                      analytic_planes=True)
    assert torch.isfinite(out.t).all()
    ate_opt = ate_rmse(gt_t.numpy(), out.t.numpy())[0]
    assert ate_opt < 0.5 * ate_init and ate_opt < 0.02, (ate_init, ate_opt)
