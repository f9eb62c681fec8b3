"""Parity of the PyTorch port's geometry (SE(3), planes, camera) with the
JAX package, on batched numpy inputs that include near-zero angles and
argmax ties.  Tolerance 1e-5 (f32, O(1) values)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import REPO, assert_close
from pop_up_slam_tpu.geometry import camera as jcam
from pop_up_slam_tpu.geometry import plane as jplane
from pop_up_slam_tpu.geometry import se3 as jse3
from pop_up_slam_tpu_torch.geometry import camera as tcam
from pop_up_slam_tpu_torch.geometry import plane as tplane
from pop_up_slam_tpu_torch.geometry import se3 as tse3

TOL = 1e-5


def _xi(seed, n=64):
    """Tangent vectors with angles from 0 through the small-angle switch
    (0.1 rad) up to ~2.5 rad, plus exact zeros."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(n, 6)).astype(np.float32)
    ax = xi[:, 3:] / np.linalg.norm(xi[:, 3:], axis=1, keepdims=True)
    ang = np.concatenate([
        np.zeros(4), 10.0 ** rng.uniform(-7, -1, n // 2 - 4),
        rng.uniform(0.05, 2.5, n - n // 2),
    ]).astype(np.float32)
    xi[:, 3:] = ax * ang[:, None]
    xi[:2] = 0.0
    return xi


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("seed", [0, 1])
def test_so3_se3_exp_log(seed):
    xi = _xi(seed)
    R_j, t_j = jse3.se3_exp(jnp.asarray(xi))
    R_t, t_t = tse3.se3_exp(_t(xi))
    assert_close(R_t, R_j, TOL, what="R")
    assert_close(t_t, t_j, TOL, what="t")
    assert_close(tse3.se3_log(R_t, t_t), jse3.se3_log(R_j, t_j), 2e-5,
                 what="log")
    assert_close(tse3.so3_log(R_t), jse3.so3_log(R_j), TOL, what="so3_log")


@pytest.mark.parametrize("seed", [2, 3])
def test_jacobians_and_adjoint(seed):
    xi = _xi(seed)
    xi[:, :3] *= 0.5
    assert_close(tse3.se3_right_jacobian_inv(_t(xi)),
                 jse3.se3_right_jacobian_inv(jnp.asarray(xi)), 2e-5,
                 what="Jr_inv")
    R, t = jse3.se3_exp(jnp.asarray(xi))
    assert_close(tse3.se3_adjoint(_t(R), _t(t)), jse3.se3_adjoint(R, t), TOL,
                 what="adjoint")
    assert_close(tse3.se3_Q(_t(xi[:, :3]), _t(xi[:, 3:])),
                 jse3.se3_Q(jnp.asarray(xi[:, :3]), jnp.asarray(xi[:, 3:])),
                 TOL, what="Q")


def test_rotmat_to_quat_ties():
    """Identity, 180-degree turns and diagonal ties: the first maximum of
    (tr, m00, m11, m22) wins in both."""
    Rs = np.stack([
        np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
        np.diag([-1.0, -1.0, 1.0]),
        np.array([[0, 1, 0], [1, 0, 0], [0, 0, -1.0]]),
        np.array([[0, 0, 1], [0, -1, 0], [1, 0, 0.0]]),
    ]).astype(np.float32)
    assert_close(tse3.rotmat_to_quat(_t(Rs)),
                 jse3.rotmat_to_quat(jnp.asarray(Rs)), TOL, what="quat")


def test_compose_between_retract():
    xa, xb = _xi(4, 32), _xi(5, 32)
    Ra, ta = jse3.se3_exp(jnp.asarray(xa))
    Rb, tb = jse3.se3_exp(jnp.asarray(xb))
    out_j = jse3.se3_between(Ra, ta, Rb, tb)
    out_t = tse3.se3_between(_t(Ra), _t(ta), _t(Rb), _t(tb))
    assert_close(out_t, tuple(out_j), TOL, what="between")
    ret_j = jse3.se3_retract(Ra, ta, jnp.asarray(xb))
    ret_t = tse3.se3_retract(_t(Ra), _t(ta), _t(xb))
    assert_close(ret_t, tuple(ret_j), TOL, what="retract")


def _planes(seed, n=48):
    rng = np.random.default_rng(seed)
    pi = rng.normal(size=(n, 4)).astype(np.float32)
    # ties in |component| (argmax first index), zero d, tiny d
    pi[0] = [0.5, 0.5, 0.5, 0.5]
    pi[1] = [0.0, 0.7, -0.7, 0.0]
    pi[2] = [1.0, 0.0, 0.0, 1e-8]
    pi[3] = [0.0, 0.0, -1.0, 0.0]
    pi[4] = [-0.6, 0.6, 0.0, 0.3]
    return pi


@pytest.mark.parametrize("seed", [6, 7])
def test_plane_ops(seed):
    pi = _planes(seed)
    pj, pt = jnp.asarray(pi), _t(pi)
    assert_close(tplane.normalize(pt), jplane.normalize(pj), TOL, what="norm")
    unit_j = jplane.normalize(pj)
    unit_t = tplane.normalize(pt)
    assert_close(tplane.tangent_basis(unit_t), jplane.tangent_basis(unit_j),
                 TOL, what="B4")
    n_j, _ = jplane.to_hessian_normal(unit_j)
    n_t, _ = tplane.to_hessian_normal(unit_t)
    assert_close(tplane.normal_tangent_basis(n_t),
                 jplane.normal_tangent_basis(n_j), TOL, what="B3")
    delta = np.random.default_rng(seed).normal(size=(len(pi), 3)).astype(
        np.float32) * 0.05
    assert_close(tplane.retract(unit_t, _t(delta)),
                 jplane.retract(unit_j, jnp.asarray(delta)), TOL,
                 what="retract")
    other = np.roll(pi, 1, axis=0)
    assert_close(tplane.hessian_local(unit_t, _t(other)),
                 jplane.hessian_local(unit_j, jnp.asarray(other)), TOL,
                 what="hessian_local")
    assert_close(tplane.normal_angle(unit_t, _t(other)),
                 jplane.normal_angle(unit_j, jnp.asarray(other)), 1e-4,
                 what="normal_angle")


def test_plane_transform_and_camera():
    xi = _xi(8, 16)
    xi[:, :3] *= 3.0
    R, t = jse3.se3_exp(jnp.asarray(xi))
    pi = jplane.normalize(jnp.asarray(_planes(9, 16)))
    assert_close(tplane.transform(_t(pi), _t(R), _t(t)),
                 jplane.transform(pi, R, t), TOL, what="transform")
    assert_close(tplane.transform_to_world(_t(pi), _t(R), _t(t)),
                 jplane.transform_to_world(pi, R, t), TOL, what="to_world")

    Kj = jcam.Intrinsics.create(80.0, 80.0, 80.0, 60.0)
    Kt = tcam.Intrinsics.create(80.0, 80.0, 80.0, 60.0, device="cpu")
    rng = np.random.default_rng(10)
    uv = rng.uniform(0, 160, size=(16, 2)).astype(np.float32)
    ground = np.array([0.0, 0.0, 1.0, 0.0], np.float32)
    pj, okj = jcam.backproject_to_world_plane(Kj, jnp.asarray(uv), R, t,
                                              jnp.asarray(ground))
    pt, okt = tcam.backproject_to_world_plane(Kt, _t(uv), _t(R), _t(t),
                                              _t(ground))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert_close(pt, pj, 1e-4, rtol=1e-5, what="backproject")
    rays = tcam.pixel_rays(Kt, _t(uv))
    assert_close(rays, jcam.pixel_rays(Kj, jnp.asarray(uv)), TOL, what="rays")
    sj, vj = jcam.ray_plane_depth(jcam.pixel_rays(Kj, jnp.asarray(uv)), pi)
    st, vt = tcam.ray_plane_depth(rays, _t(pi))
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    assert_close(st, sj, 1e-4, rtol=1e-5, what="ray_plane_depth")


def test_port_imports_without_jax():
    """The port imports in a process where ``import jax`` and the JAX
    package both fail: every module, the monocular and TUM slices'
    included, and the slice of the batched and pipelined runners, the
    segmenter network, the native loader, the problem builder and the
    export, the multi-device strategies, the sharded runner and the
    segmenter's training script."""
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['pop_up_slam_tpu'] = None; "
            "import pop_up_slam_tpu_torch, pop_up_slam_tpu_torch.pipeline, "
            "pop_up_slam_tpu_torch.ops, pop_up_slam_tpu_torch.convert, "
            "pop_up_slam_tpu_torch.odometry, pop_up_slam_tpu_torch.fusion, "
            "pop_up_slam_tpu_torch.factors.graph, "
            "pop_up_slam_tpu_torch.pipeline.offline, "
            "pop_up_slam_tpu_torch.pipeline.smoothing, "
            "pop_up_slam_tpu_torch.solver.covariance, "
            "pop_up_slam_tpu_torch.evaluation.ate, "
            "pop_up_slam_tpu_torch.utils.metrics, "
            "pop_up_slam_tpu_torch.utils.checkpoint, "
            "pop_up_slam_tpu_torch.io.png, pop_up_slam_tpu_torch.io.tum, "
            "pop_up_slam_tpu_torch.io.synthetic, "
            "pop_up_slam_tpu_torch.io.tum_fixture, "
            "pop_up_slam_tpu_torch.models.segmentation, "
            "pop_up_slam_tpu_torch.config, "
            "pop_up_slam_tpu_torch.runners.tum_runner, "
            "pop_up_slam_tpu_torch.cli, "
            "pop_up_slam_tpu_torch.pipeline.batched, "
            "pop_up_slam_tpu_torch.pipeline.pipelined, "
            "pop_up_slam_tpu_torch.io.native_loader, "
            "pop_up_slam_tpu_torch.io.problems, "
            "pop_up_slam_tpu_torch.viz, pop_up_slam_tpu_torch.viz.export, "
            "pop_up_slam_tpu_torch.models, "
            "pop_up_slam_tpu_torch.parallel, "
            "pop_up_slam_tpu_torch.parallel.distributed, "
            "pop_up_slam_tpu_torch.parallel.map_blocks, "
            "pop_up_slam_tpu_torch.parallel.keyframe_blocks, "
            "pop_up_slam_tpu_torch.parallel.multihost, "
            "pop_up_slam_tpu_torch.pipeline.sharded; "
            "sys.path.insert(0, 'scripts'); import train_segnet_torch; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_raise_without_cuda():
    """With no device named and no GPU present, entry points raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pop_up_slam_tpu_torch.pipeline import SlamConfig, slam_init

    with pytest.raises(RuntimeError, match="no CUDA device"):
        slam_init(SlamConfig(), np.eye(3, dtype=np.float32),
                  np.zeros(3, np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcam.Intrinsics.create(1.0, 1.0, 0.0, 0.0)
