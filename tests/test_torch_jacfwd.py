"""The port's per-factor ``jacfwd`` linearization and the rest of its
geometry against the JAX package on the CPU.

- ``se3.vee``, ``quat_to_rotmat``, ``se3_right_jacobian_inv_approx``,
  ``se3_matrix``, ``se3_from_matrix``, ``plane.from_normal_distance``,
  ``plane.local`` and ``camera.project`` on numpy-seeded inputs: 1e-6
  (1e-5 for ``local``, ``project`` 1e-4 relative);
- ``_odom_terms``, ``_plane_terms`` and ``_prior_terms`` (``jacfwd`` under
  ``vmap``) on two seeded problems, one with padded factors linearized
  at the identity: 1e-5 relative to the largest entry, invalid rows
  exactly zero, everything finite;
- ``linearize`` with every combination of ``analytic_planes`` and
  ``analytic_poses``: 1e-5 relative to each output's largest entry; and
  the port's ``jacfwd`` linearization against its closed-form one at the
  same tolerance;
- ``linearize``, ``gn_solve``, ``lm_solve`` and ``dogleg_solve`` called
  with the reference's default arguments (``analytic_planes=False``: the
  ``jacfwd`` plane terms): the window within 1e-4 and the cost history
  within 1e-4 relative.

Each JAX function is compiled once for the whole file (the problems
share their shapes).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, ba_problem, random_system, to_jax
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.geometry import camera as jcam
from pop_up_slam_tpu.geometry import plane as jplane
from pop_up_slam_tpu.geometry import se3 as jse3
from pop_up_slam_tpu.solver import dogleg as jdl
from pop_up_slam_tpu.solver import gauss_newton as jgn
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors import graph as tgraph
from pop_up_slam_tpu_torch.geometry import camera as tcam
from pop_up_slam_tpu_torch.geometry import plane as tplane
from pop_up_slam_tpu_torch.geometry import se3 as tse3
from pop_up_slam_tpu_torch.solver import dogleg as tdl
from pop_up_slam_tpu_torch.solver import gauss_newton as tgn


def _t(x):
    return torch.as_tensor(np.asarray(x))


def test_geometry_matches_reference():
    rng = np.random.default_rng(0)
    f32 = np.float32
    M = rng.normal(size=(5, 3, 3)).astype(f32)
    assert_close(tse3.vee(_t(M)), jse3.vee(M), 1e-6, what="vee")
    q = rng.normal(size=(5, 4)).astype(f32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    assert_close(tse3.quat_to_rotmat(_t(q)), jse3.quat_to_rotmat(q), 1e-6,
                 what="quat_to_rotmat")
    xi = (0.3 * rng.normal(size=(5, 6))).astype(f32)
    assert_close(tse3.se3_right_jacobian_inv_approx(_t(xi)),
                 jse3.se3_right_jacobian_inv_approx(xi), 1e-6,
                 what="jr_inv_approx")
    R = np.asarray(jse3.so3_exp(jnp.asarray(xi[:, 3:])))
    t = xi[:, :3]
    T = tse3.se3_matrix(_t(R), _t(t))
    assert_close(T, jse3.se3_matrix(R, t), 1e-6, what="se3_matrix")
    for a, b in zip(tse3.se3_from_matrix(T), jse3.se3_from_matrix(
            np.asarray(T))):
        assert_close(a, b, 0.0, what="se3_from_matrix")
    n = rng.normal(size=(6, 3)).astype(f32)
    d = rng.normal(size=6).astype(f32)
    d[0] = 0.0
    assert_close(tplane.from_normal_distance(_t(n), _t(d)),
                 jplane.from_normal_distance(n, d), 1e-6,
                 what="from_normal_distance")
    pi_ref = np.asarray(jplane.normalize(rng.normal(size=(6, 4)).astype(f32)))
    pi = pi_ref + 0.05 * rng.normal(size=(6, 4)).astype(f32)
    pi[1] = -pi[1]                                 # antipodal
    assert_close(tplane.local(_t(pi_ref), _t(pi)),
                 jplane.local(pi_ref, pi), 1e-5, what="local")
    K = (80.0, 80.0, 80.0, 60.0)
    p = rng.normal(size=(8, 3)).astype(f32)
    p[:, 2] = np.abs(p[:, 2]) + 0.5
    p[0, 2] = 1e-7                                 # the z clamp
    assert_close(tcam.project(tcam.Intrinsics.create(*K, device="cpu"),
                              _t(p)),
                 jcam.project(jcam.Intrinsics.create(*K), p), 1e-2,
                 rtol=1e-4, what="project")


def _problems():
    """A corridor BA problem and a random system of the same shapes (one
    compile serves both), the latter with its last odometry factor and
    its prior padded (invalid, at the identity)."""
    w1, f1 = ba_problem(1, W=5, L=7, prior_gauge=True)
    w2, f2 = random_system(2, W=5, L=7, F=35)
    f2["odom"]["valid"][-1] = False
    f2["odom"]["i"][-1] = f2["odom"]["j"][-1] = 0
    f2["odom"]["R_meas"][-1] = np.eye(3, dtype=np.float32)
    f2["odom"]["t_meas"][-1] = 0.0
    f2["priors"]["valid"][0] = False
    f2["priors"]["R"][0] = w2["R"][0]
    f2["priors"]["t"][0] = w2["t"][0]
    return [(w1, f1), (w2, f2)]


def _jax(w, f):
    return (to_jax(jgraph.Window, w),
            jgraph.Factors(odom=to_jax(jgraph.OdomFactors, f["odom"]),
                           planes=to_jax(jgraph.PlaneFactors, f["planes"]),
                           priors=to_jax(jgraph.PosePriors, f["priors"])))


def _torch(w, f):
    return convert.window_from_numpy(w, CPU), convert.factors_from_numpy(f,
                                                                         CPU)


def _rel_close(a, b, rtol, what):
    b = np.asarray(b)
    assert_close(a, b, rtol * max(1.0, float(np.abs(b).max())), what=what)


FLAGS = [(ap, apo) for ap in (False, True) for apo in (False, True)]
TERMS = [("_odom_terms", "odom"), ("_plane_terms", "planes"),
         ("_prior_terms", "priors")]


@functools.lru_cache(maxsize=None)
def _jit_terms(name):
    return jax.jit(getattr(jgraph, name))


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("name,field", TERMS)
def test_jacfwd_terms_match_reference(case, name, field):
    w, f = _problems()[case]
    wj, fj = _jax(w, f)
    wt, ft = _torch(w, f)
    out_j = _jit_terms(name)(wj, getattr(fj, field))
    out_t = getattr(tgraph, name)(wt, getattr(ft, field))
    valid = getattr(ft, field).valid
    for i, (a, b) in enumerate(zip(out_t, out_j)):
        assert torch.isfinite(a).all(), (name, i)
        _rel_close(a, b, 1e-5, f"{name}[{i}]")
        assert not a[~valid].any(), (name, i)


@functools.lru_cache(maxsize=None)
def _jit_linearize_all():
    """The reference's linearize with all four flag combinations, in one
    compile; the second, (False, True), is its default."""
    def lin(w, f):
        return [jgraph.linearize(w, f, analytic_planes=ap, analytic_poses=apo)
                for ap, apo in FLAGS]
    return jax.jit(lin)


@pytest.mark.parametrize("case", [0, 1])
def test_linearize_every_flag_matches_reference(case):
    w, f = _problems()[case]
    wj, fj = _jax(w, f)
    wt, ft = _torch(w, f)
    outs_j = _jit_linearize_all()(wj, fj)
    outs_t = [tgraph.linearize(wt, ft, analytic_planes=ap, analytic_poses=apo)
              for ap, apo in FLAGS]
    for (ap, apo), lin_t, lin_j in zip(FLAGS, outs_t, outs_j):
        for name, a, b in zip(lin_t._fields, lin_t, lin_j):
            _rel_close(a, b, 1e-5, f"{name} planes={ap} poses={apo}")
    # the port's jacfwd linearization against its own closed form
    for name, a, b in zip(outs_t[0]._fields, outs_t[0], outs_t[3]):
        _rel_close(a, b.numpy(), 1e-5, f"{name} jacfwd vs analytic")


@functools.lru_cache(maxsize=None)
def _jit_solvers():
    """The reference's three solvers with their default arguments, in one
    compile."""
    return jax.jit(lambda w, f: (jgn.gn_solve(w, f), jgn.lm_solve(w, f),
                                 jdl.dogleg_solve(w, f)))


def test_reference_defaults_run_and_match():
    """``analytic_planes`` defaults to False in the reference, which the
    port used to refuse; ``linearize``, ``gn_solve``, ``lm_solve`` and
    ``dogleg_solve`` called with no flag now run the jacfwd plane terms,
    as the reference's do."""
    w, f = ba_problem(3, W=5, L=7, prior_gauge=True)
    wj, fj = _jax(w, f)
    wt, ft = _torch(w, f)
    lin_j = _jit_linearize_all()(wj, fj)[FLAGS.index((False, True))]
    lin_t = tgraph.linearize(wt, ft)
    for name, a, b in zip(lin_t._fields, lin_t, lin_j):
        _rel_close(a, b, 1e-5, f"linearize {name}")
    for fn, (win_j, stats_j) in zip(
            (tgn.gn_solve, tgn.lm_solve, tdl.dogleg_solve),
            _jit_solvers()(wj, fj)):
        win_t, stats_t = fn(wt, ft)
        assert_close(win_t, win_j, 1e-4, what=fn.__name__)
        _rel_close(stats_t.cost_history, stats_j.cost_history, 1e-4,
                   f"{fn.__name__} costs")
