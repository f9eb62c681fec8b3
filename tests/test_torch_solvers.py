"""The port's LM and dog-leg solvers and the plain versions of its
Schur-reduction (K3a/K3b) and plane-Jacobian (K5) kernels against the JAX
package on the CPU.  The CUDA kernels against these plain versions are in
test_torch_cuda.py.

- ``schur_reduce_plain`` vs ``schur_reduce_pallas(interpret=True)`` on the
  single-tile route (W=5, L=9: S rtol 1e-5 / atol 1e-4, steps rtol 1e-4 /
  atol 1e-4, as the reference's own kernel test), on an indefinite system
  where both skip the same direction, and on the tiled route (W=23, L=9:
  rtol 1e-3 / atol 5e-3, a 138-dim f32 factorization summed in another
  order);
- ``plane_terms_analytic`` vs ``plane_terms_pallas(interpret=True)`` at
  F=37 with invalid factors, rtol 1e-5 / atol 1e-5;
- ``lm_solve`` and ``dogleg_solve`` vs the reference's on a W=5 corridor
  problem with robust kernels, the reference compiled once each with
  ``solve_schur``; the port through ``solve_schur`` and through
  ``schur_reduce_plain``: windows 1e-4, cost histories 1e-4 relative,
  ``accepted`` exact;
- ``solve_dense`` vs ``solve_schur`` (1e-4) and the ``make_solve_fn``
  dispatch;
- ``make_solve_fn("on")`` at W=40, L=64 (n = 240: the plain versions of
  K3b and of K4 past its one-block route) vs the reference's
  ``make_solve_fn("auto")`` (``solve_schur`` at 6W > 80): rtol 1e-3 /
  atol 5e-3, the tiled route's tolerance.

Inputs are made from seeds with numpy (``_torch_parity``); every JAX
function here is compiled once per shape.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, ba_problem, indefinite,
                           np_tree, random_problem, random_system, to_jax)
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.factors.robust import RobustConfig as JRC
from pop_up_slam_tpu.factors.robust import RobustKernel as JRK
from pop_up_slam_tpu.ops.plane_jacobians import plane_terms_pallas
from pop_up_slam_tpu.ops.schur_pallas import schur_reduce_pallas
from pop_up_slam_tpu.solver import dogleg as jdl
from pop_up_slam_tpu.solver import gauss_newton as jgn
from pop_up_slam_tpu.solver import schur as jschur
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors import graph as tgraph
from pop_up_slam_tpu_torch.factors.robust import RobustConfig as TRC
from pop_up_slam_tpu_torch.factors.robust import RobustKernel as TRK
from pop_up_slam_tpu_torch.ops import plane_jacobians as tpj
from pop_up_slam_tpu_torch.ops import schur as kschur
from pop_up_slam_tpu_torch.solver import dogleg as tdl
from pop_up_slam_tpu_torch.solver import gauss_newton as tgn
from pop_up_slam_tpu_torch.solver import schur as tschur

ROBUST = (JRC(odom=JRK("huber", 2.0), plane=JRK("cauchy", 3.0)),
          TRC(odom=TRK("huber", 2.0), plane=TRK("cauchy", 3.0)))

# ------------------------------------------------------ K3a / K3b plain


def _system(W, L, seed):
    """A seeded SPD system: the port's window and its linearization."""
    w, f = random_system(seed, W, L)
    wt = convert.window_from_numpy(w, CPU)
    lin = tgraph.linearize(wt, convert.factors_from_numpy(f, CPU),
                           analytic_planes=True)
    return w, wt, lin


@pytest.mark.parametrize("case", ["small", "indefinite", "tiled"])
def test_schur_reduce_plain_matches_reference(case):
    W, L = (23, 9) if case == "tiled" else (5, 9)
    w, wt, lin = _system(W, L, seed=7 if W == 5 else 11)
    if case == "indefinite":
        lin = indefinite(lin)
    out_t = kschur.schur_reduce_plain(lin, wt, 1e-3)
    out_j = schur_reduce_pallas(
        jgraph.Linearization(*(jnp.asarray(x) for x in np_tree(lin))),
        to_jax(jgraph.Window, w), damping=1e-3, interpret=True)
    if case == "tiled":
        tol = dict(rtol=1e-3, atol=5e-3)
        assert_close(out_t.S, out_j.S, what="S", **tol)
    else:
        tol = dict(rtol=1e-4, atol=1e-4)
        assert_close(out_t.S, out_j.S, 1e-4, rtol=1e-5, what="S")
    assert_close(out_t.dxp, out_j.dxp, what="dxp", **tol)
    assert_close(out_t.dxl, out_j.dxl, what="dxl", **tol)
    if case == "indefinite":
        assert float(out_t.dxp[2, 0]) == 0.0 == float(out_j.dxp[2, 0])
    # the wrapper on CPU tensors is the plain version and launches nothing
    before = (kschur.schur_reduce_small.launches, kschur.schur_gemm.launches)
    out_w = kschur.schur_reduce(lin, wt, 1e-3)
    for a, b in zip(out_w, out_t):
        assert torch.equal(a, b)
    assert (kschur.schur_reduce_small.launches,
            kschur.schur_gemm.launches) == before


# ------------------------------------------------------------ K5 plain


def test_plane_terms_analytic_matches_pallas():
    w, pf = random_problem(3, F=37)
    pf["valid"][:3] = False
    out_j = plane_terms_pallas(to_jax(jgraph.Window, w),
                               to_jax(jgraph.PlaneFactors, pf),
                               interpret=True)
    wt = convert.window_from_numpy(w, CPU)
    pft = tgraph.PlaneFactors(*(torch.as_tensor(pf[k])
                                for k in tgraph.PlaneFactors._fields))
    out_t = tpj.plane_terms_analytic(wt, pft)
    for a, b, what in zip(out_t, out_j, ("r", "Jp", "Jl")):
        assert_close(a, b, 1e-5, rtol=1e-5, what=what)
        assert not a[~pft.valid].any(), what
    before = tpj.plane_terms.launches
    for a, b in zip(tpj.plane_terms(wt, pft), out_t):
        assert torch.equal(a, b)
    assert tpj.plane_terms.launches == before


# ------------------------------------------------------ LM and dog-leg

# W=5 corridor problem, measurement noise and initial error x3: LM (lam0
# 1e-4) accepts twice, then rejects two steps that raise the cost by ~1.2
# (3e-3 relative, no near-tie); dog-leg from a 0.05 m trust radius takes
# boundary steps.
SOLVERS = {
    "lm": (jgn.lm_solve, tgn.lm_solve, dict(iters=4, lam0=1e-4)),
    "dogleg": (jdl.dogleg_solve, tdl.dogleg_solve, dict(iters=4,
                                                        delta0=0.05)),
}


def _solver_problem():
    return ba_problem(11, W=5, L=9, prior_gauge=True, noise=3.0)


@functools.lru_cache(maxsize=None)
def _reference(name):
    """The reference solver on the problem, compiled once: numpy
    (window, stats)."""
    j_solve, _, kw = SOLVERS[name]
    w, f = _solver_problem()
    wj = to_jax(jgraph.Window, w)
    fj = jgraph.Factors(odom=to_jax(jgraph.OdomFactors, f["odom"]),
                        planes=to_jax(jgraph.PlaneFactors, f["planes"]),
                        priors=to_jax(jgraph.PosePriors, f["priors"]))
    out = jax.jit(lambda w_, f_: j_solve(
        w_, f_, solve_fn=jschur.solve_schur, analytic_planes=True,
        robust=ROBUST[0], **kw))(wj, fj)
    return np_tree(out)


@pytest.mark.parametrize("route", ["solve_schur", "schur_reduce"])
@pytest.mark.parametrize("name", ["lm", "dogleg"])
def test_solver_matches_reference(name, route):
    w_j, s_j = _reference(name)
    _, t_solve, kw = SOLVERS[name]
    w, f = _solver_problem()
    solve_fn = (tschur.solve_schur if route == "solve_schur"
                else kschur.schur_reduce_plain)
    w_t, s_t = t_solve(convert.window_from_numpy(w, CPU),
                       convert.factors_from_numpy(f, CPU), solve_fn=solve_fn,
                       analytic_planes=True, robust=ROBUST[1], **kw)
    assert_close(w_t, w_j, 1e-4, what="window")
    assert_close(s_t.cost_history, s_j.cost_history, 0.0, rtol=1e-4,
                 what="cost_history")
    assert_close(s_t.lambdas, s_j.lambdas, 0.0, rtol=1e-4, what="lambdas")
    assert_close(s_t.step_norms, s_j.step_norms, 1e-4, rtol=1e-3,
                 what="step_norms")
    np.testing.assert_array_equal(s_t.accepted.numpy(), s_j.accepted)
    if name == "lm":
        np.testing.assert_array_equal(s_j.accepted, [True, True, False,
                                                     False])


# ------------------------------------------------- dense solve, dispatch


@pytest.mark.parametrize("prior_gauge", [False, True])
def test_solve_dense_matches_solve_schur(prior_gauge):
    w, f = ba_problem(4, W=5, L=9, prior_gauge=prior_gauge)
    wt = convert.window_from_numpy(w, CPU)
    lin = tgraph.linearize(wt, convert.factors_from_numpy(f, CPU),
                           analytic_planes=True)
    dxp, dxl = tschur.solve_dense(lin, wt, 1e-5)
    sol = tschur.solve_schur(lin, wt, 1e-5)
    assert_close(dxp, sol.dxp, 1e-4, what="dxp")
    assert_close(dxl, sol.dxl, 1e-4, what="dxl")


def test_make_solve_fn_dispatch():
    _, wt, lin = _system(5, 9, seed=7)
    assert tschur.make_solve_fn("off") is tschur.solve_schur
    assert tschur.make_solve_fn("on") is kschur.schur_reduce
    # "auto" on CPU tensors is solve_schur, as the reference's off the TPU
    auto = tschur.make_solve_fn("auto")(lin, wt, 1e-3)
    ref = tschur.solve_schur(lin, wt, 1e-3)
    for a, b in zip(auto, ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tschur.make_solve_fn("sometimes")


def test_make_solve_fn_on_matches_reference_at_w40():
    """n = 6W = 240, where K4 leaves its one-block route: the port's
    Schur route on CPU tensors against the reference's ``"auto"``."""
    w, f = random_system(13, W=40, L=64, F=240)
    wt = convert.window_from_numpy(w, CPU)
    lin = tgraph.linearize(wt, convert.factors_from_numpy(f, CPU),
                           analytic_planes=True)
    out_t = tschur.make_solve_fn("on")(lin, wt, 1e-3)
    j_solve = jschur.make_solve_fn("auto")
    assert j_solve is jschur.solve_schur
    out_j = j_solve(
        jgraph.Linearization(*(jnp.asarray(x) for x in np_tree(lin))),
        to_jax(jgraph.Window, w), 1e-3)
    tol = dict(rtol=1e-3, atol=5e-3)
    assert_close(out_t.S, out_j.S, what="S", **tol)
    assert_close(out_t.dxp, out_j.dxp, what="dxp", **tol)
    assert_close(out_t.dxl, out_j.dxl, what="dxl", **tol)
