"""Parity of the port's factors and solver (linearize, Schur, Gauss-Newton,
the small dense helpers) with the JAX package.

Inputs: a numpy-seeded corridor BA problem (6 poses, 9 planes, noisy
odometry and plane measurements; ``_torch_parity.ba_problem``), handed to
both sides, to the port through ``convert.py``; numpy-seeded SPD
matrices.  Tolerances: 1e-4
absolute on solver outputs (poses in m, unit planes), relative 1e-4 on
normal-equation blocks whose entries reach ~1e5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import CPU, assert_close, ba_problem, np_tree, to_jax
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.factors.robust import RobustConfig as JRC
from pop_up_slam_tpu.factors.robust import RobustKernel as JRK
from pop_up_slam_tpu.solver import gauss_newton as jgn
from pop_up_slam_tpu.solver import schur as jschur
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors import graph as tgraph
from pop_up_slam_tpu_torch.factors.robust import RobustConfig as TRC
from pop_up_slam_tpu_torch.factors.robust import RobustKernel as TRK
from pop_up_slam_tpu_torch.solver import gauss_newton as tgn
from pop_up_slam_tpu_torch.solver import schur as tschur

ROBUST = (JRC(odom=JRK("huber", 2.0), plane=JRK("cauchy", 3.0)),
          TRC(odom=TRK("huber", 2.0), plane=TRK("cauchy", 3.0)))


def _problem(prior_gauge: bool, seed: int = 3):
    """The same seeded numpy problem as the reference's tuples and, via
    ``convert``, as the port's."""
    w, f = ba_problem(seed, prior_gauge=prior_gauge)
    window = to_jax(jgraph.Window, w)
    factors = jgraph.Factors(
        odom=to_jax(jgraph.OdomFactors, f["odom"]),
        planes=to_jax(jgraph.PlaneFactors, f["planes"]),
        priors=to_jax(jgraph.PosePriors, f["priors"]))
    return (window, factors,
            convert.window_from_numpy(np_tree(window), CPU),
            convert.factors_from_numpy(np_tree(factors), CPU))


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n)).astype(np.float32)
    return (A @ A.T + n * np.eye(n, dtype=np.float32)).astype(np.float32)


def test_small_dense_helpers():
    H = np.stack([_spd(6, s) for s in range(8)])
    assert_close(tschur.inv3x3(torch.as_tensor(H[:, :3, :3])),
                 jschur.inv3x3(jnp.asarray(H[:, :3, :3])), 1e-6, rtol=1e-4,
                 what="inv3x3")
    assert_close(tschur.spd_inv6_blocked(torch.as_tensor(H)),
                 jschur.spd_inv6_blocked(jnp.asarray(H)), 1e-6, rtol=1e-4,
                 what="spd_inv6")
    L_t = tschur.chol_small(torch.as_tensor(H))
    L_j = jschur.chol_small(jnp.asarray(H))
    assert_close(L_t, L_j, 1e-5, rtol=1e-5, what="chol_small")
    B = np.random.default_rng(9).normal(size=(8, 6, 2)).astype(np.float32)
    assert_close(tschur.cho_solve_small(L_t, torch.as_tensor(B)),
                 jschur.cho_solve_small(L_j, jnp.asarray(B)), 1e-5,
                 rtol=1e-4, what="cho_solve_small")


@functools.lru_cache(maxsize=None)
def _jax_linearize(robust: bool):
    """The reference's (linearize, total_cost), compiled once per robust
    configuration (the gauge only changes values)."""
    rj = ROBUST[0] if robust else None
    return jax.jit(lambda w, f: (
        jgraph.linearize(w, f, analytic_planes=True, robust=rj),
        jgraph.total_cost(w, f, robust=rj)))


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("prior_gauge", [False, True])
def test_linearize_matches(prior_gauge, robust):
    wj, fj, wt, ft = _problem(prior_gauge)
    rt = ROBUST[1] if robust else None
    lj, cost_j = _jax_linearize(robust)(wj, fj)
    lt = tgraph.linearize(wt, ft, analytic_planes=True, robust=rt)
    for name in lj._fields:
        b = np.asarray(getattr(lj, name))
        assert_close(getattr(lt, name), b, 1e-4 * max(1.0, np.abs(b).max()),
                     what=name)
    assert_close(tgraph.total_cost(wt, ft, robust=rt), cost_j,
                 1e-4 * float(lj.cost), what="total_cost")


def test_solve_schur_matches():
    wj, fj, wt, ft = _problem(prior_gauge=True)
    lj, sj = jax.jit(lambda w, f: (
        lambda lin: (lin, jschur.solve_schur(lin, w, damping=1e-5)))(
            jgraph.linearize(w, f, analytic_planes=True)))(wj, fj)
    lt = tgraph.linearize(wt, ft, analytic_planes=True)
    st = tschur.solve_schur(lt, wt, damping=1e-5)
    assert_close(st.S, sj.S, 1e-4 * float(np.abs(sj.S).max()), what="S")
    assert_close(st.dxp, sj.dxp, 1e-4, what="dxp")
    assert_close(st.dxl, sj.dxl, 1e-4, what="dxl")


@pytest.mark.parametrize("prior_gauge,robust", [(False, False),
                                                (True, True)])
def test_gn_solve_matches(prior_gauge, robust):
    wj, fj, wt, ft = _problem(prior_gauge)
    rj, rt = ROBUST if robust else (None, None)
    w_j, s_j = jax.jit(lambda w, f: jgn.gn_solve(
        w, f, iters=3, damping=1e-5, analytic_planes=True, robust=rj))(wj, fj)
    w_t, s_t = tgn.gn_solve(wt, ft, iters=3, damping=1e-5,
                            analytic_planes=True, robust=rt)
    assert_close(w_t, w_j, 1e-4, what="window")
    assert_close(s_t.cost_history, s_j.cost_history, 1e-2, rtol=1e-4,
                 what="cost_history")
    assert_close(s_t.step_norms, s_j.step_norms, 1e-4, rtol=1e-3,
                 what="step_norms")


def test_failed_factorization_keeps_the_state(no_debug_nans):
    """A non-PD reduced system: the reference's Cholesky yields NaN and
    sanitize_step zeroes the step; the port fills NaN on ``info != 0``
    to keep that behaviour."""
    S = np.diag(np.array([4.0, -1.0, 9.0], np.float32))
    L_t = tschur.cholesky_nan(torch.as_tensor(S))
    L_j = jnp.linalg.cholesky(jnp.asarray(S))
    np.testing.assert_array_equal(torch.isnan(L_t).numpy(),
                                  np.asarray(jnp.isnan(L_j)))
    dxp = torch.full((2, 6), float("nan"))
    dxl = torch.zeros((3, 3))
    p2, l2, ok = tgn.sanitize_step(dxp, dxl)
    _, _, ok_j = jgn.sanitize_step(jnp.asarray(dxp.numpy()),
                                   jnp.asarray(dxl.numpy()))
    assert bool(ok) == bool(ok_j) is False
    assert torch.equal(p2, torch.zeros_like(p2))
    _, _, ok_big = tgn.sanitize_step(torch.full((2, 6), 1e9), dxl)
    assert not bool(ok_big)


def test_unported_paths_raise():
    """No path of this module raises for being unported any more: the
    per-factor jacfwd linearization, the last one, now runs and agrees
    with the closed form (its parity tests are in test_torch_jacfwd.py),
    as the reduced-solve dispatch and LM do (test_torch_solvers.py); an
    unknown solve route still raises."""
    _, _, wt, ft = _problem(prior_gauge=False)
    lin_j = tgraph.linearize(wt, ft, analytic_planes=False)
    lin_a = tgraph.linearize(wt, ft, analytic_planes=True)
    for a, b in zip(lin_j, lin_a):
        assert torch.isfinite(a).all()
        assert_close(a, b.numpy(), 1e-5 * max(1.0, float(b.abs().max())))
    r, Jp, Jl = tgraph._plane_terms(wt, ft.planes)
    assert torch.isfinite(Jp).all() and Jl.shape[1:] == (3, 3)
    with pytest.raises(ValueError, match="pallas"):
        tschur.make_solve_fn("bogus")
    solve_on = tschur.make_solve_fn("on")
    w_t, stats = tgn.lm_solve(wt, ft, iters=1, solve_fn=solve_on,
                              analytic_planes=True)
    assert torch.isfinite(w_t.t).all() and stats.accepted.shape == (1,)
    assert tschur.make_solve_fn("off") is tschur.solve_schur
