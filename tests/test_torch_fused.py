"""The plain PyTorch version of the port's K1 (fused windowed GN,
ops/fused_gn.py) against the JAX reference on the CPU (the CUDA kernel
against this plain version is in test_torch_cuda.py).

- plain vs ``gn_solve`` (analytic Jacobians), atol 1e-4;
- plain vs the reference's fused body ``fused_gn_solve(use_pallas=False)``
  at 5e-3 (the reference's own fused-vs-per-op bound), with and without
  the marginal block and a robust kernel; the marginal sqrt-info at 1e-3
  relative;
- the closed-form plane Jacobians it linearizes with, 1e-4 relative.

Inputs: numpy-seeded corridor BA problems (``_torch_parity.ba_problem``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (CPU, assert_close, ba_problem,
                           np_tree, to_jax)
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.factors.robust import RobustConfig as JRC
from pop_up_slam_tpu.factors.robust import RobustKernel as JRK
from pop_up_slam_tpu.ops import fused_gn as jfused
from pop_up_slam_tpu.ops.plane_jacobians import plane_terms_analytic as jpta
from pop_up_slam_tpu.solver import gauss_newton as jgn
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors.robust import RobustConfig as TRC
from pop_up_slam_tpu_torch.factors.robust import RobustKernel as TRK
from pop_up_slam_tpu_torch.ops import fused_gn
from pop_up_slam_tpu_torch.ops.plane_jacobians import plane_terms_analytic

ROBUST = (JRC(odom=JRK("huber", 2.0), plane=JRK("cauchy", 3.0)),
          TRC(odom=TRK("huber", 2.0), plane=TRK("cauchy", 3.0)))
MARG_STATIC = ((1 / 0.03,) * 3 + (1 / 0.01,) * 3, 1e-6, 4.0)


def _problem(seed, prior_gauge=True):
    w, f = ba_problem(seed, prior_gauge=prior_gauge)
    wj = to_jax(jgraph.Window, w)
    fj = jgraph.Factors(odom=to_jax(jgraph.OdomFactors, f["odom"]),
                        planes=to_jax(jgraph.PlaneFactors, f["planes"]),
                        priors=to_jax(jgraph.PosePriors, f["priors"]))
    return (wj, fj, convert.window_from_numpy(np_tree(wj), CPU),
            convert.factors_from_numpy(np_tree(fj), CPU))


def _marg(wj, fj, full):
    """A MARG block from the problem's window: slots 0/1, odometry 0 and
    a prior of modest strength (so the marginal is not dominated by it)."""
    pr = fj.priors
    return jfused.pack_marg(
        wj.R[0], wj.t[0], wj.R[1], wj.t[1], fj.odom.R_meas[0],
        fj.odom.t_meas[0], fj.odom.valid[0], pr.R[0], pr.t[0],
        pr.sqrt_info[0] * 0.5, jnp.asarray(full))


def test_plane_terms_analytic_matches_reference():
    wj, fj, wt, ft = _problem(1)
    out_j = jax.jit(jpta)(wj, fj.planes)
    out_t = plane_terms_analytic(wt, ft.planes)
    for a, b, what in zip(out_t, out_j, ("r", "Jp", "Jl")):
        assert_close(a, b, 1e-4 * max(1.0, float(np.abs(b).max())), what=what)


@pytest.mark.parametrize("robust", [False, True])
def test_fused_gn_plain_matches_gn_solve(robust):
    wj, fj, wt, ft = _problem(2)
    rj, rt = ROBUST if robust else (None, None)
    w_j, s_j = jax.jit(lambda w, f: jgn.gn_solve(
        w, f, iters=2, damping=1e-5, analytic_planes=True, robust=rj))(wj, fj)
    w_t, c_t = fused_gn.fused_gn_solve(wt, ft, iters=2, damping=1e-5,
                                       robust=rt)
    assert_close(w_t, w_j, 1e-4, what="window")
    assert_close(c_t, s_j.cost_history[:2], 1e-2, rtol=1e-4, what="costs")


@functools.lru_cache(maxsize=None)
def _fused_body(marg: bool, robust: bool):
    """The reference fused body, jitted once per static configuration
    (one iteration: its compile dominates this file's time)."""
    rj = ROBUST[0] if robust else JRC()
    if marg:
        return jax.jit(lambda w, f, m: jfused.fused_gn_solve(
            w, f, iters=1, damping=1e-5, robust=rj, use_pallas=False,
            marg=m, marg_static=MARG_STATIC))
    return jax.jit(lambda w, f: jfused.fused_gn_solve(
        w, f, iters=1, damping=1e-5, robust=rj, use_pallas=False))


@pytest.mark.parametrize("marg,full", [(False, False), (True, True),
                                       (True, False)])
def test_fused_gn_plain_matches_fused_body(marg, full):
    """With the marginal block the robust kernels are on; without it,
    off (one compile each)."""
    wj, fj, wt, ft = _problem(4)
    robust = marg
    rt = ROBUST[1] if robust else TRC()
    if marg:
        M = _marg(wj, fj, full)
        w_j, c_j, m_j = _fused_body(True, robust)(wj, fj, M)
        w_t, c_t, m_t = fused_gn.fused_gn_solve(
            wt, ft, iters=1, damping=1e-5, robust=rt,
            marg=torch.as_tensor(np.asarray(M)), marg_static=MARG_STATIC)
        assert_close(m_t, m_j, 1e-3 * float(np.abs(m_j).max()), what="m_sqrt")
    else:
        w_j, c_j = _fused_body(False, robust)(wj, fj)
        w_t, c_t = fused_gn.fused_gn_solve(wt, ft, iters=1, damping=1e-5,
                                           robust=rt)
    assert_close(w_t, w_j, 5e-3, what="window")
    assert_close(c_t, c_j, 1e-2, rtol=5e-3, what="costs")


def test_fused_gn_gate():
    """The kernel's shape gate is its shared-memory budget (227 KB) and
    the 64-bit observer masks (W <= 64)."""
    assert fused_gn.fused_gn_supported(8, 64, 72, 7, 1)
    assert fused_gn.smem_bytes(8, 64, 72, 7, 1) == 105368
    assert not fused_gn.fused_gn_supported(16, 128, 144, 15, 1)
