"""The port's multi-device strategies (``pop_up_slam_tpu_torch/parallel``)
against the JAX package on the CPU, over 1, 2 and 4 gloo ranks.

The ranks are spawned processes (``_torch_dist.run_ranks``: one
rendezvous per world size for the whole file, every case run in it, a
120 s limit).  The reference's sharded functions are never called live
here: the port's sharded functions are held against the reference's
single-device ones, as the reference's own tests hold its sharded
functions (``tests/test_parallel.py``, ``tests/test_parallel_ext.py``),
at their tolerances:

- the ``empty()`` fillers and ``pad_factors_for_sharding``: equal to the
  reference's, exactly;
- ``sharded_linearize`` (``jacfwd`` plane terms): within rtol 3e-4 / atol
  3e-3 of the live JAX ``linearize`` (``test_parallel.py:42-43``), the
  absolute floor raised to 1e-5 of each field's largest entry (the port's
  linearization rule, ``test_torch_jacfwd.py``): the port's own
  single-device ``linearize`` already parts from the reference's at one
  Hpl entry of 972 by 1.0e-3 of that entry (0.019 against a field scale
  of 2.4e4, f32 cancellation in another operation order), and
  within rtol 1e-5 / atol 1e-4 of the port's own ``linearize`` (the
  ranks' blocks are summed in another order); with
  ``analytic_planes=True`` (the plane-Jacobian kernel's plain version on
  the CPU), the same against the port's;
- ``distributed_gn_solve``: t and planes within 1e-3 of the JAX
  ``gn_solve`` (3 iterations, damping 1e-6);
- ``map_block_gn_solve``: within 2e-3, its cost history within rtol 1e-3
  (L = 9 landmark slots: not a multiple of 2 or 4);
- the keyframe-sharded linearization (rtol 1e-5 / atol 5e-3, with the
  same floor of 1e-5 of the field's largest entry against the reference)
  and solve (2e-3);
- ``sharded_popup``: each rank's block equals its slice of the port's
  vmapped pop-up (atol 1e-5), and the gathered pop-up the reference's
  batched pop-up recorded at the same poses (``corridor_ref_batched.npz``:
  valid walls and column counts exactly);
- ``partition_plane_factors`` and ``route_factors_by_keyframe``: host
  numpy passes, equal to the reference's exactly.

The problem is the reference's ``build_corridor_problem`` output recorded
in ``corridor_ref_batched.npz`` (W=6, L=9, 36 plane factors), its window
padded with two invalid pose slots to W=8, which the keyframe strategy
needs at 4 ranks (W a multiple of the world size).  Every rank must
return the same replicated result.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from _torch_dist import run_ranks
from _torch_parity import CPU, REPO, corridor_inputs, to_jax
from pop_up_slam_tpu.factors import graph as jgraph
from pop_up_slam_tpu.parallel import distributed as jdist
from pop_up_slam_tpu.parallel import keyframe_blocks as jkb
from pop_up_slam_tpu.parallel import map_blocks as jmb
from pop_up_slam_tpu.solver import gn_solve as j_gn_solve
from pop_up_slam_tpu_torch import convert
from pop_up_slam_tpu_torch.factors import graph as tgraph
from pop_up_slam_tpu_torch.parallel import (
    pad_factors_for_sharding,
    partition_plane_factors,
    route_factors_by_keyframe,
)
from pop_up_slam_tpu_torch.pipeline.batched import batched_pop_up
from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
from pop_up_slam_tpu_torch.popup import popup as tpp

WORLDS = (1, 2, 4)
ITERS, DAMPING = 3, 1e-6
N_POPUP = 8                  # corridor frames through the DP pop-up
REF_B = os.path.join(REPO, "pop_up_slam_tpu_torch", "data",
                     "corridor_ref_batched.npz")

_linearize = jax.jit(jgraph.linearize,
                     static_argnames=("analytic_planes", "robust"))
_gn_solve = jax.jit(j_gn_solve, static_argnames=(
    "iters", "solve_fn", "analytic_planes", "robust"))


def _recorded_problem():
    ref = np.load(REF_B)
    w = {k: ref[f"problem.window.{k}"][0] for k in tgraph.Window._fields}
    f = {g: {k: ref[f"problem.factors.{g}.{k}"][0] for k in cls._fields}
         for g, cls in (("odom", tgraph.OdomFactors),
                        ("planes", tgraph.PlaneFactors),
                        ("priors", tgraph.PosePriors))}
    pad = 8 - w["R"].shape[0]
    w = dict(w, R=np.concatenate([w["R"], np.tile(np.eye(3, dtype=np.float32),
                                                  (pad, 1, 1))]),
             t=np.concatenate([w["t"], np.zeros((pad, 3), np.float32)]),
             pose_valid=np.concatenate([w["pose_valid"], np.zeros(pad, bool)]),
             pose_fixed=np.concatenate([w["pose_fixed"], np.zeros(pad, bool)]))
    return w, f


PROBLEM = _recorded_problem()


def _jax(w, f):
    return (to_jax(jgraph.Window, w),
            jgraph.Factors(to_jax(jgraph.OdomFactors, f["odom"]),
                           to_jax(jgraph.PlaneFactors, f["planes"]),
                           to_jax(jgraph.PosePriors, f["priors"])))


def _port(w, f):
    return (convert.window_from_numpy(w, CPU),
            convert.factors_from_numpy(f, CPU))


@functools.cache
def _jax_solution():
    """The reference's single-device solve (window, SolveStats) and
    linearization of PROBLEM, compiled once."""
    w, stats = _gn_solve(*_jax(*PROBLEM), iters=ITERS, damping=DAMPING)
    lin = _linearize(*_jax(*PROBLEM))
    return (jax.tree.map(np.asarray, w), [np.asarray(x) for x in lin],
            jax.tree.map(np.asarray, stats))


def _popup_inputs():
    masks = corridor_inputs()[0][:N_POPUP]
    ref = np.load(REF_B)
    return dict(masks=masks, R=ref["dr_R"][:N_POPUP],
                t=ref["dr_t"][:N_POPUP], K=(320.0, 320.0, 320.0, 240.0),
                pcfg={}), ref["popup_valid"][:N_POPUP], \
        ref["popup_n_points"][:N_POPUP]


@pytest.fixture(scope="module", params=WORLDS, ids=lambda n: f"{n}ranks")
def ranks(request):
    """Every case on ``n`` ranks, once: (n, per-rank results)."""
    n = request.param
    w, f = PROBLEM
    cases = [
        ("lin", "linearize", dict(window=w, factors=f)),
        ("lin_analytic", "linearize", dict(window=w, factors=f,
                                           analytic_planes=True)),
        ("gn", "gn", dict(window=w, factors=f, iters=ITERS,
                          damping=DAMPING)),
        ("map_block", "map_block", dict(window=w, factors=f, iters=ITERS,
                                        damping=DAMPING)),
        ("kf_lin", "kf_linearize", dict(window=w, factors=f)),
        ("kf_solve", "kf_solve", dict(window=w, factors=f, iters=ITERS,
                                      damping=DAMPING)),
        ("popup", "popup", _popup_inputs()[0]),
    ]
    return n, run_ranks(n, cases)


def _replicated(results, key):
    """Rank 0's result of ``key``, after checking every rank's equals it."""
    first = results[0][key]
    for r, res in enumerate(results[1:], 1):
        jax.tree.map(lambda a, b: np.testing.assert_array_equal(
            a, b, err_msg=f"rank {r} {key}"), res[key], first)
    return first


def _assert_tree(a, b, rtol, atol, what, scale=0.0):
    """Field by field: finite, within ``rtol`` and an absolute floor of
    ``atol`` or ``scale`` times the field's largest entry."""
    for i, (x, y) in enumerate(zip(a, b)):
        assert np.isfinite(x).all(), (what, i)
        floor = max(atol, scale * float(np.abs(y).max()))
        np.testing.assert_allclose(x, y, rtol=rtol, atol=floor,
                                   err_msg=f"{what} field {i}")


def test_empty_fillers_match_reference():
    for cap in (0, 1, 3):
        for tcls, jcls in ((tgraph.OdomFactors, jgraph.OdomFactors),
                           (tgraph.PlaneFactors, jgraph.PlaneFactors),
                           (tgraph.PosePriors, jgraph.PosePriors)):
            t, j = tcls.empty(cap, device=CPU), jcls.empty(cap)
            for name, a, b in zip(tcls._fields, t, j):
                b = np.asarray(b)
                assert a.dtype == convert._DTYPES[b.dtype], (name, a.dtype)
                np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_pad_factors_for_sharding_matches_reference(n):
    w, f = PROBLEM
    t = pad_factors_for_sharding(_port(w, f)[1], n)
    j = jdist.pad_factors_for_sharding(_jax(w, f)[1], n)
    for tb, jb in zip(t, j):
        assert tb[0].shape[0] % n == 0
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sharded_linearize_matches(ranks):
    n, res = ranks
    w, f = PROBLEM
    lin = _replicated(res, "lin")
    _assert_tree(lin, _jax_solution()[1], 3e-4, 3e-3, "vs JAX",
                 scale=1e-5)
    _assert_tree(lin, [x.numpy() for x in tgraph.linearize(*_port(w, f))],
                 1e-5, 1e-4, "vs port")
    lin_a = _replicated(res, "lin_analytic")
    _assert_tree(lin_a, [x.numpy() for x in tgraph.linearize(
        *_port(w, f), analytic_planes=True)], 1e-5, 1e-4, "analytic")


def test_distributed_gn_solve_matches_single_device(ranks):
    n, res = ranks
    out = _replicated(res, "gn")
    w_ref, _, stats = _jax_solution()
    for k in ("t", "planes"):
        assert np.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k], getattr(w_ref, k), atol=1e-3,
                                   err_msg=k)
    assert out["cost"].shape == (ITERS + 1,)


def test_map_block_gn_solve_matches_single_device(ranks):
    n, res = ranks
    out = _replicated(res, "map_block")
    w_ref, _, stats = _jax_solution()
    for k in ("t", "planes"):
        assert np.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k], getattr(w_ref, k), atol=2e-3,
                                   err_msg=k)
    np.testing.assert_allclose(out["cost"][:-1],
                               stats.cost_history[:ITERS],
                               rtol=1e-3)


def test_keyframe_sharded_matches_single_device(ranks):
    n, res = ranks
    w_ref, lin_ref, _ = _jax_solution()
    kf_lin = _replicated(res, "kf_lin")
    _assert_tree(kf_lin, lin_ref, 1e-5, 5e-3, "kf lin", scale=1e-5)
    w, f = PROBLEM
    _assert_tree(kf_lin, [x.numpy() for x in tgraph.linearize(
        *_port(w, f), analytic_poses=False)], 1e-5, 1e-4, "kf lin vs port")
    out = _replicated(res, "kf_solve")
    for k in ("t", "planes"):
        assert np.isfinite(out[k]).all()
        np.testing.assert_allclose(out[k], getattr(w_ref, k), atol=2e-3,
                                   err_msg=k)


def test_sharded_popup_matches_vmap_and_reference(ranks):
    n, res = ranks
    inp, ref_valid, ref_n_points = _popup_inputs()
    K = Intrinsics.create(*inp["K"], device=CPU)
    plain, _ = batched_pop_up(K, torch.as_tensor(inp["masks"]),
                              torch.as_tensor(inp["R"]),
                              torch.as_tensor(inp["t"]), tpp.PopupConfig(),
                              9)
    plain = [x.numpy() for x in plain]
    s = N_POPUP // n
    for r, out in enumerate(res):
        for name, a, b in zip(tpp.PopupPlanes._fields, out["popup"]["local"],
                              plain):
            np.testing.assert_allclose(a, b[r * s:(r + 1) * s], atol=1e-5,
                                       err_msg=f"rank {r} {name}")
    gathered = _replicated([{"all": out["popup"]["all"]} for out in res],
                           "all")
    for name, a, b in zip(tpp.PopupPlanes._fields, gathered, plain):
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(gathered.valid, ref_valid)
    np.testing.assert_array_equal(gathered.n_points, ref_n_points)


@pytest.mark.parametrize("n", WORLDS)
def test_partition_plane_factors_matches_reference(n):
    w, f = PROBLEM
    L = -(-w["planes"].shape[0] // n) * n
    t, cap_t = partition_plane_factors(_port(w, f)[1].planes, L, n)
    j, cap_j = jmb.partition_plane_factors(_jax(w, f)[1].planes, L, n)
    assert cap_t == cap_j
    for name, a, b in zip(tgraph.PlaneFactors._fields, t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)


@pytest.mark.parametrize("n", WORLDS)
def test_route_factors_by_keyframe_matches_reference(n):
    w, f = PROBLEM
    W = w["R"].shape[0]
    t = route_factors_by_keyframe(_port(w, f)[1], W, n)
    j = convert.routed_factors_from_numpy(jax.tree.map(
        np.asarray, jkb.route_factors_by_keyframe(_jax(w, f)[1], W, n)),
        CPU)
    for name, a, b in zip(jkb.RoutedFactors._fields, t, j):
        a = a if isinstance(a, tuple) else (a,)
        b = b if isinstance(b, tuple) else (b,)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype, name
            assert torch.equal(x, y), name
