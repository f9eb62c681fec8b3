"""The benchmark's Levenberg-Marquardt cell, ``corridor_w8_lm.replay``, on
the CPU, and the port's LM solve against the benchmark's plain LM
reference (``portbench/reference/solver/lm.py``).

The harness refuses to report where JAX is loaded, and this suite's
conftest loads it, so the cell's runs are made in one child process
without JAX (this file run as a script): a sound run and a traced one at
``portbench/tests/_portbench_cpu.py``'s size (14-frame sequences, two of
them) with ``pallas="on"`` (the Schur kernels' plain route, the one the
card takes), and one run for each planted fault.  On the CPU the port
takes its kernels' plain versions, of which the reference is a frozen
copy, so a sound run reads every gap as exactly 0.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "corridor_w8_lm.replay"
SEED = 2147483907


# ----------------------------------------------------------------------
# the child process: the cell's runs
# ----------------------------------------------------------------------

def _faulty_lm(accept_all: bool = False, fixed_lambda: bool = False):
    """The port's ``lm_solve`` with one of its decisions broken: every
    step accepted, or lambda never changed."""
    from pop_up_slam_tpu_torch.factors.graph import linearize, total_cost
    from pop_up_slam_tpu_torch.solver import gauss_newton as gn

    def lm(window, factors, iters=8, lam0=1e-4, lam_up=10.0, lam_down=0.3,
           solve_fn=None, analytic_planes=False, robust=None):
        dev = window.t.device
        lam = torch.full((), lam0, dtype=torch.float32, device=dev)
        cost = total_cost(window, factors, robust=robust)
        costs, norms, lambdas, accepted = [], [], [], []
        for _ in range(iters):
            lin = linearize(window, factors, analytic_planes=analytic_planes,
                            robust=robust)
            sol = solve_fn(lin, window, lam)
            w_try = gn.apply_update(window, sol.dxp, sol.dxl)
            cost_try = total_cost(w_try, factors, robust=robust)
            accept = (torch.ones((), dtype=torch.bool, device=dev)
                      if accept_all else cost_try < cost)
            costs.append(cost)
            norms.append(torch.sqrt(torch.sum(sol.dxp ** 2)
                                    + torch.sum(sol.dxl ** 2)))
            lambdas.append(lam)
            accepted.append(accept)
            window = gn.select_window(accept, w_try, window)
            if not fixed_lambda:
                lam = torch.clamp(torch.where(accept, lam * lam_down,
                                              lam * lam_up), 1e-9, 1e6)
            cost = torch.where(accept, cost_try, cost)
        return window, gn.stack_stats(costs + [cost], norms, lambdas,
                                      accepted, dev)

    return lm


def _returns_input():
    """An LM that returns the window it was given."""
    from pop_up_slam_tpu_torch.pipeline import slam

    orig = slam.lm_solve

    def lm(window, factors, **kw):
        return window, orig(window, factors, **kw)[1]

    return [(slam, "lm_solve", lm)]


def _accepts_every_step():
    from pop_up_slam_tpu_torch.pipeline import slam

    return [(slam, "lm_solve", _faulty_lm(accept_all=True))]


def _lambda_fixed():
    from pop_up_slam_tpu_torch.pipeline import slam

    return [(slam, "lm_solve", _faulty_lm(fixed_lambda=True))]


def _k3a_undamped():
    """K3a's operands with lambda dropped (the kernel's and its plain
    version's; the CPU takes the plain one)."""
    from pop_up_slam_tpu_torch.ops import schur

    def undamped(fn):
        def small(Hpp, B, G, rhs, pm, lam, *args, **kw):
            return fn(Hpp, B, G, rhs, pm, lam * 0.0, *args, **kw)
        if hasattr(fn, "launches"):
            # the kernel's body bumps the counter of what it is named by
            small.launches = fn.launches
        return small

    return [(schur, name, undamped(getattr(schur, name)))
            for name in ("schur_reduce_small", "schur_reduce_small_plain")]


# Each fault with the change of traffic or configuration (program and
# reference alike) under which it changes the result:
# - at the cell's traffic LM rejects only second-iteration steps whose
#   trial cost lies within ~1e-5 of the cost (float32's rounding of the
#   sum), so an LM that accepts them moves the window by a rounding step;
#   with odometry noise of 0.5 m / 0.2 rad first steps overshoot (in the
#   walk of sway 0.1 one raises the cost 27-fold) and are rejected, and
#   every frame is checked, that one too;
# - at the cell's lambda (1e-5, against a diagonal of S of 1e3-1e6),
#   S + lambda I rounds to S: dropping it changes no bit; at lambda 1e3
#   it moves the step.
FAULTS = {
    "returns_input": (_returns_input, {}),
    "accepts_every_step": (_accepts_every_step,
                           {"traffic": {"odom_sigma_t": 0.5,
                                        "odom_sigma_r": 0.2,
                                        "sways": [0.1]},
                            "workload": {"check_frames": 14}}),
    "lambda_fixed": (_lambda_fixed, {}),
    "k3a_undamped": (_k3a_undamped, {"slam": {"damping": 1000.0}}),
}
# the fault runs and the traced one: one 14-frame sequence, a short
# warm-up (the CPU compiles nothing), two frames checked (the faults but
# one change every keyframe)
SHORT = {"traffic": {"sequences": 1, "sways": [0.3]},
         "workload": {"warm_frames": 2, "check_frames": 2}}


def _run(trace: int = 0, fault=None, extra=()) -> dict:
    sys.path.insert(0, os.path.join(REPO, "portbench", "tests"))
    from _portbench_cpu import overrides

    from portbench import harness

    ov = overrides(CELL)
    ov["slam"] = {"pallas": "on"}
    for more in extra:
        for k, v in more.items():
            ov.setdefault(k, {}).update(v)
    patches = []

    def plant(run):
        for mod, name, fn in fault():
            patches.append((mod, name, getattr(mod, name)))
            setattr(mod, name, fn)

    try:
        code, res = harness.execute(
            ["--workload", CELL, "--seed", str(SEED), "--seconds", "0.1",
             "--trace", str(trace)], time.perf_counter(), device="cpu",
            overrides=ov, fault=plant if fault else None)
    finally:
        for mod, name, fn in reversed(patches):
            setattr(mod, name, fn)
    if res is None:
        return {"code": code}
    return {"code": code, "correct": res["correct"],
            "attempted": res["attempted"], "failed": res["failed"],
            "checks": res["checks"], "info": res["info"],
            "metrics": {k: v["value"] for k, v in res["metrics"].items()},
            "window_s": res["device"].get("window_s"),
            "forbidden": harness.forbidden_modules()}


def _child() -> None:
    sys.path.insert(0, REPO)
    import portbench

    portbench.cache_env()
    out = {"sound": _run(), "traced": _run(trace=1, extra=(SHORT,))}
    for name, (fault, extra) in FAULTS.items():
        out[name] = _run(fault=fault, extra=(SHORT, extra))
    top = sorted({m.split(".")[0] for m in sys.modules})
    print(json.dumps({"runs": out, "top": top}))


# ----------------------------------------------------------------------
# the tests
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    # four threads run the child as fast as eight do, with a third less
    # CPU time taken from the suite's other workers
    env["OMP_NUM_THREADS"] = "4"
    out = subprocess.run([sys.executable, os.path.abspath(__file__)],
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_cell_is_correct_and_reads_every_gap_as_zero(runs):
    r = runs["runs"]["sound"]
    assert r["code"] == 0
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    for name, c in r["checks"].items():
        assert c["value"] == 0.0, (name, c)
    assert "lm_decisions_differ" in r["checks"]
    assert "depth_pixels_off" not in r["checks"]
    # the device time comes from the device trace, which a CPU run lacks
    assert set(r["metrics"]) == {"setup_s"} and r["metrics"]["setup_s"] > 0
    # no kernel launches on the CPU; K1 and K2 are off this path anyway
    for k in ("k1", "k2", "k3a", "k5"):
        assert r["info"][f"{k}_launches_per_frame"] == 0.0


def test_traced_run_reads_the_lm_span_and_no_device_metric(runs):
    r = runs["runs"]["traced"]
    assert r["code"] == 0 and r["correct"], r.get("checks")
    m = r["metrics"]
    assert m["lm_solve_host_ms_per_frame"] > 0
    for name in ("k3a_roofline", "k5_roofline", "launches_per_frame.replay",
                 "k1_roofline.replay", "k2_roofline"):
        assert name not in m
    assert m["frames_per_s.replay"] > 0 and r["window_s"] > 0


def test_a_run_of_the_cell_loads_no_jax(runs):
    assert runs["runs"]["sound"]["forbidden"] == []
    for name in ("jax", "jaxlib", "flax", "pop_up_slam_tpu"):
        assert name not in runs["top"]
    assert "pop_up_slam_tpu_torch" in runs["top"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_planted_fault_is_not_correct(runs, fault):
    r = runs["runs"][fault]
    assert r["code"] == 0
    assert not r["correct"], r["checks"]


def _tuples(graph, window: dict, factors: dict):
    def t(d):
        return {k: torch.as_tensor(v) for k, v in d.items()}

    return graph.Window(**t(window)), graph.Factors(
        odom=graph.OdomFactors(**t(factors["odom"])),
        planes=graph.PlaneFactors(**t(factors["planes"])),
        priors=graph.PosePriors(**t(factors["priors"])))


@pytest.mark.parametrize("route", ["solve_schur", "schur_reduce_plain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lm_solve_matches_the_benchmark_reference(seed, route):
    """Six iterations from lambda 1e-5 on a seeded corridor window (W=4,
    L=16, slot 0 under a prior): seeds 0 and 1 reject their last two
    steps, seed 2 accepts all six."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from _torch_parity import ba_problem

    from pop_up_slam_tpu_torch.factors import graph as tgraph
    from pop_up_slam_tpu_torch.ops import schur as tops
    from pop_up_slam_tpu_torch.solver import gauss_newton as tgn
    from pop_up_slam_tpu_torch.solver import schur as tschur
    from portbench.reference.factors import graph as rgraph
    from portbench.reference.ops import schur as rops
    from portbench.reference.solver import lm as rlm
    from portbench.reference.solver import schur as rschur

    window, factors = ba_problem(seed, W=4, L=16, prior_gauge=True)
    fns = {"solve_schur": (tschur.solve_schur, rschur.solve_schur),
           "schur_reduce_plain": (tops.schur_reduce_plain,
                                  rops.schur_reduce_plain)}[route]
    kw = dict(iters=6, lam0=1e-5, analytic_planes=True)
    w_p, st_p = tgn.lm_solve(*_tuples(tgraph, window, factors),
                             solve_fn=fns[0], **kw)
    w_r, st_r = rlm.lm_solve(*_tuples(rgraph, window, factors),
                             solve_fn=fns[1], **kw)
    # the decisions exactly: both sides compute the same float32
    # operations on the CPU, so the costs they compare are the same
    assert torch.equal(st_p.accepted, st_r.accepted)
    assert torch.equal(st_p.lambdas, st_r.lambdas)
    # the window within 1e-6 relative: ~8 float32 ulps, room for the two
    # copies' kernels to sum in another order, far below a step (>1e-4)
    for name, a, b in zip(w_p._fields, w_p, w_r):
        if a.dtype.is_floating_point:
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7,
                                       msg=name)
        else:
            assert torch.equal(a, b), name


if __name__ == "__main__":
    _child()
