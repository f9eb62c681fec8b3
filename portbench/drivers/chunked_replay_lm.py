"""Driver: whole sequences through the chunked runner, with the
Levenberg-Marquardt back end.

The program's path is ``chunked_replay``'s (``run_sequence_chunked``
from a fresh ``slam_init`` per sequence); the configuration's
``solver="lm"`` sends each keyframe's windowed solve through
``pipeline.slam.lm_solve``: per-op linearization with the plane-Jacobian
kernel K5, the Schur kernel K3a as the reduced solve at W=8, the
accept/reject test and the damping.

The check is ``chunked_replay``'s with one change, the reference's frame
step: ``reference/pipeline/slam.py::slam_step`` with the LM reference
(``reference/solver/lm.py``) as its ``solve_impl``.  It adds one
number on the solve's own decisions, ``lm_decisions_differ``: the
checked frames whose solve used another lambda than the reference's
before the two first disagreed on accepting a step.  Such a
disagreement is a rounding tie on a sound run: a keyframe's second step
changes a cost of ~100 float32 terms by its rounding, and goes either
way.  Each one is printed with both sides' costs, and the widest, as
the cost's change over max(cost, 1) on the side that accepted
(``lm_flip_margin``), and their count (``lm_accept_flips``) are
reported, not held; a wrong decision on a step that matters moves the
window, which ``pose_gap`` and ``map_gap`` hold.

Hooks besides the frame hooks (``_hooks.py``), on the module attributes
the port looks up at call time (``slam.py``'s module global
``lm_solve``, ``ops.schur``'s ``schur_reduce_small`` from ``_reduce``,
``ops.plane_jacobians``' ``plane_terms`` from ``linearize``):

- ``lm_solve``: its statistics (accept flags, lambdas, costs) kept on
  the checked frames;
- with ``--trace 1``, ``portbench:`` ranges around the three and the
  inputs of the traced K3a and K5 launches, whose operations and bytes
  are counted after the window.

The kernels' ``.launches`` counters are read at the window's two ends
and reported a window frame (K1 and K2 run on this path never).
"""

from __future__ import annotations

import contextlib
import sys

import torch

from ..reference.pipeline import slam as rslam
from ..reference.solver import lm as rlm
from ..trace import ranged
from . import chunked_replay
from ._hooks import FrameHooks, checked


class LMHooks(FrameHooks):
    """The frame hooks plus the LM solve's and its kernels' wrappers."""

    def __init__(self, run, boundary_at_popup: bool):
        super().__init__(run, boundary_at_popup)
        self.k3a_inputs: list = []
        self.k5_inputs: list = []

    def install(self, offline, fused_gn_mod, depth_render_mod) -> None:
        super().install(offline, fused_gn_mod, depth_render_mod)
        from pop_up_slam_tpu_torch.ops import plane_jacobians, schur
        from pop_up_slam_tpu_torch.pipeline import slam

        trace = self.run.trace
        tracer = self.run.tracer
        hooks = self

        lm_solve = slam.lm_solve
        if trace:
            lm_solve = ranged("lm_solve", lm_solve)

        def lm_hook(*args, **kw):
            out = lm_solve(*args, **kw)
            if hooks.capturing():
                hooks.captured[hooks.frame]["lm_stats"] = out[1]
            return out

        self._patch(slam, "lm_solve", lm_hook)
        if not trace:
            return
        k3a = ranged("schur_reduce_small", schur.schur_reduce_small)
        k5 = ranged("plane_terms", plane_jacobians.plane_terms)

        def k3a_hook(Hpp, B, G, rhs, pm, lam, stamps=None):
            if tracer.active and B.device.type == "cuda":
                hooks.k3a_inputs.append((G, pm))
            return k3a(Hpp, B, G, rhs, pm, lam, stamps=stamps)

        def k5_hook(window, factors, stamps=None):
            if tracer.active and window.t.device.type == "cuda":
                F = factors.valid.shape[0]
                one = factors.sqrt_info.stride() == (0, 3, 1) and F > 0
                hooks.k5_inputs.append(
                    (window.window_size, window.max_landmarks, factors.valid,
                     factors.pose_idx, factors.lm_idx, one))
            return k5(window, factors, stamps=stamps)

        # the wrappers carry the launch counters the originals bump
        k3a_hook.launches = schur.schur_reduce_small.launches
        k5_hook.launches = plane_jacobians.plane_terms.launches
        self._patch(schur, "schur_reduce_small", k3a_hook)
        self._patch(plane_jacobians, "plane_terms", k5_hook)

    def work_counts(self, run) -> None:
        """After the window: K1's and K2's counts (none run here) and
        K3a's and K5's operations and bytes over the traced launches,
        into ``run.extras``."""
        from ..work.k3a import k3a_bytes, k3a_ops
        from ..work.k5 import k5_bytes, k5_ops

        super().work_counts(run)
        peaks = run.extras["peaks"]

        def total(works):
            ops = sum(o for o, _ in works)
            nbytes = sum(b for _, b in works)
            bound_s = sum(max(o / peaks["f32_flops_per_s"],
                              b / peaks["hbm_bytes_per_s"])
                          for o, b in works)
            return {"launches": len(works), "ops": ops, "bytes": nbytes,
                    "bound_s": bound_s}

        run.extras["k3a"] = total([(k3a_ops(G, pm), k3a_bytes(*G.shape))
                                   for G, pm in self.k3a_inputs])
        run.extras["k5"] = total([(k5_ops(W, L, v, p, lm),
                                   k5_bytes(W, L, v.shape[0], one))
                                  for W, L, v, p, lm, one in self.k5_inputs])
        self.k3a_inputs.clear()
        self.k5_inputs.clear()


def _launches() -> dict:
    """The kernels' launch counters (K1 and K2 never launch here)."""
    from pop_up_slam_tpu_torch.ops import (depth_render, fused_gn,
                                           plane_jacobians, schur)

    return {"k1": fused_gn.fused_gn_solve.launches,
            "k2": depth_render.depth_render.launches,
            "k3a": schur.schur_reduce_small.launches,
            "k5": plane_jacobians.plane_terms.launches}


def lm_step(program_device: str, overrides: dict, record: list):
    """The reference's ``slam_step`` with the LM reference as its windowed
    solve, routed as on the program's device, under the program's slam
    overrides; each call appends its keyframe solves' SolveStats (on the
    CPU) to ``record``."""
    step = rslam.slam_step

    def slam_step(state, det, odom_R, odom_t, cfg, solve_impl=None):
        cfg = cfg._replace(**overrides)
        solves = []
        # the reference's frame step holds the GN route alone by name;
        # with a solve_impl it runs no route of its own
        out = step(state, det, odom_R, odom_t, cfg._replace(solver="gn"),
                   solve_impl=rlm.solve_impl(cfg, program_device,
                                             record=solves))
        record.append([type(s)(*(x.cpu() for x in s)) for s in solves])
        return out

    return slam_step


def decisions(p, r: list):
    """(differs, flip) of one frame: the program's solve statistics ``p``
    (None where the frame was no keyframe) against the reference's (a
    list of at most one).  Iteration by iteration the lambdas must be
    equal, up to the first accept decision the two sides took
    differently: ``flip`` is (iteration, margin) there, the margin being
    the cost's change over max(cost, 1) on the side that accepted (the
    costs are whitened, in units of the sigmas); the iterations after it
    are not compared."""
    if (p is None) != (not r):
        return True, None
    if p is None:
        return False, None
    r = r[0]
    pa, ra = p.accepted.cpu(), r.accepted
    pl, rl = p.lambdas.cpu(), r.lambdas
    if pa.shape != ra.shape:
        return True, None
    for k in range(pa.shape[0]):
        if not torch.equal(pl[k], rl[k]):
            return True, None
        if bool(pa[k]) != bool(ra[k]):
            c = (p if bool(pa[k]) else r).cost_history.cpu().double()
            return False, (k, abs(float((c[k] - c[k + 1])
                                        / c[k].abs().clamp(min=1))))
    return False, None


def lm_numbers(prog: list, ref: list, where=None) -> dict:
    """Over the checked frames: ``lm_decisions_differ`` (frames),
    ``lm_flip_margin`` (the widest flip's margin, 0 with none) and
    ``lm_accept_flips`` (frames).  Each flip is printed on standard
    error with ``where`` (the frames' names) and both sides' statistics."""
    diff = abs(len(prog) - len(ref))
    flips, widest = 0, 0.0
    for i, (p, r) in enumerate(zip(prog, ref)):
        d, flip = decisions(p, r)
        diff += d
        if flip is not None:
            flips += 1
            widest = max(widest, flip[1])
            print(f"lm flip: {where[i] if where else i}, iteration "
                  f"{flip[0]}, margin {flip[1]!r}; program "
                  f"{_stats(p)}; reference {_stats(r[0])}", file=sys.stderr)
    return {"lm_decisions_differ": float(diff), "lm_flip_margin": widest,
            "lm_accept_flips": float(flips)}


def _stats(s) -> str:
    return (f"accepted {s.accepted.tolist()} costs "
            f"{s.cost_history.tolist()} lambdas {s.lambdas.tolist()}")


class Driver(chunked_replay.Driver):
    def __init__(self, run):
        super().__init__(run)
        self.hooks = LMHooks(run, boundary_at_popup=True)
        self.launches: dict = {}

    def setup(self) -> None:
        super().setup()
        self.launches = _launches()

    def finish(self) -> None:
        self.launches = {k: v - self.launches[k]
                         for k, v in _launches().items()}
        super().finish()

    def check(self, control: bool = False):
        captured = self.hooks.captured
        frames = checked(captured)
        prog = [captured[f].get("lm_stats") for f in frames]
        where = [f"window frame {f} (sequence {captured[f]['seq']}, frame "
                 f"{captured[f]['pos']})" for f in frames]
        calls = []
        step = lm_step(self.run.device.type,
                       self.run.overrides.get("slam", {}), calls)
        with _patched(rslam, "slam_step", step):
            checks, info, ctl_got = super().check(control)
        # one frame step a reference_frame call; with the control, each
        # checked frame's reference is followed by its control
        ref, ctl = (calls[0::2], calls[1::2]) if control else (calls, [])
        got = lm_numbers(prog, ref, where)
        checks = [c if c.name not in got else
                  type(c)(c.name, got[c.name], c.limit) for c in checks]
        info["lm_accept_flips"] = got["lm_accept_flips"]
        info["lm_flip_margin"] = got["lm_flip_margin"]
        n = max(self.run.frames, 1)
        for k, v in self.launches.items():
            info[f"{k}_launches_per_frame"] = v / n
        if ctl_got is not None:
            ctl_got.update(lm_numbers([s[0] if s else None for s in ctl],
                                      ref, [f"control, {w}" for w in where]))
        return checks, info, ctl_got


@contextlib.contextmanager
def _patched(mod, name, value):
    saved = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, saved)
