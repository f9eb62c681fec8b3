"""Wrappers the drivers put around the program's module attributes.

The program's frame function (``pipeline/offline.py::make_frame_fn``)
looks up ``pp.pop_up``, ``pp.render_depth`` and ``slam_step`` at each
call, and the frame step looks up ``ops.fused_gn.fused_gn_solve`` and
``ops.depth_render.depth_render`` at each keyframe and render.  The
wrappers

- count frames (a frame starts at its pop-up);
- keep references to what the timed path produced on the frames drawn
  for the check (the pop-up's inputs and result, the state before and
  after the frame step, the step's inputs and pose, the depth map): the
  program's tensors are never written in place, so a reference keeps
  them as they were made.  The frames are a sample of the window's,
  drawn from the seed as the window runs (reservoir sampling), so at
  most ``check_frames`` frames are held whatever the window's length,
  and a frame that leaves the sample frees its tensors;
- with ``--trace 1``, put ``portbench:<name>`` profiler ranges around
  the calls and keep the inputs of each K1 and K2 launch of the traced
  frames, whose operations and bytes are counted after the window.

Nothing is copied or synchronized inside the window.
"""

from __future__ import annotations

import random

import torch

from ..trace import ranged


class FrameHooks:
    """Install with :meth:`install`, remove with :meth:`remove`."""

    def __init__(self, run, boundary_at_popup: bool):
        self.run = run
        self.boundary_at_popup = boundary_at_popup
        self.frame = -1            # window frame index (-1: warm-up)
        self.counting = False
        self.sample_size = int(run.workload["check_frames"])
        self.rng = random.Random(run.seed)
        self.seen = 0              # window frames offered to the sample
        self.slots: list = []      # the sampled window frames
        self.keep = False          # whether the running frame is kept
        self.captured: dict = {}   # window frame -> what was kept
        self.seq_index = -1
        self.seq_pos = -1
        self.last_out = None       # the previous frame step's state
        self.k1_inputs: list = []
        self.k2_inputs: list = []
        self._saved = []

    # ------------------------------------------------------------------
    def _patch(self, mod, name, fn):
        self._saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def remove(self) -> None:
        for mod, name, fn in reversed(self._saved):
            setattr(mod, name, fn)
        self._saved.clear()
        self.last_out = None

    def _admit(self) -> bool:
        """Whether the frame that starts now is kept for the check: the
        window's first frame always (the start), the others by reservoir
        sampling (algorithm R) from the seed, each frame of the window
        equally likely to end in the sample."""
        if not self.counting:
            return False
        if self.frame == 0:
            return True
        i = self.seen
        self.seen += 1
        if i < self.sample_size:
            self.slots.append(self.frame)
            return True
        j = self.rng.randrange(i + 1)
        if j >= self.sample_size:
            return False
        self.captured.pop(self.slots[j], None)
        self.slots[j] = self.frame
        return True

    def capturing(self) -> bool:
        return self.keep

    def start_sequence(self, index: int) -> None:
        self.seq_index = index
        self.seq_pos = -1

    # ------------------------------------------------------------------
    def install(self, offline, fused_gn_mod, depth_render_mod) -> None:
        pp = offline.pp
        trace = self.run.trace
        tracer = self.run.tracer
        hooks = self

        pop_up = pp.pop_up
        if trace:
            pop_up = ranged("pop_up", pop_up)

        def pop_up_hook(K, mask, R, t, cfg):
            if hooks.counting:
                hooks.frame += 1
                if hooks.boundary_at_popup:
                    tracer.boundary()
            hooks.seq_pos += 1
            hooks.keep = hooks._admit()
            res = pop_up(K, mask, R, t, cfg)
            if hooks.capturing():
                hooks.captured[hooks.frame] = {
                    "seq": hooks.seq_index, "pos": hooks.seq_pos,
                    "mask": mask, "pred_R": R, "pred_t": t, "res": res}
            return res

        slam_step = offline.slam_step
        if trace:
            slam_step = ranged("slam_step", slam_step)

        def slam_step_hook(state, det, odom_R, odom_t, cfg, **kw):
            out = slam_step(state, det, odom_R, odom_t, cfg, **kw)
            if hooks.capturing():
                hooks.captured[hooks.frame].update(
                    state_in=state, odom_R=odom_R, odom_t=odom_t,
                    state_out=out[0], R=out[1][0], t=out[1][1],
                    prev_out=hooks.last_out if hooks.seq_pos > 0 else None)
            hooks.last_out = out[0]
            return out

        render_depth = pp.render_depth
        if trace:
            render_depth = ranged("render_depth", render_depth)

        def render_depth_hook(*args, **kw):
            d = render_depth(*args, **kw)
            if hooks.capturing():
                hooks.captured[hooks.frame]["depth"] = d
            return d

        self._patch(pp, "pop_up", pop_up_hook)
        self._patch(offline, "slam_step", slam_step_hook)
        self._patch(pp, "render_depth", render_depth_hook)
        if trace:
            self._patch(offline, "detections_from_popup",
                        ranged("detections", offline.detections_from_popup))
            k1 = fused_gn_mod.fused_gn_solve
            k2 = depth_render_mod.depth_render

            def k1_hook(window, factors, iters=2, damping=1e-5, robust=None,
                        **kw):
                if tracer.active:
                    hooks.k1_inputs.append((window, factors, iters, robust))
                return k1(window, factors, iters=iters, damping=damping,
                          robust=robust, **kw)

            def k2_hook(K, res, mask, R, t, **kw):
                if tracer.active:
                    hooks.k2_inputs.append((tuple(mask.shape),
                                            res.valid, res.planes_w.shape[0]))
                return k2(K, res, mask, R, t, **kw)

            # the wrappers carry the launch counters the originals bump
            k1_hook.launches = k2_hook.launches = 0
            self._patch(fused_gn_mod, "fused_gn_solve", k1_hook)
            self._patch(depth_render_mod, "depth_render", k2_hook)

    # ------------------------------------------------------------------
    def work_counts(self, run) -> None:
        """After the window: K1's and K2's operations and bytes over the
        traced launches, into ``run.extras``."""
        from ..work.k1 import k1_bytes, k1_ops
        from ..work.k2 import k2_bytes, k2_ops

        ops = nbytes = 0.0
        bound_s = 0.0
        peaks = run.extras["peaks"]
        for window, factors, iters, robust in self.k1_inputs:
            o = k1_ops(window, factors, iters, robust)
            b = k1_bytes(window, factors, iters)
            ops += o
            nbytes += b
            bound_s += max(o / peaks["f32_flops_per_s"],
                           b / peaks["hbm_bytes_per_s"])
        run.extras["k1"] = {"launches": len(self.k1_inputs), "ops": ops,
                            "bytes": nbytes, "bound_s": bound_s}
        ops = nbytes = bound_s = 0.0
        for (H, W), valid, S in self.k2_inputs:
            o = k2_ops(H, W, int(valid.sum()))
            b = k2_bytes(H, W, S)
            ops += o
            nbytes += b
            bound_s += max(o / peaks["f32_flops_per_s"],
                           b / peaks["hbm_bytes_per_s"])
        run.extras["k2"] = {"launches": len(self.k2_inputs), "ops": ops,
                            "bytes": nbytes, "bound_s": bound_s}
        self.k1_inputs.clear()
        self.k2_inputs.clear()


def checked(captured: dict) -> list:
    """The sampled frames whose frame step ran, in window order."""
    return sorted(k for k, v in captured.items() if "state_out" in v)
