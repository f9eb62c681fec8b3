"""Driver: whole sequences through the chunked runner.

Entry: ``pipeline.offline.run_sequence_chunked(state, masks, odom_R,
odom_t, K, pcfg, scfg, chunk, depth)`` from a fresh ``slam_init`` per
sequence, on the traffic's masks and odometry (already on the device).
A sequence is timed on the host clock around work that ends in
``torch.cuda.synchronize()``; its frames count when their poses have
come back.  The traffic's sequences are run in turn, round and round.
"""

from __future__ import annotations

import torch

from ..check import (INFO, carry_differs, cpu_outputs, frame_gaps,
                     intrinsics, merge, popup_config, program_frame, reference_frame,
                     slam_config, start_gap, tf32)
from ..harness import Check
from ..traffic import generate
from ..work import load_peaks
from ._hooks import FrameHooks, checked


def program_configs(config: dict):
    """The program's (SlamConfig, PopupConfig) from a configuration
    file."""
    from pop_up_slam_tpu_torch.assoc import AssocConfig
    from pop_up_slam_tpu_torch.factors.robust import (RobustConfig,
                                                      RobustKernel)
    from pop_up_slam_tpu_torch.pipeline import SlamConfig
    from pop_up_slam_tpu_torch.popup.popup import PopupConfig

    d = dict(config["slam"])
    d["assoc"] = AssocConfig(**d["assoc"])
    d["robust"] = RobustConfig(**{k: RobustKernel(**v)
                                  for k, v in d["robust"].items()})
    return SlamConfig(**d), PopupConfig(**config["popup"])


class Driver:
    def __init__(self, run):
        self.run = run
        self.hooks = FrameHooks(run, boundary_at_popup=True)
        self.next_seq = 0
        self.outputs = []       # per window sequence: (index, R, t)

    def setup(self) -> None:
        run, dev = self.run, self.run.device
        import pop_up_slam_tpu_torch  # noqa: F401  (f32 matmul settings)
        from pop_up_slam_tpu_torch.geometry.camera import Intrinsics
        from pop_up_slam_tpu_torch.ops import depth_render, fused_gn
        from pop_up_slam_tpu_torch.pipeline import (offline,
                                                    run_sequence_chunked,
                                                    slam_init)

        if dev.type == "cuda":
            from pop_up_slam_tpu_torch.ops import _build

            _build.library()
        run.mark("program")
        self.run_chunked = run_sequence_chunked
        self.slam_init = slam_init
        self.scfg, self.pcfg = program_configs(run.config)
        self.scfg = self.scfg._replace(**run.overrides.get("slam", {}))
        fx, fy, cx, cy = run.config["intrinsics"]
        self.K = Intrinsics.create(fx, fy, cx, cy, device=dev)
        self.inputs = generate.make(run.traffic, run.config, run.seed, dev,
                                    run.workdir)
        run.mark("inputs")
        self.n_seq = self.inputs["masks"].shape[0]
        run.extras["peaks"] = load_peaks()
        self.hooks.install(offline, fused_gn, depth_render)
        # warm-up: the first ``warm_frames`` frames of a sequence, whole
        # chunks of the cell's one chunk shape, through the same entry
        self._one(0, int(run.workload["warm_frames"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.mark("warm-up")
        self.hooks.counting = True

    def _one(self, s: int, frames: int | None = None):
        inp = self.inputs
        n = slice(None, frames)
        self.hooks.start_sequence(s)
        state = self.slam_init(self.scfg, inp["R0"][s], inp["t0"][s])
        state, outs = self.run_chunked(
            state, inp["masks"][s, n], inp["odom_R"][s, n],
            inp["odom_t"][s, n],
            self.K, self.pcfg, self.scfg, chunk=self.run.config["chunk"],
            depth=self.run.config["depth"])
        return outs

    def sequence(self) -> None:
        s = self.next_seq % self.n_seq
        self.next_seq += 1
        first = self.hooks.frame + 1
        outs = self._one(s)
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)
        n = outs[0].shape[0]
        self.run.frames += n
        self.outputs.append((s, first, outs[0], outs[1]))

    def complete(self) -> bool:
        """Whether the window holds what the metrics read."""
        return True

    def finish(self) -> None:
        """After the window: the wrappers off, the traced launches'
        work counted."""
        self.hooks.remove()
        if self.run.trace:
            self.hooks.work_counts(self.run)

    # ------------------------------------------------------------------
    def check(self, control: bool = False):
        """(compared numbers, reported numbers, the control's numbers or
        None)."""
        run = self.run
        hooks = self.hooks
        # every returned pose finite; each checked frame's returned pose
        # is the one its frame step produced
        stacked = {}
        for s, first, R, t in self.outputs:
            ok = torch.isfinite(R).all(dim=(1, 2)) & torch.isfinite(t).all(1)
            run.failed += int((~ok).sum())
            stacked[first] = (R, t)
        frames = checked(hooks.captured)
        cpu = torch.device("cpu")
        cfg = slam_config(run.config["slam"])
        pcfg = popup_config(run.config["popup"])
        K = intrinsics(run.config, cpu)
        depth_kw = {} if run.config["depth"] else None
        inp = self.inputs
        per_frame, out_differ = [], 0
        kept = {f: hooks.captured[f] for f in frames}
        first_state = hooks.captured.get(0, {}).get("state_in")
        s0 = hooks.captured.get(0, {}).get("seq")
        R0 = inp["R0"][s0].cpu() if s0 is not None else None
        t0 = inp["t0"][s0].cpu() if s0 is not None else None
        prog = {f: program_frame(fr, cpu) for f, fr in kept.items()}
        carry = sum(carry_differs(fr["prev_out"], fr["state_in"])
                    for fr in kept.values() if fr["prev_out"] is not None)
        for f, fr in kept.items():
            base = max(k for k in stacked if k <= f)
            R, t = stacked[base]
            out_differ += int(not (torch.equal(R[f - base].cpu(),
                                               prog[f]["R"])
                                   and torch.equal(t[f - base].cpu(),
                                                   prog[f]["t"])))
        masks = {f: inp["masks"][fr["seq"], fr["pos"]].cpu()
                 for f, fr in kept.items()}
        odom = {f: (inp["odom_R"][fr["seq"], fr["pos"]].cpu(),
                    inp["odom_t"][fr["seq"], fr["pos"]].cpu())
                for f, fr in kept.items()}
        states = {f: {"state_in": to_cpu(fr["state_in"]),
                      "pred_R": fr["pred_R"].cpu(),
                      "pred_t": fr["pred_t"].cpu()}
                  for f, fr in kept.items()}
        first_cpu = to_cpu(first_state) if first_state is not None else None
        # the program's state is freed before the reference runs
        self.release()
        per_control = []
        for f in frames:
            res_p = prog[f]["res"]
            r = reference_frame(states[f], masks[f], *odom[f], K, cfg, pcfg,
                                cpu, res_for_backend=res_p,
                                depth_kw=depth_kw)
            per_frame.append(frame_gaps(prog[f], r))
            if control:
                per_control.append(frame_gaps(self._control(
                    states[f], masks[f], odom[f], cfg, pcfg, depth_kw), r))
        got = merge(per_frame)
        got["outputs_differ"] = float(out_differ)
        got["carry_differ"] = float(carry)
        if first_cpu is not None:
            got["start_gap"] = start_gap(first_cpu, R0, t0, cfg, cpu)
        return split(got, run.workload["limits"]) + (
            merge(per_control) if control else None,)

    def _control(self, st, mask, odom, cfg, pcfg, depth_kw):
        """The reference in the program's place, in TF32 on the card."""
        dev = self.run.device
        with tf32():
            c = reference_frame(st, mask, *odom, intrinsics(self.run.config,
                                                            dev),
                                cfg, pcfg, dev, depth_kw=depth_kw)
        return cpu_outputs(c)

    def release(self) -> None:
        self.hooks.captured.clear()
        self.outputs.clear()
        self.inputs = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def split(got: dict, limits: dict):
    """(the compared numbers, each beside its limit; the reported ones)."""
    checks = [Check(k, got.get(k, float("inf")), float(v))
              for k, v in limits.items()]
    return checks, {k: got[k] for k in INFO if k in got}


def to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to_cpu(v) for v in x))
    return x
