"""Driver: whole TUM sequences through the TUM runner.

Entry: ``runners.tum_runner.run_tum_sequence(cfg, odometry, ..., smooth,
device, out)`` over the tree the traffic wrote in set-up, replayed whole
and back to back; each replay draws its own ``gt_perturb`` noise
(``cfg.seed``).  The runner works one frame at a time (PNG decode,
pop-up, frame step, the pose to the host) and smooths the keyframe
trajectory once a sequence.

Each frame's latency is read on the benchmark's own clock at the
runner's per-frame log call, which comes after the frame's pose has
reached the host: a frame's time runs from the previous frame's stamp,
the first frame's from the call's start.
"""

from __future__ import annotations

import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..check import (carry_differs, cpu_outputs, frame_gaps, intrinsics,
                     merge, popup_config, program_frame, reference_frame,
                     slam_config, start_gap, tf32, to_ref)
from ..reference import tum_odometry
from ..reference.pipeline import smoothing as rsmooth
from ..traffic import generate
from ..trace import ranged
from ..work import load_peaks
from ._hooks import FrameHooks, checked
from .chunked_replay import program_configs, split, to_cpu

class Driver:
    def __init__(self, run):
        self.run = run
        self.hooks = FrameHooks(run, boundary_at_popup=False)
        self.replay = 0
        self.stamps: list = []
        self.sequences: dict = {}   # replay -> the runner's internals

    def replay_seed(self, r: int) -> int:
        return generate.seed_of(self.run.seed, 7, r)

    def setup(self) -> None:
        run, dev = self.run, self.run.device
        import pop_up_slam_tpu_torch  # noqa: F401  (f32 matmul settings)
        from pop_up_slam_tpu_torch.config import get_config
        from pop_up_slam_tpu_torch.io import tum
        from pop_up_slam_tpu_torch.ops import depth_render, fused_gn
        from pop_up_slam_tpu_torch.pipeline import offline
        from pop_up_slam_tpu_torch.runners import tum_runner

        if dev.type == "cuda":
            from pop_up_slam_tpu_torch.ops import _build

            _build.library()
        run.mark("program")
        self.tum_runner = tum_runner
        scfg, pcfg = program_configs(run.config)
        scfg = scfg._replace(**run.overrides.get("slam", {}))
        fx, fy, cx, cy = run.config["intrinsics"]
        self.inputs = generate.make(run.traffic, run.config, run.seed, dev,
                                    run.workdir)
        run.mark("inputs")
        self.cfg = get_config("tum_fr3")._replace(
            fx=fx, fy=fy, cx=cx, cy=cy, height=run.config["height"],
            width=run.config["width"], slam=scfg, popup=pcfg,
            sequence_dir=self.inputs["root"], metrics_path="",
            out_trajectory="", checkpoint_path="", resume="")
        run.extras["peaks"] = load_peaks()
        run.extras["stages"] = []
        self.hooks.install(offline, fused_gn, depth_render)
        hooks, stamps, tracer = self.hooks, self.stamps, run.tracer

        class TimedLogger(tum_runner.MetricsLogger):
            """The runner's per-frame log: the benchmark's own clock is
            read when a frame's pose has reached the host."""

            def log(self, **kv):
                if hooks.counting:
                    stamps.append(time.perf_counter())
                    tracer.boundary()
                super().log(**kv)

        self.hooks._patch(tum_runner, "MetricsLogger", TimedLogger)
        if run.trace:
            self.hooks._patch(tum, "load_image",
                              ranged("decode", tum.load_image))
            self.hooks._patch(tum_runner, "smooth_trajectory",
                              ranged("smooth", tum_runner.smooth_trajectory))
        # warm-up: the tree's first ``warm_frames`` frames, enough
        # keyframes to fill the window and marginalize, and the smoother,
        # through the same entry
        self._call(-1, int(run.workload["warm_frames"]))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        run.mark("warm-up")
        self.hooks.counting = True

    def _call(self, r: int, max_frames: int = 0):
        out = {}
        self.hooks.start_sequence(r)
        cfg = self.cfg._replace(seed=self.replay_seed(r))
        summary = self.tum_runner.run_tum_sequence(
            cfg, odometry=self.run.config["odometry"],
            odom_sigma_t=self.run.config["odom_sigma_t"],
            odom_sigma_r=self.run.config["odom_sigma_r"],
            max_frames=max_frames, smooth=self.run.config["smooth"],
            device=self.run.device, out=out)
        return out, summary

    def sequence(self) -> None:
        r = self.replay
        self.replay += 1
        first = self.hooks.frame + 1
        n0 = len(self.stamps)
        t_call = time.perf_counter()
        out, summary = self._call(r)
        stamps = [t_call] + self.stamps[n0:]
        n = len(stamps) - 1
        self.run.frames += n
        self.run.frame_ms += [1e3 * (b - a) for a, b in
                              zip(stamps[:-1], stamps[1:])]
        est_t = np.asarray(out["est_t"][1:])
        est_R = np.asarray(out["est_R"][1:])
        ok = np.isfinite(est_t).all(1) & np.isfinite(est_R).all((1, 2))
        self.run.failed += int((~ok).sum())
        # the stage timers of sequences the profiler did not touch
        tr = self.run.tracer
        if not (self.run.trace and first <= tr.start_at + tr.frames
                and first + n > tr.start_at):
            self.run.extras["stages"].append(summary["stage_timing"])
        print("stages: " + ", ".join(
            f"{k} {v['mean_ms']} ms x{v['count']}"
            for k, v in summary["stage_timing"].items()), file=sys.stderr)
        # every sequence's smoother is checked; the filtering poses only
        # of the sequences that hold sampled frames
        out.pop("marginals", None)
        self.sequences[r] = out
        live = {fr["seq"] for fr in self.hooks.captured.values()}
        for k, o in self.sequences.items():
            if k not in live:
                o.pop("est_R", None)
                o.pop("est_t", None)

    def complete(self) -> bool:
        """Whether the window holds what the metrics read: with
        ``--trace 1``, a sequence the profiler did not touch (the stage
        timers)."""
        return not self.run.trace or bool(self.run.extras["stages"])

    def finish(self) -> None:
        """After the window: the wrappers off, the traced launches'
        work counted."""
        self.hooks.remove()
        if self.run.trace:
            self.hooks.work_counts(self.run)

    # ------------------------------------------------------------------
    def check(self, control: bool = False):
        """(compared numbers, reported numbers, the control's numbers or
        None).  Every sequence's smoothed keyframes are held against the
        reference smoother's on the same recorder and final state
        (``smooth_gap``), which runs on the run's device; beside it,
        ``smooth_unmoved`` is how far the smoother's input lies from the
        reference's result: what a smoother that returned its input
        would read."""
        run, hooks = self.run, self.hooks
        frames = checked(hooks.captured)
        cpu = torch.device("cpu")
        cfg = slam_config(run.config["slam"])
        pcfg = popup_config(run.config["popup"])
        K = intrinsics(run.config, cpu)
        kept = {f: hooks.captured[f] for f in frames}
        prog = {f: program_frame(fr, cpu) for f, fr in kept.items()}
        carry = sum(carry_differs(fr["prev_out"], fr["state_in"])
                    for fr in kept.values() if fr["prev_out"] is not None)
        states = {f: {"state_in": to_cpu(fr["state_in"]),
                      "pred_R": fr["pred_R"].cpu(),
                      "pred_t": fr["pred_t"].cpu(),
                      "mask": fr["mask"].cpu(),
                      "odom": (fr["odom_R"].cpu(), fr["odom_t"].cpu()),
                      "seq": fr["seq"], "pos": fr["pos"]}
                  for f, fr in kept.items()}
        first = hooks.captured.get(0, {}).get("state_in")
        first = to_cpu(first) if first is not None else None
        # each checked frame's returned pose is its frame step's; every
        # sequence's smoothed keyframes, for the sequences checked
        seqs = self.sequences
        out_differ = 0
        for f, st in states.items():
            out = seqs[st["seq"]]
            k = st["pos"] + 1
            out_differ += int(not (
                np.array_equal(out["est_R"][k], prog[f]["R"].numpy())
                and np.array_equal(out["est_t"][k], prog[f]["t"].numpy())))
        smooth_in = [_smoother_inputs(seqs[r]) for r in sorted(seqs)]
        self.release()

        gt = tum_odometry.load_ground_truth(self.tree_root)
        per_frame, per_control, mask_px, odom_gap = [], [], 0, 0.0
        for f in frames:
            st = states[f]
            ref_mask = torch.as_tensor(self.masks[st["pos"] + 1])
            mask_px += int((st["mask"] != ref_mask).sum())
            oR, ot = tum_odometry.odometry_at(
                gt, self.replay_seed(st["seq"]), st["pos"] + 1,
                run.config["odom_sigma_t"], run.config["odom_sigma_r"])
            odom_gap = max(odom_gap,
                           float((st["odom"][0] - oR).abs().max()),
                           float((st["odom"][1] - ot).abs().max()))
            r = reference_frame(st, ref_mask, oR, ot, K, cfg, pcfg, cpu,
                                res_for_backend=prog[f]["res"])
            per_frame.append(frame_gaps(prog[f], r))
            if control:
                dev = run.device
                with tf32():
                    c = reference_frame(st, ref_mask, oR, ot,
                                        intrinsics(run.config, dev), cfg,
                                        pcfg, dev)
                per_control.append(frame_gaps(cpu_outputs(c), r))
        got = merge(per_frame)
        got["outputs_differ"] = float(out_differ)
        got["carry_differ"] = float(carry)
        got["mask_pixels_differ"] = float(mask_px)
        got["odom_gap"] = odom_gap
        if first is not None:
            got["start_gap"] = start_gap(
                first, torch.as_tensor(gt.R[0], dtype=torch.float32),
                torch.as_tensor(gt.t[0], dtype=torch.float32), cfg, cpu)
        smooth_gap = c_smooth_gap = unmoved = 0.0
        dev = run.device
        for rec, state, kf_R, kf_t in smooth_in:
            if rec.n_kf < 2:          # nothing to smooth, on either side
                continue
            if kf_R is None:          # the program did not smooth
                smooth_gap = float("inf")
                continue

            def smooth():
                R, t, _ = rsmooth.smooth_trajectory(
                    rec, to_ref(state, dev), cfg,
                    iters=run.config["smooth_iters"], damping=cfg.damping)
                return R, t

            rR, rt = smooth()
            smooth_gap = max(smooth_gap, _pose_gap(kf_R, kf_t, rR, rt))
            unmoved = max(unmoved, _pose_gap(np.stack(rec.kf_R),
                                             np.stack(rec.kf_t), rR, rt))
            if control:
                with tf32():
                    c_smooth_gap = max(c_smooth_gap,
                                       _pose_gap(*smooth(), rR, rt))
        got["smooth_gap"] = smooth_gap
        got["smooth_unmoved"] = unmoved
        checks, info = split(got, run.workload["limits"])
        if not control:
            return checks, info, None
        ctl = merge(per_control)
        ctl["smooth_gap"] = c_smooth_gap
        return checks, info, ctl

    def release(self) -> None:
        self.tree_root = self.inputs["root"]
        self.masks = self.inputs["masks"]
        self.hooks.captured.clear()
        self.sequences.clear()
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()


def _pose_gap(R, t, R_ref, t_ref) -> float:
    d = max(float(np.abs(np.asarray(R, np.float64) - R_ref).max()),
            float(np.abs(np.asarray(t, np.float64) - t_ref).max()))
    return d if np.isfinite(d) else float("inf")


def _smoother_inputs(out: dict):
    """What the smoother was given (the program's recorder and final
    state), copied to the host, and what it returned."""
    rec = out["recorder"]
    snap = SimpleNamespace(
        n_kf=rec.n_kf, D=rec.D, kf_R=list(rec.kf_R), kf_t=list(rec.kf_t),
        odom_R=list(rec.odom_R), odom_t=list(rec.odom_t),
        pf_pi=list(rec.pf_pi), pf_lm=list(rec.pf_lm),
        pf_valid=list(rec.pf_valid), pf_stamp=list(rec.pf_stamp))
    return snap, to_cpu(out["state"]), out.get("kf_R"), out.get("kf_t")
