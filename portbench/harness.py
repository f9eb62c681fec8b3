"""One run of one benchmark cell: set-up, the measured window, the
metrics, the check, the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` at the root
names the cell's configuration (its file), its traffic
(``portbench/traffic/<traffic>.json``) and its metrics
(``portbench/metrics/<metric>.py``); ``portbench/workloads/<cell>.json``
names the driver (``portbench/drivers/<driver>.py``) and the traced and
checked frame counts.  A driver runs the program; this module times it.

The window runs whole sequences back to back; it ends at the end of the
sequence that is running when ``--seconds`` is reached (and, with
``--trace 1``, once the traced frames are done).  Set-up is everything
from the process's start to the window's first frame.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .trace import DeviceClock, Tracer

ROOT = Path(__file__).resolve().parent.parent
HERE = Path(__file__).resolve().parent
# top-level module names that must not be loaded in a run (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "pop_up_slam_tpu")


def load_json(path) -> dict:
    with open(path) as f:
        return json.load(f)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"portbench: no {what} named {name!r} in BENCHMARK.json")


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def _report_forbidden() -> bool:
    bad = forbidden_modules()
    if bad:
        print("portbench: forbidden modules loaded: " + ", ".join(bad),
              file=sys.stderr)
    return bool(bad)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def power_limit() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else None


@dataclass
class Run:
    """What a driver is given and what it fills in."""

    cell: dict
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    workdir: str                # made by execute, removed when it ends
    tracer: Tracer
    clock: DeviceClock
    overrides: dict = field(default_factory=dict)
    # filled in by the window
    frames: int = 0            # frames whose pose came back
    failed: int = 0            # of them, poses that are not finite
    sequences: int = 0
    setup_s: float = 0.0
    window_s: float = 0.0
    frame_ms: list = field(default_factory=list)   # per-frame latency
    extras: dict = field(default_factory=dict)     # driver's readings
    setup_marks: list = field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Stamp the end of a set-up phase (printed on standard error)."""
        self.setup_marks.append((phase, time.perf_counter()))

    @property
    def trace_summary(self):
        return self.tracer.summary


@dataclass
class Check:
    """One number compared with the plain reference, and its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def _parse(argv):
    ap = argparse.ArgumentParser(prog="portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def prepare(argv, device=None, overrides=None):
    """Parse, find the cell's files, pick the device; returns (args,
    bench, Run, driver module) or raises SystemExit."""
    args = _parse(argv)
    bench = load_json(ROOT / "BENCHMARK.json")
    cell = _named(bench["workloads"], args.workload, "workload")
    cfg_entry = _named(bench["configs"], cell["config"], "config")
    config = load_json(ROOT / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    workload = load_json(HERE / "workloads" / f"{cell['name']}.json")
    overrides = overrides or {}
    traffic.update(overrides.get("traffic", {}))
    workload.update(overrides.get("workload", {}))
    if device is None:
        if not torch.cuda.is_available():
            raise SystemExit("portbench: no CUDA device is available")
        if torch.cuda.device_count() < cell["chips"]:
            raise SystemExit(
                f"portbench: the cell needs {cell['chips']} devices, "
                f"{torch.cuda.device_count()} are available")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    tracer = Tracer(bool(args.trace), workload["trace_start"],
                    workload["trace_frames"], device)
    # a --trace 0 run profiles the device over the whole window where an
    # end-to-end metric of the cell is read from the device trace
    clock = DeviceClock(
        not args.trace and any(m["source"] == "device_trace" for m in
                               cell_metrics(bench, cell["name"],
                                            "end_to_end")), device)
    run = Run(cell, config, traffic, workload, args.seed, args.seconds,
              bool(args.trace), device, "", tracer, clock, overrides)
    driver_mod = importlib.import_module(
        f"portbench.drivers.{workload['driver']}")
    return args, bench, run, driver_mod


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def metric_reader(name: str):
    """The reader of metric ``name``: ``portbench/metrics/<name>.py``
    (a name may hold dots, as ``k1_roofline.replay``)."""
    mod_name = "portbench.metrics." + name.replace(".", "__")
    if mod_name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            mod_name, HERE / "metrics" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[mod_name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[mod_name]


def read_metrics(bench, run, kind) -> dict:
    out = {}
    for m in cell_metrics(bench, run.cell["name"], kind):
        value = metric_reader(m["name"]).read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(argv, t0: float, device=None, overrides=None, fault=None,
            control: bool = False):
    """Run one cell once.  Returns (exit code, result dict or None).
    ``device`` and ``fault`` are for the tests: a device other than the
    card skips the look for one, and ``fault(run)`` breaks the program
    underneath before set-up.  With ``control`` the result also holds
    the control's numbers (the reference in the program's place, one
    precision lower) under ``control``."""
    args, bench, run, driver_mod = prepare(argv, device, overrides)
    # the run's files (the TUM tree) live under TMPDIR and go with it
    run.workdir = tempfile.mkdtemp(prefix="portbench-")
    try:
        driver = driver_mod.Driver(run)
        if fault is not None:
            fault(run)
        driver.setup()
        _sync(run.device)
        t_start = time.perf_counter()
        c_start = time.process_time()
        run.setup_s = t_start - t0
        prev, phases = t0, []
        for phase, t in run.setup_marks:
            phases.append(f"{phase} {t - prev:.3f} s")
            prev = t
        print("setup: " + ", ".join(phases), file=sys.stderr)
        while True:
            run.clock.start()
            driver.sequence()
            run.clock.stop()
            run.sequences += 1
            if (time.perf_counter() - t_start >= run.seconds
                    and run.tracer.done and driver.complete()):
                break
        _sync(run.device)
        run.window_s = time.perf_counter() - t_start
        print(f"window: {run.window_s!r} s, process cpu "
              f"{time.process_time() - c_start!r} s, {run.sequences} "
              f"sequences, {run.frames} frames", file=sys.stderr)
        if run.clock.measured:
            print(f"device clock: {run.clock.busy_us!r} us busy, "
                  f"{run.clock.activities} activities "
                  f"({run.clock.activities / max(run.frames, 1)!r} a frame); "
                  f"activities and busy us a sequence "
                  f"{run.clock.sequences!r}", file=sys.stderr)
        driver.finish()
        peak = (torch.cuda.max_memory_allocated(run.device)
                if run.device.type == "cuda" else 0)
        if _report_forbidden():
            return 4, None
        summary = run.tracer.summarize()
        kind = "per_layer" if run.trace else "end_to_end"
        metrics = read_metrics(bench, run, kind)
        checks, info, ctl = driver.check(control)
    finally:
        shutil.rmtree(run.workdir, ignore_errors=True)
    if _report_forbidden():
        return 4, None
    dev = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
           "kind": (torch.cuda.get_device_name(run.device)
                    if run.device.type == "cuda" else "cpu"),
           "count": int(run.cell["chips"]),
           "memory_peak_bytes": int(peak)}
    if run.device.type == "cuda":
        dev["power"] = power_limit()
    result = {"correct": run.failed == 0 and all(c.ok for c in checks),
              "attempted": run.frames, "failed": run.failed,
              "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary.busy_us() * 1e-6
        dev["window_s"] = summary.window_us * 1e-6
        result["breakdown"] = summary.breakdown()
    result["info"] = info
    if ctl is not None:
        result["control"] = ctl
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    return 0, result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    try:
        code, result = execute(argv, t0)
    except SystemExit as e:
        if isinstance(e.code, str):
            print(e.code, file=sys.stderr)
            return 3
        raise
    if result is None:
        return code
    sys.stdout.flush()
    for name, v in result["info"].items():
        print(f"info {name}: {v!r} (not held to a limit)", file=sys.stderr)
    for name, c in result["checks"].items():
        ok = c["value"] <= c["limit"]
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAIL'}", file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
