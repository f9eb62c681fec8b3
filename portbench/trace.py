"""The traced part of a ``--trace 1`` run, and what is read from it.

The profiler (``torch.profiler``, CPU and CUDA activities) runs over a
fixed number of frames from the window's steady part: it starts at the
``trace_start``-th frame boundary of the window and stops at the
``trace_start + trace_frames``-th, each boundary reported by the driver.
The device is synchronized at both ends, so the traced window holds the
device work of those frames only.  The benchmark's own ranges are named
``portbench:<name>``; they come from wrappers the drivers put around the
program's module attributes.

A ``--trace 0`` run of a cell with an end-to-end metric read from the
device trace profiles the device alone over the whole window instead
(:class:`DeviceClock`).
"""

from __future__ import annotations

import bisect
import os
from dataclasses import dataclass, field

import torch

PREFIX = "portbench:"
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
SCALAR_READ = "aten::_local_scalar_dense"


def busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals (the profile
    script's ``_busy_us``)."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def union(intervals):
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


@dataclass
class TraceSummary:
    """What a metric reader sees of the trace: device activities and the
    host's events, in microseconds on the profiler's clock."""

    frames: int
    window: tuple                      # (start, end)
    device: list                       # (name, start, end)
    host: list                         # (name, start, end), all CPU events
    spans: dict = field(default_factory=dict)   # portbench range -> us

    @property
    def window_us(self) -> float:
        return self.window[1] - self.window[0]

    def busy_us(self) -> float:
        return busy_us([(s, e) for _, s, e in self.device])

    def device_us(self, names) -> float:
        """Device time of the activities whose name contains any of
        ``names``."""
        return sum(e - s for n, s, e in self.device
                   if any(k in n for k in names))

    def count_host(self, names) -> int:
        return sum(1 for n, _, _ in self.host if n in names)

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by what the host was doing (the benchmark's range and the
        innermost host operation at the gap's middle), in seconds."""
        ops = {}
        for n, s, e in self.device:
            ops[n[:96]] = ops.get(n[:96], 0.0) + (e - s)
        busy = union([(s, e) for _, s, e in self.device])
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        ops_h = sorted((h for h in self.host if not h[0].startswith(PREFIX)),
                       key=lambda x: x[1])
        starts = [h[1] for h in ops_h]
        ranges = sorted((h for h in self.host if h[0].startswith(PREFIX)),
                        key=lambda x: x[1])
        r_starts = [h[1] for h in ranges]
        gaps = {}
        for a, b in zip(edges[0::2], edges[1::2]):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            rng, op, op_len = "outside", "idle", None
            k = bisect.bisect_right(r_starts, mid)
            for n, s, e in reversed(ranges[max(0, k - 8):k]):
                if e >= mid:
                    rng = n[len(PREFIX):]
                    break
            k = bisect.bisect_right(starts, mid)
            for n, s, e in reversed(ops_h[max(0, k - 400):k]):
                if e >= mid and (op_len is None or e - s < op_len):
                    op, op_len = n, e - s
            label = f"{rng}/{op}"[:96]
            gaps[label] = gaps.get(label, 0.0) + (b - a)

        def top_of(d):
            return [[k, v * 1e-6] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}


class Tracer:
    """Starts and stops the profiler at frame boundaries (see the module
    docstring).  Disabled, it only counts."""

    def __init__(self, enabled: bool, start: int, frames: int,
                 device: torch.device):
        self.enabled = enabled
        self.device = device
        self.start_at, self.frames = start, frames
        self.count = 0
        self.prof = None
        self.active = False
        self.done = not enabled
        self.summary: TraceSummary | None = None

    def boundary(self) -> None:
        if self.done:
            return
        if self.count == self.start_at:
            from torch.profiler import ProfilerActivity, profile

            self._sync()
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.start()
            self.active = True
            with torch.profiler.record_function(PREFIX + "begin"):
                pass
        elif self.count == self.start_at + self.frames:
            with torch.profiler.record_function(PREFIX + "end"):
                self._sync()
            self.prof.stop()
            self.active = False
            self.done = True
        self.count += 1

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def summarize(self) -> TraceSummary | None:
        """Reduce the profile to a :class:`TraceSummary` (after the
        window: the events are read on the host)."""
        if self.prof is None or not self.done:
            return None
        evs = self.prof.events()
        begin = end = None
        device, host = [], []
        for e in evs:
            s, f = e.time_range.start, e.time_range.end
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if not e.name.startswith(PREFIX):
                    device.append((e.name, s, f))
                continue
            if e.name == PREFIX + "begin":
                begin = s
            elif e.name == PREFIX + "end":
                end = (s, f)
            host.append((e.name, s, f))
        if begin is None or end is None:
            raise RuntimeError("the trace lacks the benchmark's markers")
        # the harness's own synchronize at the end is not the program's
        host = [h for h in host if h[1] < end[0]]
        window = (begin, end[1])
        device = [(n, max(s, window[0]), min(f, window[1]))
                  for n, s, f in device if f > window[0] and s < window[1]]
        spans = {}
        for n, s, f in host:
            if n.startswith(PREFIX):
                spans[n[len(PREFIX):]] = spans.get(n[len(PREFIX):], 0.0) + (
                    f - s)
        self.summary = TraceSummary(self.frames, window, device, host, spans)
        self.prof = None
        return self.summary


class DeviceClock:
    """The device time of the whole window in a ``--trace 0`` run: the
    profiler, CUDA activities only, over each of the window's sequences in
    turn, and each sequence's kernels, copies and memsets reduced to the
    length of their union before the next starts.  (One profile holds a
    sequence's ~135,000 activities, well inside the profiler's buffers; a
    whole window's millions would overflow them.)  The harness starts it
    before a sequence dispatches anything and stops it after the sequence
    has synchronized, so every activity of the window is counted.
    Disabled, it does nothing."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled and device.type == "cuda"
        self.device = device
        self.busy_us = 0.0
        self.activities = 0
        self.sequences: list = []  # (activities, busy us) a sequence
        self.prof = None
        if self.enabled:
            # keep CUPTI set up between the sequences' profiles
            os.environ.setdefault("TEARDOWN_CUPTI", "0")

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.start()

    def stop(self) -> None:
        if self.prof is None:
            return
        torch.cuda.synchronize(self.device)
        self.prof.stop()
        cuda = torch.autograd.DeviceType.CUDA
        iv = [(e.start_ns(), e.end_ns())
              for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
        self.prof = None
        busy = busy_us(iv) * 1e-3
        self.activities += len(iv)
        self.busy_us += busy
        self.sequences.append((len(iv), busy))

    @property
    def measured(self) -> bool:
        return self.enabled and self.activities > 0


def ranged(name: str, fn):
    """``fn`` inside a ``portbench:<name>`` profiler range."""
    rf = torch.profiler.record_function

    def wrapper(*args, **kwargs):
        with rf(PREFIX + name):
            return fn(*args, **kwargs)

    wrapper.__wrapped__ = fn
    return wrapper
