"""Structured per-frame metrics + stage timing.

The port's own copy of ``pop_up_slam_tpu/utils/metrics.py``: every
frame appends one JSON line and the stage wall-clock sums are reported
at the end.  For kernel-level tracing use ``torch.profiler`` (the CLI
exposes ``--profile-dir``).
"""

from __future__ import annotations

import json
import time


class StageTimer:
    """Wall-clock accumulator per named stage.

    Note: CUDA work is asynchronous, so a stage's time is only
    meaningful if the caller synchronizes the device before ``stop()``
    (the TUM runner does); otherwise use torch.profiler for device-side
    truth.
    """

    def __init__(self):
        self.totals: dict = {}
        self.counts: dict = {}
        self._start = None
        self._name = None

    def start(self, name: str):
        self._name = name
        self._start = time.perf_counter()

    def stop(self):
        dt = time.perf_counter() - self._start
        self.totals[self._name] = self.totals.get(self._name, 0.0) + dt
        self.counts[self._name] = self.counts.get(self._name, 0) + 1
        self._name = None
        return dt

    def summary(self) -> dict:
        return {
            k: {
                "total_s": round(v, 4),
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                "count": self.counts[k],
            }
            for k, v in self.totals.items()
        }


class MetricsLogger:
    """Append-only JSONL metrics stream + in-memory aggregation."""

    def __init__(self, path: str | None = None):
        self.path = path
        self._fh = open(path, "w") if path else None
        self.rows: list = []

    def log(self, **kv) -> None:
        kv.setdefault("ts", time.time())
        self.rows.append(kv)
        if self._fh:
            self._fh.write(json.dumps(kv) + "\n")
            self._fh.flush()

    def close(self) -> None:
        if self._fh:
            self._fh.close()

    def summary(self, keys=None) -> dict:
        """Mean/min/max over numeric columns."""
        out = {}
        if not self.rows:
            return out
        keys = keys or {
            k for r in self.rows for k, v in r.items()
            if isinstance(v, (int, float)) and k != "ts"
        }
        for k in keys:
            vals = [r[k] for r in self.rows if k in r]
            if vals:
                out[k] = {
                    "mean": sum(vals) / len(vals),
                    "min": min(vals),
                    "max": max(vals),
                    "n": len(vals),
                }
        return out
