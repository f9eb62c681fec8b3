"""A whole benchmark run on the CPU at a size a test can hold.

The harness's look for a card is skipped (``device="cpu"``); the
program takes its kernels' plain versions (``fused="on"``: K1's plain
version on CPU tensors), so a sound run agrees with the reference bit
for bit.  Sequences are cut to a few frames.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FRAMES = 14


def overrides(cell: str) -> dict:
    ov = {"workload": {"trace_start": 3, "trace_frames": 4,
                       "check_frames": 6, "warm_frames": FRAMES},
          "slam": {"fused": "on"}}
    if cell.startswith("corridor"):
        ov["traffic"] = {"frames": FRAMES, "sequences": 2,
                         "sways": [0.1, 0.3]}
    else:
        ov["traffic"] = {"frames": FRAMES}
    return ov


def run_cell(cell: str, seed: int = 2147483907, trace: int = 0, fault=None):
    from portbench import harness

    t0 = time.perf_counter()
    return harness.execute(
        ["--workload", cell, "--seed", str(seed), "--seconds", "0.1",
         "--trace", str(trace)], t0, device="cpu",
        overrides=overrides(cell), fault=fault)
