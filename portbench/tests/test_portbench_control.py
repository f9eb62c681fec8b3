"""The control comes out not correct: the plain reference in the
program's place on the card, in TF32 (the nearest precision below the
configuration's float32 with TF32 off), from the same inputs and states,
fails at least one of the cell's limits.  Needs the card; at the cell's
own size the readings come from ``portbench/control.py``."""

import os
import time

import pytest
import torch

from _portbench_cpu import overrides

CELLS = ("corridor_w8_gn.replay", "tum_fr3.seq144")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists on the card only")
    from portbench import harness

    ov = overrides(cell)
    ov.pop("slam")          # the card runs the kernels, as the cell does
    ov["workload"]["check_frames"] = 12
    code, res = harness.execute(
        ["--workload", cell, "--seed", "2147483911", "--seconds", "0.1",
         "--trace", "0"], time.perf_counter(), overrides=ov, control=True)
    assert code == 0
    assert res["correct"], res["checks"]
    limits = {k: c["limit"] for k, c in res["checks"].items()}
    failed = [k for k, v in res["control"].items()
              if k in limits and v > limits[k]]
    assert failed, res["control"]
