"""The entry point prints no result and exits non-zero where it cannot
measure: no CUDA device, or a cell that ``BENCHMARK.json`` lacks."""

import os
import subprocess
import sys

import pytest
import torch

from _portbench_cpu import ROOT


def _run(*args):
    return subprocess.run(
        [sys.executable, os.path.join("portbench", "run.py"), *args],
        capture_output=True, text=True, cwd=ROOT, timeout=300)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run("--workload", "corridor_w8_gn.replay", "--seed",
               "2147483913", "--seconds", "1", "--trace", "0")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_unknown_cell_no_result():
    out = _run("--workload", "no_such.cell", "--seed", "1", "--seconds",
               "1", "--trace", "0")
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
