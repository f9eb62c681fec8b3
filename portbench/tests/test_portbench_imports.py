"""A run loads neither JAX nor the JAX package: the harness compares each
loaded module's whole top-level name (``pop_up_slam_tpu_torch`` begins
with ``pop_up_slam_tpu``)."""

import json
import os
import subprocess
import sys

from _portbench_cpu import ROOT

SCRIPT = """
import json, sys
sys.path.insert(0, {here!r})
from _portbench_cpu import run_cell
from portbench import harness
for cell in ("corridor_w8_gn.replay", "tum_fr3.seq144"):
    code, res = run_cell(cell)
    assert code == 0 and res is not None
print(json.dumps({{"forbidden": harness.forbidden_modules(),
                  "top": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_a_run_loads_no_jax():
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(here=here)],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    for name in ("jax", "jaxlib", "flax", "pop_up_slam_tpu"):
        assert name not in got["top"]
    assert "pop_up_slam_tpu_torch" in got["top"]


def test_the_whole_name_is_compared(monkeypatch):
    from portbench import harness

    monkeypatch.setitem(sys.modules, "pop_up_slam_tpu_torch_x", sys)
    assert "pop_up_slam_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pop_up_slam_tpu.geometry", sys)
    assert harness.forbidden_modules() == ["pop_up_slam_tpu.geometry"]
