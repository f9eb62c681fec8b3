"""The plain reference against the port at a small size on the CPU, and
a whole run's check.

On the CPU the port runs its kernels' plain versions, of which the
reference is a frozen copy: a whole run of each cell, its check
included, reads every gap as exactly 0."""

import pytest

from _portbench_cpu import run_cell

CELLS = ("corridor_w8_gn.replay", "tum_fr3.seq144")


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port_on_the_cpu(cell):
    code, res = run_cell(cell)
    assert code == 0
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    for name, c in res["checks"].items():
        assert c["value"] == 0.0, (name, c)
    metrics = res["metrics"]
    assert metrics["setup_s"]["value"] > 0
    if cell.startswith("tum"):
        assert metrics["frames_per_s"]["value"] > 0
    else:
        # the replay's device time comes from the device trace, which a
        # CPU run lacks: it is not reported
        assert set(metrics) == {"setup_s"}


def test_traced_run_reads_the_host_spans():
    code, res = run_cell(CELLS[1], trace=1)
    assert code == 0 and res["correct"]
    m = res["metrics"]
    assert m["popup_host_ms_per_frame"]["value"] > 0
    assert m["slam_step_host_ms_per_frame"]["value"] > 0
    # a CPU run has no device activity: no device metric is reported
    for name in ("device_idle_pct", "launches_per_frame", "k1_roofline"):
        assert name not in m
    assert res["device"]["window_s"] > 0
