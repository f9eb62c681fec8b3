"""The harness's arithmetic on hand-made numbers: the busy union and the
idle share, launches and syncs per frame, the rate and the p95."""

import statistics
from types import SimpleNamespace

import pytest

from _portbench_cpu import ROOT  # noqa: F401  (puts the repository on sys.path)
import torch

from portbench.harness import metric_reader
from portbench.metrics import (device_idle_pct, device_ms_per_frame,
                               frame_ms_p95, frames_per_s,
                               host_syncs_per_frame, k1_roofline,
                               launches_per_frame)
from portbench.trace import DeviceClock, TraceSummary, busy_us, union


def test_busy_union_of_overlapping_intervals():
    iv = [(0, 10), (5, 15), (20, 30), (22, 25), (40, 41)]
    assert busy_us(iv) == 26
    assert union(iv) == [[0, 15], [20, 30], [40, 41]]
    assert busy_us([]) == 0


def _summary():
    device = [("k_a", 0.0, 10.0), ("k_b", 5.0, 15.0), ("memcpy", 60.0, 70.0)]
    host = [("portbench:slam_step", 0.0, 80.0),
            ("cudaStreamSynchronize", 15.0, 60.0),
            ("aten::_local_scalar_dense", 16.0, 59.0),
            ("cudaDeviceSynchronize", 85.0, 86.0)]
    return TraceSummary(frames=2, window=(0.0, 100.0), device=device,
                        host=host, spans={"slam_step": 80.0})


def test_idle_share_launches_and_syncs():
    run = SimpleNamespace(trace_summary=_summary(), extras={})
    assert device_idle_pct.read(run) == pytest.approx(75.0)
    assert launches_per_frame.read(run) == pytest.approx(1.5)
    assert host_syncs_per_frame.read(run) == pytest.approx(1.5)


def test_breakdown_attributes_gaps_to_the_host():
    b = _summary().breakdown()
    ops = dict((k, v) for k, v in b["device_ops"])
    assert ops == {"k_a": pytest.approx(10e-6), "k_b": pytest.approx(10e-6),
                   "memcpy": pytest.approx(10e-6)}
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 15-60: inside the frame step, the host in its scalar read
    assert gaps["slam_step/aten::_local_scalar_dense"] == pytest.approx(45e-6)
    # 70-100: the frame step until 80, then nothing
    assert sum(gaps.values()) == pytest.approx(75e-6)


def test_roofline_share_is_bound_over_device_time():
    s = _summary()
    s.device.append(("void fused_gn_kernel<8>", 80.0, 84.0))
    run = SimpleNamespace(trace_summary=s,
                          extras={"k1": {"launches": 1, "bound_s": 1e-6}})
    assert k1_roofline.read(run) == pytest.approx(25.0)
    run.extras["k1"]["launches"] = 0
    assert k1_roofline.read(run) is None


def test_rate_and_p95():
    run = SimpleNamespace(frames=300, window_s=4.0,
                          frame_ms=[float(i) for i in range(1, 101)])
    assert frames_per_s.read(run) == 75.0
    want = statistics.quantiles(run.frame_ms, n=20, method="inclusive")[18]
    assert frame_ms_p95.read(run) == pytest.approx(want)
    assert want == pytest.approx(95.05)
    run.frame_ms = [1.0] * 5
    assert frame_ms_p95.read(run) is None


def test_device_time_a_frame():
    clock = SimpleNamespace(measured=True, busy_us=3.0e5)
    run = SimpleNamespace(frames=150, clock=clock)
    assert device_ms_per_frame.read(run) == pytest.approx(2.0)
    clock.measured = False
    assert device_ms_per_frame.read(run) is None


def test_device_clock_is_off_without_a_card():
    clock = DeviceClock(True, torch.device("cpu"))
    clock.start()
    clock.stop()
    assert not clock.enabled and not clock.measured


def test_a_dotted_metric_name_finds_its_reader():
    assert metric_reader("k1_roofline.replay").read is k1_roofline.read
    assert metric_reader("frames_per_s.replay").read is frames_per_s.read
