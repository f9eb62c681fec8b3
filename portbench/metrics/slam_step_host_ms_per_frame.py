"""slam_step_host_ms_per_frame: host time inside the benchmark's range
around ``pipeline.slam.slam_step`` (association, store, factors, the
windowed solve, the marginal), per traced frame."""


def read(run):
    t = run.trace_summary
    if t is None or "slam_step" not in t.spans:
        return None
    return t.spans["slam_step"] * 1e-3 / t.frames
