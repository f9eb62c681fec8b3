"""launches_per_frame: device activities (kernels, copies, memsets) the
profiler recorded, per traced frame."""


def read(run):
    t = run.trace_summary
    if t is None or not t.device:
        return None
    return len(t.device) / t.frames
