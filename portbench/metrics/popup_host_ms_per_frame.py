"""popup_host_ms_per_frame: host time inside the benchmark's range
around ``popup.popup.pop_up``, per traced frame."""


def read(run):
    t = run.trace_summary
    if t is None or "pop_up" not in t.spans:
        return None
    return t.spans["pop_up"] * 1e-3 / t.frames
