"""device_idle_pct: 100 minus the union of device activities (kernels,
copies, memsets) over the traced window, in percent."""


def read(run):
    t = run.trace_summary
    if t is None or not t.device or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us() / t.window_us)
