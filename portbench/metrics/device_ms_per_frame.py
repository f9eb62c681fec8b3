"""device_ms_per_frame: the device's busy time over the whole window (the
union of its kernels, copies and memsets, from the profiler's device
trace of every sequence; ``trace.DeviceClock``) per frame whose pose came
back, in ms: what each frame costs a card that many sequences share."""


def read(run):
    c = run.clock
    if not c.measured or run.frames <= 0:
        return None
    return c.busy_us * 1e-3 / run.frames
