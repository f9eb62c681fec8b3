"""Shared arithmetic of the kernels' roofline shares."""


def share(run, key: str, kernels) -> float | None:
    """The least time the counted work needs (``run.extras[key]``) over
    the device time of the activities named ``kernels``, in percent."""
    t = run.trace_summary
    work = run.extras.get(key)
    if t is None or not work or not work["launches"]:
        return None
    dev_us = t.device_us(kernels)
    if dev_us <= 0:
        return None
    return 100.0 * work["bound_s"] * 1e6 / dev_us
