"""io_ms_per_frame: the TUM runner's ``io`` stage (PNG decode and the
mask to the device; its timer synchronizes the device before it stops),
per frame, over the window's sequences the profiler did not touch."""


def read(run):
    st = [s["io"] for s in run.extras.get("stages", []) if "io" in s]
    n = sum(s["count"] for s in st)
    return 1e3 * sum(s["total_s"] for s in st) / n if n else None
