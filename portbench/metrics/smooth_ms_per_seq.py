"""smooth_ms_per_seq: the TUM runner's ``smooth`` stage (the full
keyframe trajectory re-solved once a sequence), per sequence, over the
window's sequences the profiler did not touch."""


def read(run):
    st = [s["smooth"] for s in run.extras.get("stages", []) if "smooth" in s]
    n = sum(s["count"] for s in st)
    return 1e3 * sum(s["total_s"] for s in st) / n if n else None
