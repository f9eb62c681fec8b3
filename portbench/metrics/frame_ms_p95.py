"""frame_ms_p95: the 95th percentile of every frame's latency in the
window (host clock; a frame's time runs from the previous frame's pose
on the host to its own, a sequence's first frame from the call's
start).  The sample count and the median go to standard error."""

import statistics
import sys


def read(run):
    xs = run.frame_ms
    if len(xs) < 20:
        return None
    p95 = statistics.quantiles(xs, n=20, method="inclusive")[18]
    print(f"frame_ms: n={len(xs)} median={statistics.median(xs)!r} "
          f"p95={p95!r}", file=sys.stderr)
    return p95
