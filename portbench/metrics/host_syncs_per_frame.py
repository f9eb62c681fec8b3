"""host_syncs_per_frame: ``cudaStreamSynchronize`` and
``cudaDeviceSynchronize`` calls plus ``aten::_local_scalar_dense``
reads the profiler recorded on the host, per traced frame."""

from ..trace import SCALAR_READ, SYNC_CALLS


def read(run):
    t = run.trace_summary
    if t is None:
        return None
    return t.count_host(SYNC_CALLS + (SCALAR_READ,)) / t.frames
