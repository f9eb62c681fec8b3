"""Run one benchmark cell of the PyTorch/CUDA port once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cell's number of
CUDA devices.  Prints the compared numbers with their limits as the last
lines on standard error and one JSON result as the last line on standard
output; exits non-zero with no result when there is no CUDA device, the
port cannot be imported, or a forbidden module (JAX or the JAX package)
was loaded.  See ``portbench/harness.py`` and ``PERF.md``.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    import portbench

    portbench.cache_env()
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], t0=T0))
