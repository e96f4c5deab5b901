#!/usr/bin/env python3
"""One run of one benchmark cell of the port (``locust_tpu_torch``).

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints one JSON line last on stdout; exits
non-zero, with no line, when the cell's CUDA devices are missing or the
run fails.  See benchmark/README.md.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# The checkout's root, in place of this folder: the package is `benchmark`.
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(harness.main(sys.argv[1:], T_START))
