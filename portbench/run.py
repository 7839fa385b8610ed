#!/usr/bin/env python3
"""Run one cell of the benchmark, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (harness.py). Without the
CUDA devices the cell asks for, it prints no result and exits non-zero.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
