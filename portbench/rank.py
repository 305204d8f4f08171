#!/usr/bin/env python3
"""One rank other than 0 of a multi-card cell of the benchmark.

    python3 portbench/rank.py <shared.json> <rank>

Started by the harness's process (rank 0) with torchrun's environment,
never by hand: it reads the cell and the run's arguments that rank 0
wrote to `shared.json`, joins the program's process group and follows
rank 0's calls on its own card (``harness.follow_main``).  It prints no
result.  It ends when rank 0 ends.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.follow_main(sys.argv[1], int(sys.argv[2]), T_START))
