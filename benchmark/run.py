"""Run one cell of BENCHMARK.json on the CUDA card this machine holds.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

from the root of a checkout.  Prints the result as one JSON line on
standard output, the numbers the judge compared on standard error; exits
nonzero, printing no result, without a card or without the program.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

from harness.cell import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
