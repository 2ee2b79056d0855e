"""The benchmark of mpc_arpo_project_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Run from the root of a checkout, on a machine with the CUDA devices the
cell asks for. Prints one JSON line as the last line of its standard
output; see ``benchmark/README.md``.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)  # arpobench
sys.path.insert(1, os.path.dirname(HERE))  # the program, at the checkout's root

from arpobench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(T_START))
