"""What the harness's tests share: the paths, and one small run of a cell
on the CPU (the program's plain twins stand in for its CUDA kernels)."""

import os
import sys
import time

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

from arpobench import cells, harness  # noqa: E402

# a size a test run holds: a few scenarios over a few steps, every one
# sampled, the traced span inside the first batch
SMALL = dict(batch=4, horizon_s=3.0, trace_steps=[1, 3], pool_batches=2)
SEED = 2 ** 31 + 12345


def small_cell(name, **traffic):
    cell = cells.load_cell(name)
    return cell._replace(traffic=dict(cell.traffic, **dict(SMALL, **traffic)))


def cpu_run(cell, seconds=10.0, trace=False, control=False):
    """(line, check_lines) of a run of ``cell`` on the CPU."""
    torch.set_num_threads(2)
    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"),
                            time.perf_counter(), control=control,
                            log=lambda *a: None)
