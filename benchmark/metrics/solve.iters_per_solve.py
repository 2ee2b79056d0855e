"""The mean ADMM iterations of an alive solve (``done_iters``) over the
traced run's whole batches, from the rollout's outputs. Layer: the solve and
its chunk loop (``ops/admm.py``). Fewer iterations a solve, more solves a
second."""

import numpy as np

UNIT = "iters"


def read(run):
    if run.done_iters.size == 0:
        return None
    return float(np.mean(run.done_iters))
