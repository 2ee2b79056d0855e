"""The share of alive solves that end SOLVED over the traced run's whole
batches, from the rollout's outputs. Layer: the solve and its chunk loop. A
MAX_ITER solve runs up to ``max_iter`` iterations, so the share moves the
throughput; it is a reading of the layer, not a guard of fidelity."""

import numpy as np

from arpobench import counts

UNIT = "%"


def read(run):
    if run.status.size == 0:
        return None
    return 100.0 * float(np.mean(run.status == counts.SOLVED))
