"""Scaling out: Monte-Carlo sweeps over ``torch.distributed`` ranks.

The reference has no parallelism of any kind: its Monte-Carlo studies are
serial Python ``for`` loops (``disturbRejComp.py``,
``success_rates_test.py``). Here the scenario batch is the parallel axis:
batched on each device, split over ranks (one per device), with the
statistics combined by one collective a chunk (NCCL between GPUs, gloo on
CPUs).
"""

from mpc_arpo_project_tpu_torch.parallel.mesh import make_mesh, host_device_counts
from mpc_arpo_project_tpu_torch.parallel.mc import (
    SweepStats,
    run_sweep,
    sharded_stats_fn,
    disturbance_rejection_study,
    success_rate_study,
)

__all__ = [
    "make_mesh",
    "host_device_counts",
    "SweepStats",
    "run_sweep",
    "sharded_stats_fn",
    "disturbance_rejection_study",
    "success_rate_study",
]
