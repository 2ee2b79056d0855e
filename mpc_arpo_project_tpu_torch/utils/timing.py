"""Timing / profiling harness: wall time of device work, an accumulating
section timer, and a ``torch.profiler`` trace context.

Counterpart of ``mpc_arpo_project_tpu/utils/timing.py``. A CUDA call
returns before the device finishes, so :func:`device_time` synchronises the
device of the output before it reads the clock; CPU tensors are finished
when the call returns.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Any, Callable

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.utils.guards import tree_leaves


def _sync(out: Any) -> None:
    """Wait for the CUDA devices that hold a tensor of ``out``."""
    for dev in {leaf.device for _, leaf in tree_leaves(out)
                if torch.is_tensor(leaf) and leaf.is_cuda}:
        torch.cuda.synchronize(dev)


def device_time(fn: Callable, *args, reps: int = 3, warmup: int = 1,
                **kw) -> float:
    """Median wall time in seconds of ``fn(*args, **kw)``, each call ended
    by a synchronisation of the devices its output lives on."""
    for _ in range(warmup):
        _sync(fn(*args, **kw))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn(*args, **kw))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


class Timer:
    """Accumulating section timer for host-side orchestration code."""

    def __init__(self):
        self.acc = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] = self.acc.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.acc.values()) or 1.0
        lines = [
            f"{k:>24}: {v:8.3f}s ({100*v/total:5.1f}%)"
            for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """``torch.profiler`` over the CPU and, where there is one, the CUDA
    device; on exit writes a Chrome trace to ``log_dir/trace.json``. Yields
    the profiler (``key_averages()`` sums kernel time by name)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
