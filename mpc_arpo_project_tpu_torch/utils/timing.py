"""Timing / profiling harness: wall time of device work, the program's
spans, and a ``torch.profiler`` trace context.

Counterpart of ``mpc_arpo_project_tpu/utils/timing.py``. A CUDA call
returns before the device finishes, so :func:`device_time` synchronises the
device of the output before it reads the clock; CPU tensors are finished
when the call returns.

The spans (:func:`span`) mark the program's layers in a ``torch.profiler``
trace, on the clock of the device's kernels, and cost one check of the
profiler's state when no profiler runs. Their names are a fixed vocabulary;
a count of spans is the counter (``record_function`` exports no arguments):

=====================  ==================================================
``loop.step``          a discrete step (``rollout/discrete.py::_step``)
``loop.tick``          a continuous tick (``rollout/continuous.py::_tick``)
``step.estimate``      the UKF or KF update
``step.bounds``        the constraint rebuild and the new ``l``, ``u``
``step.control``       the controller hierarchy and the saturation
``step.plant``         the plant: the discrete line, or ``rk4_tick``
``solve``              ``ops/admm.py::admm_solve``
``solve.setup``        'eig': slot assignment to the first refresh
``solve.refresh``      'eig': one Woodbury inner-inverse refresh
``solve.chunk``        one check chunk of the solve's loop
``kernel.eig_chunk``   the host side of one ``eig_chunk`` CUDA launch
``solve.read``         one device-to-host read of the solve
``solve.compact``      'eig': one compaction of the running slots
``solve.finish``       'eig': the scatter back to problem order
=====================  ==================================================
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


_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler.record_function(name)`` while a profiler records,
    else a shared context that does nothing. ``name`` is one of the
    module's vocabulary, a constant string."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def host_read(t: torch.Tensor):
    """``t.item()`` for a 0-d tensor, else ``t.tolist()``, in a
    ``solve.read`` span: the solve's device-to-host reads."""
    with span("solve.read"):
        return t.item() if t.dim() == 0 else t.tolist()


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
