"""The traced span: ``torch.profiler`` over a fixed span of steps, and the
device's busy and idle time read back from its Chrome trace.

``Tracer`` starts the profiler (host and CUDA activities) on entry; on exit
it stops it, writes the Chrome trace into a fresh directory under the
temporary directory, reads the events back and deletes the file.

The arithmetic below ``Tracer`` is a frozen copy of
``mpc_arpo_project_tpu_torch/tools/profile_step.py:55-60, 69-70`` (the
trace's categories) and ``:172-278`` (``_innermost``, ``_idle``, ``aggregate``),
unchanged, so that a later change to the program cannot move it. The
profiler stretches a step (by 45-66% at steps 60-80 of the flagship), so an
idle share from it is a traced-run number.
"""

from __future__ import annotations

import collections
import heapq
import json
import os
import shutil
import tempfile

import torch


class Tracer:
    """``with Tracer() as t: ...`` leaves the trace's events in
    ``t.events``."""

    def __init__(self):
        self.events = None
        self._prof = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        folder = tempfile.mkdtemp(prefix="arpobench_trace_")
        try:
            path = os.path.join(folder, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                data = json.load(fh)
        finally:
            shutil.rmtree(folder, ignore_errors=True)
        self.events = (data.get("traceEvents", []) if isinstance(data, dict)
                       else data)
        return False


def kernel_ms(events, symbol: str) -> float:
    """The summed duration of the trace's device kernels whose name holds
    ``symbol``, in ms."""
    return sum(e.get("dur", 0) for e in events
               if e.get("ph") == "X" and e.get("cat") == "kernel"
               and symbol in e.get("name", "")) / 1e3


# the trace's categories of device events (kineto's names)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# neither device nor host events: the profiler's own span over the whole
# trace, and ranges of host annotations drawn on the device's track
NOT_HOST_CATS = ("Trace", "gpu_user_annotation")
# the profiler's own host work (CUPTI's "Activity Buffer Request"): a gap
# under it is the profiler's cost, and is named so
OVERHEAD_CAT = "overhead"
# the longest idle gaps that are listed one by one
N_GAPS = 5


def _innermost(host, points):
    """For each of ``points`` (increasing), the name of the shortest host
    event (start, end, name) that covers it, or None."""
    host = sorted(host)
    active, names, i = [], [], 0
    for p in points:
        while i < len(host) and host[i][0] <= p:
            s, e, name = host[i]
            heapq.heappush(active, (e - s, e, name))
            i += 1
        while active and active[0][1] < p:
            heapq.heappop(active)
        names.append(active[0][2] if active else None)
    return names


def _idle(device, host, n_steps):
    """The window's idle figures (``aggregate``'s ``device``) from the
    device's (start, end) intervals and the host's (start, end, name)
    events, given in microseconds."""
    t0 = min([s for s, _ in device] + [s for s, _, _ in host])
    t1 = max([e for _, e in device] + [e for _, e, _ in host])
    busy, gaps, edge = 0.0, [], t0
    for s, e in sorted(device):
        if s > edge:
            gaps.append((edge, s))
        if e > edge:
            busy += e - max(s, edge)
            edge = e
    if t1 > edge:
        gaps.append((edge, t1))
    names = _innermost(host, [(a + b) / 2 for a, b in gaps])
    names = ["(no host op)" if n is None else n for n in names]
    by_op = collections.defaultdict(float)
    n_by_op = collections.defaultdict(int)
    for (a, b), name in zip(gaps, names):
        by_op[name] += (b - a) / 1e3
        n_by_op[name] += 1
    longest = sorted(zip(gaps, names), key=lambda g: -(g[0][1] - g[0][0]))
    return dict(
        window_ms=(t1 - t0) / 1e3, busy_ms=busy / 1e3,
        device_ms=sum(e - s for s, e in device) / 1e3,
        idle_share=1.0 - busy / (t1 - t0),
        n_events=len(device), n_gaps=len(gaps),
        gaps=[((b - a) / 1e3, name) for (a, b), name in longest[:N_GAPS]],
        idle_by_host_op=[(name, ms / n_steps, n_by_op[name]) for name, ms in
                         sorted(by_op.items(), key=lambda kv: -kv[1])])


def aggregate(events, n_steps, top):
    """The trace's tables over a window of ``n_steps`` steps:

    * ``tracks``: (track, ms) of every complete event by process track,
      largest first (``tools/profile_step.py:137-153``). A track is named by
      its process name and, where the trace labels the process (torch's
      profiler names the host's and the card's tracks after the process and
      labels them ``CPU`` and ``GPU 0``), by the label in brackets;
    * ``ops``: (name cut at 110 characters, ms, count) of the device's
      events (the trace's kernel, copy and set events) summed by name, the
      ``top`` largest (``tools/profile_step.py:146-161``);
    * ``device``: None when the trace holds no device event; else the
      window, from the earliest start to the latest end of the program's
      events (host and device; not the profiler's own span) on the trace's
      clock, the host's, to which the profiler maps the device's
      timestamps: ``window_ms``; ``busy_ms``, the union of the device's
      events over all streams; ``device_ms``, their sum; ``idle_share``,
      ``1 - busy / window``; ``gaps``, the ``N_GAPS`` longest idle gaps
      (ms, host op), where the host op is the innermost host event that
      covers the gap's midpoint ("(no host op)" where none does; "profiler:
      NAME" where it is the profiler's own work); and
      ``idle_by_host_op``, (host op, idle ms per step, gaps) of every gap.
    """
    pid_name, pid_label = {}, {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pid_name[e["pid"]] = e["args"].get("name", "")
        elif e.get("ph") == "M" and e.get("name") == "process_labels":
            pid_label[e["pid"]] = e["args"].get("labels", "")
    track_of = {pid: pid_name.get(pid, "?") + (f" ({pid_label[pid]})"
                                               if pid_label.get(pid) else "")
                for pid in set(pid_name) | set(pid_label)}
    tracks = collections.defaultdict(float)
    ops = collections.defaultdict(float)
    ops_n = collections.defaultdict(int)
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        us = e.get("dur", 0)
        dur = us / 1e3
        tracks[track_of.get(e.get("pid"), "?")] += dur
        ts, cat, name = e["ts"], e.get("cat"), e.get("name", "?")
        if cat in DEVICE_CATS:
            ops[name] += dur
            ops_n[name] += 1
            device.append((ts, ts + us))
        elif cat not in NOT_HOST_CATS:
            if cat == OVERHEAD_CAT:
                name = f"profiler: {name}"
            host.append((ts, ts + us, name))
    rows = sorted(ops.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        n_steps=n_steps,
        tracks=sorted(tracks.items(), key=lambda kv: -kv[1]),
        ops=[(name[:110], v, ops_n[name]) for name, v in rows],
        device=_idle(device, host, n_steps) if device else None)

