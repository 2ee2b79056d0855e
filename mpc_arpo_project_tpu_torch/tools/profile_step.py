"""Port of ``tools/profile_step.py:1-161``: device time by kernel and the
device's idle share over the flagship closed loop.

Runs the flagship rollout (the JAX tool's configuration: Nx=50, fp32 'eig',
B=1024, 300 steps), traces a few segments in the middle of the trajectory
with ``torch.profiler`` (CPU and CUDA activities), and reads the exported
Chrome trace:

* the total time of the trace's complete events by process track, and the
  device's events (kernels, copies and sets) summed by name: ms in all, ms
  per step, count (the JAX tool's two tables);
* the card's counterpart of the JAX tool's device track: the window, the
  device's busy time (the union of its events over all streams), the idle
  share ``1 - busy / window``, the longest idle gaps with the host op that
  spans each, and the idle ms per step by that host op;
* the program's spans (``utils.timing.span``): by name, their count a
  step, their host self time a step (less their child spans), and the
  device ms a step launched under them and the idle ms a step under them
  (child spans included).

    python -m mpc_arpo_project_tpu_torch.tools.profile_step \\
        [--batch 1024] [--segs 2] [--start-seg 6] [--top 40] [--cpu]

It runs on the card by default and raises without one unless ``--cpu`` is
given. The trace goes to a fresh temporary directory, whose path it prints.
On the card, a trace that holds no device event, or fewer events of a
hand-written kernel than its wrapper counted launches, is an error (exit
code 1): there is no other timer to fall back to.

The JAX tool's first run existed only to compile, and its traced run drew
its noise from ``jax.random.fold_in(key(0), 1)``. The port runs once, on
noise from a ``torch.Generator`` on the engine's device seeded 0 (other
draws than JAX's). The segments before the window build the kernels; with
``--start-seg 0`` they are built before the rollout starts.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import heapq
import json
import os
import sys
import tempfile
import time
from typing import NamedTuple

import torch

from mpc_arpo_project_tpu_torch.bench import (
    _noise, _sync, flagship_parts, flagship_sim)
from mpc_arpo_project_tpu_torch.ops import admm, admm_eig
from mpc_arpo_project_tpu_torch.rollout import discrete
from mpc_arpo_project_tpu_torch.tools.kernel_probe import card_line
from mpc_arpo_project_tpu_torch.utils.timing import profile_trace

# the trace's categories of device events (kineto's names)
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# neither device nor host events: the profiler's own span over the whole
# trace, and ranges of host annotations drawn on the device's track
NOT_HOST_CATS = ("Trace", "gpu_user_annotation")
# the profiler's own host work (CUPTI's "Activity Buffer Request"): a gap
# under it is the profiler's cost, and is named so
OVERHEAD_CAT = "overhead"
# the program's spans (``utils.timing.span``), and the host calls that
# launch device work, matched to it by the trace's correlation id
SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the hand-written kernels of the flagship 'eig' path: wrapper, the CUDA
# symbol its launches carry in the trace, and its library's build
KERNELS = {"eig_chunk": (admm_eig.eig_chunk, "eig_chunk_kernel",
                         admm_eig._lib)}
# the JAX tool's segment length (steps)
SEG = 10
# the longest idle gaps that are listed one by one
N_GAPS = 5


def flagship_engine(batch, device="cuda", T_final=150.0):
    """The JAX tool's flagship (``tools/profile_step.py:57-93``): the
    bench's MPC (Nx=50), failsafe and debris, sigma 0.75 held 50 steps,
    ``T_final`` seconds, fp32, 'eig' with a 4000-iteration cap and the
    stall windows 12 and 24 chunks of 25. Returns (engine, noise): the
    (T, batch, 4) noise from a generator on the engine's device seeded 0.
    Raises on ``device="cuda"`` without a CUDA device."""
    device = admm.resolve_device(device)
    mpc, fail, debris = flagship_parts(Nx=50)
    settings = admm.ADMMSettings(
        max_iter=4000, solve_mode="eig", check_every=25,
        stall_exit_chunks=12, stall_tighten_chunks=24)
    engine = discrete.build_engine(flagship_sim(T_final), mpc, fail, debris,
                                   settings=settings, dtype=torch.float32,
                                   device=device)
    return engine, _noise(engine, batch, 0)


class Profile(NamedTuple):
    """A traced window: the Chrome trace's path and events, the steps it
    holds, each kernel's launches counted by its wrapper over the window,
    the window's seconds on the host's clock, every segment's ms per step on
    that clock (each segment ends in a synchronisation; the window's run
    traced, and the profiler's start and stop fall between segments), and
    the seconds from the window's end until its events were read back (the
    profiler's stop, the export, the parse)."""

    path: str
    events: list
    n_steps: int
    launches: dict
    wall_s: float
    seg_ms: list
    trace_s: float


def _launches():
    return {name: k[0].launches for name, k in KERNELS.items()}


def profile(engine, noise, *, seg=SEG, start_seg=6, segs=2, log_dir):
    """Run the closed loop over ``noise`` and trace steps
    ``[start_seg * seg, (start_seg + segs) * seg)`` into
    ``log_dir/trace.json``. The device is synchronised at every segment
    boundary, so the window holds whole steps; the profiler starts and stops
    at a boundary, after that synchronisation."""
    lo, hi = start_seg * seg, (start_seg + segs) * seg
    if start_seg < 0 or segs < 1 or hi > engine.nsim:
        raise ValueError(f"the window [{lo}, {hi}) is not inside the "
                         f"{engine.nsim} steps")
    device = engine.device
    window = contextlib.ExitStack()
    seg_ms, marks = [], {}

    def start():
        window.enter_context(profile_trace(log_dir))
        marks["launches"] = _launches()

    def stop(now):
        marks["stopped"] = now
        marks["launches"] = {n: v - marks["launches"][n]
                             for n, v in _launches().items()}
        window.close()  # stops the profiler and writes the trace

    def progress(done, total, carry):
        _sync(device)
        now = time.perf_counter()
        seg_ms.append((now - marks["prev"]) * 1e3 / seg)
        if done == lo:
            start()
        elif done == hi:
            stop(now)
        marks["prev"] = time.perf_counter()

    if lo == 0:
        if device.type == "cuda":
            for _, _, build in KERNELS.values():
                build()
        _sync(device)
        start()
    marks["prev"] = time.perf_counter()
    with window:
        discrete.rollout_chunked(engine, noise, seg=seg, progress=progress)
    path = os.path.join(log_dir, "trace.json")
    print(f"traced steps [{lo},{hi}) into {path}", file=sys.stderr)
    with open(path) as fh:
        data = json.load(fh)
    events = data.get("traceEvents", []) if isinstance(data, dict) else data
    wall_s = sum(seg_ms[start_seg:start_seg + segs]) * seg / 1e3
    return Profile(path, events, hi - lo, marks["launches"], wall_s, seg_ms,
                   time.perf_counter() - marks["stopped"])


def kernel_events(events, symbol):
    """The count of device kernel events whose name holds ``symbol``."""
    return sum(1 for e in events if e.get("ph") == "X"
               and e.get("cat") == "kernel" and symbol in e.get("name", ""))


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


def _gaps(device, host):
    """(t0, t1, busy, gaps) of the window from the earliest start to the
    latest end of the device's (start, end) and the host's (start, end,
    name) events: the device's busy time (the union of its intervals) and
    its idle gaps (start, end)."""
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
    return t0, t1, busy, gaps


def _idle(device, host, n_steps):
    """The window's idle figures (``aggregate``'s ``device``) from the
    device's (start, end) intervals and the host's (start, end, name)
    events, given in microseconds."""
    t0, t1, busy, gaps = _gaps(device, host)
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


def _covering(spans, points):
    """For each of ``points`` (increasing), the set of names of the spans
    (start, end, name; nested, as one thread's are) that cover it."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    stack, out, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append({name for _, _, name in stack})
    return out


def span_table(events, n_steps):
    """The program's spans over a window of ``n_steps`` steps: (name, count,
    host self ms, device ms, idle ms), each a step, by name. Self time is
    the span's time less that of its child spans; device ms sums the
    device's events whose launch (the host call of the same correlation id)
    lies in the span, idle ms the idle gaps whose midpoint does, child
    spans included. Both are None where the trace holds no device event."""
    spans = sorted(((e["ts"], e["ts"] + e.get("dur", 0), e["name"])
                    for e in events
                    if e.get("ph") == "X" and e.get("cat") == SPAN_CAT),
                   key=lambda sp: (sp[0], -sp[1]))
    count = collections.Counter(name for _, _, name in spans)
    self_us = collections.defaultdict(float)
    stack = []
    for s, e, name in spans:
        while stack and stack[-1][1] <= s:
            stack.pop()
        self_us[name] += e - s
        if stack:
            self_us[stack[-1][2]] -= e - s
        stack.append((s, e, name))
    launch_ts, device, host = {}, [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in LAUNCH_CATS and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = e["ts"]
        if cat in DEVICE_CATS:
            device.append(e)
        elif cat not in NOT_HOST_CATS:
            host.append((e["ts"], e["ts"] + e.get("dur", 0), e.get("name")))
    dev_us = idle_us = None
    if device:
        dev_us = collections.defaultdict(float)
        launched = sorted(
            (launch_ts[e["args"]["correlation"]], e.get("dur", 0))
            for e in device
            if e.get("args", {}).get("correlation") in launch_ts)
        for names, (_, dur) in zip(
                _covering(spans, [ts for ts, _ in launched]), launched):
            for name in names:
                dev_us[name] += dur
        idle_us = collections.defaultdict(float)
        gaps = _gaps([(e["ts"], e["ts"] + e.get("dur", 0)) for e in device],
                     host)[3]
        for names, (a, b) in zip(
                _covering(spans, [(a + b) / 2 for a, b in gaps]), gaps):
            for name in names:
                idle_us[name] += b - a
    per = lambda us: us / 1e3 / n_steps
    return [(name, count[name] / n_steps, per(self_us[name]),
             None if dev_us is None else per(dev_us[name]),
             None if idle_us is None else per(idle_us[name]))
            for name in sorted(count)]


def print_tables(agg, out=print):
    """The JAX tool's two tables, in its format."""
    out("\n== total X-event ms by process track ==")
    for k, v in agg["tracks"]:
        out(f"  {v:10.1f} ms  {k}")
    n = agg["n_steps"]
    out(f"\n== device ops over {n} steps (ms total / ms per step) ==")
    for name, v, count in agg["ops"]:
        out(f"  {v:9.1f} ms  {v / n:7.2f} ms/step  x{count:<6d} {name}")


def print_idle(dev, n_steps, out=print):
    """The device's idle figures (``aggregate``'s ``device``)."""
    out(f"\n== device idle over {n_steps} steps ==")
    out(f"  window {dev['window_ms']:.1f} ms ({dev['window_ms'] / n_steps:.2f}"
        f" ms/step), busy {dev['busy_ms']:.1f} ms (union over streams; "
        f"{dev['device_ms']:.1f} ms summed over {dev['n_events']} events), "
        f"idle share "
        f"{dev['idle_share']:.4f}, {dev['n_gaps']} gaps")
    out(f"  the {len(dev['gaps'])} longest idle gaps (ms, host op):")
    for ms, name in dev["gaps"]:
        out(f"  {ms:9.3f} ms  {name[:110]}")
    out("  idle ms per step by host op (gaps):")
    for name, ms, count in dev["idle_by_host_op"]:
        out(f"  {ms:9.3f} ms/step  x{count:<6d} {name[:110]}")


def print_spans(rows, n_steps, out=print):
    """``span_table``'s rows."""
    out(f"\n== program spans over {n_steps} steps (a step: count, host self "
        "ms, device ms launched under it, idle ms under it) ==")
    if not rows:
        out("  (no program span in the trace)")
        return
    out(f"  {'count':>9}  {'self ms':>12}  {'device ms':>12}  "
        f"{'idle ms':>12}  span")
    for name, n, self_ms, dev_ms, idle_ms in rows:
        cells = [f"{v:12.3f}" if v is not None else "not measured"
                 for v in (self_ms, dev_ms, idle_ms)]
        out(f"  {n:9.2f}  " + "  ".join(cells) + f"  {name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--segs", type=int, default=2, help="segments to trace")
    ap.add_argument("--start-seg", type=int, default=6,
                    help=f"first traced segment ({SEG} steps each)")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; without "
                         "one the tool raises)")
    args = ap.parse_args(argv)

    device = admm.resolve_device("cpu" if args.cpu else "cuda")
    print(card_line() if device.type == "cuda" else "device cpu")
    engine, noise = flagship_engine(args.batch, device)
    prof = profile(engine, noise, start_seg=args.start_seg, segs=args.segs,
                   log_dir=tempfile.mkdtemp(prefix="profile_step_"))
    n = prof.n_steps
    around = prof.seg_ms[max(args.start_seg - 1, 0):args.start_seg] + \
        prof.seg_ms[args.start_seg + args.segs:][:1]
    print(f"trace {prof.path}: {len(prof.events)} events, stopped, written "
          f"and read in {prof.trace_s:.1f} s; on the host's clock the traced "
          f"window ran {prof.wall_s * 1e3 / n:.2f} ms/step, the untraced "
          f"segments beside it " + " and ".join(f"{v:.2f}" for v in around)
          + " ms/step")
    agg = aggregate(prof.events, n, args.top)
    print_tables(agg)
    print_spans(span_table(prof.events, n), n)
    if agg["device"] is None:
        if device.type == "cuda":
            print("NO DEVICE EVENT IN THE TRACE: the profiler saw no kernel "
                  "on the card")
            return 1
        print("\n(no device events: a CPU run)")
        return 0
    print_idle(agg["device"], n)
    print("\n== hand-written kernels: wrapper launches / trace events ==")
    missed = 0
    for name, (_, symbol, _) in KERNELS.items():
        seen = kernel_events(prof.events, symbol)
        print(f"  {name}: {prof.launches[name]} / {seen}")
        missed += seen != prof.launches[name]
    print("  solve.chunk spans: " + str(sum(
        1 for e in prof.events if e.get("ph") == "X"
        and e.get("cat") == SPAN_CAT and e.get("name") == "solve.chunk")))
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
