"""The program's spans in the traced span: which layer each idle gap of the
device and each device event's launch falls in.

The program marks its layers with ``torch.profiler.record_function``
(``mpc_arpo_project_tpu_torch/utils/timing.py::span``), which the trace
holds as host events of the category ``user_annotation``, on the clock of
the device's events. A step is a ``loop.step`` span (``loop.tick`` on the
continuous loop); its solve is a ``solve`` span inside it, and every span
of the solve (``solve.*``, ``kernel.eig_chunk``) lies inside that. So a
moment of the trace falls in one of three parts:

* ``solve``: inside a ``solve`` span;
* ``step``: inside a ``loop.*`` span, outside every ``solve`` span;
* ``outside``: outside every ``loop.*`` span (the harness's callback
  between steps, the profiler's start and stop).

An idle gap of the device falls where its midpoint falls; a device event
(kernel, copy or set) where the host call that launched it (the
``cuda_runtime`` or ``cuda_driver`` event of the same ``correlation``)
started, and ``outside`` where the trace holds no such call. The gaps and
the window are ``arpobench.trace``'s, so the parts of the idle sum to its
idle; the device events are those of ``trace.aggregate``'s ``device_ms``.
A trace without a ``loop.*`` span (a program without the spans) has no
parts: every function below returns None for it.
"""

from __future__ import annotations

import bisect

from arpobench import trace

SPAN_CAT = "user_annotation"
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# the hand-written kernels, which the glue metrics leave out
HAND_KERNELS = ("eig_chunk_kernel", "rk4_tick_kernel")
PARTS = ("solve", "step", "outside")


def _merged(intervals):
    """The union of (start, end) intervals as sorted disjoint starts and
    ends."""
    starts, ends = [], []
    for s, e in sorted(intervals):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], e)
        else:
            starts.append(s)
            ends.append(e)
    return starts, ends


def _inside(union, p) -> bool:
    starts, ends = union
    i = bisect.bisect_right(starts, p) - 1
    return i >= 0 and p <= ends[i]


def program_spans(events):
    """(start, end, name) of the trace's program spans, in microseconds."""
    return [(e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
            for e in events
            if e.get("ph") == "X" and e.get("cat") == SPAN_CAT]


def count(events, name):
    """The number of spans called ``name``, or None without loop spans."""
    spans = program_spans(events)
    if not any(n.startswith("loop.") for _, _, n in spans):
        return None
    return sum(1 for _, _, n in spans if n == name)


def _classifier(events):
    """A function from a moment of the trace to its part, or None without
    loop spans."""
    spans = program_spans(events)
    loops = [(s, e) for s, e, n in spans if n.startswith("loop.")]
    if not loops:
        return None
    solve = _merged([(s, e) for s, e, n in spans if n == "solve"])
    loop = _merged(loops)

    def part(p):
        if _inside(solve, p):
            return "solve"
        return "step" if _inside(loop, p) else "outside"

    return part


def gaps(events):
    """The device's idle gaps (start, end) in microseconds over the window
    of ``trace._idle``: the earliest start to the latest end of the
    program's host and device events."""
    device, host = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, end = e["ts"], e["ts"] + e.get("dur", 0)
        if e.get("cat") in trace.DEVICE_CATS:
            device.append((ts, end))
        elif e.get("cat") not in trace.NOT_HOST_CATS:
            host.append((ts, end))
    if not device:
        return []
    t0 = min(s for s, _ in device + host)
    t1 = max(e for _, e in device + host)
    out, edge = [], t0
    for s, e in sorted(device):
        if s > edge:
            out.append((edge, s))
        edge = max(edge, e)
    if t1 > edge:
        out.append((edge, t1))
    return out


def idle_ms(events):
    """{part: idle ms} of the trace's device idle, or None without loop
    spans or device events."""
    part = _classifier(events)
    if part is None or not any(e.get("cat") in trace.DEVICE_CATS
                               for e in events):
        return None
    out = dict.fromkeys(PARTS, 0.0)
    for a, b in gaps(events):
        out[part((a + b) / 2)] += (b - a) / 1e3
    return out


def glue_ms(events):
    """{part: device ms} of the device's events other than the
    hand-written kernels, by where each was launched; None without loop
    spans or device events."""
    part = _classifier(events)
    device = [e for e in events if e.get("ph") == "X"
              and e.get("cat") in trace.DEVICE_CATS]
    if part is None or not device:
        return None
    launched = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            c = (e.get("args") or {}).get("correlation")
            if c is not None:
                launched[c] = e["ts"]
    out = dict.fromkeys(PARTS, 0.0)
    for e in device:
        if e.get("cat") == "kernel" and any(
                k in e.get("name", "") for k in HAND_KERNELS):
            continue
        ts = launched.get((e.get("args") or {}).get("correlation"))
        out["outside" if ts is None else part(ts)] += e.get("dur", 0) / 1e3
    return out
