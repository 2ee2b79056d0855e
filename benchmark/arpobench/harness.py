"""One run of one cell: set-up, the measured window, the check, one line.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

Set-up (``setup_s``) is everything from the process's start to the window:
the imports, the engine's build (host synthesis, equilibration, the solver's
precomputation), the kernels (built by nvcc into the program's ``build/``
on a checkout's first run, loaded from there after), and a warm-up batch at
the cell's B, a few steps long, on draws of its own. The window then runs
the study (``arpobench.study``). Once it has closed, the peak device memory
is read, the program's state freed, and the reference
(``arpobench.reference``) checks the sampled steps.

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics;
with ``--trace 1`` a fixed span of steps of the first batch is traced
(``arpobench.trace``) and the metrics are the per-layer ones that find
something to read (``benchmark/metrics/``). ``--control`` also runs the
precision control in the program's place on the same samples and adds its
readings to the line (the benchmark's own runs do not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple, Optional

import numpy as np

from arpobench import counts

BANNED = ("jax", "jaxlib", "flax", "mpc_arpo_project_tpu")
CONTROL_SAMPLES = 128  # steps the precision control is read on


def banned_modules() -> list:
    """The modules loaded whose top-level name, compared whole, is banned."""
    return sorted(n for n in list(sys.modules)
                  if n.split(".", 1)[0] in BANNED)


class RunView(NamedTuple):
    """What a per-layer metric reads: the engine's sizes, the traced span (``trace``: events' ``agg`` from ``trace.aggregate``,
    ``n_steps``, ``launches`` over the span, ``span_done``: the
    iterations of the span's alive solves, or None where the first batch
    did not complete), and the whole batches' alive solves (their
    ``status`` and ``done_iters``)."""

    sizes: dict
    trace: Optional[dict]
    status: np.ndarray
    done_iters: np.ndarray


def engine_sizes(engine, cfg: dict) -> dict:
    """The sizes of the program's 'eig' solve that the operation count
    takes: padded constraint rows and variables, Woodbury rank, s-part
    width."""
    prob = (engine.base if cfg["loop"] == "continuous" else engine).prob
    if prob.eig_YT is None:
        return {}
    return dict(m=int(prob.A0bar.shape[0]), nz=int(prob.Pbar.shape[0]),
                K=int(prob.eig_YT.shape[1]), gw=int(prob.gsel.shape[1] // 3))


def whole_batch_solves(window):
    """(status, done_iters) of every alive solve of the window's whole
    batches, and the success of every pool scenario they ran (a pool batch
    that came round again counted once)."""
    st, di, sc, seen = [], [], [], set()
    for b in window.batches:
        if b.out is None:
            continue
        alive = counts.alive_mask(b.out.ctrl_seq.cpu().numpy())
        st.append(b.out.status.cpu().numpy()[alive])
        di.append(b.out.done_iters.cpu().numpy()[alive])
        if b.pool not in seen:
            seen.add(b.pool)
            sc.append(b.out.success.cpu().numpy())
    cat = lambda v, dt: np.concatenate(v) if v else np.zeros(0, dt)
    return cat(st, int), cat(di, int), cat(sc, bool)


def span_done_iters(window, shape, trace_steps):
    """The iterations of the traced span's alive solves, where the first
    batch completed."""
    first = window.batches[0] if window.batches else None
    if first is None or first.out is None:
        return None
    lo, hi = trace_steps
    alive = counts.alive_mask(first.out.ctrl_seq[lo:hi].cpu().numpy())
    return first.out.done_iters[lo:hi].cpu().numpy()[alive]


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, control: bool = False, log=None):
    """Set up, measure and check one run of ``cell`` on ``device``; returns
    (line, check_lines), the result's dict and the lines that give each
    number compared beside its limit."""
    import torch

    from arpobench import cells, samples, study
    from arpobench import trace as tracing
    from arpobench.reference import compare, model

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    cfg, traffic = cell.config, cell.traffic
    torch.set_float32_matmul_precision(cfg["matmul_precision"])
    shape = study.shape_of(cfg, traffic)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    engine = study.build_engine(cfg, traffic["horizon_s"], device)
    t_warm = time.perf_counter()
    study.warm_up(engine, cfg, shape, seed, study.WARMUP_STEPS, device)
    setup_s = time.perf_counter() - t_start
    log(f"set-up {setup_s:.3f} s (imports {t_build - t_start:.3f}, engine "
        f"{t_warm - t_build:.3f}, kernels and warm-up "
        f"{t_start + setup_s - t_warm:.3f}); window {seconds} s on "
        f"{cell.name} (B={shape.batch}, {shape.n_steps} steps a batch)")

    trace_steps = tuple(traffic["trace_steps"]) if trace else None
    win = study.run_window(engine, cfg, traffic, shape, seed, seconds, device,
                           trace_steps, tracing.Tracer if trace else None)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else 0)
    status, done_iters, success = whole_batch_solves(win)
    whole = sum(b.out is not None for b in win.batches)
    log(f"window {win.seconds:.3f} s: {len(win.step_ms)} steps, "
        f"{whole} whole batches of {len(win.batches)}, "
        f"{win.alive_solves} alive solves")
    i = 0
    for b in win.batches:
        ms = win.step_ms[i:i + b.steps]
        i += b.steps
        log(f"  batch {b.index} (pool {b.pool}): {b.steps} steps, "
            f"{ms.sum() / 1e3:.3f} s, "
            f"p90 {np.percentile(ms, 90) if len(ms) else float('nan'):.1f} ms")
    if win.raised:
        log(win.raised)

    metrics, view = {}, None
    if trace:
        t = win.trace or {}
        agg = (tracing.aggregate(t["events"], t["n_steps"], 40)
               if t.get("events") else None)
        view = RunView(engine_sizes(engine, cfg),
                       dict(t, agg=agg, span_done=span_done_iters(
                           win, shape, trace_steps)) if agg else None,
                       status, done_iters)
        for name, mod in cells.metric_readers().items():
            v = mod.read(view) if view.trace else None
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
        if view.trace:
            log(f"traced steps {trace_steps}: {len(t['events'])} events, "
                f"read back in {t['read_s']:.1f} s")
            view.trace["events"] = None

    # the reference, after the window, with the program's state freed
    sc = model.Scenario(cfg)
    smp = samples.collect(cfg, shape, win, sc.initial)
    del engine
    win = win._replace(batches=[], trace=None)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    if smp is None:
        numbers = dict.fromkeys(compare.NUMBERS, float("nan"))
    else:
        numbers = compare.compare(sc, smp)
    log(f"reference: {0 if smp is None else len(smp.j)} sampled steps, "
        f"{time.perf_counter() - t_ref:.1f} s")

    failed = win.nonfinite + int((status == counts.UNSOLVED).sum()) + \
        (shape.batch if win.raised else 0)
    correct = (compare.verdict(numbers, cell.limits) and failed == 0
               and not win.raised and whole > 0)

    if not trace:
        e2e = dict(
            alive_solves_per_s=(win.alive_solves / win.seconds, "solves/s"),
            step_ms_p90=(float(np.percentile(win.step_ms, 90))
                         if len(win.step_ms) else float("nan"), "ms"),
            docked_pct=(100.0 * float(success.mean()) if success.size
                        else float("nan"), "%"),
            setup_s=(setup_s, "s"))
        metrics = {k: {"value": e2e[k][0], "unit": e2e[k][1]}
                   for k in cell.end_to_end}

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    line = {"correct": bool(correct), "attempted": int(win.alive_solves),
            "failed": int(failed), "metrics": metrics, "device": dev}
    d = view.trace["agg"]["device"] if trace and view.trace else None
    if d is not None:
        n = view.trace["n_steps"]
        dev["busy_s"] = d["busy_ms"] / 1e3
        dev["window_s"] = d["window_ms"] / 1e3
        line["breakdown"] = {
            "device_ops": [[name, ms / 1e3] for name, ms, _ in
                           view.trace["agg"]["ops"][:10]],
            "idle_gaps": [[name, ms * n / 1e3] for name, ms, _ in
                          d["idle_by_host_op"][:10]]}
    if control and smp is not None:
        # the control solves each sample's QP: a draw of them will do
        rng = np.random.default_rng(study.seed_of(seed, 2 ** 31 + 2))
        sub = np.sort(rng.choice(len(smp.j), min(len(smp.j), CONTROL_SAMPLES),
                                 replace=False))
        part = compare.Samples(
            {k: v[sub] for k, v in smp.ent.items()},
            {k: v[sub] for k, v in smp.out.items()},
            *(getattr(smp, f)[sub] for f in compare.Samples._fields[2:]))
        ctl = compare.compare(sc, compare.control_outputs(sc, part))
        line["control"] = {"correct": compare.verdict(ctl, cell.limits),
                           "readings": ctl}
        for k in compare.NUMBERS:
            log(f"control {k} {ctl[k]:.6g}")
    checks = {k: {"value": numbers[k], "limit": cell.limits[k]}
              for k in compare.NUMBERS}
    line["checks"] = checks
    check_lines = [f"check {k} {v['value']:.6g} limit {v['limit']:.6g}"
                   for k, v in checks.items()]
    return line, check_lines


def finite(v):
    """``v`` with every float that is not finite replaced by None, so that
    the line is strict JSON."""
    if isinstance(v, dict):
        return {k: finite(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [finite(x) for x in v]
    if isinstance(v, float) and not np.isfinite(v):
        return None
    return v


def main(t_start: float, argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also read the precision control on the samples")
    args = ap.parse_args(argv)

    from arpobench import cells

    cell = cells.load_cell(args.workload)
    import torch

    need = int(cell.chips)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"no result: the cell needs {need} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    # one host thread drives the card; OpenMP workers spinning beside it
    # slowed it unevenly (on an H100's 8-core host, h40 read 2,690-3,343
    # alive-solves/s with them, 3,370-3,616 without)
    torch.set_num_threads(1)
    line, check_lines = run_cell(cell, args.seed, args.seconds,
                                 bool(args.trace), device, t_start,
                                 control=args.control)
    found = banned_modules()
    if found:
        print("no result: the process holds " + ", ".join(found),
              file=sys.stderr)
        return 4
    for s in check_lines:
        print(s, file=sys.stderr, flush=True)
    print(json.dumps(finite(line), allow_nan=False), flush=True)
    return 0
