"""The flagship measurement on the port: prints ONE JSON line.

    python -m mpc_arpo_project_tpu_torch.bench

Counterpart of the repository's ``bench.py`` (JAX on a TPU), on PyTorch and
the CUDA kernels of this package: batched horizon-50 CW MPC solves per
second on one card, measured end to end in the closed loop (every solve
includes the warm-started ADMM QP, failsafe switching, plant step, UKF
update and dynamic constraint rebuild), counting only the steps of
scenarios still alive. ``vs_baseline`` is against 10,000 solves/s.

The same configuration, knobs (``BENCH_*``, with bench.py's names and
defaults) and passes: a first pass (on the port, the nvcc build of the
kernels the path launches plus a run), the timed pass on fresh noise, and
the latency pass with a device sync every ``BENCH_LAT_SEG`` steps (skipped
with ``BENCH_QUICK=1``). Diagnostics go to stderr; the single stdout line
has bench.py's keys, plus ``extras.backend``, ``extras.dtype`` and
``extras.device`` (the card's name and power limit, as nvidia-smi gives
them). The engine is fp32 in every solve mode, as bench.py builds it.

There is no fallback: without a CUDA device, or on any exception, it
prints the traceback and exits non-zero. Only ``run(..., device="cpu")``
runs on the CPU (the tests call it).
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import (
    Debris, FailsafeParams, MPCParams, Noise, SimConditions)
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.rollout import discrete

METRIC = "closed_loop_mpc_alive_solves_per_sec_chip_h50"
BASELINE_SOLVES_PER_S = 10000.0
STATUS_NAMES = {0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER", 3: "PINF",
                4: "DINF"}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def flagship_parts(Nx=50):
    """MPC weights (horizon ``Nx``), failsafe gains and the debris box of the
    flagship (``bench.py:50-75``): radial approach, offset-free, debris."""
    v_ecr = 50000.0 * np.ones(5)
    v_ecr[-2] *= -1
    v_ecr[-1] = 0.0
    mpc = MPCParams(
        8e2 * np.diag([0.2 ** 2, 10 ** 2, 3.8 ** 2, 900.0]),
        1000 ** 2 * np.eye(2), 5 ** 2 * np.eye(5), v_ecr,
        {"Nx": Nx, "Nc": 5, "Nb": 5}, (0.2, 0.2))
    fail = FailsafeParams(
        0.005 * np.diag([0.0001, 1, 100000.0, 1.0, 0.01]), 100 * np.eye(2),
        np.eye(1, 4), np.zeros((2, 2)))
    return mpc, fail, Debris((40.0, 0.0), 5.0, 20.0)


def flagship_sim(T_final, sigma=0.75):
    """The flagship scenario (``bench.py:76-89``): radial approach from
    (100, 10), noise ``sigma`` held 50 steps, ``T_final`` seconds of 0.5 s
    control steps."""
    return SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
        2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0),
        Noise((sigma, sigma), 50), False, T_final=T_final)


def bench_settings(env=os.environ) -> admm.ADMMSettings:
    """The production solver profile from the ``BENCH_*`` knobs of ``env``
    (``bench.py:94-128``; 'eig' by default). The stall windows are counted
    in chunks, so they are scaled by ``check_every / 25`` to stay constant
    in iterations."""
    check_every = int(env.get("BENCH_CHECK_EVERY", "25"))
    scale = check_every / 25
    return admm.ADMMSettings(
        max_iter=int(env.get("BENCH_MAX_ITER", "4000")),
        solve_mode=env.get("BENCH_SOLVE_MODE", "eig"),
        check_every=check_every,
        stall_exit_chunks=max(1, round(int(env.get("BENCH_STALL", "12"))
                                       / scale)),
        stall_tighten_chunks=max(1, round(int(env.get("BENCH_TIGHTEN", "24"))
                                          / scale)),
        adaptive_rho=env.get("BENCH_ADAPTIVE_RHO", "1") == "1",
        ns_refresh_drift=float(env.get("BENCH_NS_DRIFT", "0.02")),
        ir_steps=int(env.get("BENCH_IR", "1")),
        pallas_tile=int(env.get("BENCH_TILE", "32")),
        eig_tail_mult=int(env.get("BENCH_TAIL_MULT", "1")),
        eig_refresh_cap_div=int(env.get("BENCH_REFRESH_DIV", "32")),
        eig_apply=env.get("BENCH_APPLY", "loop"),
        eig_deb_equil_smax=float(env.get("BENCH_SMAX", "32")),
        eig_warm_iters=int(env.get("BENCH_WARM_ITERS", "3")),
        eig_cold_iters=int(env.get("BENCH_COLD_ITERS", "30")),
        eig_compact_chunks=tuple(
            int(v) for v in env.get("BENCH_COMPACT", "2,4,8,16,24").split(",")
            if v),
    )


class BenchRun(NamedTuple):
    """What ``run`` measured: the engine, the timed pass's output and wall
    time, the latency pass's per-segment times (empty when quick), the
    first pass's wall time (None when skipped), the engine build's and the
    peak device memory (None on the CPU)."""

    engine: discrete.DiscreteEngine
    out: discrete.RolloutOut
    wall: float
    seg_times: list
    build_and_first_s: Optional[float]
    engine_build_s: float
    max_memory_allocated_bytes: Optional[int]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _noise(engine, B, seed):
    """The (T, B, 4) noise of one pass, from a generator on the engine's
    device seeded with ``seed`` (bench.py's ``key`` or ``fold_in(key, k)``
    is ``seed + k`` here)."""
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noise = discrete.make_noise_sequence(engine, gen, B)
    _sync(engine.device)
    return noise


def latency_pass(engine, noise, lat_seg):
    """The closed loop over ``noise`` with a device sync every ``lat_seg``
    steps; returns the host-clock time of each segment (``bench.py:150-174``).
    Each sync adds a host round trip, so the per-step times are an upper
    bound."""
    seg_times = []
    tprev = [time.perf_counter()]

    def progress(done, total, carry):
        _sync(engine.device)
        now = time.perf_counter()
        seg_times.append(now - tprev[0])
        tprev[0] = now

    discrete.rollout_chunked(engine, noise, seg=lat_seg, progress=progress)
    return seg_times


def run(settings, B, quick, device="cuda", seed=0, seg=10, lat_seg=1,
        first_pass=True) -> BenchRun:
    """bench.py's passes on one fp32 flagship engine (T_final 30 s when
    ``quick``, else 150 s) at batch ``B``: the first pass (kernel build
    plus run; ``first_pass=False`` skips it where the kernels are already
    built), the timed pass, and the latency pass unless ``quick``. The
    noise of the three passes comes from generators seeded ``seed``,
    ``seed + 1`` and ``seed + 2``. Raises on ``device="cuda"`` without a
    CUDA device."""
    device = admm.resolve_device(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    mpc, fail, debris = flagship_parts()
    engine = discrete.build_engine(flagship_sim(30.0 if quick else 150.0),
                                   mpc, fail, debris, settings=settings,
                                   dtype=torch.float32, device=device)
    engine_build_s = time.perf_counter() - t0
    log(f"engine build: {engine_build_s:.1f}s (nz={engine.dims.nz} "
        f"m={engine.dims.m}; padded {engine.prob.Pbar.shape[0]} x "
        f"{engine.prob.A0bar.shape[0]}) T={engine.nsim} steps")

    build_and_first_s = None
    if first_pass:
        noise = _noise(engine, B, seed)
        t0 = time.perf_counter()
        discrete.rollout_chunked(
            engine, noise, seg=seg,
            progress=lambda done, total, carry: log(
                f"  segment {done}/{total}"))
        _sync(device)
        build_and_first_s = time.perf_counter() - t0
        log(f"first call (kernel build + run): {build_and_first_s:.1f}s")

    noise = _noise(engine, B, seed + 1)
    t0 = time.perf_counter()
    out = discrete.rollout_chunked(engine, noise, seg=seg)
    _sync(device)
    wall = time.perf_counter() - t0

    seg_times = []
    if not quick:
        seg_times = latency_pass(engine, _noise(engine, B, seed + 2), lat_seg)
    peak = (torch.cuda.max_memory_allocated(device) if device.type == "cuda"
            else None)
    return BenchRun(engine, out, wall, seg_times, build_and_first_s,
                    engine_build_s, peak)


def summarize(out, engine, B, wall, seg_times, lat_seg=1) -> dict:
    """bench.py's metrics (``bench.py:176-222``) of a timed pass's output,
    reduced in numpy: alive steps (``ctrl_seq > 0``), the status histogram
    and mix over alive steps, ``done_iters`` p50/p90/p99/max per status,
    the success rate, the mean ADMM iterations a step, and the p50/p95
    step latency (from ``seg_times`` over ``lat_seg`` steps each, else the
    timed pass's mean)."""
    status = out.status.cpu().numpy()
    alive = out.ctrl_seq.cpu().numpy() > 0
    done_iters = out.done_iters.cpu().numpy()
    alive_steps = int(alive.sum())
    total_steps = engine.nsim * B
    hist = {name: int((status[alive] == code).sum())
            for code, name in STATUS_NAMES.items()}
    effort = {}
    for code in (1, 2, 3):
        sel = done_iters[(status == code) & alive]
        if sel.size:
            q = np.percentile(sel, [50, 90, 99])
            effort[STATUS_NAMES[code]] = dict(
                p50=float(q[0]), p90=float(q[1]), p99=float(q[2]),
                max=int(sel.max()), n=int(sel.size))
    if seg_times:
        per_step = np.asarray(seg_times) / lat_seg * 1000.0
        p50, p95 = (float(v) for v in np.percentile(per_step, [50, 95]))
    else:
        p50 = p95 = wall / engine.nsim * 1000.0
    return dict(
        wall_s=wall, steps=engine.nsim, batch=B, total_steps=total_steps,
        alive_steps=alive_steps, solves_per_sec=alive_steps / wall,
        raw_steps_per_sec=total_steps / wall, status_hist=hist,
        status_mix_alive={k: round(v / max(alive_steps, 1), 4)
                          for k, v in hist.items()},
        done_iters=effort,
        success_rate=float(out.success.cpu().numpy().mean()),
        mean_admm_iters_per_step=float(out.iters.cpu().numpy().mean()),
        p50_step_ms=p50, p95_step_ms=p95, latency_sync_every_steps=lat_seg)


def report(summary, settings, **extras) -> dict:
    """The stdout line: bench.py's keys (``bench.py:225-252``) from
    ``summary``, with ``extras`` added to its ``extras``."""
    sps = summary["solves_per_sec"]
    return {
        "metric": METRIC,
        "value": round(sps, 1),
        "unit": "solves/s/chip",
        "vs_baseline": round(sps / BASELINE_SOLVES_PER_S, 3),
        "extras": {
            "raw_steps_per_sec": round(summary["raw_steps_per_sec"], 1),
            "success_rate": round(summary["success_rate"], 4),
            "mean_admm_iters_per_step": round(
                summary["mean_admm_iters_per_step"], 1),
            "status_mix_alive": summary["status_mix_alive"],
            "p50_step_ms": round(summary["p50_step_ms"], 2),
            "p95_step_ms": round(summary["p95_step_ms"], 2),
            "latency_sync_every_steps": summary["latency_sync_every_steps"],
            "batch": summary["batch"],
            "solver": {
                "solve_mode": settings.solve_mode,
                "max_iter": settings.max_iter,
                "check_every": settings.check_every,
                "stall_exit_chunks": settings.stall_exit_chunks,
                "stall_tighten_chunks": settings.stall_tighten_chunks,
                "tile": settings.pallas_tile,
            },
            **extras,
        },
    }


def main(env=os.environ) -> int:
    from mpc_arpo_project_tpu_torch.tools.kernel_probe import card_line

    device = admm.resolve_device("cuda")
    # full-precision fp32 products: TF32 shows up as extra MAX_ITER exits
    torch.set_float32_matmul_precision("highest")
    quick = env.get("BENCH_QUICK") == "1"
    B = int(env.get("BENCH_BATCH", "64" if quick else "1024"))
    seg = int(env.get("BENCH_SEG", "10"))
    lat_seg = int(env.get("BENCH_LAT_SEG", "1"))
    settings = bench_settings(env)
    card = card_line()
    log(f"bench: device={card} batch={B} horizon Nx=50 "
        f"solve_mode={settings.solve_mode} fp32")

    r = run(settings, B, quick, device, seed=0, seg=seg, lat_seg=lat_seg)
    s = summarize(r.out, r.engine, B, r.wall, r.seg_times, lat_seg)
    for name, q in s["done_iters"].items():
        log(f"  done_iters[{name}]: p50={q['p50']:.0f} p90={q['p90']:.0f} "
            f"p99={q['p99']:.0f} max={q['max']} n={q['n']}")
    log(f"wall={s['wall_s']:.2f}s steps={s['total_steps']} "
        f"alive={s['alive_steps']} success_rate={s['success_rate']:.3f} "
        f"mean_admm_iters/step={s['mean_admm_iters_per_step']:.0f}")
    log(f"status mix (fraction of alive steps): {s['status_mix_alive']}")
    log(f"step latency (batch={B}, per-{lat_seg}-step sync): "
        f"p50={s['p50_step_ms']:.1f}ms p95={s['p95_step_ms']:.1f}ms "
        f"(real-time budget 500ms/step: "
        f"{'MET' if s['p95_step_ms'] <= 500 else 'NOT met'} at this batch)")
    log(f"honest alive-solves/s/chip: {s['solves_per_sec']:,.0f} "
        f"(raw steps/s incl. dead: {s['raw_steps_per_sec']:,.0f})")
    print(json.dumps(report(
        s, settings, backend="torch", dtype="float32", device=card,
        steps=s["steps"], alive_steps=s["alive_steps"],
        status_hist_alive=s["status_hist"], done_iters=s["done_iters"],
        wall_s=r.wall, build_and_first_s=r.build_and_first_s,
        engine_build_s=r.engine_build_s,
        max_memory_allocated_bytes=r.max_memory_allocated_bytes,
        bench_apply=f"BENCH_APPLY={settings.eig_apply} has no effect in the "
                    "port: its CUDA kernel has one layout of the product "
                    "a·T⁻¹ (ops/admm.py, ADMMSettings)")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
