"""The system under test, driven as a Monte-Carlo study: engines built from a
configuration file, inputs made from the seed, and the window's batches.

The program (``mpc_arpo_project_tpu_torch``) is reached only through its
public entries: the configuration objects, ``build_engine`` and
``rollout_chunked`` of ``rollout.discrete`` or ``rollout.continuous`` with
``seg=1`` and a ``progress`` callback, and the launch counters of its two
hand-written kernels. The harness makes the inputs (the noise of every
scenario, from the seed, on the engine's device) and hands them over.

One window runs whole batches of the cell's B scenarios over the cut
horizon, back to back, and ends at the first control-step boundary after
``seconds``. The scenarios come from a pool fixed by the traffic file
(``pool_batches`` batches of draws from ``POOL_SEED``); the run's seed
orders the pool's batches and the scenarios within each, so every seed runs
the same work in another order, and a window of whole batches covers the
same scenarios whatever its seed. The callback records, at every step
boundary, a CUDA event on the current stream (no synchronisation; the chunk
loop's own host read keeps the stream at most a chunk behind the host), a
reference to the step's alive mask and applied control (counted once the
window has closed), and the carries of ``SAMPLE_ROWS`` rows drawn from the
seed for the correctness check: one ``torch.cat`` of the fields and one
``index_select`` a step, the harness's only device work in the window.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import (
    Debris, FailsafeParams, MPCParams, Noise, SimConditions)
from mpc_arpo_project_tpu_torch.ops import admm, admm_eig, rk4_tick
from mpc_arpo_project_tpu_torch.rollout import continuous, discrete

# the carry fields kept for the sampled rows, and the solver's iterates
FIELDS = ("x_true", "xest", "xest_stored", "P", "xintf", "prev_u", "l", "u",
          "c1", "c2", "s", "alive", "succ")
ITERATES = ("xbar", "ybar", "zbar")
SAMPLE_ROWS = 8  # rows of each batch the check samples
POOL_SEED = 20261018  # the seed of every traffic's pool of scenarios
WARMUP_STEPS = 4
# launch counters of the hand-written kernels
COUNTERS = {"eig_chunk": admm_eig.eig_chunk, "rk4_tick": rk4_tick.rk4_tick}


class WindowClosed(Exception):
    """Raised from the progress callback where a run stops a batch."""


def seed_of(seed: int, *parts: int) -> int:
    """A 63-bit generator seed for ``parts`` of the run seeded ``seed``."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64,
                                 *(int(p) % 2 ** 32 for p in parts)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def sim_conditions(cfg: dict, horizon_s: float) -> SimConditions:
    s = cfg["sim"]
    t_cont = s["T_cont"]
    return SimConditions(
        np.asarray(s["x0"], float), np.asarray(s["xr"], float), s["r_p"],
        s["los_ang"], s["r_tol"], s["mean_mtn"], s["time_stp"], s["isReject"],
        tuple(s["suc_cond"]), Noise(tuple(s["noise_std"]), s["noise_length"]),
        s["inTrack"], T_cont=float("nan") if t_cont is None else t_cont,
        T_final=horizon_s, isDeltaV=s["isDeltaV"])


def settings(cfg: dict) -> admm.ADMMSettings:
    so = dict(cfg["solver"])
    so["eig_compact_chunks"] = tuple(so["eig_compact_chunks"])
    return admm.ADMMSettings(**so)


def build_engine(cfg: dict, horizon_s: float, device):
    """The program's engine for configuration ``cfg`` at ``horizon_s``."""
    m, f, d = cfg["mpc"], cfg["failsafe"], cfg["debris"]
    mpc = MPCParams(np.diag(m["Q_state_diag"]), np.diag(m["R_input_diag"]),
                    np.diag(m["R_slack_diag"]), np.asarray(m["V_ecr"], float),
                    dict(m["horizons"]), tuple(m["u_lim"]))
    fail = FailsafeParams(np.diag(f["Q_fail_diag"]),
                          np.diag(f["R_fail_diag"]),
                          np.asarray(f["C_int"], float),
                          np.asarray(f["K_dead"], float))
    debris = Debris(tuple(d["center"]), d["side_length"],
                    d["detect_distance"])
    dtype = getattr(torch, cfg["dtype"])
    sim = sim_conditions(cfg, horizon_s)
    if cfg["loop"] == "continuous":
        return continuous.build_engine(
            sim, mpc, fail, debris, settings=settings(cfg), dtype=dtype,
            noise_convention=cfg["noise_convention"], device=device)
    return discrete.build_engine(sim, mpc, fail, debris,
                                 settings=settings(cfg), dtype=dtype,
                                 device=device)


class Shape(NamedTuple):
    """What the harness needs to know of one cell's rollout."""

    loop: str
    batch: int
    n_steps: int  # control steps (ticks) a batch runs
    n_draws: int
    draw_dim: int
    dtype: torch.dtype


def shape_of(cfg: dict, traffic: dict) -> Shape:
    s = cfg["sim"]
    T, hold = s["time_stp"], s["noise_length"]
    steps = int(traffic["horizon_s"] / T)
    if cfg["loop"] == "continuous":
        n_sub = int(round(T / s["T_cont"]))
        n_draws = steps * n_sub // (hold * n_sub) + 2
        return Shape("continuous", traffic["batch"], steps - 1, n_draws, 2,
                     getattr(torch, cfg["dtype"]))
    return Shape("discrete", traffic["batch"], steps, steps // hold + 2, 4,
                 getattr(torch, cfg["dtype"]))


def make_draws(shape: Shape, seed: int, part: int, device) -> torch.Tensor:
    """Standard-normal draws of one batch, (n_draws, B, draw_dim), from a
    generator on ``device`` seeded by (seed, part)."""
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, part))
    return torch.randn((shape.n_draws, shape.batch, shape.draw_dim),
                       generator=gen, dtype=shape.dtype, device=device)


def pool_draws(traffic: dict, shape: Shape, seed: int, batch_index: int,
               device):
    """(pool batch, draws) of the window's batch ``batch_index``: the pool
    batch the seed's order puts there, its scenarios shuffled by (seed,
    batch index)."""
    order = np.random.default_rng(seed_of(seed, 2 ** 31 + 3)).permutation(
        traffic["pool_batches"])
    k = int(order[batch_index % len(order)])
    draws = make_draws(shape, POOL_SEED, k, device)
    gen = torch.Generator(device=device).manual_seed(
        seed_of(seed, batch_index, 5))
    perm = torch.randperm(shape.batch, generator=gen, device=device)
    return k, draws[:, perm].contiguous()


def program_inputs(cfg: dict, shape: Shape, draws: torch.Tensor):
    """What the rollout takes: for the discrete loop the (T, B, 4) held noise
    (each draw scaled by (sigma_x, sigma_y, 0, 0) and held ``noise_length``
    steps); for the continuous loop the draws scaled by the Brownian
    per-substep sigma_x * sqrt(T_cont), on both axes."""
    s = cfg["sim"]
    if shape.loop == "continuous":
        return draws * (s["noise_std"][0] * math.sqrt(s["T_cont"]))
    sig = torch.tensor([s["noise_std"][0], s["noise_std"][1], 0.0, 0.0],
                       dtype=draws.dtype, device=draws.device)
    idx = torch.arange(shape.n_steps, device=draws.device) // s["noise_length"]
    return (draws * sig)[idx]


def rollout(engine, shape: Shape, inputs, progress):
    mod = continuous if shape.loop == "continuous" else discrete
    return mod.rollout_chunked(engine, inputs, seg=1, progress=progress)


def launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def record(carry) -> list:
    """The tensors of ``carry`` that the check reads, in the order of
    ``FIELDS`` and ``ITERATES``."""
    st = carry.admm_state
    return [getattr(carry, f) for f in FIELDS] + [getattr(st, f)
                                                   for f in ITERATES]


class Batch(NamedTuple):
    """One batch of the window: its index, its pool batch, the draws it ran
    on, the sampled rows, their records after each completed step (steps,
    R, columns: ``record``'s tensors flattened side by side, in float) with
    each tensor's trailing shape, the steps completed, and the rollout's
    outputs where the batch completed (else None)."""

    index: int
    pool: int  # the pool batch it ran
    draws: torch.Tensor
    rows: np.ndarray
    carries: Optional[torch.Tensor]
    layout: list  # (name, trailing shape) of each recorded tensor
    steps: int
    out: Optional[object]


class Window(NamedTuple):
    seconds: float  # the window's length on the host's clock
    step_ms: np.ndarray  # every completed step's time
    alive_solves: int  # alive solves of every completed step
    nonfinite: int  # alive solves whose control was not finite
    batches: list
    trace: Optional[dict]  # what the traced span recorded
    raised: Optional[str]  # the traceback where the program raised


def run_window(engine, cfg: dict, traffic: dict, shape: Shape, seed: int,
               seconds: float, device, trace_steps=None,
               tracer: Optional[Callable] = None) -> Window:
    """The measured window; see the module's docstring. ``trace_steps``
    (lo, hi) with ``tracer`` (a context manager factory) traces steps
    [lo, hi) of the first batch; the time the tracer takes to stop and hand
    back its trace is kept out of the window."""
    cuda = device.type == "cuda"
    stamps = []  # CUDA events, or host times on the CPU

    def stamp():
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            stamps.append(ev)
        else:
            stamps.append(time.perf_counter())

    # per step: the mask of the scenarios that solved, and the applied
    # control (references: the program makes new tensors every step)
    solving, applied = [], []
    batches, trace = [], {}
    raised = None
    t0 = time.perf_counter()
    state = dict(deadline=t0 + seconds, closed=False, paused=0.0)
    stamp()
    b = 0
    n_rows = min(SAMPLE_ROWS, shape.batch)
    try:
        while not state["closed"]:
            pool, draws = pool_draws(traffic, shape, seed, b, device)
            inputs = program_inputs(cfg, shape, draws)
            rng = np.random.default_rng(seed_of(seed, b, 1))
            rows = np.sort(rng.choice(shape.batch, n_rows, replace=False))
            rows_t = torch.as_tensor(rows, device=device)
            rec, layout = [], []
            done_steps = [0]
            entering = [torch.ones(shape.batch, dtype=torch.bool,
                                   device=device)]
            stack = contextlib.ExitStack()

            def progress(done, total, carry, b=b, rec=rec, layout=layout,
                         rows_t=rows_t, done_steps=done_steps,
                         entering=entering, stack=stack):
                stamp()
                # the solves of this step: those alive while it solved
                solving.append(carry.alive if shape.loop == "discrete"
                               else entering[0])
                applied.append(carry.prev_u)
                entering[0] = carry.alive
                parts = record(carry)
                if not layout:
                    layout.extend((f, tuple(t.shape[1:])) for f, t in
                                  zip(FIELDS + ITERATES, parts))
                rec.append(torch.cat(
                    [t.reshape(t.shape[0], -1).to(shape.dtype)
                     for t in parts], 1).index_select(0, rows_t))
                done_steps[0] += 1
                if tracer is not None and b == 0 and trace_steps is not None:
                    if done_steps[0] == trace_steps[0]:
                        _sync(device)
                        trace["launches0"] = launches()
                        trace["reader"] = stack.enter_context(tracer())
                    elif done_steps[0] == trace_steps[1] and "reader" in trace:
                        _sync(device)
                        trace["launches"] = {
                            k: v - trace["launches0"][k]
                            for k, v in launches().items()}
                        t_stop = time.perf_counter()
                        stack.close()  # stops the profiler, reads its trace
                        trace["events"] = trace["reader"].events
                        paused = time.perf_counter() - t_stop
                        state["paused"] += paused
                        state["deadline"] += paused
                        trace["read_s"] = paused
                        trace["n_steps"] = trace_steps[1] - trace_steps[0]
                if (time.perf_counter() >= state["deadline"]
                        and done < total):
                    state["closed"] = True
                    raise WindowClosed

            out = None
            try:
                with stack:
                    out = rollout(engine, shape, inputs, progress)
            except WindowClosed:
                pass
            batches.append(Batch(b, pool, draws, rows,
                                 torch.stack(rec) if rec else None,
                                 list(layout), done_steps[0], out))
            if time.perf_counter() >= state["deadline"]:
                state["closed"] = True
            b += 1
    except Exception:  # the program raised: the run is reported as failed
        import traceback

        raised = traceback.format_exc()
    _sync(device)
    window_s = time.perf_counter() - t0 - state["paused"]
    if cuda:
        step_ms = np.array([a.elapsed_time(z) for a, z in
                            zip(stamps[:-1], stamps[1:])])
    else:
        step_ms = np.diff(np.array(stamps)) * 1e3
    n_alive = n_nonfinite = 0
    if solving:
        sv = torch.stack(solving)
        bad = sv & ~torch.isfinite(torch.stack(applied)).all(2)
        n_alive, n_nonfinite = torch.stack([sv.sum(), bad.sum()]).tolist()
    return Window(window_s, step_ms, int(n_alive), int(n_nonfinite), batches,
                  trace or None, raised)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def warm_up(engine, cfg: dict, shape: Shape, seed: int, steps: int, device):
    """This cell's shapes before the window: a batch at the cell's B on
    draws of its own, stopped after ``steps`` steps."""
    draws = make_draws(shape, seed, 2 ** 31, device)
    inputs = program_inputs(cfg, shape, draws)

    def progress(done, total, carry):
        if done >= steps:
            raise WindowClosed

    try:
        rollout(engine, shape, inputs, progress)
    except WindowClosed:
        pass
    _sync(device)
