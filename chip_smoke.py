"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``mpc_arpo_project_tpu_torch`` (never JAX, nor the JAX package) on
``cuda:0``:

1. device: the card's name and power limit, torch and CUDA versions; fp32
   matmuls are pinned to full precision (no TF32);
2. build: compiles the seven CUDA libraries from ``csrc/`` with nvcc, all
   at once (one nvcc per source; the 'pallas' chunk kernel is three, by
   type and layout), and logs ptxas' register and spill lines;
3. kernels against plain, at flagship shapes (Nx=50: nz=256, m=512, B=1024)
   on real inputs of the flagship engine (the first solve, and the solve
   after five control steps), in fp32 and fp64, each timed by CUDA events
   beside its plain twin:
   - ``eig_chunk`` ('eig' engine), also on the after-5-steps chunk cut to
     11 live slots (the costliest class of the chunk census), with its
     bound and HBM floor, and a sweep of its layouts (slots per block S;
     in fp32 also a cluster of C blocks per live slot) over live counts
     (the evidence for ``admm_eig.eig_layout``);
   - ``admm_chunk``, also on a 32-row overtime lane of the after-5-steps
     call with 9 live slots (the costliest class of its chunk census),
     with its bound, and a sweep of its layouts (cluster size C, slots per
     block S) over live counts (the evidence for
     ``admm_pallas.admm_layout``); ``ns_fused`` (warm and cold, on a need
     mask that includes rows poisoned with inf and NaN; the full-width
     cold first refresh; 3 needy rows of a 32-row call, the costliest class
     of the refresh census) and ``newton_schulz_inverse`` (on the
     per-problem M of ``_build_M``) ('pallas' engine); the Newton–Schulz
     cases are timed in fp32 and fp64 beside ``torch.linalg.inv`` of the
     same M;
4. the chunk-parts probe (``tools/kernel_probe.py`` of the port) at its
   flagship shapes (B=1024, bt=32, nz=256, m=512, 25 iterations, fp32
   inputs), in each of the original's precisions ('highest', 'high',
   'default'): each of its six kernels against its twin on unit-gain
   inputs, and the bf16-rounding ones also on inputs where their
   arithmetic is exact (launch counted), then timed as the probe times it
   on the same inputs ('highest' also on the original's scales), with its
   bound at the precision's peak, the stream floor of its matrix, the
   groups the card holds at once and useful TF/s;
5. the continuous plant's tick kernel ``rk4_tick`` (500 RK4 substeps,
   B=1024, the radialC plant) against its twin on states spread over the
   approach with scenarios placed to dock and to terminate within the
   tick, both input models, telemetry on and off, fp32 and fp64; timed
   beside the twin, with its bound and the latency of one warp's chain;
6. main path 1: the flagship closed loop (radial, noisy, offset-free,
   debris; 'eig' solve, UKF) for 20 control steps at B=1024, fp32;
7. main path 2: the same closed loop in ``solve_mode='pallas'`` (the
   repository's bench configuration with ``BENCH_SOLVE_MODE=pallas``);
8. main path 3: the same closed loop in the default ``solve_mode='chol'``
   (the fp64 oracle mode) in fp64; each main path reports every kernel's
   launch count (set to 0 just before the path, read just after),
   alive-solves/s, the status mix, the mean ADMM iterations per step, a
   per-step split from CUDA events and the peak device memory; 'eig'
   also a census of its ``eig_chunk`` calls by live count, 'pallas' a
   census of its ``admm_chunk`` calls by live count and lane width and of
   its ``ns_fused`` calls by (rows, warm/cold, needy count);
9. main path 4: the continuous-time closed loop of the radialC scenario
   (nonlinear two-body plant, RK4 at 1 ms: 500 substeps a 0.5 s tick;
   fp32 'eig', UKF, ``max_iter=1000``) for 139 ticks at B=1024: the
   launches of every kernel (``rk4_tick`` once a tick), ms per tick split
   into the solve span, the ``rk4_tick`` span and the rest, scenario
   substeps/s, the status and controller mix of alive ticks, the docked
   share, the termination substep's quartiles and the peak memory;
10. the sweeps (``parallel``) over an NCCL process group of one rank, on
   a flat ("data",) mesh: ``run_sweep`` of the flagship 'eig' engine
   (fp32, 20 steps) over 2048 scenarios in chunks of 1024 with a
   checkpoint; its resume from a checkpoint cut after chunk 0, which must
   give the same counts and the mean final distance within 1e-6 (bit
   identity is printed); a batch against its two halves on the same draws
   (fp64 'eig' at B=256 for 70 steps: the same termination, success and
   controller codes per scenario and stats within 1e-9; fp32 at B=1024:
   the count of scenarios that differ is printed); the fused
   disturbance-rejection
   study (sigma 0.7, hold lengths 10, 50 and 150 steps, 170 runs each, both
   arms: 1020 scenarios for 70 steps); and ``chunk_stats`` of the
   continuous radialC engine at B=1024 for 20 ticks; then
   ``graft_entry.dryrun_multichip(1)`` (the entry programs' sharded sweep
   step, Nx=40 'eig', B=2) over the same group. Its ``sweep:`` line holds
   scenarios/s, alive-solves/s, the outcome sums, the checks and the
   study's ratios;
11. the drivers users run (``examples``, ``tools/status_mix.py`` of the
   port): the mixed sweep's 10 engines (radial and in-track x R_input
   scales 0.25-4) at B=1024 each, 10,240 scenarios in fp32 'eig' with its
   ``--quick`` solver cap (max_iter 500) for 10 s (its ``--quick`` depth
   is 30 s), through its
   ``grid``, ``scenario_inputs`` and ``engine_stats`` (each engine must
   launch ``eig_chunk``, alive statuses lie in 0..4, and an in-track
   scenario with non-finite states must be counted diverged); the
   status-mix tool's fp64 'chol' oracle arm on shard 0/8 of ``--config
   ref --sigma 0.03 --runs 128`` (16 scenarios x 600 steps), held to the
   JAX package's record of that shard in ``artifacts/status_mix`` (within
   one docked scenario, 1% of the record's alive steps per status count
   and 1% on the mean termination step; whether it is exact is printed),
   and its fp32 'prod' arm on the same draws. Its ``drivers:`` line
   follows the ``sweep:`` line;
12. the oracle tools (``tools/continuous_fullscale.py``,
   ``tools/deviation_bench.py``, the status-mix refsim arm of the port):
   (a) ``fullscale_record`` of main path 4's engine (radialC, fp32 'eig',
   max_iter 1000) for T_final 100 s (200 ticks, 100,000 substeps a
   scenario; the tool's horizon, 300 s, runs in the B=8 engine below and
   in (b)) at B=1024: finite states, and each scenario's controller
   codes nonzero exactly on the ticks that started before its termination
   substep; then the command line's own engine ('chol' fp32, B=8) beside
   the JAX package's TPU record ``artifacts/contC_tpu_r5.json`` (other
   draws: printed, not held); (b) the port's fp64 'chol' engine at T=300 s
   on the card against the NumPy oracle ``simulate_continuous`` on the JAX
   tool's ``RandomState(11)`` draws: termination substep, controller codes
   and success equal and the tick trajectory within 1e-6 up to the
   terminating tick; after it the engine holds the state at the
   terminating substep and the oracle the tick's start, in the JAX package
   too, so the rows after it may differ (ROADMAP section 3); (c)
   ``deviation_bench.replay`` of the 60 QPs of ``artifacts/devseq_r5.npz``
   at production settings in 'eig' fp32, 'pallas' fp32 and 'chol' fp64
   (each must launch its kernels), beside the JAX package's TPU v5e
   numbers, and
   the first 3 'chol' steps on the CPU within 1e-9; (d) the refsim arm on
   the drivers phase's shard, held to the JAX package's record
   ``artifacts/status_mix/ref_s0.03_refsim_shard0of8.json`` under the
   rule of phase 11's oracle arm. The host oracles of (b) and (d) run
   from the start of the phase in two child processes started with
   ``spawn``, without CUDA and on one thread each. Its ``oracle:`` line
   follows the ``drivers:`` line;
13. the sigma=0.01 docking-gap dissection (``tools/first_divergence.py``
   and ``tools/probe_stall.py`` of the port), in one process: (a) the
   production rollout (fp32 'eig', the reference success-rate
   configuration at sigma=0.01, 128 runs x 600 steps, the draws of
   ``status_mix --seed 20260818``), keeping the carry entering every step
   on the card; (b) the fp64 'chol' oracle on the 45 gap columns of the
   JAX package's record ``artifacts/fd_oracle_r5.npz``, held to it under
   the rule of phase 11's oracle arm (whether statuses, termination and
   success are exact is printed); (c) ``compare`` of (a) and (b): the kinds
   of first flip and each gap scenario's first flip, beside the JAX
   package's reading of its own files; (d) the carry entering step 65 (and
   the gap's most common first-flip step, if another) captured:
   ``resolve_full`` must give every alive row its recorded status, and
   ``resolve`` re-solves it in fp32 'eig' and fp64 'chol'; (e)
   ``probe_stall``'s dump of (a)'s plateau pairs analysed in fp64 'chol'
   and fp32 'eig', and the JAX package's recorded pairs
   (``artifacts/stall_probe_r5.npz``) analysed beside their log. Its
   ``dissection:`` line follows the ``oracle:`` line;
14. the bench (``mpc_arpo_project_tpu_torch/bench.py``, the repository's
   ``bench.py`` on the port) at its defaults, full width and depth: fp32
   'eig', B=1024, 300 control steps, its timed pass and its latency pass
   (a sync every step); alive steps, no UNSOLVED alive step and
   ``eig_chunk`` launches are asserted, and the status mix is printed
   beside the JAX package's TPU v5e record (``BENCH_r05.json``, other
   draws: not held) and by window of steps; then ``graft_entry.entry()``'s
   step (B=8, Nx=40, 'eig') on the card against the CPU: in fp64 the same
   statuses, controller codes and ``done_iters`` and the state within
   1e-6, in fp32 finite. Its ``bench:`` line follows the ``dissection:``
   line;
15. the device's time by kernel and its idle share
   (``tools/profile_step.py`` of the port): the JAX tool's flagship (fp32
   'eig', B=1024) for 80 steps, ``torch.profiler`` over its default window,
   steps [60, 80); the trace must hold device events, as many
   ``eig_chunk`` kernel events as the wrapper counted launches over the
   window, a busy time (the union over streams) within the window and
   within the sum of the device's events, and an idle share in [0, 1].
   Its ``profile:`` line (the idle share, the traced ms per step, the top
   five device names with ms per step and count, the top three idle-gap
   host ops) follows the ``bench:`` line;
16. small agreement: 4 fp64 control steps at B=8 on the card (kernels) and
   on the CPU (twins) must give the same statuses, controller codes,
   termination, success and ``done_iters``, and trajectories within 1e-6;
   for 'eig' (with the 'dual' and the 'near' rho rescue), 'pallas' and
   'chol', for 'chol' with ``estimator='kf'`` and with
   ``synthesis='torch'``, and for the mixed sweep's noisy offset-free
   in-track engine ('eig'); and 5 ticks of the continuous loop in fp64 at
   B=8 ('eig' and 'chol'), which must also give the same termination
   substeps;
17. import check: no ``jax``, ``mpc_arpo_project_tpu``, ``tools`` or
   ``examples`` module was loaded.

With ``--ns-dump FILE`` it also saves every ``eig_chunk``, ``admm_chunk``
and Newton–Schulz kernel call of phase 3's comparisons (inputs, keywords,
the digests of what the kernel returned) for
``mpc_arpo_project_tpu_torch/tools/ns_replay.py``, which replays them on
another tree's kernels and compares bit for bit.

Prints the ``sweep:``, ``drivers:``, ``oracle:``, ``dissection:``,
``bench:`` and ``profile:`` lines and the kernels' JSON line, then ``{"ok": true, ...}``
as the last line.
Exits non-zero, with the traceback and without that line, when any phase
fails or no CUDA device is present.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import statistics
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
# the tests' helpers (the inputs of the tick kernel's check, the in-track
# agreement's run); they import nothing of JAX
TESTS = os.path.join(ROOT, "tests")

# H100 SXM peaks (NVIDIA's data sheet; the card's power limit is printed
# beside every time): fp32 and fp64 on the CUDA cores, HBM3 bandwidth
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
HBM_BYTES_S = 3.35e12


def log(*a):
    print(*a, flush=True)


def _parts(Nx):
    """MPC weights (horizon ``Nx``), failsafe gains and the debris box of
    the flagship family (``mpc_arpo_project_tpu_torch.bench``)."""
    from mpc_arpo_project_tpu_torch import bench

    return bench.flagship_parts(Nx)


def _settings(solve_mode, max_iter=4000):
    """The production solver profile (the bench's settings at their
    defaults) in ``solve_mode``."""
    from mpc_arpo_project_tpu_torch import bench

    return bench.bench_settings({"BENCH_SOLVE_MODE": solve_mode,
                                 "BENCH_MAX_ITER": str(max_iter)})


def flagship_sim(T_final, sigma=0.75):
    """The flagship scenario (the bench's: radial approach, offset-free,
    noise ``sigma`` held 50 steps)."""
    from mpc_arpo_project_tpu_torch import bench

    return bench.flagship_sim(T_final, sigma)


def flagship(T_final, device, dtype, solve_mode="eig", settings_kw=None,
             **engine_kw):
    """The flagship scenario and the production solver profile (the
    repository's bench configuration at its defaults, with
    ``BENCH_SOLVE_MODE=solve_mode``), with the settings ``settings_kw``
    changed; ``engine_kw`` (``estimator``, ``synthesis``) goes to
    ``build_engine``."""
    from mpc_arpo_project_tpu_torch.rollout import discrete

    mpc, fail, debris = _parts(50)
    sim = flagship_sim(T_final)
    settings = _settings(solve_mode)._replace(**(settings_kw or {}))
    return discrete.build_engine(sim, mpc, fail, debris, settings=settings,
                                 dtype=dtype, device=device, **engine_kw)


def radial_c(T_final, device, dtype, solve_mode="eig"):
    """The continuous radialC scenario (``examples/common.py:18-60``'s
    radial configuration with ``noisy=True, T_cont=1e-3``: Nx=40, noise
    sigma 0.0012 held 50 ticks, Brownian convention, UKF) with
    ``tools/continuous_fullscale.py``'s ``max_iter=1000`` and the
    flagship's other settings in ``solve_mode``."""
    from mpc_arpo_project_tpu_torch import Noise, SimConditions
    from mpc_arpo_project_tpu_torch.rollout import continuous

    mpc, fail, debris = _parts(40)
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
        2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0),
        Noise((0.0012, 0.0012), 50), False, T_cont=1e-3, T_final=T_final)
    return continuous.build_engine(
        sim, mpc, fail, debris, settings=_settings(solve_mode, max_iter=1000),
        dtype=dtype, device=device)


def _solver_calls(mode, **fns):
    """Make the solver (``ops.admm``) call ``fns`` in place of the functions
    of the same names in the module it looks them up in (``admm_eig`` or
    ``admm_pallas``, by ``mode``; for 'chol', ``admm`` itself: its
    ``_chol_factor`` and ``_chol_solve``) for the duration of the block.
    Each stand-in shares its function's attributes, so a kernel entry that
    counts its launches by its own name in its module still counts them on
    itself."""
    from mpc_arpo_project_tpu_torch.ops import admm

    return _patched(admm if mode == "chol" else _solver_module(mode), **fns)


@contextlib.contextmanager
def _patched(mod, **fns):
    """Module ``mod`` holds ``fns`` in place of its functions of the same
    names for the duration of the block (see ``_solver_calls``)."""
    saved = {n: getattr(mod, n) for n in fns}
    for n, f in fns.items():
        f.__dict__ = saved[n].__dict__
        setattr(mod, n, f)
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(mod, n, f)


def _solver_module(mode):
    from mpc_arpo_project_tpu_torch.ops import admm_eig, admm_pallas

    return admm_eig if mode == "eig" else admm_pallas


def capture_chunks(engine, B, steps_before, seed):
    """Inputs of the first chunk call (``eig_chunk`` or ``admm_chunk``, by
    the engine's solve mode) of the first solve and of the solve after
    ``steps_before`` control steps (cloned)."""
    import torch
    from mpc_arpo_project_tpu_torch.rollout import discrete

    mode = engine.settings.solve_mode
    mod = _solver_module(mode)
    name = "eig_chunk" if mode == "eig" else "admm_chunk"
    real = getattr(mod, name)
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noise = discrete.make_noise_sequence(engine, gen, B)
    carry = discrete._init_carry(engine, B, engine.x0.expand(B, 4))
    captured = {}

    def grab(step):
        def rec(*a, **k):
            if step not in captured:
                clone = lambda v: v.clone() if torch.is_tensor(v) else v
                captured[step] = (tuple(clone(v) for v in a),
                                  {kk: clone(v) for kk, v in k.items()})
            return real(*a, **k)
        return rec

    for i in range(steps_before + 1):
        with _solver_calls(mode, **{name: grab(i)}):
            carry, _ = discrete._step(engine, carry, i, noise[i])
    return [captured[0], captured[steps_before]]


def _cast(args, kw, dtype):
    import torch

    cv = lambda v: (v.to(dtype) if torch.is_tensor(v) and v.is_floating_point()
                    else v)
    return tuple(cv(v) for v in args), {k: cv(v) for k, v in kw.items()}


def _row_rel(a, b):
    """Per-row max |a - b| relative to the row's max |b|."""
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    scale = b.abs().amax(1).clamp(min=1e-30)
    return (a - b).abs().amax(1) / scale


def _chunk_err(out, ref, parts=False):
    """Per-row relative deviation of a chunk's outputs from ``ref``: x, y, z
    and stats columns 0-3 (rp, rp_rel, rd, rd_rel), each relative to the
    row's max-abs in ``ref`` (a residual is a difference of terms of the
    size of its rp_rel/rd_rel, so that is its scale). ``parts=True`` keeps
    the four columns (x, y, z, stats) apart."""
    import torch

    e = torch.stack([_row_rel(out[i].double(), ref[i].double())
                     for i in range(3)]
                    + [_row_rel(out[3][:, :4].double(),
                                ref[3][:, :4].double())], 1)
    return e if parts else e.amax(1)


def _plain(k):
    """A kernel call's keywords without those that only steer the CUDA
    kernel (``eig_chunk``'s ``n_live`` and ``group``, ``admm_chunk``'s
    ``n_live`` and ``layout``), for its twin."""
    return {kk: v for kk, v in k.items()
            if kk not in ("n_live", "group", "layout")}


def _launch(kernel, a, k, label):
    """Call a kernel entry and check that it counted exactly one launch
    (so the result really came from the CUDA kernel)."""
    n0 = kernel.launches
    out = kernel(*a, **k)
    if kernel.launches != n0 + 1:
        raise AssertionError(f"{label}: {kernel.__name__} did not launch its "
                             "kernel")
    return out


def compare_kernel(kernel, plain, args, kw, dtype, tol, label, record=None):
    """Run a chunk kernel (``eig_chunk`` or ``admm_chunk``) and its twin on
    the same inputs in ``dtype``; returns (max abs err, summary dict).
    Raises if they disagree beyond ``tol``. The kernel's call goes to
    ``record`` (a ``CallRecord``) when one is given.

    Deviation per row: see ``_chunk_err``. fp64 holds every not-done row
    to ``tol``. In fp32 a row passes within ``tol`` of the plain version, or
    when the kernel is no farther from the fp64 plain result on the same
    inputs than 4x the fp32 plain version's own distance plus ``tol``: the
    fp32 plain version is itself more than ``tol`` from fp64 on some inputs
    (debris rows whose answer moves by ~1e-4 under 1-ulp input changes,
    residuals that cancel), and two fp32 versions cannot be held closer
    than their own error. Either way pinf/dinf must agree on 99.5% of
    rows."""
    import torch

    a, k = _cast(args, kw, dtype)
    ker = _launch(kernel, a, k, label)
    if record is not None:
        record.add_chunk(kernel.__name__, args, kw, dtype, label, ker)
    ref = plain(*a, **_plain(k))
    live = ~k["done"]
    n_live = int(live.sum())
    err = _chunk_err(ker, ref)[live]
    flags_k, flags_r = ker[3][:, 4:6] > 0, ref[3][:, 4:6] > 0
    same_flags = (flags_k == flags_r).all(1)[live]
    for row in torch.nonzero(~same_flags).squeeze(1).tolist()[:20]:
        slot = int(torch.nonzero(live).squeeze(1)[row])
        log(f"  [{label}] slot {slot}: pinf/dinf kernel "
            f"{flags_k[slot].tolist()} plain {flags_r[slot].tolist()}")
    frac_flags = float(same_flags.float().mean())
    over = err > tol
    frac_tol = 1.0 - float(over.float().mean())
    max_abs = max(float((ker[i] - ref[i]).abs()[live].max()) for i in range(3))
    if dtype == torch.float64:
        ok = not bool(over.any())
    else:
        a64, k64 = _cast(args, kw, torch.float64)
        ref64 = plain(*a64, **_plain(k64))
        e_ker = _chunk_err(ker, ref64)[live]
        e_ref = _chunk_err(ref, ref64)[live]
        worse = over & (e_ker > 4.0 * e_ref + tol)
        if bool(over.any()):
            row = int(torch.argmax(err))
            pk = _chunk_err(ker, ref64, parts=True)[live][row].tolist()
            pr = _chunk_err(ref, ref64, parts=True)[live][row].tolist()
            log(f"  [{label}] worst row {row}: kernel-vs-plain "
                f"{float(err[row]):.3e}; vs fp64 (x, y, z, stats): kernel "
                + ", ".join(f"{v:.2e}" for v in pk) + "; plain "
                + ", ".join(f"{v:.2e}" for v in pr))
        for row in torch.nonzero(worse).squeeze(1).tolist()[:20]:
            log(f"  [{label}] row {row}: kernel-vs-plain {float(err[row]):.3e};"
                f" vs fp64: kernel {float(e_ker[row]):.3e}, plain "
                f"{float(e_ref[row]):.3e}")
        ok = not bool(worse.any())
    summary = dict(rows=n_live, max_rel_err=float(err.max()),
                   rows_within_tol=frac_tol, flags_identical=frac_flags,
                   max_abs_err=max_abs)
    if dtype != torch.float64:
        summary.update(max_rel_err_vs_fp64_kernel=float(e_ker.max()),
                       max_rel_err_vs_fp64_plain=float(e_ref.max()))
    log(f"  [{label}] {json.dumps(summary)}")
    if not ok or frac_flags < 0.995:
        raise AssertionError(f"{label}: kernel and plain version disagree "
                             f"(tol {tol:g}): {summary}")
    return max_abs, summary


class CallRecord:
    """The kernel calls of the comparisons that ``--ns-dump`` saves for
    ``mpc_arpo_project_tpu_torch/tools/ns_replay.py``: inputs (one CPU copy
    each, before the cast to the call's type), keywords and what the kernel
    returned (Newton–Schulz: the digest of X and the residuals; the chunk
    kernels ``eig_chunk`` and ``admm_chunk``: the digests of x, y, z and
    stats)."""

    def __init__(self):
        self.calls, self._cpu = [], {}

    def _keep(self, v):
        import torch

        if not torch.is_tensor(v):
            return v
        return self._cpu.setdefault(id(v), (v, v.cpu()))[1]

    def add(self, kernel, args, kw, dtype, n_need, label, xk, rk):
        from mpc_arpo_project_tpu_torch.tools.ns_replay import digest

        self.calls.append(dict(
            label=label, entry=kernel.__name__,
            args=tuple(map(self._keep, args)), kw=dict(kw), n_need=n_need,
            dtype=str(dtype)[6:], x_digest=digest(xk), res=rk.cpu()))

    def add_chunk(self, entry, args, kw, dtype, label, outs):
        from mpc_arpo_project_tpu_torch.tools.ns_replay import digest

        self.calls.append(dict(
            label=label, entry=entry, args=tuple(map(self._keep, args)),
            kw={k: self._keep(v) for k, v in kw.items()},
            dtype=str(dtype)[6:], digests=[digest(o) for o in outs]))


def compare_inverse(kernel, plain, args, kw, dtype, tol, label, need=None,
                    n_need=None, record=None):
    """Run a Newton–Schulz entry (given ``n_need``) and its twin on the
    same inputs in ``dtype``; returns (max abs err on the held rows,
    summary dict). The kernel's call goes to ``record`` (a ``CallRecord``)
    when one is given.

    With ``need`` (``ns_fused``: args = stack, w, X_prev, need), rows
    without need must pass through bit for bit, inf and NaN included, with
    residual 0. Needy rows whose twin result is not
    finite (a poisoned warm start) must be non-finite in the kernel too.
    The other needy rows are held as in ``compare_kernel``: X per row
    relative to its max-abs, within ``tol`` (fp64), or in fp32 within
    ``tol`` or no farther from the fp64 twin than 4x the fp32 twin plus
    ``tol``; the fp64 residuals to ``tol`` absolute."""
    import torch

    a, k = _cast(args, kw, dtype)
    xk, rk = _launch(kernel, a, dict(k, n_need=n_need), label)
    if record is not None:
        record.add(kernel, args, kw, dtype, n_need, label, xk, rk)
    xr, rr = plain(*a, **k)
    B = xk.shape[0]
    if need is None:
        need = torch.ones(B, dtype=torch.bool, device=xk.device)
    else:  # ns_fused(stack, w, X_prev, need)
        x_prev = a[2]
        same = lambda u, v: ((u == v)
                             | (torch.isnan(u) & torch.isnan(v))).all()
        if (not bool(same(xk[~need], x_prev[~need]))
                or bool((rk[~need] != 0).any())):
            raise AssertionError(f"{label}: rows without need did not pass "
                                 "through")
    fin_r = torch.isfinite(xr).all(2).all(1)
    fin_k = torch.isfinite(xk).all(2).all(1)
    if bool((need & ~fin_r & fin_k).any()):
        raise AssertionError(f"{label}: the kernel is finite where the plain "
                             "version is not")
    held = need & fin_r
    if bool((held & ~fin_k).any()):
        raise AssertionError(f"{label}: the kernel is not finite where the "
                             "plain version is")
    err = _row_rel(xk[held].double(), xr[held].double())
    over = err > tol
    if dtype == torch.float64:
        ok = not bool(over.any())
        res_err = float((rk[held] - rr[held]).abs().max())
        ok = ok and res_err <= tol
    else:
        a64, k64 = _cast(args, kw, torch.float64)
        x64, _ = plain(*a64, **k64)
        e_ker = _row_rel(xk[held].double(), x64[held])
        e_ref = _row_rel(xr[held].double(), x64[held])
        worse = over & (e_ker > 4.0 * e_ref + tol)
        ok = not bool(worse.any())
        res_err = None
    max_abs = float((xk[held] - xr[held]).abs().max())
    summary = dict(rows=int(held.sum()), poisoned_needy=int((need & ~fin_r).sum()),
                   passed_through=int((~need).sum()),
                   max_rel_err=float(err.max()),
                   rows_within_tol=1.0 - float(over.float().mean()),
                   max_abs_err=max_abs,
                   residual_kernel_max=float(rk[held].max()),
                   residual_plain_max=float(rr[held].max()))
    if res_err is not None:
        summary["residual_max_abs_diff"] = res_err
    else:
        summary.update(max_rel_err_vs_fp64_kernel=float(e_ker.max()),
                       max_rel_err_vs_fp64_plain=float(e_ref.max()))
    log(f"  [{label}] {json.dumps(summary)}")
    if not ok:
        raise AssertionError(f"{label}: kernel and plain version disagree "
                             f"(tol {tol:g}): {summary}")
    return max_abs, summary


def time_ms(fn, n=20):
    """Median of ``n`` CUDA-event timings of ``fn()`` (after one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


# ---------------------------------------------------------------------------
# bounds: the least time the card could take for the same work, the larger
# of (bytes each input read once + each output written once) / HBM rate and
# (operations on these inputs) / fp32 peak; data-dependent work (done rows,
# rows without need) is counted for this run's inputs
# ---------------------------------------------------------------------------

def _bytes(tensors, live_frac, B):
    """Bytes of ``tensors``: per-problem ones (leading dim B) scaled by the
    share of rows the call works on, shared ones in full."""
    import torch

    total = 0.0
    for t in tensors:
        if not torch.is_tensor(t):
            continue
        b = t.numel() * t.element_size()
        total += b * live_frac if (t.dim() and t.shape[0] == B) else b
    return total


def _bound(flops, nbytes, peak=PEAK_FP32):
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def eig_chunk_bound(args, kw, outs):
    """One eig chunk: per live problem-iteration, A'v (A_c and the s-part
    gather/scatter), the eigenbasis solve with the rank-K Woodbury term,
    and Av; the end-of-chunk residuals and certificates (2 Av, 2 A'v,
    2 P v). Beside it, ``eig_chunk_floor`` is the HBM floor of the kernel's
    design, which reads each slot's T^-1 every iteration."""
    x, tinv, gsel_s = args[7], args[1], args[16]
    B, nz = x.shape
    m, K, gw = args[8].shape[1], tinv.shape[1], gsel_s.shape[1]
    live = int((~kw["done"]).sum())
    a_mv = m * nz + nz * gw + gw * m
    it = 2 * a_mv + 2 * nz * nz + 2 * K * nz + K * K
    end = 4 * a_mv + 2 * nz * nz
    flops = 2.0 * live * (kw["n_iter"] * it + end)
    return _bound(flops, _bytes(list(args) + list(outs), live / B, B))


def eig_chunk_floor(args, kw):
    """The HBM floor of ``csrc/eig_chunk.cu``: each live slot's T^-1 (K x K)
    streamed once per iteration (25 x live x K^2 x 4 bytes in fp32, 0.50 ms
    at 1024 live slots), the rest of the chunk's bytes being L2 hits."""
    tinv = args[1]
    live = int((~kw["done"]).sum())
    return (kw["n_iter"] * live * tinv[0].numel() * tinv.element_size()
            / HBM_BYTES_S * 1e3)


def admm_chunk_bound(args, kw, outs):
    """One 'pallas' chunk: per live problem-iteration, A'v and Av (A0 and
    the 3 gw correction gather/scatter), (1 + ir_steps) Minv applies and
    ir_steps structured M v products (7 nz^2); the end-of-chunk residuals
    and certificates (2 Av, 2 A'v, 2 P v)."""
    x, gsel = args[6], args[12]
    B, nz = x.shape
    m, gw3 = args[7].shape[1], gsel.shape[1]
    ir = kw["ir_steps"]
    live = int((~kw["done"]).sum())
    a_mv = m * nz + nz * gw3 + gw3 * m
    it = 2 * a_mv + (1 + ir) * nz * nz + ir * 7 * nz * nz
    end = 4 * a_mv + 2 * nz * nz
    flops = 2.0 * live * (kw["n_iter"] * it + end)
    return _bound(flops, _bytes(list(args) + list(outs), live / B, B))


PEAK_BF16_TC = 989e12  # dense bf16 tensor-core peak, fp32 accumulate


def probe_bound(name, inputs, n_it, precision="highest"):
    """One probe kernel in ``precision``: the function's useful MACs at
    that precision's peak (fp32 on the CUDA cores at "highest"; one bf16
    tensor-core pass at "default", three at "high"; the bf16 variant names
    bf16 itself, so two passes in every precision), or each input read once
    and the output written once, whichever is larger. Also returns the time
    at the fp32 peak of the MACs the "highest" kernels execute (the bf16
    variant's two limb products, the block-diagonal variant's bt-fold
    masked MACs), and the floor of streaming the variant's matrix from HBM
    in every iteration."""
    from mpc_arpo_project_tpu_torch.tools import kernel_probe as kp

    v = kp.variant(name, inputs)
    x, mat = inputs["x"], inputs[v.operand]
    n = 2.0 * x.shape[0] * n_it
    passes = (2 if name == "minv_bf16" else
              {"highest": 0, "high": 3, "default": 1}[precision])
    bound_ms, bound_by = _bound(
        n * v.macs * max(passes, 1),
        _bytes([x, mat, x], 1.0, x.shape[0]),
        PEAK_FP32 if passes == 0 else PEAK_BF16_TC)
    stream_ms = mat.numel() * mat.element_size() * n_it / HBM_BYTES_S * 1e3
    return (bound_ms, bound_by, n * v.executed / PEAK_FP32 * 1e3,
            stream_ms)


def ns_bound(n, rows, n_iter, tensors, B, stack=True):
    """Newton–Schulz on ``rows`` problems: 2 n_iter + 1 products of n^3
    MACs each (the iteration and the residual), plus building M from the
    7-matrix stack once (ns_fused); at the fp32 or fp64 CUDA-core peak by
    the tensors' type."""
    import torch

    flops = 2.0 * rows * ((2 * n_iter + 1) * n ** 3 + (7 * n * n if stack
                                                        else 0))
    f64 = any(torch.is_tensor(t) and t.dtype == torch.float64
              for t in tensors)
    return _bound(flops, _bytes(tensors, rows / B, B),
                  PEAK_FP64 if f64 else PEAK_FP32)


def time_ns_case(label, kernel, plain, args, kw, n_need, M, n=20):
    """Time a Newton–Schulz entry (given ``n_need``) beside its cuBLAS twin,
    ``torch.linalg.inv`` of the same needy M, and its bound, in fp32 and
    fp64 (median of ``n`` CUDA-event runs); returns the fp32 (ms, plain
    ms, bound ms, bound by, inv ms)."""
    import torch

    fused = len(args) == 4
    B, nz = args[-2 if fused else -1].shape[:2]
    rows = int(args[3].sum()) if fused else B
    out = {}
    for dt in (torch.float32, torch.float64):
        a, k = _cast(args, kw, dt)
        Md = M.to(dt)
        k_ms = time_ms(lambda: kernel(*a, **k, n_need=n_need), n)
        p_ms = time_ms(lambda: plain(*a, **k), n)
        inv_ms = time_ms(lambda: torch.linalg.inv(Md), n)
        b_ms, b_by = ns_bound(nz, rows, k["n_iter"], list(a) + [a[-2 if fused
                                                                 else -1]],
                              B, stack=fused)
        log(f"{label}, {str(dt)[6:].replace('float', 'fp')}: kernel "
            f"{k_ms:.3f} ms, plain {p_ms:.3f} ms, bound {b_ms:.3f} ms "
            f"({b_by}); torch.linalg.inv of the same M {inv_ms:.3f} ms "
            f"(median of {n}, CUDA events)")
        out[dt] = (k_ms, p_ms, b_ms, b_by, inv_ms)
    return out[torch.float32]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

# the costliest live class of the 'eig' main path's chunk census (PERF.md
# section 5: chunks of 1-32 live slots, 10.6 on average, 47% of the chunk
# span on the parent kernel), timed beside the 1024-slot chunk
COSTLY_LIVE = 11
# live counts of the sweep over layouts that sets eig_layout's policy (and
# the chunk's own 1024)
SWEEP_LIVE = (1, 7, 11, 15, 16, 30, 33, 66, 128, 192, 264, 384, 528, 768)


def _with_live(args, kw, n_live):
    """``kw`` with all but ``n_live`` of the chunk's live slots marked done:
    each combo group keeps its first live slots (the solver's live-first
    packing), in proportion to its live count; ``n_live`` set to match."""
    import torch

    done, bt = kw["done"], kw["bt"]
    combo = args[0].long().repeat_interleave(bt)
    live = ~done
    total = int(live.sum())
    keep = torch.zeros_like(live)
    left = min(n_live, total)
    for c in range(int(combo.max()) + 1):
        idx = torch.nonzero(live & (combo == c)).squeeze(1)
        q = min(left, -(-idx.numel() * n_live // total))
        keep[idx[:q]] = True
        left -= q
    return dict(kw, done=~keep, n_live=int(keep.sum()))


# the costliest class of the 'pallas' main path's chunk census (PERF.md
# section 5: calls of 1-32 live slots in the 32-row overtime lanes, 9.0
# live on average, 35% of the chunk span on the one-slot kernel), timed beside
# the 1024-slot chunk: (lane rows, live slots)
ADMM_COSTLY = (32, 9)
# live counts of the sweep over layouts that sets admm_pallas.admm_layout
ADMM_SWEEP_LIVE = (1, 9, 33, 66, 128, 264, 528, 1024)


def _first_live(kw, n_live):
    """``kw`` with all but the first ``n_live`` live slots marked done."""
    import torch

    live = torch.nonzero(~kw["done"]).squeeze(1)
    done = torch.ones_like(kw["done"])
    done[live[:n_live]] = False
    return dict(kw, done=done, n_live=min(n_live, live.numel()))


def _lane(args, kw, rows, n_live):
    """An overtime lane's call: the first ``rows`` rows of a chunk call
    (the per-slot arguments are the first ten), the first ``n_live`` of
    their live slots live."""
    a = tuple(v[:rows].contiguous() if i < 10 else v
              for i, v in enumerate(args))
    return a, _first_live(dict(kw, done=kw["done"][:rows]), n_live)


def check_eig_kernel(engine, B, record=None):
    """``eig_chunk`` against its twin on the first solve's and the
    after-5-steps chunk (all live slots) and on the after-5-steps chunk cut
    to the census's costliest live class, in fp32 and fp64 (the calls go to
    ``record`` when one is given); timed at both live counts beside its
    twin, bound and HBM floor; then a sweep of the layouts (slots per
    block S, clusters of C blocks) over live counts, which
    ``admm_eig.eig_layout``'s policy follows. Returns the
    JSON entry (without launches)."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm_eig

    sets = capture_chunks(engine, B, steps_before=5, seed=1)
    a, k = sets[1]
    sets.append((a, _with_live(a, k, COSTLY_LIVE)))
    max_abs = 0.0
    labels = ("first solve", "after 5 steps",
              f"after 5 steps, {COSTLY_LIVE} live (the census's costliest "
              "class)")
    for label, (a, k) in zip(labels, sets):
        log(f"eig_chunk vs plain, {label}: {a[0].shape[0]} tiles of "
            f"bt={k['bt']}, {int((~k['done']).sum())} live slots (n_live "
            f"{k.get('n_live')}), |tinv|max={float(a[1].abs().max()):.3e}")
        err32, _ = compare_kernel(admm_eig.eig_chunk, admm_eig.eig_chunk_ref,
                                  a, k, torch.float32, 1e-4, f"fp32 {label}",
                                  record)
        compare_kernel(admm_eig.eig_chunk, admm_eig.eig_chunk_ref, a, k,
                       torch.float64, 1e-10, f"fp64 {label}", record)
        max_abs = max(max_abs, err32)
    timed = {}
    # the card's wave tables at the chunk's shapes, by type
    a, k = sets[1]
    dims = (a[7].shape[1], a[8].shape[1], a[1].shape[1], a[16].shape[1])
    waves_of = {dt: admm_eig._waves(dt, *dims, a[7].device)
                for dt in (torch.float32, torch.float64)}
    layout = lambda n, dt, bt=k["bt"]: admm_eig.eig_layout(n, bt, dt,
                                                         waves_of[dt])
    for label, (a, k) in zip(labels[1:], sets[1:]):
        live = int((~k["done"]).sum())
        ms = time_ms(lambda: admm_eig.eig_chunk(*a, **k))
        plain_ms = time_ms(lambda: admm_eig.eig_chunk_ref(*a, **_plain(k)))
        a64, k64 = _cast(a, k, torch.float64)
        ms64 = time_ms(lambda: admm_eig.eig_chunk(*a64, **k64))
        plain_ms64 = time_ms(
            lambda: admm_eig.eig_chunk_ref(*a64, **_plain(k64)))
        bound_ms, bound_by = eig_chunk_bound(a, k, admm_eig.eig_chunk(*a, **k))
        floor = eig_chunk_floor(a, k)
        log(f"eig_chunk, 25 iterations, {label} ({live} live slots, layout "
            f"(C, S) {layout(live, torch.float32)} fp32, "
            f"{layout(live, torch.float64)} fp64): fp32 "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound_ms:.3f} ms ({bound_by}), HBM floor of this design (T^-1 "
            f"read every iteration) {floor:.3f} ms; fp64 kernel {ms64:.3f} "
            f"ms, plain {plain_ms64:.3f} ms (median of 20, CUDA events)")
        timed[label] = (ms, plain_ms, bound_ms, bound_by)

    # layouts against live count (median of 10 each): slots per block S,
    # and in fp32 a cluster of C blocks per live slot
    a, k = sets[1]
    n_all = int((~k["done"]).sum())
    for dt in (torch.float32, torch.float64):
        a_d, k_d = _cast(a, k, dt)
        if waves_of[dt]:
            log(f"  eig_chunk clusters, {str(dt)[6:]}: clusters a wave holds "
                f"on this card {waves_of[dt]}")
        layouts = [(1, S) for S in (1, 2, 4, 8)
                   if S <= admm_eig.GROUP_CAP[dt] and k["bt"] % S == 0]
        layouts += [(C, 1) for C in admm_eig.CLUSTERS[dt]]
        for live in SWEEP_LIVE + (n_all,):
            kl = _with_live(a_d, k_d, live)
            row = {lay: time_ms(lambda: admm_eig.eig_chunk(*a_d, **dict(
                kl, layout=lay)), 10) for lay in layouts}
            log(f"  layout sweep, {str(dt)[6:]}, {kl['n_live']} live: "
                + ", ".join(f"(C, S)={c, s} {t:.3f} ms"
                            for (c, s), t in row.items())
                + "; policy "
                + f"{layout(kl['n_live'], dt)}")
    ms, plain_ms, bound_ms, bound_by = timed[labels[1]]
    return dict(name="eig_chunk", route="cuda",
                source="mpc_arpo_project_tpu_torch/csrc/eig_chunk.cu",
                replaces="mpc_arpo_project_tpu/ops/admm_eig.py:75",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def hold_lane(a_full, k_full, a, k, label, record=None):
    """The fp32 ``admm_chunk`` on an overtime lane's call (the first rows
    of the full call ``a_full``, ``k_full``, some of their live slots live)
    held bit for bit to the full call's rows, which ``compare_kernel`` held
    to the twin: a slot's result depends on no other slot and on no layout.
    Not to the fp32 twin itself: the twin's fp32 rows depend on the batch
    its products run in, and the first live rows of this input include the
    row whose kernel result is 1.5e-4 from fp64 by the round-off of the
    kernel's stack7 summation order (ROADMAP section 3, closed), which the
    twin's 4x-plus-1e-4 rule passes in the full call but not at every batch
    size. Its distances from the twins are logged. Raises unless the bits
    agree and the done rows pass through with zero stats."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm_pallas

    full = admm_pallas.admm_chunk(*a_full, **k_full)
    out = _launch(admm_pallas.admm_chunk, a, k, label)
    if record is not None:
        record.add_chunk("admm_chunk", a, k, torch.float32, label, out)
    rows = a[6].shape[0]
    live, done = ~k["done"], k["done"]
    same = all(torch.equal(o[live], f[:rows][live]) for o, f in zip(out, full))
    passed = (all(torch.equal(o[done], v[done]) for o, v in
                  zip(out[:3], a[6:9])) and bool((out[3][done] == 0).all()))
    a64, k64 = _cast(a, k, torch.float64)
    e_ker = _chunk_err(out, admm_pallas.admm_chunk_ref(
        *a64, **_plain(k64)))[live]
    e_ref = _chunk_err(admm_pallas.admm_chunk_ref(*a, **_plain(k)),
                       admm_pallas.admm_chunk_ref(*a64, **_plain(k64)))[live]
    log(f"  [{label}] {int(live.sum())} live rows bit-identical to the full "
        f"call's: {same}; done rows passed through: {passed}; vs fp64: "
        f"kernel {float(e_ker.max()):.3e}, plain {float(e_ref.max()):.3e}")
    if not (same and passed):
        raise AssertionError(f"{label}: the lane's rows differ from the full "
                             "call's or its done rows did not pass through")


def admm_sweep(a, k):
    """``admm_chunk`` in every layout (C, S) of its type against live count
    on the after-5-steps call (median of 10 each), beside the layout
    ``admm_layout`` picks; and the groups a wave of this card holds per
    layout, beside the H100 table the policy defaults to."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm_pallas

    nz, m, gw3 = a[6].shape[1], a[7].shape[1], a[12].shape[1]
    for dt in (torch.float32, torch.float64):
        waves = admm_pallas._waves(dt, nz, m, gw3 // 3, a[6].device)
        log(f"  admm layouts, {str(dt)[6:]}: groups a wave holds on this card "
            f"{waves}; the policy's table {admm_pallas.WAVES[dt]}")
        a_d, k_d = _cast(a, k, dt)
        for live in ADMM_SWEEP_LIVE:
            kl = _first_live(k_d, live)
            row = {lay: time_ms(lambda: admm_pallas.admm_chunk(
                *a_d, **dict(kl, layout=lay)), 10)
                for lay in admm_pallas.LAYOUTS[dt]}
            log(f"  layout sweep, {str(dt)[6:]}, {kl['n_live']} live: "
                + ", ".join(f"(C, S)={c, s} {t:.3f} ms"
                            for (c, s), t in row.items())
                + f"; policy {admm_pallas.admm_layout(kl['n_live'], dt)}")


def check_pallas_kernels(engine, B, record=None):
    """``admm_chunk``, ``ns_fused`` and ``newton_schulz_inverse`` against
    their twins on inputs of the 'pallas' flagship engine; returns their
    JSON entries (without launches). The kernel calls of the comparisons
    go to ``record`` when one is given."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm, admm_pallas

    sets = capture_chunks(engine, B, steps_before=5, seed=1)
    rows, n_live = ADMM_COSTLY
    sets.append(_lane(*sets[1], rows, n_live))
    labels = ["first solve", "after 5 steps",
              f"after 5 steps, {rows}-row lane, {n_live} live (the census's "
              "costliest class)"]
    max_abs = 0.0
    for label, (a, k) in zip(labels, sets):
        log(f"admm_chunk vs plain, {label}: {int((~k['done']).sum())} live "
            f"of {a[6].shape[0]} slots, |minv|max={float(a[0].abs().max()):.3e}")
        if label == labels[2]:
            hold_lane(*sets[1], a, k, f"fp32 {label}", record)
        else:
            err32, _ = compare_kernel(
                admm_pallas.admm_chunk, admm_pallas.admm_chunk_ref, a, k,
                torch.float32, 1e-4, f"fp32 {label}", record)
            max_abs = max(max_abs, err32)
        compare_kernel(admm_pallas.admm_chunk, admm_pallas.admm_chunk_ref, a,
                       k, torch.float64, 1e-10, f"fp64 {label}", record)
    timed = {}
    for label, (a, k) in zip(labels[1:], sets[1:]):
        live = int((~k["done"]).sum())
        ms = time_ms(lambda: admm_pallas.admm_chunk(*a, **k))
        plain_ms = time_ms(lambda: admm_pallas.admm_chunk_ref(*a, **_plain(k)))
        a64, k64 = _cast(a, k, torch.float64)
        ms64 = time_ms(lambda: admm_pallas.admm_chunk(*a64, **k64))
        plain_ms64 = time_ms(
            lambda: admm_pallas.admm_chunk_ref(*a64, **_plain(k64)))
        bound_ms, bound_by = admm_chunk_bound(a, k,
                                              admm_pallas.admm_chunk(*a, **k))
        log(f"admm_chunk, 25 iterations, {label} ({live} live slots, layout "
            f"(C, S) {admm_pallas.admm_layout(live, torch.float32)} fp32, "
            f"{admm_pallas.admm_layout(live, torch.float64)} fp64): fp32 "
            f"kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.3f} ms ({bound_by}); fp64 "
            f"kernel {ms64:.3f} ms, plain {plain_ms64:.3f} ms (median of 20, "
            "CUDA events)")
        timed[label] = (ms, plain_ms, bound_ms, bound_by)
    a, k = sets[1]
    admm_sweep(a, k)
    ms, plain_ms, bound_ms, bound_by = timed[labels[1]]
    chunk = dict(name="admm_chunk", route="cuda",
                 source="mpc_arpo_project_tpu_torch/csrc/admm_chunk.cuh",
                 replaces="mpc_arpo_project_tpu/ops/admm_pallas.py:260",
                 max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                 bound_ms=bound_ms, bound_by=bound_by, library_ms=None)

    # ---- Newton–Schulz on the same problems: the weights w7 and the
    # inverses Minv of the after-5-steps chunk; every 8th row needy (the
    # flagship's compacted refresh buffer holds B/8 rows), a 3% rho drift
    # on the needy rows, and poisoned inverses: +inf and NaN on rows
    # without need, NaN on one needy row (its warm result is NaN)
    st = engine.settings
    prob = engine.prob
    nz = prob.Pbar.shape[0]
    dev = prob.Pbar.device
    sigma = float(st.sigma)
    eye = torch.eye(nz, dtype=prob.Pbar.dtype, device=dev)
    stack = torch.cat([(prob.Pbar + sigma * eye)[None], prob.G[None],
                       prob.Fstack], 0).contiguous()
    minv, coef, w7 = a[0], a[1], a[9]
    need = torch.zeros(B, dtype=torch.bool, device=dev)
    need[::8] = True
    drift = torch.ones(8, dtype=w7.dtype, device=dev)
    drift[1:7] = 1.03
    w = torch.where(need[:, None], w7 * drift, w7).contiguous()
    X_prev = minv.clone()
    X_prev[1] = torch.inf
    X_prev[2] = torch.nan
    X_prev[8] = torch.nan
    ones = torch.ones(B, dtype=torch.bool, device=dev)
    # the census's costliest class (PERF.md section 5): 3 needy rows of a
    # 32-row overtime lane, cold
    need32 = torch.zeros(32, dtype=torch.bool, device=dev)
    need32[[3, 17, 30]] = True
    w32, x32 = w[:32].contiguous(), minv[:32].contiguous()
    fused_cases = [  # (label, args, kw, n_need)
        ("warm", (stack, w, X_prev, need), dict(n_iter=st.ns_warm_iters,
                                                cold=False), None),
        ("cold", (stack, w, X_prev, need), dict(n_iter=st.ns_cold_iters,
                                                cold=True), None),
        ("cold, full width (the first refresh)", (stack, w, minv, ones),
         dict(n_iter=st.ns_cold_iters, cold=True), B),
        ("cold, 3 needy of 32 rows", (stack, w32, x32, need32),
         dict(n_iter=st.ns_cold_iters, cold=True), 3)]
    max_ns = 0.0
    for label, args, kw, n_need in fused_cases:
        for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
            err, _ = compare_inverse(
                admm_pallas.ns_fused, admm_pallas.ns_fused_ref, args, kw, dt,
                tol, f"ns_fused {label} {str(dt)[6:]}", need=args[3],
                n_need=n_need, record=record)
            if dt == torch.float32:
                max_ns = max(max_ns, err)

    # timed: the compacted refresh of chip_smoke's earlier PRs (the K = B/8
    # needy rows alone, warm and cold), the full-width first refresh and
    # the census's costliest class
    rows = torch.nonzero(need).squeeze(1)
    K = rows.numel()
    w_k, x_k = w[rows].contiguous(), minv[rows].contiguous()
    need_k = torch.ones(K, dtype=torch.bool, device=dev)
    Ms = lambda wt, nd: admm_pallas._stack_matrix(stack, wt[nd]).contiguous()
    fp32 = {}
    for label, args, kw, n_need, M_of in (
            (f"ns_fused warm ({st.ns_warm_iters} iterations) on {K} needy "
             "rows", (stack, w_k, x_k, need_k), fused_cases[0][2], None,
             Ms(w_k, need_k)),
            (f"ns_fused cold ({st.ns_cold_iters} iterations) on {K} needy "
             "rows", (stack, w_k, x_k, need_k), fused_cases[1][2], None,
             Ms(w_k, need_k)),
            (f"ns_fused cold ({st.ns_cold_iters} iterations), full width: "
             f"{B} needy rows", fused_cases[2][1], fused_cases[2][2], B,
             Ms(w, ones)),
            (f"ns_fused cold ({st.ns_cold_iters} iterations), 3 needy of 32 "
             "rows (the census's costliest class)", fused_cases[3][1],
             fused_cases[3][2], 3, Ms(w32, need32))):
        fp32[label] = time_ns_case(
            label, admm_pallas.ns_fused, admm_pallas.ns_fused_ref, args, kw,
            n_need, M_of, n=5 if n_need == B else 20)
    k_ms, p_ms, b_ms, b_by, inv_ms = fp32[
        f"ns_fused cold ({st.ns_cold_iters} iterations) on {K} needy rows"]
    fused = dict(name="ns_fused", route="cuda",
                 source="mpc_arpo_project_tpu_torch/csrc/ns_inverse.cu",
                 replaces="mpc_arpo_project_tpu/ops/admm_pallas.py:119",
                 max_abs_err=max_ns, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                 bound_by=b_by, library_ms=inv_ms)

    # ---- newton_schulz_inverse on the per-problem M of _build_M for the
    # after-5-steps coefficients and rho scales, from the cold start
    coeffs = (coef[:, 1], coef[:, 2], coef[:, 3])
    M = admm._build_M(prob, coeffs, w7[:, 1], sigma).contiguous()
    X0 = admm_pallas.cold_start_inverse(M)
    max_inv = 0.0
    for dt, tol in ((torch.float32, 1e-4), (torch.float64, 1e-10)):
        err, _ = compare_inverse(
            admm_pallas.newton_schulz_inverse,
            admm_pallas.newton_schulz_inverse_ref, (M, X0),
            dict(n_iter=st.ns_cold_iters), dt, tol,
            f"newton_schulz_inverse {str(dt)[6:]}", record=record)
        if dt == torch.float32:
            max_inv = err
    Mk, X0k = M[rows].contiguous(), X0[rows].contiguous()
    i_ms, i_plain, i_bound, i_by, i_lib = time_ns_case(
        f"newton_schulz_inverse ({st.ns_cold_iters} iterations) on {K} "
        "problems", admm_pallas.newton_schulz_inverse,
        admm_pallas.newton_schulz_inverse_ref, (Mk, X0k),
        dict(n_iter=st.ns_cold_iters), None, Mk)
    inverse = dict(name="ns_inverse", route="cuda",
                   source="mpc_arpo_project_tpu_torch/csrc/ns_inverse.cu",
                   replaces="mpc_arpo_project_tpu/ops/admm_pallas.py:64",
                   max_abs_err=max_inv, ms=i_ms, plain_ms=i_plain,
                   bound_ms=i_bound, bound_by=i_by, library_ms=i_lib)
    return [chunk, fused, inverse]


def check_probe(B=1024, bt=32, n_it=25):
    """The six chunk-parts probe kernels at the probe's flagship shapes, in
    each of the original's precisions: each against its twin
    (``kernel_probe.check_against_twin`` on unit-gain inputs: per-row 1e-5;
    "high" over the iterations ``HIGH_TOL``; the bf16 variant and every
    "default" kernel at one iteration there and over ``n_it`` on
    ``exact_inputs``; launch counted), then timed as the probe times it on
    the same inputs, beside its twin, its bound, the stream floor and the
    groups the card holds at once; at "highest" also on the original's
    scales (where the matvec and stack7 iterates reach fp32's denormals).
    Returns the probe's JSON entry (without launches): the six "highest"
    kernels, as before."""
    from mpc_arpo_project_tpu_torch.tools import kernel_probe as kp

    t0 = time.perf_counter()
    unit = kp.make_inputs(B, bt, unit_gain=True)
    orig = kp.make_inputs(B, bt)
    nz, m = unit["x"].shape[1], unit["a0"].shape[0]
    total = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, max_abs_err=0.0)
    by = {"operations": 0.0, "bytes": 0.0}
    for precision in kp.PRECISIONS:
        sums = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for name, v in kp.variants(nz, m, bt).items():
            err = kp.check_against_twin(name, unit, n_it, precision)
            ms = kp.time_ms(name, unit, n_it, precision=precision)
            # the twins of "high" and "default" cost 5-50 ms a launch
            fast = precision == "highest"
            plain_ms = kp.time_ms(name, unit, n_it, loop=10 if fast else 3,
                                  reps=3 if fast else 2, twin=True,
                                  precision=precision)
            bound_ms, bound_by, executed_ms, stream_ms = probe_bound(
                name, unit, n_it, precision)
            groups = kp.capacity(name, precision, bt, nz, m)
            tf = 2 * v.macs * B * n_it / (ms * 1e-3) / 1e12
            extra = ""
            if fast:
                extra += (f"; original's scales "
                          f"{kp.time_ms(name, orig, n_it):.3f} ms")
                if v.executed != v.macs:
                    extra += (f"; executed MACs at fp32 peak "
                              f"{executed_ms:.3f} ms")
            log(f"  probe {v.label} [{precision}]: {ms:8.3f} ms/chunk "
                f"{ms / n_it * 1e3:8.1f} us/iter useful {tf:6.2f} TF/s; twin "
                f"{plain_ms:.3f} ms; bound {bound_ms:.3f} ms ({bound_by}); "
                f"matrix streamed every iteration {stream_ms:.3f} ms; "
                f"{groups} groups at once{extra}; vs twin " + json.dumps(err))
            sums["ms"] += ms
            sums["plain_ms"] += plain_ms
            sums["bound_ms"] += bound_ms
            if fast:
                total["ms"] += ms
                total["plain_ms"] += plain_ms
                total["bound_ms"] += bound_ms
                total["max_abs_err"] = max(total["max_abs_err"],
                                           err["max_abs_err"])
                by[bound_by] += bound_ms
        log(f"probe [{precision}], six kernels one launch each (B={B}, "
            f"bt={bt}, {n_it} iterations, fp32 inputs): kernels "
            f"{sums['ms']:.3f} ms, twins {sums['plain_ms']:.3f} ms, bounds "
            f"{sums['bound_ms']:.3f} ms (ms per chunk: best of 3 runs of 10 "
            "launches, the twins of high and default best of 2 of 3; CUDA "
            "events)")
    log(f"probe phase {time.perf_counter() - t0:.1f} s")
    return dict(name="kernel_probe", route="cuda",
                source="mpc_arpo_project_tpu_torch/csrc/kernel_probe.cu",
                replaces="tools/kernel_probe.py:142",
                bound_by=max(by, key=by.get), library_ms=None, **total)


def _counters():
    """Every kernel entry's launch counter, by name."""
    from mpc_arpo_project_tpu_torch.ops import admm_eig, admm_pallas, rk4_tick
    from mpc_arpo_project_tpu_torch.tools import kernel_probe as kp

    return dict(eig_chunk=admm_eig.eig_chunk,
                admm_chunk=admm_pallas.admm_chunk,
                ns_fused=admm_pallas.ns_fused,
                ns_inverse=admm_pallas.newton_schulz_inverse,
                rk4_tick=rk4_tick.rk4_tick,
                **{f"probe {n}": v.entry for n, v in kp.variants().items()})


def _read_counters(counters):
    launches = {n: fn.launches for n, fn in counters.items()}
    launches["kernel_probe"] = sum(launches.pop(n) for n in list(launches)
                                   if n.startswith("probe "))
    return launches


def main_path(engine, B, seed):
    """One flagship closed loop on the card, in the engine's solve mode:
    every kernel count is set to 0 just before and read just after; returns
    the counts and the numbers to report."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm
    from mpc_arpo_project_tpu_torch.rollout import discrete

    mode = engine.settings.solve_mode
    # (span label, function timed by CUDA events) for the per-step split
    if mode == "eig":
        timed_fns = (("chunk_kernel", "eig_chunk"),
                     ("tinv_safe_refresh", "tinv_safe_refresh"))
        path_kernels, rest_name = ("eig_chunk",), "host_syncs_and_glue"
    elif mode == "pallas":
        timed_fns = (("chunk_kernel", "admm_chunk"),
                     ("masked_safe_refresh", "masked_safe_refresh"))
        path_kernels = ("admm_chunk", "ns_fused")
        rest_name = "host_syncs_and_glue"
    else:
        timed_fns = (("factorizations", "_chol_factor"),
                     ("triangular_solves", "_chol_solve"))
        path_kernels, rest_name = (), "matvecs_certificates_and_glue"
    mod = admm if mode == "chol" else _solver_module(mode)
    counters = _counters()
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noise = discrete.make_noise_sequence(engine, gen, B)
    spans = {fn: [] for _, fn in timed_fns}
    census = []

    def timed(name, fn):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return call

    def censused(fn):
        """``ns_fused`` recording each call's rows, need count (kept on the
        device, read after the run), warm/cold, n_iter and CUDA-event span."""
        def call(stack, w, X_prev, need, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(stack, w, X_prev, need, **k)
            e1.record()
            census.append((X_prev.shape[0], bool(k["cold"]), k["n_iter"],
                           need.sum(), e0, e1))
            return out
        return call

    def chunk_censused(name):
        """The chunk kernel ``name`` (``eig_chunk`` or ``admm_chunk``)
        recording each call's rows (the lane width B_l), n_iter, live count
        (kept on the device, read after the run) and CUDA-event span, which
        also counts in the chunk span of the split."""
        fn = getattr(mod, name)

        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            chunks.append((k["done"].shape[0], k["n_iter"],
                           (~k["done"]).sum(), e0, e1))
            return out
        return call

    chunks = []
    wrapped = {fn: timed(fn, getattr(mod, fn)) for _, fn in timed_fns}
    if mode == "pallas":
        wrapped["ns_fused"] = censused(mod.ns_fused)
        wrapped["admm_chunk"] = chunk_censused("admm_chunk")
    if mode == "eig":
        wrapped["eig_chunk"] = chunk_censused("eig_chunk")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _solver_calls(mode, **wrapped):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = discrete.rollout_chunked(
            engine, noise, seg=10,
            progress=lambda d, t, c: log(f"  [{mode}] step {d}/{t}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(counters)
    ms = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) for k, v in spans.items()}

    T = engine.nsim
    status = out.status.cpu()
    alive = out.ctrl_seq.cpu() > 0
    for name in path_kernels:
        if launches[name] <= 0:
            raise AssertionError(f"the {mode} main path launched no {name} "
                                 "kernel")
    if not ((status[alive] >= 0) & (status[alive] <= 4)).all():
        raise AssertionError("alive status outside {0..4}")
    if not (status[~alive] == -1).all():
        raise AssertionError("dead-step status is not -1")
    for name in ("x_true", "x_est", "ctrls"):
        if not torch.isfinite(getattr(out, name)).all():
            raise AssertionError(f"non-finite {name}")
    expect = {"x_true": (T + 1, B, 4), "x_est": (T + 1, B, 6),
              "ctrls": (T + 1, B, 2), "status": (T, B)}
    for name, shape in expect.items():
        if tuple(getattr(out, name).shape) != shape:
            raise AssertionError(f"{name} shape {tuple(getattr(out, name).shape)}")
    n_alive = int(alive.sum())
    names = {0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER", 3: "PINF", 4: "DINF"}
    mix = {v: int((status[alive] == k).sum()) / max(n_alive, 1)
           for k, v in names.items()}
    wall_ms = wall * 1000.0
    split = {"total": wall_ms / T}
    split.update({label: ms[fn] / T for label, fn in timed_fns})
    split[rest_name] = (wall_ms - sum(ms.values())) / T
    rep_census = refresh_census(census, T, ms.get("masked_safe_refresh"))
    span = ms.get(path_kernels[0]) if path_kernels else None
    ch_census = chunk_census(chunks, T, span, by_rows=mode == "pallas")
    return launches, dict(
        solve_mode=mode, dtype=str(engine.dtype)[6:], steps=T, batch=B,
        wall_s=wall, alive_steps=n_alive,
        alive_solves_per_s=n_alive / wall, status_mix_alive=mix,
        mean_admm_iters_per_step=float(out.iters.float().mean()),
        success_rate=float(out.success.float().mean()),
        per_step_ms=split,
        timed_calls_per_step={label: len(spans[fn]) / T
                              for label, fn in timed_fns},
        launches=launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
        **({"refresh_census": rep_census} if census else {}),
        **({"chunk_census": ch_census} if chunks else {}),
    )


_LIVE_BUCKETS = ((1, 32), (33, 128), (129, 512), (513, 1152))


def chunk_census(calls, T, span_ms, by_rows=False):
    """Group a main path's chunk-kernel calls by live bucket (and, with
    ``by_rows``, also by lane width B_l and live bucket): calls, ms per
    step and per call, mean live count, the n_iter values seen and the
    share of the chunk span; logs one line per class."""
    def bucket(k):
        return (next((lo, hi) for lo, hi in _LIVE_BUCKETS if k <= hi) if k
                else (0, 0))

    groups = {}
    for rows, n_iter, live, e0, e1 in calls:
        k = int(live)
        keys = [("all", bucket(k))]
        if by_rows:
            keys.append((rows, bucket(k)))
        for key in keys:
            g = groups.setdefault(key, [0, 0.0, 0, set()])
            g[0] += 1
            g[1] += e0.elapsed_time(e1)
            g[2] += k
            g[3].add(n_iter)
    out = []
    order = lambda kv: (kv[0][0] != "all", str(kv[0][0]).zfill(5), kv[0][1])
    for ((rows, (lo, hi)), (n, t, k, iters)) in sorted(groups.items(),
                                                        key=order):
        out.append(dict(rows=rows, live=f"{lo}-{hi}", calls_per_step=n / T,
                        ms_per_step=t / T, ms_per_call=t / n,
                        mean_live=k / n, n_iter=sorted(iters),
                        share_of_chunk_span=t / span_ms if span_ms else None))
        lane = "" if rows == "all" else f"B_l={rows} "
        log(f"  chunk census: {lane}live {lo}-{hi}: {n / T:.2f} calls/step, "
            f"{t / T:.3f} ms/step, {t / n:.3f} ms/call, mean live "
            f"{k / n:.1f}, n_iter {sorted(iters)}, "
            + (f"{100 * t / span_ms:.1f}% of the chunk span"
               if span_ms else ""))
    return out


_NEED_BUCKETS = ((1, 1), (2, 8), (9, 32), (33, 128), (129, 512),
                 (513, 1 << 30))


def refresh_census(calls, T, span_ms):
    """Group the main path's ``ns_fused`` calls by (rows B_l, warm/cold,
    needy bucket): calls and ms per step, share of the refresh span; logs
    one line per class, costliest first."""
    groups = {}
    for rows, cold, n_iter, needy, e0, e1 in calls:
        k = int(needy)
        lo, hi = next(b for b in _NEED_BUCKETS if b[0] <= k <= b[1]) if k \
            else (0, 0)
        g = groups.setdefault((rows, "cold" if cold else "warm", n_iter,
                               f"{lo}-{hi}" if hi < 1 << 30 else f">={lo}"),
                              [0, 0.0, 0])
        g[0] += 1
        g[1] += e0.elapsed_time(e1)
        g[2] += k
    out = []
    for (rows, kind, n_iter, bucket), (n, t, k) in sorted(
            groups.items(), key=lambda kv: -kv[1][1]):
        out.append(dict(rows=rows, start=kind, n_iter=n_iter, needy=bucket,
                        calls_per_step=n / T, ms_per_step=t / T,
                        mean_needy=k / n, ms_per_call=t / n,
                        share_of_refresh=t / span_ms if span_ms else None))
        log(f"  refresh census: B_l={rows} {kind} ({n_iter} it.) needy "
            f"{bucket}: {n / T:.2f} calls/step, {t / T:.3f} ms/step, "
            f"{t / n:.3f} ms/call, mean needy {k / n:.1f}, "
            + (f"{100 * t / span_ms:.1f}% of the refresh span"
               if span_ms else ""))
    return out


def small_agreement(seed, solve_mode, settings_kw=None, **engine_kw):
    """4 fp64 control steps at B=8: the card (kernels) against the CPU
    (twins); ``settings_kw`` changes the solver settings and ``engine_kw``
    goes to ``build_engine``."""
    import torch
    from mpc_arpo_project_tpu_torch.rollout import discrete

    outs = []
    rng = np.random.default_rng(seed)
    draws = None
    kw = {**(settings_kw or {}), **engine_kw}
    label = " ".join([solve_mode] + [f"{k}={v}" for k, v in kw.items()])
    for device in ("cuda", "cpu"):
        eng = flagship(2.0, device, torch.float64, solve_mode, settings_kw,
                       **engine_kw)
        if draws is None:
            draws = rng.standard_normal((eng.nsim // eng.noise_rep + 2, 8, 4))
        ns = discrete.noise_sequence_from_draws(eng, draws)
        outs.append(discrete.rollout(eng, ns))
    _agree(label, outs)


def _agree(label, outs):
    """A B=8 run on the card against the same run on the CPU: statuses,
    controller codes, termination, success and ``done_iters`` equal,
    trajectories within 1e-6."""
    import torch

    g, c = outs
    for name in ("status", "ctrl_seq", "i_term", "success", "done_iters"):
        if not torch.equal(getattr(g, name).cpu(), getattr(c, name)):
            raise AssertionError(f"small agreement ({label}): {name} "
                                 f"differs\n{getattr(g, name).cpu()}\n"
                                 f"{getattr(c, name)}")
    dx = float((g.x_true.cpu() - c.x_true).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"small agreement ({label}): x_true differs "
                             f"by {dx}")
    log(f"  [{label}] {c.status.shape[0]} steps, B={c.status.shape[1]}, "
        f"fp64: statuses, controller codes, termination, success and "
        f"done_iters equal; max |x_true diff| = {dx:.3e}")


# ---------------------------------------------------------------------------
# the continuous closed loop (radialC) and its tick kernel
# ---------------------------------------------------------------------------

# operations of one substep of ``csrc/rk4_tick.cu`` (a power, a division,
# an arctangent or a square root counts as one): an alive scenario's RK4
# step (4 derivative evaluations of 20, 24 for the stage states, 28 for
# the combination), the held draw (2) and the checks (18); a dead one still
# makes the termination check (6)
RK4_OPS_ALIVE = 152
RK4_OPS_DEAD = 6

# the continuous main path's length: 139 ticks of 500 substeps (the
# scenarios of the radialC run end near 64 s)
CONT_T_FINAL = 70.0


def _tick_states(out):
    """x_end, x_after_first and (with telemetry) every substep's state, one
    row per scenario, in fp64."""
    import torch

    parts = [out[0], out[4]]
    if out[5] is not None:
        parts.append(out[5].transpose(0, 1).reshape(out[0].shape[0], -1))
    return torch.cat(parts, 1).double()


def _mask_diffs(out, ref):
    """Scenarios whose alive, termination substep or success differ."""
    return {n: int((out[i] != ref[i]).sum())
            for i, n in ((1, "alive"), (2, "i_term_sub"), (3, "success"))}


def rk4_bound(plant, args, out, j):
    """The least time of one tick: operations over the fp32 or fp64 peak
    (alive scenario-substeps of this run's data at ``RK4_OPS_ALIVE``, the
    rest at ``RK4_OPS_DEAD``) against the bytes (each input read once, the
    one held draw of the tick, each output written once) over HBM rate."""
    import torch

    x, alive, i_term = args[0], args[1], out[2]
    B, n_sub = x.shape[0], plant.n_sub
    g0 = j * n_sub
    died = alive & ~out[1]
    live_sub = torch.where(died, i_term - g0, torch.where(alive, n_sub, 0))
    n_live = int(live_sub.sum())
    flops = RK4_OPS_ALIVE * n_live + RK4_OPS_DEAD * (B * n_sub - n_live)
    draws = args[6]
    n_held = ((g0 + n_sub - 1) // plant.noise_int_sub
              - g0 // plant.noise_int_sub + 1)
    nbytes = (sum(t.numel() * t.element_size() for t in args[:6])
              + n_held * draws[0].numel() * draws.element_size()
              + sum(t.numel() * t.element_size() for t in out
                    if t is not None))
    peak = PEAK_FP64 if x.dtype == torch.float64 else PEAK_FP32
    return _bound(flops, nbytes, peak)


def check_rk4_tick(engine, B=1024, j=37):
    """``rk4_tick`` against its twin at batch ``B`` on the inputs of
    ``tests/torch_helpers.tick_inputs`` (states spread over the approach,
    scenarios placed to dock and to terminate within the tick, dead and
    successful ones, the radialC draws), on the engine's plant: both input models (acceleration and
    delta-v), telemetry on and off, fp32 and fp64. fp64: the masks (alive,
    termination substep, success) equal and the states within 1e-9. fp32:
    each scenario's states within 1e-4 of the fp32 twin or no farther from
    the fp64 twin than 4x the fp32 twin plus 1e-4 (the chunk kernels'
    rule); mask disagreements are printed. Then timed (CUDA events) in
    fp32 and fp64 beside the fp32 twin, with its bound and the latency of
    the substep chain (one warp of 32 scenarios). Returns the JSON entry
    (without launches)."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import rk4_tick as rk

    sys.path.insert(0, TESTS)
    from torch_helpers import tick_inputs

    max_abs = 0.0
    base64 = tuple(v.cuda() for v in tick_inputs(engine.plant, B, 21, j)[0])
    for delta_v in (False, True):
        plant = engine.plant._replace(is_delta_v=delta_v)
        for telemetry in (False, True):
            ref64 = rk.rk4_tick_plain(*base64, j, plant, telemetry)
            for dt in (torch.float64, torch.float32):
                label = (f"rk4_tick {str(dt)[6:]}, "
                         f"{'delta-v' if delta_v else 'acceleration'}, "
                         f"telemetry {'on' if telemetry else 'off'}")
                a = tuple(v.to(dt) if v.is_floating_point() else v
                          for v in base64)
                ker = _launch(rk.rk4_tick, a + (j, plant),
                              dict(telemetry=telemetry), label)
                ref = rk.rk4_tick_plain(*a, j, plant, telemetry)
                e = (_tick_states(ker) - _tick_states(ref)).abs().amax(1)
                masks = _mask_diffs(ker, ref)
                summary = dict(
                    max_abs_err=float(e.max()), terminated=int(
                        (a[1] & ~ker[1]).sum()),
                    newly_successful=int((ker[3] & ~a[3]).sum()),
                    mask_diffs_vs_twin=masks)
                if dt == torch.float64:
                    ok = not any(masks.values()) and float(e.max()) <= 1e-9
                else:
                    e_k = (_tick_states(ker) - _tick_states(ref64)).abs().amax(1)
                    e_t = (_tick_states(ref) - _tick_states(ref64)).abs().amax(1)
                    worse = (e > 1e-4) & (e_k > 4.0 * e_t + 1e-4)
                    for row in torch.nonzero(worse).squeeze(1).tolist()[:20]:
                        log(f"  [{label}] row {row}: vs fp64 kernel "
                            f"{float(e_k[row]):.3e}, fp32 twin "
                            f"{float(e_t[row]):.3e}")
                    summary.update(mask_diffs_vs_fp64_twin=_mask_diffs(ker,
                                                                       ref64),
                                   max_err_vs_fp64_kernel=float(e_k.max()),
                                   max_err_vs_fp64_twin=float(e_t.max()))
                    ok = not bool(worse.any())
                    if not (delta_v or telemetry):
                        max_abs = float(e.max())
                log(f"  [{label}] {json.dumps(summary)}")
                if not ok:
                    raise AssertionError(f"{label}: kernel and plain version "
                                         f"disagree: {summary}")
    a = tuple(v.float() if v.is_floating_point() else v for v in base64)
    plant = engine.plant
    ms = time_ms(lambda: rk.rk4_tick(*a, j, plant))
    plain_ms = time_ms(lambda: rk.rk4_tick_plain(*a, j, plant), 3)
    ms64 = time_ms(lambda: rk.rk4_tick(*base64, j, plant))
    ms_tel = time_ms(lambda: rk.rk4_tick(*a, j, plant, telemetry=True))
    warp = tuple(v[:32] for v in a[:6]) + (a[6][:, :32].contiguous(),)
    chain_ms = time_ms(lambda: rk.rk4_tick(*warp, j, plant))
    bound_ms, bound_by = rk4_bound(plant, a, rk.rk4_tick(*a, j, plant), j)
    bound64, by64 = rk4_bound(plant, base64, rk.rk4_tick(*base64, j, plant),
                              j)
    log(f"rk4_tick, {plant.n_sub} substeps, B={B}: fp32 kernel {ms:.4f} ms "
        f"(telemetry on {ms_tel:.4f} ms), fp64 kernel {ms64:.4f} ms, fp32 "
        f"plain {plain_ms:.3f} ms (median of 20; plain of 3; CUDA events); "
        f"bound fp32 {bound_ms:.5f} ms ({bound_by}), fp64 {bound64:.5f} ms "
        f"({by64}); the substep chain of one warp (32 scenarios), fp32: "
        f"{chain_ms:.4f} ms")
    return dict(name="rk4_tick", route="cuda",
                source="mpc_arpo_project_tpu_torch/csrc/rk4_tick.cu",
                replaces="mpc_arpo_project_tpu/rollout/continuous.py:207-269 "
                         "(an XLA lax.scan; no pallas_call)",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def continuous_main_path(engine, B, seed):
    """The continuous closed loop on the card: every kernel count set to 0
    just before and read just after; per tick the solve span
    (``admm_solve``) and the ``rk4_tick`` span from CUDA events, the rest
    from the host clock; returns the counts and the numbers to report."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm, rk4_tick as rk
    from mpc_arpo_project_tpu_torch.rollout import continuous

    counters = _counters()
    gen = torch.Generator(device=engine.base.device).manual_seed(seed)
    draws = continuous.make_noise_draws(engine, gen, B)
    spans = {"solve": [], "rk4_tick": []}

    def timed(name, fn):
        def call(*a, **k):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            spans[name].append((e0, e1))
            return out
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with _patched(admm, admm_solve=timed("solve", admm.admm_solve)), \
            _patched(rk, rk4_tick=timed("rk4_tick", rk.rk4_tick)):
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        out = continuous.rollout_chunked(
            engine, draws, seg=20,
            progress=lambda d, t, c: log(f"  [continuous] tick {d}/{t}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_counters(counters)
    ms = {k: sum(e0.elapsed_time(e1) for e0, e1 in v) for k, v in spans.items()}

    n_ticks = engine.n_ticks - 1  # ticks run j = 1 .. n_ticks-1
    n_total = engine.n_ticks * engine.n_sub
    if launches["rk4_tick"] != n_ticks:
        raise AssertionError(f"rk4_tick launched {launches['rk4_tick']} "
                             f"times in {n_ticks} ticks")
    if launches["eig_chunk"] <= 0:
        raise AssertionError("the continuous main path launched no eig_chunk")
    status = out.status.cpu()
    codes = out.ctrl_seq.cpu()
    alive = codes > 0
    if not ((status[alive] >= 0) & (status[alive] <= 4)).all():
        raise AssertionError("alive status outside {0..4}")
    if not (status[~alive] == -1).all():
        raise AssertionError("dead-tick status is not -1")
    expect = {"x_true_ticks": (engine.n_ticks + 1, B, 4),
              "x_est": (engine.n_ticks + 1, B, 6),
              "ctrls": (engine.n_ticks + 1, B, 2), "status": (n_ticks, B),
              "i_term_sub": (B,)}
    for name, shape in expect.items():
        v = getattr(out, name)
        if tuple(v.shape) != shape:
            raise AssertionError(f"{name} shape {tuple(v.shape)}")
        if v.is_floating_point() and not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    i_term = out.i_term_sub.cpu()
    if not ((i_term >= engine.n_sub) & (i_term <= n_total)).all():
        raise AssertionError("i_term_sub outside [n_sub, n_total]")
    n_alive = int(alive.sum())
    names = {0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER", 3: "PINF", 4: "DINF"}
    mix = {v: int((status[alive] == k).sum()) / max(n_alive, 1)
           for k, v in names.items()}
    ctrl_names = {1: "mpc", 2: "failsafe", 3: "debris_deadbeat"}
    ctrl_mix = {v: int((codes[alive] == k).sum()) / max(n_alive, 1)
                for k, v in ctrl_names.items()}
    wall_ms = wall * 1000.0
    alive_sub = int((i_term.long() - engine.n_sub).sum())
    q = torch.quantile(i_term.double(), torch.tensor(
        [0.0, 0.25, 0.5, 0.75, 1.0], dtype=torch.float64)).tolist()
    return launches, dict(
        config="radialC (examples/common.py, noisy, T_cont=1e-3), Nx=40",
        solve_mode=engine.base.settings.solve_mode,
        dtype=str(engine.base.dtype)[6:], ticks=n_ticks,
        substeps_per_tick=engine.n_sub, batch=B, wall_s=wall,
        per_tick_ms={"total": wall_ms / n_ticks,
                     "solve": ms["solve"] / n_ticks,
                     "rk4_tick": ms["rk4_tick"] / n_ticks,
                     "rest": (wall_ms - ms["solve"] - ms["rk4_tick"]) / n_ticks},
        scenario_substeps_per_s=B * n_ticks * engine.n_sub / wall,
        alive_scenario_substeps_per_s=alive_sub / wall,
        alive_ticks=n_alive, alive_solves_per_s=n_alive / wall,
        status_mix_alive=mix, controller_mix_alive=ctrl_mix,
        mean_admm_iters_per_tick=float(out.iters.float().mean()),
        docked_share=float(out.success.float().mean()),
        terminated_share=float((i_term < n_total).float().mean()),
        i_term_sub_quartiles=q,
        launches=launches,
        max_memory_allocated_bytes=torch.cuda.max_memory_allocated(),
    )


def continuous_agreement(seed, solve_mode):
    """3 s of the fp64 continuous loop (5 ticks of 500 substeps) at B=8 on
    the card (kernels) and on the CPU (twins), from initial states that
    include one that docks and one that terminates on its first tick."""
    import torch
    from mpc_arpo_project_tpu_torch.rollout import continuous

    rng = np.random.default_rng(seed)
    x0b = np.concatenate([rng.uniform(3.5, 60, (8, 1)),
                          rng.uniform(-5, 5, (8, 1)), np.zeros((8, 2))], 1)
    x0b[1] = [3.1, 0.05, -0.4, 0.0]
    x0b[3] = [0.8, 3.0, 0.1, -0.3]
    outs, draws = [], None
    for device in ("cuda", "cpu"):
        eng = radial_c(3.0, device, torch.float64, solve_mode)
        if draws is None:
            n_draws = eng.n_ticks * eng.n_sub // eng.noise_int_sub + 2
            draws = float(eng.sig_cont) * rng.standard_normal((n_draws, 8, 2))
        outs.append(continuous.rollout(eng, draws, torch.as_tensor(x0b)))
    g, c = outs
    for name in ("status", "ctrl_seq", "i_term_sub", "success", "done_iters"):
        if not torch.equal(getattr(g, name).cpu(), getattr(c, name)):
            raise AssertionError(f"continuous agreement ({solve_mode}): {name}"
                                 f" differs\n{getattr(g, name).cpu()}\n"
                                 f"{getattr(c, name)}")
    dx = float((g.x_true_ticks.cpu() - c.x_true_ticks).abs().max())
    if dx > 1e-6:
        raise AssertionError(f"continuous agreement ({solve_mode}): "
                             f"x_true_ticks differs by {dx}")
    log(f"  [continuous {solve_mode}] 5 ticks of 500 substeps, B=8, fp64: "
        f"statuses, codes, i_term_sub {c.i_term_sub.tolist()}, success "
        f"{c.success.tolist()} and done_iters equal; max |x_true_ticks "
        f"diff| = {dx:.3e}")


# ---------------------------------------------------------------------------
# the Monte-Carlo sweeps over torch.distributed (NCCL)
# ---------------------------------------------------------------------------

# the sweep phase's sizes: chunks of 1024 flagship scenarios (the width of
# every other cell), two of them (``examples/pod_sweep.py`` runs 4096);
# the fused study of ``examples/disturb_rej_comp.py --quick`` (sigma 0.7,
# hold lengths 10, 50, 150 steps) with 170 runs a setting, so 2 arms x 3
# lengths x 170 = 1020 scenarios in one batch, cut from its 50 s to 35 s
# (70 steps; the batch-composition check's fp64 run too) to leave the
# bench phase its full depth: flagship scenarios start to terminate from
# about step 50 (3 of 16 by step 100 in a CPU run)
SWEEP_TOTAL, SWEEP_CHUNK = 2048, 1024
STUDY_HOLDS, STUDY_RUNS, STUDY_SIGMA, STUDY_T_FINAL = (10, 50, 150), 170, 0.7, 35.0
# the continuous branch of ``chunk_stats``: 20 ticks run (j = 1 .. 20)
SWEEP_CONT_T_FINAL = 10.5


def _sweep_counts(res):
    """The counts of a ``run_sweep`` result, by name."""
    return dict(n=res["n"], success_rate=res["success_rate"],
                mean_i_term=res["mean_i_term"],
                total_admm_iters=res["total_admm_iters"], **res["ctrl_usage"])


def _composition(engine, B, seed):
    """One batch of ``B`` against its two halves on the same draws, each
    rolled out directly: the per-scenario termination step, success and
    controller codes, and the chunk statistics of the whole against the sum
    over the halves (every count but ``sum_iters``, which sums per-step
    batch maxima, and the final-distance sum by its relative difference).
    Returns (scenarios that differ, stats that differ, relative difference
    of the final-distance sums, scenarios of the whole batch that
    terminated before the last step, that succeeded)."""
    import torch
    from mpc_arpo_project_tpu_torch.parallel import mc
    from mpc_arpo_project_tpu_torch.rollout import discrete

    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noise = discrete.make_noise_sequence(engine, gen, B)
    w, a, b = (discrete.rollout(engine, n)
               for n in (noise, noise[:, :B // 2], noise[:, B // 2:]))
    cat = lambda name: torch.cat([getattr(a, name), getattr(b, name)], -1)
    same = ((w.i_term == cat("i_term")) & (w.success == cat("success"))
            & (w.ctrl_seq == cat("ctrl_seq")).all(0))
    whole, *halves = (mc._out_stats(engine, o)[0] for o in (w, a, b))
    differ = [k for k in ("n", "n_success", "sum_i_term", "n_mpc",
                          "n_failsafe", "n_deadbeat")
              if int(getattr(whole, k)) != sum(int(getattr(h, k))
                                               for h in halves)]
    fd = sum(float(h.sum_final_dist) for h in halves)
    rel = abs(float(whole.sum_final_dist) - fd) / abs(float(
        whole.sum_final_dist))
    return (int((~same).sum()), differ, rel,
            int((w.i_term < engine.nsim).sum()), int(w.success.sum()))


def _study_direct(sim, mpc, fail, debris, seed, **engine_kw):
    """The fused study's batch (the engine, draws and per-scenario
    ``is_reject`` that ``disturbance_rejection_study_fused`` builds from
    the same arguments) rolled out directly in this process. Returns the
    output, the steps and the ratios of its final-distance sums."""
    import dataclasses
    import torch
    from mpc_arpo_project_tpu_torch.parallel import mc
    from mpc_arpo_project_tpu_torch.rollout import discrete

    L, R = len(STUDY_HOLDS), STUDY_RUNS
    engine = discrete.build_engine(
        dataclasses.replace(sim, isReject=True), mpc, fail, debris,
        **engine_kw)
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    half = discrete.make_noise_sequence_multi(
        engine, gen, np.repeat(np.asarray(STUDY_HOLDS, dtype=np.int64), R))
    kw = dict(dtype=engine.dtype, device=engine.device)
    is_rej = torch.cat([torch.ones(L * R, **kw), torch.zeros(L * R, **kw)])
    out = discrete.rollout(engine, torch.cat([half, half], 1),
                           is_reject_b=is_rej)
    sums = mc._final_distance(out, engine.xr).reshape(2, L, R).sum(-1)
    sums = sums.cpu().double().numpy()
    return out, engine.nsim, sums[0] / np.maximum(sums[1], 1e-12)


def _dryrun():
    """``graft_entry.dryrun_multichip`` over the process group's one rank:
    its statistics and its printed line."""
    from mpc_arpo_project_tpu_torch import graft_entry

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        st = graft_entry.dryrun_multichip(1)
    return st, buf.getvalue()


def sweep_phase(eig_engine, seed):
    """The sweeps on the card over an NCCL process group of one rank: a
    chunked, checkpointed ``run_sweep`` of the flagship 'eig' engine, its
    resume from a checkpoint cut after chunk 0, the batch-composition
    checks, the fused disturbance-rejection study, the continuous branch
    of ``chunk_stats`` and the entry programs' ``dryrun_multichip``. Every
    kernel count is set to 0 just before each part and read just after;
    returns the counts summed over the runs of the sweep path (the sweep,
    the study, the continuous chunk and the dry run, not the checks) and
    the report."""
    import torch
    import torch.distributed as dist
    from mpc_arpo_project_tpu_torch.ops import _build
    from mpc_arpo_project_tpu_torch.parallel import mc, mesh as mesh_lib
    from mpc_arpo_project_tpu_torch.rollout import continuous

    counters = _counters()
    launches = {}

    def part(fn, path):
        """``fn()`` with the counts from 0, its wall time (host clock, the
        device synchronised) and its launches; those of a ``path`` (a run
        of the sweep path, not a check) are added to the phase's."""
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _read_counters(counters)
        if path:
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
        return res, wall, {k: v for k, v in got.items() if v}

    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"backend {dist.get_backend()}, not nccl")
        mesh = mesh_lib.make_mesh()
        torch.cuda.reset_peak_memory_stats()
        ck = os.path.join(_build.BUILD, "sweep_checkpoint.json")
        ck0 = os.path.join(_build.BUILD, "sweep_checkpoint_cut.json")
        os.makedirs(_build.BUILD, exist_ok=True)
        for p in (ck, ck0):
            if os.path.exists(p):
                os.remove(p)
        n_chunks = SWEEP_TOTAL // SWEEP_CHUNK

        # 1. the chunked, checkpointed sweep
        res, wall, sw_launch = part(lambda: mc.run_sweep(
            eig_engine, SWEEP_TOTAL, SWEEP_CHUNK, seed, mesh=mesh,
            checkpoint_path=ck), path=True)
        with open(ck) as fh:
            if json.load(fh)["next_chunk"] != n_chunks:
                raise AssertionError("the checkpoint did not reach the end")
        if res["n"] != SWEEP_TOTAL:
            raise AssertionError(f"sweep n {res['n']}")
        if not np.isfinite(res["mean_final_dist"]):
            raise AssertionError("non-finite mean final distance")
        alive = sum(res["ctrl_usage"].values())
        if not 0 < alive <= eig_engine.nsim * SWEEP_TOTAL:
            raise AssertionError(f"{alive} alive steps")
        sweep = dict(
            total=SWEEP_TOTAL, chunk=SWEEP_CHUNK, steps=eig_engine.nsim,
            wall_s=wall, wall_per_chunk_s=wall / n_chunks,
            scenarios_per_s=res["n"] / wall, alive_solves=alive,
            alive_solves_per_s=alive / wall, launches=sw_launch, **res)
        log("  [sweep] " + json.dumps(sweep))

        # 2. resume from a checkpoint cut after chunk 0: the acc of a
        # one-chunk sweep with the same seed, relabelled as the 2-chunk one
        def resumed():
            mc.run_sweep(eig_engine, SWEEP_CHUNK, SWEEP_CHUNK, seed, mesh=mesh,
                         checkpoint_path=ck0)
            with open(ck0) as fh:
                state = json.load(fh)
            if state["next_chunk"] != 1:
                raise AssertionError("the cut checkpoint is not after chunk 0")
            state["total"] = SWEEP_TOTAL
            with open(ck0, "w") as fh:
                json.dump(state, fh)
            return mc.run_sweep(eig_engine, SWEEP_TOTAL, SWEEP_CHUNK, seed,
                                mesh=mesh, checkpoint_path=ck0)
        res2, wall2, res_launch = part(resumed, path=False)
        if _sweep_counts(res2) != _sweep_counts(res):
            raise AssertionError(f"resumed counts {_sweep_counts(res2)} != "
                                 f"{_sweep_counts(res)}")
        rel = abs(res2["mean_final_dist"] - res["mean_final_dist"]) / abs(
            res["mean_final_dist"])
        if rel > 1e-6:
            raise AssertionError(f"resumed mean final distance off by {rel}")
        resume = dict(counts_equal=True, mean_final_dist_rel_diff=rel,
                      bit_identical=res2 == res, wall_s=wall2,
                      launches=res_launch)
        log("  [sweep resume] " + json.dumps(resume))

        # 3. batch composition: a batch against its two halves; in fp64 at
        # the study's depth, where scenarios terminate (none succeeds at the
        # flagship's noise: success asks for 0.2 m of the target)
        eng64 = flagship(STUDY_T_FINAL, "cuda", torch.float64, "eig")
        (n64, differ64, rel64, term64, succ64), wall64, l64 = part(
            lambda: _composition(eng64, 256, seed + 1), path=False)
        if n64 or differ64 or rel64 > 1e-9:
            raise AssertionError(
                f"fp64 B=256 against its halves: {n64} scenarios and stats "
                f"{differ64} differ, final distance by {rel64}")
        if not term64:
            raise AssertionError(
                f"fp64 B=256: no scenario terminated in {eng64.nsim} steps")
        (n32, differ32, rel32, term32, succ32), wall32, l32 = part(
            lambda: _composition(eig_engine, SWEEP_CHUNK, seed + 2),
            path=False)
        composition = dict(
            fp64_B256=dict(steps=eng64.nsim, scenarios_differing=n64,
                           stats_differing=differ64,
                           final_dist_rel_diff=rel64, terminated=term64,
                           succeeded=succ64, wall_s=wall64, launches=l64),
            fp32_B1024=dict(steps=eig_engine.nsim, scenarios_differing=n32,
                            stats_differing=differ32,
                            final_dist_rel_diff=rel32, terminated=term32,
                            succeeded=succ32, wall_s=wall32, launches=l32))
        log("  [sweep composition] " + json.dumps(composition))
        del eng64

        # 4. the fused disturbance-rejection study, then its batch rolled
        # out directly (a check: its ratios, status mix and terminations)
        mpc, fail, debris = _parts(50)
        sim = flagship_sim(STUDY_T_FINAL, STUDY_SIGMA)
        kw = dict(settings=_settings("eig"), dtype=torch.float32,
                  device="cuda")
        (nls, ratios), wall_st, st_launch = part(
            lambda: mc.disturbance_rejection_study_fused(
                sim, mpc, fail, debris, list(STUDY_HOLDS), STUDY_RUNS, seed,
                mesh=mesh, **kw), path=True)
        if not (np.isfinite(ratios).all() and (ratios > 0).all()):
            raise AssertionError(f"study ratios {ratios}")
        (out, nsim, ratios_d), wall_d, l_d = part(
            lambda: _study_direct(sim, mpc, fail, debris, seed, **kw),
            path=False)
        ratio_rel = float(np.max(np.abs(ratios_d - ratios) / ratios))
        if ratio_rel > 1e-6:
            raise AssertionError(f"study ratios {ratios}, its batch rolled "
                                 f"out directly {ratios_d}")
        n_sc = 2 * len(STUDY_HOLDS) * STUDY_RUNS
        if tuple(out.x_true.shape) != (nsim + 1, n_sc, 4):
            raise AssertionError(f"study x_true {tuple(out.x_true.shape)}")
        live = out.ctrl_seq > 0
        alive_st = int(live.sum())
        status = out.status[live]
        term_st = int((out.i_term < nsim).sum())
        if not term_st:
            raise AssertionError(f"no study scenario terminated in {nsim} "
                                 "steps")
        study_rep = dict(
            sigma=STUDY_SIGMA, hold_steps=list(STUDY_HOLDS),
            runs_per_setting=STUDY_RUNS, scenarios=n_sc, steps=nsim,
            ratios=[float(r) for r in ratios], wall_s=wall_st,
            scenarios_per_s=n_sc / wall_st, alive_solves=alive_st,
            alive_solves_per_s=alive_st / wall_st,
            direct=dict(ratios_max_rel_diff=ratio_rel,
                        bit_identical=bool((ratios_d == ratios).all()),
                        wall_s=wall_d, launches=l_d, terminated=term_st,
                        succeeded=int(out.success.sum()),
                        mean_admm_iters_per_step=float(
                            out.iters.float().mean()),
                        status_mix_alive={
                            n: int((status == k).sum()) / alive_st
                            for k, n in ((1, "SOLVED"), (2, "MAX_ITER"),
                                         (3, "PINF"), (4, "DINF"))}),
            launches=st_launch)
        log("  [sweep study] " + json.dumps(study_rep))
        del out

        # 5. the continuous branch of chunk_stats, reduced over the mesh
        ceng = radial_c(SWEEP_CONT_T_FINAL, "cuda", torch.float32, "eig")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        draws = continuous.make_noise_draws(ceng, gen, SWEEP_CHUNK)
        cst, wall_c, c_launch = part(
            lambda: mc.sharded_stats_fn(ceng, mesh)(ceng, draws), path=True)
        n_ticks = ceng.n_ticks - 1
        if c_launch.get("rk4_tick") != n_ticks or not c_launch.get("eig_chunk"):
            raise AssertionError(f"continuous chunk_stats launches {c_launch}")
        if cst.n != SWEEP_CHUNK or not np.isfinite(cst.sum_final_dist):
            raise AssertionError(f"continuous chunk_stats {cst}")
        alive_c = cst.n_mpc + cst.n_failsafe + cst.n_deadbeat
        cont_rep = dict(
            ticks=n_ticks, batch=SWEEP_CHUNK, wall_s=wall_c,
            ms_per_tick=1000.0 * wall_c / n_ticks,
            scenario_substeps_per_s=SWEEP_CHUNK * n_ticks * ceng.n_sub / wall_c,
            alive_solves_per_s=alive_c / wall_c, launches=c_launch,
            **cst._asdict())
        log("  [sweep continuous] " + json.dumps(cont_rep))

        # 6. the entry programs' multi-rank dry run, over this group
        (st_dry, out_dry), wall_dry, dry_launch = part(_dryrun, path=True)
        if not dry_launch.get("eig_chunk"):
            raise AssertionError(f"dryrun_multichip launched {dry_launch}")
        dry_rep = dict(wall_s=wall_dry, launches=dry_launch,
                       line=out_dry.strip(), **st_dry._asdict())
        log("  [sweep dryrun_multichip] " + json.dumps(dry_rep))

        report = dict(
            backend=dist.get_backend(), world=dist.get_world_size(),
            mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)),
            config="flagship (bench.py defaults), Nx=50, fp32 'eig', "
                   "T_final=10 s", sweep=sweep, resume=resume,
            composition=composition, study=study_rep, continuous=cont_rep,
            dryrun_multichip=dry_rep,
            max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    finally:
        dist.destroy_process_group()
    return launches, report


# ---------------------------------------------------------------------------
# the drivers users run (``mpc_arpo_project_tpu_torch/examples``, the
# status-mix tool)
# ---------------------------------------------------------------------------

# the mixed sweep at its default grid and width, with its --quick solver
# cap and its --quick depth cut from 30 s to 10 s (20 steps) to leave the
# bench and profile phases their full depth (the checks need no more: every
# engine launches eig_chunk from its first step)
DRIVERS_B = 1024
DRIVERS_T_FINAL = 10.0
# the status-mix cell of the JAX package's recorded fp64 oracle shard
# (16 scenarios x 600 steps of the reference success-rate configuration)
ORACLE_ARGS = ["--config", "ref", "--sigma", "0.03", "--runs", "128",
               "--shard", "0/8"]
ORACLE_RECORD = os.path.join(ROOT, "artifacts", "status_mix",
                             "ref_s0.03_oracle_shard0of8.json")


def _status_line(r):
    """The numbers of a status-mix arm that the phase holds and prints."""
    return {k: r[k] for k in ("counts", "n_success", "alive_steps",
                              "mean_i_term", "ctrl_usage", "mix")}


def _held_to_record(got, ref):
    """The drivers phase's rule for a status-mix arm against the JAX
    package's record: within one docked scenario, and 1% of the record's
    alive steps per status count and on the mean termination step. Returns
    (holds, exact)."""
    exact = all(got[k] == ref[k] for k in ("counts", "n_success",
                                           "alive_steps", "mean_i_term",
                                           "ctrl_usage"))
    tol = 0.01 * ref["alive_steps"]
    off = [k for k, v in ref["counts"].items()
           if abs(got["counts"].get(k, 0) - v) > tol]
    holds = (abs(got["n_success"] - ref["n_success"]) <= 1 and not off
             and abs(got["mean_i_term"] - ref["mean_i_term"])
             <= 0.01 * ref["mean_i_term"])
    return holds, exact


def drivers_phase():
    """The drivers on the card: (a) the mixed sweep's 10 engines (radial
    and in-track x R_input 0.25-4) at B=1024 each through its ``grid``,
    ``scenario_inputs`` and ``engine_stats``, with its ``--quick`` depth
    and solver cap; (b) the status-mix tool's fp64 'oracle' arm on the
    shard of the JAX package's recorded oracle run, held to that record;
    (c) its fp32 'prod' arm on the same draws. Every kernel count is set to
    0 just before each run and read just after; returns the counts summed
    over the runs and the report."""
    import torch
    from mpc_arpo_project_tpu_torch.examples import mixed_sweep_10k as ms
    from mpc_arpo_project_tpu_torch.ops import _build
    from mpc_arpo_project_tpu_torch.parallel import mc
    from mpc_arpo_project_tpu_torch.rollout import discrete
    from mpc_arpo_project_tpu_torch.tools import status_mix

    counters = _counters()
    launches = {}

    def start():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        return time.perf_counter()

    def stop(t0):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _read_counters(counters).items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return wall, got

    # a. the mixed sweep at full width
    settings = ms.settings(quick=True)
    cells = ms.grid(ms.RU_SCALES, T_final=DRIVERS_T_FINAL, quick=True)
    rng = np.random.RandomState(ms.SEED)
    engines, totals = [], {}
    build_s = 0.0
    t_all = time.perf_counter()
    for gi, c in enumerate(cells):
        t0 = start()
        engine = discrete.build_engine(c.sim, c.mpc, c.fail, c.debris,
                                       settings=settings, dtype=torch.float32,
                                       device="cuda")
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        build_s += build
        x0b, hold, is_rej = ms.scenario_inputs(rng, c.orient, c.sim.x0,
                                               DRIVERS_B)
        r, out = ms.engine_stats(engine, ms.engine_noise(engine, gi, hold),
                                 x0b, is_rej)
        wall, got = stop(t0)
        if not got.get("eig_chunk"):
            raise AssertionError(f"engine {gi} ({c.orient}, Ru*{c.w}) "
                                 f"launched no eig_chunk: {got}")
        alive = out.ctrl_seq > 0
        st = out.status[alive]
        if not ((st >= 0) & (st <= 4)).all():
            raise AssertionError(f"engine {gi}: alive statuses outside 0..4")
        div = ~torch.isfinite(mc._final_distance(out, engine.xr))
        if int(div.sum()) != r["n_diverged"]:
            raise AssertionError(f"engine {gi}: diverged count")
        bad = ~torch.isfinite(out.x_true).all(-1).all(0) & ~div
        if c.orient == "in-track" and bool(bad.any()):
            raise AssertionError(
                f"engine {gi} (in-track, Ru*{c.w}): {int(bad.sum())} "
                "scenarios with non-finite states are not counted diverged")
        nok = DRIVERS_B - int(r["n_diverged"])
        row = dict(orient=c.orient, ru_scale=c.w, steps=engine.nsim,
                   success=int(r["n_success"]),
                   mean_final_dist=r["sum_final_dist"] / max(nok, 1),
                   diverged=int(r["n_diverged"]),
                   solved=int(r["n_solved"]), max_iter=int(r["n_maxiter"]),
                   pinf=int(r["n_pinf"]), alive_steps=int(r["alive_steps"]),
                   admm_iters=int(r["total_iters"]), wall_s=wall,
                   build_s=build, launches=got)
        log(f"  [mixed sweep {gi + 1}/{len(cells)}] " + json.dumps(row))
        engines.append(row)
        for k, v in r.items():
            totals[k] = totals.get(k, 0.0) + v
        del out, engine
    wall = time.perf_counter() - t_all
    n = DRIVERS_B * len(cells)
    ndiv = int(totals["n_diverged"])
    sweep = dict(
        engines=len(cells), batch=DRIVERS_B, scenarios=n,
        steps=cells[0].sim.nsim, max_iter=settings.max_iter,
        solve_mode=settings.solve_mode, dtype="float32", wall_s=wall,
        engine_build_s=build_s, sims_per_s=n / wall,
        alive_steps=int(totals["alive_steps"]),
        alive_steps_per_s=totals["alive_steps"] / wall,
        success=int(totals["n_success"]), diverged=ndiv,
        mean_final_dist=totals["sum_final_dist"] / max(n - ndiv, 1),
        mean_i_term=totals["sum_i_term"] / n,
        status_counts=dict(SOLVED=int(totals["n_solved"]),
                           MAX_ITER=int(totals["n_maxiter"]),
                           PINF=int(totals["n_pinf"])))
    log("  [mixed sweep] " + json.dumps(sweep))

    # b. the fp64 oracle against the JAX package's record of the same shard
    os.makedirs(_build.BUILD, exist_ok=True)
    out_json = os.path.join(_build.BUILD, "status_mix.json")
    t0 = start()
    oracle = status_mix.run(ORACLE_ARGS + ["--arm", "oracle", "--device",
                                           "cuda", "--out", out_json])
    wall_o, got_o = stop(t0)
    with open(ORACLE_RECORD) as fh:
        record = json.load(fh)
    ref, got = record["arms"]["oracle"], oracle["arms"]["oracle"]
    if oracle["shard"] != record["shard"] or oracle["nsim"] != record["nsim"]:
        raise AssertionError(f"shard {oracle['shard']} x {oracle['nsim']} "
                             f"steps, record {record['shard']}")
    cmp = dict(port=_status_line(got), record=_status_line(ref))
    holds, exact = _held_to_record(got, ref)
    if not holds:
        raise AssertionError(f"the card's oracle leaves the record: "
                             f"{json.dumps(cmp)}")
    oracle_rep = dict(args=ORACLE_ARGS, scenarios=record["shard"]["hi"]
                      - record["shard"]["lo"], steps=record["nsim"],
                      exact=exact, wall_s=wall_o, record_wall_s_cpu=ref["wall_s"],
                      launches=got_o, **cmp)
    log("  [oracle] " + json.dumps(oracle_rep))

    # c. production on the same draws
    t0 = start()
    prod = status_mix.run(ORACLE_ARGS + ["--arm", "prod", "--device", "cuda",
                                         "--out", out_json])
    wall_p, got_p = stop(t0)
    p = prod["arms"]["prod"]
    if not got_p.get("eig_chunk"):
        raise AssertionError(f"the prod arm launched no eig_chunk: {got_p}")
    prod_rep = dict(wall_s=wall_p, launches=got_p, **_status_line(p),
                    n_success_oracle=got["n_success"],
                    exit_residuals_over_tol=p["exit_residuals_over_tol"])
    log("  [prod] " + json.dumps(prod_rep))
    return launches, dict(mixed_sweep=dict(sweep, per_engine=engines),
                          oracle=oracle_rep, prod=prod_rep)


# ---------------------------------------------------------------------------
# the oracle tools (``tools/continuous_fullscale.py``,
# ``tools/deviation_bench.py`` and the status-mix refsim arm of the port)
# ---------------------------------------------------------------------------

# the full-horizon continuous batch: radialC at the reference's T_final,
# 600 ticks of 500 substeps, at the width of every other cell
FULLSCALE_T = 300.0
FULLSCALE_B = 1024
# the depth of (a)'s B=1024 run, cut from the tool's 300 s to leave the
# bench and profile phases their full depth: past 100 s the few scenarios
# left run the few-live-slot chunks they ran from 70 s on (under 19% alive)
FULLSCALE_B1024_T = 100.0
ARTIFACTS = os.path.join(ROOT, "artifacts")
# the JAX package's TPU v5e record of its production run (B=8, 'chol' fp32)
CONTC_RECORD = os.path.join(ARTIFACTS, "contC_tpu_r5.json")
# the 60 QPs that the JAX tool recorded from the oracle closed loop
DEVSEQ = os.path.join(ARTIFACTS, "devseq_r5.npz")
# the JAX package's refsim arm on the drivers phase's shard
REFSIM_RECORD = os.path.join(ARTIFACTS, "status_mix",
                             "ref_s0.03_refsim_shard0of8.json")
# the JAX package's TPU v5e replays of the same sequence in 'eig' fp32: at
# production settings (``BASELINE.md:457``), and in the fp32 accuracy mode
# (``--accurate-f32``, ``artifacts/deviation_eig_f32_tpu_r5b.log``, whose
# line reads "accurate=False" because it prints ``--accurate``)
DEVIATION_TPU = {"eig": dict(
    production=dict(converged=dict(n=60, max=1.6e-1, median=2.1e-2)),
    accurate_f32=dict(converged=dict(n=2, max=5.294e-06, median=5.273e-06),
                      max_iter=dict(n=58, max=5.085e-04,
                                    median=1.146e-05)))}


@contextlib.contextmanager
def _environ(**changes):
    """``os.environ`` with ``changes`` for the block (what a process
    started in it inherits)."""
    old = {k: os.environ.get(k) for k in changes}
    os.environ.update(changes)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _check_bookkeeping(engine, out):
    """Finite states of the expected shapes, and each scenario's recorded
    controller codes nonzero exactly on the ticks that started alive: tick
    j (row j-1 of ``ctrl_seq``) iff j * n_sub <= i_term_sub."""
    import torch

    B = out.i_term_sub.shape[0]
    for name, width in (("x_true_ticks", 4), ("x_est", 6), ("ctrls", 2)):
        v = getattr(out, name)
        if tuple(v.shape) != (engine.n_ticks + 1, B, width):
            raise AssertionError(f"{name} shape {tuple(v.shape)}")
        if not torch.isfinite(v).all():
            raise AssertionError(f"non-finite {name}")
    ticks = torch.arange(1, engine.n_ticks, device=out.ctrl_seq.device)
    started = ticks[:, None] * engine.n_sub <= out.i_term_sub[None, :].long()
    if not torch.equal(out.ctrl_seq > 0, started):
        bad = int(((out.ctrl_seq > 0) != started).any(0).sum())
        raise AssertionError(f"{bad} scenarios' ctrl_seq disagrees with "
                             "their termination substep")
    status = out.status
    if not (((status >= 0) & (status <= 4)) == started).all():
        raise AssertionError("a status outside 0..4 on an alive tick, or "
                             "not -1 on a dead one")


def _fullscale_part(start, stop, card):
    """(a): main path 4's engine at B=1024 for 100 s, then the command
    line's own engine at B=8 (300 s) beside the JAX package's TPU
    record."""
    import torch
    from mpc_arpo_project_tpu_torch.rollout import continuous
    from mpc_arpo_project_tpu_torch.tools import continuous_fullscale as cf

    engine = radial_c(FULLSCALE_B1024_T, "cuda", torch.float32, "eig")
    gen = torch.Generator(device="cuda").manual_seed(13)
    draws = continuous.make_noise_draws(engine, gen, FULLSCALE_B)
    t0 = start()
    rec, out = cf.fullscale_record(engine, draws, seg=100)
    _, got = stop(t0)
    _check_bookkeeping(engine, out)
    if (got.get("rk4_tick") != engine.n_ticks - 1 or not got.get("eig_chunk")
            or any(rec["launches"][k] != got[k] for k in rec["launches"])):
        raise AssertionError(f"fullscale launches: record {rec['launches']}, "
                             f"counters {got}, {engine.n_ticks - 1} ticks")
    i_term = out.i_term_sub.double().cpu()
    n_total = rec["substeps_per_scenario"]
    alive = rec["alive_ticks"]
    fullscale = dict(
        config="radialC, fp32 'eig', max_iter 1000 (main path 4's engine)",
        device=card, batch=FULLSCALE_B, ticks=engine.n_ticks - 1,
        substeps_per_scenario=n_total, wall_s=rec["wall_s"],
        scenario_substeps_per_s=rec["substeps_per_s"],
        docked_share=float(out.success.float().mean()),
        terminated_share=float((i_term < n_total).float().mean()),
        i_term_sub_quartiles=torch.quantile(i_term, torch.tensor(
            [0.0, 0.25, 0.5, 0.75, 1.0], dtype=torch.float64)).tolist(),
        alive_ticks=alive,
        controller_mix_alive={k: v / alive
                              for k, v in rec["ctrl_usage"].items()},
        status_mix_alive={k: v / alive
                          for k, v in rec["status_mix_alive"].items()},
        ctrl_usage=rec["ctrl_usage"], launches=got)
    log("  [fullscale] " + json.dumps(fullscale))
    del out, draws, engine

    engine = cf.build(FULLSCALE_T, torch.float32, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    draws = continuous.make_noise_draws(engine, gen, 8)
    t0 = start()
    cli, _ = cf.fullscale_record(engine, draws, seg=100)
    _, got = stop(t0)
    with open(CONTC_RECORD) as fh:
        tpu = json.load(fh)
    outcome = ("alive_ticks", "i_term_sub", "success", "ctrl_usage",
               "status_mix_alive")
    cli_rep = dict(
        port={k: cli[k] for k in outcome + ("wall_s", "substeps_per_s",
                                            "device")},
        tpu_record={k: tpu[k] for k in outcome + ("wall_s", "backend")},
        launches=got)
    log("  [fullscale cli] " + json.dumps(cli_rep))
    return fullscale, cli_rep


def _replay_part(start, stop):
    """(c): the 60 recorded QPs in 'eig' fp32, 'pallas' fp32 and 'chol'
    fp64 on the card, each launching its kernels; the first 3 'chol' steps
    also on the CPU."""
    import torch
    from mpc_arpo_project_tpu_torch.tools import deviation_bench as db

    with np.load(DEVSEQ) as f:
        seq = [f[k] for k in ("l", "u", "coeffs", "u_true")]
    kernels = {"eig": ("eig_chunk",), "pallas": ("admm_chunk", "ns_fused"),
               "chol": ()}
    replays = {}
    for mode, dtype in (("eig", torch.float32), ("pallas", torch.float32),
                        ("chol", torch.float64)):
        prob, settings = db.prepare(mode, dtype, "cuda")
        t0 = start()
        devs, st = db.replay(prob, settings, *seq)
        wall, got = stop(t0)
        if not all(got.get(k) for k in kernels[mode]):
            raise AssertionError(f"the '{mode}' replay launched {got}")
        if not np.isfinite(devs).all():
            raise AssertionError(f"the '{mode}' replay: non-finite control")
        replays[mode] = dict(dtype=str(dtype)[6:], wall_s=wall, launches=got,
                             **db.summary(devs, st),
                             tpu_v5e=DEVIATION_TPU.get(mode))
        log(f"  [replay {mode}] " + json.dumps(replays[mode]))
    cdevs, cst = db.replay(*db.prepare("chol", torch.float64, "cpu"),
                           *(a[:3] for a in seq))
    diff = np.abs(devs[:3] - cdevs)
    if not (np.array_equal(st[:3], cst) and (diff <= 1e-9).all()):
        raise AssertionError(f"'chol' fp64 replay: card {devs[:3]} {st[:3]}, "
                             f"CPU {cdevs} {cst}")
    replays["chol"]["card_vs_cpu_3_steps_max_diff"] = float(diff.max())
    return replays


def _parity_part(start, stop, engine, draws, runo, wall_oracle):
    """(b): the fp64 engine on the card against the oracle's run: the JAX
    tool's criteria up to the terminating tick, and any later miss starting
    exactly there (ROADMAP section 3)."""
    from mpc_arpo_project_tpu_torch.tools import continuous_fullscale as cf

    t0 = start()
    par = cf.parity_record(engine, draws, runo, wall_oracle, seg=100)
    _, par["launches"] = stop(t0)
    log("  [parity] " + json.dumps(par))
    if not (par["i_term_sub_port"] == par["i_term_sub_oracle"]
            and par["ctrl_seq_equal"]
            and par["success_port"] == par["success_oracle"]
            and par["tick_traj_max_abs_dev_to_termination"] <= 1e-6):
        raise AssertionError("the T=300 s parity misses the JAX tool's "
                             "criteria: " + json.dumps(par))
    j_term = par["i_term_sub_oracle"] // engine.n_sub
    if not (par["tick_traj_atol_1e-6_ok"]
            or par["first_tick_row_over_1e-6"] == j_term + 1):
        raise AssertionError("the tick trajectory departs before the "
                             "terminating tick: " + json.dumps(par))
    if not par["launches"].get("rk4_tick"):
        raise AssertionError(f"the parity run launched {par['launches']}")
    return par


def _refsim_part(summary):
    """(d): the refsim arm's summary against the JAX package's record of
    the shard."""
    with open(REFSIM_RECORD) as fh:
        record = json.load(fh)
    got, ref = summary["arms"]["refsim"], record["arms"]["refsim"]
    if (summary["shard"], summary["nsim"]) != (record["shard"],
                                               record["nsim"]):
        raise AssertionError(f"refsim shard {summary['shard']}, record "
                             f"{record['shard']}")
    holds, exact = _held_to_record(got, ref)
    refsim = dict(args=ORACLE_ARGS, exact=exact, wall_s=got["wall_s"],
                  record_wall_s_cpu=ref["wall_s"], port=_status_line(got),
                  record=_status_line(ref))
    log("  [refsim] " + json.dumps(refsim))
    if not holds:
        raise AssertionError("the refsim arm leaves the record: "
                             + json.dumps(refsim))
    return refsim


def oracle_phase():
    """The oracle tools on the card: (a) ``fullscale_record`` of main path
    4's engine (radialC, fp32 'eig', max_iter 1000) at T_final 100 s and
    B=1024, then of the command line's own engine ('chol' fp32, B=8,
    300 s) beside the JAX package's TPU record; (b) the port's fp64 'chol' engine at T=300
    s on the card against the NumPy oracle ``simulate_continuous`` on the
    JAX tool's ``RandomState(11)`` draws; (c) ``deviation_bench.replay`` of
    the 60 recorded QPs in 'eig' fp32, 'pallas' fp32 and 'chol' fp64, the
    first 3 'chol' steps also on the CPU; (d) the status-mix refsim arm on
    the drivers phase's shard against the JAX package's record. The host
    oracles of (b) and (d) run in two child processes started with
    ``spawn`` and without CUDA at the start, beside (a) and (c). Every
    kernel count is set to 0 just before each card run and read just after;
    returns the counts summed over the runs and the report."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch
    from mpc_arpo_project_tpu_torch.tools import continuous_fullscale as cf
    from mpc_arpo_project_tpu_torch.tools import status_mix

    t_phase = time.perf_counter()
    card = cf.device_line("cuda")
    counters = _counters()
    launches = {}

    def start():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        return time.perf_counter()

    def stop(t0):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _read_counters(counters).items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return wall, got

    # the host oracles first, in children without CUDA, one thread each
    par_engine = cf.build(FULLSCALE_T, torch.float64, "cuda")
    par_draws = cf.parity_draws(par_engine)
    refsim_out = os.path.join(ROOT, "mpc_arpo_project_tpu_torch", "build",
                              "status_mix_refsim.json")
    os.makedirs(os.path.dirname(refsim_out), exist_ok=True)
    pool = ProcessPoolExecutor(2, mp_context=multiprocessing.get_context(
        "spawn"))
    with _environ(CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1",
                  OPENBLAS_NUM_THREADS="1", MKL_NUM_THREADS="1"):
        oracle_job = pool.submit(cf.oracle_run, FULLSCALE_T, par_draws,
                                 cf.oracle_scaling(par_engine))
        refsim_job = pool.submit(status_mix.run, ORACLE_ARGS + [
            "--arm", "refsim", "--device", "cpu", "--out", refsim_out])
    with pool:  # the children end with it, also when a check fails
        fullscale, cli_rep = _fullscale_part(start, stop, card)
        replays = _replay_part(start, stop)
        par = _parity_part(start, stop, par_engine, par_draws,
                           *oracle_job.result())
        refsim = _refsim_part(refsim_job.result())

    for k in ("eig_chunk", "admm_chunk", "ns_fused", "rk4_tick"):
        if not launches.get(k):
            raise AssertionError(f"the oracle phase launched no {k}")
    return launches, dict(device=card, fullscale=fullscale,
                          fullscale_cli=cli_rep, parity=par,
                          deviation_replay=replays, refsim=refsim,
                          wall_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------------------
# the sigma=0.01 docking-gap dissection (``tools/first_divergence.py`` and
# ``tools/probe_stall.py`` of the port)
# ---------------------------------------------------------------------------

# the JAX package's round-5 dissection: its TPU production rollout, its fp64
# oracle on the 45 gap columns and its stall-probe capture with the log of
# that capture's analysis
FD_PROD_RECORD = os.path.join(ARTIFACTS, "fd_prod_r5.npz")
FD_ORACLE_RECORD = os.path.join(ARTIFACTS, "fd_oracle_r5.npz")
STALL_RECORD = os.path.join(ARTIFACTS, "stall_probe_r5.npz")
STALL_LOG = os.path.join(ARTIFACTS, "probe_analyze_r5.log")
# the step whose entering carry the JAX package captured
# (``artifacts/fd_cap65_r5.npz``), and the docked count of the same
# rollout in the drivers' status-mix 'prod' arm on the card (PERF.md)
DISSECT_STEP = 65
CARD_PROD_DOCKED = 83


def _fd_summary(d):
    """A status-mix arm's numbers of a first-divergence rollout file."""
    st, ctrl = d["status"], d["ctrl_seq"]
    names = {1: "SOLVED", 2: "MAX_ITER", 3: "PINF", 4: "DINF", 0: "UNSOLVED"}
    return dict(
        counts={v: int((st == k).sum()) for k, v in names.items()},
        n_success=int(d["success"].sum()), alive_steps=int((st >= 0).sum()),
        mean_i_term=float(d["i_term"].mean()),
        ctrl_usage={"mpc": int((ctrl == 1).sum()),
                    "failsafe": int((ctrl == 2).sum()),
                    "deadbeat": int((ctrl == 3).sum())})


def _log_arrays(text, label):
    """(statuses, iterations) of a ``probe_stall --analyze`` arm's line."""
    m = re.search(label + r": status \[([\d ]+)\] iters \[([\d ]+)\]",
                  text)
    return [int(v) for v in m.group(1).split()], [int(v) for v in
                                                  m.group(2).split()]


def _analysis(rep):
    keys = ("steps", "scenarios", "status_fp64", "iters_fp64", "status_fp32",
            "iters_fp32", "pviol_fp32", "pviol_fp64")
    return {k: rep[k] for k in keys}


def dissection_phase():
    """The sigma=0.01 dissection on the card, in one process: (a) the
    production rollout (fp32 'eig', 128 runs, 300 s) on the draws of
    ``status_mix --seed 20260818``, keeping the carry entering every step;
    (b) the fp64 'chol' oracle on the 45 gap columns of the JAX package's
    record, held to it; (c) ``compare`` of the two, beside the JAX
    package's reading of its own files; (d) the carry entering step 65
    (and the gap scenarios' most common first-flip step, if another)
    captured, re-solved by ``resolve_full`` (every alive row must get its
    recorded status) and by ``resolve`` (fp32 'eig' against fp64 'chol');
    (e) ``probe_stall``'s dump of the rollout's plateau pairs analysed,
    and the JAX package's recorded probe analysed beside its log. Every
    kernel count is set to 0 just before each card run and read just
    after; returns the counts summed over the runs and the report."""
    import torch
    from mpc_arpo_project_tpu_torch.ops import _build
    from mpc_arpo_project_tpu_torch.tools import first_divergence as fd
    from mpc_arpo_project_tpu_torch.tools import probe_stall as ps

    t_phase = time.perf_counter()
    counters = _counters()
    launches = {}

    def start():
        for c in counters.values():
            c.launches = 0
        torch.cuda.synchronize()
        return time.perf_counter()

    def stop(t0):
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = {k: v for k, v in _read_counters(counters).items() if v}
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return wall, got

    out_dir = os.path.join(_build.BUILD, "dissection")
    os.makedirs(out_dir, exist_ok=True)
    path = lambda name: os.path.join(out_dir, name)
    quiet = lambda: contextlib.redirect_stdout(io.StringIO())

    # a. production, every step's entering carry kept on the card
    t0 = start()
    prod = ps.rollout_run(128, device="cuda")
    wall_a, got_a = stop(t0)
    if not got_a.get("eig_chunk"):
        raise AssertionError(f"the production rollout launched {got_a}")
    with quiet():
        summ = fd.run_prod(path("prod.npz"), run=prod)
    rep = dict(prod=dict(runs=128, steps=prod.engine.nsim, wall_s=wall_a,
                         launches=got_a, docked=summ["n_success"],
                         drivers_prod_arm_docked=CARD_PROD_DOCKED,
                         alive_steps=summ["alive_steps"], mix=summ["mix"],
                         mean_iters_per_step=summ["mean_iters_per_step"]))
    log("  [prod] " + json.dumps(rep["prod"]))

    # b. the fp64 oracle on the record's gap columns, held to the record
    with np.load(FD_ORACLE_RECORD) as f:
        record = {k: f[k] for k in f.files}
    cols = record["cols"].tolist()
    t0 = start()
    orc = ps.rollout_run(128, steps=(), device="cuda", cols=cols,
                         solve_mode="chol", dtype_str="f64")
    wall_b, got_b = stop(t0)
    with quiet():
        fd.run_oracle(path("oracle.npz"), cols, run=orc)
    with np.load(path("oracle.npz")) as f:
        mine = {k: f[k] for k in f.files}
    exact = {k: bool(np.array_equal(mine[k], record[k]))
             for k in ("status", "i_term", "success")}
    holds, _ = _held_to_record(_fd_summary(mine), _fd_summary(record))
    rep["oracle"] = dict(columns=len(cols), wall_s=wall_b, exact=exact,
                         port=_fd_summary(mine), record=_fd_summary(record))
    log("  [oracle] " + json.dumps(rep["oracle"]))
    if not holds:
        raise AssertionError("the card's oracle leaves the record: "
                             + json.dumps(rep["oracle"]))

    # c. the first flips, and the JAX package's reading of its own files
    with quiet():
        flips = fd.compare(path("prod.npz"), path("oracle.npz"))
        flips_r5 = fd.compare(FD_PROD_RECORD, FD_ORACLE_RECORD)
    gap = fd.gap_scenarios(flips)
    firsts = [r["t_first"] for r in gap if r["t_first"] is not None]
    common = max(set(firsts), key=firsts.count) if firsts else None
    rep["compare"] = dict(
        kinds=fd.flip_kinds(flips), n_gap=len(gap),
        gap_first_flips=[[r["scen"], r["t_first"], r["prod"], r["oracle"]]
                         for r in gap],
        most_common_gap_first_flip=common,
        jax_r5=dict(kinds=fd.flip_kinds(flips_r5),
                    n_gap=len(fd.gap_scenarios(flips_r5))))
    log("  [compare] " + json.dumps(rep["compare"]))

    # d. capture the carry entering the step and re-solve it
    rep["capture"] = []
    status = prod.out.status.cpu().numpy()
    for step in sorted({DISSECT_STEP, common or DISSECT_STEP}):
        at = [r["scen"] for r in gap if r["t_first"] == step]
        stuck = np.nonzero(status[step] == 2)[0].tolist()
        scen = (at or stuck or [int(np.argmax(status[step] >= 0))])[0]
        cap = path(f"cap{step}.npz")
        with quiet():
            fd.capture(cap, scen, step, run=prod)
        t0 = start()
        with quiet():
            full = ps.resolve_full(cap, "cuda")
            res = fd.resolve(cap, "cuda")
        wall_d, got_d = stop(t0)
        entry = dict(step=step, scen=scen, resolve_full=full, resolve=res,
                     wall_s=wall_d, launches=got_d)
        log("  [capture] " + json.dumps(entry))
        if full["agreement"] != 1.0:
            raise AssertionError(f"the capture of step {step} re-solves to "
                                 f"{full['agreement']:.4f} of its recorded "
                                 "statuses: it is not bit-exact")
        rep["capture"].append(entry)

    # e. the stall probe: the rollout's plateau pairs, and the JAX
    # package's recorded pairs beside its log
    with quiet():
        dumped = ps.dump(path("probe.npz"), run=prod)
    with open(STALL_LOG) as fh:
        text = fh.read()
    t0 = start()
    with quiet():
        mine = ps.analyze(path("probe.npz"), "cuda") if dumped["chosen"] \
            else None
        r5 = ps.analyze(STALL_RECORD, "cuda")
    wall_e, got_e = stop(t0)
    logged = dict(zip(("status_fp64", "iters_fp64"),
                      _log_arrays(text, "fp64 chol warm")))
    logged.update(zip(("status_fp32", "iters_fp32"),
                      _log_arrays(text, "fp32 eig warm")))
    rep["stall_probe"] = dict(
        dump=dict(n_max_iter=dumped["n_max_iter"], chosen=dumped["chosen"]),
        analysis=mine and _analysis(mine),
        recorded_pairs=dict(card=_analysis(r5), log=logged),
        wall_s=wall_e, launches=got_e)
    log("  [stall probe] " + json.dumps(rep["stall_probe"]))
    if not got_e.get("eig_chunk"):
        raise AssertionError(f"the stall probe launched {got_e}")
    del prod, orc
    rep["wall_s"] = time.perf_counter() - t_phase
    return launches, rep


# ---------------------------------------------------------------------------
# the bench (``mpc_arpo_project_tpu_torch/bench.py``) and the entry step
# (``mpc_arpo_project_tpu_torch/graft_entry.py``)
# ---------------------------------------------------------------------------

# bench.py's width; its depth (300 steps) comes with its defaults
BENCH_B = 1024
# the JAX package's bench.py 'eig' status mix of alive steps on a TPU v5e
# (``BENCH_r05.json``: B=1024, 300 steps, its own draws)
TPU_BENCH_MIX = {"SOLVED": 0.6694, "MAX_ITER": 0.2126, "PINF": 0.1181}
# the windows of control steps the bench's status mix is also read in
BENCH_WINDOWS = ((0, 20), (20, 50), (50, 100), (100, 200), (200, 300))


def _window_mix(out, lo, hi):
    """Alive steps, status shares and mean ADMM iterations a step of the
    control steps ``lo`` to ``hi`` of a rollout."""
    from mpc_arpo_project_tpu_torch.bench import STATUS_NAMES

    status = out.status[lo:hi].cpu()
    alive = out.ctrl_seq[lo:hi].cpu() > 0
    n = int(alive.sum())
    return dict(steps=f"{lo}-{hi}", alive_steps=n, **{
        name: int((status[alive] == code).sum()) / max(n, 1)
        for code, name in STATUS_NAMES.items() if code},
        mean_admm_iters=float(out.iters[lo:hi].double().mean()))


def bench_phase():
    """The bench's flagship at full width and depth on the card: its
    defaults ('eig', fp32), B=1024, 300 steps, through ``bench.run``'s
    timed and latency passes (the kernels are built by then, so the first
    pass is not repeated). Every kernel count is set to 0 just before and
    read just after. Alive steps, no UNSOLVED alive step and ``eig_chunk``
    launches are asserted; the status mix is printed beside the JAX
    package's TPU record (other draws: not held), and by window of steps.
    Then ``entry()``'s step on the card against the CPU. Returns the
    counts and the report."""
    import torch
    from mpc_arpo_project_tpu_torch import bench

    counters = _counters()
    settings = bench.bench_settings({})
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = bench.run(settings, BENCH_B, False, "cuda", first_pass=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _read_counters(counters)
    s = bench.summarize(r.out, r.engine, BENCH_B, r.wall, r.seg_times)
    if r.engine.nsim != 300:
        raise AssertionError(f"the bench ran {r.engine.nsim} steps, not 300")
    if s["alive_steps"] <= 0:
        raise AssertionError("the bench has no alive step")
    if s["status_hist"]["UNSOLVED"]:
        raise AssertionError(f"{s['status_hist']['UNSOLVED']} alive steps "
                             "UNSOLVED")
    if launches["eig_chunk"] <= 0:
        raise AssertionError("the bench launched no eig_chunk kernel")
    mix = s["status_mix_alive"]
    apart = {k: mix[k] - v for k, v in TPU_BENCH_MIX.items()}
    rep = dict(
        config=f"bench defaults: flagship Nx=50, fp32 'eig', B={BENCH_B}, "
               f"{r.engine.nsim} steps", phase_wall_s=wall, launches={
                   k: v for k, v in launches.items() if v},
        # the counts cover the timed and the latency pass
        eig_chunk_per_step=launches["eig_chunk"] / (2 * r.engine.nsim),
        max_memory_allocated_bytes=r.max_memory_allocated_bytes,
        **s, tpu_v5e_record_mix=TPU_BENCH_MIX,
        mix_minus_tpu_record=apart,
        more_than_3_points_apart=[k for k, v in apart.items()
                                  if abs(v) > 0.03],
        windows=[_window_mix(r.out, lo, hi) for lo, hi in BENCH_WINDOWS])
    log("  [bench] " + json.dumps(rep))
    log(f"  [bench] status mix SOLVED / MAX_ITER / PINF: card "
        f"{mix['SOLVED']} / {mix['MAX_ITER']} / {mix['PINF']}, the JAX "
        f"package's TPU v5e record (BENCH_r05.json, other draws) "
        f"{TPU_BENCH_MIX['SOLVED']} / {TPU_BENCH_MIX['MAX_ITER']} / "
        f"{TPU_BENCH_MIX['PINF']}")
    del r
    rep["entry"] = entry_agreement()
    return launches, rep


# ---------------------------------------------------------------------------
# the device's time by kernel and its idle share
# (``mpc_arpo_project_tpu_torch/tools/profile_step.py``)
# ---------------------------------------------------------------------------

# the JAX tool's flagship at its width, cut in depth to 80 steps (40 s) so
# that its default window, steps [60, 80), ends the run
PROFILE_B = 1024
PROFILE_T_FINAL = 40.0
# the JAX tool's default window: segments of 10 steps from the 6th, 2 of them
PROFILE_START_SEG, PROFILE_SEGS = 6, 2
# the phase's table: the device's names it keeps
PROFILE_TOP = 10


def profile_phase():
    """``profile_step`` on the card: the JAX tool's flagship (fp32 'eig',
    B=1024) for 80 steps, traced over its default window [60, 80). Asserts
    that the trace holds device events, that its ``eig_chunk`` kernel
    events equal the wrapper's launches over the window, that the device's
    busy time (the union over streams) is no more than the window and no
    more than the sum of its events, and an idle share in [0, 1]. Every
    kernel count is set to 0 just before and read just after. Returns the
    counts and the report."""
    import tempfile

    import torch
    from mpc_arpo_project_tpu_torch.tools import profile_step as ps

    counters = _counters()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    engine, noise = ps.flagship_engine(PROFILE_B, T_final=PROFILE_T_FINAL)
    with tempfile.TemporaryDirectory(prefix="profile_step_") as log_dir:
        prof = ps.profile(engine, noise, start_seg=PROFILE_START_SEG,
                          segs=PROFILE_SEGS, log_dir=log_dir)
    torch.cuda.synchronize()
    launches = _read_counters(counters)
    agg = ps.aggregate(prof.events, prof.n_steps, PROFILE_TOP)
    dev, n = agg["device"], prof.n_steps
    lo = PROFILE_START_SEG * ps.SEG
    if dev is None:
        raise AssertionError("the profiler recorded no device event")
    events = ps.kernel_events(prof.events, "eig_chunk_kernel")
    if events != prof.launches["eig_chunk"]:
        raise AssertionError(f"the trace holds {events} eig_chunk kernel "
                             f"events, the wrapper counted "
                             f"{prof.launches['eig_chunk']} launches")
    # the union and the sum are taken from the same microsecond stamps;
    # the margin is their float rounding
    if not (dev["busy_ms"] <= dev["window_ms"] * (1 + 1e-12)
            and dev["busy_ms"] <= dev["device_ms"] * (1 + 1e-12)
            and 0.0 <= dev["idle_share"] <= 1.0):
        raise AssertionError(f"busy {dev['busy_ms']} ms, window "
                             f"{dev['window_ms']} ms, events summed "
                             f"{dev['device_ms']} ms, idle share "
                             f"{dev['idle_share']}")
    rep = dict(
        config=f"profile_step's flagship: fp32 'eig', B={PROFILE_B}, "
               f"{engine.nsim} steps, window [{lo}, {lo + n})",
        idle_share=dev["idle_share"],
        traced_ms_per_step=prof.wall_s * 1e3 / n,
        # the segment before the window, untraced
        untraced_ms_per_step_before=prof.seg_ms[PROFILE_START_SEG - 1],
        window_ms_per_step=dev["window_ms"] / n,
        busy_ms_per_step=dev["busy_ms"] / n,
        device_events_per_step=dev["n_events"] / n,
        eig_chunk=dict(launches_in_window=prof.launches["eig_chunk"],
                       kernel_events=events),
        n_events=len(prof.events), trace_s=prof.trace_s,
        top_device=[[name[:60], ms / n, count]
                    for name, ms, count in agg["ops"][:5]],
        top_idle_host_ops=[[name, ms] for name, ms, _ in
                           dev["idle_by_host_op"][:3]],
        launches={k: v for k, v in launches.items() if v},
        wall_s=time.perf_counter() - t0)
    ps.print_tables(agg, log)
    ps.print_idle(dict(dev, idle_by_host_op=dev["idle_by_host_op"][:10]), n,
                  log)
    log("  [profile] " + json.dumps(rep))
    return launches, rep


def entry_agreement():
    """``entry()``'s step (B=8, Nx=40, 'eig') on the card against the CPU
    from the same carry: in fp64, statuses, controller codes and
    ``done_iters`` equal and the state within 1e-6 (``_agree``'s rule); in
    fp32 (``entry()``'s default) a finite state and alive statuses in
    1..4, its distance from the CPU printed."""
    import torch
    from mpc_arpo_project_tpu_torch import graft_entry

    rep = {}
    for dtype in (torch.float64, torch.float32):
        steps = []
        for device in ("cuda", "cpu"):
            fn, (carry, step_in) = graft_entry.entry(device=device,
                                                     dtype=dtype)
            new, out = fn(carry, step_in)
            steps.append((new, out))
        (g, go), (c, co) = steps
        same = {name: torch.equal(go[k].cpu(), co[k]) for k, name in
                ((5, "status"), (4, "ctrl_seq"), (7, "done_iters"))}
        dx = float((g.x_true.cpu() - c.x_true).abs().max())
        finite = bool(torch.isfinite(g.x_true).all())
        rep[str(dtype)[6:]] = dict(equal=same, max_abs_x_true_diff=dx,
                                   status=go[5].tolist())
        if not finite or not ((go[5] >= 1) & (go[5] <= 4)).all():
            raise AssertionError(f"entry() {dtype} on the card: status "
                                 f"{go[5].tolist()}, finite {finite}")
        if dtype == torch.float64 and (not all(same.values()) or dx > 1e-6):
            raise AssertionError(f"entry() fp64, card against CPU: {same}, "
                                 f"x_true by {dx}")
    log("  [entry] " + json.dumps(rep))
    return rep


def in_track_agreement(seed):
    """4 fp64 control steps of the mixed sweep's noisy offset-free in-track
    engine ('eig') at B=8: the card (kernels) against the CPU (twins)."""
    sys.path.insert(0, TESTS)
    from torch_helpers import in_track_rollout

    _agree("in-track eig", [in_track_rollout(d, seed) for d in ("cuda", "cpu")])


def _foreign_modules():
    return sorted(m for m in sys.modules
                  if m in ("jax", "mpc_arpo_project_tpu", "tools", "examples")
                  or m.startswith(("jax.", "mpc_arpo_project_tpu.",
                                   "tools.", "examples.")))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dump = (sys.argv[sys.argv.index("--ns-dump") + 1]
            if "--ns-dump" in sys.argv else None)
    from mpc_arpo_project_tpu_torch.ops import (
        _build, admm_eig, admm_pallas, rk4_tick)
    from mpc_arpo_project_tpu_torch.tools import kernel_probe

    t_start = time.perf_counter()
    # 1. device
    log(kernel_probe.card_line())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"float32_matmul_precision={torch.get_float32_matmul_precision()}")

    # 2. build: one nvcc per library, all started together
    t0 = time.perf_counter()
    libs = {"eig_chunk": admm_eig._lib,
            **{n: partial(admm_pallas._chunk_lib, n)
               for n in admm_pallas.CHUNK_LIBS},
            "ns_inverse": admm_pallas._ns_lib,
            "kernel_probe": kernel_probe._lib,
            "rk4_tick": rk4_tick._lib}
    with ThreadPoolExecutor(len(libs)) as pool:
        for fut in [pool.submit(f) for f in libs.values()]:
            fut.result()
    log(f"build: {len(libs)} libraries ready in {time.perf_counter() - t0:.2f}"
        " s (nvcc " + ", ".join(f"{n} {(_build.build_seconds.get(n) or 0.0):.2f} s"
                                for n in libs) + ")")
    for name in libs:
        for line in _build.ptxas_log.get(name, "").splitlines():
            if ("registers" in line or "Compiling entry" in line
                    or "spill" in line):
                log(f"  ptxas [{name}]: {line.strip()}")

    # 3. kernels against plain at flagship shapes
    B = 1024
    t0 = time.perf_counter()
    eig_engine = flagship(10.0, "cuda", torch.float32, "eig")
    pal_engine = flagship(10.0, "cuda", torch.float32, "pallas")
    log(f"flagship engines (nz={eig_engine.prob.Pbar.shape[0]}, "
        f"m={eig_engine.prob.A0bar.shape[0]}, "
        f"K={eig_engine.prob.eig_YT.shape[1]}, 3gw="
        f"{pal_engine.prob.gsel.shape[1]}) built in "
        f"{time.perf_counter() - t0:.1f} s")
    record = CallRecord() if dump else None
    entries = [check_eig_kernel(eig_engine, B, record)]
    entries += check_pallas_kernels(pal_engine, B, record)
    if dump:
        torch.save({"calls": record.calls}, dump)
        log(f"saved {len(record.calls)} eig_chunk, admm_chunk and "
            f"Newton–Schulz calls to {dump}")
        del record  # it holds the inputs on the card too
    log(f"kernel checks done at {time.perf_counter() - t_start:.1f} s")

    # 4. the chunk-parts probe
    entries.append(check_probe())
    log(f"probe done at {time.perf_counter() - t_start:.1f} s")

    # 5. the continuous plant's tick kernel against plain
    cont_engine = radial_c(CONT_T_FINAL, "cuda", torch.float32, "eig")
    entries.append(check_rk4_tick(cont_engine, B))
    log(f"rk4_tick checks done at {time.perf_counter() - t_start:.1f} s")

    # 6-9. the main paths; a kernel's launches are those of the paths that
    # run it (the probe runs on none of them)
    chol_engine = flagship(10.0, "cuda", torch.float64, "chol")
    launches = {}
    for engine, seed in ((eig_engine, 2), (pal_engine, 2), (chol_engine, 2),
                         (cont_engine, 8)):
        if engine is cont_engine:
            counts, rep = continuous_main_path(engine, B, seed)
            log("main path (continuous): " + json.dumps(rep))
        else:
            counts, rep = main_path(engine, B, seed)
            log(f"main path ({engine.settings.solve_mode}): "
                + json.dumps(rep))
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
        log(f"  done at {time.perf_counter() - t_start:.1f} s")

    # 10. the sweeps over NCCL; their launches count with the main paths'
    counts, sweep_report = sweep_phase(eig_engine, 11)
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"  sweeps done at {time.perf_counter() - t_start:.1f} s")

    # 11. the drivers: the mixed sweep, the oracle shard and production on it
    t0 = time.perf_counter()
    counts, drivers_report = drivers_phase()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    drivers_report["wall_s"] = time.perf_counter() - t0
    log(f"  drivers done at {time.perf_counter() - t_start:.1f} s "
        f"(the phase {drivers_report['wall_s']:.1f} s)")

    # 12. the oracle tools: the full horizon, its parity, the deviation
    # replay and the refsim arm
    counts, oracle_report = oracle_phase()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"  oracle tools done at {time.perf_counter() - t_start:.1f} s "
        f"(the phase {oracle_report['wall_s']:.1f} s)")

    # 13. the sigma=0.01 docking-gap dissection
    counts, dissection_report = dissection_phase()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"  dissection done at {time.perf_counter() - t_start:.1f} s "
        f"(the phase {dissection_report['wall_s']:.1f} s)")

    # 14. the bench at full width and depth, and the entry step
    t0 = time.perf_counter()
    counts, bench_report = bench_phase()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    bench_report["wall_s"] = time.perf_counter() - t0
    log(f"  bench done at {time.perf_counter() - t_start:.1f} s "
        f"(the phase {bench_report['wall_s']:.1f} s)")

    # 15. the device's time by kernel and its idle share
    counts, profile_report = profile_phase()
    for name, n in counts.items():
        launches[name] = launches.get(name, 0) + n
    log(f"  profile done at {time.perf_counter() - t_start:.1f} s "
        f"(the phase {profile_report['wall_s']:.1f} s)")

    # 16. small end-to-end agreement, card against CPU
    small_agreement(3, "eig")
    small_agreement(13, "eig", settings_kw=dict(eig_rescue_mode="near"))
    small_agreement(4, "pallas")
    small_agreement(5, "chol")
    small_agreement(6, "chol", estimator="kf")
    small_agreement(7, "chol", synthesis="torch")
    continuous_agreement(9, "eig")
    continuous_agreement(10, "chol")
    in_track_agreement(12)

    # 17. import check
    bad = _foreign_modules()
    if bad:
        raise AssertionError(f"the port imported {bad}")

    for e in entries:
        e["launches"] = launches.get(e["name"], 0)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print("sweep: " + json.dumps(sweep_report))
    print("drivers: " + json.dumps(drivers_report))
    print("oracle: " + json.dumps(oracle_report))
    print("dissection: " + json.dumps(dissection_report))
    print("bench: " + json.dumps(bench_report))
    print("profile: " + json.dumps(profile_report))
    print(json.dumps({"kernels": [{k: e[k] for k in keys} for e in entries]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
