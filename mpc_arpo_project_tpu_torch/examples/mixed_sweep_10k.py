"""One-card batched MC sweep of ~10k MIXED scenarios: radial and in-track
approaches with per-scenario initial conditions, noise draws, noise hold
lengths and offset-free switches, and a per-ENGINE weight grid (the
``traj_eval_*`` drivers' freely varied MPCParams,
``test/traj_eval_radial.py:17-72``, ``test/traj_eval_in_track.py:47-63`` of
the reference). Port of ``examples/mixed_sweep_10k.py``.

What varies WHERE (the engine's architectural split, see ``config.py``):
  * per scenario (one batch): x0, noise draws, noise hold length,
    isReject, all pure tensor data;
  * per engine (weight grid): Q/Ru/slack weights and approach orientation.
    Weights change the DARE terminal policy K and hence the batch-shared
    constraint matrix stitching (``ops/qp_builder.py``), so they CANNOT vary
    inside one batch; the sweep builds one engine per weight setting.

The reference runs such sweeps as overnight serial loops
(``test/traj_eval_radial.py:4-5,92-105``).

    python -m mpc_arpo_project_tpu_torch.examples.mixed_sweep_10k           # card, 10,240 scenarios
    python -m mpc_arpo_project_tpu_torch.examples.mixed_sweep_10k --cpu --batch 8 --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import Noise
from mpc_arpo_project_tpu_torch.examples.common import (
    in_track_config, radial_config)
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc
from mpc_arpo_project_tpu_torch.rollout import discrete

RU_SCALES = (0.25, 0.5, 1.0, 2.0, 4.0)
SEED = 20260820  # the per-scenario inputs' RandomState
NOISE_SEED = 7  # engine gi's noise: chunk_generator(engine, 7, gi)


class Cell(NamedTuple):
    """One engine of the grid: its orientation, R_input scale and
    configuration."""

    orient: str
    w: float
    sim: object
    mpc: object
    fail: object
    debris: object


def settings(quick: bool = False, solve_mode: str = "eig"):
    """The sweep's solver settings (``--quick``: max_iter 500)."""
    return admm.ADMMSettings(max_iter=500 if quick else 4000,
                             solve_mode=solve_mode, stall_exit_chunks=12,
                             stall_tighten_chunks=24)


def grid(ru_scales=RU_SCALES, T_final=None, quick=False):
    """The engine grid, (radial | in-track) x R_input scale, in the JAX
    driver's order; ``T_final`` defaults to 30 s with ``quick``, else
    150 s."""
    if T_final is None:
        T_final = 30.0 if quick else 150.0

    def scaled(mpc_p, w):
        return dataclasses.replace(mpc_p, R_input=np.asarray(mpc_p.R_input) * w)

    cells = []
    for w in ru_scales:
        sim_r, mpc_r, fail_r, deb_r = radial_config(noisy=True, T_final=T_final)
        cells.append(Cell("radial", w, sim_r, scaled(mpc_r, w), fail_r, deb_r))
        sim_i, mpc_i, fail_i, deb_i = in_track_config(T_final=T_final)
        # the reference's in-track driver is noiseless/plain-MPC; the sweep
        # adds the radial study's noise model so the MC axes (noise hold,
        # isReject) exist on both orientations
        sim_i = dataclasses.replace(sim_i, noise=Noise((0.3, 0.3), 50),
                                    isReject=True)
        cells.append(Cell("in-track", w, sim_i, scaled(mpc_i, w), fail_i,
                          deb_i))
    return cells


def scenario_inputs(rng: np.random.RandomState, orient: str, base_x0, B: int):
    """Per-scenario variation drawn from ``rng`` (numpy, as the JAX driver
    draws it): x0 jitter, noise hold length and the offset-free switch.
    Returns (x0b (B, 4), hold (B,), is_rej (B,)) as numpy arrays."""
    jit_x = rng.uniform(-10, 10, size=B)
    jit_y = rng.uniform(-5, 5, size=B)
    x0b = np.tile(np.asarray(base_x0), (B, 1))
    if orient == "radial":
        x0b[:, 0] += jit_x
        x0b[:, 1] += jit_y
    else:
        x0b[:, 0] += jit_y
        x0b[:, 1] += jit_x
    hold = rng.choice([10, 25, 50, 100], size=B)
    is_rej = (np.arange(B) % 2 == 0).astype(np.float64)
    return x0b, hold, is_rej


def stats(engine, out: discrete.RolloutOut) -> dict:
    """A rollout reduced to the sweep's statistics (Python numbers).
    Scenarios can genuinely diverge (fp32 overflow under sustained
    failsafe on infeasible geometry): they are counted, and their final
    distances left out of the sum so means stay finite."""
    fd = mc._final_distance(out, engine.xr)  # non-finite where diverged
    div = ~torch.isfinite(fd)
    st = out.status
    r = dict(
        n_success=out.success.sum(),
        n_diverged=div.sum(),
        sum_final_dist=torch.where(div, 0.0, fd).sum(),
        sum_i_term=out.i_term.sum(),
        alive_steps=(out.ctrl_seq > 0).sum(),
        n_solved=(st == 1).sum(),
        n_maxiter=(st == 2).sum(),
        n_pinf=(st == 3).sum(),
        total_iters=out.iters.sum(),
    )
    vals = torch.stack([v.to(torch.float64).cpu() for v in r.values()])
    return dict(zip(r, vals.tolist()))


def engine_stats(engine, noise: torch.Tensor, x0b, is_rej):
    """Roll out one engine's batch (``noise`` (T, B, 4); ``x0b`` (B, 4) and
    ``is_rej`` (B,) numpy or tensors) and reduce it. Returns (stats,
    rollout output)."""
    kw = dict(dtype=engine.dtype, device=engine.device)
    out = discrete.rollout(engine, noise,
                           x0b=torch.as_tensor(x0b, **kw).contiguous(),
                           is_reject_b=torch.as_tensor(is_rej, **kw))
    return stats(engine, out), out


def engine_noise(engine, gi: int, hold) -> torch.Tensor:
    """Engine ``gi``'s held noise, drawn on its device from a generator
    seeded from ``(7, gi)`` (the JAX driver's ``fold_in(key(7), gi)``)."""
    return discrete.make_noise_sequence_multi(
        engine, mc.chunk_generator(engine, NOISE_SEED, gi), hold)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=1024,
                    help="scenarios per engine")
    ap.add_argument("--ru-scales", type=float, nargs="+", default=RU_SCALES,
                    help="control-weight multipliers (one engine each)")
    ap.add_argument("--quick", action="store_true",
                    help="short horizon + max_iter for smoke runs")
    ap.add_argument("--solve-mode", default=None,
                    help="override solver (default: eig on the card, chol "
                         "with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in fp64")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    solve_mode = args.solve_mode or ("chol" if args.cpu else "eig")
    dtype = torch.float64 if args.cpu else torch.float32
    st = settings(args.quick, solve_mode)
    cells = grid(args.ru_scales, quick=args.quick)
    B = args.batch
    print(f"device: {device}  solve_mode={solve_mode}  batch/engine={B}  "
          f"engines={len(cells)}")

    rng = np.random.RandomState(SEED)
    totals = {}
    t_all = time.time()
    build_s = 0.0
    for gi, c in enumerate(cells):
        t0 = time.time()
        engine = discrete.build_engine(c.sim, c.mpc, c.fail, c.debris,
                                       settings=st, dtype=dtype, device=device)
        build_s += time.time() - t0
        x0b, hold, is_rej = scenario_inputs(rng, c.orient, c.sim.x0, B)
        r, _ = engine_stats(engine, engine_noise(engine, gi, hold), x0b,
                            is_rej)
        for k, v in r.items():
            totals[k] = totals.get(k, 0.0) + v
        nok = B - int(r["n_diverged"])
        print(f"  [{gi + 1}/{len(cells)}] {c.orient:8s} Ru*{c.w:<5g} "
              f"success={int(r['n_success'])}/{B} "
              f"mean_fd={r['sum_final_dist'] / max(nok, 1):7.2f} m "
              f"diverged={int(r['n_diverged'])} "
              f"solved={int(r['n_solved'])} maxiter={int(r['n_maxiter'])} "
              f"pinf={int(r['n_pinf'])}", flush=True)

    wall = time.time() - t_all
    n = B * len(cells)
    steps = int(totals["alive_steps"])
    print(f"\n{n:,} mixed scenarios in {wall:.1f}s "
          f"({build_s:.1f}s of that engine builds) -> {n / wall:.1f} sims/s, "
          f"{steps / wall:,.0f} alive control steps/s")
    ndiv = int(totals["n_diverged"])
    print(f"aggregate: success {int(totals['n_success'])}/{n}, "
          f"diverged {ndiv}, "
          f"mean final dist {totals['sum_final_dist'] / max(n - ndiv, 1):.2f} m"
          f" (over non-diverged), mean i_term {totals['sum_i_term'] / n:.0f}")
    return totals


if __name__ == "__main__":
    main()
