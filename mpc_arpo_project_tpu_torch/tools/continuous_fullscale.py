"""Port of ``tools/continuous_fullscale.py:1-167``: the full-scale
continuous-sim artifact.

The reference's flagship "most complex simulation" is the continuous-time
nonlinear closed loop at T_final=300 s, T_cont=1 ms: 300,000 RK45 substeps
(``test/traj_eval_radialC.py:37-38``), run serially in Python. This tool
records the full-length numbers:

  --gpu       the production run on the card: the JAX tool's engine
              (``ADMMSettings(max_iter=1000)``, its default 'chol' solve,
              fp32) over --batch scenarios: wall-clock, substeps/s,
              outcome, controller mix, and the launches of ``eig_chunk``
              and ``rk4_tick``. The JAX tool's ``--tpu``.
  --parity    the port's fp64 engine, on the card unless --cpu is given,
              against the serial NumPy oracle (``tools/ref_sim.py`` of the
              port, ``simulate_continuous``) on identical
              ``RandomState(11)`` draws at FULL length: tick-trajectory
              agreement, i_term_sub, ctrl_seq equality, success.

The draws of --gpu come from a ``torch.Generator`` on the card and cannot
equal the JAX tool's ``jax.random.key(0)`` draws: compare its record with
the JAX package's (``artifacts/contC_tpu_r5.json``) as an outcome, not bit
for bit. There is no CPU fallback: --gpu, and --parity without --cpu,
raise when no CUDA device is present.

    python -m mpc_arpo_project_tpu_torch.tools.continuous_fullscale --gpu --T 300 [--batch 8]
    python -m mpc_arpo_project_tpu_torch.tools.continuous_fullscale --parity --T 300 [--cpu]

``fullscale_record`` and the parity pieces (``parity_draws``,
``oracle_scaling``, ``oracle_run``, ``parity_record``) are what the
command-line runs call; tests and ``chip_smoke.py`` call them with their
own engines and draws.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm, admm_eig, rk4_tick
from mpc_arpo_project_tpu_torch.rollout import continuous
from mpc_arpo_project_tpu_torch.tools import ref_sim

CONFIG = "radialC flagship (ref test/traj_eval_radialC.py:37-38)"
PARITY_SEED = 11
T_CONT = 1e-3


def configs(T_final):
    return radial_config(noisy=True, T_final=T_final, T_cont=T_CONT)


def build(T_final, dtype, device="cuda"):
    """The JAX tool's engine: radialC at ``T_final``, 'chol', max_iter
    1000, on ``device`` (the CUDA device unless the caller asks for the
    CPU)."""
    return continuous.build_engine(
        *configs(T_final), settings=admm.ADMMSettings(max_iter=1000),
        dtype=dtype, device=device)


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or 'cpu'."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from mpc_arpo_project_tpu_torch.tools.kernel_probe import card_line
    return card_line()


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fullscale_record(engine, draws, seg=25, warmup=False):
    """Run ``engine`` over ``draws`` ((n_draws, B, 2) pre-scaled, as
    ``continuous.make_noise_draws`` gives) and return the record: the JAX
    tool's keys, plus ``device`` and the ``eig_chunk`` and ``rk4_tick``
    launches of the timed run. ``warmup`` runs the loop once before the
    timed run (its wall time is ``wall_cold_s``; None without it).
    Returns (record, the timed run's ``ContinuousOut``)."""
    base = engine.base
    dev = base.device
    B = draws.shape[1]
    n_total = engine.n_ticks * engine.n_sub
    wall_cold = None
    if warmup:
        t0 = time.perf_counter()
        continuous.rollout_chunked(engine, draws, seg=seg)
        _sync(dev)
        wall_cold = time.perf_counter() - t0

    admm_eig.eig_chunk.launches = 0
    rk4_tick.rk4_tick.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    out = continuous.rollout_chunked(engine, draws, seg=seg)
    i_term_sub = out.i_term_sub.cpu().numpy()
    wall = time.perf_counter() - t0
    launches = {"eig_chunk": admm_eig.eig_chunk.launches,
                "rk4_tick": rk4_tick.rk4_tick.launches}

    codes = out.ctrl_seq.cpu().numpy()
    status = out.status.cpu().numpy()
    rec = {
        "config": CONFIG,
        "backend": dev.type,
        "device": device_line(dev),
        "dtype": "f64" if base.dtype == torch.float64 else "f32",
        "solve_mode": base.settings.solve_mode,
        "T_final_s": round(n_total * T_CONT, 9),
        "T_cont_s": T_CONT,
        "batch": B,
        "substeps_per_scenario": n_total,
        "wall_s": wall,
        "wall_cold_s": wall_cold,
        "substeps_per_s": n_total * B / wall,
        "alive_ticks": int((codes > 0).sum()),
        "i_term_sub": i_term_sub.tolist(),
        "success": out.success.cpu().numpy().astype(int).tolist(),
        "ctrl_usage": {
            "mpc": int((codes == 1).sum()),
            "failsafe": int((codes == 2).sum()),
            "deadbeat": int((codes == 3).sum()),
        },
        "status_mix_alive": {str(k): int((status == k).sum())
                             for k in (1, 2, 3)},
        "launches": launches,
    }
    return rec, out


def run_gpu(T_final, batch, seg, out_path, seed=0):
    """The production run on the card (the JAX tool's ``run_tpu``)."""
    engine = build(T_final, torch.float32, "cuda")
    gen = torch.Generator(device=engine.base.device).manual_seed(seed)
    draws = continuous.make_noise_draws(engine, gen, batch)
    rec, _ = fullscale_record(engine, draws, seg=seg, warmup=True)
    _write(rec, out_path)
    return rec


def parity_draws(engine) -> np.ndarray:
    """The JAX tool's parity draws: (n_draws, 2) standard normals of
    ``RandomState(11)``, unscaled."""
    n_total = engine.n_ticks * engine.n_sub
    n_draws = n_total // engine.noise_int_sub + 2
    return np.random.RandomState(PARITY_SEED).normal(size=(n_draws, 2))


def oracle_scaling(engine):
    """(D, E, c) of the engine's prepared problem, for ``OSQPRef``'s
    ``scaling_override``."""
    prob = engine.base.prob
    return (prob.D.cpu().double().numpy(), prob.E.cpu().double().numpy(),
            float(prob.c))


def oracle_run(T_final, draws, scaling):
    """The serial NumPy oracle (host, fp64) on the parity draws with the
    engine's scaling pinned; returns (its dict, wall seconds). Touches no
    torch tensor, so a child process without CUDA can run it."""
    t0 = time.perf_counter()
    runo = ref_sim.simulate_continuous(
        *configs(T_final), noise_draws=draws,
        solver_kwargs=dict(scaling_override=scaling, max_iter=1000))
    return runo, time.perf_counter() - t0


def parity_record(engine, draws, runo, wall_oracle, seg=25):
    """Roll the engine out on the parity draws and hold it to the oracle's
    run ``runo``: the JAX tool's record (``tools/continuous_fullscale.py:
    130-153``) with the port's wall time under ``wall_port_s``, the
    engine's ``device``, the first row of the tick trajectory (row j+1 is
    the state after tick j) that differs by more than 1e-6, and the largest
    difference over the rows up to the start of the terminating tick."""
    base = engine.base
    n_total = engine.n_ticks * engine.n_sub
    t0 = time.perf_counter()
    out = continuous.rollout_chunked(
        engine, engine.sig_cont * torch.as_tensor(
            draws, dtype=base.dtype, device=base.device)[:, None, :],
        seg=seg)
    it = int(out.i_term_sub[0])
    wall_port = time.perf_counter() - t0
    ticks = out.x_true_ticks[:, 0, :].cpu().double().numpy()
    row_dev = np.abs(ticks - runo["x_ticks"]).max(1)
    over = np.nonzero(row_dev > 1e-6)[0]
    # the rows up to the start of the terminating tick: after it the engine
    # holds the state at the terminating substep, the oracle the state at
    # the start of that tick
    j_term = int(runo["i_term_sub"]) // engine.n_sub
    return {
        "T_final_s": round(n_total * T_CONT, 9),
        "substeps": n_total,
        "backend": base.device.type,
        "device": device_line(base.device),
        "i_term_sub_port": it,
        "i_term_sub_oracle": int(runo["i_term_sub"]),
        "ctrl_seq_equal": bool(
            (out.ctrl_seq[:, 0].cpu().numpy() == runo["ctrl_seq"][1:]).all()),
        "tick_traj_max_abs_dev": float(row_dev.max()),
        "tick_traj_atol_1e-6_ok": bool(np.allclose(ticks, runo["x_ticks"],
                                                   atol=1e-6)),
        "first_tick_row_over_1e-6": int(over[0]) if over.size else None,
        "tick_traj_max_abs_dev_to_termination": float(
            row_dev[:j_term + 1].max()),
        "success_port": bool(out.success[0]),
        "success_oracle": bool(runo["success"]),
        "wall_port_s": wall_port,
        "wall_oracle_s": wall_oracle,
    }


def parity_ok(rec) -> bool:
    """The JAX tool's criteria: i_term_sub, ctrl_seq and success equal,
    and the tick trajectory within 1e-6."""
    return (rec["i_term_sub_port"] == rec["i_term_sub_oracle"]
            and rec["ctrl_seq_equal"] and rec["tick_traj_atol_1e-6_ok"]
            and rec["success_port"] == rec["success_oracle"])


def run_parity(T_final, out_path, device="cuda"):
    """The port's fp64 engine on ``device`` against the oracle (the JAX
    tool's ``run_parity``)."""
    engine = build(T_final, torch.float64, device)
    draws = parity_draws(engine)
    runo, wall_oracle = oracle_run(T_final, draws, oracle_scaling(engine))
    rec = parity_record(engine, draws, runo, wall_oracle)
    _write(rec, out_path)
    return rec


def _write(rec, out_path):
    print(json.dumps(rec, indent=1))
    with open(out_path, "w") as fh:
        json.dump(rec, fh, indent=1)
    print(f"wrote {out_path}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--parity", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="run --parity's engine on the CPU")
    ap.add_argument("--T", type=float, default=300.0)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seg", type=int, default=25)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    tmp = tempfile.gettempdir()
    if args.gpu:
        return run_gpu(args.T, args.batch, args.seg,
                       args.out or os.path.join(tmp, "contC_gpu.json"))
    if args.parity:
        return run_parity(args.T,
                          args.out or os.path.join(tmp, "contC_parity.json"),
                          device="cpu" if args.cpu else "cuda")
    ap.error("give --gpu or --parity")


if __name__ == "__main__":
    main()
