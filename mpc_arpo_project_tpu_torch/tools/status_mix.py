"""Status-mix / success-rate comparison between solver arms.

Port of ``tools/status_mix.py`` (``build_configs`` is a copy of its
lines 51-99 and ``run_refsim_arm`` of its lines 190-230, unchanged but for
the port's config classes and oracle). The solver
status drives the reference's failsafe switching
(``src/trajectorySimulate.py:296-314``), so the production path's
acceptance test is: at IDENTICAL settings and noise draws, does the
production closed loop produce the same per-step status mix, controller
usage and success rate as the fp64 oracle?

Arms (``--arm``, repeatable; all run on one ``--device``, the CUDA device
by default):
  prod            fp32, production solve mode (--solve-mode, default eig),
                  production stall settings (--stall/--tighten)
  prod-pallas     fp32, the Newton-Schulz kernel path ('pallas')
  oracle          fp64 'chol' (exact batched Cholesky), SAME stall settings
                  as prod: isolates fp32 and kernel effects
  oracle-nostall  fp64 'chol' with stall exit DISABLED at the full max_iter
                  cap: OSQP-faithful termination semantics
                  (``trajectorySimulate.py:296-299``)
  refsim          the serial NumPy oracle (``tools/ref_sim.py`` of the port,
                  the branch-for-branch reference replica): host fp64
                  whatever --device says; slow, use small --runs or --shard

Unlike the JAX tool, whose fp64 arms need a CPU process of their own, one
process runs every rollout arm on the card. The draws are
``np.random.RandomState`` normals, bit for bit the JAX tool's for the same
``--seed``, and ``--shard i/N`` slices them as it does, so
``tools/merge_shards.py`` merges either tool's shard files.

    python -m mpc_arpo_project_tpu_torch.tools.status_mix --config bench --runs 128
    python -m mpc_arpo_project_tpu_torch.tools.status_mix --config ref --sigma 0.03 \\
        --runs 128 --shard 0/8 --arm oracle
    python -m mpc_arpo_project_tpu_torch.tools.status_mix --device cpu --runs 4 ...

Writes a JSON summary to --out (default ``status_mix.json`` in the
temporary directory), after every arm.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import tempfile
import time

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import (
    SimConditions, MPCParams, FailsafeParams, Noise, Debris,
)
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.rollout import discrete
from mpc_arpo_project_tpu_torch.tools import ref_sim

STATUS_NAME = {0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER", 3: "PINF", 4: "DINF"}
ORACLE_TO_CODE = {
    "solved": 1,
    "max iterations": 2,
    "primal infeasible": 3,
    "dual infeasible": 4,
}
ARMS = ("prod", "prod-pallas", "oracle", "oracle-nostall", "refsim")


def build_configs(which: str, sigma: float = None):
    v_ecr = 50000.0 * np.ones(5)
    v_ecr[-2] *= -1
    v_ecr[-1] = 0.0
    if which == "bench":
        Nx, sig_d, T_final = 50, 0.75, 150.0
    else:  # reference success-rate study config (success_rates_test.py:13-15,57)
        Nx, sig_d, T_final = 40, 0.3, 300.0
    if sigma is not None:
        sig_d = sigma
    # sigma == 0 means NOISELESS (no estimator): a Noise object with zero std
    # leaves the UKF running with zero disturbance process noise, whose
    # singular covariance breaks the fp32 sigma-point Cholesky — the
    # reference's noiseless runs likewise bypass estimation
    noise = Noise((sig_d, sig_d), 50) if sig_d > 0 else None
    mpc = MPCParams(
        8e2 * np.diag([0.2**2, 10**2, 3.8**2, 900.0]),
        1000**2 * np.eye(2),
        5**2 * np.eye(5),
        v_ecr,
        {"Nx": Nx, "Nc": 5, "Nb": 5},
        (0.2, 0.2),
    )
    fail = FailsafeParams(
        0.005 * np.diag([0.0001, 1, 100000.0, 1.0, 0.01]),
        100 * np.eye(2),
        np.eye(1, 4),
        np.zeros((2, 2)),
    )
    debris = Debris((40.0, 0.0), 5.0, 20.0)
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]),
        np.array([2.5, 0.0, 0.0, 0.0]),
        2.5,
        10 * np.pi / 180,
        1.5,
        1.107e-3,
        0.5,
        True,
        (0.2, 45.0),
        noise,
        False,
        T_final=T_final,
    )
    return sim, mpc, fail, debris


def draw_matrix(sim, runs: int, seed: int, shard: str = None):
    """The standard-normal draws (n_draws, runs, 4) of ``np.random.
    RandomState(seed)`` at full width, and with ``shard`` ('i/N') the
    columns ``[i*runs/N, (i+1)*runs/N)`` of them, so a shard's scenarios
    are bit-identical slices of the unsharded run. Returns (draws, the
    summary's shard block or None)."""
    noise_rep = int(sim.noise.noise_length) if sim.noise is not None else 50
    n_draws = sim.nsim // noise_rep + 2
    draws = np.random.RandomState(seed).normal(0.0, 1.0, size=(n_draws, runs, 4))
    if not shard:
        return draws, None
    i, n = (int(v) for v in shard.split("/"))
    lo, hi = i * runs // n, (i + 1) * runs // n
    return draws[:, lo:hi], {"index": i, "of": n, "lo": lo, "hi": hi}


def run_rollout_arm(name, sim, mpc, fail, debris, draws, *, solve_mode,
                    dtype_str, max_iter, stall, tighten, tile, seg=10,
                    device="cuda"):
    """One batched-rollout arm on ``device`` (the CUDA device unless the
    caller asks for the CPU; any arm on either): its status mix, residual
    percentiles, success and controller usage."""
    device = admm.resolve_device(device)
    settings = admm.ADMMSettings(
        max_iter=max_iter,
        solve_mode=solve_mode,
        stall_exit_chunks=stall,
        stall_tighten_chunks=tighten,
        pallas_tile=tile,
    )
    dtype = torch.float64 if dtype_str == "f64" else torch.float32
    t0 = time.time()
    engine = discrete.build_engine(sim, mpc, fail, debris, settings=settings,
                                   dtype=dtype, device=device)
    noise_seq = discrete.noise_sequence_from_draws(engine, draws)
    out = discrete.rollout_chunked(engine, noise_seq, seg=seg)
    host = lambda v: v.cpu().numpy()
    st = host(out.status)  # (T, B), -1 for dead
    codes = {k: int((st == k).sum()) for k in STATUS_NAME}
    alive = int((st >= 0).sum())
    # MAX_ITER fraction by time decile of each scenario's own lifetime:
    # distinguishes warm-start DRIFT (failures cluster late) from a uniform
    # fp32 residual floor (flat profile)
    T, B = st.shape
    i_term = host(out.i_term)  # (B,)
    tt = np.arange(T)[:, None]
    life = np.maximum(i_term[None, :], 1)
    dec = np.minimum(10 * tt // life, 9)  # (T, B) decile index
    mi_by_dec = []
    for d in range(10):
        sel = st[(dec == d) & (st >= 0)]
        mi_by_dec.append(
            round(float((sel == 2).mean()), 4) if sel.size else None)
    # Exit-residual distribution of MAX_ITER and SOLVED steps, as res/tol
    # ratios where the solve path reports tolerances (converged <= 1,
    # plateau ~1-3, divergent >> 1); non-finite exits are counted apart so
    # the JSON stays strict-valid
    res_q = {}
    rp = host(out.pri_res)
    rd = host(out.dua_res)
    for code, nm in ((2, "MAX_ITER"), (1, "SOLVED")):
        m = (st == code)
        if m.any():
            worst = np.maximum(rp[m], rd[m])
            fin = worst[np.isfinite(worst)]
            res_q[nm] = {
                "pctiles_10_50_90_99": [round(float(v), 6) for v in
                                        np.percentile(fin, [10, 50, 90, 99])]
                if fin.size else None,
                "n_nonfinite": int(worst.size - fin.size),
                "n": int(worst.size),
            }
    success = host(out.success)
    ctrl = host(out.ctrl_seq)
    return {
        "arm": name,
        "solve_mode": solve_mode,
        "dtype": dtype_str,
        "stall": stall,
        "backend": device.type,
        "wall_s": round(time.time() - t0, 1),
        "alive_steps": alive,
        "mix": {STATUS_NAME[k]: round(v / max(alive, 1), 4)
                for k, v in codes.items()},
        "max_iter_frac_by_lifetime_decile": mi_by_dec,
        "exit_residuals_over_tol": res_q,
        "counts": {STATUS_NAME[k]: v for k, v in codes.items()},
        "success_rate": float(success.mean()),
        "n_success": int(success.sum()),
        "mean_i_term": float(i_term.mean()),
        "ctrl_usage": {
            "mpc": int((ctrl == 1).sum()),
            "failsafe": int((ctrl == 2).sum()),
            "deadbeat": int((ctrl == 3).sum()),
        },
    }


def run_refsim_arm(sim, mpc, fail, debris, draws, *, max_iter, stall):
    """The serial NumPy oracle (``tools/ref_sim.py`` of the port) on each
    scenario's draws in turn, on the host in fp64 whatever ``--device``
    says: the summary keys of the JAX tool's arm
    (``tools/status_mix.py:190-230``)."""
    B = draws.shape[1]
    counts = collections.Counter()
    succ = 0
    i_terms = []
    ctrl_counts = collections.Counter()
    t0 = time.time()
    for b in range(B):
        run = ref_sim.simulate_discrete(
            sim, mpc, fail, debris, noise_draws=draws[:, b],
            solver_kwargs=dict(max_iter=max_iter, stall_exit_chunks=stall),
        )
        counts.update(run.statuses)
        succ += bool(run.success)
        i_terms.append(run.i_term)
        ctrl_counts.update(run.ctrl_seq.astype(int).tolist())
        print(f"  refsim {b + 1}/{B}: i_term={run.i_term} "
              f"success={run.success} "
              f"statuses={dict(collections.Counter(run.statuses))}",
              flush=True)
    alive_o = sum(counts.values())
    return {
        "arm": "refsim",
        "solve_mode": "numpy",
        "dtype": "f64",
        "stall": stall,
        "wall_s": round(time.time() - t0, 1),
        "alive_steps": alive_o,
        "mix": {STATUS_NAME[ORACLE_TO_CODE[k]]: round(v / alive_o, 4)
                for k, v in counts.items()},
        "counts": {STATUS_NAME[ORACLE_TO_CODE[k]]: v
                   for k, v in counts.items()},
        "success_rate": succ / B,
        "n_success": succ,
        "mean_i_term": float(np.mean(i_terms)),
        "ctrl_usage": {"mpc": ctrl_counts.get(1, 0),
                       "failsafe": ctrl_counts.get(2, 0),
                       "deadbeat": ctrl_counts.get(3, 0)},
    }


def arm_options(arm, solve_mode="eig", stall=12, tighten=24):
    """``run_rollout_arm``'s solver keywords for a rollout arm."""
    if arm == "prod":
        return dict(solve_mode=solve_mode, dtype_str="f32", stall=stall,
                    tighten=tighten)
    if arm == "prod-pallas":
        return dict(solve_mode="pallas", dtype_str="f32", stall=stall,
                    tighten=tighten)
    if arm == "oracle":
        return dict(solve_mode="chol", dtype_str="f64", stall=stall,
                    tighten=tighten)
    if arm == "oracle-nostall":
        return dict(solve_mode="chol", dtype_str="f64", stall=0,
                    tighten=10**6)
    raise ValueError(f"unknown rollout arm {arm!r}")


def parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", choices=["bench", "ref"], default="bench")
    ap.add_argument("--sigma", type=float, default=None,
                    help="override the config's noise std (both axes)")
    ap.add_argument("--runs", type=int, default=128)
    ap.add_argument("--max-iter", type=int, default=4000)
    ap.add_argument("--stall", type=int, default=12)
    ap.add_argument("--tighten", type=int, default=24)
    ap.add_argument("--solve-mode", default="eig", choices=("eig", "pallas"))
    ap.add_argument("--tile", type=int, default=32)
    ap.add_argument("--seg", type=int, default=10)
    ap.add_argument("--arm", action="append", choices=ARMS, default=None,
                    help="repeatable; default: prod + oracle")
    ap.add_argument("--seed", type=int, default=20260818)
    ap.add_argument("--shard", default=None,
                    help="'i/N': run only scenario columns [i*runs/N, (i+1)*"
                         "runs/N) of the full --runs draw matrix. Draws are "
                         "generated at full width first, so shard results are "
                         "bit-identical slices of the unsharded run; counts/"
                         "successes sum across shards (tools/merge_shards.py)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where every arm runs (no fallback: cuda raises "
                         "without a CUDA device)")
    ap.add_argument("--out",
                    default=os.path.join(tempfile.gettempdir(),
                                         "status_mix.json"))
    return ap


def run(argv=None) -> dict:
    """Run the arms that ``argv`` names and return the summary; the JSON
    file at ``--out`` is rewritten after every arm, so a killed process
    keeps the arms it finished."""
    args = parser().parse_args(argv)
    arms = args.arm or ["prod", "oracle"]
    sim, mpc, fail, debris = build_configs(args.config, args.sigma)
    draws, shard = draw_matrix(sim, args.runs, args.seed, args.shard)
    if shard:
        print(f"shard {shard['index']}/{shard['of']}: scenarios "
              f"[{shard['lo']}, {shard['hi']}) of {args.runs}", flush=True)

    summary = {"config": args.config, "sigma": args.sigma, "runs": args.runs,
               "nsim": sim.nsim, "max_iter": args.max_iter, "seed": args.seed,
               "shard": shard, "arms": {}}
    for arm in arms:
        if arm == "refsim":
            r = run_refsim_arm(sim, mpc, fail, debris, draws,
                               max_iter=args.max_iter, stall=args.stall)
        else:
            r = run_rollout_arm(
                arm, sim, mpc, fail, debris, draws, max_iter=args.max_iter,
                tile=args.tile, seg=args.seg, device=args.device,
                **arm_options(arm, args.solve_mode, args.stall, args.tighten))
        summary["arms"][arm] = r
        print(json.dumps(r, indent=1), flush=True)
        with open(args.out, "w") as fh:
            json.dump(summary, fh, indent=1)
    print(f"wrote {args.out}")
    return summary


if __name__ == "__main__":
    run()
