"""Success-rate curve vs noise level: the production-path capability study.
Port of ``examples/success_curve.py``.

Extends the reference's success-rate MC
(``test/saved_runs/success_rates_test.py:64-75``, 300 serial runs at one
sigma) into a curve over noise levels, run through the PRODUCTION solver
(fp32 'eig' on the card) or, with ``--oracle``, the fp64 'chol' oracle on
the same device. The draws are ``np.random.RandomState(20260818)``
normals, the JAX driver's, so both arms see identical noise.

    python -m mpc_arpo_project_tpu_torch.examples.success_curve --sigmas 0 0.01 0.03 --runs 128
    python -m mpc_arpo_project_tpu_torch.examples.success_curve --oracle --cpu-runs 32
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

from mpc_arpo_project_tpu_torch.tools.status_mix import (
    build_configs, run_rollout_arm)

SEED = 20260818


def compute(sigmas=(0.0, 0.01, 0.03, 0.3), runs=128, config="ref",
            oracle=False, cpu_runs=None, device="cuda", T_final=None):
    """One row per sigma: runs, success, status mix, mean i_term and wall
    time of the 'prod' arm (fp32 'eig') or, with ``oracle``, the 'oracle'
    arm (fp64 'chol'), on ``device``. Noiseless rows run at most 8
    scenarios (they are deterministic); ``cpu_runs`` overrides ``runs`` for
    the oracle arm; ``T_final`` cuts the configuration's horizon."""
    rows = []
    for sig in sigmas:
        sim, mpc, fail, debris = build_configs(config, sig)
        if T_final is not None:
            sim = dataclasses.replace(sim, T_final=T_final)
        runs_s = runs if sig > 0 else min(runs, 8)
        if oracle and cpu_runs:
            runs_s = cpu_runs if sig > 0 else min(cpu_runs, 8)
        noise_rep = int(sim.noise.noise_length) if sim.noise else 50
        rng = np.random.RandomState(SEED)
        draws = rng.normal(size=(sim.nsim // noise_rep + 2, runs_s, 4))
        arm = run_rollout_arm(
            "oracle" if oracle else "prod", sim, mpc, fail, debris, draws,
            solve_mode="chol" if oracle else "eig",
            dtype_str="f64" if oracle else "f32", max_iter=4000,
            stall=12, tighten=24, tile=32, device=device)
        rows.append(dict(sigma=sig, runs=runs_s, **{
            k: arm[k] for k in ("n_success", "success_rate", "mix",
                                "mean_i_term", "wall_s")}))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sigmas", type=float, nargs="+",
                    default=(0.0, 0.01, 0.03, 0.3))
    ap.add_argument("--runs", type=int, default=128)
    ap.add_argument("--config", choices=["bench", "ref"], default="ref")
    ap.add_argument("--oracle", action="store_true",
                    help="run the fp64 'chol' oracle arm instead of the fp32 "
                         "production arm")
    ap.add_argument("--cpu-runs", type=int, default=None,
                    help="override --runs for the (slow) oracle")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the arm keeps its dtype)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "success_curve.json"))
    args = ap.parse_args(argv)

    rows = compute(args.sigmas, args.runs, args.config, args.oracle,
                   args.cpu_runs, device="cpu" if args.cpu else "cuda")
    for r in rows:
        print(f"sigma={r['sigma']:<5g} success {r['n_success']}/{r['runs']} "
              f"({r['success_rate']:.1%})  mix={r['mix']}", flush=True)
    with open(args.out, "w") as fh:
        json.dump({"config": args.config,
                   "arm": "oracle" if args.oracle else "prod",
                   "rows": rows}, fh, indent=1)
    print(f"wrote {args.out}")
    return rows


if __name__ == "__main__":
    main()
