"""Batched Monte-Carlo success-rate study (reference
``test/saved_runs/success_rates_test.py``: 300 serial sims become chunked
batched rollouts; scale the count freely). Port of
``examples/success_rates.py``.

    python -m mpc_arpo_project_tpu_torch.examples.success_rates [--runs 300] [--chunk 64] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from mpc_arpo_project_tpu_torch.config import Noise
from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc


def compute(runs=300, chunk=64, sigma=0.3, checkpoint=None, T_final=300.0,
            cpu=False):
    """The study's result dict (``mc.run_sweep``'s): the radial
    configuration at noise ``sigma`` held 50 steps, fp32 on the card or
    fp64 on the CPU, noise from seed 0."""
    sim, mpc, fail, debris = radial_config(noisy=True, T_final=T_final)
    sim = dataclasses.replace(sim, noise=Noise((sigma, sigma), 50))
    return mc.success_rate_study(
        sim, mpc, fail, debris, runs, chunk, 0, checkpoint_path=checkpoint,
        settings=admm.ADMMSettings(max_iter=1000),
        dtype=torch.float64 if cpu else torch.float32,
        device="cpu" if cpu else "cuda",
    )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=300)
    ap.add_argument("--chunk", type=int, default=64)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in fp64")
    ap.add_argument("--sigma", type=float, default=0.3,
                    help="noise std (reference uses 0.3)")
    ap.add_argument("--checkpoint", default=None,
                    help="sweep checkpoint path (resume)")
    args = ap.parse_args(argv)

    t0 = time.time()
    res = compute(args.runs, args.chunk, args.sigma, args.checkpoint,
                  cpu=args.cpu)
    el = time.time() - t0
    print(f"{res['n']} runs in {el:.1f}s ({res['n']/el:.1f} sims/s)")
    print(f"success rate: {res['success_rate']:.3f}")
    print(f"mean final distance: {res['mean_final_dist']:.2f} m; "
          f"mean i_term: {res['mean_i_term']:.0f} steps")
    print(f"controller usage: {res['ctrl_usage']}")
    return res


if __name__ == "__main__":
    main()
