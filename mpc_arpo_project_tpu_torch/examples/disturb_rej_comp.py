"""Offset-free vs plain MPC under constant-bias noise: the
disturbance-rejection Monte-Carlo study (reference ``test/disturbRejComp.py``),
collapsed from 2000 serial sims into batched rollouts. Port of
``examples/disturb_rej_comp.py``.

    python -m mpc_arpo_project_tpu_torch.examples.disturb_rej_comp [--runs 100] [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import Noise
from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc

NOISE_LENGTHS = [1.0, 10.0, 20.0, 30.0, 50.0, 70.0, 100.0, 150.0, 200.0, 250.0]
QUICK_NOISE_LENGTHS = [10.0, 50.0, 150.0]


def configs(quick=False, T_final=None):
    """(sim with rejection, sim without, mpc, fail, debris, noise lengths):
    the radial configuration at the study's sigma 0.7 held 50 steps
    (``disturbRejComp.py:23-25``); ``T_final`` defaults to 50 s with
    ``quick``, else 150 s."""
    if T_final is None:
        T_final = 50.0 if quick else 150.0
    sim_rej, mpc, fail, debris = radial_config(noisy=True, T_final=T_final)
    sim_rej = dataclasses.replace(sim_rej, noise=Noise((0.7, 0.7), 50),
                                  isReject=True)
    sim_norej = dataclasses.replace(sim_rej, isReject=False)
    lengths = QUICK_NOISE_LENGTHS if quick else NOISE_LENGTHS
    return sim_rej, sim_norej, mpc, fail, debris, lengths


def compute(runs=100, quick=False, max_iter=1000, per_setting=False,
            cpu=False, T_final=None):
    """(noise lengths, final-distance ratios reject / no-reject): the fused
    study (one engine build, hold length and switch as per-scenario data)
    or, with ``per_setting``, one engine pair per noise length; seed 0,
    fp32 on the card or fp64 on the CPU."""
    sim_rej, sim_norej, mpc, fail, debris, lengths = configs(quick, T_final)
    kw = dict(settings=admm.ADMMSettings(max_iter=max_iter),
              dtype=torch.float64 if cpu else torch.float32,
              device="cpu" if cpu else "cuda")
    if per_setting:
        return mc.disturbance_rejection_study(
            sim_norej, sim_rej, mpc, fail, debris, lengths, runs, 0, **kw)
    return mc.disturbance_rejection_study_fused(
        sim_rej, mpc, fail, debris, lengths, runs, 0, **kw)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=100,
                    help="MC runs per noise length")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in fp64")
    ap.add_argument("--quick", action="store_true",
                    help="3 noise lengths, short horizon")
    ap.add_argument("--max-iter", type=int, default=1000)
    ap.add_argument("--per-setting", action="store_true",
                    help="one engine build per noise length/arm (default is "
                         "the fused one-build study)")
    args = ap.parse_args(argv)

    t0 = time.time()
    nls, ratios = compute(args.runs, args.quick, args.max_iter,
                          args.per_setting, args.cpu)
    time_stp = configs(args.quick)[0].time_stp
    print(f"study wall: {time.time()-t0:.1f}s "
          f"({'per-setting' if args.per_setting else 'fused one-build'})")
    for nl, r in zip(nls, ratios):
        print(f"noise_length={nl:6.0f} steps ({nl * time_stp:6.1f}s): "
              f"final-distance ratio (reject/no-reject) = {r:.3f}")

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(6, 4), dpi=150)
    plt.plot(np.asarray(nls) * time_stp, ratios, "x-")
    plt.title("Final Distance Ratio vs Noise Length")
    plt.ylabel("Final Distance Ratio")
    plt.xlabel("Noise Length (s)")
    os.makedirs("RunFigs", exist_ok=True)
    plt.savefig("RunFigs/disturbRejComp.png")
    print("saved RunFigs/disturbRejComp.png")
    return nls, ratios


if __name__ == "__main__":
    main()
