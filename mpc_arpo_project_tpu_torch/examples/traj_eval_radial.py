"""Discrete-time linear CW plant, radial approach (reference
``test/traj_eval_radial.py``): a single run and the report figures. Port of
``examples/traj_eval_radial.py``.

    python -m mpc_arpo_project_tpu_torch.examples.traj_eval_radial [--noiseless] [--save N] [--cpu]
"""

from __future__ import annotations

import argparse
from collections import Counter

import torch

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.rollout import discrete


def run_one(sim, mpc, fail, debris, cpu=False):
    """One scenario of the configuration, fp32 on the card or fp64 on the
    CPU, noise from a generator seeded 0 on the engine's device. Returns
    the rollout output (batch of 1)."""
    device = "cpu" if cpu else "cuda"
    engine = discrete.build_engine(
        sim, mpc, fail, debris, dtype=torch.float64 if cpu else torch.float32,
        device=device)
    gen = torch.Generator(device=engine.device).manual_seed(0)
    return discrete.rollout(engine, discrete.make_noise_sequence(engine, gen, 1))


def compute(noiseless=False, cpu=False, T_final=150.0):
    """(sim, debris, rollout output) of the radial run."""
    sim, mpc, fail, debris = radial_config(noisy=not noiseless,
                                           T_final=T_final)
    return sim, debris, run_one(sim, mpc, fail, debris, cpu)


def report(sim, debris, out, save=0, continuous=False):
    """Print scenario 0's termination, success and controller usage, then
    save the report figures under RunFigs/ (needs matplotlib)."""
    i_term = int((out.i_term_sub if continuous else out.i_term)[0])
    codes = out.ctrl_seq[:, 0].cpu()
    codes = codes[codes > 0] if continuous else codes[:i_term]
    print(f"i_term={i_term} success={bool(out.success[0])}")
    print("controllers:", Counter(codes.tolist()))

    from mpc_arpo_project_tpu_torch.viz import (
        figurePlotSave, simrun_from_rollout)

    run = simrun_from_rollout(out, 0, continuous=continuous)
    if continuous:
        run.noise_hist = None
    figurePlotSave(sim, debris, run, saveCounter=save)
    print(f"figures saved under RunFigs/ with counter {save}")
    return run


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--noiseless", action="store_true")
    ap.add_argument("--save", type=int, default=0,
                    help="figure counter for RunFigs/")
    ap.add_argument("--cpu", action="store_true", help="run on CPU (fp64)")
    args = ap.parse_args(argv)
    sim, debris, out = compute(args.noiseless, args.cpu)
    return report(sim, debris, out, args.save)


if __name__ == "__main__":
    main()
