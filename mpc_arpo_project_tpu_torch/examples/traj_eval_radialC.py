"""Continuous-time nonlinear plant closed loop (reference
``test/traj_eval_radialC.py``), acceleration or impulsive delta-v input
model; each 0.5 s tick integrates 500 RK4 substeps in the ``rk4_tick``
kernel. Port of ``examples/traj_eval_radialC.py``.

    python -m mpc_arpo_project_tpu_torch.examples.traj_eval_radialC [--deltav] [--T 150] [--cpu]
"""

from __future__ import annotations

import argparse

import torch

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.examples.traj_eval_radial import report
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.rollout import continuous


def compute(deltav=False, T=150.0, cpu=False):
    """(sim, debris, engine, rollout output) of one radialC scenario, fp32
    on the card or fp64 on the CPU, draws from a generator seeded 0 on the
    engine's device."""
    sim, mpc, fail, debris = radial_config(
        noisy=True, T_final=T, is_delta_v=deltav, T_cont=1e-3)
    engine = continuous.build_engine(
        sim, mpc, fail, debris, settings=admm.ADMMSettings(max_iter=1000),
        dtype=torch.float64 if cpu else torch.float32,
        device="cpu" if cpu else "cuda")
    gen = torch.Generator(device=engine.base.device).manual_seed(0)
    draws = continuous.make_noise_draws(engine, gen, 1)
    return sim, debris, engine, continuous.rollout(engine, draws)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--deltav", action="store_true",
                    help="impulsive delta-v input model")
    ap.add_argument("--T", type=float, default=150.0, help="T_final seconds")
    ap.add_argument("--cpu", action="store_true", help="run on CPU (fp64)")
    ap.add_argument("--save", type=int, default=0)
    args = ap.parse_args(argv)
    sim, debris, engine, out = compute(args.deltav, args.T, args.cpu)
    it_sub = int(out.i_term_sub[0])
    print(f"i_term_sub={it_sub}/{engine.n_ticks * engine.n_sub} "
          f"({it_sub * sim.T_cont:.1f}s)")
    return report(sim, debris, out, args.save, continuous=True)


if __name__ == "__main__":
    main()
