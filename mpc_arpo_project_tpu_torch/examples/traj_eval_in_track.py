"""In-track approach scenario (reference ``test/traj_eval_in_track.py``):
noiseless discrete-time run with the swapped Q/R weighting (``swap_xy``),
per-row slack weights, debris at (0, 40), and the hatch rotated 90 degrees.
Port of ``examples/traj_eval_in_track.py``.

    python -m mpc_arpo_project_tpu_torch.examples.traj_eval_in_track [--save N] [--cpu]
"""

from __future__ import annotations

import argparse

from mpc_arpo_project_tpu_torch.examples.common import in_track_config
from mpc_arpo_project_tpu_torch.examples.traj_eval_radial import (
    report, run_one)


def compute(cpu=False, T_final=150.0):
    """(sim, debris, rollout output) of the in-track run."""
    sim, mpc, fail, debris = in_track_config(T_final=T_final)
    return sim, debris, run_one(sim, mpc, fail, debris, cpu)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--save", type=int, default=0,
                    help="figure counter for RunFigs/")
    ap.add_argument("--cpu", action="store_true", help="run on CPU (fp64)")
    args = ap.parse_args(argv)
    sim, debris, out = compute(args.cpu)
    return report(sim, debris, out, args.save)


if __name__ == "__main__":
    main()
