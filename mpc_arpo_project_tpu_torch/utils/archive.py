"""Run archiving: pickle/restore of (SimConditions, SimRun) pairs.

Counterpart of ``mpc_arpo_project_tpu/utils/archive.py`` with the port's own
config classes. The layout is the reference's ``RunObjs/`` pickle,
``{'simcond': ..., 'simrun': ..., 'debris': ...}``, so either package's
``load_run`` reads what the other's ``save_run`` wrote once the classes
named in the file import.
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

from mpc_arpo_project_tpu_torch.config import Debris, SimConditions, SimRun


def save_run(
    path: str,
    sim_conditions: SimConditions,
    sim_run: SimRun,
    debris: Optional[Debris] = None,
) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        pickle.dump(
            {"simcond": sim_conditions, "simrun": sim_run, "debris": debris}, fh
        )
    return path


def load_run(path: str):
    """Returns (sim_conditions, sim_run, debris). Unpickling runs code named
    in the file: load only archives this program wrote."""
    with open(path, "rb") as fh:
        d = pickle.load(fh)
    return d["simcond"], d["simrun"], d.get("debris")
