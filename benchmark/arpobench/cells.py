"""Where the harness finds a cell, its configuration, its traffic and the
per-layer metrics: by name, in files under ``benchmark/``.

* ``workloads/<cell>.json``: the cell: its ``config`` and ``traffic`` names,
  the chips it needs, the end-to-end metrics it reports, and the limit of
  each number that its correctness check compares;
* ``configs/<config>.json``: a configuration as it is run, with its source
  and what was cut from it;
* ``traffic/<traffic>.json``: the traffic mix: the batch, the horizon of
  each batch, the pool of scenarios (``pool_batches`` batches, which the
  run's seed orders) and the traced span;
* ``metrics/<metric>.py``: one per-layer metric, a module with ``UNIT`` and
  ``read(run)``, which returns the metric's value or None where the run
  holds nothing it reads.

A later change adds a cell, a configuration, a traffic mix or a metric by
adding files; the harness reads whatever is there.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
END_TO_END = ("alive_solves_per_s", "step_ms_p90", "docked_pct", "setup_s")
LOOPS = ("discrete", "continuous")


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple
    limits: dict


def _load(kind: str, name: str, root: str) -> dict:
    if not NAME.match(name):
        raise ValueError(f"{kind} name {name!r} is not a name")
    path = os.path.join(root, kind, name + ".json")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind}"
                                f" {name!r}: {path} does not exist")
    with open(path) as fh:
        return json.load(fh)


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` with its configuration and traffic, checked for the
    keys the harness reads."""
    w = _load("workloads", name, root)
    cfg = _load("configs", w["config"], root)
    traffic = _load("traffic", w["traffic"], root)
    if cfg.get("loop") not in LOOPS:
        raise ValueError(f"config {w['config']}: loop must be one of {LOOPS}")
    for key in ("batch", "horizon_s", "trace_steps", "pool_batches"):
        if key not in traffic:
            raise ValueError(f"traffic {w['traffic']}: no {key!r}")
    lo, hi = traffic["trace_steps"]
    if not 1 <= lo < hi <= int(traffic["horizon_s"] / cfg["sim"]["time_stp"]):
        raise ValueError(f"traffic {w['traffic']}: the traced span "
                         f"[{lo}, {hi}) must start after the first step and "
                         "end inside a batch")
    e2e = tuple(w["end_to_end"])
    unknown = set(e2e) - set(END_TO_END)
    if unknown or "setup_s" not in e2e:
        raise ValueError(f"cell {name}: end_to_end {e2e} must hold setup_s "
                         f"and only {END_TO_END}")
    return Cell(name, int(w["chips"]), cfg, traffic, e2e, dict(w["limits"]))


def metric_readers(root: str = ROOT) -> dict:
    """Every per-layer metric under ``metrics/``: name -> module."""
    out = {}
    folder = os.path.join(root, "metrics")
    for fname in sorted(os.listdir(folder)):
        if not fname.endswith(".py") or fname.startswith("_"):
            continue
        name = fname[:-3]
        if not NAME.match(name):
            raise ValueError(f"metric file {fname}: {name!r} is not a name")
        spec = importlib.util.spec_from_file_location(
            "arpobench_metric_" + name.replace(".", "_"),
            os.path.join(folder, fname))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        if not hasattr(mod, "read") or not hasattr(mod, "UNIT"):
            raise ValueError(f"metric {name}: needs UNIT and read(run)")
        out[name] = mod
    return out
