"""Reporting & animation: matplotlib report parity with the reference's
figures. Counterpart of ``mpc_arpo_project_tpu/viz``; imports matplotlib,
so nothing that runs without it (the package's ``__init__``, the compute
functions of the drivers, ``chip_smoke.py``) imports this package."""

from mpc_arpo_project_tpu_torch.viz.report import figurePlotSave, simrun_from_rollout
from mpc_arpo_project_tpu_torch.viz.animate import animate_trajectory
from mpc_arpo_project_tpu_torch.viz.animate_html import export_html

__all__ = ["figurePlotSave", "simrun_from_rollout", "animate_trajectory",
           "export_html"]
