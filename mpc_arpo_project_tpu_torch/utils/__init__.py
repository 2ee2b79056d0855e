"""Utilities: timing/profiling harness and numeric guards."""

from mpc_arpo_project_tpu_torch.utils.timing import Timer, device_time, profile_trace
from mpc_arpo_project_tpu_torch.utils.guards import check_finite_tree

__all__ = ["Timer", "device_time", "profile_trace", "check_finite_tree"]
