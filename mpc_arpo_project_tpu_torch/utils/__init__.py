"""Utilities: timing/profiling harness, spans and numeric guards."""

from mpc_arpo_project_tpu_torch.utils.timing import (
    device_time, host_read, profile_trace, span)
from mpc_arpo_project_tpu_torch.utils.guards import check_finite_tree

__all__ = ["device_time", "host_read", "profile_trace", "span",
           "check_finite_tree"]
