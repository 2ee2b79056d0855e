"""Plant models of the port: Clohessy-Wiltshire linear dynamics and the
nonlinear two-body plant."""

from mpc_arpo_project_tpu_torch.models.cw import (
    cw_continuous,
    discretize,
    observer_matrices,
)
from mpc_arpo_project_tpu_torch.models.nonlinear import two_body_deriv, rk4_step

__all__ = [
    "cw_continuous",
    "discretize",
    "observer_matrices",
    "two_body_deriv",
    "rk4_step",
]
