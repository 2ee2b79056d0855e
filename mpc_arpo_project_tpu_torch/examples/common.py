"""Shared configuration for the example drivers: the reference's canonical
radial and in-track setups.

Copy of ``examples/common.py:1-99`` (``radial_config`` and
``in_track_config``, unchanged but for the port's config classes and the
reference project's paths, given from its root), kept in the port so that
it imports nothing of the JAX package nor the top-level ``examples``. The
sources are ``test/traj_eval_radial.py:17-72``,
``test/traj_eval_in_track.py:14-66`` and ``test/traj_eval_radialC.py:17-75``.
"""

from __future__ import annotations

import numpy as np

from mpc_arpo_project_tpu_torch.config import (
    SimConditions,
    MPCParams,
    FailsafeParams,
    Noise,
    Debris,
)


def radial_config(noisy: bool = True, T_final: float = 150.0, Nx: int = 40,
                  is_reject: bool = True, is_delta_v: bool = False,
                  T_cont: float = float("nan")):
    """Canonical radial-approach configuration (traj_eval_radial.py)."""
    v_ecr = 50000.0 * np.ones(5)
    v_ecr[-2] *= -1
    v_ecr[-1] = 0.0
    mpc = MPCParams(
        8e2 * np.diag([0.2**2, 10**2, 3.8**2, 900.0]),
        1000**2 * np.eye(2),
        5**2 * np.eye(5),
        v_ecr,
        {"Nx": Nx, "Nc": 5, "Nb": 5},
        (0.2, 0.2),
    )
    fail = FailsafeParams(
        0.005 * np.diag([0.0001, 1, 100000.0, 1.0, 0.01]),
        100 * np.eye(2),
        np.eye(1, 4),
        np.zeros((2, 2)),
    )
    debris = Debris((40.0, 0.0), 5.0, 20.0)
    if np.isfinite(T_cont):
        noise = Noise((0.0012, 0.0012), 50) if noisy else None
    else:
        noise = Noise((0.75, 0.75), 50) if noisy else None
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]),
        np.array([2.5, 0.0, 0.0, 0.0]),
        2.5,
        10 * np.pi / 180,
        1.5,
        1.107e-3,
        0.5,
        is_reject,
        (0.2, 45.0),
        noise,
        False,
        T_cont=T_cont,
        T_final=T_final,
        isDeltaV=is_delta_v,
    )
    return sim, mpc, fail, debris


def in_track_config(T_final: float = 150.0):
    """In-track configuration (traj_eval_in_track.py; u_lim supplied — the
    reference script itself omits the required positional argument)."""
    v_ecr = 50000.0 * np.ones(5)
    v_ecr[-2] *= -1
    v_ecr[-1] = 1e-09
    mpc = MPCParams(
        8e2 * np.diag([0.2**2, 10**2, 3.8**2, 900.0]),
        1000**2 * np.eye(2),
        5**2 * np.diag([1.5, 1.5, 1.0, 1.0, 1e5]),
        v_ecr,
        {"Nx": 40, "Nc": 5, "Nb": 5},
        (0.2, 0.2),
        swap_xy=True,
    )
    fail = FailsafeParams(
        0.005 * np.diag([0.0001, 1, 100000.0, 1.0, 0.01]),
        100 * np.eye(2),
        np.eye(1, 4),
        np.zeros((2, 2)),
    )
    debris = Debris((0.0, 40.0), 5.0, 20.0)
    sim = SimConditions(
        np.array([-10.0, 100.0, 0.0, 0.0]),
        np.array([0.0, 2.5, 0.0, 0.0]),
        2.5,
        10 * np.pi / 180,
        1.5,
        1.107e-3,
        0.5,
        False,
        (0.2, 45.0),
        None,
        True,
        T_final=T_final,
    )
    return sim, mpc, fail, debris
