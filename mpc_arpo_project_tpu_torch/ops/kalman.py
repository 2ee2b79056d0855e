"""Steady-state Kalman filter: the linear-measurement estimator variant.

Counterpart of ``mpc_arpo_project_tpu/ops/kalman.py`` (its origin in the
reference's prototypes is documented there): the gain from the filter DARE,
solved as the control DARE of the dual system, and the fixed-gain
predict-correct step, batched over scenarios.
"""

from __future__ import annotations

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.ops.riccati import solve_dare


# Copy of mpc_arpo_project_tpu/ops/kalman.py:20-32 (steady_state_gain_np),
# unchanged: numpy and scipy only.
def steady_state_gain_np(A, C, W, V):
    """Float64 host-side twin of :func:`steady_state_gain` (scipy DARE) —
    used by ``rollout.discrete.build_engine(estimator='kf')`` so the gain is
    synthesized in fp64 regardless of the rollout dtype, exactly like the
    controller gains (the reference prototype synthesizes in float64,
    `misc/MPCrendezvousKALMANONLY.py:62-63`)."""
    import scipy.linalg as sla

    P = sla.solve_discrete_are(np.asarray(A).T, np.asarray(C).T,
                               np.asarray(W), np.asarray(V))
    S = C @ P @ C.T + V
    L = P @ C.T @ np.linalg.inv(S)
    return L, P


def steady_state_gain(A, C, W, V, iters: int = 30):
    """Steady-state gain L for x+ = A x + w, y = C x + v, on tensors:
    P = dare(A', C', W, V), L = P C' (C P C' + V)^{-1}. Returns (L, P)."""
    P = solve_dare(A.T, C.T, W, V, iters=iters)
    S = C @ P @ C.T + V
    return P @ C.T @ torch.linalg.inv(S), P


def kf_step(x, u, z, A, B, C, L):
    """One fixed-gain update of a batch: x (n_b, nx), u (n_b, nu), z
    (n_b, ny); predict x A' + u B', then correct by (z - C x_pred) L'."""
    x_pred = x @ A.T + u @ B.T
    return x_pred + (z - x_pred @ C.T) @ L.T
