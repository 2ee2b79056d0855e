"""Nonlinear planar two-body relative dynamics and a fixed-step RK4 step.

Counterpart of ``mpc_arpo_project_tpu/models/nonlinear.py`` (its choice of
fixed-step RK4 at the reference's 1 ms substep is documented there), on
tensors of shape (..., 4). The expressions keep the JAX package's order and
type promotion: the Python float constants meet the tensor's dtype at each
operation, ``** 1.5`` stays a power, and in float32 the gravity term
``mu (R_T + px) / r3 - mu / R_T**2`` cancels to a few significant digits
exactly as it does there.
"""

from __future__ import annotations

import torch

# Orbit constants of the reference (500 km altitude)
ALT = 500e3
RE = 6378.1e3
R_T = ALT + RE


def two_body_deriv(x, u, n):
    """State derivative of the planar two-body relative dynamics in the
    rotating LVLH frame of a circular target orbit of mean motion ``n`` (a
    0-dim tensor of the state's dtype). Shapes: x (..., 4), u (..., 2) ->
    (..., 4)."""
    mu = (n ** 2) * (R_T ** 3)
    px, py, vx, vy = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    r3 = ((R_T + px) ** 2 + py ** 2) ** 1.5
    ax = 2 * n * vy + (n ** 2) * px - mu * (R_T + px) / r3 + mu / (R_T ** 2) + u[..., 0]
    ay = -2 * n * vx + (n ** 2) * py - mu * py / r3 + u[..., 1]
    return torch.stack([vx, vy, ax, ay], dim=-1)


def rk4_step(x, u, n, dt):
    """One classic RK4 step of the plant with the input held; ``n`` and
    ``dt`` are 0-dim tensors of the state's dtype."""
    k1 = two_body_deriv(x, u, n)
    k2 = two_body_deriv(x + 0.5 * dt * k1, u, n)
    k3 = two_body_deriv(x + 0.5 * dt * k2, u, n)
    k4 = two_body_deriv(x + dt * k3, u, n)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
