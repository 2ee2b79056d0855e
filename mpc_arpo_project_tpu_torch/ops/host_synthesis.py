"""Host-side float64 synthesis that ``rollout.discrete.build_engine`` uses.

Copy of ``tools/ref_sim.py:45-166`` (``discretize_np``, ``synth_gains_np``
and ``configure_dynamic_np``, unchanged but for the reference project's
paths, given from its root), kept in the port so that it imports nothing of
the JAX package. numpy and scipy only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg

from mpc_arpo_project_tpu_torch.config import (
    Debris, FailsafeParams, MPCParams, SimConditions)


def discretize_np(n_mean: float, T: float, is_delta_v: bool):
    Ap = np.array(
        [
            [0.0, 0.0, 1.0, 0.0],
            [0.0, 0.0, 0.0, 1.0],
            [3 * n_mean**2, 0.0, 0.0, 2 * n_mean],
            [0.0, 0.0, -2 * n_mean, 0.0],
        ]
    )
    Bp = np.array([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    M = np.zeros((6, 6))
    M[:4, :4] = Ap * T
    M[:4, 4:] = Bp * T
    eM = scipy.linalg.expm(M)
    Ad = eM[:4, :4]
    if is_delta_v:
        Bd = Ad @ np.vstack([np.zeros((2, 2)), np.eye(2)])
    else:
        Bd = eM[:4, 4:]
    return Ad, Bd


def synth_gains_np(Ad, Bd, mpc: MPCParams, fail: FailsafeParams):
    """Virtual-LQR terminal gain + failsafe gains, scipy float64."""
    Q, Ru = mpc.Q_state, mpc.R_input
    S = scipy.linalg.solve_discrete_are(Ad, Bd, Q, Ru)
    K = np.linalg.solve(Ru + Bd.T @ S @ Bd, Bd.T @ S @ Ad)
    # integral-action LQR (python-control convention, `trajectorySimulate.py:185-187`)
    C = fail.C_int
    nr = C.shape[0]
    A_aug = np.block([[Ad, np.zeros((4, nr))], [C, np.eye(nr)]])
    B_aug = np.vstack([Bd, np.zeros((nr, 2))])
    Xf = scipy.linalg.solve_discrete_are(A_aug, B_aug, fail.Q_fail, fail.R_fail)
    Kf = np.linalg.solve(fail.R_fail + B_aug.T @ Xf @ B_aug, B_aug.T @ Xf @ A_aug)
    Kpf, Kif = Kf[:, :4], Kf[:, 4:]
    # deadbeat debris avoidance (`trajectorySimulate.py:189-203`)
    Ad_p = Ad[np.ix_([1, 3], [1, 3])]
    Bd_p = Bd[[1, 3], 1].reshape(2, 1)
    A_a = np.block([[Ad_p, np.zeros((2, 1))], [np.array([[1.0, 0.0]]), np.eye(1)]])
    B_a = np.vstack([Bd_p, np.zeros((1, 1))])
    ctrb = np.hstack([B_a, A_a @ B_a, A_a @ A_a @ B_a])
    K_prune = (np.linalg.solve(ctrb.T, np.array([0.0, 0.0, 1.0])) @
               np.linalg.matrix_power(A_a, 3)).reshape(1, 3)
    K_total = np.zeros((2, 4))
    K_total[1, 1] = K_prune[0, 0]
    K_total[1, 3] = K_prune[0, 1]
    K_i = np.array([[0.0], [K_prune[0, 2]]])
    return K, S, Kpf, Kif, K_total, K_i


def configure_dynamic_np(sim: SimConditions, debris: Optional[Debris], xest):
    """Branch-for-branch translation of `simhelpers.py:11-140`.

    Mutates ``xest`` in place for in-track runs exactly like the reference
    (the x/y swap at `simhelpers.py:72`). Returns (c1, c2, slope, xmin, xmax).
    """
    rp = sim.r_p
    rx, ry = sim.xr[0], sim.xr[1]
    if debris is not None:
        sqVerts = debris.constructVertArr()
        if sim.inTrack:
            sqVerts = sqVerts[[1, 2, 3, 0], :]
        center = list(debris.center)
        sideLength = debris.side_length
        hasDebris = True
        detect_dist = debris.detect_distance
    else:
        center = [-np.inf, -np.inf]
        sideLength = 0.0
        hasDebris = False
        detect_dist = np.inf

    C1 = (-1, 1)[bool(xest[2] >= 0)]
    C2 = (-1, 1)[bool(xest[3] >= 0)]

    if sim.inTrack:
        xestCalc = np.copy(xest)
        xest[0], xest[1] = xest[1], xest[0]
        center[0], center[1] = center[1], center[0]
    else:
        xestCalc = xest

    inter = 0.0
    if xest[1] >= 0:
        if xest[0] - (center[0] + sideLength / 2) < 0 and xest[0] - (center[0] - sideLength / 2) > 0:
            slope = (xestCalc[1] - sqVerts[1, 1]) / (xestCalc[0] - sqVerts[1, 0])
            inter = -slope * xestCalc[0] + xestCalc[1]
        elif hasDebris:
            slope = (xestCalc[1] - sqVerts[0, 1]) / (xestCalc[0] - sqVerts[0, 0])
            inter = -slope * xestCalc[0] + xestCalc[1]
        else:
            slope = 0.0
    else:
        if xest[0] - (center[0] + sideLength / 2) < 0 and xest[0] - (center[0] - sideLength / 2) > 0:
            slope = (xestCalc[1] - sqVerts[2, 1]) / (xestCalc[0] - sqVerts[2, 0])
            inter = -slope * xestCalc[0] + xestCalc[1]
        elif hasDebris:
            slope = (xestCalc[1] - sqVerts[3, 1]) / (xestCalc[0] - sqVerts[3, 0])
            inter = -slope * xestCalc[0] + xestCalc[1]
        else:
            slope = 0.0

    l1b = abs(xestCalc[0] - rx) + abs(xestCalc[1] - ry)
    if xest[1] >= 0:
        if xest[0] - (center[0] + sideLength / 2) < 0 and xest[0] - (center[0] - sideLength / 2) > 0:
            xmin = np.array([1.0, 1.0, rp, 0.0, inter])
        elif 0 < xest[0] - (center[0] + sideLength / 2) < detect_dist:
            xmin = np.array([1.0, 1.0, rp, 0.0, inter])
        else:
            xmin = np.array([1.0, 1.0, rp, 0.0, -np.inf])
        xmax = np.array([np.inf, np.inf, np.inf, l1b, np.inf])
    else:
        if xest[0] - (center[0] + sideLength / 2) < 0 and xest[0] - (center[0] - sideLength / 2) > 0:
            xmax = np.array([np.inf, np.inf, np.inf, l1b, inter])
        elif 0 < xest[0] - (center[0] + sideLength / 2) < detect_dist:
            xmax = np.array([np.inf, np.inf, np.inf, l1b, inter])
        else:
            xmax = np.array([np.inf, np.inf, np.inf, l1b, np.inf])
        xmin = np.array([1.0, 1.0, rp, 0.0, -np.inf])

    return C1, C2, slope, xmin, xmax
