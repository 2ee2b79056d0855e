"""Port of ``tools/ref_sim.py:168-667``: the NumPy oracle closed-loop
simulator, the port's trajectory ground truth.

A branchy, host-side, float64 replica of the reference's discrete-time
closed loop ``trajectorySimulate`` (``src/trajectorySimulate.py:17-388``)
and of its continuous-time loop ``trajectorySimulateC``
(``src/trajectorySimulateC.py:17-446``), built on the port's QP builder,
its ``OSQPRef`` oracle solver (``tools/osqp_ref.py``) and a NumPy UKF with
filterpy conventions. The code is the JAX package's, unchanged but for the
reference project's paths (given from its root) and the imports:
``discretize_np``, ``synth_gains_np`` and ``configure_dynamic_np`` (the
original's lines 45-166) come from ``ops/host_synthesis.py``, which holds
the port's one copy of them; the config classes from ``config.py``;
``QPDims``, ``build_qp`` and ``materialize_A`` from ``ops/qp_builder.py``;
``R_T`` from ``models/nonlinear.py``. It reproduces the reference's
semantics exactly, including its quirks (documented inline with file:line
citations):

  * one-step input delay: the plant propagates with the *previous* step's
    control (``trajectorySimulate.py:324`` uses ``ctrls[:, i]`` which was
    written at step i-1);
  * sequential 2-norm saturation that recomputes the norm after scaling the
    first component (``:317-319``);
  * the in-track in-place estimate swap side effect of
    ``configureDynamicConstraints`` (``simhelpers.py:72``): the stored
    estimate column is swapped, and the *next* step's failsafe controllers
    read the swapped values;
  * shared integrator state ``xintf`` between the two failsafe controllers,
    reset on MPC success (``:303-313``).

The dynamic-constraint logic is an independent, branch-for-branch
translation of ``simhelpers.py:11-140``: it shares no code with the
branchless ``ops/constraints.py`` nor with any torch path, so tests can
hold them against each other. Host numpy only: used by the oracle tools
(``tools/status_mix.py``'s refsim arm, ``tools/continuous_fullscale.py``,
``tools/deviation_bench.py``) and by tests, never on the card's compute
path. Imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import scipy.linalg

from mpc_arpo_project_tpu_torch.config import (
    SimConditions, MPCParams, FailsafeParams, Debris)
from mpc_arpo_project_tpu_torch.models.nonlinear import R_T
from mpc_arpo_project_tpu_torch.ops.host_synthesis import (
    configure_dynamic_np, discretize_np, synth_gains_np)
from mpc_arpo_project_tpu_torch.ops.qp_builder import (
    QPDims, build_qp, materialize_A)
from mpc_arpo_project_tpu_torch.tools.osqp_ref import OSQPRef


def bounds_np(dims: QPDims, xmin, xmax, umin, umax, is_reject, d_est):
    ny = dims.ny
    lineq = np.concatenate(
        [
            np.kron(np.ones(dims.Nb + 1), xmin),
            np.full((dims.Nx - dims.Nb) * ny, -np.inf),
            np.kron(np.ones(dims.Nc), umin),
            is_reject * d_est,
        ]
    )
    uineq = np.concatenate(
        [
            np.kron(np.ones(dims.Nb + 1), xmax),
            np.full((dims.Nx - dims.Nb) * ny, np.inf),
            np.kron(np.ones(dims.Nc), umax),
            is_reject * d_est,
        ]
    )
    return lineq, uineq


# ----------------------------- NumPy UKF (filterpy conventions) -----------

class UKFNp:
    def __init__(self, Ao, Bou, Q, R, x0, P0, alpha=0.1, beta=2.0, kappa=-1.0):
        self.Ao, self.Bou, self.Q, self.R = Ao, Bou, Q, R
        self.x, self.P = x0.copy(), P0.copy()
        n = 6
        lam = alpha**2 * (n + kappa) - n
        self.lam = lam
        self.Wm = np.full(2 * n + 1, 1.0 / (2 * (n + lam)))
        self.Wc = self.Wm.copy()
        self.Wm[0] = lam / (n + lam)
        self.Wc[0] = lam / (n + lam) + (1 - alpha**2 + beta)

    def _sigmas(self):
        n = 6
        U = scipy.linalg.cholesky((n + self.lam) * self.P)  # upper
        s = np.empty((2 * n + 1, n))
        s[0] = self.x
        for k in range(n):
            s[k + 1] = self.x + U[k]
            s[n + k + 1] = self.x - U[k]
        return s

    def predict(self, u):
        sig = self._sigmas()
        self.sig_f = sig @ self.Ao.T + (self.Bou @ u)[None, :]
        self.x = self.Wm @ self.sig_f
        d = self.sig_f - self.x[None, :]
        self.P = (d * self.Wc[:, None]).T @ d + self.Q

    def update(self, z):
        sig_h = np.stack(
            [
                np.linalg.norm(self.sig_f[:, :2], axis=1),
                np.arctan2(self.sig_f[:, 1], self.sig_f[:, 0]),
            ],
            axis=1,
        )
        zp = self.Wm @ sig_h
        dz = sig_h - zp[None, :]
        S = (dz * self.Wc[:, None]).T @ dz + self.R
        dx = self.sig_f - self.x[None, :]
        Pxz = (dx * self.Wc[:, None]).T @ dz
        K = Pxz @ np.linalg.inv(S)
        self.x = self.x + K @ (z - zp)
        self.P = self.P - K @ S @ K.T


# ----------------------------- closed loop -----------------------------

@dataclass
class OracleRun:
    i_term: int
    success: bool
    x_true: np.ndarray  # (4, nsim+1)
    x_est: np.ndarray  # (6, nsim+1)
    ctrls: np.ndarray  # (2, nsim+1)
    ctrl_seq: np.ndarray  # (nsim,) controller codes, 0 before use
    noise: np.ndarray  # (4, nsim+1)
    statuses: list


def simulate_discrete(
    sim: SimConditions,
    mpc: MPCParams,
    fail: FailsafeParams,
    debris: Optional[Debris],
    noise_draws: Optional[np.ndarray] = None,
    seed: int = 123,
    solver_kwargs: Optional[dict] = None,
):
    """Oracle replica of `trajectorySimulate` (`trajectorySimulate.py:17-388`).

    ``noise_draws``: optional (n_draws, 4) pre-generated standard-normal draws
    (pre-sigma scaling) so the JAX rollout can consume the identical noise.
    """
    solver_kwargs = dict(solver_kwargs or {})
    rng = np.random.RandomState(seed)

    T = sim.time_stp
    nsim = int(sim.T_final / T)
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)
    if sim.noise is not None:
        sig = np.diag([sim.noise.noise_std[0], sim.noise.noise_std[1], 0.0, 0.0])
        noise_rep = int(sim.noise.noise_length)
    else:
        sig = np.zeros((4, 4))
        noise_rep = 1
    n_draws_needed = nsim // noise_rep + 2
    if noise_draws is None:
        noise_draws = rng.normal(0.0, 1.0, size=(n_draws_needed, 4))

    Ad, Bd = discretize_np(sim.mean_mtn, T, sim.isDeltaV)
    K, QN, Kpf, Kif, K_total, K_i = synth_gains_np(Ad, Bd, mpc, fail)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)

    x0 = sim.x0.copy()
    xr = sim.xr
    umin, umax = static.umin, static.umax
    is_reject = float(sim.isReject)

    # initial constraint configuration (`trajectorySimulate.py:234`): fresh
    # temp estimate array, so the in-track swap does not leak into telemetry
    xest_tmp = np.concatenate([x0, [0.0, 0.0]])
    C1, C2, slope, xmin, xmax = configure_dynamic_np(sim, debris, xest_tmp)
    lineq, uineq = bounds_np(dims, xmin, xmax, umin, umax, is_reject, xest_tmp[4:6])
    leq = np.concatenate([-x0, np.zeros(dims.Nx * 4)])
    l = np.concatenate([leq, lineq])
    u = np.concatenate([leq, uineq])
    A = materialize_A(static, C1, C2, -slope)

    prob = OSQPRef(static.P, static.q, A, l, u, **solver_kwargs)

    # observer system (`trajectorySimulate.py:113-118,271-282`)
    Ao = scipy.linalg.block_diag(Ad, np.eye(2))
    Ao[0, 4] = 1.0
    Ao[1, 5] = 1.0
    Bou = np.vstack([Bd, np.zeros((2, 2))])
    Qw = np.zeros((6, 6))
    Qw[:4, :4] = 0.001 * np.eye(4)
    Qw[4, 4] = (T * sig[0, 0]) ** 2
    Qw[5, 5] = (T * sig[1, 1]) ** 2
    P0 = scipy.linalg.block_diag(1e-20 * np.eye(4), np.eye(2))
    kf = UKFNp(Ao, Bou, Qw, np.zeros((2, 2)), np.concatenate([x0, [0.0, 0.0]]), P0)

    if debris is not None:
        center = debris.center
        sideLength = debris.side_length
    else:
        center = (-np.inf, -np.inf)
        sideLength = 0.0

    x_true = np.zeros((4, nsim + 1))
    x_est = np.zeros((6, nsim + 1))
    ctrls = np.zeros((2, nsim + 1))
    noiseStored = np.zeros((4, nsim + 1))
    ctrl_seq = np.zeros(nsim)
    statuses = []
    x_true[:, 0] = x0
    x_est[:, 0] = np.concatenate([x0, [0.0, 0.0]])
    draw_idx = 0
    noiseVec = sig @ noise_draws[draw_idx]
    noiseStored[:, 0] = noiseVec
    xintf = np.zeros(1)
    iterm = nsim

    Crefx = fail.C_int
    Crefy = np.array([[0.0, 1.0, 0.0, 0.0]])
    i0u = (dims.Nx + 1) * 4

    for i in range(nsim):
        # termination (`trajectorySimulate.py:288-293`)
        if not sim.inTrack and (
            np.linalg.norm(x_true[0:2, i]) < sim.r_p or x_true[0, i] < sim.r_p - sim.r_tol
        ):
            iterm = i
            break
        if sim.inTrack and (
            np.linalg.norm(x_true[0:2, i]) < sim.r_p or x_true[1, i] < sim.r_p - sim.r_tol
        ):
            iterm = i
            break

        res = prob.solve()
        statuses.append(res.status)

        if res.status != "solved":
            e = x_est[:, i]  # NOTE: swapped for in-track runs (see module docstring)
            if (
                e[0] - (center[0] + sideLength / 2) < 0
                and e[0] - (center[0] - sideLength / 2) > 0
                and e[1] < center[1] + sideLength / 2
                and e[1] > center[1] - sideLength / 2
            ):
                ctrl_seq[i] = 3  # deadbeat collision avoidance
                xintf = xintf + Crefy @ e[:4] - (center[1] + sideLength / 2)
                ctrl = -K_total @ e[:4] - (K_i @ xintf.reshape(1, 1)).ravel()
            else:
                ctrl_seq[i] = 2  # LQR failsafe homing
                xintf = xintf + Crefx @ e[:4] - xr[0]
                ctrl = -Kpf @ e[:4] - (Kif @ xintf.reshape(-1, 1)).ravel()
        else:
            ctrl_seq[i] = 1  # MPC
            xintf = np.zeros(1)
            ctrl = res.x[i0u : i0u + 2].copy()

        # sequential-saturation quirk (`trajectorySimulate.py:317-319`)
        if np.linalg.norm(ctrl) > umax[0]:
            ctrl[0] = ctrl[0] * (umax[0] / np.linalg.norm(ctrl))
            ctrl[1] = ctrl[1] * (umax[0] / np.linalg.norm(ctrl))

        # plant step with the PREVIOUS control (`:322-325`)
        ctrls[:, i + 1] = ctrl
        x_true[:, i + 1] = Ad @ x_true[:, i] + Bd @ ctrls[:, i] + noiseVec

        # estimation (`:329-337`)
        if sim.noise is not None:
            z = np.array(
                [
                    np.linalg.norm(x_true[:2, i + 1]),
                    math.atan2(x_true[1, i + 1], x_true[0, i + 1]),
                ]
            )
            kf.predict(ctrls[:, i])
            kf.update(z)
            x_est[:, i + 1] = kf.x
        else:
            x_est[:, i + 1] = np.concatenate([x_true[:, i + 1], [0.0, 0.0]])

        # x0-equality update with the fresh (unswapped) estimate (`:340-342`)
        l[:4] = -x_est[:4, i + 1]
        u[:4] = -x_est[:4, i + 1]
        prob.update(l=l, u=u)

        # constraint reconfiguration — swaps x_est[:, i+1] in place for
        # in-track runs, exactly like the reference (`:345-348`)
        C1, C2, slope, xmin, xmax = configure_dynamic_np(sim, debris, x_est[:, i + 1])
        lineq, uineq = bounds_np(
            dims, xmin, xmax, umin, umax, is_reject, x_est[4:6, i + 1]
        )
        l[(dims.Nx + 1) * 4 :] = lineq
        u[(dims.Nx + 1) * 4 :] = uineq
        A = materialize_A(static, C1, C2, -slope)
        prob.update(l=l, u=u, A=A)

        # noise hold/redraw (`:351-356`)
        if (i + 1) % noise_rep == 0:
            draw_idx += 1
            noiseVec = sig @ noise_draws[draw_idx]
        noiseStored[:, i + 1] = noiseVec

    # success scan (`trajectorySimulate.py:370-376`)
    success = False
    for i in range(iterm - 1, 0, -1):
        dist = np.linalg.norm(x_true[0:2, i] - xr[0:2])
        with np.errstate(divide="ignore", invalid="ignore"):
            # numpy semantics: vy/0 -> inf -> 90 deg; 0/0 -> nan -> comparison False
            ang = np.abs(np.arctan(x_true[3, i] / x_true[2, i])) * (180 / np.pi)
        if dist <= sim.suc_cond[0] and ang <= sim.suc_cond[1]:
            success = True
            break

    return OracleRun(
        i_term=iterm,
        success=success,
        x_true=x_true,
        x_est=x_est,
        ctrls=ctrls,
        ctrl_seq=ctrl_seq,
        noise=noiseStored,
        statuses=statuses,
    )


# ----------------------------- continuous-time oracle -----------------------------

def _rk4_np(x, u, n_mean, dt):
    def deriv(x, u):
        mu = (n_mean**2) * (R_T**3)
        px, py, vx, vy = x
        r3 = ((R_T + px) ** 2 + py**2) ** 1.5
        ax = 2 * n_mean * vy + (n_mean**2) * px - mu * (R_T + px) / r3 + mu / (R_T**2) + u[0]
        ay = -2 * n_mean * vx + (n_mean**2) * py - mu * py / r3 + u[1]
        return np.array([vx, vy, ax, ay])

    k1 = deriv(x, u)
    k2 = deriv(x + 0.5 * dt * k1, u)
    k3 = deriv(x + 0.5 * dt * k2, u)
    k4 = deriv(x + dt * k3, u)
    return x + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)


def simulate_continuous(
    sim: SimConditions,
    mpc: MPCParams,
    fail: FailsafeParams,
    debris: Optional[Debris],
    noise_draws: Optional[np.ndarray] = None,
    seed: int = 123,
    solver_kwargs: Optional[dict] = None,
    noise_convention: str = "brownian",
):
    """Oracle replica of `trajectorySimulateC` (`trajectorySimulateC.py:17-446`)
    with fixed-step RK4 in place of per-millisecond adaptive RK45 (equivalence
    of the integrators is covered by test_dynamics.test_rk4_vs_solve_ivp).

    Reference semantics preserved: idle first control period, sample-and-hold
    with one-substep input delay, measurement/UKF one substep after each tick,
    the previous tick's delta-v impulse applied at the tick substep, held
    position noise every substep, UKF Bnoise scale T*(T/T_cont).
    ``noise_convention`` matches rollout.continuous.build_engine.
    """
    solver_kwargs = dict(solver_kwargs or {})
    rng = np.random.RandomState(seed)

    T = sim.time_stp
    T_cont = sim.T_cont
    n_sub = int(round(T / T_cont))
    n_ticks = int(sim.T_final / T)
    n_total = n_ticks * n_sub
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)

    if sim.noise is not None:
        sig_x = sim.noise.noise_std[0]
        noise_rep = int(sim.noise.noise_length)
    else:
        sig_x = 0.0
        noise_rep = 1
    if noise_convention == "brownian":
        sig_cont = sig_x * np.sqrt(T_cont)
    else:
        sig_cont = sig_x / np.sqrt(T_cont)
    noise_int_sub = noise_rep * n_sub
    n_draws = n_total // noise_int_sub + 2
    if noise_draws is None:
        noise_draws = rng.normal(0.0, 1.0, size=(n_draws, 2))

    Ad, Bd = discretize_np(sim.mean_mtn, T, sim.isDeltaV)
    K, QN, Kpf, Kif, K_total, K_i = synth_gains_np(Ad, Bd, mpc, fail)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)

    x0 = sim.x0.copy()
    xr = sim.xr
    umin, umax = static.umin, static.umax
    is_reject = float(sim.isReject)

    xest_tmp = np.concatenate([x0, [0.0, 0.0]])
    C1, C2, slope, xmin, xmax = configure_dynamic_np(sim, debris, xest_tmp)
    lineq, uineq = bounds_np(dims, xmin, xmax, umin, umax, is_reject, xest_tmp[4:6])
    leq = np.concatenate([-x0, np.zeros(dims.Nx * 4)])
    l = np.concatenate([leq, lineq])
    u = np.concatenate([leq, uineq])
    A = materialize_A(static, C1, C2, -slope)

    prob = OSQPRef(static.P, static.q, A, l, u, **solver_kwargs)

    Ao = scipy.linalg.block_diag(Ad, np.eye(2))
    Ao[0, 4] = 1.0
    Ao[1, 5] = 1.0
    Bou = np.vstack([Bd, np.zeros((2, 2))])
    # continuous-sim Bnoise scale (`trajectorySimulateC.py:310-313`)
    Qw = np.zeros((6, 6))
    Qw[:4, :4] = 0.001 * np.eye(4)
    Qw[4, 4] = (T * n_sub * sig_x) ** 2
    Qw[5, 5] = (T * n_sub * (sim.noise.noise_std[1] if sim.noise else 0.0)) ** 2
    P0 = scipy.linalg.block_diag(1e-20 * np.eye(4), np.eye(2))
    kf = UKFNp(Ao, Bou, Qw, np.zeros((2, 2)), np.concatenate([x0, [0.0, 0.0]]), P0)

    if debris is not None:
        center = debris.center
        sideLength = debris.side_length
    else:
        center = (-np.inf, -np.inf)
        sideLength = 0.0

    x_ticks = np.zeros((n_ticks + 1, 4))
    x_est = np.zeros((n_ticks + 1, 6))
    ctrls = np.zeros((n_ticks + 1, 2))
    ctrl_seq = np.zeros(n_ticks, dtype=int)
    statuses = []
    x_ticks[0] = x_ticks[1] = x0
    x_est[0] = x_est[1] = np.concatenate([x0, [0.0, 0.0]])

    x = x0.copy()
    prev_u = np.zeros(2)
    xintf = np.zeros(1)
    iterm_sub = n_total
    succ = False
    alive = True
    Crefx = fail.C_int
    i0u = (dims.Nx + 1) * 4

    for j in range(1, n_ticks):
        alive_at_tick = alive
        res = prob.solve()
        statuses.append(res.status)
        e = x_est[j]  # stored (possibly swapped) estimate from last tick
        if res.status != "solved":
            if (
                e[0] - (center[0] + sideLength / 2) < 0
                and e[0] - (center[0] - sideLength / 2) > 0
                and e[1] < center[1] + sideLength / 2
                and e[1] > center[1] - sideLength / 2
            ):
                code = 3
                xintf = xintf + np.array([e[1]]) - (center[1] + sideLength / 2)
                ctrl = -K_total @ e[:4] - (K_i @ xintf.reshape(1, 1)).ravel()
            else:
                code = 2
                xintf = xintf + Crefx @ e[:4] - xr[0]
                ctrl = -Kpf @ e[:4] - (Kif @ xintf.reshape(-1, 1)).ravel()
        else:
            code = 1
            xintf = np.zeros(1)
            ctrl = res.x[i0u : i0u + 2].copy()

        if np.linalg.norm(ctrl) > umax[0]:
            ctrl[0] = ctrl[0] * (umax[0] / np.linalg.norm(ctrl))
            ctrl[1] = ctrl[1] * (umax[0] / np.linalg.norm(ctrl))

        x_after_first = None
        for k in range(n_sub):
            gi = j * n_sub + k
            if alive:
                pos_norm = np.linalg.norm(x[:2])
                back = x[1] if sim.inTrack else x[0]
                if pos_norm < sim.r_p or back < sim.r_p - sim.r_tol:
                    alive = False
                    iterm_sub = gi
                else:
                    dist_k = np.linalg.norm(x[:2] - xr[:2])
                    with np.errstate(divide="ignore", invalid="ignore"):
                        ang_k = np.abs(np.arctan(x[3] / x[2])) * 180 / np.pi
                    if gi >= 1 and dist_k <= sim.suc_cond[0] and ang_k <= sim.suc_cond[1]:
                        succ = True
            if alive:
                u_now = prev_u if k == 0 else ctrl
                if sim.isDeltaV:
                    x_next = _rk4_np(x, np.zeros(2), sim.mean_mtn, T_cont)
                    if k == 0:
                        x_next[2:] += prev_u
                else:
                    x_next = _rk4_np(x, u_now, sim.mean_mtn, T_cont)
                x_next[:2] += sig_cont * noise_draws[gi // noise_int_sub]
                x = x_next
            if k == 0:
                x_after_first = x.copy()

        # measurement/UKF one substep after the tick, prev tick's control
        if sim.noise is not None:
            z = np.array(
                [np.linalg.norm(x_after_first[:2]),
                 math.atan2(x_after_first[1], x_after_first[0])]
            )
            kf.predict(prev_u)
            kf.update(z)
            est = kf.x.copy()
        else:
            est = np.concatenate([x_after_first, [0.0, 0.0]])

        # control/code recorded with PRE-tick aliveness (matches
        # rollout.continuous: a tick that started before mid-block
        # termination still recorded its control)
        if alive_at_tick:
            ctrls[j + 1] = ctrl
            ctrl_seq[j] = code
        if alive:
            l[:4] = -est[:4]
            u[:4] = -est[:4]
            prob.update(l=l, u=u)
            C1, C2, slope, xmin, xmax = configure_dynamic_np(sim, debris, est)
            lineq, uineq = bounds_np(dims, xmin, xmax, umin, umax, is_reject, est[4:6])
            l[(dims.Nx + 1) * 4 :] = lineq
            u[(dims.Nx + 1) * 4 :] = uineq
            A = materialize_A(static, C1, C2, -slope)
            prob.update(l=l, u=u, A=A)
            x_est[j + 1] = est
            x_ticks[j + 1] = x
            prev_u = ctrl
        else:
            x_est[j + 1] = x_est[j]
            x_ticks[j + 1] = x_ticks[j]

    return dict(
        i_term_sub=iterm_sub,
        success=succ,
        x_ticks=x_ticks,
        x_est=x_est,
        ctrls=ctrls,
        ctrl_seq=ctrl_seq,
        statuses=statuses,
    )
