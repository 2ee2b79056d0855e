"""The ADMM solve's stopping rule, as the plain reference judges it, and the
precision control's own ADMM.

The program solves each step's QP

    minimise 1/2 x'Px + q'x   subject to   l <= Ax <= u

by OSQP's ADMM on the problem equilibrated by Ruiz's method (``D``, ``E``,
``c``), and carries its last iterate, scaled, into the next step. A solve it
reports SOLVED has met its stopping rule: with ``w`` 1 on every row but the
debris row, which the program weighs by ``alpha = min(1, smax / |s|)``,

    ||w (Ax - z)||      <= eps_abs + eps_rel max(||w Ax||, ||w z||)
    ||Px + q + A'y||    <= eps_abs + eps_rel max(||Px||, ||A'y||, ||q||)

(infinity norms, unscaled x, y, z). ``ratios`` works both out in float64
from the reference's own QP and its own equilibration, with ``z``'s
distance from [l, u] counted as primal residual too, and returns each as a
multiple of its tolerance: at most 1 on a sound SOLVED answer, above 1 on a
MAX_ITER one.

``control_solve`` is the precision control's solve: the same ADMM (the
program's stated settings, adaptive rho, no stall exits) from a cold start,
its matrix products in TF32 and its vectors in float32 (the step a
tensor-core ``eig_chunk`` would take), claiming SOLVED where its own
residuals, in that arithmetic, meet the rule. numpy only.

``ruiz`` and the constants are a frozen copy of
``mpc_arpo_project_tpu_torch/ops/admm.py:47-51, 60-84, 192-220`` (the
settings' defaults, ``_ruiz``); the equilibration is worked out on the QP at
the configuration's initial state, as the program's engine does
(``rollout/discrete.py:145-154``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from arpobench.reference import qp_build
from arpobench.reference.precision import CONTROL, Precision

MIN_SCALING, MAX_SCALING = 1e-4, 1e4
RHO_MIN, RHO_MAX, RHO_EQ_SCALE = 1e-6, 1e6, 1e3
SOLVED, MAX_ITER = 1, 2
# the program's defaults of the settings the solve states
DEFAULTS = dict(sigma=1e-6, alpha=1.6, rho_bar=0.1, eps_abs=1e-3,
                eps_rel=1e-3, max_iter=4000, check_every=25,
                scaling_iters=10, adaptive_rho=True,
                adaptive_rho_interval=50, adaptive_rho_tol=5.0,
                stall_exit_chunks=0, eig_deb_equil_smax=32.0)


class Scaling(NamedTuple):
    D: np.ndarray  # (nz,)
    E: np.ndarray  # (m,)
    c: float


def settings(cfg: dict) -> dict:
    """The solve's settings: the configuration's, else the defaults."""
    return {k: cfg["solver"].get(k, v) for k, v in DEFAULTS.items()}


def ruiz(P, q, A, iters):
    n = P.shape[0]
    D = np.ones(n)
    E = np.ones(A.shape[0])
    c = 1.0
    Ps, As, qs = P.copy(), A.copy(), q.copy()
    for _ in range(iters):
        norm_cols_n = np.maximum(np.abs(Ps).max(axis=0, initial=0.0),
                                 np.abs(As).max(axis=0, initial=0.0))
        norm_cols_m = np.abs(As).max(axis=1, initial=0.0)
        norms = np.clip(np.concatenate([norm_cols_n, norm_cols_m]),
                        MIN_SCALING, MAX_SCALING)
        delta = 1.0 / np.sqrt(norms)
        dn, dm = delta[:n], delta[n:]
        Ps = Ps * dn[:, None] * dn[None, :]
        As = As * dm[:, None] * dn[None, :]
        qs = qs * dn
        D *= dn
        E *= dm
        norm_P_cols = np.abs(Ps).max(axis=0, initial=0.0)
        gamma = 1.0 / max(
            np.clip(max(norm_P_cols.mean(), np.abs(qs).max(initial=0.0)),
                    MIN_SCALING, MAX_SCALING),
            MIN_SCALING,
        )
        Ps *= gamma
        qs *= gamma
        c *= gamma
    return Ps, qs, As, D, E, c


def scaling(sc, qp_bounds, solve: dict) -> Scaling:
    """The equilibration of the QP at the initial state (``qp_bounds`` is
    ``model.qp_bounds``)."""
    x0 = np.concatenate([sc.x0, [0.0, 0.0]])[None]
    c1, c2, s, _, _ = qp_bounds(sc, x0)
    A = qp_build.materialize_A(sc.qp, c1[0], c2[0], s[0])
    *_, D, E, c = ruiz(sc.qp.P, sc.qp.q, A, solve["scaling_iters"])
    return Scaling(D, E, float(c))


def deb_weight(sc, s, solve: dict, m: int):
    """(R, m) row weights: ``alpha`` on the debris rows, 1 elsewhere."""
    smax = float(solve["eig_deb_equil_smax"])
    sa = np.abs(s)
    alpha = np.ones_like(sa)
    if smax > 0:
        big = np.isfinite(s) & (sa > smax)
        alpha[big] = smax / sa[big]
    w = np.ones((len(s), m))
    w[:, sc.qp.deb_rows] = alpha[:, None]
    return w


def A_times(sc, c1, c2, s, x):
    """(R, m): each sample's A x, A built from (c1, c2, s)."""
    st = sc.qp
    Ax = x @ st.A0.T
    Ax[:, st.fun_rows] += (c1[:, None] * x[:, st.velx_cols]
                           + c2[:, None] * x[:, st.vely_cols])
    Ax[:, st.deb_rows] += s[:, None] * x[:, st.posx_cols]
    return Ax


def AT_times(sc, c1, c2, s, y):
    """(R, nz): each sample's A'y."""
    st = sc.qp
    Aty = y @ st.A0
    fy, dy = y[:, st.fun_rows], y[:, st.deb_rows]
    Aty[:, st.velx_cols] += c1[:, None] * fy
    Aty[:, st.vely_cols] += c2[:, None] * fy
    Aty[:, st.posx_cols] += s[:, None] * dy
    return Aty


def unscale(sc, scal: Scaling, xbar, ybar, zbar):
    """Unscaled (x, y, z) of scaled iterates (padding dropped)."""
    nz, m = sc.dims.nz, sc.dims.m
    D, E, c = scal
    return (D * xbar[:, :nz], E * ybar[:, :m] / c, zbar[:, :m] / E)


def ratios(sc, solve: dict, c1, c2, s, lo, hi, x, y, z):
    """(primal, dual): each sample's residual as a multiple of the stopping
    rule's tolerance, in float64; see the module's docstring."""
    x, y, z = (np.asarray(a, float) for a in (x, y, z))
    st = sc.qp
    w = deb_weight(sc, s, solve, sc.dims.m)
    Ax = A_times(sc, c1, c2, s, x)
    with np.errstate(invalid="ignore"):
        out = np.maximum(np.where(np.isfinite(lo), lo - z, 0.0),
                         np.where(np.isfinite(hi), z - hi, 0.0))
    rp = np.maximum(np.abs(w * (Ax - z)).max(1),
                    (w * np.maximum(out, 0.0)).max(1))
    rp_rel = np.maximum(np.abs(w * Ax).max(1), np.abs(w * z).max(1))
    Px = x @ st.P
    Aty = AT_times(sc, c1, c2, s, y)
    rd = np.abs(Px + st.q + Aty).max(1)
    rd_rel = np.maximum(np.maximum(np.abs(Px).max(1), np.abs(Aty).max(1)),
                        np.abs(st.q).max())
    ea, er = solve["eps_abs"], solve["eps_rel"]
    return rp / (ea + er * rp_rel), rd / (ea + er * rd_rel)


def control_solve(sc, scal: Scaling, solve: dict, c1, c2, s, lo, hi,
                  prec: Precision = CONTROL):
    """The precision control's ADMM on each sample's QP: unscaled (x, y, z),
    its status (SOLVED where its own check met the rule, else MAX_ITER) and
    its iterations. Its matrices are held as ``prec.held`` rounds them (TF32),
    its vectors in float32; the KKT systems are solved exactly on the held
    matrices, so that the gap to the rule is the held matrices'."""
    st, dims = sc.qp, sc.dims
    nz, m, R = dims.nz, dims.m, len(c1)
    f32 = np.float32
    D, E, cst = scal
    w = deb_weight(sc, s, solve, m)
    # the equilibrated QPs, the debris row weighted as the program does
    A = np.repeat(st.A0[None], R, 0)
    r = np.arange(R)[:, None]
    A[r, st.fun_rows[None], st.velx_cols[None]] = c1[:, None]
    A[r, st.fun_rows[None], st.vely_cols[None]] = c2[:, None]
    A[r, st.deb_rows[None], st.posx_cols[None]] = s[:, None]
    Ab = prec.held((w * E)[:, :, None] * A * D[None, None, :])
    Pb = prec.held(cst * st.P * D[:, None] * D[None, :])
    qb = (cst * D * st.q).astype(f32)
    lb, ub = (w * E * lo).astype(f32), (w * E * hi).astype(f32)
    AbT = np.ascontiguousarray(Ab.transpose(0, 2, 1))
    einv = (1.0 / (w * E)).astype(f32)
    dq = (1.0 / (D * cst)).astype(f32)
    rho0 = np.full(m, solve["rho_bar"])
    rho0[st.eq_mask] = solve["rho_bar"] * RHO_EQ_SCALE
    rho0 = np.clip(rho0, RHO_MIN, RHO_MAX)
    rho_lo = RHO_MIN / solve["rho_bar"]
    rho_hi = RHO_MAX / (solve["rho_bar"] * RHO_EQ_SCALE)
    sigma, alpha = solve["sigma"], f32(solve["alpha"])
    ea, er = solve["eps_abs"], solve["eps_rel"]
    mv = lambda M, v: np.matmul(M, v[:, :, None])[:, :, 0]
    Ab64 = Ab.astype(np.float64)
    G = np.matmul(Ab64.transpose(0, 2, 1) * rho0[None, None, :], Ab64)
    PI = Pb.astype(np.float64) + sigma * np.eye(nz)

    def factor(scale, rows):
        """The inverse KKT matrices of ``rows`` at their rho scales."""
        return np.linalg.inv(PI[None] + scale[rows, None, None] * G[rows])

    scale = np.ones(R)
    Kinv = factor(scale, np.arange(R))
    x = np.zeros((R, nz), f32)
    y = np.zeros((R, m), f32)
    z = np.zeros((R, m), f32)
    done = np.zeros(R, bool)
    status = np.full(R, MAX_ITER)
    iters = np.full(R, int(solve["max_iter"]))
    every = int(solve["check_every"])
    stride = max(1, int(solve["adaptive_rho_interval"]) // every)
    amax = lambda a: np.abs(a).max(1)
    for it in range(1, int(solve["max_iter"]) + 1):
        rho = (scale[:, None] * rho0[None]).astype(f32)
        rhs = sigma * x - qb[None] + mv(AbT, rho * z - y)
        xt = mv(Kinv, rhs.astype(np.float64)).astype(f32)
        zt = mv(Ab, xt)
        zr = alpha * zt + (1 - alpha) * z
        zn = np.clip(zr + y / rho, lb, ub)
        keep = done[:, None]
        x = np.where(keep, x, alpha * xt + (1 - alpha) * x)
        y = np.where(keep, y, y + rho * (zr - zn))
        z = np.where(keep, z, zn)
        if it % every:
            continue
        Ax, Px, Aty = mv(Ab, x), x @ Pb, mv(AbT, y)
        rp = amax(einv * (Ax - z))
        rp_rel = np.maximum(amax(einv * Ax), amax(einv * z))
        rd = amax(dq * (Px + qb + Aty))
        rd_rel = np.maximum(np.maximum(amax(dq * Px), amax(dq * Aty)),
                            amax(dq * qb[None]))
        conv = (~done & (rp <= ea + er * rp_rel) & (rd <= ea + er * rd_rel))
        status[conv] = SOLVED
        iters[conv] = it
        done |= conv
        if done.all():
            break
        if solve["adaptive_rho"] and (it // every) % stride == 0:
            with np.errstate(divide="ignore", invalid="ignore"):
                ratio = np.sqrt((rp / np.maximum(rp_rel, 1e-10))
                                / np.maximum(rd / np.maximum(rd_rel, 1e-10),
                                             1e-10))
            tol = solve["adaptive_rho_tol"]
            trig = (~done & np.isfinite(ratio)
                    & ((ratio > tol) | (ratio < 1.0 / tol)))
            if trig.any():
                scale = np.where(trig, np.clip(scale * ratio, rho_lo, rho_hi),
                                 scale)
                Kinv[trig] = factor(scale, trig)
    # leave the equilibrated, weighted problem
    return D * x, (w * E) * y / cst, z / (w * E), status, iters
