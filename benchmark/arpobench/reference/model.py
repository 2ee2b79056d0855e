"""The plain reference of one closed-loop step, in float64 numpy.

Written from the reference project's semantics, independently of the
program: nothing here imports the port, the JAX package or torch, and
nothing takes a matrix the program made. ``Scenario`` works out from a
configuration file (``benchmark/configs/<name>.json``) what the program's
engine derives: the discretised CW plant, the terminal LQR gain, the failsafe
and deadbeat gains, the dense QP and the debris geometry. The functions below
it are the parts of one control step, each vectorised over rows (scenarios):

* ``qp_bounds``: the three dynamic constraint coefficients and the bound
  vectors of the QP a scenario solves, from its state estimate
  (`simhelpers.py:11-140`);
* ``failsafe``: the controller a scenario falls back to when the QP is not
  SOLVED (integral LQR, or the deadbeat law inside the debris box), and the
  integrator it carries (`trajectorySimulate.py:250-300`);
* ``saturate``: the sequential saturation of the applied control;
* ``cw_step`` and ``two_body_tick``: the plant (the discrete CW model, or the
  nonlinear two-body model by RK4 substeps with sample-and-hold);
* ``ukf_step``: the unscented filter of the offset-free disturbance
  observer (Merwe sigma points, range/bearing measurement, filterpy's
  conventions).

Each takes ``prec``, the arithmetic (``arpobench.reference.precision``):
float64 for the reference, and the precision control's for the control.
The solve's stopping rule and equilibration are ``arpobench.reference.admm``'s.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import scipy.linalg

from arpobench.reference import admm, qp_build
from arpobench.reference.precision import FLOAT64, Precision

# the target orbit of the reference (500 km altitude), for the two-body plant
ALT = 500e3
RE = 6378.1e3
R_T = ALT + RE

# Merwe sigma-point parameters of the reference's UKF (alpha, beta, kappa)
UKF_ALPHA, UKF_BETA, UKF_KAPPA = 0.1, 2.0, -1.0


class _Sim(NamedTuple):
    """The fields of the reference's ``SimConditions`` that the QP builder
    reads by attribute."""

    x0: np.ndarray
    xr: np.ndarray
    r_p: float
    los_ang: float
    r_tol: float
    inTrack: bool
    hatch_ofst: float


class _Mpc(NamedTuple):
    Q_state: np.ndarray
    R_input: np.ndarray
    R_slack: np.ndarray
    V_ecr: np.ndarray
    u_lim: tuple


def discretize(n: float, T: float, delta_v: bool):
    """Zero-order-hold discretisation of the CW equations (Ad, Bd)."""
    A = np.array([[0.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 1.0],
                  [3 * n * n, 0.0, 0.0, 2 * n], [0.0, 0.0, -2 * n, 0.0]])
    Bc = np.vstack([np.zeros((2, 2)), np.eye(2)])
    M = np.zeros((6, 6))
    M[:4, :4], M[:4, 4:] = A * T, Bc * T
    E = scipy.linalg.expm(M)
    Ad = E[:4, :4]
    Bd = Ad @ Bc if delta_v else E[:4, 4:]
    return Ad, Bd


def dlqr(A, B, Q, R):
    """Discrete LQR: (K, S) with u = -K x and S the Riccati solution."""
    S = scipy.linalg.solve_discrete_are(A, B, Q, R)
    return np.linalg.solve(R + B.T @ S @ B, B.T @ S @ A), S


class Scenario:
    """What one configuration fixes, worked out in float64."""

    def __init__(self, cfg: dict):
        s, m, f, d = cfg["sim"], cfg["mpc"], cfg["failsafe"], cfg["debris"]
        self.loop = cfg["loop"]
        self.T = float(s["time_stp"])
        self.n = float(s["mean_mtn"])
        self.in_track = bool(s["inTrack"])
        self.delta_v = bool(s["isDeltaV"])
        self.is_reject = float(bool(s["isReject"]))
        self.x0 = np.asarray(s["x0"], float)
        self.xr = np.asarray(s["xr"], float)
        self.rp, self.rtol = float(s["r_p"]), float(s["r_tol"])
        self.dist_tol, self.ang_tol = (float(v) for v in s["suc_cond"])
        self.sig = np.asarray(s["noise_std"], float)
        self.hold = int(s["noise_length"])
        hz = m["horizons"]
        self.dims = qp_build.QPDims(Nx=hz["Nx"], Nc=hz["Nc"], Nb=hz["Nb"])
        self.umax = float(m["u_lim"][0])

        self.Ad, self.Bd = discretize(self.n, self.T, self.delta_v)
        Q, R = np.diag(m["Q_state_diag"]), np.diag(m["R_input_diag"])
        K, QN = dlqr(self.Ad, self.Bd, Q, R)

        # failsafe: integral LQR on the x position (python-control's
        # convention, `trajectorySimulate.py:185-187`)
        C = np.asarray(f["C_int"], float)
        nr = C.shape[0]
        A_aug = np.block([[self.Ad, np.zeros((4, nr))], [C, np.eye(nr)]])
        B_aug = np.vstack([self.Bd, np.zeros((nr, 2))])
        Kf, _ = dlqr(A_aug, B_aug, np.diag(f["Q_fail_diag"]),
                     np.diag(f["R_fail_diag"]))
        self.Kpf, self.Kif = Kf[:, :4], Kf[:, 4]
        self.C_int = C[0]

        # deadbeat debris escape on the (y, vy) pair with an integrator,
        # by Ackermann's formula (`trajectorySimulate.py:189-203`)
        Ap = self.Ad[np.ix_([1, 3], [1, 3])]
        Bp = self.Bd[[1, 3], 1].reshape(2, 1)
        Aa = np.block([[Ap, np.zeros((2, 1))], [np.array([[1.0, 0.0, 1.0]])]])
        Ba = np.vstack([Bp, np.zeros((1, 1))])
        ctrb = np.hstack([Ba, Aa @ Ba, Aa @ Aa @ Ba])
        kp = np.linalg.solve(ctrb.T, np.array([0.0, 0.0, 1.0])) @ \
            np.linalg.matrix_power(Aa, 3)
        self.K_db = np.zeros((2, 4))
        self.K_db[1, 1], self.K_db[1, 3] = kp[0], kp[1]
        self.Ki_db = np.array([0.0, kp[2]])

        sim = _Sim(self.x0, self.xr, self.rp, float(s["los_ang"]), self.rtol,
                   self.in_track, math.pi / 2 if self.in_track else 0.0)
        mpc = _Mpc(Q, R, np.diag(m["R_slack_diag"]),
                   np.asarray(m["V_ecr"], float), tuple(m["u_lim"]))
        self.qp = qp_build.build_qp(self.dims, sim, mpc, self.Ad, self.Bd, K,
                                    QN)

        self.center = np.asarray(d["center"], float)
        self.half = float(d["side_length"]) / 2.0
        self.detect = float(d["detect_distance"])
        cx, cy, h = self.center[0], self.center[1], self.half
        verts = np.array([[cx + h, cy + h], [cx - h, cy + h],
                          [cx - h, cy - h], [cx + h, cy - h]])
        self.verts = verts[[1, 2, 3, 0]] if self.in_track else verts

        # the UKF's process model and noise
        self.Ao = np.zeros((6, 6))
        self.Ao[:4, :4], self.Ao[4:, 4:] = self.Ad, np.eye(2)
        self.Ao[0, 4] = self.Ao[1, 5] = 1.0
        self.Bo = np.vstack([self.Bd, np.zeros((2, 2))])
        self.Qw = np.zeros((6, 6))
        self.Qw[:4, :4] = 0.001 * np.eye(4)
        if self.loop == "continuous":
            self.T_cont = float(s["T_cont"])
            self.n_sub = int(round(self.T / self.T_cont))
            self.noise_int_sub = self.hold * self.n_sub
            self.sig_cont = self.sig[0] * math.sqrt(self.T_cont)
            noise_scale = self.T * self.n_sub
        else:
            noise_scale = self.T
        self.Qw[4, 4] = (noise_scale * self.sig[0]) ** 2
        self.Qw[5, 5] = (noise_scale * self.sig[1]) ** 2
        self.d_scale = noise_scale * float(self.sig.max())

        # the solve's stated settings and the equilibration they give
        self.solve = admm.settings(cfg)
        self.scaling = admm.scaling(self, qp_bounds, self.solve)

    # ---- initial state of a batch
    def initial(self, rows: int) -> dict:
        """The state entering the first step of a batch, for ``rows``
        scenarios (all alive)."""
        P0 = np.zeros((6, 6))
        P0[:4, :4] = 1e-20 * np.eye(4)
        P0[4:, 4:] = np.eye(2)
        xest = np.concatenate([self.x0, [0.0, 0.0]])
        return dict(x=np.tile(self.x0, (rows, 1)), xest=np.tile(xest, (rows, 1)),
                    P=np.tile(P0, (rows, 1, 1)), xintf=np.zeros(rows),
                    prev_u=np.zeros((rows, 2)))


def qp_bounds(sc: Scenario, xest, prec: Precision = FLOAT64):
    """(c1, c2, s, l, u) of the QPs built from the (R, 6) estimates
    ``xest`` [x, y, vx, vy, dx, dy]: the velocity-funnel signs, the debris
    row's coefficient and the full (R, m) bound vectors."""
    ew = prec.ew
    xest = prec.cast(xest)
    R = xest.shape[0]
    dims = sc.dims
    c1 = np.where(xest[:, 2] >= 0, 1.0, -1.0)
    c2 = np.where(xest[:, 3] >= 0, 1.0, -1.0)
    if sc.in_track:
        e0, e1, ctr0 = xest[:, 1], xest[:, 0], sc.center[1]
    else:
        e0, e1, ctr0 = xest[:, 0], xest[:, 1], sc.center[0]
    px, py = xest[:, 0], xest[:, 1]
    inside = ((e0 - (ctr0 + sc.half)) < 0) & ((e0 - (ctr0 - sc.half)) > 0)
    above = e1 >= 0
    vi = np.where(above, np.where(inside, 1, 0), np.where(inside, 2, 3))
    v = sc.verts[vi]
    with np.errstate(divide="ignore", invalid="ignore"):
        slope = ew((py - v[:, 1]) / (px - v[:, 0]))
    inter = ew(-slope * px + py)
    approach = e0 - (ctr0 + sc.half)
    active = inside | ((approach > 0) & (approach < sc.detect))
    l1 = ew(np.abs(px - sc.xr[0]) + np.abs(py - sc.xr[1]))
    inf = np.full(R, np.inf)
    xmin = np.stack([np.ones(R), np.ones(R), np.full(R, sc.rp), np.zeros(R),
                     np.where(above & active, inter, -inf)], 1)
    xmax = np.stack([inf, inf, inf, l1, np.where(~above & active, inter, inf)],
                    1)
    n_free = (dims.Nx - dims.Nb) * dims.ny
    eq = np.concatenate([-xest[:, :4], np.zeros((R, dims.n_eq - 4))], 1)
    d_eq = ew(sc.is_reject * xest[:, 4:6])
    umin = np.tile(sc.qp.umin, dims.Nc)
    umax = np.tile(sc.qp.umax, dims.Nc)
    lo = np.concatenate([eq, np.tile(xmin, dims.Nb + 1), np.full((R, n_free),
                         -np.inf), np.tile(umin, (R, 1)), d_eq], 1)
    hi = np.concatenate([eq, np.tile(xmax, dims.Nb + 1), np.full((R, n_free),
                         np.inf), np.tile(umax, (R, 1)), d_eq], 1)
    return c1, c2, -slope, lo, hi


def in_debris_box(sc: Scenario, e):
    """Whether each stored estimate ``e`` (R, 6) lies inside the debris
    box, the deadbeat law's domain."""
    cx, cy, h = sc.center[0], sc.center[1], sc.half
    return ((e[:, 0] - (cx + h) < 0) & (e[:, 0] - (cx - h) > 0)
            & (e[:, 1] < cy + h) & (e[:, 1] > cy - h))


def failsafe(sc: Scenario, e, xintf, prec: Precision = FLOAT64):
    """(u, xintf_new, code) of the fallback controller from the stored
    estimate ``e`` (R, 6) and the integrator ``xintf`` (R,): the deadbeat law
    (code 3) inside the debris box, else the integral LQR (code 2)."""
    e, xintf = prec.cast(e), prec.cast(xintf)
    box = in_debris_box(sc, e)
    cy, h = sc.center[1], sc.half
    xi_db = prec.ew(xintf + e[:, 1] - (cy + h))
    u_db = prec.ew(-prec.mm(e[:, :4], sc.K_db.T)
                   - xi_db[:, None] * sc.Ki_db[None, :])
    xi_fs = prec.ew(xintf + prec.mm(e[:, :4], sc.C_int) - sc.xr[0])
    u_fs = prec.ew(-prec.mm(e[:, :4], sc.Kpf.T)
                   - xi_fs[:, None] * sc.Kif[None, :])
    return (np.where(box[:, None], u_db, u_fs), np.where(box, xi_db, xi_fs),
            np.where(box, 3, 2))


def saturate(sc: Scenario, u, prec: Precision = FLOAT64):
    """The reference's sequential saturation: the first component is scaled
    by the norm of the pair, the second by the norm of the pair with the
    first already scaled."""
    u = prec.cast(u)
    n1 = prec.ew(np.hypot(u[:, 0], u[:, 1]))
    over = n1 > sc.umax
    with np.errstate(divide="ignore", invalid="ignore"):
        a = prec.ew(np.where(over, u[:, 0] * sc.umax / n1, u[:, 0]))
        n2 = prec.ew(np.hypot(a, u[:, 1]))
        b = prec.ew(np.where(over, u[:, 1] * sc.umax / n2, u[:, 1]))
    return np.stack([a, b], 1)


def cw_step(sc: Scenario, x, u, noise, prec: Precision = FLOAT64):
    """The discrete plant: x' = Ad x + Bd u + noise, rows of (R, 4)."""
    return prec.ew(prec.mm(x, sc.Ad.T) + prec.mm(u, sc.Bd.T) + prec.cast(noise))


def terminated(sc: Scenario, x, margin: float = 0.0):
    """The termination test on true states x (R, 4): range below r_p, or the
    approach axis below r_p - r_tol. ``margin`` widens both thresholds
    (positive) or narrows them (negative)."""
    axis = 1 if sc.in_track else 0
    return ((np.hypot(x[:, 0], x[:, 1]) < sc.rp + margin)
            | (x[:, axis] < sc.rp - sc.rtol + margin))


def docked_now(sc: Scenario, x, margin: float = 0.0):
    """The success test on true states x (R, 4): within ``dist_tol`` of the
    target and a flight-path angle within ``ang_tol`` degrees; ``margin``
    widens both tolerances by that share."""
    dist = np.hypot(x[:, 0] - sc.xr[0], x[:, 1] - sc.xr[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        ang = np.abs(np.degrees(np.arctan(x[:, 3] / x[:, 2])))
    return (dist <= sc.dist_tol * (1 + margin)) & (ang <= sc.ang_tol * (1 + margin))


def two_body_deriv(x, u, n, ew):
    mu = n * n * R_T ** 3
    px, py, vx, vy = x[:, 0], x[:, 1], x[:, 2], x[:, 3]
    r3 = ew(((R_T + px) ** 2 + py ** 2) ** 1.5)
    ax = ew(2 * n * vy + n * n * px - mu * (R_T + px) / r3 + mu / R_T ** 2
            + u[:, 0])
    ay = ew(-2 * n * vx + n * n * py - mu * py / r3 + u[:, 1])
    return np.stack([vx, vy, ax, ay], 1)


def rk4(x, u, n, dt, ew):
    k1 = two_body_deriv(x, u, n, ew)
    k2 = two_body_deriv(ew(x + 0.5 * dt * k1), u, n, ew)
    k3 = two_body_deriv(ew(x + 0.5 * dt * k2), u, n, ew)
    k4 = two_body_deriv(ew(x + dt * k3), u, n, ew)
    return ew(x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4))


def two_body_tick(sc: Scenario, x, prev_u, ctrl, draws, j, succ,
                  prec: Precision = FLOAT64, margin: float = 0.0,
                  path: bool = False):
    """One control tick of the continuous plant for rows of (R, 4) that are
    alive when it starts, row r at tick ``j[r]``: ``n_sub`` RK4 substeps at
    ``T_cont``, the previous tick's control held over the first substep and
    ``ctrl`` over the rest, the held position noise ``draws[r, gi //
    noise_int_sub]`` (draws (R, n_draws, 2); gi the global substep) added
    after each, and a row frozen from the substep at whose start it meets
    the termination test; the success flag ``succ`` (R,) gathers every
    substep's success test while alive. ``margin`` moves the tests'
    thresholds (``terminated``, ``docked_now``). Returns (x_end, alive,
    succ, x_first): x_first is the state after the first substep, which the
    measurement reads. With ``path`` a fifth item: (n_sub, R, 4), each
    row's state entering each substep as if it never ended (a row that ends
    keeps the state entering the substep at whose start it ends)."""
    ew = prec.ew
    x = prec.cast(x)
    prev_u, ctrl = prec.cast(prev_u), prec.cast(ctrl)
    rows = np.arange(x.shape[0])
    j = np.broadcast_to(np.asarray(j), rows.shape)
    alive = np.ones(x.shape[0], bool)
    succ = np.array(succ, bool)
    zero = np.zeros_like(prev_u)
    x_first, states = None, []
    free = x  # the row's state as if it never ended
    for k in range(sc.n_sub):
        gi = j * sc.n_sub + k
        states.append(free)
        alive &= ~terminated(sc, x, margin)
        succ |= alive & docked_now(sc, x, margin) & (gi >= 1)
        if sc.delta_v:
            xn = rk4(free, zero, sc.n, sc.T_cont, ew)
            if k == 0:
                xn[:, 2:] = ew(xn[:, 2:] + prev_u)
        else:
            xn = rk4(free, prev_u if k == 0 else ctrl, sc.n, sc.T_cont, ew)
        xn[:, :2] = ew(xn[:, :2] + draws[rows, gi // sc.noise_int_sub])
        if k == 0:
            x_first = xn
        free = xn
        x = np.where(alive[:, None], xn, x)
    if path:
        return x, alive, succ, x_first, np.stack(states)
    return x, alive, succ, x_first


def ukf_step(sc: Scenario, xest, P, u, z, prec: Precision = FLOAT64):
    """One predict + update of the UKF (filterpy's Merwe scaled sigma
    points; process x' = Ao x + Bo u with noise Qw; measurement range and
    bearing with zero noise). Rows: xest (R, 6), P (R, 6, 6), u (R, 2),
    z (R, 2). Returns (xest', P')."""
    mm, ew = prec.mm, prec.ew
    xest, P, u, z = (prec.cast(v) for v in (xest, P, u, z))
    n = 6
    lam = UKF_ALPHA ** 2 * (n + UKF_KAPPA) - n
    Wm = np.full(2 * n + 1, 1.0 / (2 * (n + lam)))
    Wc = Wm.copy()
    Wm[0] = lam / (n + lam)
    Wc[0] = lam / (n + lam) + 1 - UKF_ALPHA ** 2 + UKF_BETA
    U = _cholesky(prec.cast((n + lam) * P)).transpose(0, 2, 1)
    sig = ew(np.concatenate([xest[:, None], xest[:, None] + U,
                             xest[:, None] - U], 1))
    f = ew(mm(sig, sc.Ao.T) + mm(u, sc.Bo.T)[:, None, :])
    xp = mm(Wm, f)
    d = ew(f - xp[:, None])
    Pp = ew(mm((d * Wc[None, :, None]).transpose(0, 2, 1), d) + sc.Qw)
    h = ew(np.stack([np.hypot(f[..., 0], f[..., 1]),
                     np.arctan2(f[..., 1], f[..., 0])], -1))
    zp = mm(Wm, h)
    dz = ew(h - zp[:, None])
    S = mm((dz * Wc[None, :, None]).transpose(0, 2, 1), dz)
    Pxz = mm((d * Wc[None, :, None]).transpose(0, 2, 1), dz)
    det = S[:, 0, 0] * S[:, 1, 1] - S[:, 0, 1] * S[:, 1, 0]
    adj = np.stack([np.stack([S[:, 1, 1], -S[:, 0, 1]], 1),
                    np.stack([-S[:, 1, 0], S[:, 0, 0]], 1)], 1)
    with np.errstate(divide="ignore", invalid="ignore"):
        K = mm(Pxz, adj / det[:, None, None])  # 2x2 inverse, NaN if singular
    x_post = ew(xp + mm(K, (z - zp)[:, :, None])[:, :, 0])
    P_post = ew(Pp - mm(mm(K, S), K.transpose(0, 2, 1)))
    return x_post, P_post


def _cholesky(A):
    """Lower Cholesky factors of a batch; a row whose matrix is not
    positive definite gets NaN, as the program's unrolled factor gives."""
    try:
        return np.linalg.cholesky(A)
    except np.linalg.LinAlgError:
        out = np.full_like(A, np.nan)
        for r in range(A.shape[0]):
            try:
                out[r] = np.linalg.cholesky(A[r])
            except np.linalg.LinAlgError:
                pass
        return out


def range_bearing(x, prec: Precision = FLOAT64):
    """The measurement of positions x (R, >=2): range and bearing."""
    x = prec.cast(x)
    return prec.ew(np.stack([np.hypot(x[:, 0], x[:, 1]),
                             np.arctan2(x[:, 1], x[:, 0])], 1))
