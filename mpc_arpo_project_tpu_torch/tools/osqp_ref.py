"""Port of ``tools/osqp_ref.py:1-429``: the host-side NumPy reference
implementation of the OSQP operator-splitting QP solver, unchanged but for
the reference project's paths (given from its root) and this docstring.

The reference codebase depends on the OSQP C solver through its Python
bindings (``src/trajectorySimulate.py:242-245,296,342,348``); this module is
the port's *oracle*: a faithful, branchy, float64 implementation of the
published OSQP algorithm (Stellato et al., "OSQP: An Operator Splitting
Solver for Quadratic Programs", arXiv:1711.08013) used to

  1. validate the batched ADMM solver (``ops/admm.py``) to the BASELINE
     "control deviation <= 1e-4" acceptance (``tools/deviation_bench.py``),
     and
  2. drive the NumPy oracle closed-loop simulator (``tools/ref_sim.py``)
     that replicates the reference's trajectory semantics end-to-end.

It is deliberately host numpy, not torch: dense float64, data-dependent
branches, one problem at a time. Accuracy mode (tight eps, high max_iter)
solves far past OSQP's default tolerances. Imports nothing of the JAX
package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import scipy.linalg

MIN_SCALING = 1e-4
MAX_SCALING = 1e4
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_SCALE = 1e3


@dataclass
class RefResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    status: str
    iters: int
    pri_res: float
    dua_res: float


class OSQPRef:
    """minimize 0.5 x'Px + q'x  s.t.  l <= Ax <= u  (dense, float64)."""

    def __init__(
        self,
        P: np.ndarray,
        q: np.ndarray,
        A: np.ndarray,
        l: np.ndarray,
        u: np.ndarray,
        rho: float = 0.1,
        sigma: float = 1e-6,
        alpha: float = 1.6,
        eps_abs: float = 1e-3,
        eps_rel: float = 1e-3,
        eps_pinf: float = 1e-4,
        eps_dinf: float = 1e-4,
        pinf_support_margin: float = 1.0,
        max_iter: int = 4000,
        check_every: int = 25,
        scaling_iters: int = 10,
        adaptive_rho: bool = True,
        adaptive_rho_interval: int = 50,
        adaptive_rho_tol: float = 5.0,
        scaling_override=None,
        rho_boundary_only: bool = False,
        stall_exit_chunks: int = 0,
        stall_improve: float = 0.95,
        cert_single_iter_delta: bool = False,
    ):
        """``scaling_override=(D, E, c)`` pins the Ruiz scaling (e.g. to the
        nominal-problem scaling the batched TPU solver shares across a whole
        rollout), and ``rho_boundary_only`` defers rho adaptation to solve
        boundaries — both so the oracle performs iteration-for-iteration the
        same arithmetic as ``ops.admm`` for closed-loop parity testing."""
        self.P = np.array(P, dtype=np.float64)
        self.q = np.array(q, dtype=np.float64)
        self.A = np.array(A, dtype=np.float64)
        self.l = np.array(l, dtype=np.float64)
        self.u = np.array(u, dtype=np.float64)
        self.n = self.P.shape[0]
        self.m = self.A.shape[0]
        self.rho_bar = rho
        self.sigma = sigma
        self.alpha = alpha
        self.eps_abs = eps_abs
        self.eps_rel = eps_rel
        self.eps_pinf = eps_pinf
        self.eps_dinf = eps_dinf
        self.pinf_support_margin = pinf_support_margin
        self.max_iter = max_iter
        self.check_every = check_every
        self.adaptive_rho = adaptive_rho
        self.adaptive_rho_interval = adaptive_rho_interval
        self.adaptive_rho_tol = adaptive_rho_tol
        self.rho_boundary_only = rho_boundary_only
        # opt-in stall exit mirroring ops.admm (0 = off, the OSQP-faithful
        # default): give up with 'max iterations' when neither residual has
        # improved >= (1 - stall_improve) for stall_exit_chunks check windows
        self.stall_exit_chunks = stall_exit_chunks
        self.stall_improve = stall_improve
        # Upstream OSQP tests the infeasibility certificates on the
        # SINGLE-iteration delta; ops.admm (and this oracle by default) test
        # the delta accumulated over a whole check interval, which is
        # behaviorally equivalent downstream (any non-solved status triggers
        # the reference failsafe) but can flip infeasible-vs-max_iter labels.
        # Set True to restore the upstream semantics for cross-validation
        # against the real `osqp` package (ADVICE r1).
        self.cert_single_iter_delta = cert_single_iter_delta

        if scaling_override is not None:
            D, E, c = scaling_override
            self.D = np.array(D, dtype=np.float64)
            self.E = np.array(E, dtype=np.float64)
            self.c = float(c)
            self._apply_scaling()
        else:
            self._equilibrate(scaling_iters)
        self._set_rho(self.rho_bar)
        self._factor()

        self.xbar = np.zeros(self.n)
        self.ybar = np.zeros(self.m)
        self.zbar = np.zeros(self.m)

    # ---------------- scaling ----------------
    def _apply_scaling(self):
        """Apply (self.D, self.E, self.c) to the problem data."""
        self.Ps = self.c * (self.P * self.D[:, None] * self.D[None, :])
        self.qs = self.c * (self.D * self.q)
        self.As = self.A * self.E[:, None] * self.D[None, :]
        self.ls = self.E * self.l
        self.us = self.E * self.u

    def _equilibrate(self, iters: int):
        """Modified Ruiz equilibration on [[P, A'], [A, 0]] plus cost scaling."""
        n, m = self.n, self.m
        D = np.ones(n)
        E = np.ones(m)
        c = 1.0
        Ps = self.P.copy()
        As = self.A.copy()
        qs = self.q.copy()
        for _ in range(iters):
            # column inf-norms of the scaled KKT matrix
            norm_cols_n = np.maximum(
                np.abs(Ps).max(axis=0, initial=0.0), np.abs(As).max(axis=0, initial=0.0)
            )
            norm_cols_m = np.abs(As).max(axis=1, initial=0.0)
            norms = np.concatenate([norm_cols_n, norm_cols_m])
            norms = np.clip(norms, MIN_SCALING, MAX_SCALING)
            delta = 1.0 / np.sqrt(norms)
            dn, dm = delta[:n], delta[n:]
            Ps = Ps * dn[:, None] * dn[None, :]
            As = As * dm[:, None] * dn[None, :]
            qs = qs * dn
            D *= dn
            E *= dm
            # cost scaling
            norm_P_cols = np.abs(Ps).max(axis=0, initial=0.0)
            mean_pc = norm_P_cols.mean() if n else 1.0
            norm_q = np.abs(qs).max(initial=0.0)
            gamma = 1.0 / max(np.clip(max(mean_pc, norm_q), MIN_SCALING, MAX_SCALING), MIN_SCALING)
            Ps *= gamma
            qs *= gamma
            c *= gamma
        self.D, self.E, self.c = D, E, c
        self.Ps, self.As, self.qs = Ps, As, qs
        self.ls = E * self.l
        self.us = E * self.u
        # E*inf can produce nan only if E==0, which clipping precludes

    def _set_rho(self, rho_bar: float):
        eq = np.isfinite(self.l) & np.isfinite(self.u) & (self.u - self.l < 1e-12)
        rho = np.full(self.m, np.clip(rho_bar, RHO_MIN, RHO_MAX))
        rho[eq] = np.clip(rho_bar * RHO_EQ_SCALE, RHO_MIN, RHO_MAX)
        self.rho_vec = rho
        self.rho_bar = rho_bar

    def _factor(self):
        M = self.Ps + self.sigma * np.eye(self.n) + self.As.T @ (self.rho_vec[:, None] * self.As)
        self._chol = scipy.linalg.cho_factor(M)

    # ---------------- public API ----------------
    def warm_start(self, x: Optional[np.ndarray] = None, y: Optional[np.ndarray] = None):
        if x is not None:
            self.xbar = x / self.D
            self.zbar = self.As @ self.xbar
        if y is not None:
            self.ybar = (self.c / self.E) * y  # inverse of y = c^-1 E ybar

    def update(self, q=None, l=None, u=None, A=None):
        """Matches the reference's OSQP usage: new bounds each step and a new
        constraint matrix with identical sparsity
        (``src/trajectorySimulate.py:340-348``)."""
        refactor = False
        if q is not None:
            self.q = np.array(q, dtype=np.float64)
            self.qs = self.c * self.D * self.q
        if l is not None:
            self.l = np.array(l, dtype=np.float64)
            self.ls = self.E * self.l
        if u is not None:
            self.u = np.array(u, dtype=np.float64)
            self.us = self.E * self.u
        if A is not None:
            self.A = np.array(A, dtype=np.float64)
            self.As = self.A * self.E[:, None] * self.D[None, :]
            refactor = True
        if l is not None or u is not None:
            # equality pattern may have changed -> rho vector pattern
            old = self.rho_vec.copy()
            self._set_rho(self.rho_bar)
            refactor = refactor or not np.array_equal(old, self.rho_vec)
        if refactor:
            self._factor()

    def _residuals(self, xbar, ybar, zbar):
        Einv = 1.0 / self.E
        Dinv = 1.0 / self.D
        Ax = self.As @ xbar
        rp = np.abs(Einv * (Ax - zbar)).max(initial=0.0)
        rp_rel = max(
            np.abs(Einv * Ax).max(initial=0.0), np.abs(Einv * zbar).max(initial=0.0)
        )
        Px = self.Ps @ xbar
        Aty = self.As.T @ ybar
        rd = (1.0 / self.c) * np.abs(Dinv * (Px + self.qs + Aty)).max(initial=0.0)
        rd_rel = (1.0 / self.c) * max(
            np.abs(Dinv * Px).max(initial=0.0),
            np.abs(Dinv * Aty).max(initial=0.0),
            np.abs(Dinv * self.qs).max(initial=0.0),
        )
        return rp, rp_rel, rd, rd_rel

    def _primal_infeasible(self, dybar):
        """Farkas-certificate test in SCALED space (as OSQP does): unscaled
        certificates false-positive on feasible problems whose solutions are
        large, because ||A'v|| <= eps*||v|| still admits support values of
        order ||x||*eps*||v||."""
        # project delta-y onto the polar of the recession cone of [l, u]
        v = dybar.copy()
        u_inf = ~np.isfinite(self.us)
        l_inf = ~np.isfinite(self.ls)
        v[u_inf & l_inf] = 0.0
        v[u_inf & ~l_inf] = np.minimum(v[u_inf & ~l_inf], 0.0)
        v[l_inf & ~u_inf] = np.maximum(v[l_inf & ~u_inf], 0.0)
        nv = np.abs(v).max(initial=0.0)
        # absolute gate (as OSQP): near convergence delta-y -> 0 and the
        # normalized certificate tests become pure round-off noise
        if nv <= self.eps_pinf:
            return False
        Atv = np.abs(self.As.T @ v).max(initial=0.0)
        if Atv > self.eps_pinf * nv:
            return False
        vp = np.maximum(v, 0.0)
        vm = np.minimum(v, 0.0)
        # evaluate u*vp / l*vm only where the multiplier is active (avoids inf*0)
        sup = (np.where(vp > 0, self.us, 0.0) * vp).sum() + (np.where(vm < 0, self.ls, 0.0) * vm).sum()
        # The support must be *decisively* negative. With only
        # ||A'v|| <= eps*||v||, Farkas admits |sup| up to ~||x||_1 * eps * ||v||
        # for feasible problems, so on degenerate actives the bare OSQP test
        # can misfire at tight tolerances; genuinely conflicting constraints in
        # this problem family give sup/||v|| of order -1e3 (measured), so a
        # unit margin separates them by orders of magnitude either way.
        thresh = max(self.eps_pinf, self.pinf_support_margin)
        return bool(sup <= -thresh * nv) and np.isfinite(sup)

    def _dual_infeasible(self, dxbar):
        """Unboundedness certificate in SCALED space (see _primal_infeasible)."""
        v = dxbar
        nv = np.abs(v).max(initial=0.0)
        # absolute gate (as OSQP); see _primal_infeasible
        if nv <= self.eps_dinf:
            return False
        if np.abs(self.Ps @ v).max(initial=0.0) > self.eps_dinf * nv:
            return False
        if self.qs @ v > -self.eps_dinf * nv:
            return False
        Av = self.As @ v
        # recession-cone test per OSQP: for finite u: Av_i <= eps; finite l: Av_i >= -eps
        up_ok = np.where(np.isfinite(self.us), Av <= self.eps_dinf * nv, True)
        lo_ok = np.where(np.isfinite(self.ls), Av >= -self.eps_dinf * nv, True)
        return bool(np.all(up_ok & lo_ok))

    def solve(self) -> RefResult:
        xbar, ybar, zbar = self.xbar, self.ybar, self.zbar
        rho = self.rho_vec
        status = "max iterations"
        it = 0
        rp = rd = np.inf
        # iterates at the last termination check: the infeasibility
        # certificates test the delta accumulated over the whole check
        # interval (matches ops.admm / native/osqp_ref.cpp — see ops.admm for
        # the fp32 rationale)
        x_chk, y_chk = xbar.copy(), ybar.copy()
        best_rp = best_rd = np.inf
        last_prog_chunk = 0
        for it in range(1, self.max_iter + 1):
            rhs = self.sigma * xbar - self.qs + self.As.T @ (rho * zbar - ybar)
            xt = scipy.linalg.cho_solve(self._chol, rhs)
            zt = self.As @ xt
            x_next = self.alpha * xt + (1 - self.alpha) * xbar
            z_tmp = self.alpha * zt + (1 - self.alpha) * zbar
            z_next = np.clip(z_tmp + ybar / rho, self.ls, self.us)
            y_next = ybar + rho * (z_tmp - z_next)

            if self.cert_single_iter_delta:
                x_chk, y_chk = xbar, ybar  # previous iterate, upstream-style

            xbar, ybar, zbar = x_next, y_next, z_next

            if it % self.check_every == 0 or it == self.max_iter:
                dx = xbar - x_chk
                dy = ybar - y_chk
                x_chk, y_chk = xbar.copy(), ybar.copy()
                rp, rp_rel, rd, rd_rel = self._residuals(xbar, ybar, zbar)
                if rp <= self.eps_abs + self.eps_rel * rp_rel and rd <= self.eps_abs + self.eps_rel * rd_rel:
                    status = "solved"
                    break
                if self._primal_infeasible(dy):
                    status = "primal infeasible"
                    break
                if self._dual_infeasible(dx):
                    status = "dual infeasible"
                    break
                if self.stall_exit_chunks:
                    chunk = it // self.check_every
                    if rp <= self.stall_improve * best_rp or rd <= self.stall_improve * best_rd:
                        last_prog_chunk = chunk
                    if chunk - last_prog_chunk >= self.stall_exit_chunks:
                        status = "max iterations"
                        break
                best_rp = min(best_rp, rp)
                best_rd = min(best_rd, rd)
            if (
                self.adaptive_rho
                and not self.rho_boundary_only
                and it % self.adaptive_rho_interval == 0
            ):
                rp_, rp_rel_, rd_, rd_rel_ = self._residuals(xbar, ybar, zbar)
                num = rp_ / max(rp_rel_, 1e-10)
                den = rd_ / max(rd_rel_, 1e-10)
                ratio = np.sqrt(num / max(den, 1e-10))
                if ratio > self.adaptive_rho_tol or ratio < 1.0 / self.adaptive_rho_tol:
                    # clamp so eq rows (rho*1e3) stay within RHO_MAX — matches
                    # the uniform-scalar clamp of ops.admm (see there)
                    new_rho = np.clip(self.rho_bar * ratio, RHO_MIN, RHO_MAX / RHO_EQ_SCALE)
                    if new_rho != self.rho_bar:
                        self._set_rho(new_rho)
                        self._factor()
                        rho = self.rho_vec

        if self.adaptive_rho and self.rho_boundary_only:
            # between-solve adaptation, matching ops.admm: the factorization is
            # rebuilt at the next update() anyway
            rp_, rp_rel_, rd_, rd_rel_ = self._residuals(xbar, ybar, zbar)
            num = rp_ / max(rp_rel_, 1e-10)
            den = max(rd_ / max(rd_rel_, 1e-10), 1e-10)
            ratio = np.sqrt(num / den)
            if ratio > self.adaptive_rho_tol or ratio < 1.0 / self.adaptive_rho_tol:
                new_rho = np.clip(self.rho_bar * ratio, RHO_MIN, RHO_MAX)
                if new_rho != self.rho_bar:
                    self._set_rho(new_rho)
                    self._factor()

        self.xbar, self.ybar, self.zbar = xbar, ybar, zbar
        x = self.D * xbar
        y = (1.0 / self.c) * self.E * ybar
        z = (1.0 / self.E) * zbar
        return RefResult(x=x, y=y, z=z, status=status, iters=it, pri_res=rp, dua_res=rd)

    def polish(self, res: RefResult, delta: float = 1e-7, refine: int = 5) -> RefResult:
        """OSQP-style solution polishing: guess the active set from the dual
        signs, solve the reduced equality-constrained KKT system with small
        regularization + iterative refinement, and keep the polished solution
        if it improves the residuals. Gives machine-precision ground truth on
        degenerate problems where plain ADMM stalls."""
        if res.status != "solved" and res.status != "max iterations":
            return res
        low = (res.y < -1e-12) & np.isfinite(self.l)
        upp = (res.y > 1e-12) & np.isfinite(self.u)
        act = low | upp
        A_red = self.A[act]
        rhs_red = np.where(low[act], self.l[act], self.u[act])
        n, k = self.n, int(act.sum())
        KKT = np.block(
            [
                [self.P + delta * np.eye(n), A_red.T],
                [A_red, -delta * np.eye(k)],
            ]
        )
        rhs = np.concatenate([-self.q, rhs_red])
        lu = scipy.linalg.lu_factor(KKT)
        sol = scipy.linalg.lu_solve(lu, rhs)
        # iterative refinement against the UNregularized KKT matrix
        KKT0 = np.block([[self.P, A_red.T], [A_red, np.zeros((k, k))]])
        for _ in range(refine):
            r = rhs - KKT0 @ sol
            sol = sol + scipy.linalg.lu_solve(lu, r)
        x_pol = sol[:n]
        nu = sol[n:]
        y_pol = np.zeros(self.m)
        y_pol[act] = nu
        z_pol = self.A @ x_pol
        # accept only if it improves the (unscaled) residuals
        rp_old = max(
            np.abs(np.clip(self.A @ res.x - self.u, 0, None)).max(initial=0.0),
            np.abs(np.clip(self.l - self.A @ res.x, 0, None)).max(initial=0.0),
        )
        rp_new = max(
            np.abs(np.clip(z_pol - self.u, 0, None)).max(initial=0.0),
            np.abs(np.clip(self.l - z_pol, 0, None)).max(initial=0.0),
        )
        rd_old = np.abs(self.P @ res.x + self.q + self.A.T @ res.y).max(initial=0.0)
        rd_new = np.abs(self.P @ x_pol + self.q + self.A.T @ y_pol).max(initial=0.0)
        if max(rp_new, rd_new / max(np.abs(self.q).max(), 1.0)) <= max(
            rp_old, rd_old / max(np.abs(self.q).max(), 1.0)
        ):
            return RefResult(
                x=x_pol, y=y_pol, z=z_pol, status="solved polished",
                iters=res.iters, pri_res=rp_new, dua_res=rd_new,
            )
        return res
