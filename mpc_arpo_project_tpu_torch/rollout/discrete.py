"""Discrete-time linear closed-loop rollout, batched over scenarios.

Counterpart of ``mpc_arpo_project_tpu/rollout/discrete.py``: one step =
{batched ADMM QP solve -> failsafe switching -> saturation -> plant step ->
UKF -> dynamic constraint rebuild} over a scenario batch, with early
termination as an ``alive`` mask. The JAX ``lax.scan`` is a Python loop over
steps here; the reference quirks the JAX package reproduces (one-step input
delay, sequential saturation, the in-track estimate swap seen by the
failsafe, the shared failsafe integrator) are reproduced the same way.

Every solve mode runs ('chol', the default, 'eig' or 'pallas':
``settings.solve_mode``); nothing in the step depends on the mode: the
solver's inverse state (``ADMMState.minv``) is carried and frozen for dead
scenarios whatever its shape. The estimator is the UKF (``'ukf'``) or the
steady-state KF on a linear position measurement (``'kf'``); the gains are
synthesized with scipy (``synthesis='scipy'``) or by the torch DARE and
Ackermann of ``ops.riccati`` in float64 on the CPU (``'torch'``, the JAX
package's ``'jax'``). The engine lives on the CUDA device unless
``build_engine`` is given ``device="cpu"``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import (
    Debris, FailsafeParams, MPCParams, SimConditions)
from mpc_arpo_project_tpu_torch.ops import (
    admm, constraints, host_synthesis, kalman, riccati, ukf)
from mpc_arpo_project_tpu_torch.ops.qp_builder import QPDims, build_qp
from mpc_arpo_project_tpu_torch.utils.timing import span


@dataclass(frozen=True)
class DiscreteEngine:
    """Device-resident engine for one scenario family (tensors on one
    device, in one dtype; the flags and sizes are plain Python values)."""

    dims: QPDims
    in_track: bool
    has_noise: bool
    nsim: int
    settings: admm.ADMMSettings
    Ad: torch.Tensor
    Bd: torch.Tensor
    Kpf: torch.Tensor
    Kif: torch.Tensor
    K_total: torch.Tensor
    K_i: torch.Tensor
    Crefx: torch.Tensor
    Ao: torch.Tensor
    Bou: torch.Tensor
    Qw: torch.Tensor
    R_meas: torch.Tensor
    ukf_w: ukf.MerweWeights
    prob: admm.ADMMProblem
    leq0: torch.Tensor
    umin: torch.Tensor
    umax: torch.Tensor
    geom: constraints.ConstraintGeom
    x0: torch.Tensor
    xr: torch.Tensor
    rp: torch.Tensor
    rtol: torch.Tensor
    sig_diag: torch.Tensor
    noise_rep: int
    dist_tol: torch.Tensor
    ang_tol: torch.Tensor
    debris_center: torch.Tensor
    debris_half: torch.Tensor
    estimator: str = "ukf"
    Co: Optional[torch.Tensor] = None  # (2, 6) linear measurement (kf only)
    L_kf: Optional[torch.Tensor] = None  # (6, 2) steady-state gain (kf only)

    @property
    def dtype(self) -> torch.dtype:
        return self.Ad.dtype

    @property
    def device(self) -> torch.device:
        return self.Ad.device


class RolloutOut(NamedTuple):
    """Stacked telemetry, shapes (T+1, B, ...) unless noted; index 0 holds
    the initial condition."""

    x_true: torch.Tensor  # (T+1, B, 4)
    x_est: torch.Tensor  # (T+1, B, 6)
    ctrls: torch.Tensor  # (T+1, B, 2)
    noise: torch.Tensor  # (T+1, B, 4)
    ctrl_seq: torch.Tensor  # (T, B) int32 codes 0/1/2/3
    status: torch.Tensor  # (T, B) solver statuses
    iters: torch.Tensor  # (T,) ADMM iterations per step (batch max)
    i_term: torch.Tensor  # (B,) termination step (== nsim if none)
    success: torch.Tensor  # (B,) bool
    final_rho: torch.Tensor  # (B,)
    done_iters: torch.Tensor  # (T, B)
    pri_res: torch.Tensor  # (T, B) residual/tolerance ratio at solver exit
    dua_res: torch.Tensor  # (T, B)


def build_engine(
    sim: SimConditions,
    mpc: MPCParams,
    fail: FailsafeParams,
    debris: Optional[Debris],
    settings: admm.ADMMSettings = admm.ADMMSettings(),
    dtype=torch.float32,
    synthesis: str = "scipy",
    estimator: str = "ukf",
    device="cuda",
) -> DiscreteEngine:
    """Host-side engine construction: float64 synthesis, cast to ``dtype``
    on ``device`` (the CUDA device unless the caller asks for the CPU;
    raises when there is none). ``synthesis``: 'scipy' (LAPACK DARE and
    Ackermann, the default) or 'torch' (``ops.riccati`` on float64 CPU
    tensors; the JAX package calls it 'jax'). ``estimator``: 'ukf' or 'kf'
    (its gain from the scipy DARE in float64). The config objects are read
    by attribute only."""
    device = admm.resolve_device(device)
    if synthesis not in ("scipy", "torch"):
        raise ValueError(f"unknown synthesis {synthesis!r}: 'scipy' or "
                         "'torch' (the port's name for the JAX package's "
                         "in-graph 'jax' synthesis)")
    if estimator not in ("ukf", "kf"):
        raise ValueError(f"unknown estimator {estimator!r}")
    T = sim.time_stp
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)
    Ad, Bd = host_synthesis.discretize_np(sim.mean_mtn, T, sim.isDeltaV)
    if synthesis == "torch":
        f64 = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
        Adt, Bdt = f64(Ad), f64(Bd)
        Kt, QNt = riccati.dlqr(Adt, Bdt, f64(mpc.Q_state), f64(mpc.R_input))
        _, Kpft, Kift = riccati.dlqr_integral(
            Adt, Bdt, f64(fail.Q_fail), f64(fail.R_fail), f64(fail.C_int))
        Ktt, Kit = riccati.deadbeat_debris_gains(Adt, Bdt)
        K, QN, Kpf, Kif, K_total, K_i = (
            v.numpy() for v in (Kt, QNt, Kpft, Kift, Ktt, Kit))
    else:
        K, QN, Kpf, Kif, K_total, K_i = host_synthesis.synth_gains_np(
            Ad, Bd, mpc, fail)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)
    # equilibrate on the INITIAL constraint matrix, as the reference's OSQP
    # setup does
    c1_0, c2_0, s0, _, _ = host_synthesis.configure_dynamic_np(
        sim, debris, np.concatenate([sim.x0, [0.0, 0.0]]))
    prob = admm.prepare_problem(
        static, dims, settings, nominal_coeffs=(c1_0, c2_0, -s0), dtype=dtype,
        pad=(settings.solve_mode in ("pallas", "eig")), device=device)

    Ao = np.zeros((6, 6))
    Ao[:4, :4] = Ad
    Ao[4:, 4:] = np.eye(2)
    Ao[0, 4] = 1.0
    Ao[1, 5] = 1.0
    Bou = np.vstack([Bd, np.zeros((2, 2))])
    if sim.noise is not None:
        sig = np.array([sim.noise.noise_std[0], sim.noise.noise_std[1], 0.0, 0.0])
        noise_rep = int(sim.noise.noise_length)
        has_noise = True
    else:
        sig = np.zeros(4)
        noise_rep = 1
        has_noise = False
    Qw = np.zeros((6, 6))
    Qw[:4, :4] = 0.001 * np.eye(4)
    Qw[4, 4] = (T * sig[0]) ** 2
    Qw[5, 5] = (T * sig[1]) ** 2
    if estimator == "kf":
        Co = np.hstack([np.eye(2, 4), np.zeros((2, 2))])
        L_kf, _ = kalman.steady_state_gain_np(
            Ao, Co, Qw + 1e-9 * np.eye(6), 1e-4 * np.eye(2))
    else:
        Co = L_kf = None

    if debris is not None:
        d_center = np.asarray(debris.center, dtype=np.float64)
        d_half = debris.side_length / 2.0
    else:
        d_center = np.array([-np.inf, -np.inf])
        d_half = 0.0

    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                  device=device)
    return DiscreteEngine(
        dims=dims, in_track=bool(sim.inTrack), has_noise=has_noise,
        nsim=sim.nsim, settings=settings,
        Ad=t(Ad), Bd=t(Bd), Kpf=t(Kpf), Kif=t(Kif), K_total=t(K_total),
        K_i=t(K_i), Crefx=t(fail.C_int), Ao=t(Ao), Bou=t(Bou), Qw=t(Qw),
        R_meas=t(np.zeros((2, 2))),
        ukf_w=ukf.merwe_weights(6, 0.1, 2.0, -1.0, dtype=dtype, device=device),
        prob=prob, leq0=t(static.leq), umin=t(static.umin),
        umax=t(static.umax),
        geom=constraints.make_geometry(sim, debris, dtype=dtype, device=device),
        x0=t(sim.x0), xr=t(sim.xr), rp=t(sim.r_p), rtol=t(sim.r_tol),
        sig_diag=t(sig), noise_rep=noise_rep, dist_tol=t(sim.suc_cond[0]),
        ang_tol=t(sim.suc_cond[1]), debris_center=t(d_center),
        debris_half=t(d_half), estimator=estimator,
        Co=None if Co is None else t(Co),
        L_kf=None if L_kf is None else t(L_kf),
    )


def make_noise_sequence(engine: DiscreteEngine, generator: torch.Generator,
                        batch: int) -> torch.Tensor:
    """(T, B, 4) held-noise sequence: one standard-normal draw per hold
    interval, scaled by the sigma diagonal. Draws come from ``generator``
    on its own device and move to the engine's."""
    n_draws = engine.nsim // engine.noise_rep + 2
    draws = torch.randn((n_draws, batch, 4), generator=generator,
                        dtype=engine.dtype, device=generator.device)
    return noise_sequence_from_draws(engine, draws)


def noise_sequence_from_draws(engine: DiscreteEngine, draws) -> torch.Tensor:
    """Build the (T, B, 4) sequence from explicit standard-normal draws
    (n_draws, B, 4), numpy or torch — lets tests feed both packages the same
    noise. A step past the last draw takes the last one, as the JAX
    package's clamped gather does: a noiseless engine (hold 1, zero sigma)
    accepts the draws of any hold length."""
    draws = torch.as_tensor(draws, dtype=engine.dtype, device=engine.device)
    scaled = draws * engine.sig_diag[None, None, :]
    idx = torch.arange(engine.nsim, device=engine.device) // engine.noise_rep
    return scaled[idx.clamp(max=draws.shape[0] - 1)]


def make_noise_sequence_multi(engine: DiscreteEngine,
                              generator: torch.Generator,
                              hold_lengths) -> torch.Tensor:
    """(T, B, 4) held-noise sequence with a PER-SCENARIO hold length
    (``hold_lengths``: (B,) ints), so that a sweep over hold lengths runs as
    one batch. Uniform hold lengths equal to the engine's give
    ``make_noise_sequence``'s sequence from the same generator state."""
    hold = np.asarray(hold_lengths, dtype=np.int64)
    n_draws = engine.nsim // max(int(hold.min()), 1) + 2
    draws = torch.randn((n_draws, hold.shape[0], 4),
                        generator=generator, dtype=engine.dtype,
                        device=generator.device)
    return noise_sequence_multi_from_draws(engine, draws, hold)


def noise_sequence_multi_from_draws(engine: DiscreteEngine, draws,
                                    hold_lengths) -> torch.Tensor:
    """``make_noise_sequence_multi`` from explicit standard-normal draws
    (n_draws, B, 4): step t of scenario b takes draw t // hold[b]."""
    draws = torch.as_tensor(draws, dtype=engine.dtype, device=engine.device)
    scaled = draws * engine.sig_diag[None, None, :]
    hold = torch.as_tensor(np.asarray(hold_lengths, dtype=np.int64),
                           device=engine.device)
    idx = torch.arange(engine.nsim, device=engine.device)[:, None] // hold
    return torch.gather(scaled, 0, idx[:, :, None].expand(-1, -1, 4))


class _Carry(NamedTuple):
    x_true: torch.Tensor  # (B, 4)
    xest: torch.Tensor  # (B, 6) fresh (unswapped) estimate
    xest_stored: torch.Tensor  # (B, 6) telemetry/failsafe view
    P: torch.Tensor  # (B, 6, 6)
    xintf: torch.Tensor  # (B,) failsafe integrator
    prev_u: torch.Tensor  # (B, 2) control applied to the plant this step
    l: torch.Tensor  # (B, m)
    u: torch.Tensor  # (B, m)
    c1: torch.Tensor  # (B,)
    c2: torch.Tensor
    s: torch.Tensor
    admm_state: admm.ADMMState
    alive: torch.Tensor  # (B,) bool
    i_term: torch.Tensor  # (B,) int32
    succ: torch.Tensor  # (B,) bool


def _reject_b(engine: DiscreteEngine, B: int, is_reject_b):
    if is_reject_b is None:
        return engine.geom.is_reject.expand(B)
    return torch.as_tensor(is_reject_b, dtype=engine.dtype, device=engine.device)


def _bounds(engine: DiscreteEngine, xest, is_reject_b):
    dyn = constraints.configure(engine.geom, xest)
    lineq, uineq = constraints.assemble_bounds(
        dyn, xest, engine.dims, engine.umin, engine.umax, is_reject_b)
    return dyn, lineq, uineq


def _init_carry(engine: DiscreteEngine, batch: int, x0b: torch.Tensor,
                is_reject_b: Optional[torch.Tensor] = None) -> _Carry:
    dims = engine.dims
    kw = dict(dtype=engine.dtype, device=engine.device)
    is_reject_b = _reject_b(engine, batch, is_reject_b)
    xest0 = torch.cat([x0b, torch.zeros((batch, 2), **kw)], 1)
    P0 = torch.zeros((6, 6), **kw)
    P0[:4, :4] = 1e-20 * torch.eye(4, **kw)
    P0[4:, 4:] = torch.eye(2, **kw)
    dyn, lineq, uineq = _bounds(engine, xest0, is_reject_b)
    leq = torch.cat([-x0b, engine.leq0[4:].expand(batch, -1)], 1)
    return _Carry(
        x_true=x0b, xest=xest0, xest_stored=xest0,
        P=P0.expand(batch, 6, 6).clone(),
        xintf=torch.zeros((batch,), **kw),
        prev_u=torch.zeros((batch, 2), **kw),
        l=torch.cat([leq, lineq], 1), u=torch.cat([leq, uineq], 1),
        c1=dyn.c1, c2=dyn.c2, s=dyn.s,
        admm_state=admm.init_state(engine.prob, batch, engine.settings),
        alive=torch.ones((batch,), dtype=torch.bool, device=engine.device),
        i_term=torch.full((batch,), engine.nsim, dtype=torch.int32,
                          device=engine.device),
        succ=torch.zeros((batch,), dtype=torch.bool, device=engine.device),
    )


def _step(engine: DiscreteEngine, carry: _Carry, i: int, noise_i: torch.Tensor,
          is_reject_b: Optional[torch.Tensor] = None):
    """One closed-loop control step for the whole batch, in a ``loop.step``
    span; returns the new carry and the step's telemetry tuple."""
    with span("loop.step"):
        dims = engine.dims
        B = carry.x_true.shape[0]
        is_reject_b = _reject_b(engine, B, is_reject_b)
        x = carry.x_true

        # --- termination and incremental success scan
        pos_norm = torch.linalg.vector_norm(x[:, :2], dim=1)
        back = x[:, 1] if engine.in_track else x[:, 0]
        term_now = (pos_norm < engine.rp) | (back < engine.rp - engine.rtol)
        newly_dead = carry.alive & term_now
        alive = carry.alive & ~term_now
        i_term = carry.i_term.masked_fill(newly_dead, i)
        dist_k = torch.linalg.vector_norm(x[:, :2] - engine.xr[:2][None, :], dim=1)
        ang_k = torch.atan(x[:, 3] / x[:, 2]).abs() * (180.0 / math.pi)
        ok_k = (dist_k <= engine.dist_tol) & (ang_k <= engine.ang_tol)
        succ = carry.succ | (alive & ok_k) if i >= 1 else carry.succ

        # --- QP solve (warm-started); dead scenarios are skipped in the solver
        res = admm.admm_solve(engine.prob, (carry.c1, carry.c2, carry.s),
                              carry.l, carry.u, carry.admm_state, engine.settings,
                              active=alive)
        with span("step.control"):
            solved = res.status == admm.SOLVED

            # --- controller hierarchy
            i0u = (dims.Nx + 1) * dims.nx
            u_mpc = res.x[:, i0u: i0u + 2]
            e = carry.xest_stored
            cx, cy = engine.debris_center[0], engine.debris_center[1]
            h = engine.debris_half
            in_box = ((e[:, 0] - (cx + h) < 0) & (e[:, 0] - (cx - h) > 0)
                      & (e[:, 1] < cy + h) & (e[:, 1] > cy - h))
            xintf_db = carry.xintf + e[:, 1] - (cy + h)
            u_db = -(e[:, :4] @ engine.K_total.T) - xintf_db[:, None] * engine.K_i[:, 0][None, :]
            xintf_fs = carry.xintf + (e[:, :4] @ engine.Crefx[0]) - engine.xr[0]
            u_fs = -(e[:, :4] @ engine.Kpf.T) - xintf_fs[:, None] * engine.Kif[:, 0][None, :]
            u_fail = torch.where(in_box[:, None], u_db, u_fs)
            xintf_new = torch.where(solved, 0.0, torch.where(in_box, xintf_db, xintf_fs))
            ctrl = torch.where(solved[:, None], u_mpc, u_fail)
            code = torch.where(solved, admm.SOLVED,
                               torch.where(in_box, 3, 2)).to(torch.int32)

            # --- sequential saturation quirk
            umax0 = engine.umax[0]
            n1 = torch.linalg.vector_norm(ctrl, dim=1)
            over = n1 > umax0
            c0 = torch.where(over, ctrl[:, 0] * umax0 / n1, ctrl[:, 0])
            n2 = torch.sqrt(c0 ** 2 + ctrl[:, 1] ** 2)
            c1_ = torch.where(over, ctrl[:, 1] * umax0 / n2, ctrl[:, 1])
            ctrl = torch.stack([c0, c1_], 1)

        # --- plant step with the PREVIOUS control
        with span("step.plant"):
            x_next = x @ engine.Ad.T + carry.prev_u @ engine.Bd.T + noise_i

        # --- estimation
        with span("step.estimate"):
            if engine.has_noise and engine.estimator == "kf":
                # steady-state KF: linear position measurement, fixed gain; the
                # covariance is static by construction
                xest_next = kalman.kf_step(carry.xest, carry.prev_u, x_next[:, :2],
                                           engine.Ao, engine.Bou, engine.Co,
                                           engine.L_kf)
                P_next = carry.P
            elif engine.has_noise:
                z = torch.stack([torch.linalg.vector_norm(x_next[:, :2], dim=1),
                                 torch.atan2(x_next[:, 1], x_next[:, 0])], 1)
                st = ukf.step(ukf.UKFState(x=carry.xest, P=carry.P), carry.prev_u, z,
                              engine.ukf_w, engine.Ao, engine.Bou, engine.Qw,
                              engine.R_meas)
                xest_next, P_next = st.x, st.P
            else:
                xest_next = torch.cat([x_next, torch.zeros_like(x_next[:, :2])], 1)
                P_next = carry.P

        # --- bound + constraint updates
        with span("step.bounds"):
            dyn, lineq, uineq = _bounds(engine, xest_next, is_reject_b)
            l_new = torch.cat([-xest_next[:, :4], carry.l[:, 4:dims.n_eq], lineq], 1)
            u_new = torch.cat([-xest_next[:, :4], carry.u[:, 4:dims.n_eq], uineq], 1)

        # --- freeze dead scenarios
        def keep(new, old):
            return torch.where(alive.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

        st = res.state
        old = carry.admm_state
        new_carry = _Carry(
            x_true=keep(x_next, x),
            xest=keep(xest_next, carry.xest),
            xest_stored=keep(dyn.xest_stored, carry.xest_stored),
            P=keep(P_next, carry.P),
            xintf=keep(xintf_new, carry.xintf),
            prev_u=keep(ctrl, carry.prev_u),
            l=keep(l_new, carry.l),
            u=keep(u_new, carry.u),
            c1=keep(dyn.c1, carry.c1),
            c2=keep(dyn.c2, carry.c2),
            s=keep(dyn.s, carry.s),
            admm_state=admm.ADMMState(
                xbar=keep(st.xbar, old.xbar), ybar=keep(st.ybar, old.ybar),
                zbar=keep(st.zbar, old.zbar),
                rho_scale=keep(st.rho_scale, old.rho_scale),
                minv=keep(st.minv, old.minv), minv_ok=st.minv_ok,
                ref_coef=keep(st.ref_coef, old.ref_coef)),
            alive=alive, i_term=i_term, succ=succ,
        )

        def ratio(r, tol):
            return torch.where((tol > 0) & torch.isfinite(tol), r / tol, r)

        out = (
            keep(x_next, x),
            keep(dyn.xest_stored, carry.xest_stored),
            keep(ctrl, torch.zeros_like(ctrl)),
            noise_i,
            torch.where(alive, code, 0),
            torch.where(alive, res.status, -1),
            res.iters,
            torch.where(alive, res.done_iters, 0),
            torch.where(alive, ratio(res.pri_res, res.pri_tol), 0.0),
            torch.where(alive, ratio(res.dua_res, res.dua_tol), 0.0),
        )
        return new_carry, out


def rollout_chunked(
    engine: DiscreteEngine,
    noise_seq: torch.Tensor,
    x0b: Optional[torch.Tensor] = None,
    seg: int = 25,
    progress=None,
    is_reject_b: Optional[torch.Tensor] = None,
) -> RolloutOut:
    """Run the closed loop over ``noise_seq`` (T, B, 4), calling
    ``progress(done, total, carry)`` after every ``seg`` steps.

    ``x0b``: optional (B, 4) initial states (default the engine's x0);
    ``is_reject_b``: optional (B,) per-scenario offset-free switch."""
    T, B = noise_seq.shape[0], noise_seq.shape[1]
    if T != engine.nsim or T % seg:
        raise ValueError(f"noise length {T} must equal nsim={engine.nsim} "
                         f"and be a multiple of seg={seg}")
    if x0b is None:
        x0b = engine.x0.expand(B, 4)
    carry = _init_carry(engine, B, x0b, is_reject_b)
    outs = []
    for i in range(T):
        carry, o = _step(engine, carry, i, noise_seq[i], is_reject_b)
        outs.append(o)
        if progress is not None and (i + 1) % seg == 0:
            progress(i + 1, T, carry)

    (x_true_s, xest_s, ctrl_s, noise_s, code_s, status_s, iters_s,
     done_iters_s, rp_s, rd_s) = zip(*outs)
    st = lambda xs: torch.stack(xs, 0)
    xest0 = torch.cat([x0b, torch.zeros_like(x0b[:, :2])], 1)
    return RolloutOut(
        x_true=torch.cat([x0b[None], st(x_true_s)], 0),
        x_est=torch.cat([xest0[None], st(xest_s)], 0),
        ctrls=torch.cat([torch.zeros_like(x0b[None, :, :2]), st(ctrl_s)], 0),
        noise=torch.cat([noise_seq[:1], st(noise_s)], 0),
        ctrl_seq=st(code_s),
        status=st(status_s),
        iters=torch.tensor(iters_s, dtype=torch.int32),
        i_term=carry.i_term,
        success=carry.succ,
        final_rho=carry.admm_state.rho_scale,
        done_iters=st(done_iters_s),
        pri_res=st(rp_s),
        dua_res=st(rd_s),
    )


def rollout(
    engine: DiscreteEngine,
    noise_seq: torch.Tensor,
    x0b: Optional[torch.Tensor] = None,
    is_reject_b: Optional[torch.Tensor] = None,
) -> RolloutOut:
    """Run the full closed loop for a scenario batch in one pass (the same
    loop as ``rollout_chunked``, without progress callbacks)."""
    return rollout_chunked(engine, noise_seq, x0b, seg=noise_seq.shape[0],
                           is_reject_b=is_reject_b)
