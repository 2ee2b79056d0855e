"""Continuous-time nonlinear closed loop with sample-and-hold, batched over
scenarios.

Counterpart of ``mpc_arpo_project_tpu/rollout/continuous.py`` (the
reference semantics it reproduces are documented there): the controller
runs every T seconds with the discrete loop's machinery (QP solve,
failsafe, saturation, UKF or KF, constraint rebuild) while the nonlinear
two-body plant integrates at T_cont with fixed-step RK4. The JAX outer
``lax.scan`` over ticks is a Python loop here; the inner scan over the
T/T_cont substeps is one call of ``ops.rk4_tick.rk4_tick`` per tick (one
launch of its CUDA kernel on the card, its plain twin on the CPU). The
engine lives on the CUDA device unless ``build_engine`` is given
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.config import (
    Debris, FailsafeParams, MPCParams, SimConditions)
from mpc_arpo_project_tpu_torch.ops import admm, kalman, ukf
from mpc_arpo_project_tpu_torch.ops import rk4_tick as rk4
from mpc_arpo_project_tpu_torch.rollout import discrete as dd
from mpc_arpo_project_tpu_torch.utils.timing import span


@dataclass(frozen=True)
class ContinuousEngine:
    base: dd.DiscreteEngine  # all the discrete machinery (QP, gains, UKF, geom)
    n_ticks: int  # discrete steps
    sig_cont: torch.Tensor  # per-substep position-jump sigma
    plant: rk4.TickPlant  # the substeps' sizes, switches and constants

    @property
    def n_sub(self) -> int:  # substeps per tick (T/T_cont)
        return self.plant.n_sub

    @property
    def noise_int_sub(self) -> int:  # substeps per noise draw
        return self.plant.noise_int_sub

    @property
    def is_delta_v(self) -> bool:
        return self.plant.is_delta_v


class ContinuousOut(NamedTuple):
    x_true_ticks: torch.Tensor  # (n_ticks+1, B, 4) truth at tick boundaries
    x_sub: Optional[torch.Tensor]  # (n_ticks-1, n_sub, B, 4) substep truth (optional)
    x_est: torch.Tensor  # (n_ticks+1, B, 6)
    ctrls: torch.Tensor  # (n_ticks+1, B, 2) per-tick applied control
    ctrl_seq: torch.Tensor  # (n_ticks-1, B)
    status: torch.Tensor  # (n_ticks-1, B)
    i_term_sub: torch.Tensor  # (B,) termination substep index (== n_total if none)
    success: torch.Tensor  # (B,)
    iters: torch.Tensor  # (n_ticks-1,) ADMM iterations per tick (batch max)
    done_iters: torch.Tensor  # (n_ticks-1, B) per-problem iterations to finish


def build_engine(
    sim: SimConditions,
    mpc: MPCParams,
    fail: FailsafeParams,
    debris: Optional[Debris],
    settings: admm.ADMMSettings = admm.ADMMSettings(),
    dtype=torch.float32,
    noise_convention: str = "brownian",
    estimator: str = "ukf",
    device="cuda",
) -> ContinuousEngine:
    """The discrete engine (on ``device``, the CUDA device unless the caller
    asks for the CPU; raises when there is none) plus the continuous
    plant's sizes and constants. ``noise_convention``: 'brownian' (the
    per-substep position jump sigma*sqrt(T_cont), the default) or
    'white_noise_per_dt' (sigma/sqrt(T_cont), the reference's formula as
    written); both use sigma_x for both axes, as the reference does."""
    if not np.isfinite(sim.T_cont):
        raise ValueError("the continuous engine needs a finite T_cont")
    base = dd.build_engine(sim, mpc, fail, debris, settings=settings,
                           dtype=dtype, estimator=estimator, device=device)
    n_sub = int(round(sim.time_stp / sim.T_cont))
    n_ticks = int(sim.T_final / sim.time_stp)
    if sim.noise is not None:
        sig_x = sim.noise.noise_std[0]
        noise_rep = int(sim.noise.noise_length)
    else:
        sig_x = 0.0
        noise_rep = 1
    if noise_convention == "brownian":
        sig_cont = sig_x * np.sqrt(sim.T_cont)
    elif noise_convention == "white_noise_per_dt":
        sig_cont = sig_x / np.sqrt(sim.T_cont)
    else:
        raise ValueError(noise_convention)
    noise_int_sub = noise_rep * n_sub  # substeps per held draw

    # the continuous sim's process noise replaces the discrete one
    T = sim.time_stp
    Qw = np.zeros((6, 6))
    Qw[:4, :4] = 0.001 * np.eye(4)
    Qw[4, 4] = (T * n_sub * sig_x) ** 2
    Qw[5, 5] = (T * n_sub * sim.noise.noise_std[1] if sim.noise else 0.0) ** 2
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64), dtype=dtype,
                                  device=base.device)
    changes = dict(Qw=t(Qw))
    if estimator == "kf":
        # re-synthesize the steady-state gain against the continuous-sim
        # process noise, from the engine's (dtype-rounded) Ao
        Co = np.hstack([np.eye(2, 4), np.zeros((2, 2))])
        L_kf, _ = kalman.steady_state_gain_np(
            base.Ao.cpu().double().numpy(), Co, Qw + 1e-9 * np.eye(6),
            1e-4 * np.eye(2))
        changes["L_kf"] = t(L_kf)
    base = dataclasses.replace(base, **changes)

    # the plant constants as the engine's dtype rounds them
    r = lambda v: float(torch.tensor(float(v), dtype=dtype))
    plant = rk4.TickPlant(
        n_sub=n_sub, noise_int_sub=noise_int_sub,
        is_delta_v=bool(sim.isDeltaV), in_track=base.in_track,
        mean_mtn=r(sim.mean_mtn), T_cont=r(sim.T_cont), rp=r(sim.r_p),
        rtol=r(sim.r_tol), xr=(r(sim.xr[0]), r(sim.xr[1])),
        dist_tol=r(sim.suc_cond[0]), ang_tol=r(sim.suc_cond[1]))
    return ContinuousEngine(base=base, n_ticks=n_ticks, sig_cont=t(sig_cont),
                            plant=plant)


def make_noise_draws(engine: ContinuousEngine, generator: torch.Generator,
                     batch: int) -> torch.Tensor:
    """(n_draws, B, 2) pre-scaled held white-noise draws from ``generator``
    (on its own device; the draws move to the engine's)."""
    n_total = engine.n_ticks * engine.n_sub
    n_draws = n_total // engine.noise_int_sub + 2
    base = engine.base
    draws = torch.randn((n_draws, batch, 2), generator=generator,
                        dtype=base.dtype, device=generator.device)
    return engine.sig_cont * draws.to(base.device)


class _CCarry(NamedTuple):
    x_true: torch.Tensor  # (B, 4)
    xest: torch.Tensor
    xest_stored: torch.Tensor
    P: torch.Tensor
    xintf: torch.Tensor
    prev_u: torch.Tensor  # (B, 2) previous tick's control (delay substep + UKF)
    l: torch.Tensor
    u: torch.Tensor
    c1: torch.Tensor
    c2: torch.Tensor
    s: torch.Tensor
    admm_state: admm.ADMMState
    alive: torch.Tensor
    i_term_sub: torch.Tensor  # (B,) int32 substep index of termination
    succ: torch.Tensor


def _tick(engine: ContinuousEngine, carry: _CCarry, j: int,
          noise_draws: torch.Tensor, substep_telemetry: bool):
    """One control tick, in a ``loop.tick`` span: solve and switch as the
    discrete step does, then the n_sub RK4 substeps with sample-and-hold
    (``rk4_tick``)."""
    with span("loop.tick"):
        base = engine.base
        dims = base.dims
        B = carry.x_true.shape[0]

        # --- QP solve + controller selection; dead scenarios are skipped in
        # the solver
        res = admm.admm_solve(base.prob, (carry.c1, carry.c2, carry.s), carry.l,
                              carry.u, carry.admm_state, base.settings,
                              active=carry.alive)
        with span("step.control"):
            solved = res.status == admm.SOLVED
            i0u = (dims.Nx + 1) * dims.nx
            u_mpc = res.x[:, i0u: i0u + 2]
            e = carry.xest_stored
            cx, cy = base.debris_center[0], base.debris_center[1]
            h = base.debris_half
            in_box = ((e[:, 0] - (cx + h) < 0) & (e[:, 0] - (cx - h) > 0)
                      & (e[:, 1] < cy + h) & (e[:, 1] > cy - h))
            xintf_db = carry.xintf + e[:, 1] - (cy + h)
            u_db = -(e[:, :4] @ base.K_total.T) - xintf_db[:, None] * base.K_i[:, 0][None, :]
            xintf_fs = carry.xintf + (e[:, :4] @ base.Crefx[0]) - base.xr[0]
            u_fs = -(e[:, :4] @ base.Kpf.T) - xintf_fs[:, None] * base.Kif[:, 0][None, :]
            u_fail = torch.where(in_box[:, None], u_db, u_fs)
            xintf_new = torch.where(solved, 0.0, torch.where(in_box, xintf_db, xintf_fs))
            ctrl = torch.where(solved[:, None], u_mpc, u_fail)
            code = torch.where(solved, 1, torch.where(in_box, 3, 2)).to(torch.int32)

            umax0 = base.umax[0]
            n1 = torch.linalg.vector_norm(ctrl, dim=1)
            over = n1 > umax0
            c0 = torch.where(over, ctrl[:, 0] * umax0 / n1, ctrl[:, 0])
            n2 = torch.sqrt(c0 ** 2 + ctrl[:, 1] ** 2)
            c1v = torch.where(over, ctrl[:, 1] * umax0 / n2, ctrl[:, 1])
            ctrl = torch.stack([c0, c1v], 1)

        # --- the n_sub substeps with sample-and-hold and the 1-substep delay;
        # x_after_first is the state one substep after the tick, which the
        # measurement reads
        with span("step.plant"):
            x_end, alive, i_term_sub, succ, x_after_first, x_sub = rk4.rk4_tick(
                carry.x_true, carry.alive, carry.i_term_sub, carry.succ,
                carry.prev_u, ctrl, noise_draws, j, engine.plant,
                telemetry=substep_telemetry)

        # --- measurement + estimator one substep after the tick, with the
        # previous tick's held control in the predict step
        with span("step.estimate"):
            if base.has_noise and base.estimator == "kf":
                xest_next = kalman.kf_step(carry.xest, carry.prev_u,
                                           x_after_first[:, :2], base.Ao, base.Bou,
                                           base.Co, base.L_kf)
                P_next = carry.P
            elif base.has_noise:
                z = torch.stack([torch.linalg.vector_norm(x_after_first[:, :2], dim=1),
                                 torch.atan2(x_after_first[:, 1], x_after_first[:, 0])],
                                1)
                st = ukf.step(ukf.UKFState(x=carry.xest, P=carry.P), carry.prev_u, z,
                              base.ukf_w, base.Ao, base.Bou, base.Qw, base.R_meas)
                xest_next, P_next = st.x, st.P
            else:
                xest_next = torch.cat([x_after_first,
                                       torch.zeros_like(x_after_first[:, :2])], 1)
                P_next = carry.P

        with span("step.bounds"):
            dyn, lineq, uineq = dd._bounds(base, xest_next,
                                           base.geom.is_reject.expand(B))
            l_new = torch.cat([-xest_next[:, :4], carry.l[:, 4:dims.n_eq], lineq], 1)
            u_new = torch.cat([-xest_next[:, :4], carry.u[:, 4:dims.n_eq], uineq], 1)

        def keep(new, old):
            return torch.where(alive.reshape((B,) + (1,) * (new.dim() - 1)), new, old)

        st = res.state
        old = carry.admm_state
        new_carry = _CCarry(
            x_true=x_end,
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
            alive=alive,
            i_term_sub=i_term_sub,
            succ=succ,
        )
        pre = carry.alive  # control and codes are recorded with PRE-tick aliveness
        outs = (
            x_end,
            keep(dyn.xest_stored, carry.xest_stored),
            torch.where(pre[:, None], ctrl, 0.0),
            torch.where(pre, code, 0),
            torch.where(pre, res.status, -1),
            res.iters,
            torch.where(pre, res.done_iters, 0),
            x_sub,
        )
        return new_carry, outs


def _init(engine: ContinuousEngine, noise_draws, x0b):
    base = engine.base
    # contiguous: the tick kernel takes no strided input
    noise_draws = torch.as_tensor(noise_draws, dtype=base.dtype,
                                  device=base.device).contiguous()
    B = noise_draws.shape[1]
    if x0b is None:
        x0b = base.x0.expand(B, 4)
    x0b = torch.as_tensor(x0b, dtype=base.dtype,
                          device=base.device).contiguous()
    dcarry = dd._init_carry(base, B, x0b)
    n_total = engine.n_ticks * engine.n_sub
    carry = _CCarry(
        x_true=x0b, xest=dcarry.xest, xest_stored=dcarry.xest_stored,
        P=dcarry.P, xintf=dcarry.xintf, prev_u=torch.zeros_like(x0b[:, :2]),
        l=dcarry.l, u=dcarry.u, c1=dcarry.c1, c2=dcarry.c2, s=dcarry.s,
        admm_state=dcarry.admm_state,
        alive=torch.ones((B,), dtype=torch.bool, device=base.device),
        i_term_sub=torch.full((B,), n_total, dtype=torch.int32,
                              device=base.device),
        succ=torch.zeros((B,), dtype=torch.bool, device=base.device),
    )
    return noise_draws, x0b, carry


def rollout_chunked(
    engine: ContinuousEngine,
    noise_draws,
    x0b: Optional[torch.Tensor] = None,
    seg: int = 25,
    progress=None,
    substep_telemetry: bool = False,
) -> ContinuousOut:
    """Run the continuous-time closed loop for a scenario batch, calling
    ``progress(tick_reached, n_ticks, carry)`` after every ``seg`` ticks and
    after the last.

    noise_draws: (n_draws, B, 2) pre-scaled draws, a tensor from
    ``make_noise_draws`` or an array (zeros allowed); x0b: optional (B, 4)
    initial states (default the engine's x0). The first T seconds idle with
    zero control, as the reference does: ticks run j = 1 .. n_ticks-1."""
    base = engine.base
    noise_draws, x0b, carry = _init(engine, noise_draws, x0b)
    B = x0b.shape[0]
    ticks = list(range(1, engine.n_ticks))
    outs = []
    for i, j in enumerate(ticks):
        carry, o = _tick(engine, carry, j, noise_draws, substep_telemetry)
        outs.append(o)
        if progress is not None and ((i + 1) % seg == 0 or i + 1 == len(ticks)):
            progress(j + 1, engine.n_ticks, carry)

    kw = dict(dtype=base.dtype, device=base.device)
    if outs:
        (x_ticks_s, xest_s, ctrl_s, code_s, status_s, iters_s, done_iters_s,
         x_sub_s) = zip(*outs)
        st = lambda xs: torch.stack(xs, 0)
        x_ticks, xest, ctrl_t = st(x_ticks_s), st(xest_s), st(ctrl_s)
        code, status, done_iters = st(code_s), st(status_s), st(done_iters_s)
        iters = torch.tensor(iters_s, dtype=torch.int32)
        x_sub = st(x_sub_s) if substep_telemetry else None
    else:  # n_ticks <= 1: no tick runs
        x_ticks, xest = torch.zeros((0, B, 4), **kw), torch.zeros((0, B, 6), **kw)
        ctrl_t = torch.zeros((0, B, 2), **kw)
        code = torch.zeros((0, B), dtype=torch.int32, device=base.device)
        status = torch.zeros((0, B), dtype=torch.int32, device=base.device)
        done_iters = torch.zeros((0, B), dtype=torch.int32, device=base.device)
        iters = torch.zeros((0,), dtype=torch.int32)
        x_sub = (torch.zeros((0, engine.n_sub, B, 4), **kw)
                 if substep_telemetry else None)
    xest0 = torch.cat([x0b, torch.zeros((B, 2), **kw)], 1)
    return ContinuousOut(
        x_true_ticks=torch.cat([x0b[None], x0b[None], x_ticks], 0),
        x_sub=x_sub,
        x_est=torch.cat([xest0[None], xest0[None], xest], 0),
        ctrls=torch.cat([torch.zeros((2, B, 2), **kw), ctrl_t], 0),
        ctrl_seq=code,
        status=status,
        i_term_sub=carry.i_term_sub,
        success=carry.succ,
        iters=iters,
        done_iters=done_iters,
    )


def rollout(
    engine: ContinuousEngine,
    noise_draws,
    x0b: Optional[torch.Tensor] = None,
    substep_telemetry: bool = False,
) -> ContinuousOut:
    """Run the continuous-time closed loop for a scenario batch in one pass
    (the loop of ``rollout_chunked``, without progress callbacks)."""
    return rollout_chunked(engine, noise_draws, x0b,
                           seg=max(engine.n_ticks, 1),
                           substep_telemetry=substep_telemetry)
