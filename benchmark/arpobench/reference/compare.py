"""The comparison that decides ``correct``: the program's closed-loop steps
held to the plain reference, step by step.

The closed loop is chaotic over a horizon (a float32 and a float64 run part
within a few steps), so the reference cannot replay a batch from its start.
It follows the program step by step instead: for each sampled (scenario,
step) it takes the state the program carried into the step, and the inputs
the harness made, works out what the step must give, and compares it with
what the program carried out of it. The stages:

* ``plant``: the true state after the step, from the state before it and
  the control the program applied (the CW model, or the two-body RK4
  substeps for the continuous loop);
* ``ukf_x``, ``ukf_d``, ``ukf_P``: the estimate of the state, of the
  disturbance, and their covariance after the UKF's predict and update on
  the program's measurement;
* ``qp_data``: the next QP's dynamic coefficients and bounds, built from
  the program's new estimate;
* ``solve``: the step's ADMM answer (the solver's iterates the program
  carried out of the step), held to the solver's stopping rule on the
  reference's own QP, built from the estimate the step entered with: by how
  many tolerances the worst SOLVED answer's residual lies above the rule
  (``reference.admm``);
* ``solve_u``: where the QP was SOLVED, the applied control against the
  saturated first input of that answer, to the control limit;
* ``fallback``: where the QP was not SOLVED, the failsafe or deadbeat
  control after saturation, and the integrator;
* ``flags``: disagreements on what must agree exactly: termination,
  success, which controller ran, the integrator's reset, a dead scenario's
  frozen state, the pattern of infinite bounds, a MAX_ITER answer that
  meets the stopping rule with half its tolerance to spare, and one given
  up before the solver's stall rule or iteration cap allows. Tests with a
  threshold (termination, success) count as disagreeing only where the
  reference decides the same way with the threshold moved by ``BORDER``
  either way; a scenario that ends inside a continuous tick is held to the
  run whose ending matches it best.

The answer is held to the rule the solver states and not to the exact
optimum: on these QPs the MPC's first input is weakly determined (its box
spans about 1% of the cost), and ``eps_abs = eps_rel = 1e-3`` leaves a
SOLVED answer up to ~40% above the least cost.

Each gap is relative: positions to their size or 1 m, velocities to theirs
or 0.01 m/s, the disturbance estimate to its size or the standard deviation
of its process noise in the filter, controls to the control limit.
Every number is the largest over the sample. numpy only.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from arpobench.reference import admm, model
from arpobench.reference.precision import CONTROL

NUMBERS = ("plant", "ukf_x", "ukf_d", "ukf_P", "qp_data", "solve", "solve_u",
           "fallback", "flags")
# how far a test with a threshold may move (m for termination, a share of
# the tolerances for success): a thousand times float32's gap in a tick
BORDER = 1e-3
END_SUBSTEPS = 2  # how many substeps apart two runs may end a scenario
SOLVED, MAX_ITER, MPC = 1, 2, 1
MET = 0.5  # a MAX_ITER answer within this share of its tolerances disagrees


class Samples(NamedTuple):
    """Sampled alive (scenario, step) pairs, each entry with a leading axis
    of samples. ``ent``/``out``: the carry fields before and after the step
    (x, xest, xest_stored, P, xintf, prev_u, succ, alive; ``out`` also c1,
    c2, s, l, u); ``code``, ``status``, ``ctrl``: the step's controller
    code, QP status and applied control from the rollout's outputs;
    ``noise``: the discrete step's (4,) input, or the continuous row's
    (n_draws, 2) draws; ``j``: the step (tick) index."""

    ent: dict
    out: dict
    code: np.ndarray
    status: np.ndarray
    ctrl: np.ndarray
    noise: np.ndarray
    j: np.ndarray
    iters: np.ndarray


def _rel(a, b, floor):
    """Per row: max |a - b| / max(|b|, floor) over the last axis."""
    a, b = np.asarray(a, float), np.asarray(b, float)
    return (np.abs(a - b).max(-1) / np.maximum(np.abs(b).max(-1), floor))


def _state_gap(a, b):
    return np.maximum(_rel(a[..., :2], b[..., :2], 1.0),
                      _rel(a[..., 2:4], b[..., 2:4], 1e-2))


def _max(v):
    v = np.asarray(v, float)
    if v.size == 0:
        return 0.0
    return float(np.nanmax(v)) if not np.isnan(v).all() else float("nan")


def first_input(sc: model.Scenario, x):
    i0 = (sc.dims.Nx + 1) * sc.dims.nx
    return x[..., i0:i0 + 2]


def least_iters(sc: model.Scenario) -> int:
    """The fewest iterations after which the solver may report MAX_ITER:
    its stall rule's (no progress over ``stall_exit_chunks`` checks from
    the start), or its cap."""
    so = sc.solve
    n = so["stall_exit_chunks"] * so["check_every"]
    return min(n, so["max_iter"]) if n else so["max_iter"]


def solve_check(sc: model.Scenario, smp: Samples):
    """Per sample: (excess, met, u_gap): how many tolerances the answer's
    residual lies above the stopping rule, whether it meets the rule with
    ``MET`` to spare, and the applied control's gap to the saturated first
    input of the answer, to the control limit."""
    e, o = smp.ent, smp.out
    c1, c2, s, lo, hi = model.qp_bounds(sc, e["xest"])
    x, y, z = admm.unscale(sc, sc.scaling, o["xbar"], o["ybar"], o["zbar"])
    rp, rd = admm.ratios(sc, sc.solve, c1, c2, s, lo, hi, x, y, z)
    worst = np.where(np.isfinite(rp) & np.isfinite(rd),
                     np.maximum(rp, rd), np.inf)
    excess = np.maximum(worst - 1.0, 0.0)
    u = model.saturate(sc, first_input(sc, x))
    u_gap = np.abs(smp.ctrl - u).max(-1) / sc.umax
    return excess, worst <= MET, u_gap


def compare(sc: model.Scenario, smp: Samples, detail: dict = None) -> dict:
    """The numbers of ``NUMBERS`` for the samples. ``detail``, where given,
    receives each sample's gaps."""
    e, o = smp.ent, smp.out
    S = len(smp.j)
    flags = 0
    if smp.j.size == 0:
        return dict.fromkeys(NUMBERS, 0.0)
    solving = np.ones(S, bool)  # every sample entered its step alive

    # ---- plant, termination and success
    if sc.loop == "continuous":
        x_ref, x_first, miss = _ticks(sc, e, smp)
        flags += int(miss.sum())
        plant = np.where(miss, 0.0, _state_gap(o["x"], x_ref))
        z = model.range_bearing(x_first)
        ran = o["alive"]  # the carry kept the step's new values
    else:
        term = model.terminated(sc, e["x"])
        border = model.terminated(sc, e["x"], BORDER) != \
            model.terminated(sc, e["x"], -BORDER)
        alive_ref = ~term
        flags += int(((o["alive"] != alive_ref) & ~border).sum())
        solving = o["alive"]
        ok = model.docked_now(sc, e["x"])
        ok_b = model.docked_now(sc, e["x"], BORDER) != \
            model.docked_now(sc, e["x"], -BORDER)
        succ_ref = e["succ"] | (solving & ok & (smp.j >= 1))
        flags += int(((o["succ"] != succ_ref) & ~(ok_b & solving)).sum())
        # a scenario that ends keeps its state
        dead = ~o["alive"]
        flags += int((dead & (o["x"] != e["x"]).any(-1)).sum())
        x_ref = model.cw_step(sc, e["x"], e["prev_u"], smp.noise)
        plant = np.where(solving, _state_gap(o["x"], x_ref), 0.0)
        z = model.range_bearing(o["x"])
        ran = solving

    # ---- estimator
    xe, P = model.ukf_step(sc, e["xest"], e["P"], e["prev_u"], z)
    ukf_x = _state_gap(o["xest"][:, :4], xe[:, :4])
    ukf_d = _rel(o["xest"][:, 4:], xe[:, 4:], sc.d_scale)
    ukf_P = np.abs(o["P"] - P).max((1, 2)) / np.abs(P).max((1, 2))

    # ---- the next QP's data
    c1, c2, s, lo, hi = model.qp_bounds(sc, o["xest"])
    flags += int((ran & ((o["c1"] != c1) | (o["c2"] != c2))).sum())
    pattern = (np.isfinite(o["l"]) != np.isfinite(lo)) | \
        (np.isfinite(o["u"]) != np.isfinite(hi))
    flags += int((ran & pattern.any(-1)).sum())
    fl, fh = np.isfinite(lo) & ~pattern, np.isfinite(hi) & ~pattern
    gl = np.where(fl, np.abs(o["l"] - np.where(fl, lo, 0)) /
                  np.maximum(np.abs(np.where(fl, lo, 0)), 1.0), 0).max(-1)
    gh = np.where(fh, np.abs(o["u"] - np.where(fh, hi, 0)) /
                  np.maximum(np.abs(np.where(fh, hi, 0)), 1.0), 0).max(-1)
    gs = np.abs(o["s"] - s) / np.maximum(np.abs(s), 1.0)
    qp_data = np.maximum(np.maximum(gl, gh), gs)

    # ---- controller: which one ran, the fallback and the integrator
    uf, xi, code_ref = model.failsafe(sc, e["xest_stored"], e["xintf"])
    mpc = smp.code == MPC
    flags += int((solving & (mpc != (smp.status == SOLVED))).sum())
    flags += int((solving & ~mpc & (smp.code != code_ref)).sum())
    flags += int((ran & mpc & (o["xintf"] != 0)).sum())
    fb = ~mpc & solving

    # ---- the solve: its answer against the stopping rule, where the carry
    # kept it (a scenario that ends inside a tick keeps its old iterates)
    excess, met, u_gap = solve_check(sc, smp)
    ok = ran & (smp.status == SOLVED)
    gave_up = ran & (smp.status == MAX_ITER)
    flags += int((gave_up & (met | (smp.iters < least_iters(sc)))).sum())
    fallback = np.maximum(
        np.abs(smp.ctrl - model.saturate(sc, uf)).max(-1) / sc.umax,
        np.where(ran, np.abs(o["xintf"] - xi) / np.maximum(np.abs(xi), 1.0),
                 0.0))

    if detail is not None:
        detail.update(plant=plant, ukf_x=ukf_x, ukf_d=ukf_d, ukf_P=ukf_P,
                      qp_data=qp_data, solve=excess, solve_u=u_gap,
                      fallback=fallback, solving=solving, ran=ran)
    return dict(
        plant=_max(plant[solving]), ukf_x=_max(ukf_x[ran]),
        ukf_d=_max(ukf_d[ran]), ukf_P=_max(ukf_P[ran]),
        qp_data=_max(qp_data[ran]), solve=_max(excess[ok]),
        solve_u=_max(u_gap[ok]), fallback=_max(fallback[fb]),
        flags=float(flags))


def _ticks(sc: model.Scenario, e: dict, smp: Samples):
    """The continuous samples' ticks. Where the program's termination or
    success differs from the reference's, the tick is run again with the
    tests' thresholds moved by ``BORDER`` either way; a scenario that the
    program ends inside the tick is held to the reference's states within
    ``END_SUBSTEPS`` substeps of the one at which the reference ends it (a
    float32 state crosses the threshold a substep apart). Returns (x,
    x_first, miss): each row's reference end state, and ``miss`` where no
    run's termination and success match the program's."""
    o = smp.out
    x, alive, succ, first = model.two_body_tick(
        sc, e["x"], e["prev_u"], smp.ctrl, smp.noise, smp.j, e["succ"])
    miss = (o["alive"] != alive) | (o["succ"] != succ)
    r = np.nonzero(miss)[0]
    for m in (BORDER, -BORDER):
        if not r.size:
            break
        xm, am, sm, _ = model.two_body_tick(
            sc, e["x"][r], e["prev_u"][r], smp.ctrl[r], smp.noise[r],
            smp.j[r], e["succ"][r], margin=m)
        hit = (am == o["alive"][r]) & (sm == o["succ"][r])
        x[r[hit]] = xm[hit]
        miss[r[hit]] = False
        r = r[~hit]
    ended = np.nonzero(~o["alive"] & ~miss)[0]
    if ended.size:
        *_, states = model.two_body_tick(
            sc, e["x"][ended], e["prev_u"][ended], smp.ctrl[ended],
            smp.noise[ended], smp.j[ended], e["succ"][ended], path=True)
        term = np.stack([model.terminated(sc, s_) for s_ in states])
        k_end = np.where(term.any(0), term.argmax(0), len(states) - 1)
        for i, row in enumerate(ended):
            ks = np.arange(max(k_end[i] - END_SUBSTEPS, 0),
                           min(k_end[i] + END_SUBSTEPS + 1, len(states)))
            gaps = _state_gap(o["x"][row], states[ks, i])
            x[row] = states[ks[np.argmin(gaps)], i]
    return x, first, miss


def control_outputs(sc: model.Scenario, smp: Samples) -> Samples:
    """The precision control put in the program's place: every step of the
    samples computed by the reference in the control's arithmetic
    (``precision.CONTROL``) from the same states and inputs, its own ADMM
    (``admm.control_solve``) deciding whether the MPC or the fallback
    runs."""
    p = CONTROL
    e = smp.ent
    qc1, qc2, qs, qlo, qhi = model.qp_bounds(sc, e["xest"], p)
    x_s, y_s, z_s, st, its = admm.control_solve(sc, sc.scaling, sc.solve, qc1,
                                           qc2, qs, qlo, qhi, p)
    conv = st == SOLVED
    u_mpc = model.saturate(sc, first_input(sc, x_s), p)
    uf, xi, code_fb = model.failsafe(sc, e["xest_stored"], e["xintf"], p)
    code = np.where(conv, MPC, code_fb)
    ctrl = np.where(conv[:, None], u_mpc, model.saturate(sc, uf, p))
    o = dict(smp.out)
    if sc.loop == "continuous":
        x, alive, succ, first = model.two_body_tick(
            sc, e["x"], e["prev_u"], ctrl, smp.noise, smp.j, e["succ"], p)
        z = model.range_bearing(first, p)
    else:
        alive = ~model.terminated(sc, e["x"])
        x = np.where(alive[:, None],
                     model.cw_step(sc, e["x"], e["prev_u"], smp.noise, p),
                     e["x"])
        succ = e["succ"] | (alive & model.docked_now(sc, e["x"])
                            & (smp.j >= 1))
        z = model.range_bearing(x, p)
    xe, P = model.ukf_step(sc, e["xest"], e["P"], e["prev_u"], z, p)
    c1, c2, s, lo, hi = model.qp_bounds(sc, xe, p)
    D, E, cst = sc.scaling
    o.update(x=x, alive=alive, succ=succ, xest=xe, P=P, c1=c1, c2=c2, s=s,
             l=lo, u=hi, xintf=np.where(conv, 0.0, xi), prev_u=ctrl,
             xbar=x_s / D, ybar=y_s * cst / E, zbar=z_s * E)
    return smp._replace(out=o, code=code,
                        status=np.where(conv, SOLVED, MAX_ITER), ctrl=ctrl,
                        iters=its)


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit (a NaN is not)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NUMBERS)
