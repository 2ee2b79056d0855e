"""Capture and dissect the fp32 MAX_ITER (plateau-stall) steps of the
production sigma=0.01 rollout.

Port of ``tools/probe_stall.py``: the same configuration, draws, choice
of (step, scenario) pairs and npz keys, so a capture written by either
package is read by the other's ``--analyze`` and ``--resolve-full``. A
plateau step is one of three mechanisms:

  * reported-floor: the fp32 residual COMPUTATION floors above tolerance
    while the iterate's true (fp64-evaluated) residual keeps shrinking;
  * iterate-floor: the fp32 iteration itself stalls in a noise ball above
    tolerance;
  * genuinely-hard: the fp64 oracle ALSO plateaus on this QP from this warm
    state, so it is no fp32 capability gap.

``--dump`` runs the production rollout, picks up to 8 (step, scenario)
MAX_ITER pairs and writes each one's QP inputs and warm state;
``--analyze`` re-solves them warm from that state in fp64 'chol' and in
fp32 'eig' (the production kernel on the card, where the JAX tool emulated
it in interpret mode on a CPU) and evaluates the true primal violations in
fp64; ``--dump-full`` writes the whole batch's carry entering ``--step``
with that step's recorded statuses, and ``--resolve-full`` re-solves it
with the production settings and reports the status agreement.

    python -m mpc_arpo_project_tpu_torch.tools.probe_stall --dump P.npz
    python -m mpc_arpo_project_tpu_torch.tools.probe_stall --analyze P.npz
    python -m mpc_arpo_project_tpu_torch.tools.probe_stall --dump-full F.npz --step 65
    python -m mpc_arpo_project_tpu_torch.tools.probe_stall --resolve-full F.npz

Everything runs on the CUDA device; ``--cpu`` (``device="cpu"``) runs it on
the CPU, and without a CUDA device and without it the tool raises. The
port's closed loop runs step by step whatever ``seg`` says, so a carry is
bit-exact at every step, not only at segment boundaries; ``seg`` keeps
only the JAX tool's choice of boundary steps. One rollout can serve every
capture (``rollout_run`` with the steps to keep).
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.ops.host_synthesis import (
    discretize_np, synth_gains_np)
from mpc_arpo_project_tpu_torch.ops.qp_builder import (
    QPDims, build_qp, materialize_A)
from mpc_arpo_project_tpu_torch.rollout import discrete
from mpc_arpo_project_tpu_torch.tools.status_mix import build_configs

SEED = 20260818
STATUS_NAME = {-1: "dead", 0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER",
               3: "PINF", 4: "DINF"}
STALL = dict(stall_exit_chunks=12, stall_tighten_chunks=24)


def configs(sigma=0.01, T_final=300.0):
    """(sim, mpc, fail, debris) of the reference success-rate configuration
    at noise ``sigma`` (``status_mix.build_configs('ref', sigma)``, the
    JAX tool's ``build``), ``T_final`` s long."""
    sim, mpc, fail, debris = build_configs("ref", sigma)
    return dataclasses.replace(sim, T_final=T_final), mpc, fail, debris


def build(sigma=0.01, T_final=300.0, solve_mode="eig", dtype_str="f32",
          max_iter=4000, device="cuda", **settings):
    """The engine of ``configs(sigma, T_final)`` with the production stall
    settings; ``settings`` are further ``ADMMSettings`` fields. Returns
    (engine, (sim, mpc, fail, debris))."""
    sim, mpc, fail, debris = configs(sigma, T_final)
    st = admm.ADMMSettings(max_iter=max_iter, solve_mode=solve_mode,
                           **STALL, **settings)
    dtype = torch.float32 if dtype_str == "f32" else torch.float64
    eng = discrete.build_engine(sim, mpc, fail, debris, settings=st,
                                dtype=dtype, device=device)
    return eng, (sim, mpc, fail, debris)


def draws(runs=128, seed=SEED, nsim=600, noise_rep=50):
    """The standard-normal draws (nsim // noise_rep + 2, runs, 4) of
    ``RandomState(seed)``: those of ``status_mix`` at the same seed."""
    rng = np.random.RandomState(seed)
    return rng.normal(0.0, 1.0, size=(nsim // noise_rep + 2, runs, 4))


class Run(NamedTuple):
    """A rollout and the carries entering the steps it kept (by step)."""

    engine: discrete.DiscreteEngine
    out: discrete.RolloutOut
    carries: dict


def rollout_run(runs=128, seed=SEED, steps=None, device="cuda", cols=None,
                **build_kw) -> Run:
    """The rollout of ``build(**build_kw)`` (production fp32 'eig' by
    default) on ``draws(runs, seed)`` (columns ``cols`` only, if given),
    keeping the carry entering each step of ``steps`` (every step when
    None). A carry is kept as the rollout made it, on the device: the loop
    builds a new carry each step and changes none in place."""
    eng, _ = build(device=device, **build_kw)
    d = draws(runs, seed, eng.nsim)
    if cols is not None:
        d = d[:, cols]
    noise = discrete.noise_sequence_from_draws(eng, d)
    want = range(1, eng.nsim) if steps is None else set(steps)
    carries = {}

    def keep(done, total, carry):
        if done in want:
            carries[done] = carry

    out = discrete.rollout_chunked(eng, noise, seg=1, progress=keep)
    return Run(eng, out, carries)


def host(v):
    """A tensor as a numpy array on the host."""
    return v.cpu().numpy()


def carry_arrays(carry, rows=None) -> dict:
    """The npz fields of a carry (the JAX tools' keys for the whole batch):
    l, u, c1, c2, s, xbar, ybar, zbar, rho, minv, ref, alive."""
    sel = host if rows is None else (lambda v: host(v)[rows])
    st = carry.admm_state
    return dict(l=sel(carry.l), u=sel(carry.u), c1=sel(carry.c1),
                c2=sel(carry.c2), s=sel(carry.s), xbar=sel(st.xbar),
                ybar=sel(st.ybar), zbar=sel(st.zbar), rho=sel(st.rho_scale),
                minv=sel(st.minv), ref=sel(st.ref_coef),
                alive=sel(carry.alive))


def load_state(prob, settings, d, dtype, device, nz=None, m=None):
    """The warm state of a capture ``d`` on ``prob``, its vectors cut to
    (nz, m) where given (the padded carry on an unpadded problem)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    state = admm.init_state(prob, d["l"].shape[0], settings)._replace(
        xbar=t(d["xbar"][:, :nz]), ybar=t(d["ybar"][:, :m]),
        zbar=t(d["zbar"][:, :m]), rho_scale=t(d["rho"]))
    if settings.solve_mode != "eig":
        return state
    return state._replace(minv=t(d["minv"]), ref_coef=t(d["ref"]),
                          minv_ok=torch.ones((), dtype=torch.bool,
                                             device=device))


def choose(status, success, seg=10, late=False, n=8):
    """Up to ``n`` (step, scenario) pairs: per non-docking scenario its
    earliest (``late``: latest) MAX_ITER step on a multiple of ``seg``,
    the scenarios ordered by that step (the JAX tool's choice)."""
    mi_t, mi_b = np.nonzero(status == 2)
    boundary = mi_t % seg == 0
    chosen = {}
    for t, b in zip(mi_t[boundary], mi_b[boundary]):
        b, t = int(b), int(t)
        if not success[b]:
            prev = chosen.get(b)
            chosen[b] = t if prev is None else (max(prev, t) if late
                                                else min(prev, t))
    pairs = sorted(chosen.items(), key=lambda kv: kv[1])[:n]
    return [(t, b) for b, t in pairs]


def dump(path, runs=128, seed=SEED, seg=10, late=False, device="cuda",
         run: Optional[Run] = None) -> dict:
    """Write the QP inputs and warm state of the chosen MAX_ITER (step,
    scenario) pairs of the production rollout (``run``, else a new one) to
    ``path``: per scenario b the keys ``{b}_t``, ``{b}_l``, ... and
    ``scenarios``. Returns the counts and the pairs."""
    # the carries of the boundary steps only: the choice takes no other
    probe = run or rollout_run(runs, seed, steps=range(seg, 10 ** 6, seg),
                               device=device)
    st = host(probe.out.status)
    succ = host(probe.out.success)
    n_mi = int((st == 2).sum())
    print(f"MAX_ITER steps: {n_mi}; success {int(succ.sum())}/{st.shape[1]}")
    chosen = choose(st, succ, seg, late)
    print("chosen (step, scenario):", chosen)
    if not chosen:
        print("nothing to probe")
        return dict(n_max_iter=n_mi, n_success=int(succ.sum()), chosen=[])
    data = {}
    for t, b in chosen:
        data[f"{b}_t"] = np.asarray(t)
        for k, v in carry_arrays(probe.carries[t], b).items():
            data[f"{b}_{'rho_scale' if k == 'rho' else k}"] = v
    data["scenarios"] = np.asarray([b for _, b in chosen])
    np.savez(path, **data)
    print(f"wrote {path}")
    return dict(n_max_iter=n_mi, n_success=int(succ.sum()), chosen=chosen)


def res_ratio(res, tol, floor):
    """res / max(tol, floor) on the host in float64."""
    return host(res / tol.clamp(min=floor)).astype(np.float64)


def analyze(path, device="cuda") -> dict:
    """Re-solve the dumped steps warm from the production carry in fp64
    'chol' and in fp32 'eig' (with the carried inner inverse), and evaluate
    each final iterate's true primal violation on the unscaled fp64
    problem. Returns the statuses, iterations, residual/tolerance ratios,
    violations and the control deviation |u32 - u64| per scenario."""
    device = admm.resolve_device(device)
    d = np.load(path)
    scen = d["scenarios"]
    sim, mpc, fail, debris = configs()
    Ad, Bd = discretize_np(sim.mean_mtn, sim.time_stp, False)
    K, QN, *_ = synth_gains_np(Ad, Bd, mpc, fail)
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)
    g = lambda k: np.stack([d[f"{b}_{k}"] for b in scen])
    steps = [int(d[f"{b}_t"]) for b in scen]
    print("probe steps:", steps)
    print("s coeffs:", g("s").round(4))

    cap = {k: g(k) for k in ("l", "u", "c1", "c2", "s", "xbar", "ybar",
                             "zbar", "minv", "ref")}
    cap["rho"] = g("rho_scale")

    def arm(solve_mode, dtype, **kw):
        st = admm.ADMMSettings(solve_mode=solve_mode, max_iter=4000,
                               **STALL, **kw)
        # pad=True: the carry comes from the padded fp32 'eig' engine
        # (nz 201 -> 256, m 406 -> 512); padding leaves solutions unchanged
        prob = admm.prepare_problem(static, dims, settings=st, dtype=dtype,
                                    pad=True, device=device)
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        return admm.admm_solve(prob, tuple(t(cap[k]) for k in ("c1", "c2",
                                                               "s")),
                               t(cap["l"]), t(cap["u"]),
                               load_state(prob, st, cap, dtype, device), st)

    # arm A: fp64 chol warm-started from the production fp32 carry
    r64 = arm("chol", torch.float64)
    # arm B: fp32 eig from the same carry, its inner inverse included (the
    # JAX tool's tile of 4)
    r32 = arm("eig", torch.float32, pallas_tile=4)
    rep = dict(steps=steps, scenarios=scen.tolist())
    for name, r, floor in (("fp64 chol warm", r64, 1e-300),
                           ("fp32 eig warm", r32, 1e-30)):
        key = name.split()[0]
        rep[f"status_{key}"] = host(r.status).tolist()
        rep[f"iters_{key}"] = host(r.done_iters).tolist()
        rep[f"rp_tol_{key}"] = res_ratio(r.pri_res, r.pri_tol, floor).tolist()
        rep[f"rd_tol_{key}"] = res_ratio(r.dua_res, r.dua_tol,
                                         floor).tolist()
        print(f"{name}: status {np.asarray(rep[f'status_{key}'])} iters "
              f"{np.asarray(rep[f'iters_{key}'])}")
        print("  rp/tol", np.round(rep[f"rp_tol_{key}"], 2),
              "rd/tol", np.round(rep[f"rd_tol_{key}"], 2))

    # true fp64 residuals of each final iterate on the unscaled problem
    iu = (dims.Nx + 1) * 4
    l, u, c = cap["l"], cap["u"], (cap["c1"], cap["c2"], cap["s"])
    x32 = host(r32.x).astype(np.float64)
    x64 = host(r64.x).astype(np.float64)
    rep.update(pviol_fp32=[], pviol_fp64=[], du=[])
    for i, b in enumerate(scen):
        A = materialize_A(static, *[float(ci[i]) for ci in c])
        n = A.shape[1]
        viol = lambda x: float(max(np.maximum(A @ x - u[i], 0).max(),
                                   np.maximum(l[i] - A @ x, 0).max()))
        p32, p64 = viol(x32[i, :n]), viol(x64[i, :n])
        du = float(np.abs(x32[i, iu:iu + 2] - x64[i, iu:iu + 2]).max())
        rep["pviol_fp32"].append(p32)
        rep["pviol_fp64"].append(p64)
        rep["du"].append(du)
        print(f"scen {b}: true prim viol fp32 {p32:.3e} vs fp64 {p64:.3e}"
              f"  control dev |u32-u64| {du:.3e}")
    return rep


def save_full(path, carry, status, step, **extra):
    """Write a whole batch's carry entering ``step`` with that step's
    recorded ``status`` (the JAX tools' keys)."""
    np.savez(path, **carry_arrays(carry), status=status, step=np.asarray(step),
             **extra)


def dump_full(path, step=65, runs=128, seed=SEED, device="cuda",
              run: Optional[Run] = None) -> dict:
    """Write the full carry entering ``step`` of the production rollout
    (``run``, else a new one) and that step's recorded statuses. Returns
    the status counts."""
    if run is None:
        run = rollout_run(runs, seed, steps=[step], device=device)
    st = host(run.out.status)[step]
    save_full(path, run.carries[step], st, step)
    counts = dict(zip(*[a.tolist() for a in np.unique(st,
                                                      return_counts=True)]))
    print(f"wrote {path}: step {step}, statuses {counts}")
    return counts


def resolve_full(path, device="cuda") -> dict:
    """Re-solve a ``dump_full`` capture with the production engine's
    problem and settings (fp32 'eig'; the engine pins the Ruiz scaling to
    the scenario's nominal coefficients) and compare the statuses with
    the recorded ones on the alive rows."""
    device = admm.resolve_device(device)
    d = np.load(path)
    eng, _ = build(device=device)
    prob, st = eng.prob, eng.settings
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    alive = d["alive"]
    r = admm.admm_solve(prob, (t(d["c1"]), t(d["c2"]), t(d["s"])),
                        t(d["l"]), t(d["u"]),
                        load_state(prob, st, d, torch.float32, device), st,
                        active=torch.as_tensor(alive, device=device))
    got, rec = host(r.status), d["status"]
    agree = float((got[alive] == rec[alive]).mean())
    print("device:", device)
    print(f"status agreement on alive rows: {agree:.4f}")
    counts = {}
    for code, nm in ((1, "SOLVED"), (2, "MAX_ITER"), (3, "PINF")):
        counts[nm] = dict(recorded=int((rec[alive] == code).sum()),
                          resolved=int((got[alive] == code).sum()))
        print(f"  {nm}: recorded {counts[nm]['recorded']}  "
              f"re-solved {counts[nm]['resolved']}")
    mi = np.nonzero(alive & (rec == 2))[0]
    to = dict(zip(*[a.tolist() for a in np.unique(got[mi],
                                                  return_counts=True)]))
    iters = host(r.done_iters)[mi].tolist()
    print("recorded-MAX_ITER rows re-solve to:", to)
    print("their done_iters:", iters)
    return dict(agreement=agree, n_alive=int(alive.sum()), counts=counts,
                max_iter_rows_resolve_to=to, max_iter_rows_done_iters=iters)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--analyze", default=None)
    ap.add_argument("--dump-full", default=None)
    ap.add_argument("--resolve-full", default=None)
    ap.add_argument("--step", type=int, default=65)
    ap.add_argument("--seg", type=int, default=10,
                    help="--dump picks MAX_ITER steps on multiples of it")
    ap.add_argument("--late", action="store_true",
                    help="--dump picks each scenario's latest such step")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; without "
                         "one the tool raises)")
    args = ap.parse_args(argv)
    device = admm.resolve_device("cpu" if args.cpu else "cuda")
    if args.dump:
        return dump(args.dump, seg=args.seg, late=args.late, device=device)
    if args.analyze:
        return analyze(args.analyze, device)
    if args.dump_full:
        return dump_full(args.dump_full, args.step, device=device)
    if args.resolve_full:
        return resolve_full(args.resolve_full, device)
    ap.error("one of --dump, --analyze, --dump-full, --resolve-full")


if __name__ == "__main__":
    main()
