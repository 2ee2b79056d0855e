"""Where the production closed loop first leaves the fp64 oracle's: the
sigma=0.01 docking-gap dissection.

Port of ``tools/first_divergence.py``. ``probe_stall`` showed the captured
MAX_ITER plateau steps to be hard for the fp64 oracle too, so the gap must
open earlier: the production trajectory diverges from the oracle's and then
wanders into the hard states. This tool finds that first divergence:

  --prod P.npz      production fp32 'eig' rollout, per-step telemetry
  --oracle O.npz    fp64 'chol' oracle rollout on --cols columns of the
                    SAME draw matrix (sliced as ``status_mix --shard`` does)
                    (``--mode``, ``--dtype`` and ``--set FIELD=VALUE``, a
                    solver setting, run another arm in place of either:
                    e.g. ``--oracle E.npz --cols ... --mode eig --dtype
                    f64`` is fp64 'eig' on the gap columns, which tells
                    precision from iterate path)
  --summary F...    (host) each rollout file's docked count, status mix
                    and mean ADMM iterations a step
  --compare P O     (host) the first step where each scenario's status
                    sequences differ, which arm docked, and the kinds of
                    first flip (MAX_ITER where SOLVED, PINF where SOLVED...)
  --capture C.npz --scen b --step t   the carry entering step t
  --resolve C.npz   re-solve of the captured step from the identical carry:
                    fp32 'eig' (production) against fp64 'chol', and the fp32
                    final iterate's residuals evaluated in fp64

The draws, the npz keys and their shapes are the JAX tool's, so a file
written by either package is read by the other. Unlike the JAX tool, which
ran the production rollout on the TPU and the oracle on a CPU, every arm
runs on the CUDA device (``--cpu``: on the CPU; without a CUDA device and
without it the tool raises), and one rollout can serve ``--prod``,
``--capture`` and ``probe_stall.dump`` (pass ``run=``). ``--resolve`` runs
the production settings as they are (the JAX tool cut the tile to 4 for
its interpret mode).

A status flip is the only channel through which solver arithmetic can
change the trajectory (identical draws are injected by construction):
fp64 OSQP statuses drive the reference's failsafe switch.
"""

from __future__ import annotations

import argparse
import ast
from typing import Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.tools.probe_stall import (
    STATUS_NAME, Run, build, host, load_state, res_ratio, rollout_run,
    save_full)


def _save_run(path, out, cols):
    np.savez(path, status=host(out.status), i_term=host(out.i_term),
             success=host(out.success), ctrl_seq=host(out.ctrl_seq),
             x_true=host(out.x_true), x_est=host(out.x_est),
             iters=host(out.iters), pri_res=host(out.pri_res),
             dua_res=host(out.dua_res), cols=np.asarray(cols))
    print(f"wrote {path}: success {int(out.success.sum())}/{len(cols)}")
    return summary(path)


def summary(path) -> dict:
    """A rollout file's docked count, alive steps, status mix of the alive
    steps and mean ADMM iterations a step (the batch's most, over all
    steps); printed and returned."""
    d = np.load(path)
    st = d["status"]
    alive = int((st >= 0).sum())
    rep = dict(path=path, runs=int(st.shape[1]),
               n_success=int(d["success"].sum()), alive_steps=alive,
               mix={STATUS_NAME[k]: float((st == k).sum() / max(alive, 1))
                    for k in (1, 2, 3, 4)},
               mean_iters_per_step=float(d["iters"].mean()))
    print(rep)
    return rep


def run_prod(path, runs=128, device="cuda", run: Optional[Run] = None,
             **build_kw):
    """The production fp32 'eig' rollout (``run``, else a new one with
    ``probe_stall.build(**build_kw)``) on the draws of ``runs`` scenarios,
    written to ``path``."""
    run = run or rollout_run(runs, steps=(), device=device, **build_kw)
    return _save_run(path, run.out, np.arange(run.out.success.shape[0]))


def run_oracle(path, cols, runs=128, device="cuda", run: Optional[Run] = None,
               **build_kw):
    """The fp64 'chol' oracle rollout (``run``, else a new one; another arm
    with ``probe_stall.build(**build_kw)``) on columns ``cols`` of the draws
    of ``runs`` scenarios, written to ``path``."""
    build_kw = dict(dict(solve_mode="chol", dtype_str="f64"), **build_kw)
    run = run or rollout_run(runs, steps=(), device=device, cols=cols,
                             **build_kw)
    return _save_run(path, run.out, cols)


def compare(prod_path, oracle_path):
    """Per oracle column: the first step where the status sequences
    differ, the two statuses there, each arm's success and termination
    step (``prod_path`` holds every scenario, or the oracle's columns from
    another arm). Prints them, the kinds of first flip and the gap scenarios (the
    oracle docks, production does not); returns the records."""
    p = np.load(prod_path)
    o = np.load(oracle_path)
    cols = o["cols"]
    # the prod file's column of each oracle column (the prod file may hold
    # all scenarios or, from another arm, the oracle's columns only)
    at = {int(c): i for i, c in enumerate(p["cols"])}
    pj = [at[int(b)] for b in cols]
    ps, os_ = p["status"][:, pj], o["status"]  # (T, n)
    flips = []
    for j, b in enumerate(cols):
        d = np.nonzero(ps[:, j] != os_[:, j])[0]
        t = int(d[0]) if len(d) else None
        rec = dict(
            scen=int(b), t_first=t,
            prod=STATUS_NAME[int(ps[t, j])] if t is not None else None,
            oracle=STATUS_NAME[int(os_[t, j])] if t is not None else None,
            prod_success=bool(p["success"][pj[j]]),
            oracle_success=bool(o["success"][j]),
            prod_i_term=int(p["i_term"][pj[j]]),
            oracle_i_term=int(o["i_term"][j]),
        )
        flips.append(rec)
        print(rec)
    print("\nfirst-flip kinds:", flip_kinds(flips))
    gap = gap_scenarios(flips)
    print(f"gap scenarios (oracle docks, production doesn't): "
          f"{[r['scen'] for r in gap]}")
    for r in gap:
        print(f"  scen {r['scen']}: first flip at t={r['t_first']} "
              f"prod={r['prod']} oracle={r['oracle']}")
    return flips


def flip_kinds(flips) -> dict:
    """How many columns first flip in each (prod, oracle) status pair."""
    kinds = {}
    for r in flips:
        if r["t_first"] is None:
            k = "identical-status-sequences"
        else:
            k = f"prod={r['prod']} where oracle={r['oracle']}"
        kinds[k] = kinds.get(k, 0) + 1
    return kinds


def gap_scenarios(flips) -> list:
    """The records of the columns the oracle docks and production does
    not."""
    return [r for r in flips if r["oracle_success"] and not r["prod_success"]]


def capture(path, scen, step, runs=128, device="cuda",
            run: Optional[Run] = None):
    """Write the production rollout's carry entering ``step`` (from ``run``
    if it kept it, else from a new rollout), that step's recorded statuses
    and the scenario ``scen`` to ``path``. Returns the scenario's status."""
    if run is None or step not in run.carries:
        run = rollout_run(runs, steps=[step], device=device)
    st = host(run.out.status)[step]
    save_full(path, run.carries[step], st, step, scen=np.asarray(scen))
    name = STATUS_NAME[int(st[scen])]
    print(f"wrote {path}: step {step} scen {scen} "
          f"recorded prod status {name}")
    return name


def _report(label, r, rows, floor):
    rp = res_ratio(r.pri_res, r.pri_tol, floor)
    rd = res_ratio(r.dua_res, r.dua_tol, floor)
    st, it = host(r.status), host(r.done_iters)
    rep = dict(status=[STATUS_NAME[int(st[b])] for b in rows],
               iters=[int(it[b]) for b in rows],
               rp_tol=[float(rp[b]) for b in rows],
               rd_tol=[float(rd[b]) for b in rows])
    rep["n_solved"] = rep["status"].count("SOLVED")
    for i, b in enumerate(rows):
        print(f"{label} scen {b}: status {rep['status'][i]} iters "
              f"{rep['iters'][i]} rp/tol {rep['rp_tol'][i]:.3g} "
              f"rd/tol {rep['rd_tol'][i]:.3g}")
    return rep


def resolve(path, device="cuda") -> dict:
    """Re-solve the captured step from the identical carry: fp32 'eig'
    (production) and fp64 'chol' (the oracle), each on its engine's problem
    (the engines pin the Ruiz scaling to nominal coefficients; see
    ``probe_stall.resolve_full``), reported on every alive row recorded
    MAX_ITER at this step and the captured scenario; then the fp32 final
    iterate's residuals evaluated in fp64 on the fp64 problem (a reported
    floor when they are at or below tolerance there)."""
    device = admm.resolve_device(device)
    d = np.load(path)
    rows = sorted(set(np.nonzero(d["alive"] & (d["status"] == 2))[0].tolist())
                  | {int(d["scen"])})
    recorded = dict(zip(*[a.tolist() for a in np.unique(
        d["status"][d["alive"]], return_counts=True)]))
    print(f"recorded statuses at step {int(d['step'])}: {recorded}")
    print(f"probing rows: {rows}")
    active = torch.as_tensor(d["alive"], device=device)
    rep = dict(step=int(d["step"]), scen=int(d["scen"]), rows=rows,
               recorded=recorded)

    # fp32 'eig', the production engine, on the padded carry as it is
    eng, _ = build(device=device)
    t32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    r32 = admm.admm_solve(eng.prob, (t32(d["c1"]), t32(d["c2"]), t32(d["s"])),
                          t32(d["l"]), t32(d["u"]),
                          load_state(eng.prob, eng.settings, d, torch.float32,
                                     device), eng.settings, active=active)
    rep["fp32 eig"] = _report("fp32 eig (production)", r32, rows, 1e-30)

    # fp64 'chol': the engine is unpadded (nz=201, m=406) and the carry
    # padded (256/512); the Ruiz scalings agree on the overlap to fp32
    # rounding, so the cut warm state is an exact warm start (the padded
    # coordinates are inert zeros)
    eng, _ = build(solve_mode="chol", dtype_str="f64", device=device)
    prob, st = eng.prob, eng.settings
    nz, m = prob.Pbar.shape[0], prob.A0bar.shape[0]
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
    coeffs = (t64(d["c1"]), t64(d["c2"]), t64(d["s"]))
    r64 = admm.admm_solve(prob, coeffs, t64(d["l"][:, :m]),
                          t64(d["u"][:, :m]),
                          load_state(prob, st, d, torch.float64, device, nz,
                                     m), st, active=active)
    rep["fp64 chol"] = _report("fp64 chol (oracle)", r64, rows, 1e-300)

    # reported floor or iterate floor: the fp32 final iterate's residuals
    # evaluated in fp64 on the fp64 problem
    x32 = r32.state.xbar[:, :nz].double()
    y32 = r32.state.ybar[:, :m].double()
    z32 = r32.state.zbar[:, :m].double()
    qbar = prob.qbar.expand(x32.shape[0], -1)
    Ax = admm._matvec_A(prob, coeffs, x32)
    rp = (prob.Einv * (Ax - z32)).abs().amax(1)
    rp_rel = torch.maximum((prob.Einv * Ax).abs().amax(1),
                           (prob.Einv * z32).abs().amax(1))
    Px = x32 @ prob.Pbar
    Aty = admm._matvec_AT(prob, coeffs, y32)
    cinv = 1.0 / prob.c
    rd = cinv * (prob.Dinv * (Px + qbar + Aty)).abs().amax(1)
    rd_rel = cinv * torch.maximum(
        (prob.Dinv * Px).abs().amax(1),
        torch.maximum((prob.Dinv * Aty).abs().amax(1),
                      (prob.Dinv * qbar).abs().amax(1)))
    tp = st.eps_abs + st.eps_rel * rp_rel
    td = st.eps_abs + st.eps_rel * rd_rel
    rp_t, rd_t = host(rp / tp), host(rd / td)
    rep["fp64 re-evaluation of fp32"] = dict(
        rp_tol=[float(rp_t[b]) for b in rows],
        rd_tol=[float(rd_t[b]) for b in rows])
    print("fp64 re-evaluation of the fp32 FINAL iterate:")
    for b in rows:
        print(f"  scen {b}: rp64/tol {rp_t[b]:.3g} rd64/tol {rd_t[b]:.3g}")
    return rep


def _setting(ap, text):
    """(field, value) of a ``--set FIELD=VALUE``: the value as a Python
    literal where it is one, else the string."""
    field, _, value = text.partition("=")
    if field not in admm.ADMMSettings._fields or not value:
        ap.error(f"--set {text!r}: not FIELD=VALUE of an ADMMSettings field")
    try:
        return field, ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return field, value


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--prod", default=None)
    ap.add_argument("--oracle", default=None)
    ap.add_argument("--cols", default=None,
                    help="comma-separated scenario columns for --oracle")
    ap.add_argument("--compare", nargs=2, default=None)
    ap.add_argument("--summary", nargs="+", default=None,
                    help="(host) each rollout file's docked count, status "
                         "mix and mean iterations a step")
    ap.add_argument("--capture", default=None)
    ap.add_argument("--scen", type=int, default=None)
    ap.add_argument("--step", type=int, default=None)
    ap.add_argument("--resolve", default=None)
    ap.add_argument("--mode", default=None, choices=("eig", "chol", "pallas"),
                    help="another solve mode for --prod or --oracle")
    ap.add_argument("--dtype", default=None, choices=("f32", "f64"),
                    help="another dtype for --prod or --oracle")
    ap.add_argument("--set", action="append", default=[],
                    metavar="FIELD=VALUE",
                    help="an ADMMSettings field of the --prod or --oracle "
                         "arm (repeatable), e.g. eig_rescue_mode=near")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the CUDA device; without "
                         "one the tool raises)")
    args = ap.parse_args(argv)
    if args.compare:
        return compare(*args.compare)
    if args.summary:
        return [summary(p) for p in args.summary]
    device = admm.resolve_device("cpu" if args.cpu else "cuda")
    arm = dict(_setting(ap, v) for v in args.set)
    arm.update({k: v for k, v in (("solve_mode", args.mode),
                                  ("dtype_str", args.dtype)) if v})
    if args.prod:
        return run_prod(args.prod, device=device, **arm)
    if args.oracle:
        return run_oracle(args.oracle, [int(v) for v in args.cols.split(",")],
                          device=device, **arm)
    if args.capture:
        return capture(args.capture, args.scen, args.step, device=device)
    if args.resolve:
        return resolve(args.resolve, device)
    ap.error("one of --prod, --oracle, --compare, --capture, --resolve")


if __name__ == "__main__":
    main()
