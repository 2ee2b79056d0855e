"""Port of ``tools/deviation_bench.py:1-211``: the BASELINE deviation
harness, the maximum control deviation against the OSQP-algorithm oracle.

Runs the oracle closed-loop simulator over a scenario, records the exact QP
data (bounds + dynamic coefficients) of every control step, then solves the
same QP sequence with the port's batched solver (``ops.admm.admm_solve``,
warm-started through the sequence exactly like the rollout does) and
reports the maximum deviation of the extracted control input: the
BASELINE.json "max control deviation vs OSQP" metric, measured per solve
so closed-loop chaos cannot inflate it.

Ground truth per step: the oracle re-solved at tight tolerance + polish.

    python -m mpc_arpo_project_tpu_torch.tools.deviation_bench \\
        [--mode chol|pallas|eig] [--steps 60] [--dtype f32|f64] \\
        [--accurate | --accurate-f32] [--cpu]
    python -m mpc_arpo_project_tpu_torch.tools.deviation_bench --record FILE.npz
    python -m mpc_arpo_project_tpu_torch.tools.deviation_bench --replay FILE.npz \\
        --mode eig --dtype f32

The recorder (``tools/ref_sim.py`` and ``tools/osqp_ref.py`` of the port,
polished ground truth) is host numpy in fp64 and runs nowhere else. The
solves run on the card by default and on the CPU only with ``--cpu``:
the JAX tool's default was the CPU, with ``--tpu`` to use the chip, and the
port turns that round, as all its entry points do. Without a CUDA device
and without ``--cpu`` a solve raises. One process records and replays (the
JAX tool needed two because its backends are process-global).

The JAX tool widened the single problem to a batch of 8 identical rows on
the TPU only because Mosaic needs 8-row blocks
(``tools/deviation_bench.py:169-175``). The port's 'eig' and 'pallas'
kernels take a batch of one (a slot group of width 1), so every mode
solves B=1.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.ops.host_synthesis import (
    configure_dynamic_np, discretize_np, synth_gains_np)
from mpc_arpo_project_tpu_torch.ops.qp_builder import QPDims, build_qp
from mpc_arpo_project_tpu_torch.tools import ref_sim
from mpc_arpo_project_tpu_torch.tools.osqp_ref import OSQPRef

# the solver tolerances of the JAX tool's default run, ``--accurate`` and
# ``--accurate-f32``
TOLERANCES = {
    "default": {},
    "accurate": dict(eps_abs=1e-5, eps_rel=1e-10, max_iter=10000),
    "accurate-f32": dict(eps_abs=1e-5, eps_rel=1e-6, max_iter=20000),
}
# the first control input's offset in the decision vector, (Nx + 1) * nx
I0U = (radial_config()[1].Nx + 1) * 4


def problem_setup(steps=60):
    """The scenario (radial, noisy, ``steps`` control steps), its static QP
    and the nominal dynamic coefficients of its first step: (configs,
    dims, static, nominal (c1, c2, -slope))."""
    sim, mpc, fail, debris = radial_config(noisy=True, T_final=steps * 0.5)
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)
    Ad, Bd = discretize_np(sim.mean_mtn, sim.time_stp, sim.isDeltaV)
    K, QN, *_ = synth_gains_np(Ad, Bd, mpc, fail)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)
    c1_0, c2_0, s0, _, _ = configure_dynamic_np(
        sim, debris, np.concatenate([sim.x0, [0.0, 0.0]]))
    return (sim, mpc, fail, debris), dims, static, (c1_0, c2_0, -s0)


def record(steps=60, seed=3):
    """Run the oracle closed loop for ``steps`` control steps and record
    every ``OSQPRef`` solve (``tools/deviation_bench.py:91-152``): a dict of
    the bounds ``l``, ``u`` (n, m), the dynamic coefficients ``coeffs``
    (n, 3) read from the recorded constraint matrices, and ``u_true`` (n, 2),
    the first control input of the oracle re-solved at tight tolerance and
    polished. Host numpy, fp64."""
    cfg, dims, static, _ = problem_setup(steps)
    solves = []
    orig_init, orig_solve, orig_update = (OSQPRef.__init__, OSQPRef.solve,
                                          OSQPRef.update)

    def recording_solve(self):
        solves.append(
            dict(l=self.l.copy(), u=self.u.copy(), A=self._rec_A.copy()
                 if hasattr(self, "_rec_A") else None)
        )
        return orig_solve(self)

    def recording_update(self, l=None, u=None, A=None):
        if A is not None:
            self._rec_A = np.asarray(A)
        return orig_update(self, l=l, u=u, A=A)

    def recording_init(self, P, q, A, l, u, **kw):
        orig_init(self, P, q, A, l, u, **kw)
        self._rec_A = np.asarray(A)

    OSQPRef.__init__ = recording_init
    OSQPRef.solve = recording_solve
    OSQPRef.update = recording_update
    try:
        run = ref_sim.simulate_discrete(*cfg, seed=seed)
    finally:
        OSQPRef.__init__ = orig_init
        OSQPRef.solve = orig_solve
        OSQPRef.update = orig_update

    print(f"recorded {len(solves)} QP solves from the oracle closed loop "
          f"(statuses: {dict((s, run.statuses.count(s)) for s in set(run.statuses))})")

    # dynamic coefficients per step from the recorded A matrices
    fr0, vx0 = static.fun_rows[0], static.velx_cols[0]
    dr0, px0 = static.deb_rows[0], static.posx_cols[0]
    coeffs = np.array(
        [
            (s_["A"][fr0, vx0], s_["A"][fr0, static.vely_cols[0]], s_["A"][dr0, px0])
            for s_ in solves
        ]
    )
    i0r = (dims.Nx + 1) * 4

    def _truth(s_):
        oracle = OSQPRef(static.P, static.q, s_["A"], s_["l"], s_["u"],
                         eps_abs=1e-6, eps_rel=1e-10, max_iter=60000)
        return oracle.polish(oracle.solve()).x[i0r: i0r + 2]

    return dict(l=np.stack([s_["l"] for s_ in solves]),
                u=np.stack([s_["u"] for s_ in solves]), coeffs=coeffs,
                u_true=np.stack([_truth(s_) for s_ in solves]))


def prepare(mode, dtype, device="cuda", tolerances="default"):
    """The port's prepared problem of the scenario and the solver settings
    of ``mode`` at ``tolerances`` (a key of ``TOLERANCES``), on ``device``
    (the CUDA device unless the caller asks for the CPU): (prob,
    settings)."""
    settings = admm.ADMMSettings(solve_mode=mode, **TOLERANCES[tolerances])
    _, dims, static, nominal = problem_setup()
    prob = admm.prepare_problem(static, dims, settings,
                                nominal_coeffs=nominal, dtype=dtype,
                                pad=(mode in ("pallas", "eig")), device=device)
    return prob, settings


def replay(prob, settings, ls, us, coeffs, u_trues):
    """Solve the recorded sequence with ``admm_solve`` on ``prob``'s device
    and dtype, one problem warm-started through the sequence
    (``tools/deviation_bench.py:177-193``): returns (deviations, statuses),
    each (n,), the max-abs deviation of the first control input from
    ``u_trues`` and the solver status of each step."""
    kw = dict(dtype=prob.Pbar.dtype, device=prob.Pbar.device)
    state = admm.init_state(prob, 1, settings)
    devs, statuses = [], []
    for k in range(ls.shape[0]):
        cc = tuple(torch.full((1,), float(c), **kw) for c in coeffs[k])
        lk = torch.as_tensor(ls[k], **kw)[None]
        uk = torch.as_tensor(us[k], **kw)[None]
        res = admm.admm_solve(prob, cc, lk, uk, state, settings)
        state = res.state
        u = res.x[0, I0U: I0U + 2].cpu().double().numpy()
        devs.append(float(np.abs(u - u_trues[k]).max()))
        statuses.append(int(res.status[0]))
    return np.asarray(devs), np.asarray(statuses)


def summary(devs, statuses):
    """Converged count, and max and median deviation of the converged and
    of the max-iter steps (None where there are none)."""
    solved = statuses == admm.SOLVED
    part = lambda d: (dict(n=int(d.size), max=float(d.max()),
                           median=float(np.median(d))) if d.size else None)
    return dict(steps=int(devs.size), converged=part(devs[solved]),
                max_iter=part(devs[~solved]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", default="chol", choices=["chol", "pallas", "eig"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dtype", default="f64", choices=["f32", "f64"])
    ap.add_argument("--accurate", action="store_true",
                    help="accuracy-mode solver settings (tighter eps)")
    ap.add_argument("--accurate-f32", action="store_true",
                    help="fp32-reachable accuracy mode: eps_abs=1e-5, "
                         "eps_rel=1e-6 (eps_rel=1e-10 sits below fp32 eps, "
                         "so --accurate never converges in fp32)")
    ap.add_argument("--cpu", action="store_true",
                    help="solve on the CPU (default: the CUDA device; "
                         "without one the solve raises)")
    ap.add_argument("--record", default=None,
                    help="record the oracle QP sequence + polished ground "
                         "truth to this npz and exit (host numpy)")
    ap.add_argument("--replay", default=None,
                    help="solve a --record'ed sequence instead of running "
                         "the oracle")
    args = ap.parse_args(argv)

    if args.record:
        np.savez(args.record, **record(args.steps))
        print(f"wrote {args.record}")
        return None
    # the solve's device first: no oracle run before a refusal
    device = admm.resolve_device("cpu" if args.cpu else "cuda")
    if args.replay:
        with np.load(args.replay) as f:
            rec = {k: f[k] for k in ("l", "u", "coeffs", "u_true")}
    else:
        rec = record(args.steps)
    n_steps = rec["l"].shape[0]
    dtype = torch.float64 if args.dtype == "f64" else torch.float32
    tol = ("accurate" if args.accurate else
           "accurate-f32" if args.accurate_f32 else "default")
    prob, settings = prepare(args.mode, dtype, device, tol)
    print(f"solving {n_steps} recorded QP solves on {prob.Pbar.device}")
    devs, statuses = replay(prob, settings, rec["l"], rec["u"],
                            rec["coeffs"], rec["u_true"])
    s = summary(devs, statuses)
    print(f"mode={args.mode} dtype={args.dtype} tolerances={tol}:")
    if s["converged"]:
        c = s["converged"]
        print(f"  converged steps ({c['n']}/{n_steps}): control deviation "
              f"max={c['max']:.3e} median={c['median']:.3e}")
    if s["max_iter"]:
        # steps that exhausted max_iter before the tolerance (degenerate
        # active sets): the returned iterate's deviation anyway
        c = s["max_iter"]
        print(f"  max-iter steps ({c['n']}/{n_steps}): deviation "
              f"max={c['max']:.3e} median={c['median']:.3e}")
    return s["converged"]["max"] if s["converged"] else float("nan")


if __name__ == "__main__":
    main()
