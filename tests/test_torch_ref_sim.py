"""The port's oracles (``mpc_arpo_project_tpu_torch/tools/osqp_ref.py`` and
``tools/ref_sim.py``) against the JAX package's (``tools/osqp_ref.py``,
``tools/ref_sim.py``): host numpy in fp64 on both sides, so every result
must be equal, bit for bit.

* ``OSQPRef`` on the radial QP (Nx=40, nz=201, m=406): solved from its own
  Ruiz scaling, re-solved after an ``update`` of the bounds and the
  constraint matrix, warm-started from a perturbed solution, polished, and
  in the forced primal-infeasible case (a debris lower bound of 1e3); and
  pinned to a given scaling with boundary-only rho adaptation and the stall
  exit, as the closed-loop parity tests run it.
* ``simulate_discrete``, noisy radial and noisy in-track (the in-track
  estimate swap), T_final 10 s: every ``OracleRun`` field.
* ``simulate_continuous``, noisy radialC, T_final 3 s: the returned dict.

The JAX references are computed in module-scoped fixtures. Each package
gets its own configuration objects from its own ``examples/common.py``.
"""

import dataclasses

import numpy as np
import pytest
from threadpoolctl import threadpool_limits

from examples import common as jcommon
from tools import osqp_ref as josqp
from tools import ref_sim as jref
from mpc_arpo_project_tpu_torch.config import Noise as TNoise
from mpc_arpo_project_tpu_torch.examples import common as tcommon
from mpc_arpo_project_tpu_torch.ops.qp_builder import (
    QPDims, build_qp, materialize_A)
from mpc_arpo_project_tpu_torch.tools import osqp_ref as tosqp
from mpc_arpo_project_tpu_torch.tools import ref_sim as tref
from mpc_arpo_project_tpu.config import Noise as JNoise
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """The numpy oracles on one BLAS thread: their matrices are small
    (nz=201, m=406), and several test workers whose BLAS threads spin on
    the same cores ran the refsim arm 6x slower than one thread."""
    with threadpool_limits(1):
        yield


def _radial_qp():
    """The radial QP at the scenario start (the port's builder; both
    solvers get the same arrays): (P, q, A, l, u, dims)."""
    ref = tref
    sim, mpc, fail, debris = tcommon.radial_config(noisy=False)
    dims = QPDims(Nx=mpc.Nx, Nc=mpc.Nc, Nb=mpc.Nb)
    Ad, Bd = ref.discretize_np(sim.mean_mtn, sim.time_stp, sim.isDeltaV)
    K, QN, *_ = ref.synth_gains_np(Ad, Bd, mpc, fail)
    static = build_qp(dims, sim, mpc, Ad, Bd, K, QN)
    xe = np.concatenate([sim.x0, [0.0, 0.0]])
    c1, c2, slope, xmin, xmax = ref.configure_dynamic_np(sim, debris, xe)
    lineq, uineq = ref.bounds_np(dims, xmin, xmax, static.umin, static.umax,
                                 float(sim.isReject), xe[4:6])
    leq = np.concatenate([-sim.x0, np.zeros(dims.Nx * 4)])
    A = materialize_A(static, c1, c2, -slope)
    return (static.P, static.q, A, np.concatenate([leq, lineq]),
            np.concatenate([leq, uineq]), dims)


def _pinf_bounds(l, u, dims):
    """The debris rows' lower bound raised to 1e3: the debris line then
    contradicts the approach cone, a genuinely infeasible QP."""
    l2 = l.copy()
    for j in range(dims.Nb + 1):
        l2[dims.n_eq + j * 5 + 4] = 1e3
    return l2, u


def _osqp_case(osqp, case):
    """One scripted use of a module's ``OSQPRef``: the list of results."""
    P, q, A, l, u, dims = _radial_qp()
    if case == "pinned":
        base = osqp.OSQPRef(P, q, A, l, u)
        solver = osqp.OSQPRef(P, q, A, l, u,
                              scaling_override=(base.D * 1.01, base.E, base.c),
                              rho_boundary_only=True, stall_exit_chunks=4,
                              eps_abs=1e-6, eps_rel=1e-10)
        return [solver.solve(), solver.solve()]
    if case == "pinf":
        l2, u2 = _pinf_bounds(l, u, dims)
        return [osqp.OSQPRef(P, q, A, l2, u2).solve()]
    solver = osqp.OSQPRef(P, q, A, l, u, max_iter=8000)
    first = solver.solve()
    if case == "solve":
        return [first]
    if case == "update":
        l2, u2 = l.copy(), u.copy()
        l2[:4] = u2[:4] = -np.array([95.0, 9.0, -0.2, -0.05])
        A2 = A.copy()
        A2[A != 0] *= 1.0 + 1e-3 * np.sign(A[A != 0])
        solver.update(l=l2, u=u2, A=A2)
        return [first, solver.solve()]
    if case == "warm_start":
        solver.warm_start(x=first.x * 0.9, y=first.y * 1.1)
        return [first, solver.solve()]
    if case == "polish":
        # the radial start is degenerate: the polished guess is refused and
        # the ADMM result comes back
        return [first, solver.polish(first)]
    raise ValueError(case)


def _small_qp_polished(osqp):
    """A random strictly convex QP (n=12, m=20, seeded) whose active set
    polishing finds: the accepted branch of ``polish``."""
    rng = np.random.default_rng(4)
    M = rng.standard_normal((12, 12))
    P, q = M @ M.T + np.eye(12), 5 * rng.standard_normal(12)
    A = rng.standard_normal((20, 12))
    l, u = -np.ones(20), np.ones(20)
    l[:3] = -np.inf
    solver = osqp.OSQPRef(P, q, A, l, u)
    res = solver.solve()
    return [res, solver.polish(res)]


def _equal_results(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        for f in dataclasses.fields(r):
            a, b = getattr(g, f.name), getattr(r, f.name)
            if isinstance(b, np.ndarray):
                assert np.array_equal(a, b), f.name
            else:
                assert a == b, (f.name, a, b)


OSQP_CASES = ("solve", "update", "warm_start", "polish", "pinf", "pinned")


@pytest.fixture(scope="module")
def osqp_refs():
    return {case: _osqp_case(josqp, case) for case in OSQP_CASES}


@pytest.mark.parametrize("case", OSQP_CASES)
def test_osqp_ref_matches_jax(osqp_refs, case):
    ref = osqp_refs[case]
    got = _osqp_case(tosqp, case)
    _equal_results(got, ref)
    statuses = [r.status for r in ref]
    if case == "pinf":
        assert statuses == ["primal infeasible"]
    elif case == "pinned":
        # tight tolerances on the degenerate start: the stall exit ends both
        assert statuses == ["max iterations"] * 2
        assert max(r.iters for r in ref) < 4000
    else:
        assert statuses[-1] == "solved"


def test_osqp_ref_polish_matches_jax():
    ref = _small_qp_polished(josqp)
    _equal_results(_small_qp_polished(tosqp), ref)
    assert [r.status for r in ref] == ["solved", "solved polished"]


def _discrete_configs(common, noise_cls, which):
    """Noisy radial or noisy in-track at T_final 10 s (20 control steps)."""
    if which == "radial":
        sim, mpc, fail, debris = common.radial_config(noisy=True,
                                                      T_final=10.0)
    else:
        sim, mpc, fail, debris = common.in_track_config(T_final=10.0)
        sim = dataclasses.replace(sim, noise=noise_cls((0.4, 0.4), 20))
    return sim, mpc, fail, debris


DISCRETE = ("radial", "in-track")


@pytest.fixture(scope="module")
def discrete_refs():
    return {w: jref.simulate_discrete(*_discrete_configs(jcommon, JNoise, w),
                                      seed=5) for w in DISCRETE}


@pytest.mark.parametrize("which", DISCRETE)
def test_simulate_discrete_matches_jax(discrete_refs, which):
    ref = discrete_refs[which]
    got = tref.simulate_discrete(*_discrete_configs(tcommon, TNoise, which),
                                 seed=5)
    for f in dataclasses.fields(ref):
        a, b = getattr(got, f.name), getattr(ref, f.name)
        if isinstance(b, np.ndarray):
            assert np.array_equal(a, b), f.name
        else:
            assert a == b, (f.name, a, b)
    assert len(ref.statuses) == ref.i_term == 20


def test_simulate_continuous_matches_jax():
    cfg = dict(noisy=True, T_final=3.0, T_cont=1e-3)
    ref = jref.simulate_continuous(*jcommon.radial_config(**cfg), seed=7)
    got = tref.simulate_continuous(*tcommon.radial_config(**cfg), seed=7)
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, (k, got[k], v)
    assert len(ref["statuses"]) == 5
