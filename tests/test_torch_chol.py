"""``admm_solve`` in 'chol' mode (the default, the fp64 oracle mode): the
port of ``tests/test_admm.py``'s solver tests, and the port against the JAX
package's 'chol' solve on the same inputs.

Fixture of ``tests/test_admm.py``: the noiseless radial scenario at Nx=40
(nz=201, m=406, unpadded), debris box at (40, 0), B=3, fp64. The port
builds its own problem (``prepare_problem`` of its own QP build) for the
oracle tests; the parity tests hand both packages the JAX package's problem.
Statuses, ``done_iters`` and iteration counts must be equal; x must agree
to 1e-9 relative to each row's max (the same arithmetic in another
summation order).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import constraints as tcon
from mpc_arpo_project_tpu_torch.ops.qp_builder import materialize_A
from tests.test_admm import problem as jax_problem  # noqa: F401 (fixture)
from tests.torch_helpers import flagship_parts, static_problem
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from tools.osqp_ref import OSQPRef


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _debris_bounds(l, u, dims, lower, upper=None):
    """Copies of (l, u) with the debris rows' bounds set (the infeasible
    and plateau cases of ``tests/test_admm.py``)."""
    l2, u2 = l.copy(), u.copy()
    for j in range(dims.Nb + 1):
        l2[dims.n_eq + j * 5 + 4] = lower
        if upper is not None:
            u2[dims.n_eq + j * 5 + 4] = upper
    return l2, u2


@pytest.fixture(scope="module")
def port():
    """The port's own build of the problem, at the initial state."""
    static, dims, sim = static_problem(40)
    geom = tcon.make_geometry(sim, flagship_parts()[2])
    xe = _t(np.concatenate([sim.x0, [0.0, 0.0]]))[None]
    dyn = tcon.configure(geom, xe)
    lineq, uineq = tcon.assemble_bounds(dyn, xe, dims, _t(static.umin),
                                        _t(static.umax), geom.is_reject[None])
    leq = _t(static.leq)[None]
    coeffs = (float(dyn.c1[0]), float(dyn.c2[0]), float(dyn.s[0]))
    prob = tadmm.prepare_problem(static, dims, nominal_coeffs=coeffs,
                                 dtype=torch.float64, device="cpu")
    return dict(static=static, dims=dims, prob=prob, coeffs=coeffs,
                l=torch.cat([leq, lineq], 1)[0].numpy(),
                u=torch.cat([leq, uineq], 1)[0].numpy())


def _solve(p, ls, us, state=None, settings=tadmm.ADMMSettings(), active=None):
    """One port solve of the rows ``ls``/``us`` (lists of bound vectors)."""
    B = len(ls)
    coeffs = tuple(torch.full((B,), v, dtype=torch.float64)
                   for v in p["coeffs"])
    if state is None:
        state = tadmm.init_state(p["prob"], B, settings)
    return tadmm.admm_solve(p["prob"], coeffs, _t(np.stack(ls)),
                            _t(np.stack(us)), state, settings, active=active)


def test_matches_pinned_oracle_exactly(port):
    p = port
    res = _solve(p, [p["l"]] * 3, [p["u"]] * 3)
    A_np = materialize_A(p["static"], *p["coeffs"])
    D, E, c = (p["prob"].D.numpy(), p["prob"].E.numpy(),
               float(p["prob"].c))
    r = OSQPRef(p["static"].P, p["static"].q, A_np, p["l"], p["u"],
                scaling_override=(D, E, c)).solve()
    assert r.status == "solved"
    assert (res.status == tadmm.SOLVED).all()
    np.testing.assert_allclose(res.x[0].numpy(), r.x, atol=1e-9)
    assert res.iters == r.iters


def test_infeasible_detection_and_mixed_batch(port):
    p = port
    l2, _ = _debris_bounds(p["l"], p["u"], p["dims"], 1e3)
    res = _solve(p, [p["l"], l2, p["l"], l2], [p["u"]] * 4)
    st = res.status.numpy()
    assert st[0] == tadmm.SOLVED and st[2] == tadmm.SOLVED
    assert st[1] == tadmm.PRIMAL_INFEASIBLE
    assert st[3] == tadmm.PRIMAL_INFEASIBLE
    # feasible members are unperturbed by infeasible neighbours
    clean = _solve(p, [p["l"]], [p["u"]])
    np.testing.assert_allclose(res.x[0].numpy(), clean.x[0].numpy(),
                               atol=1e-10)


def test_warm_start_reduces_iterations(port):
    p = port
    res1 = _solve(p, [p["l"]] * 3, [p["u"]] * 3)
    l2, u2 = p["l"].copy(), p["u"].copy()
    l2[:4] -= 0.01
    u2[:4] -= 0.01
    warm = _solve(p, [l2] * 3, [u2] * 3, state=res1.state)
    cold = _solve(p, [l2] * 3, [u2] * 3)
    assert warm.iters <= cold.iters
    assert (warm.status == tadmm.SOLVED).all()


def test_active_mask_skips_problems(port):
    """Inactive problems are frozen (iterates pass through, status
    UNSOLVED) and never drag the batch's iteration count."""
    p = port
    st0 = tadmm.init_state(p["prob"], 4)
    ls, us = [p["l"]] * 4, [p["u"]] * 4
    active = torch.tensor([True, False, True, False])
    res = _solve(p, ls, us, st0, active=active)
    st = res.status.numpy()
    assert st[0] == tadmm.SOLVED and st[2] == tadmm.SOLVED
    assert st[1] == tadmm.UNSOLVED and st[3] == tadmm.UNSOLVED
    assert torch.equal(res.state.xbar[1], st0.xbar[1])
    assert torch.equal(res.state.ybar[3], st0.ybar[3])
    none = _solve(p, ls, us, st0, active=torch.zeros(4, dtype=torch.bool))
    assert none.iters == 0
    full = _solve(p, ls, us, st0)
    np.testing.assert_allclose(res.x[0].numpy(), full.x[0].numpy(),
                               atol=1e-12)


def test_stall_exit_cuts_plateau(port):
    """A problem pinned to a marginally conflicting near-equality band
    exits (MAX_ITER by stall, or PINF) well before the cap; the converging
    one is untouched."""
    p = port
    l2, u2 = _debris_bounds(p["l"], p["u"], p["dims"], 1e3, 1e3 + 1e-6)
    st = tadmm.ADMMSettings(max_iter=4000, stall_exit_chunks=8)
    res = _solve(p, [p["l"], l2], [p["u"], u2], settings=st)
    s = res.status.numpy()
    assert s[0] == tadmm.SOLVED
    assert s[1] in (tadmm.PRIMAL_INFEASIBLE, tadmm.MAX_ITER)
    assert res.iters < 4000
    ref = _solve(p, [p["l"]], [p["u"]])
    np.testing.assert_allclose(res.x[0].numpy(), ref.x[0].numpy(),
                               atol=1e-10)


def test_fp32_solve_agrees_with_fp64(port):
    """The mode runs in fp32 too: the same statuses, x near the fp64
    solve's."""
    p = port
    static, dims = p["static"], p["dims"]
    prob32 = tadmm.prepare_problem(static, dims, nominal_coeffs=p["coeffs"],
                                   dtype=torch.float32, device="cpu")
    coeffs = tuple(torch.full((3,), v, dtype=torch.float32)
                   for v in p["coeffs"])
    l = torch.as_tensor(np.stack([p["l"]] * 3), dtype=torch.float32)
    u = torch.as_tensor(np.stack([p["u"]] * 3), dtype=torch.float32)
    r32 = tadmm.admm_solve(prob32, coeffs, l, u,
                           tadmm.init_state(prob32, 3))
    r64 = _solve(p, [p["l"]] * 3, [p["u"]] * 3)
    assert r32.x.dtype == torch.float32
    assert torch.equal(r32.status, r64.status)
    scale = r64.x.abs().amax(1, keepdim=True)
    assert ((r32.x.double() - r64.x).abs() <= 1e-3 * scale).all()


# ---------------------------------------------------------------------------
# the port against the JAX package's 'chol' solve, on the same inputs
# ---------------------------------------------------------------------------

def _jax_case(p, name):
    """(coeffs, l, u, settings, active) of one parity case, numpy."""
    dims = p["dims"]
    l, u = np.asarray(p["l"]), np.asarray(p["u"])
    st = jadmm.ADMMSettings()
    active = None
    if name == "cold":
        ls, us = [l] * 3, [u] * 3
    elif name == "infeasible":
        l2, _ = _debris_bounds(l, u, dims, 1e3)
        ls, us = [l, l2, l, l2], [u] * 4
    elif name == "stall":
        l2, u2 = _debris_bounds(l, u, dims, 1e3, 1e3 + 1e-6)
        ls, us = [l, l2], [u, u2]
        st = jadmm.ADMMSettings(max_iter=4000, stall_exit_chunks=8)
    elif name == "active":
        ls, us = [l] * 4, [u] * 4
        active = np.array([True, False, True, False])
    elif name == "warm":
        ls = [l - np.r_[np.full(4, 0.01), np.zeros(len(l) - 4)]] * 3
        us = [u - np.r_[np.full(4, 0.01), np.zeros(len(u) - 4)]] * 3
    B = len(ls)
    coeffs = tuple(np.full(B, v) for v in p["coeffs"])
    return coeffs, np.stack(ls), np.stack(us), st, active


@pytest.fixture(scope="module")
def jax_refs(jax_problem):
    p = jax_problem
    refs = {}
    for name in ("cold", "infeasible", "stall", "active", "warm"):
        coeffs, l, u, st, active = _jax_case(p, name)
        B = l.shape[0]
        jc = tuple(jnp.asarray(c) for c in coeffs)
        if name == "warm":
            state = refs["cold"][1].state
        else:
            state = jadmm.init_state(p["prob"], B, st)
        res = jadmm.admm_solve(p["prob"], jc, jnp.asarray(l), jnp.asarray(u),
                               state, st, active=None if active is None
                               else jnp.asarray(active))
        refs[name] = ((coeffs, l, u, st, active, state), res)
    return refs


@pytest.mark.parametrize("case", ["cold", "infeasible", "stall", "active",
                                  "warm"])
def test_matches_jax_chol(jax_problem, jax_refs, case):
    (coeffs, l, u, st, active, jstate), rj = jax_refs[case]
    prob = tadmm.problem_from_numpy(jax_problem["prob"], device="cpu")
    state = tadmm.state_from_numpy(jstate, device="cpu")
    rt = tadmm.admm_solve(
        prob, tuple(_t(c) for c in coeffs), _t(l), _t(u), state,
        tadmm.ADMMSettings(**st._asdict()),
        active=None if active is None else torch.as_tensor(active))
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.done_iters.numpy(),
                                  np.asarray(rj.done_iters))
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    scale = np.abs(xj).max(axis=1, keepdims=True)
    assert (np.abs(rt.x.numpy() - xj) <= 1e-9 * scale).all()
    np.testing.assert_allclose(rt.state.rho_scale.numpy(),
                               np.asarray(rj.state.rho_scale), rtol=1e-12)


def test_non_pd_row_runs_to_max_iter_in_both(jax_problem):
    """A row whose normal matrix is not positive definite (a negative rho
    scale) gets a NaN factor in both packages and runs to MAX_ITER; the
    other rows solve as usual."""
    p = jax_problem
    B = 3
    coeffs = tuple(np.full(B, v) for v in p["coeffs"])
    l = np.stack([np.asarray(p["l"])] * B)
    u = np.stack([np.asarray(p["u"])] * B)
    st = jadmm.ADMMSettings(max_iter=300)
    js = jadmm.init_state(p["prob"], B, st)
    js = js._replace(rho_scale=jnp.asarray([1.0, -1.0, 1.0]))
    rj = jadmm.admm_solve(p["prob"], tuple(jnp.asarray(c) for c in coeffs),
                          jnp.asarray(l), jnp.asarray(u), js, st)
    prob = tadmm.problem_from_numpy(p["prob"], device="cpu")
    rt = tadmm.admm_solve(prob, tuple(_t(c) for c in coeffs), _t(l), _t(u),
                          tadmm.state_from_numpy(js, device="cpu"),
                          tadmm.ADMMSettings(max_iter=300))
    expect = [tadmm.SOLVED, tadmm.MAX_ITER, tadmm.SOLVED]
    np.testing.assert_array_equal(np.asarray(rj.status), expect)
    np.testing.assert_array_equal(rt.status.numpy(), expect)
    np.testing.assert_array_equal(rt.done_iters.numpy(),
                                  np.asarray(rj.done_iters))
    assert rt.iters == int(rj.iters) == 300
    assert torch.isnan(rt.x[1]).all() and np.isnan(np.asarray(rj.x[1])).all()
    xj = np.asarray(rj.x)
    for b in (0, 2):
        assert (np.abs(rt.x[b].numpy() - xj[b])
                <= 1e-9 * np.abs(xj[b]).max()).all()
