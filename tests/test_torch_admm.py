"""``admm_solve`` in 'eig' mode: the port against the JAX package, the
port's own invariances, and the captured ρ-rescue case.

Same fixture as ``tests/test_admm_eig.py`` (Nx=40, B=8, tile 4, all four
combos, debris active on half the rows), fp64, adaptive rho on. Statuses
and per-problem ``done_iters`` must be equal; x must agree to 1e-9 relative
to each row's max (the two packages run the same arithmetic in another
summation order; a row that runs 2000 iterations accumulates ~1e-11).
"""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.config import Noise
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tests.test_admm_eig import _build_setup
from tests.torch_helpers import flagship_parts, sim_conditions
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

KW = dict(solve_mode="eig", pallas_tile=4, max_iter=2000)


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    p = _build_setup()
    tp = tadmm.problem_from_numpy(p["prob"], dtype=torch.float64,
                                 device="cpu")
    coeffs = tuple(_t(c) for c in p["coeffs"])
    # a second, warm-started solve on shifted bounds
    l2 = np.asarray(p["l"]).copy()
    u2 = np.asarray(p["u"]).copy()
    l2[:, :4] -= 0.01
    u2[:, :4] -= 0.01
    jst = jadmm.ADMMSettings(**KW)
    j1 = jadmm.admm_solve(p["prob"], p["coeffs"], p["l"], p["u"],
                          jadmm.init_state(p["prob"], p["B"], jst), jst)
    j2 = jadmm.admm_solve(p["prob"], p["coeffs"], jnp.asarray(l2),
                          jnp.asarray(u2), j1.state, jst)
    return dict(p=p, tp=tp, coeffs=coeffs, l=_t(p["l"]), u=_t(p["u"]),
                l2=_t(l2), u2=_t(u2), j1=j1, j2=j2)


def _solve(s, settings, l=None, u=None, state=None, active=None):
    B = s["p"]["B"]
    if state is None:
        state = tadmm.init_state(s["tp"], B, settings)
    return tadmm.admm_solve(s["tp"], s["coeffs"],
                            s["l"] if l is None else l,
                            s["u"] if u is None else u, state, settings,
                            active=active)


def _assert_matches_jax(rt, rj):
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.done_iters.numpy(),
                                  np.asarray(rj.done_iters))
    assert rt.iters == int(rj.iters)
    xj = np.asarray(rj.x)
    scale = np.abs(xj).max(axis=1, keepdims=True)
    assert (np.abs(rt.x.numpy() - xj) <= 1e-9 * scale).all()


@pytest.fixture(scope="module")
def cold(setup):
    return _solve(setup, tadmm.ADMMSettings(**KW))


def test_admm_solve_matches_jax_cold(setup, cold):
    _assert_matches_jax(cold, setup["j1"])
    assert (cold.status.numpy() == tadmm.SOLVED).sum() >= 6


def test_admm_solve_matches_jax_warm(setup, cold):
    """Warm start from the JAX package's own state, through
    ``state_from_numpy``: both packages continue from one iterate."""
    state = tadmm.state_from_numpy(setup["j1"].state, dtype=torch.float64,
                                   device="cpu")
    rt = _solve(setup, tadmm.ADMMSettings(**KW), setup["l2"], setup["u2"],
                state)
    _assert_matches_jax(rt, setup["j2"])


# Compaction, alive-first packing and the refresh capacity cut only move
# independent problems between slots, so the discrete outcomes must be
# equal. The real values are held per row, relative to the row's max-abs:
# a CPU BLAS (MKL here) does not give a GEMM row bit for bit the same result
# when the product has another number of rows (fp64, one thread: (X @ W)[:r]
# and X[:r] @ W differ for r = 1, 2, 6 at W 201x201), and moving problems
# changes the row counts of the solver's batched products. Measured on an
# AVX-512 CPU: x within 1.4e-11 (compaction) and 2.0e-11 (packing), minv
# within 1.2e-13. The tolerances are about 10x those. On the card the
# kernels work one block per slot, so compaction stays bit-exact there
# (``tests/test_torch_cuda.py``).
X_RTOL = 2e-10
MINV_RTOL = 2e-12


def _rows_close(a, b, rtol):
    a = a.reshape(a.shape[0], -1)
    b = b.reshape(b.shape[0], -1)
    scale = b.abs().amax(1).clamp(min=1e-300)
    return bool(((a - b).abs().amax(1) <= rtol * scale).all())


def test_compaction_is_a_pure_permutation(setup, cold):
    """Straggler compaction only moves problems between slots: statuses,
    ``done_iters`` and iteration counts are equal with it disabled or at
    other boundaries, x and the inner inverses equal to round-off."""
    for chunks in ((), (1, 2, 4, 8)):
        r = _solve(setup, tadmm.ADMMSettings(eig_compact_chunks=chunks, **KW))
        assert torch.equal(r.status, cold.status), chunks
        assert torch.equal(r.done_iters, cold.done_iters), chunks
        assert r.iters == cold.iters
        assert _rows_close(r.x, cold.x, X_RTOL), chunks
        assert _rows_close(r.state.minv, cold.state.minv, MINV_RTOL), chunks


def test_alive_first_packing_is_a_pure_permutation(setup, cold):
    """Inactive problems are packed after the active ones of their combo
    group: active rows give the all-active solve's statuses and
    ``done_iters`` and its x to round-off; inactive rows stay frozen bit
    for bit and UNSOLVED."""
    st = tadmm.ADMMSettings(**KW)
    st0 = tadmm.init_state(setup["tp"], setup["p"]["B"], st)
    active = torch.tensor([True, False, True, True, False, True, False, True])
    r = _solve(setup, st, state=st0, active=active)
    assert torch.equal(r.status[active], cold.status[active])
    assert torch.equal(r.done_iters[active], cold.done_iters[active])
    assert _rows_close(r.x[active], cold.x[active], X_RTOL)
    assert (r.status[~active] == tadmm.UNSOLVED).all()
    assert torch.equal(r.state.xbar[~active], st0.xbar[~active])
    assert torch.equal(r.state.ybar[~active], st0.ybar[~active])


def test_refresh_capacity_compaction_is_exact(setup, cold):
    """The capacity-compacted Woodbury refresh (24 slots: cap 6 >= 4 needy
    rows) and its full-width fallback (cap 2 < 4) equal the full-width
    refresh that the default divisor gives at this size (cap 0): statuses
    equal, x and the inner inverses to round-off (the refresh's batched
    products change their row count here too; measured bit-identical on
    an AVX-512 CPU)."""
    for div in (4, 12):
        r = _solve(setup, tadmm.ADMMSettings(**dict(KW, eig_refresh_cap_div=div)))
        assert torch.equal(r.status, cold.status), div
        assert torch.equal(r.done_iters, cold.done_iters), div
        assert _rows_close(r.x, cold.x, X_RTOL), div
        assert _rows_close(r.state.minv, cold.state.minv, MINV_RTOL), div


@pytest.mark.parametrize("kw, err", [
    (dict(solve_mode="qr"), ValueError),
    (dict(solve_mode="pallas", mxu_precision="high"), ValueError),
    (dict(KW, eig_rescue_mode="dula"), ValueError),
    (dict(KW, mxu_precision="high"), ValueError),
    (dict(KW, eig_refresh_precision="high"), ValueError),
    (dict(KW, stall_exit_chunks=6, eig_rescue_chunks=6), ValueError),
])
def test_unsupported_settings_raise(setup, kw, err):
    with pytest.raises(err):
        _solve(setup, tadmm.ADMMSettings(**kw))


def test_rho_rescue_solves_dual_plateau_capture():
    """The port's counterpart of the JAX package's test of the same name
    (``tests/test_admm_eig_robust.py``): the committed step-65 capture
    (``artifacts/fd_cap65_r5.npz``) holds 13 rows whose fp32 'eig' solve
    stalls with the primal converged and the dual plateaued. With the ρ
    rescue the fp32 port solves them; without it they stall-exit MAX_ITER.
    A 16-row slice (the 13 rows and 3 solved fillers; rows are
    independent) keeps the CPU cost down."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "artifacts", "fd_cap65_r5.npz")
    d = np.load(path)
    plateau = np.nonzero(d["alive"] & (d["status"] == 2))[0]
    assert len(plateau) == 13
    rows = np.concatenate([plateau, np.nonzero(d["alive"]
                                               & (d["status"] == 1))[0][:3]])
    mpc, fail, debris = flagship_parts(Nx=40)
    sim = sim_conditions(noise=Noise((0.01, 0.01), 50), T_final=300.0)
    base = tadmm.ADMMSettings(max_iter=4000, solve_mode="eig", pallas_tile=4,
                              stall_exit_chunks=12, stall_tighten_chunks=24)
    prob = tdisc.build_engine(sim, mpc, fail, debris, settings=base,
                              dtype=torch.float32, device="cpu").prob
    sl = lambda a: torch.as_tensor(d[a][rows], dtype=torch.float32)

    def run(st):
        s = tadmm.init_state(prob, len(rows), st)._replace(
            xbar=sl("xbar"), ybar=sl("ybar"), zbar=sl("zbar"),
            rho_scale=sl("rho"), minv=sl("minv"), ref_coef=sl("ref"),
            minv_ok=torch.ones((), dtype=torch.bool))
        return tadmm.admm_solve(prob, (sl("c1"), sl("c2"), sl("s")),
                                sl("l"), sl("u"), s, st,
                                active=torch.as_tensor(d["alive"][rows]))

    st_on = run(base).status[:13]
    assert int((st_on == tadmm.SOLVED).sum()) >= 12, st_on
    st_off = run(base._replace(eig_rho_rescue=False)).status[:13]
    assert int((st_off == tadmm.MAX_ITER).sum()) >= 12, st_off
