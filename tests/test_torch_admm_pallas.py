"""The port's 'pallas' solve mode against the JAX package.

Problem: ``tests/test_admm_pallas.py``'s fixture (Nx=40 unpadded, so nz=201
and m=406; B=8), fp64. The JAX package runs its Pallas kernels in interpret
mode on the CPU; the port runs the kernels' plain twins. Tolerances:

* one chunk (``admm_chunk_ref``) and the Newton–Schulz refreshes: 1e-10
  relative to each row's max — the same arithmetic in another summation
  order over 25 iterations (or 45 Newton–Schulz steps);
* whole solves: statuses, iteration counts and ``done_iters`` equal, x to
  1e-9 relative to each row's max (a row that runs thousands of iterations
  accumulates ~1e-11);
* the closed loop: every discrete outcome equal, ``x_true`` to 1e-8.

Inputs on which the JAX kernel's blend ``nd*Xf + (1-nd)*X`` gives NaN (a
non-finite inverse on a row without need) are outside the parity domain;
the port's pass-through of such rows is tested on its own.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.config import Noise
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.ops import admm_pallas as jpal
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import admm_pallas as tpal
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tests.test_admm_pallas import setup as _jax_setup
from tests.torch_helpers import (
    capture_chunks, flagship_parts, pallas_inputs, sim_conditions)
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-10
PALLAS = dict(solve_mode="pallas")


def _t(a, dtype=torch.float64):
    a = np.array(a)
    return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None)


def _tstate(jstate):
    return tadmm.state_from_numpy(jstate, dtype=torch.float64, device="cpu")


def _row_close(a, b, tol):
    """Per-row max |a - b| within ``tol`` of the row's max |b|."""
    a, b = np.asarray(a), np.asarray(b)
    scale = np.abs(b).reshape(b.shape[0], -1).max(1)
    err = np.abs(a - b).reshape(b.shape[0], -1).max(1)
    return bool((err <= tol * scale).all()), err / np.maximum(scale, 1e-300)


@pytest.fixture(scope="module")
def setup():
    """The fixture of ``tests/test_admm_pallas.py`` for both packages, and
    the JAX package's fresh solve (the warm start of later cases)."""
    p = _jax_setup.__wrapped__()
    st = jadmm.ADMMSettings(**PALLAS)
    j1 = jadmm.admm_solve(p["prob"], p["coeffs"], p["l"], p["u"],
                          jadmm.init_state(p["prob"], p["B"], st), st)
    return dict(p=p, j1=j1,
                tp=tadmm.problem_from_numpy(p["prob"], dtype=torch.float64,
                                            device="cpu"),
                coeffs=tuple(_t(c) for c in p["coeffs"]),
                l=_t(p["l"]), u=_t(p["u"]))


# ---------------------------------------------------------------------------
# the chunk
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs(setup):
    """Real 'pallas' kernel inputs (``tests/torch_helpers.pallas_inputs``)."""
    return pallas_inputs(setup["tp"], setup["l"], setup["u"])


@pytest.fixture(scope="module")
def chunk(inputs):
    """A real chunk (the second of a solve with all four funnel-sign combos,
    s != 0 and two inactive problems), through the port's twin and the JAX
    package's ``admm_chunk``."""
    a, k = inputs["chunk"]
    ref_t = tpal.admm_chunk_ref(*a, **k)
    ja = [jnp.asarray(v.numpy()) for v in a]
    jk = {kk: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
          for kk, v in k.items()}
    ref_j = jpal.admm_chunk(*ja, interpret=True, **jk)
    return a, k, ref_t, [np.asarray(v) for v in ref_j]


def test_admm_chunk_ref_matches_jax(chunk):
    a, k, (xt, yt, zt, st), (xj, yj, zj, sj) = chunk
    live = ~k["done"].numpy()
    assert live.sum() == 6
    assert len(set(zip(a[1][:, 1].tolist(), a[1][:, 2].tolist()))) == 4
    for name, pt, pj in (("x", xt, xj), ("y", yt, yj), ("z", zt, zj)):
        ok, err = _row_close(pt.numpy()[live], pj[live], TOL)
        assert ok, (name, err)
    stt, stj = st.numpy()[live], sj[live]
    for col in (0, 1, 2, 3, 6, 7):
        np.testing.assert_allclose(stt[:, col], stj[:, col], rtol=TOL, atol=0,
                                   err_msg=f"stats col {col}")
    np.testing.assert_array_equal(stt[:, 4:6], stj[:, 4:6])


def test_admm_chunk_ref_done_rows_pass_through(chunk):
    a, k, (xt, yt, zt, st), _ = chunk
    done = k["done"]
    for out, inp in ((xt, a[6]), (yt, a[7]), (zt, a[8])):
        assert torch.equal(out[done], inp[done])
    assert (st[done] == 0).all()


def test_entries_dispatch_to_the_twin_on_cpu(chunk):
    a, k, ref, _ = chunk
    for o, r in zip(tpal.admm_chunk(*a, **k), ref):
        assert torch.equal(o, r)


def test_entries_raise_without_a_kernel(chunk, inputs):
    """No fallback: a tensor on a device with no kernel raises instead of
    running the twin, at every entry."""
    a, k, _, _ = chunk
    meta = lambda v: v.to("meta") if torch.is_tensor(v) else v
    with pytest.raises(ValueError, match="no kernel"):
        tpal.admm_chunk(*map(meta, a), **{kk: meta(v) for kk, v in k.items()})
    ni = inputs
    with pytest.raises(ValueError, match="no kernel"):
        tpal.ns_fused(*map(meta, (ni["stack"], ni["w"], ni["X_warm"],
                                  ni["need"])), n_iter=1, cold=False)
    with pytest.raises(ValueError, match="no kernel"):
        tpal.newton_schulz_inverse(meta(ni["M"]), meta(ni["X_warm"]), 1)


# ---------------------------------------------------------------------------
# Newton–Schulz
# ---------------------------------------------------------------------------

def test_build_M_matches_jax(setup, inputs):
    ni = inputs
    jM = jadmm._build_M(setup["p"]["prob"],
                        tuple(jnp.asarray(c.numpy()) for c in ni["coeffs"]),
                        jnp.asarray(ni["r"]), ni["sigma"])
    np.testing.assert_allclose(ni["M"].numpy(), np.asarray(jM), rtol=1e-13,
                               atol=1e-13 * float(np.abs(jM).max()))


@pytest.fixture(scope="module")
def jax_ns_fused(inputs):
    """The JAX package's ``ns_fused`` (interpret mode) on the fixture, warm
    (3 iterations) and cold (45), each computed once."""
    ni = inputs
    args = [jnp.asarray(ni[k].numpy()) for k in ("stack", "w", "X_warm",
                                                   "need")]
    return {cold: jpal.ns_fused(*args, n_iter=45 if cold else 3, cold=cold,
                                interpret=True) for cold in (False, True)}


def _count(need, n_need):
    """``n_need`` of a parametrised case: None, or the exact count."""
    return None if n_need is None else int(need.sum())


@pytest.mark.parametrize("n_need", [None, "count"])
@pytest.mark.parametrize("cold", [False, True])
def test_ns_fused_ref_matches_jax(inputs, jax_ns_fused, cold, n_need):
    ni = inputs
    n_iter = 45 if cold else 3
    xt, rt = tpal.ns_fused_ref(ni["stack"], ni["w"], ni["X_warm"], ni["need"],
                               n_iter=n_iter, cold=cold)
    xj, rj = jax_ns_fused[cold]
    need = ni["need"]
    ok, err = _row_close(xt.numpy()[need], np.asarray(xj)[need.numpy()], TOL)
    assert ok, err
    assert torch.equal(xt[~need], ni["X_warm"][~need])
    assert (rt[~need] == 0).all()
    assert (rt[need] < 1e-8).all()
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=TOL)
    # the dispatching entry is the twin on the CPU, with or without n_need
    xe, re = tpal.ns_fused(ni["stack"], ni["w"], ni["X_warm"], ni["need"],
                           n_iter=n_iter, cold=cold,
                           n_need=_count(need, n_need))
    assert torch.equal(xe, xt) and torch.equal(re, rt)


@pytest.fixture(scope="module")
def jax_ns_inverse(inputs):
    M = inputs["M"]
    X0 = tpal.cold_start_inverse(M)
    return jpal.newton_schulz_inverse(jnp.asarray(M.numpy()),
                                      jnp.asarray(X0.numpy()), n_iter=45,
                                      interpret=True)


@pytest.mark.parametrize("n_need", [None, "count"])
def test_newton_schulz_inverse_ref_matches_jax(inputs, jax_ns_inverse,
                                               n_need):
    M = inputs["M"]
    X0 = tpal.cold_start_inverse(M)
    xt, rt = tpal.newton_schulz_inverse_ref(M, X0, n_iter=45)
    xj, rj = jax_ns_inverse
    ok, err = _row_close(xt.numpy(), np.asarray(xj), TOL)
    assert ok, err
    assert float(rt.max()) < 1e-10
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=0, atol=TOL)
    every = torch.ones(M.shape[0], dtype=torch.bool)
    xe, re = tpal.newton_schulz_inverse(M, X0, n_iter=45,
                                        n_need=_count(every, n_need))
    assert torch.equal(xe, xt) and torch.equal(re, rt)
    xs = tpal.safe_inverse(M, X0, ~every, warm_iters=3, cold_iters=45)
    assert torch.equal(xs, xt)


@pytest.mark.parametrize("rows, n, tile", [
    (1, 256, 64), (3, 256, 64), (32, 256, 64), (61, 256, 64),
    (65, 256, 64), (66, 256, 128), (128, 256, 128), (445, 256, 128),
    (1024, 256, 128), (8, 201, 64), (65, 201, 64), (66, 201, 128),
    (72, 201, 128), (131, 40, 64), (132, 40, 128), (0, 256, 64)])
def test_ns_tile_choice(rows, n, tile):
    """The Newton–Schulz GEMM takes its large tile (128x256 in fp32, one
    block per SM) when a call's needy rows give each of the 132 SMs a
    block (66 rows at the flagship's n=256; the main path's refreshes hold
    at most 61 needy rows or at least 444, PERF.md section 5), else the
    64x64 tile."""
    assert tpal.ns_tile(rows, n) == tile


_DTYPES = (torch.float32, torch.float64)
_LIVE = (1, 11, 33, 66, 67, 264, 528, 529, 1024, 1152)
# (live slots, type, layout): the mean live counts of the 'pallas' census
# classes (9, 44, 97, 185, 394, 773) and the live counts of chip_smoke's
# layout sweep, with the layout the policy takes there: the sweep's
# fastest, or within 5% of it (PERF.md section 6)
ADMM_CENSUS = [
    (9, torch.float32, (8, 1)), (44, torch.float32, (2, 1)),
    (97, torch.float32, (2, 1)), (128, torch.float32, (2, 1)),
    (185, torch.float32, (2, 1)), (264, torch.float32, (2, 1)),
    (394, torch.float32, (1, 1)), (528, torch.float32, (1, 1)),
    (773, torch.float32, (1, 4)), (1024, torch.float32, (1, 4)),
    (9, torch.float64, (8, 1)), (33, torch.float64, (8, 1)),
    (66, torch.float64, (8, 1)), (128, torch.float64, (1, 1)),
    (264, torch.float64, (1, 1)), (528, torch.float64, (1, 2)),
    (1024, torch.float64, (1, 2)),
]


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n_live", _LIVE)
def test_admm_layout_within_its_caps(n_live, dtype):
    """The policy picks a layout the kernel takes in the type: a cluster
    of C blocks for one slot, or S slots a block, never both."""
    C, S = tpal.admm_layout(n_live, dtype)
    assert (C, S) in tpal.LAYOUTS[dtype]
    assert C == 1 or S == 1
    assert set(tpal.WAVES[dtype]) == set(tpal.LAYOUTS[dtype])


@pytest.mark.parametrize("dtype", _DTYPES)
@pytest.mark.parametrize("n_live", _LIVE)
def test_admm_layout_fits_one_wave(n_live, dtype):
    """The largest cluster whose clusters fit one wave of the card; else
    the smallest whose clusters fit ``CLUSTER_WAVES`` waves; else the
    smallest group whose groups fit one wave; else the largest group. Also
    with the wave sizes a caller passes (a card that holds fewer)."""
    for waves in (tpal.WAVES[dtype],
                  {k: max(1, v // 2) for k, v in tpal.WAVES[dtype].items()}):
        C, S = tpal.admm_layout(n_live, dtype, waves)
        clusters = [c for c, _ in waves if c > 1]
        fits = lambda c, s, n=1: (n_live if c > 1 else -(-n_live // s)) <= (
            n * waves[(c, s)])
        one = [c for c in clusters if fits(c, 1)]
        some = [c for c in clusters if fits(c, 1, tpal.CLUSTER_WAVES)]
        if one:
            assert (C, S) == (max(one), 1)
        elif some:
            assert (C, S) == (min(some), 1)
        else:
            groups = [s for c, s in waves if c == 1]
            fit = [s for s in groups if fits(1, s)]
            assert (C, S) == (1, min(fit) if fit else max(groups))


@pytest.mark.parametrize("n_live, dtype, layout", ADMM_CENSUS)
def test_admm_layout_follows_the_census(n_live, dtype, layout):
    """At the live counts of the 'pallas' main path's chunk census and of
    chip_smoke's sweep (PERF.md sections 5 and 6), the policy picks the
    layout the sweep found fastest, or one within its stated margin."""
    assert tpal.admm_layout(n_live, dtype) == layout


def test_admm_chunk_twin_ignores_n_live_and_layout(chunk):
    """On the CPU ``admm_chunk`` runs the twin, which takes ``n_live`` and
    ``layout`` and moves no bit for them (not even for values the kernel
    refuses)."""
    a, k, ref, _ = chunk
    for extra in (dict(n_live=6), dict(n_live=1, layout=(8, 1)),
                  dict(layout=(3, 3))):
        for o, r in zip(tpal.admm_chunk(*a, **k, **extra), ref):
            assert torch.equal(o, r)


@pytest.mark.parametrize("n_need", [None, "count"])
def test_masked_safe_refresh_recovers_and_passes_through(setup, inputs,
                                                         n_need):
    """The poisoned case of ``tests/test_admm_pallas.py``: a 1e200-scaled
    and a NaN warm start on needy rows recover through the cold retry as
    in the JAX package; a non-finite inverse on a row WITHOUT need passes
    through unchanged (the select; the JAX blend would give NaN)."""
    ni = inputs
    X_prev = torch.linalg.inv(ni["M"])
    X_prev[0] *= 1e200
    X_prev[2] = torch.nan
    need = torch.tensor([True, False, True, False] * 2)
    kw = dict(warm_iters=3, cold_iters=45)
    xt = tpal.masked_safe_refresh(ni["stack"], ni["w"], X_prev, need, **kw,
                                  n_need=_count(need, n_need))
    xj = jpal.masked_safe_refresh(
        jnp.asarray(ni["stack"].numpy()), jnp.asarray(ni["w"].numpy()),
        jnp.asarray(X_prev.numpy()), jnp.asarray(need.numpy()), **kw)
    assert torch.isfinite(xt).all()
    ok, err = _row_close(xt.numpy()[need], np.asarray(xj)[need.numpy()], TOL)
    assert ok, err
    assert torch.equal(xt[~need], X_prev[~need])
    eye = torch.eye(X_prev.shape[1], dtype=torch.float64)
    for row in (0, 2):
        assert float((eye - ni["M"][row] @ xt[row]).abs().max()) < 1e-8
    poisoned = X_prev.clone()
    poisoned[1] = torch.inf
    poisoned[3] = torch.nan
    xp, rp = tpal.ns_fused(ni["stack"], ni["w"], poisoned, need, n_iter=3,
                           cold=True, n_need=_count(need, n_need))
    assert torch.equal(xp[1], poisoned[1]) and torch.isnan(xp[3]).all()
    assert (rp[~need] == 0).all() and torch.isfinite(xp[need]).all()


# ---------------------------------------------------------------------------
# whole solves
# ---------------------------------------------------------------------------

def _assert_solve_matches(rt, rj):
    np.testing.assert_array_equal(rt.status.numpy(), np.asarray(rj.status))
    np.testing.assert_array_equal(rt.done_iters.numpy(),
                                  np.asarray(rj.done_iters))
    assert rt.iters == int(rj.iters)
    ok, err = _row_close(rt.x.numpy(), np.asarray(rj.x), 1e-9)
    assert ok, err


def _case_inputs(setup, case):
    """(coeffs, l, u, JAX warm-start state or None) of a solve case."""
    p = setup["p"]
    coeffs = p["coeffs"]
    l, u = np.asarray(p["l"]).copy(), np.asarray(p["u"]).copy()
    state = None
    if case == "warm":
        l[:, :4] -= 0.01
        u[:, :4] -= 0.01
        state = setup["j1"].state
    elif case == "infeasible":
        dims = p["dims"]
        for j in range(dims.Nb + 1):
            l[:, dims.n_eq + j * 5 + 4] = 1e3
    elif case == "poisoned":
        s1 = setup["j1"].state
        xb = np.asarray(s1.xbar).copy()
        xb[0] = np.nan
        yb = np.asarray(s1.ybar).copy()
        yb[3] = np.inf
        mv = np.asarray(s1.minv).copy()
        mv[0] = np.nan
        state = s1._replace(xbar=jnp.asarray(xb), ybar=jnp.asarray(yb),
                            minv=jnp.asarray(mv))
    elif case == "flip":
        c1, c2, s = coeffs
        coeffs = (-c1, -c2, s)
        state = setup["j1"].state
    return coeffs, l, u, state


@pytest.fixture(scope="module",
                params=["fresh", "warm", "infeasible", "poisoned", "flip"])
def solve_case(request, setup):
    p = setup["p"]
    coeffs, l, u, state = _case_inputs(setup, request.param)
    st = jadmm.ADMMSettings(**PALLAS)
    if request.param == "fresh":
        rj = setup["j1"]
    else:
        rj = jadmm.admm_solve(
            p["prob"], coeffs, jnp.asarray(l), jnp.asarray(u),
            jadmm.init_state(p["prob"], p["B"], st) if state is None
            else state, st)
    return request.param, coeffs, l, u, state, rj


def test_admm_solve_matches_jax(setup, solve_case):
    case, coeffs, l, u, state, rj = solve_case
    tp, B = setup["tp"], setup["p"]["B"]
    st = tadmm.ADMMSettings(**PALLAS)
    ts = tadmm.init_state(tp, B, st) if state is None else _tstate(state)
    rt = tadmm.admm_solve(tp, tuple(_t(c) for c in coeffs), _t(l), _t(u), ts,
                          st)
    _assert_solve_matches(rt, rj)
    assert torch.isfinite(rt.x).all()
    np.testing.assert_allclose(rt.state.rho_scale.numpy(),
                               np.asarray(rj.state.rho_scale), rtol=1e-9)
    np.testing.assert_array_equal(np.isnan(rt.state.ref_coef.numpy()),
                                  np.isnan(np.asarray(rj.state.ref_coef)))
    if case == "infeasible":
        assert (rt.status == tadmm.PRIMAL_INFEASIBLE).all()
    elif case != "flip":
        assert (rt.status == tadmm.SOLVED).all()


@pytest.fixture(scope="module")
def cascade(setup):
    """B=16 with three infeasible problems (3, 7, 12) and odd rows shifted;
    rows 0-11 warm-started from a converged solve, rows 12-15 cold at rho
    scales 0.01, 0.1, 10 and 100. The warm rows finish after one chunk, so
    the six stragglers move to the 8-slot lane; after 175 iterations four
    remain and move to the 4-slot lane, where they finish at 200, 275, 325
    and 600 iterations. The JAX package's solve with ``overtime_div=4``."""
    p, j1 = setup["p"], setup["j1"]
    dims, B = p["dims"], 16
    coeffs = tuple(np.tile(np.asarray(v)[:1], B) for v in p["coeffs"])
    l = np.tile(np.asarray(p["l"])[:1], (B, 1))
    u = np.tile(np.asarray(p["u"])[:1], (B, 1))
    for j in range(dims.Nb + 1):
        l[[3, 7, 12], dims.n_eq + j * 5 + 4] = 1e3
    l[1::2, :4] -= 0.005
    st = jadmm.ADMMSettings(**PALLAS, pallas_tile=4, max_iter=2000,
                            overtime_div=4)
    warm = {f: np.asarray(getattr(j1.state, f))[[0] * B]
            for f in ("xbar", "ybar", "zbar", "rho_scale", "minv", "ref_coef")}
    for f in ("xbar", "ybar", "zbar", "minv", "ref_coef"):
        warm[f][12:] = 0.0
    warm["rho_scale"][12:] = [0.01, 0.1, 10.0, 100.0]
    state = jadmm.init_state(p["prob"], B, st)._replace(
        **{f: jnp.asarray(v) for f, v in warm.items()},
        minv_ok=jnp.ones((), dtype=bool))
    rj = jadmm.admm_solve(p["prob"], tuple(map(jnp.asarray, coeffs)),
                          jnp.asarray(l), jnp.asarray(u), state, st)
    return coeffs, l, u, state, rj


def test_overtime_cascade_matches_jax_and_single_lane(setup, cascade):
    coeffs, l, u, state, rj = cascade
    tp = setup["tp"]
    args = (tp, tuple(map(_t, coeffs)), _t(l), _t(u), _tstate(state))
    base = tadmm.ADMMSettings(**PALLAS, pallas_tile=4, max_iter=2000)
    widths = [a[0].shape[0] for a, _ in capture_chunks(
        *args, base._replace(overtime_div=4))]
    assert {8, 4} <= set(widths), widths
    r_two = tadmm.admm_solve(*args, base._replace(overtime_div=4))
    _assert_solve_matches(r_two, rj)
    r_one = tadmm.admm_solve(*args, base._replace(overtime_div=0))
    assert torch.equal(r_one.status, r_two.status)
    assert torch.equal(r_one.done_iters, r_two.done_iters)
    ok, err = _row_close(r_two.x.numpy(), r_one.x.numpy(), 1e-9)
    assert ok, err
    ok, err = _row_close(r_two.state.xbar.numpy(), r_one.state.xbar.numpy(),
                         1e-9)
    assert ok, err


def test_refresh_compaction_is_exact(setup):
    """The compacted needy refresh (K=4 slots for the 4 flipped problems)
    and the full-width one give the same solve."""
    tp, B, j1 = setup["tp"], setup["p"]["B"], setup["j1"]
    c1, c2, s = setup["coeffs"]
    flip = torch.tensor([True, False] * 4)
    coeffs = (torch.where(flip, -c1, c1), torch.where(flip, -c2, c2), s)
    out = []
    for div in (2, 0):
        st = tadmm.ADMMSettings(**PALLAS, pallas_tile=4,
                                refresh_compact_div=div)
        out.append(tadmm.admm_solve(tp, coeffs, setup["l"], setup["u"],
                                    _tstate(j1.state), st))
    assert torch.equal(out[0].status, out[1].status)
    assert torch.equal(out[0].done_iters, out[1].done_iters)
    ok, err = _row_close(out[0].x.numpy(), out[1].x.numpy(), 1e-12)
    assert ok, err


# ---------------------------------------------------------------------------
# closed loop
# ---------------------------------------------------------------------------

def test_closed_loop_matches_jax():
    """The closed loop of ``tests/test_admm_pallas.py:164-211`` (Nx=40,
    noise 0.3 held 10 steps, 30 steps, max_iter=500), B=2, in 'pallas'
    mode through both packages on the same numpy draws."""
    mpc, fail, debris = flagship_parts(Nx=40)
    sim = sim_conditions(False, Noise((0.3, 0.3), 10), 15.0)
    jst = jadmm.ADMMSettings(max_iter=500, **PALLAS)
    jeng = jdisc.build_engine(sim, mpc, fail, debris, settings=jst,
                              dtype=jnp.float64)
    draws = np.random.RandomState(9).normal(
        size=(jeng.nsim // jeng.noise_rep + 2, 2, 4))
    j = jax.tree.map(np.asarray, jax.jit(jdisc.rollout)(
        jeng, jdisc.noise_sequence_from_draws(jeng, draws)))
    tst = tadmm.ADMMSettings(max_iter=500, **PALLAS)
    teng = tdisc.build_engine(sim, mpc, fail, debris, settings=tst,
                              dtype=torch.float64, device="cpu")
    t = tdisc.rollout(teng, tdisc.noise_sequence_from_draws(teng, draws))
    assert t.status.shape == (30, 2)
    for name in ("status", "ctrl_seq", "i_term", "success", "done_iters"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(j, name), err_msg=name)
    np.testing.assert_allclose(t.x_true.numpy(), j.x_true, rtol=0, atol=1e-8)
