"""The hand-written CUDA kernels against their plain torch twins, on a GPU.

Imports neither JAX nor the test configuration's JAX setup, so it runs on a
machine with the card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Elsewhere every test here skips. Inputs are real. For ``eig_chunk``: the
first chunk of a warm-started port solve on the ``tests/test_admm_eig.py``
problem (Nx=40, B=8, tile 4, all four combos, debris on half the rows, two
inactive problems), and a chunk of an infeasible solve in which the Farkas
certificate fires; its slot groups (S slots per block) are held to the
one-slot instance bit for bit on those tiles widened from 4 to 8 slots.
For the 'pallas' kernels (``admm_chunk``, ``ns_fused``,
``newton_schulz_inverse``): the ``tests/test_admm_pallas.py`` problem
(Nx=40 unpadded, nz=201, m=406, B=8) through ``pallas_inputs``. Tolerance
1e-10 per row in fp64: each kernel and its twin run the same arithmetic in
another summation order, over 25 chunk iterations or 45 Newton–Schulz
steps. The six probe kernels (fp32 inputs, in each of the three
precisions) run on the probe's unit-gain inputs at nz=32, m=64, B=8, bt=4,
at a ragged nz=40 (B=6, bt=3) and at nz=38 (rows not 16-byte multiples:
the cp.async staging), held to their twins to 1e-5 per row
(``kernel_probe.check_against_twin``: 'high' to ``HIGH_TOL`` over more than
one iteration; the bf16 kernel and the 'default' ones at one iteration,
and over more on matrices where their arithmetic is exact). ``rk4_tick`` (one tick of the continuous plant's 500 RK4 substeps)
runs on ``tick_inputs`` against its twin on the card: in fp64 the masks
(alive, termination substep, success) equal and the states within 1e-9;
in fp32 each scenario's states within 1e-4 of the fp32 twin or no farther
from the fp64 twin than 4x the fp32 twin plus 1e-4. A B=8 continuous
closed loop on the card equals the CPU's, and so does the mixed sweep's
noisy offset-free in-track discrete engine ('eig'). ``torch.profiler`` records one kernel event for one ``eig_chunk`` call
(``tools/profile_step``'s instrument). The sweeps: a world-1 NCCL
``run_sweep`` on the card equals the CPU's ``chunk_stats`` on its chunks'
draws, and a batch on the card gives its two halves' outcomes (fp64 'eig').
The oracle tools: ``deviation_bench.replay`` of 3 recorded QPs on the card
equals the CPU's ('eig' fp32, 'chol' fp64), and the continuous fp64 engine
on the card holds the JAX tool's parity criteria against the NumPy oracle
at T=10 s. Production fp32 'eig' docks at least 16 of 32 runs at
sigma=0.01 and 8 of 8 without noise (``tests/test_tpu_success.py``).
"""

import json
import os

import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu_torch.config import Noise, SimConditions
from mpc_arpo_project_tpu_torch.ops import admm, admm_eig, admm_pallas
from mpc_arpo_project_tpu_torch.ops import constraints, rk4_tick
from mpc_arpo_project_tpu_torch.parallel import mc, mesh as mesh_lib
from mpc_arpo_project_tpu_torch.rollout import continuous, discrete
from mpc_arpo_project_tpu_torch.tools import continuous_fullscale
from mpc_arpo_project_tpu_torch.tools import deviation_bench
from mpc_arpo_project_tpu_torch.tools import kernel_probe as kp
from mpc_arpo_project_tpu_torch.tools import profile_step
from mpc_arpo_project_tpu_torch.utils.timing import profile_trace
# pytest puts this file's directory on sys.path. Import the helpers from
# there: a regular package named ``tests`` installed elsewhere shadows
# the repository's ``tests`` directory, which has no ``__init__.py``.
from torch_helpers import (
    chunk_inputs, flagship_parts, in_track_rollout, pallas_inputs,
    radial_c_plant, static_problem, sweep_engine, tick_inputs)

TOL = 1e-10
pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _problem(solve_mode):
    """The port's own build of the Nx=40 problem in fp64 on the CPU
    ('eig': padded, as ``tests/test_admm_eig.py`` builds it; 'pallas':
    unpadded, as ``tests/test_admm_pallas.py`` does), with B=8 copies of
    the bounds at the initial state."""
    static, dims, sim = static_problem(40)
    settings = admm.ADMMSettings(solve_mode=solve_mode, pallas_tile=4)
    prob = admm.prepare_problem(static, dims, settings, dtype=torch.float64,
                                device="cpu")
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    geom = constraints.make_geometry(sim, flagship_parts()[2])
    xe = t(np.concatenate([sim.x0, [0.0, 0.0]]))[None]
    lineq, uineq = constraints.assemble_bounds(
        constraints.configure(geom, xe), xe, dims, t(static.umin),
        t(static.umax), geom.is_reject[None])
    B = 8
    leq = t(static.leq)[None]
    l = torch.cat([leq, lineq], 1).expand(B, -1).clone()
    u = torch.cat([leq, uineq], 1).expand(B, -1).clone()
    return prob, dims, l, u


@pytest.fixture(scope="module")
def chunks(gpu):
    """Two real ``eig_chunk`` inputs."""
    prob, dims, l, u = _problem("eig")
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    coeffs = (t([1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0]),
              t([1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0]),
              t([0.0, 0.0, 0.0, 0.0, 1.9, -2.4, 0.7, -0.4]))
    return chunk_inputs(prob, dims, coeffs, l, u)


@pytest.fixture(scope="module")
def pallas(gpu):
    """Real inputs of the three 'pallas' kernels."""
    prob, _, l, u = _problem("pallas")
    return pallas_inputs(prob, l, u)


def _to(args, kw, device):
    mv = lambda v: v.to(device) if torch.is_tensor(v) else v
    return tuple(mv(v) for v in args), {k: mv(v) for k, v in kw.items()}


@pytest.mark.parametrize("case", ["warm", "infeasible"])
def test_cuda_kernel_matches_twin(gpu, chunks, case):
    """fp64 kernel against the twin on the CPU: x, y, z and stats 0-3 and
    6-7 to 1e-10 per row, pinf/dinf identical, done rows passed through,
    one launch counted per call."""
    a, k = chunks[case]
    ref = admm_eig.eig_chunk_ref(*a, **k)
    ac, kc = _to(a, k, gpu)
    n0 = admm_eig.eig_chunk.launches
    out = [o.cpu() for o in admm_eig.eig_chunk(*ac, **kc)]
    torch.cuda.synchronize()
    assert admm_eig.eig_chunk.launches == n0 + 1
    live = ~k["done"]
    assert int(live.sum()) >= 6
    for o, r in zip(out[:3], ref[:3]):
        scale = r.abs().amax(1).clamp(min=1e-300)
        assert (((o - r).abs().amax(1) / scale)[live] <= TOL).all()
    for col in (0, 1, 2, 3, 6, 7):
        torch.testing.assert_close(out[3][live, col], ref[3][live, col],
                                   rtol=TOL, atol=0.0)
    assert torch.equal(out[3][:, 4:6], ref[3][:, 4:6])
    if case == "infeasible":
        assert (out[3][:, 4] > 0).any()
    done = k["done"]
    for o, v in zip(out[:3], a[7:10]):
        assert torch.equal(o[done], v[done])
    assert (out[3][done] == 0).all()


def test_cuda_profiler_sees_one_eig_chunk_kernel(gpu, chunks, tmp_path):
    """``torch.profiler`` records the kernel the port launches through
    ``ctypes``: one ``eig_chunk`` call under the profiler (the library built
    before it) is one kernel event of ``eig_chunk_kernel`` in the Chrome
    trace, and one launch counted by the wrapper; so is a call in the
    cluster layout (fp32), whose one event is the cluster kernel's."""
    a, k = chunks["warm"]
    ac, kc = _to(a, k, gpu)
    a32, k32 = _on_card(a, k, torch.float32, gpu)
    k32 = dict(k32, n_live=int((~k32["done"]).sum()), layout=(8, 1))
    for i, (args, kw) in enumerate(((ac, kc), (a32, k32))):
        admm_eig.eig_chunk(*args, **kw)  # built, shapes' waves asked
        torch.cuda.synchronize()
        n0 = admm_eig.eig_chunk.launches
        out = tmp_path / str(i)
        with profile_trace(str(out)):
            admm_eig.eig_chunk(*args, **kw)
            torch.cuda.synchronize()
        assert admm_eig.eig_chunk.launches == n0 + 1
        with open(out / "trace.json") as fh:
            events = json.load(fh)["traceEvents"]
        assert profile_step.kernel_events(events, "eig_chunk_kernel") == 1
        assert profile_step.kernel_events(
            events, "eig_chunk_kernel_cluster") == i
        agg = profile_step.aggregate(events, 1, 10)
        assert agg["device"] is not None
        assert 0.0 <= agg["device"]["idle_share"] <= 1.0


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take(gpu, chunks):
    """No fallback: an unsupported dtype or a tensor left on the CPU
    raises, and no launch is counted."""
    a, k = chunks["warm"]
    ac, kc = _to(a, k, gpu)
    n0 = admm_eig.eig_chunk.launches
    a16 = tuple(v.half() if v.is_floating_point() else v for v in ac)
    k16 = {kk: (v.half() if torch.is_tensor(v) and v.is_floating_point()
                else v) for kk, v in kc.items()}
    with pytest.raises(TypeError):
        admm_eig.eig_chunk(*a16, **k16)
    mixed = list(ac)
    mixed[1] = a[1]  # tinv on the CPU
    with pytest.raises(ValueError, match="tinv"):
        admm_eig.eig_chunk(*mixed, **kc)
    assert admm_eig.eig_chunk.launches == n0


def _rows_within(out, ref, rows, tol):
    out, ref = out[rows].reshape(int(rows.sum()), -1), ref[rows].reshape(
        int(rows.sum()), -1)
    scale = ref.abs().amax(1).clamp(min=1e-300)
    return bool((((out - ref).abs().amax(1) / scale) <= tol).all())


def test_cuda_admm_chunk_matches_twin(gpu, pallas):
    """fp64 'pallas' chunk kernel against the twin on the CPU: x, y, z and
    stats 0-3 and 6-7 to 1e-10 per row, pinf/dinf identical, done rows
    passed through with zero stats, one launch per call."""
    a, k = pallas["chunk"]
    ref = admm_pallas.admm_chunk_ref(*a, **k)
    ac, kc = _to(a, k, gpu)
    n0 = admm_pallas.admm_chunk.launches
    out = [o.cpu() for o in admm_pallas.admm_chunk(*ac, **kc)]
    torch.cuda.synchronize()
    assert admm_pallas.admm_chunk.launches == n0 + 1
    live = ~k["done"]
    assert int(live.sum()) == 6
    for o, r in zip(out[:3], ref[:3]):
        assert _rows_within(o, r, live, TOL)
    for col in (0, 1, 2, 3, 6, 7):
        torch.testing.assert_close(out[3][live, col], ref[3][live, col],
                                   rtol=TOL, atol=0.0)
    assert torch.equal(out[3][:, 4:6], ref[3][:, 4:6])
    done = k["done"]
    for o, v in zip(out[:3], a[6:9]):
        assert torch.equal(o[done], v[done])
    assert (out[3][done] == 0).all()


@pytest.mark.parametrize("cold", [False, True])
def test_cuda_ns_fused_matches_twin(gpu, pallas, cold):
    """fp64 Newton–Schulz refresh kernel against the twin: needy rows to
    1e-10 per row, residuals to 1e-10; rows without need, one of them
    +inf and one NaN, pass through bit for bit with residual 0."""
    X_prev = pallas["X_warm"].clone()
    need = pallas["need"]
    X_prev[1] = torch.inf
    X_prev[4] = torch.nan
    n_iter = 45 if cold else 3
    args = (pallas["stack"], pallas["w"], X_prev, need)
    xr, rr = admm_pallas.ns_fused_ref(*args, n_iter=n_iter, cold=cold)
    n0 = admm_pallas.ns_fused.launches
    xk, rk = admm_pallas.ns_fused(*(v.to(gpu) for v in args), n_iter=n_iter,
                                  cold=cold)
    xk, rk = xk.cpu(), rk.cpu()
    torch.cuda.synchronize()
    assert admm_pallas.ns_fused.launches == n0 + 1
    assert _rows_within(xk, xr, need, TOL)
    torch.testing.assert_close(rk, rr, rtol=0.0, atol=TOL)
    assert torch.equal(xk[~need & ~torch.isnan(X_prev[:, 0, 0])],
                       X_prev[~need & ~torch.isnan(X_prev[:, 0, 0])])
    assert torch.isnan(xk[4]).all()
    assert (rk[~need] == 0).all()


def test_cuda_newton_schulz_inverse_matches_twin(gpu, pallas):
    M = pallas["M"]
    X0 = admm_pallas.cold_start_inverse(M)
    xr, rr = admm_pallas.newton_schulz_inverse_ref(M, X0, n_iter=45)
    n0 = admm_pallas.newton_schulz_inverse.launches
    xk, rk = admm_pallas.newton_schulz_inverse(M.to(gpu), X0.to(gpu),
                                               n_iter=45)
    xk, rk = xk.cpu(), rk.cpu()
    assert admm_pallas.newton_schulz_inverse.launches == n0 + 1
    assert _rows_within(xk, xr, torch.ones(M.shape[0], dtype=torch.bool), TOL)
    torch.testing.assert_close(rk, rr, rtol=0.0, atol=TOL)
    assert float(rk.max()) < 1e-10


def _same(a, b):
    """Bit for bit, NaN where NaN (torch.equal calls two NaNs unequal)."""
    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _ns_case(kernel, args, kw, gpu, n_need, rows=None):
    """One kernel call on the card (launch counted) against its twin on
    the card: the rows in ``rows`` (default: every finite twin row) to
    1e-10 per row, their residuals to 1e-10; returns the kernel's result."""
    plain = (admm_pallas.ns_fused_ref if kernel is admm_pallas.ns_fused
             else admm_pallas.newton_schulz_inverse_ref)
    ag = tuple(v.to(gpu) for v in args)
    xr, rr = plain(*ag, **kw)
    n0 = kernel.launches
    xk, rk = kernel(*ag, **kw, n_need=n_need)
    torch.cuda.synchronize()
    assert kernel.launches == n0 + 1
    if rows is None:
        rows = torch.isfinite(xr).flatten(1).all(1)
    assert _rows_within(xk, xr, rows, TOL)
    torch.testing.assert_close(rk[rows], rr[rows], rtol=0.0, atol=TOL)
    return xk, rk


def _rand_ns(n, B, seed):
    """A (7, n, n) stack, (B, 8) weights and the (B, n, n) M they make:
    a well-conditioned symmetric base plus six small symmetric terms."""
    rng = np.random.default_rng(seed)
    sym = lambda a: (a + a.T) / (2.0 * np.sqrt(n))
    base = sym(rng.standard_normal((n, n))) + 3.0 * np.eye(n)
    stack = np.stack([base] + [0.1 * sym(rng.standard_normal((n, n)))
                               for _ in range(6)])
    w = np.zeros((B, 8))
    w[:, 0] = 1.0
    w[:, 1:7] = rng.uniform(0.2, 1.0, (B, 6))
    st, wt = torch.as_tensor(stack), torch.as_tensor(w)
    return st, wt, admm_pallas._stack_matrix(st, wt).contiguous()


@pytest.mark.parametrize("cold", [False, True])
@pytest.mark.parametrize("needy", [8, 72])
def test_cuda_ns_fused_both_tiles(gpu, pallas, cold, needy):
    """Nine copies of the fixture's 8 problems (n=201): 8 needy rows with
    n_need=8 take the 64x64 tile, 72 the 128-row tile; both against the
    twin, and n_need=None (72 slots, the 128-row tile) gives the same bits
    as n_need=count."""
    B = 72
    w = pallas["w"].repeat(9, 1)
    X = admm_pallas.cold_start_inverse(pallas["M"]).repeat(9, 1, 1) \
        if cold else pallas["X_warm"].repeat(9, 1, 1)
    need = torch.zeros(B, dtype=torch.bool)
    need[torch.randperm(B, generator=torch.Generator().manual_seed(needy))
         [:needy]] = True
    assert admm_pallas.ns_tile(needy, 201) == (64 if needy == 8 else 128)
    args = (pallas["stack"], w, X, need)
    kw = dict(n_iter=45 if cold else 3, cold=cold)
    xk, rk = _ns_case(admm_pallas.ns_fused, args, kw, gpu, needy,
                      rows=need.to(gpu))
    xn, rn = admm_pallas.ns_fused(*(v.to(gpu) for v in args), **kw)
    assert _same(xn, xk) and _same(rn, rk)
    assert _same(xk[~need], X[~need].to(gpu)) and (rk[~need] == 0).all()


@pytest.mark.parametrize("B", [8, 72])
def test_cuda_newton_schulz_inverse_both_tiles(gpu, pallas, B):
    M = pallas["M"].repeat(B // 8, 1, 1)
    X0 = admm_pallas.cold_start_inverse(M)
    assert admm_pallas.ns_tile(B, 201) == (64 if B == 8 else 128)
    xk, rk = _ns_case(admm_pallas.newton_schulz_inverse, (M, X0),
                      dict(n_iter=45), gpu, B)
    xn, rn = admm_pallas.newton_schulz_inverse(M.to(gpu), X0.to(gpu), 45)
    assert _same(xn, xk) and _same(rn, rk)
    assert float(rk.max()) < 1e-10


@pytest.mark.parametrize("n", [40, 201])
@pytest.mark.parametrize("n_iter", [0, 2, 45])
def test_cuda_ns_ragged_and_n_iter(gpu, n, n_iter):
    """Random problems at n=40 (16-byte B copies) and n=201 (element
    copies; both ragged against every tile), warm and cold, n_iter 0 (the
    residual of the start alone) to 45; newton_schulz_inverse on the same M."""
    B = 6
    stack, w, M = _rand_ns(n, B, seed=n + n_iter)
    X_warm = torch.linalg.inv(M * 1.01).contiguous()
    need = torch.tensor([True, False, True, True, False, True])
    for cold in (False, True):
        for n_need in (None, 4):
            _ns_case(admm_pallas.ns_fused, (stack, w, X_warm, need),
                     dict(n_iter=n_iter, cold=cold), gpu, n_need,
                     rows=need.to(gpu))
    _ns_case(admm_pallas.newton_schulz_inverse, (M, X_warm),
             dict(n_iter=n_iter), gpu, None)


def test_cuda_ns_fused_no_need_passes_through(gpu, pallas):
    """No row needy: every row, +inf and NaN ones too, passes through bit
    for bit with residual 0, with n_need=0 (no product at all) or None."""
    X = pallas["X_warm"].clone()
    X[1] = torch.inf
    X[4] = torch.nan
    need = torch.zeros(8, dtype=torch.bool)
    args = tuple(v.to(gpu) for v in (pallas["stack"], pallas["w"], X, need))
    for n_need in (0, None):
        for cold in (False, True):
            xk, rk = admm_pallas.ns_fused(*args, n_iter=3, cold=cold,
                                          n_need=n_need)
            assert _same(xk, args[2]) and (rk == 0).all()


@pytest.mark.parametrize("cold", [False, True])
def test_cuda_ns_fused_poisoned_rows(gpu, pallas, cold):
    """+inf and NaN inverses on needy rows (non-finite after a warm
    refresh, finite after a cold one, which ignores X_prev) and on rows
    without need (passed through bit for bit)."""
    X = pallas["X_warm"].clone()
    need = pallas["need"]  # rows 0 2 3 5 6 needy
    X[0] = torch.inf
    X[2] = torch.nan
    X[1] = torch.inf
    X[4] = torch.nan
    args = (pallas["stack"], pallas["w"], X, need)
    kw = dict(n_iter=45 if cold else 3, cold=cold)
    held = need.clone()
    if not cold:
        held[[0, 2]] = False
    xk, rk = _ns_case(admm_pallas.ns_fused, args, kw, gpu,
                      int(need.sum()), rows=held.to(gpu))
    fin = torch.isfinite(xk).flatten(1).all(1).cpu()
    assert bool(fin[0]) == cold and bool(fin[2]) == cold
    assert _same(xk[~need], X[~need].to(gpu)) and (rk[~need] == 0).all()


def test_cuda_pallas_wrappers_reject_what_the_kernels_do_not_take(gpu,
                                                                  pallas):
    """No fallback: fp16, or a tensor left on the CPU, raises at each
    'pallas' entry, and no launch is counted."""
    a, k = pallas["chunk"]
    ac, kc = _to(a, k, gpu)
    counts = lambda: (admm_pallas.admm_chunk.launches,
                      admm_pallas.ns_fused.launches,
                      admm_pallas.newton_schulz_inverse.launches)
    n0 = counts()
    half = lambda v: v.half() if torch.is_tensor(v) and v.is_floating_point() else v
    with pytest.raises(TypeError):
        admm_pallas.admm_chunk(*map(half, ac),
                               **{kk: half(v) for kk, v in kc.items()})
    mixed = list(ac)
    mixed[0] = a[0]  # minv on the CPU
    with pytest.raises(ValueError, match="minv"):
        admm_pallas.admm_chunk(*mixed, **kc)
    st, w, X, need = (pallas[n].to(gpu) for n in ("stack", "w", "X_warm",
                                                  "need"))
    with pytest.raises(TypeError):
        admm_pallas.ns_fused(st.half(), w.half(), X.half(), need, n_iter=1,
                             cold=False)
    with pytest.raises(ValueError, match="stack"):
        admm_pallas.ns_fused(pallas["stack"], w, X, need, n_iter=1,
                             cold=False)
    with pytest.raises(ValueError, match="M"):
        admm_pallas.newton_schulz_inverse(pallas["M"], X, 1)
    assert counts() == n0


@pytest.mark.parametrize("precision", ["highest", "high", "default"])
@pytest.mark.parametrize("n_it", [1, 25])
@pytest.mark.parametrize("shape", [(8, 4, 32, 64), (6, 3, 40, 72),
                                   (4, 2, 38, 70)])
@pytest.mark.parametrize("name", ["matvec_pair", "minv_rowvec", "minv_lhs",
                                  "minv_bf16", "minv_blockdiag", "stack7"])
def test_cuda_probe_kernel_matches_twin(gpu, name, shape, n_it, precision):
    """Each probe kernel against its twin in each precision: rows within
    1e-5, one launch counted per call ('high' within ``HIGH_TOL`` over
    ``n_it``; the bf16 kernel and every 'default' one at one iteration on
    these inputs, and over ``n_it`` on ``exact_inputs``, where their
    arithmetic is exact)."""
    B, bt, nz, m = shape
    inputs = kp.make_inputs(B, bt, nz, m, device=gpu, unit_gain=True)
    kp.check_against_twin(name, inputs, n_it, precision)


def test_cuda_probe_wrappers_reject_what_the_kernels_do_not_take(gpu):
    inputs = kp.make_inputs(8, 4, 32, 64, device=gpu)
    n0 = kp.minv_rowvec.launches
    with pytest.raises(TypeError):
        kp.minv_rowvec(inputs["x"].double(), inputs["minv"].double(), 1)
    with pytest.raises(ValueError, match="mat"):
        kp.minv_rowvec(inputs["x"], inputs["minv"].cpu(), 1)
    with pytest.raises(ValueError, match="bt"):
        kp.minv_blockdiag(inputs["x"], inputs["mflat"], 1, 3)
    with pytest.raises(ValueError, match="precision"):
        kp.minv_rowvec(inputs["x"], inputs["minv"], 1, precision="fastest")
    wide = kp.make_inputs(8, 4, 264, 64, device=gpu)
    n7 = kp.stack7.launches
    with pytest.raises(ValueError, match="nz"):
        kp.stack7(wide["x"], wide["s7"], 1)
    assert kp.minv_rowvec.launches == n0 and kp.stack7.launches == n7


def test_cuda_compaction_is_bit_exact(gpu):
    """On the card the chunk kernel works one block per slot, so moving
    problems between slots changes nothing: in fp64 the 'eig' solve with
    straggler compaction off, or at other boundaries, equals the default
    bit for bit (on a CPU the batched BLAS products of the twin break this;
    ``tests/test_torch_admm.py``)."""
    prob, _, l, u = _problem("eig")
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    coeffs = (t([1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0]),
              t([1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0]),
              t([0.0, 0.0, 0.0, 0.0, 1.9, -2.4, 0.7, -0.4]))
    mv = lambda v: v.to(gpu) if torch.is_tensor(v) else v
    probg = admm.ADMMProblem(*(mv(f) for f in prob))
    coeffs, l, u = tuple(mv(c) for c in coeffs), mv(l), mv(u)

    def solve(**kw):
        st = admm.ADMMSettings(solve_mode="eig", pallas_tile=4, max_iter=2000,
                               **kw)
        return admm.admm_solve(probg, coeffs, l, u,
                               admm.init_state(probg, 8, st), st)

    base = solve()
    for chunks in ((), (1, 2, 4, 8)):
        r = solve(eig_compact_chunks=chunks)
        assert torch.equal(r.status, base.status), chunks
        assert torch.equal(r.done_iters, base.done_iters), chunks
        assert torch.equal(r.x, base.x), chunks
        assert torch.equal(r.state.minv, base.state.minv), chunks



def _widen(a, k, f):
    """The chunk inputs with each tile of ``bt`` slots followed by ``f - 1``
    copies of itself: tiles of ``f * bt`` slots of one combo, so that every
    slots-per-block S up to ``f * bt`` is allowed, and each slot's result
    can be held against its copies' (a slot's position moves no bit)."""
    bt = k["bt"]

    def per_slot(t):
        tiles = t.reshape(-1, bt, *t.shape[1:])
        return tiles.repeat(1, f, *([1] * (t.dim() - 1))).reshape(
            -1, *t.shape[1:]).contiguous()

    # args 1-9 are per slot: tinv, scal, qbar, lbar, ubar, dg, x, y, z
    a2 = tuple(per_slot(v) if 1 <= i <= 9 else v for i, v in enumerate(a))
    return a2, dict(k, bt=f * bt, done=per_slot(k["done"]))


def _on_card(a, k, dtype, gpu):
    cv = lambda v: (v.to(gpu, dtype) if v.is_floating_point() else v.to(gpu))
    return (tuple(cv(v) for v in a),
            {kk: cv(v) if torch.is_tensor(v) else v for kk, v in k.items()})


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["warm", "infeasible", "ragged"])
def test_cuda_slot_groups_are_bit_identical(gpu, chunks, dtype, case):
    """Every slots-per-block S the type allows (up to 8 in fp32, 2 in
    fp64), and in fp32 every cluster layout (C blocks a live slot, C in
    ``CLUSTERS``), gives the one-slot (S = 1) instance's x, y, z and stats
    bit for bit, and so does the policy's layout for the live count (a
    cluster in fp32, where the live slots fit one wave): on the fixture's
    tiles of 4 widened to 8 (so S = 8 runs in fp32), with groups that mix
    done and live slots ('warm' has two inactive problems; 'ragged' leaves
    5 live slots of each copy, 10 in all), and each slot equal to its copy
    in the widened tile."""
    a, k = chunks["infeasible" if case == "infeasible" else "warm"]
    if case == "ragged":
        done = k["done"].clone()
        done[torch.nonzero(~done).squeeze(1)[5:]] = True
        k = dict(k, done=done)
    ag, kg = _on_card(*_widen(a, k, 2), dtype, gpu)
    bt, n_live = kg["bt"], int((~kg["done"]).sum())
    assert case != "ragged" or n_live == 10
    groups = [S for S in (1, 2, 4, 8)
              if S <= admm_eig.GROUP_CAP[dtype] and bt % S == 0]
    assert groups[-1] == (8 if dtype == torch.float32 else 2)
    outs = {}
    for S in groups:
        n0 = admm_eig.eig_chunk.launches
        outs[S] = admm_eig.eig_chunk(*ag, **kg, layout=(1, S))
        torch.cuda.synchronize()
        assert admm_eig.eig_chunk.launches == n0 + 1
    for C in admm_eig.CLUSTERS[dtype]:
        n0 = admm_eig.eig_chunk.launches
        outs[(C, 1)] = admm_eig.eig_chunk(*ag, **kg, n_live=n_live,
                                          layout=(C, 1))
        torch.cuda.synchronize()
        assert admm_eig.eig_chunk.launches == n0 + 1
    assert len(admm_eig.CLUSTERS[dtype]) == (
        4 if dtype == torch.float32 else 0)
    outs["policy"] = admm_eig.eig_chunk(*ag, **kg, n_live=n_live)
    nz, m, K, gw = ag[7].shape[1], ag[8].shape[1], ag[1].shape[1], \
        ag[16].shape[1]
    policy = admm_eig.eig_layout(n_live, bt, dtype, admm_eig._waves(
        dtype, nz, m, K, gw, gpu))
    assert (policy[0] > 1) == (dtype == torch.float32), policy
    for S, out in outs.items():
        for o, r in zip(out, outs[1]):
            assert _same(o, r), S
    for o in outs[1]:
        tiles = o.reshape(-1, 2, bt // 2, o.shape[1])
        assert _same(tiles[:, 0], tiles[:, 1])


def test_cuda_wrapper_rejects_a_group_the_kernel_does_not_take(gpu, chunks):
    """A layout (1, S) whose slots per block S does not divide bt, is not a
    power of two, or exceeds the type's cap raises, and so does a cluster
    layout in fp64, a cluster size the kernel does not take, or a cluster
    of more than one slot; no launch is counted."""
    a, k = chunks["warm"]
    n0 = admm_eig.eig_chunk.launches
    for dtype, S in ((torch.float32, 8), (torch.float64, 4),
                     (torch.float64, 3), (torch.float32, 16),
                     (torch.float32, 0)):
        with pytest.raises(ValueError, match="group"):
            admm_eig.eig_chunk(*_on_card(a, k, dtype, gpu)[0],
                               **_on_card(a, k, dtype, gpu)[1], layout=(1, S))
    for dtype, lay in ((torch.float64, (8, 1)), (torch.float64, (2, 1)),
                       (torch.float32, (3, 1)), (torch.float32, (32, 1)),
                       (torch.float32, (8, 2))):
        with pytest.raises(ValueError, match="layout"):
            admm_eig.eig_chunk(*_on_card(a, k, dtype, gpu)[0],
                               **_on_card(a, k, dtype, gpu)[1], layout=lay)
    assert k["bt"] % 8
    assert admm_eig.eig_chunk.launches == n0


@pytest.mark.parametrize("C", [2, 4, 8, 16])
def test_cuda_cluster_marks_live_slots_past_n_live(gpu, chunks, C):
    """A cluster call given one live slot fewer than it has computes the
    first ``n_live`` live slots as the one-slot instance does, copies the
    done slots through, and gives the last live slot, which no cluster
    took, NaN x, y, z and stats (so the solver resets its row)."""
    a, k = chunks["warm"]
    ag, kg = _on_card(*_widen(a, k, 2), torch.float32, gpu)
    live = torch.nonzero(~kg["done"]).squeeze(1)
    ref = admm_eig.eig_chunk(*ag, **kg, layout=(1, 1))
    out = admm_eig.eig_chunk(*ag, **kg, n_live=live.numel() - 1,
                             layout=(C, 1))
    torch.cuda.synchronize()
    last = int(live[-1])
    for o, r in zip(out, ref):
        assert torch.isnan(o[last]).all()
        assert _same(o[live[:-1]], r[live[:-1]])
        assert _same(o[kg["done"]], r[kg["done"]])


def _pallas_case(pallas, case):
    """The fixture's chunk (B=8, 6 live rows) with only its first
    ``case`` live rows live, or (``case`` = 'wide') three copies of its rows
    (B=24, 18 live), so that groups of 8 slots fill."""
    a, k = pallas["chunk"]
    if case == "wide":
        a = tuple(v.repeat(3, *([1] * (v.dim() - 1))).contiguous()
                  if i < 10 else v for i, v in enumerate(a))
        return a, dict(k, done=k["done"].repeat(3))
    done = k["done"].clone()
    done[torch.nonzero(~done).squeeze(1)[case:]] = True
    return a, dict(k, done=done)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", [1, 3, 6, "wide"])
def test_cuda_admm_layouts_are_bit_identical(gpu, pallas, dtype, case):
    """Every layout (cluster size C, slots per block S) the kernel takes in
    the type gives the x, y, z and stats of C = S = 1 bit for bit, and so
    does the policy's layout for the live count; done rows pass through
    with zero stats in every layout, and each copy of a row in the widened
    case equals the row."""
    a, k = _pallas_case(pallas, case)
    ag, kg = _on_card(a, k, dtype, gpu)
    n_live = int((~kg["done"]).sum())
    outs = {}
    for lay in admm_pallas.LAYOUTS[dtype]:
        n0 = admm_pallas.admm_chunk.launches
        outs[lay] = admm_pallas.admm_chunk(*ag, **kg, n_live=n_live,
                                           layout=lay)
        torch.cuda.synchronize()
        assert admm_pallas.admm_chunk.launches == n0 + 1
    outs["policy"] = admm_pallas.admm_chunk(*ag, **kg, n_live=n_live)
    outs["n_live=None"] = admm_pallas.admm_chunk(*ag, **kg)
    done = kg["done"]
    for lay, out in outs.items():
        for o, r in zip(out, outs[(1, 1)]):
            assert _same(o, r), lay
        for o, v in zip(out[:3], ag[6:9]):
            assert torch.equal(o[done], v[done]), lay
        assert (out[3][done] == 0).all(), lay
        assert all(bool(torch.isfinite(o[~done]).all()) for o in out), lay
    if case == "wide":
        for o in outs[(1, 1)]:
            assert _same(o[:8], o[8:16]) and _same(o[:8], o[16:])


def test_cuda_admm_chunk_refuses_a_layout_it_does_not_take(gpu, pallas):
    """A layout outside ``LAYOUTS[dtype]`` (a two-block cluster in fp64,
    which would not fit shared memory; clusters of slot groups; sizes the
    kernel has no instance for) or an ``n_live`` beyond the rows raises,
    and no launch is counted."""
    a, k = pallas["chunk"]
    n0 = admm_pallas.admm_chunk.launches
    for dtype, lay in ((torch.float64, (2, 1)), (torch.float64, (1, 4)),
                       (torch.float32, (2, 2)), (torch.float32, (4, 1)),
                       (torch.float32, (16, 1)),
                       (torch.float32, (1, 16)), (torch.float32, (3, 1))):
        with pytest.raises(ValueError, match="layout"):
            admm_pallas.admm_chunk(*_on_card(a, k, dtype, gpu)[0],
                                   **_on_card(a, k, dtype, gpu)[1],
                                   layout=lay)
    with pytest.raises(ValueError, match="n_live"):
        admm_pallas.admm_chunk(*_on_card(a, k, torch.float32, gpu)[0],
                               **_on_card(a, k, torch.float32, gpu)[1],
                               n_live=9)
    assert admm_pallas.admm_chunk.launches == n0


def _tick_states(out):
    """x_end, x_after_first and (with telemetry) every substep's state of a
    tick, one row per scenario."""
    parts = [out[0], out[4]]
    if out[5] is not None:
        parts.append(out[5].transpose(0, 1).reshape(out[0].shape[0], -1))
    return torch.cat(parts, 1).double()


@pytest.mark.parametrize("telemetry", [False, True])
@pytest.mark.parametrize("model", ["acceleration", "delta_v", "in_track"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cuda_rk4_tick_matches_twin(gpu, dtype, model, telemetry):
    """The kernel against its twin on the same card inputs (B=300, a ragged
    last block; the draw switched every 7 substeps so that it changes
    inside the tick), one launch counted; 'in_track' terminates on the y
    axis instead of the x axis."""
    plant = radial_c_plant(dtype, is_delta_v=model == "delta_v",
                           in_track=model == "in_track", noise_int_sub=7)
    a, j = tick_inputs(plant, 300, 11)
    on = lambda v: v.to(gpu, dtype) if v.is_floating_point() else v.to(gpu)
    ag = tuple(on(v) for v in a)
    n0 = rk4_tick.rk4_tick.launches
    ker = rk4_tick.rk4_tick(*ag, j, plant, telemetry=telemetry)
    torch.cuda.synchronize()
    assert rk4_tick.rk4_tick.launches == n0 + 1
    ref = rk4_tick.rk4_tick_plain(*ag, j, plant, telemetry=telemetry)
    assert (ker[5] is None) == (not telemetry)
    # the inputs reach what they were placed for: deaths on entry and in
    # the tick, survivors and (where the x axis is the approach axis, so
    # that the docking states are not cut off first) new successes
    dead = ~a[1].to(gpu) | ~ker[1]
    assert dead.any() and ker[1].any()
    assert model == "in_track" or (ker[3] & ~ag[3]).any()
    e = (_tick_states(ker) - _tick_states(ref)).abs().amax(1)
    if dtype == torch.float64:
        for i in (1, 2, 3):
            assert torch.equal(ker[i], ref[i]), i
        assert float(e.max()) <= 1e-9
    else:
        ref64 = rk4_tick.rk4_tick_plain(*(on(v).double() if v.is_floating_point()
                                          else on(v) for v in a), j, plant,
                                        telemetry=telemetry)
        e_k = (_tick_states(ker) - _tick_states(ref64)).abs().amax(1)
        e_t = (_tick_states(ref) - _tick_states(ref64)).abs().amax(1)
        assert not ((e > 1e-4) & (e_k > 4 * e_t + 1e-4)).any()


def test_cuda_rk4_tick_refuses_what_the_kernel_does_not_take(gpu):
    """A half-precision state, a tensor left on the CPU, a strided input or
    draws that end before the tick does raise, and no launch is counted."""
    plant = radial_c_plant()
    a, j = tick_inputs(plant, 64, 2)
    ag = [v.to(gpu) for v in a]
    n0 = rk4_tick.rk4_tick.launches
    bad = [(0, ag[0].half(), TypeError), (4, a[4], ValueError),
           (5, torch.cat([ag[5], ag[5]], 1)[:, ::2], ValueError),
           (6, ag[6][:0], ValueError)]
    for i, v, err in bad:
        args = list(ag)
        args[i] = v
        with pytest.raises(err):
            rk4_tick.rk4_tick(*args, j, plant)
    assert rk4_tick.rk4_tick.launches == n0


def test_cuda_continuous_rollout_matches_cpu(gpu):
    """B=8 fp64 continuous closed loop of the radialC scenario for 3 s on
    the card (the kernels) and on the CPU (the twins): statuses, codes,
    termination substeps, success and done_iters equal, trajectories
    within 1e-6; one ``rk4_tick`` launch per tick."""
    mpc, fail, debris = flagship_parts(Nx=40)
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
        2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0),
        Noise((0.0012, 0.0012), 50), False, T_cont=1e-3, T_final=3.0)
    rng = np.random.default_rng(5)
    x0b = np.concatenate([rng.uniform(3.5, 60, (8, 1)),
                          rng.uniform(-5, 5, (8, 1)), np.zeros((8, 2))], 1)
    x0b[1] = [3.1, 0.05, -0.4, 0.0]
    x0b[3] = [0.8, 3.0, 0.1, -0.3]
    outs = []
    for device in (gpu, "cpu"):
        eng = continuous.build_engine(
            sim, mpc, fail, debris, settings=admm.ADMMSettings(max_iter=1000),
            dtype=torch.float64, device=device)
        if not outs:
            n_draws = eng.n_ticks * eng.n_sub // eng.noise_int_sub + 2
            draws = float(eng.sig_cont) * rng.standard_normal((n_draws, 8, 2))
        n0 = rk4_tick.rk4_tick.launches
        outs.append(continuous.rollout(eng, draws, torch.as_tensor(x0b)))
        if device is gpu:
            assert rk4_tick.rk4_tick.launches == n0 + eng.n_ticks - 1
    g, c = outs
    for name in ("status", "ctrl_seq", "i_term_sub", "success", "done_iters"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert float((g.x_true_ticks.cpu() - c.x_true_ticks).abs().max()) <= 1e-6
    assert int(c.i_term_sub[3]) == eng.n_sub


def test_cuda_continuous_rollout_from_the_engine_start(gpu):
    """With no initial states the loop starts every scenario at the
    engine's x0 (an expanded view, made contiguous for the kernel): one
    tick in fp32 on the card, finite and one ``rk4_tick`` launch."""
    mpc, fail, debris = flagship_parts(Nx=40)
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
        2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0),
        Noise((0.0012, 0.0012), 50), False, T_cont=1e-3, T_final=1.0)
    eng = continuous.build_engine(sim, mpc, fail, debris,
                                  settings=admm.ADMMSettings(max_iter=200),
                                  dtype=torch.float32, device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(0)
    n0 = rk4_tick.rk4_tick.launches
    out = continuous.rollout(eng, continuous.make_noise_draws(eng, gen, 4))
    assert rk4_tick.rk4_tick.launches == n0 + 1
    assert out.x_true_ticks.shape == (3, 4, 4)
    assert torch.isfinite(out.x_true_ticks).all()


def test_cuda_nccl_sweep_matches_cpu(gpu, tmp_path):
    """``run_sweep`` over an NCCL process group of one rank (fp64 'eig',
    16 scenarios in chunks of 8) launches ``eig_chunk`` and equals the
    CPU's ``chunk_stats`` on the same chunks' draws: counts exact, the
    final-distance sum within 1e-9."""
    import torch.distributed as dist

    engine = sweep_engine("eig", device=gpu)
    cpu_engine = sweep_engine("eig")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert dist.get_backend() == "nccl"
        mesh = mesh_lib.make_mesh()
        n0 = admm_eig.eig_chunk.launches
        res = mc.run_sweep(engine, total=16, chunk=8, seed=7, mesh=mesh)
        assert admm_eig.eig_chunk.launches > n0
    finally:
        dist.destroy_process_group()
    st = [mc.sharded_stats_fn(cpu_engine, None)(
        cpu_engine, mc._draw_chunk(engine, 7, ci, 8).cpu()) for ci in range(2)]
    ref = {k: sum(getattr(s, k) for s in st) for k in mc.SweepStats._fields}
    assert res["n"] == ref["n"] == 16
    assert res["ctrl_usage"] == {"mpc": ref["n_mpc"],
                                 "failsafe": ref["n_failsafe"],
                                 "deadbeat": ref["n_deadbeat"]}
    assert res["success_rate"] == ref["n_success"] / 16
    assert res["mean_i_term"] == ref["sum_i_term"] / 16
    np.testing.assert_allclose(res["mean_final_dist"],
                               ref["sum_final_dist"] / 16, rtol=1e-9)


def test_cuda_batch_composition(gpu):
    """On the card, a batch of 16 (fp64 'eig') and its two halves on the
    same draws: termination, success and controller codes per scenario
    equal, and the final-distance sums within 1e-9."""
    engine = sweep_engine("eig", device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(3)
    noise = discrete.make_noise_sequence(engine, gen, 16)
    w = discrete.rollout(engine, noise)
    a = discrete.rollout(engine, noise[:, :8])
    b = discrete.rollout(engine, noise[:, 8:])
    for name in ("i_term", "success", "ctrl_seq"):
        half = torch.cat([getattr(a, name), getattr(b, name)], -1)
        assert torch.equal(getattr(w, name), half), name
    fd = lambda o: float(mc._final_distance(o, engine.xr).sum())
    np.testing.assert_allclose(fd(w), fd(a) + fd(b), rtol=1e-9)


def test_cuda_in_track_rollout_matches_cpu(gpu):
    """The mixed sweep's in-track engine in fp64 'eig' at B=8 for 4 steps
    on the card (``eig_chunk``) and on the CPU (its twin), on the same
    inputs: statuses, codes, termination, success and done_iters equal,
    trajectories within 1e-6."""
    n0 = admm_eig.eig_chunk.launches
    g = in_track_rollout(gpu, 12)
    assert admm_eig.eig_chunk.launches > n0
    c = in_track_rollout("cpu", 12)
    for name in ("status", "ctrl_seq", "i_term", "success", "done_iters"):
        assert torch.equal(getattr(g, name).cpu(), getattr(c, name)), name
    assert float((g.x_true.cpu() - c.x_true).abs().max()) <= 1e-6


DEVSEQ = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts", "devseq_r5.npz")


@pytest.mark.parametrize("mode, dtype, tol", [
    ("eig", torch.float32, 1e-5), ("chol", torch.float64, 1e-9)])
def test_cuda_replay_matches_cpu(gpu, mode, dtype, tol):
    """``deviation_bench.replay`` of the first 3 recorded QPs on the card
    (``eig_chunk`` in 'eig') and on the CPU (its twin) in the same dtype:
    the same statuses, and per-step deviations from the oracle's truth
    within ``tol`` (fp32: a tenth of the 1e-4 BASELINE deviation bound)."""
    with np.load(DEVSEQ) as f:
        seq = [f[k][:3] for k in ("l", "u", "coeffs", "u_true")]
    n0 = admm_eig.eig_chunk.launches
    g = deviation_bench.replay(*deviation_bench.prepare(mode, dtype, gpu),
                               *seq)
    if mode == "eig":
        assert admm_eig.eig_chunk.launches > n0
    c = deviation_bench.replay(*deviation_bench.prepare(mode, dtype, "cpu"),
                               *seq)
    np.testing.assert_array_equal(g[1], c[1])
    np.testing.assert_allclose(g[0], c[0], rtol=0, atol=tol)


def test_cuda_continuous_parity_with_the_oracle(gpu):
    """The port's fp64 continuous engine on the card for 10 s (19 ticks of
    500 substeps, ``rk4_tick`` once a tick) against the NumPy oracle
    ``simulate_continuous`` on the same ``RandomState(11)`` draws: the JAX
    tool's criteria (termination substep, controller codes and success
    equal, the tick trajectory within 1e-6)."""
    eng = continuous_fullscale.build(10.0, torch.float64, gpu)
    draws = continuous_fullscale.parity_draws(eng)
    runo, wall = continuous_fullscale.oracle_run(
        10.0, draws, continuous_fullscale.oracle_scaling(eng))
    n0 = rk4_tick.rk4_tick.launches
    rec = continuous_fullscale.parity_record(eng, draws, runo, wall)
    assert rk4_tick.rk4_tick.launches == n0 + eng.n_ticks - 1
    assert rec["backend"] == "cuda"
    assert continuous_fullscale.parity_ok(rec), rec


def test_cuda_production_success_low_sigma(gpu):
    """The port's counterpart of ``tests/test_tpu_success.py``: production
    (fp32 'eig', ``eig_chunk`` on the card, stall 12/24) on the reference
    success-rate configuration (Nx=40, 300 s) docks at least half of 32
    runs at sigma=0.01 (the card's 128-run arm docked 83; the bar leaves
    about three binomial sigma of room), and all 8 noiseless runs."""
    from mpc_arpo_project_tpu_torch.tools.status_mix import build_configs

    settings = admm.ADMMSettings(max_iter=4000, solve_mode="eig",
                                 stall_exit_chunks=12, stall_tighten_chunks=24)
    eng = discrete.build_engine(*build_configs("ref", sigma=0.01),
                                settings=settings, dtype=torch.float32,
                                device=gpu)
    gen = torch.Generator(device=gpu).manual_seed(20260820)
    n0 = admm_eig.eig_chunk.launches
    out = discrete.rollout_chunked(
        eng, discrete.make_noise_sequence(eng, gen, 32), seg=10)
    assert admm_eig.eig_chunk.launches > n0
    assert int(out.success.sum()) >= 16, int(out.success.sum())
    eng0 = discrete.build_engine(*build_configs("ref", sigma=0.0),
                                 settings=settings, dtype=torch.float32,
                                 device=gpu)
    noise0 = torch.zeros((eng0.nsim, 8, 4), dtype=torch.float32, device=gpu)
    out0 = discrete.rollout_chunked(eng0, noise0, seg=10)
    assert int(out0.success.sum()) == 8
