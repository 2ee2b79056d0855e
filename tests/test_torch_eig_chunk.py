"""The port's fused 'eig' chunk and Woodbury refresh against the JAX package.

Chunk inputs are real: the first chunk of a warm-started port solve on the
``tests/test_admm_eig.py`` fixture (Nx=40, B=8, tile 4, all four combos,
debris on half the rows, two inactive problems), and the chunk of an
infeasible solve in which the Farkas certificate fires. The same numpy
arrays go through the JAX ``eig_chunk`` (Pallas, interpret mode on the CPU)
and the port's ``eig_chunk_ref``, in fp64. Tolerance 1e-10: the two run the
same arithmetic in another summation order, over 25 iterations.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm_eig as jeig
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import admm_eig as teig
from tests.test_admm_eig import _build_setup
from tests.torch_helpers import chunk_inputs
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-10


def _t(a, dtype=torch.float64):
    a = np.array(a)
    return torch.as_tensor(a, dtype=dtype if a.dtype.kind == "f" else None)


@pytest.fixture(scope="module")
def chunks():
    p = _build_setup()
    prob = tadmm.problem_from_numpy(p["prob"], dtype=torch.float64,
                                   device="cpu")
    coeffs = tuple(_t(c) for c in p["coeffs"])
    inputs = chunk_inputs(prob, p["dims"], coeffs, _t(p["l"]), _t(p["u"]))
    out = {}
    for name, (a, k) in inputs.items():
        ref_t = teig.eig_chunk_ref(*a, **k)
        ja = [jnp.asarray(v.numpy()) for v in a]
        jk = {kk: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
              for kk, v in k.items()}
        ref_j = jeig.eig_chunk(*ja, interpret=True, **jk)
        out[name] = (a, k, ref_t, [np.asarray(v) for v in ref_j])
    return out


@pytest.mark.parametrize("case", ["warm", "infeasible"])
def test_eig_chunk_ref_matches_jax(chunks, case):
    a, k, (xt, yt, zt, st), (xj, yj, zj, sj) = chunks[case]
    live = ~k["done"].numpy()
    assert live.sum() >= 6
    for name, pt, pj in (("x", xt, xj), ("y", yt, yj), ("z", zt, zj)):
        pt = pt.numpy()[live]
        pj = pj[live]
        scale = np.abs(pj).max(axis=1, keepdims=True)
        assert (np.abs(pt - pj) <= TOL * scale).all(), name
    stt, stj = st.numpy()[live], sj[live]
    for col in (0, 1, 2, 3, 6, 7):
        np.testing.assert_allclose(stt[:, col], stj[:, col], rtol=TOL, atol=0,
                                   err_msg=f"stats col {col}")
    np.testing.assert_array_equal(stt[:, 4:6], stj[:, 4:6])
    if case == "infeasible":
        assert (stt[:, 4] > 0).any()


def test_eig_chunk_ref_done_rows_pass_through(chunks):
    a, k, (xt, yt, zt, st), _ = chunks["warm"]
    done = k["done"]
    assert done.any()
    x, y, z = a[7], a[8], a[9]
    assert torch.equal(xt[done], x[done])
    assert torch.equal(yt[done], y[done])
    assert torch.equal(zt[done], z[done])
    assert (st[done] == 0).all()


def test_eig_chunk_dispatch_is_the_twin_on_cpu(chunks):
    a, k, ref, _ = chunks["warm"]
    out = teig.eig_chunk(*a, **k)
    for o, r in zip(out, ref):
        assert torch.equal(o, r)


def test_eig_chunk_raises_without_a_kernel(chunks):
    """No fallback: a tensor on a device with no kernel raises instead of
    running the twin."""
    a, k, _, _ = chunks["warm"]
    am = tuple(v.to("meta") for v in a)
    km = {kk: (v.to("meta") if torch.is_tensor(v) else v) for kk, v in k.items()}
    with pytest.raises(ValueError, match="no kernel"):
        teig.eig_chunk(*am, **km)


@pytest.fixture(scope="module")
def refresh_inputs():
    p = _build_setup()
    jp = p["prob"]
    B, K = p["B"], jp.eig_YT.shape[1]
    rng = np.random.default_rng(7)
    combo_row = np.array([3, 0, 1, 2, 3, 2, 1, 0], dtype=np.int32)
    r = rng.uniform(0.5, 2.0, B)
    s = rng.uniform(-3.0, 3.0, B)
    al = np.where(np.abs(s) > 2.5, 0.8, 0.0)  # some rows equilibrated
    scal = np.zeros((B, 8))
    scal[:, 0], scal[:, 1], scal[:, 2] = r, s, al
    lam = np.asarray(jp.eig_lam)[combo_row]
    dg = 1.0 / (1.0 + r[:, None] * lam)
    need = np.array([True, True, False, True, True, False, True, True])
    return dict(combo_row=combo_row, scal=scal, dg=dg, need=need,
                X0=np.zeros((B, K, K)), jp=jp,
                tp=tadmm.problem_from_numpy(jp, dtype=torch.float64,
                                           device="cpu"))


def _refresh_both(ri, X_prev, fn_kw, safe):
    jp, tp = ri["jp"], ri["tp"]
    jargs = (jnp.asarray(ri["combo_row"]), jnp.asarray(ri["scal"]),
             jnp.asarray(ri["dg"]), jnp.asarray(X_prev), jnp.asarray(ri["need"]),
             jp.eig_YT, jp.eig_w33col)
    targs = (torch.as_tensor(ri["combo_row"]).long(), _t(ri["scal"]),
             _t(ri["dg"]), _t(X_prev), torch.as_tensor(ri["need"]),
             tp.eig_YT, tp.eig_w33col)
    if safe:
        jx = jeig.tinv_safe_refresh(*jargs, wuucol=jp.eig_wuucol, **fn_kw)
        tx = teig.tinv_safe_refresh(*targs, wuucol=tp.eig_wuucol, **fn_kw)
        return np.asarray(jx), tx.numpy(), None, None
    jx, jr = jeig.tinv_refresh(*jargs, wuucol=jp.eig_wuucol, **fn_kw)
    tx, tr = teig.tinv_refresh(*targs, wuucol=tp.eig_wuucol, **fn_kw)
    return np.asarray(jx), tx.numpy(), np.asarray(jr), tr.numpy()


def test_tinv_refresh_matches_jax(refresh_inputs):
    ri = refresh_inputs
    jx, tx, jr, tr = _refresh_both(ri, ri["X0"], dict(n_iter=30, cold=True),
                                   safe=False)
    np.testing.assert_allclose(tx, jx, rtol=TOL, atol=TOL * np.abs(jx).max())
    np.testing.assert_allclose(tr, jr, rtol=1e-6, atol=1e-14)
    assert (tr[ri["need"]] < 1e-8).all()
    assert (tx[~ri["need"]] == 0).all()
    # warm refresh from the cold result after a 2% slope drift
    ri2 = dict(ri, scal=ri["scal"] * np.array([1, 1.02, 1, 0, 0, 0, 0, 0]))
    jx2, tx2, _, _ = _refresh_both(ri2, jx, dict(n_iter=3, cold=False),
                                   safe=False)
    np.testing.assert_allclose(tx2, jx2, rtol=TOL, atol=TOL * np.abs(jx2).max())


@pytest.mark.parametrize("cold_cap", [0, 4])
def test_tinv_safe_refresh_matches_jax(refresh_inputs, cold_cap):
    """From zeros the warm pass is bad on every needy row, so the cold
    restart runs (compacted to ``cold_cap`` rows when it fits)."""
    ri = refresh_inputs
    kw = dict(warm_iters=3, cold_iters=30, cold_cap=cold_cap)
    jx, tx, _, _ = _refresh_both(ri, ri["X0"], kw, safe=True)
    np.testing.assert_allclose(tx, jx, rtol=TOL, atol=TOL * np.abs(jx).max())



@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("bt", [1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 64])
def test_eig_group_divides_bt_within_the_cap(dtype, bt):
    """The slots per block of the CUDA kernel divide the tile (so a group
    is combo-pure), are a power of two and stay within the type's cap
    (shared memory holds 8 fp32 slots' vectors; 2 fp64 slots, whose
    registers spill at 4), at every live count."""
    cap = teig.GROUP_CAP[dtype]
    assert cap == (8 if dtype == torch.float32 else 2)
    for n_live in (0, 1, 5, 31, 100, 263, 264, 528, 1000, 1056, 1152, 10**6):
        S = teig.eig_group(n_live, bt, dtype)
        assert bt % S == 0 and S & (S - 1) == 0 and 1 <= S <= cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_group_follows_the_census(dtype):
    """One slot per block while one block per live slot (and a partial
    group per combo) fits one wave of the card's SMs: the chunks of 1-128
    live slots, 70% of the parent kernel's chunk span; the cap at a full
    1152-slot chunk; never fewer slots per block for more live slots; and
    the groups of a chunk fit one wave whenever the cap allows."""
    per_card = teig.GROUPS_PER_CARD
    for n_live in (1, 8, 11, 32, 53, 128):
        assert teig.eig_group(n_live, 32, dtype) == 1
    assert teig.eig_group(129, 32, dtype) == 2
    assert teig.eig_group(1152, 32, dtype) == teig.GROUP_CAP[dtype]
    sizes = [teig.eig_group(n, 32, dtype) for n in range(0, 2000, 7)]
    assert sizes == sorted(sizes)
    for n_live in range(1, 1153):
        S = teig.eig_group(n_live, 32, dtype)
        assert S == teig.GROUP_CAP[dtype] or -(-n_live // S) + 4 <= per_card


# clusters of each size an NVIDIA H100 80GB HBM3 holds at once at the
# chunk shapes of the flagship and of radialC (K=128, gw=64), as the
# kernel's wrapper reads them from the card
H100_WAVES = {2: 66, 4: 30, 8: 15, 16: 7}
# the wave tables the layout policy is held to: that card's and a smaller
# card's, on which clusters end below 129 live slots
_WAVES = [H100_WAVES, {2: 24, 4: 12, 8: 6, 16: 0}]


@pytest.mark.parametrize("waves", _WAVES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eig_layout_takes_clusters_for_narrow_calls(dtype, waves):
    """fp32: the largest cluster size whose clusters (one a live slot) fit
    one wave, else the smallest whose clusters fit ``CLUSTER_WAVES`` waves
    (a cluster at 1, 11 and 16 live slots); above that range, and at no
    live slot, ``eig_group``'s slots per block, unchanged. fp64 never takes
    a cluster."""
    assert set(waves) == set(teig.CLUSTERS[torch.float32])
    assert teig.CLUSTERS[torch.float64] == ()
    sizes = sorted(c for c, n in waves.items() if n > 0)
    top = teig.CLUSTER_WAVES * waves[sizes[0]]
    for n_live in (1, 11, 16):
        C, S = teig.eig_layout(n_live, 32, dtype, waves)
        assert S == 1 and (C > 1) == (dtype == torch.float32)
    for n_live in range(0, 1153):
        C, S = teig.eig_layout(n_live, 32, dtype, waves)
        if dtype == torch.float64 or n_live == 0 or n_live > top:
            assert (C, S) == (1, teig.eig_group(n_live, 32, dtype))
            continue
        assert S == 1
        one = [c for c in sizes if n_live <= waves[c]]
        assert C == (max(one) if one else sizes[0])
    for n_live in (top + 1, 1024):
        assert teig.eig_layout(n_live, 32, torch.float32, waves) == (
            1, teig.eig_group(n_live, 32, torch.float32))
    if waves is not H100_WAVES:
        for n_live in (129, 264):
            assert teig.eig_layout(n_live, 32, torch.float32, waves) == (
                1, teig.eig_group(n_live, 32, torch.float32))


def test_eig_layout_follows_the_sweep():
    """At the sweep's live counts (PERF.md section 6) the policy, on the
    H100's wave table, picks the layout that timed fastest on the card: clusters of 16 up to
    7 live slots, 8 up to 15, 4 up to 30, 2 up to 330 (five waves), the
    slot groups beyond."""
    f32 = torch.float32
    want = {1: (16, 1), 7: (16, 1), 8: (8, 1), 11: (8, 1), 15: (8, 1),
            16: (4, 1), 30: (4, 1), 33: (2, 1), 66: (2, 1), 100: (2, 1),
            128: (2, 1), 264: (2, 1), 330: (2, 1), 331: (1, 4),
            1024: (1, 8)}
    for n_live, lay in want.items():
        assert teig.eig_layout(n_live, 32, f32, H100_WAVES) == lay, n_live


def test_eig_chunk_twin_ignores_the_group_keywords(chunks):
    """On the CPU the wrapper runs the twin whatever ``n_live`` and
    ``layout`` say."""
    a, k, ref, _ = chunks["warm"]
    for extra in (dict(n_live=3), dict(layout=(1, 4)),
                  dict(n_live=3, layout=(1, 1)),
                  dict(n_live=3, layout=(8, 1)), dict(layout=(16, 1))):
        out = teig.eig_chunk(*a, **k, **extra)
        for o, r in zip(out, ref):
            assert torch.equal(o, r)
