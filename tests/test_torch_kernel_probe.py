"""The chunk-parts probe (``mpc_arpo_project_tpu_torch/tools/kernel_probe.py``):
each plain twin against a numpy transcription of the matching Pallas body
of the JAX package's ``tools/kernel_probe.py`` (its kernels are closures
inside ``main()`` pinned to TPU memory, so no test can call them), in fp64
and fp32, in each of the original's three precisions (JAX on the CPU
computes every precision in fp32, so the 'high' and 'default' passes are
written out in numpy: bf16 operands and limbs by the bits); the bf16 twin
against its exact two-limb arithmetic; and the probe's refusals. Small sizes: nz=32, m=64, B=8, bt=4, 3 iterations, on
the unit-gain inputs (the original's scales underflow fp32 within the
probe's 25 iterations). The kernels themselves are held against the twins
on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu_torch.tools import kernel_probe as kp
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

B, BT, NZ, M, N_IT = 8, 4, 32, 64, 3


# numpy transcriptions of the Pallas bodies (tools/kernel_probe.py:42-108),
# tile by tile over the grid (B // bt,); ``dot`` is the body's jnp.dot at its
# precision (``np_dot``)

def _tiles(x, bt, body):
    return np.concatenate([body(i, x[i * bt:(i + 1) * bt])
                           for i in range(x.shape[0] // bt)], 0)


def np_matvec(x, a0, n_it, bt, dot=np.matmul):
    def body(_, xt):
        for _ in range(n_it):
            y = dot(xt, a0.T)
            xt = xt.dtype.type(1e-3) * dot(y, a0)
        return xt
    return _tiles(x, bt, body)


def np_minv(x, minv, n_it, bt, dot=np.matmul):
    def body(i, xt):
        for _ in range(n_it):
            xt = np.concatenate([dot(xt[p][None, :], minv[i * bt + p])
                                 for p in range(bt)], 0)
        return xt
    return _tiles(x, bt, body)


def np_minv_lhs(x, minv, n_it, bt, dot=np.matmul):
    def body(i, xt):
        for _ in range(n_it):
            xt = np.concatenate([dot(minv[i * bt + p], xt[p][:, None]).T
                                 for p in range(bt)], 0)
        return xt
    return _tiles(x, bt, body)


def np_minv_bd(x, mflat, n_it, bt, dot=np.matmul):
    nz = x.shape[1]
    row = np.arange(bt)[:, None] * np.ones((1, bt * nz), dtype=np.int32)
    col = np.arange(bt * nz)[None, :] * np.ones((bt, 1), dtype=np.int32)
    maskf = (1.0 - np.minimum(np.abs(row - col // nz), 1)).astype(x.dtype)

    def body(i, xt):
        for _ in range(n_it):
            xe = np.concatenate([xt] * bt, axis=1) * maskf
            xt = dot(xe, mflat[i])
        return xt
    return _tiles(x, bt, body)


def np_stack(x, s7, n_it, bt, dot=np.matmul):
    nz = x.shape[1]

    def body(_, xt):
        for _ in range(n_it):
            xs = dot(xt, s7)
            acc = None
            for t in range(7):
                term = xt.dtype.type(0.1 + t) * xs[:, t * nz:(t + 1) * nz]
                acc = term if acc is None else acc + term
            xt = xt.dtype.type(1e-3) * acc
        return xt
    return _tiles(x, bt, body)


def bf16_np(a):
    """fp32 -> bf16 (round to nearest even) -> fp32, by the bits."""
    u = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    u = (u + (((u >> 16) & 1) + np.uint32(0x7FFF))) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def bf16_round_np(a):
    """``a`` rounded to bf16 from its fp32 value, in ``a``'s dtype."""
    return bf16_np(a.astype(np.float32)).astype(a.dtype)


def np_dot(precision):
    """jnp.dot at ``precision`` on a TPU: "highest" the product itself;
    "default" one bf16 pass (operands rounded to bf16, products exact,
    sums in the operands' dtype); "high" bf16_3x, hi hi + hi lo + lo hi of
    the operands' bf16 limbs (lo = bf16 of the remainder)."""
    def dot(a, b):
        if precision == "highest":
            return a @ b
        ah, bh = bf16_round_np(a), bf16_round_np(b)
        if precision == "default":
            return ah @ bh
        al, bl = bf16_round_np(a - ah), bf16_round_np(b - bh)
        return ah @ bh + ah @ bl + al @ bh
    return dot


def np_minv_bf16(x, minv, n_it, bt):
    """The two-limb body with every sum in fp64: its limb products are
    exact, so this is the arithmetic's exact value."""
    def body(i, xt):
        for _ in range(n_it):
            outs = []
            for p in range(bt):
                M = minv[i * bt + p]
                hi = bf16_np(M)
                lo = bf16_np(M - hi)
                xb = bf16_np(xt[p][None, :].astype(np.float32))
                outs.append(xb.astype(np.float64) @ hi.astype(np.float64)
                            + xb.astype(np.float64) @ lo.astype(np.float64))
            xt = np.concatenate(outs, 0)
        return xt
    return _tiles(x.astype(np.float64), bt, body)


TRANSCRIPTIONS = {"matvec_pair": (np_matvec, "a0"),
                  "minv_rowvec": (np_minv, "minv"),
                  "minv_lhs": (np_minv_lhs, "minv"),
                  "minv_blockdiag": (np_minv_bd, "mflat"),
                  "stack7": (np_stack, "s7")}


def _inputs(dtype):
    return kp.make_inputs(B, BT, NZ, M, device="cpu", dtype=dtype,
                          unit_gain=True)


def _row_rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return (np.abs(a - b).max(1) / np.abs(b).max(1)).max()


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
@pytest.mark.parametrize("name", sorted(TRANSCRIPTIONS))
def test_twin_matches_pallas_body(name, dtype, tol):
    """fp64: the same arithmetic in another summation order, 1e-12 per row;
    fp32: 2e-6 per row over 3 iterations (sums of 32-64 products each)."""
    inp = _inputs(dtype)
    fn, operand = TRANSCRIPTIONS[name]
    want = fn(inp["x"].numpy(), inp[operand].numpy(), N_IT, BT)
    got = kp.call(name, inp, N_IT, twin=True)
    assert got.dtype == dtype and got.shape == (B, NZ)
    assert _row_rel(got, want) <= tol
    # on the CPU the entry is the twin, and launches nothing
    n0 = getattr(kp, name).launches
    assert torch.equal(kp.call(name, inp, N_IT), got)
    assert getattr(kp, name).launches == n0


def test_bf16_twin_is_the_exact_two_limb_arithmetic():
    """The limbs are bf16 (round to nearest even) of M and of M - hi, as
    the numpy bit transcription makes them, and together carry M to 2^-16
    relative; one iteration of the twin is the exact sum of the limb
    products up to fp32 summation (32 products), three iterations stay
    within the fp32 round-off of x that each bf16 rounding of x sees."""
    inp = _inputs(torch.float32)
    x, minv = inp["x"], inp["minv"]
    hi, lo = kp.bf16_limbs(minv, torch.float32)
    Mn = minv.numpy()
    np.testing.assert_array_equal(hi.numpy(), bf16_np(Mn))
    np.testing.assert_array_equal(lo.numpy(), bf16_np(Mn - bf16_np(Mn)))
    assert (np.abs(hi.numpy() + lo.numpy() - Mn)
            <= 2.0 ** -16 * np.abs(Mn)).all()
    one = kp.minv_bf16_ref(x, minv, 1)
    assert _row_rel(one, np_minv_bf16(x.numpy(), Mn, 1, BT)) <= 1e-6
    three = kp.minv_bf16_ref(x, minv, N_IT)
    assert _row_rel(three, np_minv_bf16(x.numpy(), Mn, N_IT, BT)) <= 1e-2
    # the split moves M by at most 2^-16 relative, so it stays near the
    # exact product of the rowvec variant, within bf16's rounding of x
    exact = kp.minv_rowvec_ref(x.double(), minv.double(), 1)
    assert _row_rel(one, exact) <= 2.0 ** -7
    # in fp64 the same twin sums the exact products in fp64
    x64 = kp.minv_bf16_ref(x.double(), minv, 1)
    assert _row_rel(x64, np_minv_bf16(x.numpy(), Mn, 1, BT)) <= 1e-13


def test_original_scales_underflow_and_unit_gain_does_not():
    """Why the comparisons use unit-gain inputs: at the original's scales
    the matvec and stack7 iterates reach fp32's denormals within 25
    iterations; at unit gain every variant stays normal and finite."""
    orig = kp.make_inputs(B, BT, NZ, M, device="cpu")
    assert float(kp.call("matvec_pair", orig, 25, twin=True).abs().max()) \
        < 1e-30
    unit = _inputs(torch.float32)
    for name in kp.variants(NZ, M):
        y = kp.call(name, unit, 25, twin=True)
        assert torch.isfinite(y).all(), name
        assert float(y.abs().amax(1).min()) > 1e-6, name


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12),
                                        (torch.float32, 2e-6)])
@pytest.mark.parametrize("precision", ["high", "default"])
@pytest.mark.parametrize("name", sorted(kp.variants(NZ, M, BT)))
def test_twin_precision_matches_pass_definition(name, precision, dtype, tol):
    """The 'high' and 'default' twins against the numpy transcription with
    the pass written out (``np_dot``; the bf16 variant's own body in every
    precision). fp64: 1e-12 per row over 3 iterations (the same exact limb
    products in another summation order). fp32: 'high' 2e-6 per row at one
    iteration, as 'highest', and 3e-5 over 3: the limbs carry x to 2^-17 of
    each element, and where a 1-ulp difference of two summation orders
    moves an element's hi limb across a bf16 rounding boundary that
    remainder changes by up to 2^-16 of the element (measured here: 1.1e-7
    at one iteration, 7.9e-6 over 3 for minv_lhs); 'default' re-rounds x
    (and matvec_pair's y) to bf16, where such a difference can flip a
    rounding, so it is held to 2e-6 at one iteration (matvec_pair to
    ``MATVEC_DEFAULT_ONE_IT_TOL``, its y being rounded inside the
    iteration) and bit for bit over 3 on ``exact_inputs``."""
    inp = _inputs(dtype)
    runs = [(inp, N_IT, tol)]
    if name == "minv_bf16":
        want_fn = lambda i, k: np_minv_bf16(i["x"].numpy(), i["minv"].numpy(),
                                            k, BT)
        runs = [(inp, 1, 1e-6 if dtype == torch.float32 else 1e-13)]
    else:
        fn, operand = TRANSCRIPTIONS[name]
        want_fn = lambda i, k: fn(i["x"].numpy(), i[operand].numpy(), k, BT,
                                  np_dot(precision))
        if precision == "default" and dtype == torch.float32:
            one = kp.MATVEC_DEFAULT_ONE_IT_TOL if name == "matvec_pair" \
                else tol
            runs = [(inp, 1, one), (kp.exact_inputs(inp), N_IT, 0.0)]
        elif dtype == torch.float32:
            runs = [(inp, 1, tol), (inp, N_IT, 3e-5)]
    for i, k, t in runs:
        got = kp.call(name, i, k, twin=True, precision=precision)
        assert got.dtype == dtype and got.shape == (B, NZ)
        assert _row_rel(got, want_fn(i, k)) <= t, (k, t)
    # on the CPU the entry is the twin, and launches nothing
    n0 = getattr(kp, name).launches
    assert torch.equal(kp.call(name, inp, N_IT, precision=precision),
                       kp.call(name, inp, N_IT, twin=True,
                               precision=precision))
    assert getattr(kp, name).launches == n0


@pytest.mark.parametrize("name", sorted(TRANSCRIPTIONS))
def test_default_on_exact_inputs_is_exact(name):
    """``exact_inputs`` make one bf16 pass exact: over 25 iterations the
    fp32 'default' twin equals the numpy transcription (other summation
    orders, fp32) bit for bit, stays finite and normal, and differs from
    'highest' (the rounding of x to bf16 is seen)."""
    inp = kp.exact_inputs(_inputs(torch.float32))
    fn, operand = TRANSCRIPTIONS[name]
    got = kp.call(name, inp, 25, twin=True, precision="default")
    want = fn(inp["x"].numpy(), inp[operand].numpy(), 25, BT,
              np_dot("default"))
    np.testing.assert_array_equal(got.numpy(), want)
    assert float(got.abs().amax(1).min()) > 1e-6
    assert not torch.equal(got, kp.call(name, inp, 25, twin=True))


@pytest.mark.parametrize("precision", kp.PRECISIONS)
def test_run_and_main_take_every_precision(monkeypatch, precision):
    """``run`` and ``main`` accept all three precisions and carry them to
    every variant; here on a stand-in device (the CPU, where the entries are
    the twins) and a stand-in timer that runs the variant once."""
    seen = []

    def fake_time(name, inputs, n_it, loop=10, reps=3, twin=False,
                  precision="highest"):
        y = kp.call(name, inputs, 1, twin, precision)
        assert torch.isfinite(y).all()
        seen.append((name, precision))
        return 1.0

    monkeypatch.setattr(kp, "resolve_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(kp, "card_line", lambda: "stand-in card, 700.00 W")
    monkeypatch.setattr(kp, "time_ms", fake_time)
    lines = []
    assert kp.run(8, 4, 1, precision=precision, out=lines.append) == 0
    assert lines[:2] == ["stand-in card, 700.00 W", f"precision {precision}"]
    assert len(lines) == 8 and not any("FAILED" in ln for ln in lines)
    assert kp.main(["--precision", precision, "--batch", "8", "--bt", "4",
                    "--iters", "1"]) == 0
    assert seen == [(n, precision) for n in kp.variants()] * 2


def test_unknown_precision_raises(monkeypatch):
    monkeypatch.setattr(kp, "resolve_device", lambda d: torch.device("cpu"))
    with pytest.raises(ValueError, match="precision"):
        kp.run(8, 4, 1, precision="fastest")
    with pytest.raises(SystemExit):
        kp.main(["--precision", "fastest"])
    inp = _inputs(torch.float32)
    for name in kp.variants(NZ, M, BT):
        with pytest.raises(ValueError, match="precision"):
            kp.call(name, inp, 1, precision="fastest")
        with pytest.raises(ValueError, match="precision"):
            kp.call(name, inp, 1, twin=True, precision="fastest")


def test_entries_refuse_other_devices():
    """No kernel and no twin for a device that is neither CPU nor CUDA."""
    x = torch.empty((B, NZ), device="meta")
    with pytest.raises(ValueError, match="device"):
        kp.minv_rowvec(x, torch.empty((B, NZ, NZ), device="meta"), 1)


def test_variants_keep_the_original_labels_and_macs():
    v = kp.variants(256, 512, 32)
    assert list(v) == ["matvec_pair", "minv_rowvec", "minv_lhs", "minv_bf16",
                       "minv_blockdiag", "stack7"]
    assert [e.macs for e in v.values()] == [2 * 512 * 256] + [256 * 256] * 4 \
        + [7 * 256 * 256]
    # executed: the bf16 kernel's two limb products, the block-diagonal
    # kernel's bt-fold masked MACs
    assert [e.executed for e in v.values()] == [
        2 * 512 * 256, 256 * 256, 256 * 256, 2 * 256 * 256, 32 * 256 * 256,
        7 * 256 * 256]
    assert v["minv_blockdiag"].label.strip() == "minv block-diag"


def _signed_perm_apply(x, m, n_it):
    """n_it applications of the signed permutation underlying ``m`` (its
    entries' signs), in fp64."""
    s = torch.sign(m).double()
    x = x.double()
    for _ in range(n_it):
        x = torch.bmm(x[:, None, :], s)[:, 0]
    return x


@pytest.mark.parametrize("n_it", [1, 25])
def test_exact_bf16_minv_makes_the_two_limb_arithmetic_exact(n_it):
    """On ``exact_bf16_minv``'s matrices the bf16 twin gives, bit for bit,
    bf16(x) moved by the signed permutation n_it times and scaled once by
    1 + 2^-10, in fp32 as in fp64; so the card's check can hold the kernel
    to its twin over the probe's 25 iterations. A kernel that drops the lo
    limb, or that does not round x to bf16, misses by far more than the
    check's 1e-5."""
    inp = _inputs(torch.float32)
    x = inp["x"]
    m = kp.exact_bf16_minv(inp["minv"])
    assert m.shape == inp["minv"].shape and m.dtype == torch.float32
    assert torch.equal((m != 0).sum(1), torch.ones((B, NZ), dtype=torch.long))
    assert torch.equal((m != 0).sum(2), torch.ones((B, NZ), dtype=torch.long))
    hi, lo = kp.bf16_limbs(m, torch.float32)
    assert torch.equal(hi, torch.sign(m))
    assert torch.equal(lo, torch.sign(m) * 2.0 ** -10)
    xb = torch.from_numpy(bf16_np(x.numpy()))
    want = _signed_perm_apply(xb, m, n_it) * (1 + 2.0 ** -10)
    got = kp.minv_bf16_ref(x, m, n_it)
    assert torch.equal(got.double(), want)
    assert torch.equal(kp.minv_bf16_ref(x.double(), m, n_it), want)
    no_lo = _signed_perm_apply(xb, m, n_it)
    assert _row_rel(no_lo, want) > 1e-4
    if n_it > 1:
        unrounded = kp.minv_rowvec_ref(x, m, n_it)
        assert _row_rel(unrounded, want) > 1e-3
