"""Time the parts of the fused ADMM chunk kernels on the card.

Counterpart of the JAX package's ``tools/kernel_probe.py``: six probe
kernels over the chunk's shapes, each mapping x (B, nz) to (B, nz) through
``n_it`` dependent iterations in one launch (``csrc/kernel_probe.cu``):

* ``matvec_pair`` — the shared A/A' pair, x <- 1e-3 (x a0') a0;
* ``minv_rowvec`` — the per-problem inverse apply, x_p <- x_p Minv_p;
* ``minv_lhs`` — the same data in the other orientation, (Minv_p x_p')';
* ``minv_bf16`` — the two-limb bf16 apply, xb hi + xb lo;
* ``minv_blockdiag`` — the tile's x expanded under the block-diagonal mask
  times the tile's Minv flattened to (bt nz, nz) (bt-fold redundant MACs);
* ``stack7`` — the structured 7-term product and its combine.

Each entry has a plain torch twin ``<entry>_ref`` of the same math. A CPU
tensor goes to the twin, a CUDA tensor to the kernel (built with nvcc at
first use); anything else raises, as does a wrong dtype, shape or stride, a
failed build or a refused launch. Each entry counts its kernel launches in
``<entry>.launches``. Every entry and twin takes the original's
``precision`` of its products, with the TPU's definitions:

* ``"highest"`` (the default): fp32 (the kernels on the CUDA cores, no
  TF32);
* ``"default"``: one bf16 pass: both operands rounded to bf16 (nearest
  even, from their fp32 value), the products exact, the sums fp32;
* ``"high"``: bf16_3x: a = a_hi + a_lo and b = b_hi + b_lo in bf16 limbs
  (the lo limb is bf16 of the remainder), a_hi b_hi + a_hi b_lo + a_lo b_hi
  summed in fp32.

On the card ``matvec_pair``, ``stack7`` and ``minv_blockdiag`` run those
two on the tensor cores (``mma.sync`` bf16 -> fp32), ``minv_rowvec`` and
``minv_lhs`` on the CUDA cores with the operands rounded; ``minv_bf16``
names its limbs itself and is the same in every precision.

    python -m mpc_arpo_project_tpu_torch.tools.kernel_probe \\
        [--batch 1024] [--bt 32] [--iters 25] [--loop 10] [--reps 3] \\
        [--precision highest|high|default]

prints the card's name and power limit, the precision, then for each
variant the original's line: ms per chunk (``loop`` back-to-back launches
of 0.999 f(x), best of ``reps``, CUDA events), µs per iteration and useful
TF/s (the original's useful MACs). A variant that fails prints ``FAILED``
and the run exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from typing import NamedTuple

import torch

from mpc_arpo_project_tpu_torch.ops import _build
from mpc_arpo_project_tpu_torch.ops.admm import resolve_device

NZ, M = 256, 512  # the flagship chunk's padded widths


# ---------------------------------------------------------------------------
# plain twins
# ---------------------------------------------------------------------------

PRECISIONS = ("highest", "high", "default")


def _precision(name, precision):
    if precision not in PRECISIONS:
        raise ValueError(f"{name}: precision={precision!r} is not one of "
                         f"{PRECISIONS}")
    return PRECISIONS.index(precision)


def bf16_round(a):
    """``a`` rounded to bf16 (nearest even, from its fp32 value), as
    ``a.dtype``."""
    return a.float().to(torch.bfloat16).to(a.dtype)


def _limbs(a):
    hi = bf16_round(a)
    return hi, bf16_round(a - hi)


def product(a, b, precision: str = "highest", mm=torch.matmul):
    """``mm(a, b)`` in the original's precision: at "highest" the product
    itself; at "default" the product of the operands' bf16 roundings; at
    "high" a_hi b_hi + a_hi b_lo + a_lo b_hi. The limb products are exact
    in fp32, and are summed in ``a.dtype``."""
    if precision == "highest":
        return mm(a, b)
    ah, al = _limbs(a)
    bh, bl = _limbs(b)
    if precision == "default":
        return mm(ah, bh)
    if precision == "high":
        return mm(ah, bh) + mm(ah, bl) + mm(al, bh)
    raise ValueError(f"precision={precision!r} is not one of {PRECISIONS}")


def matvec_pair_ref(x, a0, n_it: int, precision: str = "highest"):
    for _ in range(n_it):
        x = 1e-3 * product(product(x, a0.T, precision), a0, precision)
    return x


def minv_rowvec_ref(x, minv, n_it: int, precision: str = "highest"):
    for _ in range(n_it):
        x = product(x[:, None, :], minv, precision, torch.bmm)[:, 0]
    return x


def minv_lhs_ref(x, minv, n_it: int, precision: str = "highest"):
    for _ in range(n_it):
        x = product(minv, x[:, :, None], precision, torch.bmm)[:, :, 0]
    return x


def bf16_limbs(minv, dtype):
    """hi = bf16(M), lo = bf16(M - hi), both as ``dtype`` values."""
    hi = minv.to(torch.bfloat16)
    lo = (minv - hi.to(minv.dtype)).to(torch.bfloat16)
    return hi.to(dtype), lo.to(dtype)


def minv_bf16_ref(x, minv, n_it: int, precision: str = "highest"):
    """The two-limb split made with ``.to(torch.bfloat16)``; the limb
    products, exact in fp32, summed in ``x.dtype``. It names bf16 itself,
    so ``precision`` changes nothing (as in the original's body)."""
    _precision("minv_bf16", precision)
    hi, lo = bf16_limbs(minv, x.dtype)
    for _ in range(n_it):
        xb = x.to(torch.bfloat16).to(x.dtype)[:, None, :]
        x = (torch.bmm(xb, hi) + torch.bmm(xb, lo))[:, 0]
    return x


def minv_blockdiag_ref(x, mflat, n_it: int, bt: int,
                       precision: str = "highest"):
    B, nz = x.shape
    # (bt, bt nz) float mask: 1 where column k lies in row p's block
    blk = torch.arange(bt * nz, device=x.device) // nz
    maskf = (blk[None, :] == torch.arange(bt, device=x.device)[:, None]).to(
        x.dtype)
    for _ in range(n_it):
        xe = x.reshape(B // bt, bt, nz).repeat(1, 1, bt) * maskf
        x = product(xe, mflat, precision, torch.bmm).reshape(B, nz)
    return x


def stack7_ref(x, s7, n_it: int, precision: str = "highest"):
    nz = x.shape[1]
    for _ in range(n_it):
        xs = product(x, s7, precision)
        acc = (0.1 + 0) * xs[:, :nz]
        for t in range(1, 7):
            acc = acc + (0.1 + t) * xs[:, t * nz:(t + 1) * nz]
        x = 1e-3 * acc
    return x


# ---------------------------------------------------------------------------
# dispatching entries
# ---------------------------------------------------------------------------

def matvec_pair(x, a0, n_it: int, precision: str = "highest"):
    """n_it times x <- 1e-3 (x a0') a0; x (B, nz), a0 (m, nz)."""
    if _on_cpu("matvec_pair", x, precision):
        return matvec_pair_ref(x, a0, n_it, precision)
    return _run(matvec_pair, 0, x, a0, (a0.shape[0], x.shape[1]), n_it,
                precision)


def minv_rowvec(x, minv, n_it: int, precision: str = "highest"):
    """n_it times x_p <- x_p Minv_p; minv (B, nz, nz)."""
    if _on_cpu("minv_rowvec", x, precision):
        return minv_rowvec_ref(x, minv, n_it, precision)
    return _run(minv_rowvec, 1, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it, precision)


def minv_lhs(x, minv, n_it: int, precision: str = "highest"):
    """n_it times x_p <- (Minv_p x_p')'; minv (B, nz, nz)."""
    if _on_cpu("minv_lhs", x, precision):
        return minv_lhs_ref(x, minv, n_it, precision)
    return _run(minv_lhs, 2, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it, precision)


def minv_bf16(x, minv, n_it: int, precision: str = "highest"):
    """n_it times x_p <- xb hi + xb lo (bf16 limbs of Minv_p and x_p), in
    every precision."""
    if _on_cpu("minv_bf16", x, precision):
        return minv_bf16_ref(x, minv, n_it, precision)
    return _run(minv_bf16, 3, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it, precision)


def minv_blockdiag(x, mflat, n_it: int, bt: int, precision: str = "highest"):
    """n_it times the block-diagonal product of each tile of ``bt``
    problems; mflat (B/bt, bt nz, nz) is Minv (B, nz, nz) reshaped."""
    if _on_cpu("minv_blockdiag", x, precision):
        return minv_blockdiag_ref(x, mflat, n_it, bt, precision)
    B, nz = x.shape
    if bt < 1 or B % bt:
        raise ValueError(f"minv_blockdiag: B={B} is not a multiple of "
                         f"bt={bt}")
    if bt > 32:
        raise ValueError(f"minv_blockdiag: the kernel takes bt <= 32, not "
                         f"bt={bt}")
    return _run(minv_blockdiag, 4, x, mflat, (B // bt, bt * nz, nz), n_it,
                precision, bt=bt)


def stack7(x, s7, n_it: int, precision: str = "highest"):
    """n_it times x <- 1e-3 sum_t (0.1 + t) (x s7)[:, t nz:(t+1) nz]; s7
    (nz, 7 nz)."""
    if _on_cpu("stack7", x, precision):
        return stack7_ref(x, s7, n_it, precision)
    return _run(stack7, 5, x, s7, (x.shape[1], 7 * x.shape[1]), n_it,
                precision)


for _entry in (matvec_pair, minv_rowvec, minv_lhs, minv_bf16, minv_blockdiag,
               stack7):
    _entry.launches = 0


def _on_cpu(name, x, precision):
    _precision(name, precision)
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return False


def _lib():
    lib = _build.load_library("kernel_probe", ("kernel_probe.cu",))
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_run.argtypes = [I, I, P, P, P, I, I, I, I, I, P]
        lib.probe_run.restype = I
        lib.probe_capacity.argtypes = [I, I, I, I, I, P]
        lib.probe_capacity.restype = I
        lib._typed = True
    return lib


MAX_NZ = 256  # the kernels hold nz <= 256 per problem on chip


def _run(entry, variant, x, mat, mat_shape, n_it, precision, bt=1):
    name = entry.__name__
    for tname, t, shape in (("x", x, tuple(x.shape)), ("mat", mat, mat_shape)):
        if t.device != x.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != tuple(shape) or x.dim() != 2:
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, not {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")
    if n_it < 0:
        raise ValueError(f"{name}: n_it={n_it} < 0")
    B, nz = x.shape
    if nz > MAX_NZ:
        raise ValueError(f"{name}: the kernel takes nz <= {MAX_NZ}, not "
                         f"nz={nz}")
    m = mat_shape[0] if variant == 0 else nz
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().probe_run(variant, _precision(name, precision),
                               x.data_ptr(), mat.data_ptr(), out.data_ptr(),
                               B, bt, nz, m, int(n_it), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")
    entry.launches += 1
    return out


def capacity(name: str, precision: str = "highest", bt: int = 32,
             nz: int = NZ, m: int = M) -> int:
    """How many of variant ``name``'s groups the card holds at once (one
    wave): blocks of 8 problems (``matvec_pair``, ``stack7``), clusters of 2
    blocks per problem (the three Minv variants) or of 8 blocks per tile of
    ``bt`` problems (``minv_blockdiag``)."""
    out = ctypes.c_int(0)
    err = _lib().probe_capacity(_VARIANT_IDS[name], _precision(name, precision),
                                bt, nz, m, ctypes.byref(out))
    if err != 0:
        raise RuntimeError(f"{name}: occupancy query failed (cudaError {err})")
    return out.value


_VARIANT_IDS = {"matvec_pair": 0, "minv_rowvec": 1, "minv_lhs": 2,
                "minv_bf16": 3, "minv_blockdiag": 4, "stack7": 5}


# ---------------------------------------------------------------------------
# the probe
# ---------------------------------------------------------------------------

class Variant(NamedTuple):
    label: str      # the original's label
    entry: object   # dispatching entry
    twin: object    # plain twin
    operand: str    # key of its matrix in ``make_inputs``
    macs: int       # the original's useful MACs per problem-iteration
    executed: int   # MACs the kernel executes per problem-iteration


def variants(nz: int = NZ, m: int = M, bt: int = 32):
    """The six probe variants, in the original's order. The bf16 kernel
    executes both limb products, the block-diagonal one its tile's bt-fold
    masked MACs."""
    return {
        "matvec_pair": Variant("matvec pair (2 m*nz)", matvec_pair,
                               matvec_pair_ref, "a0", 2 * m * nz,
                               2 * m * nz),
        "minv_rowvec": Variant("minv per-problem    ", minv_rowvec,
                               minv_rowvec_ref, "minv", nz * nz, nz * nz),
        "minv_lhs": Variant("minv matrix-lhs     ", minv_lhs, minv_lhs_ref,
                            "minv", nz * nz, nz * nz),
        "minv_bf16": Variant("minv bf16 two-limb  ", minv_bf16,
                             minv_bf16_ref, "minv", nz * nz, 2 * nz * nz),
        "minv_blockdiag": Variant("minv block-diag     ", minv_blockdiag,
                                  minv_blockdiag_ref, "mflat", nz * nz,
                                  bt * nz * nz),
        "stack7": Variant("stack7 + combine    ", stack7, stack7_ref, "s7",
                          7 * nz * nz, 7 * nz * nz),
    }


def variant(name: str, inputs: dict) -> Variant:
    """Variant ``name`` at the shapes of ``inputs``."""
    return variants(inputs["x"].shape[1], inputs["a0"].shape[0],
                    inputs["bt"])[name]


def call(name: str, inputs: dict, n_it: int, twin: bool = False,
         precision: str = "highest"):
    """Run variant ``name`` (its kernel entry, or its twin) on ``inputs``."""
    v = variant(name, inputs)
    fn = v.twin if twin else v.entry
    args = (inputs["x"], inputs[v.operand], n_it)
    if name == "minv_blockdiag":
        args += (inputs["bt"],)
    return fn(*args, precision=precision)


def _row_rel(a, b):
    """Per-row max |a - b| relative to the row's max |b|."""
    a, b = a.double(), b.double()
    return (a - b).abs().amax(1) / b.abs().amax(1).clamp(min=1e-300)


def exact_bf16_minv(minv, seed: int = 1):
    """A Minv of ``minv``'s shape on which the two-limb arithmetic is exact:
    each problem's matrix is a random signed permutation times 1 + 2^-10,
    so hi = +-1 and lo = +-2^-10, each output element is one bf16 element
    of x times 1 + 2^-10 (exact in fp32), and rounding it to bf16 in the
    next iteration gives that element back. Every summation order then
    gives the same bits over any number of iterations, while a kernel that
    drops the lo limb misses by 2^-10 and one that does not round x by
    about n_it 2^-10."""
    B, nz, _ = minv.shape
    gen = torch.Generator(device=minv.device).manual_seed(seed)
    kw = dict(generator=gen, device=minv.device)
    perm = torch.argsort(torch.rand((B, nz), **kw), dim=1)
    sign = torch.randint(0, 2, (B, nz), **kw).to(minv.dtype) * 2 - 1
    return torch.zeros_like(minv).scatter_(
        2, perm[:, :, None], (sign * (1 + 2.0 ** -10))[:, :, None])


def exact_inputs(inputs: dict, seed: int = 1) -> dict:
    """``inputs`` with matrices on which one bf16 pass ("default") is exact,
    as ``exact_bf16_minv`` makes Minv: Minv and its mflat view from
    ``exact_bf16_minv``; a0 with one entry +-22 a row j, in column
    perm[j mod nz]; s7 with one entry 48 a column of each of its seven
    blocks, in row perm_t[c]. Each output of a product is then one product
    of bf16 values (significands of 8 and at most 5 bits, exact in fp32) or
    a sum of ceil(m / nz) equal ones (matvec_pair's second product), exact
    in any order; what is rounded besides (the operands to bf16, the
    combine's weights and 1e-3) is the same operation, in the same order,
    in kernel and twin. So the 'default' kernels give their twins' bits
    over any number of iterations, although they round x to bf16 in every
    one. At unit-ish gain: 1e-3 22^2 2 = 0.968 an iteration for a0 at
    m = 2 nz."""
    x = inputs["x"]
    B, nz = x.shape
    m = inputs["a0"].shape[0]
    dev, dt = x.device, x.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)
    minv = exact_bf16_minv(inputs["minv"], seed)
    perm = torch.randperm(nz, generator=gen, device=dev)
    sign = torch.randint(0, 2, (m,), generator=gen, device=dev).to(dt) * 2 - 1
    a0 = torch.zeros((m, nz), dtype=dt, device=dev)
    a0[torch.arange(m, device=dev), perm[torch.arange(m, device=dev) % nz]] = \
        22.0 * sign
    s7 = torch.zeros((nz, 7 * nz), dtype=dt, device=dev)
    cols = torch.arange(7 * nz, device=dev)
    rows = torch.stack([torch.randperm(nz, generator=gen, device=dev)
                        for _ in range(7)]).reshape(-1)
    s7[rows, cols] = 48.0
    return dict(inputs, a0=a0, s7=s7, minv=minv,
                mflat=minv.reshape(B // inputs["bt"], inputs["bt"] * nz, nz))


# matvec_pair rounds its intermediate y to bf16 inside an iteration at
# "default": there a one-ulp difference between two fp32 summation orders
# can flip a rounding of y_j (2^-7 of it), which moves x' by up to
# 1e-3 2^-7 |y_j| |a0_jk|, about 1e-4 of the row's max on the unit-gain
# inputs; so it is held to 1e-3 at one iteration there (and to 1e-5 over
# n_it iterations on ``exact_inputs``, where no rounding can flip).
MATVEC_DEFAULT_ONE_IT_TOL = 1e-3

# "high" over n_it iterations: bf16_3x carries x to 2^-17 of each element,
# and where a 1-ulp difference between two fp32 summation orders moves an
# element's hi limb across a bf16 rounding boundary, that remainder jumps by
# up to 2^-16 of the element; over 25 iterations at unit gain the jumps add
# up. On the H100 the kernels sat 3.0e-5 to 8.0e-5 from their twins per row
# (flagship shapes, 25 iterations); 1e-5 holds at one iteration.
HIGH_TOL = 2e-4


def check_against_twin(name: str, inputs: dict, n_it: int,
                       precision: str = "highest",
                       tol: float = 1e-5) -> dict:
    """Run variant ``name``'s kernel and its twin on ``inputs`` (CUDA,
    fp32) in ``precision``, check that the entry launched its kernel once,
    and raise unless every row of the kernel is within ``tol`` of the twin,
    relative to the row's max-abs in the twin. ``minv_bf16`` (every
    precision) and every variant at "default" round x to bf16 in every
    iteration, so after the first one a 1-ulp difference between two fp32
    summation orders can flip a rounding (2^-9 of that element): they are
    held at one iteration on ``inputs`` (``matvec_pair`` to
    ``MATVEC_DEFAULT_ONE_IT_TOL``) and over ``n_it`` iterations on
    ``exact_inputs``, where their arithmetic is exact. "high" is held to
    ``tol`` at one iteration and to ``HIGH_TOL`` over ``n_it``. Returns the
    errors."""
    runs = [(inputs, n_it, tol)]
    if precision == "high" and name != "minv_bf16":
        runs = [(inputs, 1, tol), (inputs, n_it, max(tol, HIGH_TOL))]
    if name == "minv_bf16" or precision == "default":
        one = MATVEC_DEFAULT_ONE_IT_TOL if (
            name == "matvec_pair" and precision == "default") else tol
        runs = [(inputs, 1, one), (exact_inputs(inputs), n_it, tol)]
    entry = variant(name, inputs).entry
    errs, max_abs = [], 0.0
    for inp, k, _ in runs:
        n0 = entry.launches
        ker = call(name, inp, k, precision=precision)
        if entry.launches != n0 + 1:
            raise AssertionError(f"{name}: the entry did not launch its "
                                 "kernel")
        if not bool(torch.isfinite(ker).all()):
            raise AssertionError(f"{name}: the kernel's result is not finite")
        twin = call(name, inp, k, twin=True, precision=precision)
        errs.append(_row_rel(ker, twin))
        max_abs = max(max_abs, float((ker - twin).abs().max()))
    out = dict(precision=precision, iterations=[k for _, k, _ in runs],
               tol=[t for _, _, t in runs],
               max_rel_err=[float(e.max()) for e in errs],
               max_abs_err=max_abs)
    if any(bool((e > t).any()) for e, (_, _, t) in zip(errs, runs)):
        raise AssertionError(f"{name}: kernel and twin disagree: {out}")
    return out


_STACK7_GAIN = math.sqrt(sum((0.1 + t) ** 2 for t in range(7)))


def make_inputs(B: int, bt: int, nz: int = NZ, m: int = M, device="cuda",
                seed: int = 0, dtype=torch.float32, unit_gain: bool = False):
    """x (B, nz), a0 (m, nz), minv (B, nz, nz), its (B/bt, bt nz, nz) view
    mflat and s7 (nz, 7 nz), standard normals from
    ``torch.Generator(device).manual_seed(seed)`` at the original's scales
    (a0 0.1, minv 0.01, s7 0.01). With ``unit_gain`` the same draws are
    scaled so that each variant's iteration map has a spectral radius near
    1 (a0 sqrt(1e3) / (sqrt(m) + sqrt(nz)), the edge of 1e-3 a0'a0's
    spectrum; minv 1/sqrt(nz); s7 1e3 / (sqrt(nz) |0.1 + t|)): at the
    original's scales the matvec and stack7 iterates fall by ~1e-3 an
    iteration and underflow fp32 before 25 iterations, which leaves
    nothing to compare."""
    if B % bt:
        raise ValueError(f"B={B} is not a multiple of bt={bt}")
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=gen, dtype=dtype, device=device)
    if unit_gain:
        sa = math.sqrt(1e3) / (math.sqrt(m) + math.sqrt(nz))
        sm = 1.0 / math.sqrt(nz)
        ss = 1e3 / (math.sqrt(nz) * _STACK7_GAIN)
    else:
        sa, sm, ss = 0.1, 0.01, 0.01
    x = torch.randn((B, nz), **kw)
    a0 = torch.randn((m, nz), **kw) * sa
    minv = torch.randn((B, nz, nz), **kw) * sm
    s7 = torch.randn((nz, 7 * nz), **kw) * ss
    return dict(x=x, a0=a0, minv=minv,
                mflat=minv.reshape(B // bt, bt * nz, nz), s7=s7, bt=bt)


def time_ms(name: str, inputs: dict, n_it: int, loop: int = 10,
            reps: int = 3, twin: bool = False,
            precision: str = "highest") -> float:
    """ms per launch, timed as the original times it: ``loop`` back-to-back
    launches of 0.999 f(x), best of ``reps``, here by CUDA events."""
    x0 = inputs["x"]

    def run():
        xx = x0
        for _ in range(loop):
            xx = 0.999 * call(name, dict(inputs, x=xx), n_it, twin,
                              precision)
        return xx

    run()
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        run()
        e1.record()
        torch.cuda.synchronize()
        best = min(best, e0.elapsed_time(e1))
    return best / loop


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def run(batch: int = 1024, bt: int = 32, iters: int = 25, loop: int = 10,
        reps: int = 3, precision: str = "highest", out=print) -> int:
    """The probe on ``cuda:0`` in ``precision``; returns the number of
    variants that failed."""
    _precision("run", precision)
    resolve_device("cuda")
    out(card_line())
    out(f"precision {precision}")
    inputs = make_inputs(batch, bt)
    failed = 0
    for name, v in variants(NZ, M, bt).items():
        try:
            best = time_ms(name, inputs, iters, loop, reps,
                           precision=precision)
            per_iter_us = best / iters * 1e3
            tf = 2 * v.macs * batch * iters / (best * 1e-3) / 1e12
            out(f"{v.label}: {best:7.2f} ms/chunk  {per_iter_us:7.1f} us/iter"
                f"  useful {tf:5.1f} TF/s")
        except Exception as e:  # noqa: BLE001 (reported, then exit non-zero)
            failed += 1
            out(f"{v.label}: FAILED {type(e).__name__}: {str(e)[:100]}")
    return failed


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--bt", type=int, default=32)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--loop", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--precision", default="highest", choices=PRECISIONS)
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    failed = run(args.batch, args.bt, args.iters, args.loop, args.reps,
                 args.precision)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
