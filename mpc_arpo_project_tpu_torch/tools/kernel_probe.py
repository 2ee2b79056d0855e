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
``<entry>.launches``. All six kernels run in fp32 on the CUDA cores: there
is no TF32 here, which is the original's ``precision="highest"``; its
other precisions name TPU matrix-unit pass counts and raise.

    python -m mpc_arpo_project_tpu_torch.tools.kernel_probe \\
        [--batch 1024] [--bt 32] [--iters 25] [--loop 10] [--reps 3] \\
        [--precision highest]

prints the card's name and power limit, then for each variant the
original's line: ms per chunk (``loop`` back-to-back launches of
0.999 f(x), best of ``reps``, CUDA events), µs per iteration and useful
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

def matvec_pair_ref(x, a0, n_it: int):
    for _ in range(n_it):
        x = 1e-3 * ((x @ a0.T) @ a0)
    return x


def minv_rowvec_ref(x, minv, n_it: int):
    for _ in range(n_it):
        x = torch.bmm(x[:, None, :], minv)[:, 0]
    return x


def minv_lhs_ref(x, minv, n_it: int):
    for _ in range(n_it):
        x = torch.bmm(minv, x[:, :, None])[:, :, 0]
    return x


def bf16_limbs(minv, dtype):
    """hi = bf16(M), lo = bf16(M - hi), both as ``dtype`` values."""
    hi = minv.to(torch.bfloat16)
    lo = (minv - hi.to(minv.dtype)).to(torch.bfloat16)
    return hi.to(dtype), lo.to(dtype)


def minv_bf16_ref(x, minv, n_it: int):
    """The two-limb split made with ``.to(torch.bfloat16)``; the limb
    products, exact in fp32, summed in ``x.dtype``."""
    hi, lo = bf16_limbs(minv, x.dtype)
    for _ in range(n_it):
        xb = x.to(torch.bfloat16).to(x.dtype)[:, None, :]
        x = (torch.bmm(xb, hi) + torch.bmm(xb, lo))[:, 0]
    return x


def minv_blockdiag_ref(x, mflat, n_it: int, bt: int):
    B, nz = x.shape
    # (bt, bt nz) float mask: 1 where column k lies in row p's block
    blk = torch.arange(bt * nz, device=x.device) // nz
    maskf = (blk[None, :] == torch.arange(bt, device=x.device)[:, None]).to(
        x.dtype)
    for _ in range(n_it):
        xe = x.reshape(B // bt, bt, nz).repeat(1, 1, bt) * maskf
        x = torch.bmm(xe, mflat).reshape(B, nz)
    return x


def stack7_ref(x, s7, n_it: int):
    nz = x.shape[1]
    for _ in range(n_it):
        xs = x @ s7
        acc = (0.1 + 0) * xs[:, :nz]
        for t in range(1, 7):
            acc = acc + (0.1 + t) * xs[:, t * nz:(t + 1) * nz]
        x = 1e-3 * acc
    return x


# ---------------------------------------------------------------------------
# dispatching entries
# ---------------------------------------------------------------------------

def matvec_pair(x, a0, n_it: int):
    """n_it times x <- 1e-3 (x a0') a0; x (B, nz), a0 (m, nz)."""
    if _on_cpu("matvec_pair", x):
        return matvec_pair_ref(x, a0, n_it)
    return _run(matvec_pair, 0, x, a0, (a0.shape[0], x.shape[1]), n_it)


def minv_rowvec(x, minv, n_it: int):
    """n_it times x_p <- x_p Minv_p; minv (B, nz, nz)."""
    if _on_cpu("minv_rowvec", x):
        return minv_rowvec_ref(x, minv, n_it)
    return _run(minv_rowvec, 1, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it)


def minv_lhs(x, minv, n_it: int):
    """n_it times x_p <- (Minv_p x_p')'; minv (B, nz, nz)."""
    if _on_cpu("minv_lhs", x):
        return minv_lhs_ref(x, minv, n_it)
    return _run(minv_lhs, 2, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it)


def minv_bf16(x, minv, n_it: int):
    """n_it times x_p <- xb hi + xb lo (bf16 limbs of Minv_p and x_p)."""
    if _on_cpu("minv_bf16", x):
        return minv_bf16_ref(x, minv, n_it)
    return _run(minv_bf16, 3, x, minv, (x.shape[0],) + (x.shape[1],) * 2,
                n_it)


def minv_blockdiag(x, mflat, n_it: int, bt: int):
    """n_it times the block-diagonal product of each tile of ``bt``
    problems; mflat (B/bt, bt nz, nz) is Minv (B, nz, nz) reshaped."""
    if _on_cpu("minv_blockdiag", x):
        return minv_blockdiag_ref(x, mflat, n_it, bt)
    B, nz = x.shape
    if bt < 1 or B % bt:
        raise ValueError(f"minv_blockdiag: B={B} is not a multiple of "
                         f"bt={bt}")
    if bt > 32 or nz > 256:
        raise ValueError(f"minv_blockdiag: the kernel takes bt <= 32 and "
                         f"nz <= 256, not bt={bt}, nz={nz}")
    return _run(minv_blockdiag, 4, x, mflat, (B // bt, bt * nz, nz), n_it,
                bt=bt)


def stack7(x, s7, n_it: int):
    """n_it times x <- 1e-3 sum_t (0.1 + t) (x s7)[:, t nz:(t+1) nz]; s7
    (nz, 7 nz)."""
    if _on_cpu("stack7", x):
        return stack7_ref(x, s7, n_it)
    return _run(stack7, 5, x, s7, (x.shape[1], 7 * x.shape[1]), n_it)


for _entry in (matvec_pair, minv_rowvec, minv_lhs, minv_bf16, minv_blockdiag,
               stack7):
    _entry.launches = 0


def _on_cpu(name, x):
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return False


def _lib():
    lib = _build.load_library("kernel_probe", ("kernel_probe.cu",))
    if not getattr(lib, "_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.probe_run.argtypes = [I, P, P, P, P, I, I, I, I, I, P]
        lib.probe_run.restype = I
        lib._typed = True
    return lib


def _run(entry, variant, x, mat, mat_shape, n_it, bt=1):
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
    m = mat_shape[0] if variant == 0 else nz
    out = torch.empty_like(x)
    buf = torch.empty((2, B, nz) if variant == 4 else (1,), dtype=x.dtype,
                      device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = _lib().probe_run(variant, x.data_ptr(), mat.data_ptr(),
                               out.data_ptr(), buf.data_ptr(), B, bt, nz, m,
                               int(n_it), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")
    entry.launches += 1
    return out


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


def call(name: str, inputs: dict, n_it: int, twin: bool = False):
    """Run variant ``name`` (its kernel entry, or its twin) on ``inputs``."""
    v = variant(name, inputs)
    fn = v.twin if twin else v.entry
    args = (inputs["x"], inputs[v.operand], n_it)
    if name == "minv_blockdiag":
        return fn(*args, inputs["bt"])
    return fn(*args)


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


def check_against_twin(name: str, inputs: dict, n_it: int,
                       tol: float = 1e-5) -> dict:
    """Run variant ``name``'s kernel and its twin on ``inputs`` (CUDA,
    fp32), check that the entry launched its kernel once, and raise unless
    every row of the kernel is within ``tol`` of the twin, relative to the
    row's max-abs in the twin. ``minv_bf16`` rounds x to bf16 in every
    iteration, so after the first one a 1-ulp difference between two fp32
    summation orders can flip a rounding (2^-9 of that element): it is
    held at one iteration on ``inputs`` and over ``n_it`` iterations on
    ``exact_bf16_minv``'s Minv, where its arithmetic is exact. Returns the
    errors."""
    runs = [(inputs, n_it)]
    if name == "minv_bf16":
        runs = [(inputs, 1),
                (dict(inputs, minv=exact_bf16_minv(inputs["minv"])), n_it)]
    entry = variant(name, inputs).entry
    errs, max_abs = [], 0.0
    for inp, k in runs:
        n0 = entry.launches
        ker = call(name, inp, k)
        if entry.launches != n0 + 1:
            raise AssertionError(f"{name}: the entry did not launch its "
                                 "kernel")
        if not bool(torch.isfinite(ker).all()):
            raise AssertionError(f"{name}: the kernel's result is not finite")
        twin = call(name, inp, k, twin=True)
        errs.append(_row_rel(ker, twin))
        max_abs = max(max_abs, float((ker - twin).abs().max()))
    out = dict(iterations=[k for _, k in runs],
               max_rel_err=[float(e.max()) for e in errs],
               max_abs_err=max_abs)
    if any(bool((e > tol).any()) for e in errs):
        raise AssertionError(f"{name}: kernel and twin disagree (tol "
                             f"{tol:g}): {out}")
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
            reps: int = 3, twin: bool = False) -> float:
    """ms per launch, timed as the original times it: ``loop`` back-to-back
    launches of 0.999 f(x), best of ``reps``, here by CUDA events."""
    x0 = inputs["x"]

    def run():
        xx = x0
        for _ in range(loop):
            xx = 0.999 * call(name, dict(inputs, x=xx), n_it, twin)
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
    """The probe on ``cuda:0``; returns the number of variants that
    failed."""
    if precision != "highest":
        raise ValueError(
            f"precision={precision!r}: the probe runs every product in full "
            "fp32 on the CUDA cores; 'high' and 'default' name TPU "
            "matrix-unit pass counts and have no counterpart here")
    resolve_device("cuda")
    out(card_line())
    inputs = make_inputs(batch, bt)
    failed = 0
    for name, v in variants(NZ, M, bt).items():
        try:
            best = time_ms(name, inputs, iters, loop, reps)
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
    ap.add_argument("--precision", default="highest",
                    choices=("highest", "high", "default"))
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    failed = run(args.batch, args.bt, args.iters, args.loop, args.reps,
                 args.precision)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
