"""Run down where an fp32 'pallas' chunk row leaves the fp64 result.

    python3 chip_smoke.py --ns-dump DUMP
    python3 -m mpc_arpo_project_tpu_torch.tools.chunk_fault DUMP --save ROW
    python3 -m mpc_arpo_project_tpu_torch.tools.chunk_fault --row ROW

With a dump (on a card): takes the dump's fp32 ``admm_chunk`` call labelled
"fp32 after 5 steps", runs the CUDA kernel and the fp64 plain twin on it,
picks the live row whose x is farthest from fp64 (relative to the row's
max-abs), and runs that row alone (a slot's result does not depend on the
other slots) through the kernel for 1..n_iter iterations, saving the row's
inputs and the kernel's x, y, z after each iteration to ``ROW``. With
``--row`` it works from such a file, on the CPU or the card.

Then, on that row:

1. ``emulate``, a torch replica of the kernel's arithmetic (each column
   dot product in the kernel's eight FMA chains and their pairwise sum,
   each A0 row in a warp's 32 lane chains and its butterfly; fp32 FMA done
   in fp64 and rounded once more), is checked against the kernel's x, y, z
   after each iteration;
2. the distance of x from the fp64 twin after each iteration, for the
   kernel and for the fp32 twin, and the local error of one kernel
   iteration from the kernel's own state (against one fp64 iteration from
   the same state): the iteration where the kernel's distance opens up;
3. the replica run with one part of the iteration at a time in the fp32
   twin's order (torch matmul) or in fp64: the A'v pair, the two Minv
   applies, the stack7 product, the A pair. The part whose fp64 version
   closes the gap carries the error.

Prints one line per finding and a JSON summary as its last line.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

PARTS = ("ATv", "minv", "stack7", "Av")
# per-slot arguments of admm_chunk, in order; the rest are shared
_PER_SLOT = 10


def _fma(a, b, c):
    """fp32 fused multiply-add: the fp32 product is exact in fp64."""
    return (a.double() * b.double() + c.double()).float()


def dot_cols(v, M):
    """out[r, j] = sum_i v[r, i] M[i, j] (M (n, ncol) shared or (R, n, ncol)
    per row) in ``block_ops.cuh``'s ``dot_col`` order: eight interleaved
    fp32 FMA chains over rows i = q mod 8, the rows past the last full
    eight into chain 0, then ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7))."""
    n = v.shape[1]
    Mb = M if M.dim() == 3 else M[None]
    acc = torch.zeros((8, v.shape[0], Mb.shape[2]), dtype=torch.float32,
                      device=v.device)
    full = n - n % 8
    for i in range(0, full, 8):
        vi = v[:, i:i + 8].T[:, :, None]             # (8, R, 1)
        Mi = Mb[:, i:i + 8].transpose(0, 1)          # (8, R|1, ncol)
        acc = _fma(vi, Mi, acc)
    for i in range(full, n):
        acc[0] = _fma(v[:, i:i + 1], Mb[:, i], acc[0])
    return ((acc[0] + acc[1]) + (acc[2] + acc[3])) + (
        (acc[4] + acc[5]) + (acc[6] + acc[7]))


def matvec_rows(M, v):
    """out[r, i] = sum_j M[i, j] v[r, j] in ``block_ops.cuh``'s ``matvec``
    order: lane l of a warp chains j = l, l + 32, ... in fp32 FMA, then the
    xor butterfly over 16, 8, 4, 2, 1."""
    nrow, ncol = M.shape
    acc = torch.zeros((v.shape[0], nrow, 32), dtype=torch.float32,
                      device=v.device)
    lanes = torch.arange(32, device=v.device)
    for j0 in range(0, ncol, 32):
        js = j0 + lanes
        ok = js < ncol
        jc = js.clamp(max=ncol - 1)
        new = _fma(M[:, jc][None], v[:, jc][:, None, :], acc)
        acc = torch.where(ok, new, acc)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lanes ^ o]
    return acc[..., 0]


def _prec(order, fn32, ref, *xs):
    """A product in the kernel's order (``fn32``), the twin's (``ref``,
    torch matmul in the operands' type) or in fp64 (rounded back)."""
    if order == "kernel":
        return fn32(*xs)
    if order == "twin":
        return ref(*xs)
    return ref(*[x.double() for x in xs]).to(xs[0].dtype)


def emulate(row, n_iter, orders=None, dtype=torch.float32):
    """``n_iter`` iterations of the kernel's arithmetic on the saved row
    (batch of rows) in ``dtype``. ``orders`` maps each part of ``PARTS`` to
    'kernel' (the default), 'twin' or 'fp64' (fp32 only). Returns a list of
    (x, y, z) after each iteration."""
    orders = dict.fromkeys(PARTS, "kernel") | dict(orders or {})
    a = [t.to(dtype) if t.is_floating_point() else t for t in row["args"]]
    (minv, coef, qbar, lbar, ubar, rho, x, y, z, w7, a0, pbar, gsel, scat,
     rsel, gscat, stack7, einv, dinv) = a
    k = row["kw"]
    sigma, alpha = (torch.tensor(k[n], dtype=dtype) for n in ("sigma",
                                                              "alpha"))
    one_m_alpha = torch.tensor(1.0 - k["alpha"], dtype=dtype)
    nz, gw = x.shape[1], gsel.shape[1] // 3
    wsel = torch.cat([coef[:, i:i + 1].expand(-1, gw) for i in (1, 2, 3)], 1)
    if dtype == torch.float64:
        orders = dict.fromkeys(PARTS, "twin")
    mm = lambda v, M: (v[:, None, :] @ M)[:, 0] if M.dim() == 3 else v @ M

    def ATv(w):
        def f32(w):
            g = wsel * dot_cols(w, rsel)
            return dot_cols(w, a0) + dot_cols(g, gscat)

        def ref(w):
            return mm(w, a0.to(w.dtype)) + (wsel.to(w.dtype) * mm(
                w, rsel.to(w.dtype))) @ gscat.to(w.dtype)
        return _prec(orders["ATv"], f32, ref, w)

    def Av(v):
        def f32(v):
            g = wsel * dot_cols(v, gsel)
            return matvec_rows(a0, v) + dot_cols(g, scat)

        def ref(v):
            return v @ a0.to(v.dtype).T + (wsel.to(v.dtype) * (
                v @ gsel.to(v.dtype))) @ scat.to(v.dtype)
        return _prec(orders["Av"], f32, ref, v)

    def Minv(v):
        return _prec(orders["minv"], lambda v: dot_cols(v, minv),
                     lambda v: mm(v, minv.to(v.dtype)), v)

    def Mv(v):
        def f32(v):
            # the kernel's contraction: fma(w0, d0, w1 d1), then fma
            d = [dot_cols(v, stack7[:, t * nz:(t + 1) * nz])
                 for t in range(7)]
            acc = _fma(w7[:, 0:1], d[0], w7[:, 1:2] * d[1])
            for t in range(2, 7):
                acc = _fma(w7[:, t:t + 1], d[t], acc)
            return acc

        def ref(v):
            xs = v @ stack7.to(v.dtype)
            w = w7.to(v.dtype)
            acc = w[:, 0:1] * xs[:, :nz]
            for t in range(1, 7):
                acc = acc + w[:, t:t + 1] * xs[:, t * nz:(t + 1) * nz]
            return acc
        return _prec(orders["stack7"], f32, ref, v)

    fused = dtype == torch.float32
    fm = _fma if fused else (lambda p, q, r: p * q + r)
    out = []
    for _ in range(n_iter):
        w = fm(rho, z, -y)
        v3 = fm(sigma, x, -qbar) + ATv(w)
        xt = Minv(v3)
        xt = xt + Minv(v3 - Mv(xt))
        ax = Av(xt)
        ztmp = fm(alpha, ax, one_m_alpha * z)
        zn = torch.minimum(torch.maximum(ztmp + y / rho, lbar), ubar)
        y = fm(rho, ztmp - zn, y)
        z = zn
        x = fm(alpha, xt, one_m_alpha * x)
        out.append((x, y, z))
    return out


def _rel(a, b):
    """max |a - b| over the row relative to the row's max |b|."""
    a, b = a.double(), b.double()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def extract(dump, label="fp32 after 5 steps"):
    """The worst row of the dump's call ``label`` (see the module
    docstring) with the kernel's x, y, z after each of 1..n_iter
    iterations; needs a card."""
    from mpc_arpo_project_tpu_torch.ops import admm_pallas

    calls = torch.load(dump, weights_only=False)["calls"]
    c = next(c for c in calls
             if c["entry"] == "admm_chunk" and c["label"] == label)
    dev = torch.device("cuda")
    a = [t.to(dev) for t in c["args"]]
    kw = {k: (v.to(dev) if torch.is_tensor(v) else v)
          for k, v in c["kw"].items() if k not in ("n_live", "layout")}
    x32 = admm_pallas.admm_chunk(*a, **kw)[0]
    a64 = [t.double() for t in a]
    x64 = admm_pallas.admm_chunk_ref(*a64, **kw)[0]
    live = ~kw["done"]
    err = ((x32.double() - x64).abs().amax(1)
           / x64.abs().amax(1).clamp(min=1e-300))
    err = torch.where(live, err, torch.zeros_like(err))
    r = int(torch.argmax(err))
    args = [t[r:r + 1].contiguous() if i < _PER_SLOT else t
            for i, t in enumerate(a)]
    base = {k: v for k, v in kw.items() if k != "done"}
    base["done"] = torch.zeros(1, dtype=torch.bool, device=dev)
    kernel = []
    for it in range(1, kw["n_iter"] + 1):
        o = admm_pallas.admm_chunk(*args, **dict(base, n_iter=it))
        kernel.append(tuple(v.cpu() for v in o[:3]))
    return dict(row=r, label=label, args=[t.cpu() for t in args],
                kw={k: (v.cpu() if torch.is_tensor(v) else v)
                    for k, v in base.items()},
                kernel=kernel, row_err=float(err[r]))


def analyse(row):
    """The findings of the module docstring on a saved row; returns the
    summary dict."""
    kw = row["kw"]
    n = kw["n_iter"]
    twin = lambda dt, it: emulate(row, it, dtype=dt)
    ref64 = twin(torch.float64, n)
    ref32 = emulate(row, n, dict.fromkeys(PARTS, "twin"))
    emu = emulate(row, n)
    ker = row["kernel"]
    same = [max(_rel(e[i], k[i]) for i in range(3))
            for e, k in zip(emu, ker)]
    print(f"row {row['row']} of '{row['label']}' (x {row['row_err']:.3e} "
          "from fp64 in the full call)")
    print("replica vs kernel, max rel. diff of x, y, z per iteration: "
          + " ".join(f"{v:.1e}" for v in same), flush=True)
    dist = []
    for it in range(n):
        d_k = _rel(ker[it][0], ref64[it][0])
        d_t = _rel(ref32[it][0], ref64[it][0])
        # one iteration from the kernel's own state, kernel vs fp64
        st = row if it == 0 else dict(row, args=[
            *row["args"][:6], *ker[it - 1], *row["args"][9:]])
        loc64 = emulate(st, 1, dtype=torch.float64)[0][0]
        loc32 = emulate(st, 1, dict.fromkeys(PARTS, "twin"))[0][0]
        l_k = _rel(ker[it][0], loc64)
        l_t = _rel(loc32, loc64)
        dist.append(dict(iteration=it + 1, kernel=d_k, twin32=d_t,
                         local_kernel=l_k, local_twin32=l_t))
        print(f"  iteration {it + 1:2d}: x from fp64: kernel {d_k:.3e}, "
              f"fp32 twin {d_t:.3e}; one iteration from the kernel's state: "
              f"kernel {l_k:.3e}, fp32 twin {l_t:.3e}", flush=True)
    opens = next((d["iteration"] for d in dist
                  if d["kernel"] > 4.0 * d["twin32"] + 1e-6), None)
    swaps = {}
    for part in PARTS:
        for order in ("twin", "fp64"):
            x = emulate(row, n, {part: order})[-1][0]
            swaps[f"{part} {order}"] = _rel(x, ref64[-1][0])
    print("x from fp64 after the chunk: replica "
          f"{_rel(emu[-1][0], ref64[-1][0]):.3e}; with one part swapped: "
          + ", ".join(f"{k} {v:.3e}" for k, v in swaps.items()))
    return dict(row=row["row"], replica_vs_kernel=max(same),
                first_iteration_over_4x_twin=opens, distance=dist,
                swaps=swaps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dump", nargs="?", help="chip_smoke.py --ns-dump file")
    ap.add_argument("--save", help="write the extracted row here")
    ap.add_argument("--row", help="work from a saved row (no card needed)")
    args = ap.parse_args(argv)
    if args.row:
        row = torch.load(args.row, weights_only=False)
    else:
        if not torch.cuda.is_available():
            print("chunk_fault: a dump needs a CUDA device", file=sys.stderr)
            return 2
        torch.backends.cuda.matmul.allow_tf32 = False
        row = extract(args.dump)
        if args.save:
            torch.save(row, args.save)
    summary = analyse(row)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
