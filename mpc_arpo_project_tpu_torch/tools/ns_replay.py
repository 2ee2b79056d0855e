"""Replay saved kernel calls on another tree's kernels and compare their
results bit for bit.

    python3 chip_smoke.py --ns-dump FILE
    python3 mpc_arpo_project_tpu_torch/tools/ns_replay.py --tree DIR FILE

The first command saves every ``eig_chunk``, ``admm_chunk``, ``ns_fused``
and ``newton_schulz_inverse`` kernel call of chip_smoke's comparisons: its
inputs (fp32, cast to the call's type as chip_smoke casts them), keywords,
and what the kernel returned (the chunk kernels: the sha256 of x, y, z and
the stats; Newton–Schulz: the sha256 of X and the residuals; NaNs made one
NaN). The second imports ``mpc_arpo_project_tpu_torch`` from ``DIR``
(another checkout, e.g. an older commit), runs each call through that
tree's kernel on the card, and reports, per call, whether the results are
identical. Keywords the other tree's entry does not take (``n_need``,
``n_live``, ``group``, ``layout``) are dropped. Where the tree's
``eig_chunk`` takes ``group`` (older trees), each call also runs with every
slots-per-block S the call's ``bt`` and type allow; where it takes
``layout``, with those S and every cluster size C of
``admm_eig.CLUSTERS``; where its
``admm_chunk`` takes ``layout``, with every (cluster size C, slots per
block S) of ``admm_pallas.LAYOUTS``. Each run is timed on that tree
(median of 5 CUDA-event runs after one warm-up), so two trees' kernels can
be timed on the same inputs in one run. Exits 1 if any run differs, 2
without a card. Needs torch and a CUDA device, nothing else.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import os
import statistics
import sys


def digest(t):
    """sha256 of a tensor's bytes, every NaN made the same NaN first."""
    import torch

    t = torch.where(torch.isnan(t), torch.full_like(t, float("nan")), t)
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _same(a, b):
    import torch

    return a.shape == b.shape and bool(
        ((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def _time_ms(fn, n=5):
    import torch

    fn()
    times = []
    for _ in range(n):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _chunk_runs(entry, mod, c, dt):
    """(label, extra keywords) of the runs of one saved chunk-kernel call:
    the call's own, then each layout the tree can force (``eig_chunk``:
    slots per block S, and clusters of C blocks where it has them;
    ``admm_chunk``: cluster size C and slots per block S)."""
    params = inspect.signature(entry).parameters
    runs = [("policy", {})]
    if "group" in params:
        cap = mod.GROUP_CAP[dt]
        runs += [(f"S={S}", {"group": S}) for S in (1, 2, 4, 8)
                 if S <= cap and c["kw"]["bt"] % S == 0]
    if "layout" in params:
        if hasattr(mod, "LAYOUTS"):
            layouts = mod.LAYOUTS[dt]
        else:  # eig_chunk: slots per block S, then clusters of C blocks
            layouts = [(1, S) for S in (1, 2, 4, 8)
                       if S <= mod.GROUP_CAP[dt] and c["kw"]["bt"] % S == 0]
            layouts += [(C, 1) for C in mod.CLUSTERS[dt]]
        runs += [(f"C={C} S={S}", {"layout": (C, S)}) for C, S in layouts]
    return runs, params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True,
                    help="checkout whose mpc_arpo_project_tpu_torch runs")
    ap.add_argument("dump", help="file written by chip_smoke.py --ns-dump")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    from mpc_arpo_project_tpu_torch.ops import admm_eig, admm_pallas

    if not os.path.abspath(admm_pallas.__file__).startswith(tree + os.sep):
        raise RuntimeError(f"imported {admm_pallas.__file__}, not from {tree}")
    if not torch.cuda.is_available():
        print("ns_replay: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    calls = torch.load(args.dump, weights_only=False)["calls"]
    dev = torch.device("cuda")
    moved = {}

    def to_dev(t, dt):
        if not torch.is_tensor(t):
            return t
        key = (id(t), dt)
        if key not in moved:
            v = t.to(dev)
            moved[key] = v.to(dt) if v.is_floating_point() else v
        return moved[key]

    bad = runs_total = 0
    for c in calls:
        dt = getattr(torch, c["dtype"])
        a = [to_dev(t, dt) for t in c["args"]]
        if c["entry"] in ("eig_chunk", "admm_chunk"):
            mod = admm_eig if c["entry"] == "eig_chunk" else admm_pallas
            entry = getattr(mod, c["entry"])
            runs, params = _chunk_runs(entry, mod, c, dt)
            kw = {k: to_dev(v, dt) for k, v in c["kw"].items()
                  if k in params}
            for label, extra in runs:
                kwr = dict(kw, **extra)
                outs = entry(*a, **kwr)
                torch.cuda.synchronize()
                same = [digest(o) == d for o, d in zip(outs, c["digests"])]
                bad += not all(same)
                runs_total += 1
                del outs
                ms = _time_ms(lambda: entry(*a, **kwr))
                print(f"{c['label']} [{label}]: " + ", ".join(
                    f"{n} {'identical' if ok else 'DIFFERS'}"
                    for n, ok in zip(("x", "y", "z", "stats"), same))
                    + f"; {ms:.3f} ms", flush=True)
            continue
        entry = getattr(admm_pallas, c["entry"])
        kw = dict(c["kw"])
        if "n_need" in inspect.signature(entry).parameters:
            kw["n_need"] = c["n_need"]
        x, r = entry(*a, **kw)
        torch.cuda.synchronize()
        same_x = digest(x) == c["x_digest"]
        r_cpu = r.cpu()
        same_r = _same(r_cpu, c["res"])
        bad += not (same_x and same_r)
        runs_total += 1
        del x, r
        ms = _time_ms(lambda: entry(*a, **kw))
        print(f"{c['label']}: X {'identical' if same_x else 'DIFFERS'}, "
              f"residuals {'identical' if same_r else 'DIFFER'}"
              + ("" if same_r else " (max |diff| "
                 f"{float((r_cpu - c['res']).abs().nan_to_num().max()):.3e})")
              + f"; {ms:.3f} ms", flush=True)
    print(f"ns_replay: {runs_total - bad} of {runs_total} runs of "
          f"{len(calls)} calls bit-identical on {admm_pallas.__file__}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
