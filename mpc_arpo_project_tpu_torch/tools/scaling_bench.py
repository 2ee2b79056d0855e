"""Weak scaling of the Monte-Carlo sweep over ``torch.distributed`` ranks.

Port of ``tools/scaling_bench.py``: sweep throughput (sims/s) of
``parallel.mc.run_sweep`` as the number of ranks W grows, with the load
per rank held constant, so ideal scaling doubles throughput per doubling
of ranks. For each W the tool starts W processes (``spawn``) that meet in a
``FileStore`` under a temporary directory (no TCP port): NCCL ranks, one
card each, by default; gloo ranks on the CPU, one torch thread each, with
``--cpu``. They take the place of the JAX tool's ``--virtual`` CPU devices.
Without a CUDA device and without ``--cpu`` the tool raises. A W larger
than the host's card count is not measured: on a one-card machine the tool
gives W=1 only, and says so.

    python -m mpc_arpo_project_tpu_torch.tools.scaling_bench \\
        [--per-device 8] [--devices 1 2 4 8] [--T 30] [--cpu]

The engine is the JAX tool's: the noisy radial configuration, ``T`` s
long, the default 'chol' solve at ``max_iter=500``, in fp32 on the cards
and in fp64 on the CPU. Each W is timed over 2 sweeps of one chunk of
``per_device * W`` scenarios after a warm-up sweep (the median, each ended
by the sweep's own read of its statistics).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc
from mpc_arpo_project_tpu_torch.parallel import mesh as mesh_lib
from mpc_arpo_project_tpu_torch.rollout import discrete
from mpc_arpo_project_tpu_torch.utils.timing import device_time


def _rank(rank, world, device_type, store, per_device, T, out):
    """One rank of a W-rank measurement; rank 0 writes (seconds, n) to
    ``out``."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
        device, dtype, backend = f"cuda:{rank}", torch.float32, "nccl"
    else:
        torch.set_num_threads(1)
        device, dtype, backend = "cpu", torch.float64, "gloo"
    dist.init_process_group(backend, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        engine = discrete.build_engine(
            *radial_config(noisy=True, T_final=T),
            settings=admm.ADMMSettings(max_iter=500), dtype=dtype,
            device=device)
        mesh = mesh_lib.make_mesh()
        B = per_device * world
        res = {}

        def sweep():
            res.update(mc.run_sweep(engine, total=B, chunk=B, seed=world,
                                    mesh=mesh))
            return res

        t = device_time(sweep, reps=2, warmup=1)
        if rank == 0:
            with open(out, "w") as fh:
                json.dump({"seconds": t, "n": res["n"]}, fh)
    finally:
        dist.destroy_process_group()


def measure(world, per_device, T, device_type) -> dict:
    """Seconds of one sweep of ``per_device * world`` scenarios over
    ``world`` ranks."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "rank0.json")
        mp.start_processes(
            _rank, args=(world, device_type, os.path.join(tmp, "store"),
                         per_device, T, out),
            nprocs=world, start_method="spawn")
        with open(out) as fh:
            rec = json.load(fh)
    B = per_device * world
    return dict(devices=world, batch=B, seconds=rec["seconds"],
                sims_per_s=B / rec["seconds"], scenarios_run=rec["n"])


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--per-device", type=int, default=8)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--T", type=float, default=30.0)
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: NCCL ranks, one "
                         "CUDA device each; without one the tool raises)")
    args = ap.parse_args(argv)
    device = admm.resolve_device("cpu" if args.cpu else "cuda")
    if device.type == "cuda":
        from mpc_arpo_project_tpu_torch.tools.kernel_probe import card_line
        n_cards = torch.cuda.device_count()
        print(f"{card_line()}; {n_cards} CUDA device(s), NCCL", flush=True)
    else:
        n_cards = None
        print("cpu, gloo", flush=True)

    results = []
    for nd in args.devices:
        if n_cards is not None and nd > n_cards:
            print(f"devices={nd}: not measured, this host has {n_cards} "
                  f"CUDA device(s)", flush=True)
            break
        r = measure(nd, args.per_device, args.T, device.type)
        base = (results[0] if results else r)["sims_per_s"]
        r["efficiency"] = r["sims_per_s"] / (base * nd)
        results.append(r)
        print(f"devices={nd:2d} batch={r['batch']:4d}: {r['seconds']:7.2f}s "
              f"-> {r['sims_per_s']:8.2f} sims/s (scaling efficiency "
              f"{100 * r['efficiency']:5.1f}%)", flush=True)
    if device.type == "cpu":
        print("NOTE: gloo ranks on the CPU share the physical cores, so "
              "weak-scaling efficiency here is bounded by the core count (it "
              "validates the distributed sweep, not hardware scaling); run "
              "on several cards for the BASELINE efficiency metric.")
    return results


if __name__ == "__main__":
    main()
