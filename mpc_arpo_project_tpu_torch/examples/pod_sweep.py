"""Pod-scale Monte-Carlo sweep across ranks of ``torch.distributed``. Port
of ``examples/pod_sweep.py``.

One process runs the whole sweep on one card. With ``--distributed`` the
process joins the process group that ``torchrun`` describes in its
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``), NCCL between cards or gloo with ``--cpu``; each rank runs
its slice of every chunk and the statistics meet in one collective a
chunk. Over several nodes the mesh is hybrid ("dcn", "ici"). The JAX
driver's ``--virtual N`` (N virtual CPU devices) has no counterpart: run N
CPU ranks instead,

    torchrun --nproc_per_node 8 -m mpc_arpo_project_tpu_torch.examples.pod_sweep \\
        --distributed --cpu --scenarios 64 --chunk 32

    python -m mpc_arpo_project_tpu_torch.examples.pod_sweep --scenarios 4096 --chunk 512
"""

from __future__ import annotations

import argparse
import os
import time

import torch
import torch.distributed as dist

from mpc_arpo_project_tpu_torch.examples.common import radial_config
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc, mesh as mesh_lib
from mpc_arpo_project_tpu_torch.rollout import discrete


def init_distributed(cpu: bool) -> str:
    """Join the ``torchrun`` process group (gloo with ``cpu``, else NCCL on
    the card of this rank's ``LOCAL_RANK``); returns the rank's device."""
    if cpu:
        dist.init_process_group("gloo")
        return "cpu"
    local = int(os.environ.get("LOCAL_RANK", 0))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl")
    return f"cuda:{local}"


def compute(scenarios=4096, chunk=512, checkpoint="pod_sweep_ckpt.json",
            device="cuda", T_final=60.0, mesh=None):
    """(result dict of ``mc.run_sweep``, engine): the radial configuration
    for ``T_final`` s, fp32 on a card or fp64 on the CPU, noise from seed
    1, over ``mesh`` (None: this process alone)."""
    sim, mpc_p, fail, debris = radial_config(noisy=True, T_final=T_final)
    engine = discrete.build_engine(
        sim, mpc_p, fail, debris, settings=admm.ADMMSettings(max_iter=1000),
        dtype=torch.float64 if device == "cpu" else torch.float32,
        device=device,
    )
    res = mc.run_sweep(engine, total=scenarios, chunk=chunk, seed=1,
                       mesh=mesh, checkpoint_path=checkpoint)
    return res, engine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scenarios", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=512)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU in fp64 (gloo with --distributed)")
    ap.add_argument("--distributed", action="store_true",
                    help="join the process group torchrun describes")
    ap.add_argument("--checkpoint", default="pod_sweep_ckpt.json")
    args = ap.parse_args(argv)

    device = "cpu" if args.cpu else "cuda"
    mesh = None
    if args.distributed:
        device = init_distributed(args.cpu)
    try:
        if args.distributed:
            world = dist.get_world_size()
            local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
            mesh = mesh_lib.make_mesh(hybrid=world > local)
            print(f"ranks: {world} ({world // local} nodes)")
            print(f"mesh: {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        else:
            print(f"one process on {device}")
        t0 = time.time()
        res, engine = compute(args.scenarios, args.chunk, args.checkpoint,
                              device, mesh=mesh)
        el = time.time() - t0
    finally:
        if args.distributed:
            dist.destroy_process_group()
    print(f"{res['n']} scenarios in {el:.1f}s -> {res['n']/el:.1f} sims/s "
          f"({res['n'] * engine.nsim / el:,.0f} control steps/s)")
    print(f"success rate {res['success_rate']:.3f}; "
          f"mean final dist {res['mean_final_dist']:.2f} m")
    print(f"checkpoint: {args.checkpoint} (delete to restart; rerun to resume)")
    return res


if __name__ == "__main__":
    main()
