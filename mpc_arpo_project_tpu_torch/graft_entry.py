"""Entry points: one control step of the flagship, and a multi-rank dry run.

    python -m mpc_arpo_project_tpu_torch.graft_entry
    torchrun --nproc-per-node N -m mpc_arpo_project_tpu_torch.graft_entry

Counterpart of the repository's ``__graft_entry__.py``. ``entry()`` returns
one full control step of the offset-free MPC engine on the reference
radial scenario (batched QP solve -> failsafe switching -> saturation ->
plant step -> UKF -> constraint rebuild) at B=8, in the production 'eig'
profile, with its arguments. ``dryrun_multichip(n)`` splits a Monte-Carlo
sweep step (batched closed loop and its statistics, reduced over the ranks)
over the n ranks of an initialised ``torch.distributed`` process group and
runs it once on small shapes.

The command line runs ``entry()``'s step on the card, then the dry run:
under ``torchrun`` over its world (one card a rank, NCCL), else over a
process group of one rank.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from mpc_arpo_project_tpu_torch import bench
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.parallel import mc
from mpc_arpo_project_tpu_torch.rollout import discrete

# the production solver profile both JAX entry points run
# (``__graft_entry__.py:80-82``, ``:121-123``): the shared-basis 'eig'
# kernel path with stall exit, so the step covers the flagship compute path
PROFILE = dict(solve_mode="eig", max_iter=1000, stall_exit_chunks=12,
               stall_tighten_chunks=24, pallas_tile=8)


def _flagship(T_final=5.0, dtype=torch.float32, settings=None, device="cuda"):
    """The Nx=40 flagship engine (``__graft_entry__.py:17-62``: bench's
    scenario at horizon 40), with ``settings`` (the solver's defaults when
    None)."""
    mpc, fail, debris = bench.flagship_parts(40)
    return discrete.build_engine(
        bench.flagship_sim(T_final), mpc, fail, debris,
        settings=admm.ADMMSettings() if settings is None else settings,
        dtype=dtype, device=device)


def entry(device="cuda", dtype=torch.float32):
    """``(fn, (carry0, step_in))``: ``fn(carry, step_in)`` runs one control
    step of the B=8 batch and returns the new carry and the step's
    telemetry (``discrete._step``'s pair; the JAX ``fn`` returns the carry
    alone, the telemetry holds the statuses and controller codes).
    ``step_in`` is ``(i, noise)``: step 0 and zero noise."""
    engine = _flagship(settings=admm.ADMMSettings(**PROFILE), dtype=dtype,
                       device=device)
    B = 8
    carry0 = discrete._init_carry(engine, B, engine.x0.expand(B, 4))
    noise0 = torch.zeros((B, 4), dtype=engine.dtype, device=engine.device)

    def fn(carry, step_in):
        i, noise = step_in
        return discrete._step(engine, carry, i, noise)

    return fn, (carry0, (0, noise0))


def dryrun_multichip(n_devices: int) -> mc.SweepStats:
    """One sharded sweep step over the ``n_devices`` ranks of the
    initialised process group (``__graft_entry__.py:89-138``): a 2-D
    ("dcn", "ici") mesh shaped (2, n/2) when n is even and at least 4, else
    a flat ("data",) one; ``mc.sharded_stats_fn`` of the Nx=40 flagship for
    5 control steps at B = 2n, on this rank's card under NCCL, else on the
    CPU. Checks the count and a finite final-distance sum, prints the
    result on rank 0 and returns the reduced statistics."""
    if not dist.is_initialized():
        raise RuntimeError("dryrun_multichip needs an initialised "
                           "torch.distributed process group")
    world = dist.get_world_size()
    if world != n_devices:
        raise ValueError(f"need {n_devices} ranks, have {world}")
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(n_devices)
    if n_devices % 2 == 0 and n_devices >= 4:
        mesh = DeviceMesh(device, ranks.reshape(2, n_devices // 2),
                          mesh_dim_names=("dcn", "ici"))
    else:
        mesh = DeviceMesh(device, ranks, mesh_dim_names=("data",))
    engine = _flagship(T_final=2.5, settings=admm.ADMMSettings(**PROFILE),
                       device=device)
    B = 2 * n_devices
    # every rank draws the whole batch from one seed and keeps its slice
    gen = torch.Generator(device=engine.device).manual_seed(0)
    noise = discrete.make_noise_sequence(engine, gen, B)
    stats = mc.sharded_stats_fn(engine, mesh)(engine, noise)
    if stats.n != B:
        raise AssertionError(f"{stats.n} scenarios reduced, not {B}")
    if not np.isfinite(stats.sum_final_dist):
        raise AssertionError(f"final-distance sum {stats.sum_final_dist}")
    if dist.get_rank() == 0:
        print(f"dryrun_multichip ok: mesh="
              f"{dict(zip(mesh.mesh_dim_names, mesh.shape))} scenarios="
              f"{stats.n} mpc_steps={stats.n_mpc} failsafe_steps="
              f"{stats.n_failsafe} mean_final_dist="
              f"{stats.sum_final_dist / B:.3f}", flush=True)
    return stats


def main() -> int:
    admm.resolve_device("cuda")
    torchrun = "WORLD_SIZE" in os.environ
    if torchrun:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    fn, (carry, step_in) = entry()
    carry, out = fn(carry, step_in)
    torch.cuda.synchronize()
    if not torch.isfinite(carry.x_true).all():
        raise AssertionError("entry(): non-finite state after one step")
    print("entry() run ok", flush=True)
    if torchrun:
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        dryrun_multichip(dist.get_world_size())
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
