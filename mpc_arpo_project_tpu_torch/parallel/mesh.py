"""The scenario-sweep mesh over ``torch.distributed`` ranks.

Counterpart of ``mpc_arpo_project_tpu/parallel/mesh.py``. The scenario
batch is the only data axis this problem has (per-problem state is ~250
variables), so a mesh only says how a chunk's batch splits over the ranks
and over which groups its statistics are summed. Where the JAX package
shards one logical array over devices, every rank here runs its own slice
of the batch, one rank per device, and the sums meet in one collective
over all the ranks. Multi-node runs get a hybrid ("dcn", "ici") mesh,
shaped (nodes, ranks per node), which says how the batch is laid out; the
backend (NCCL) already reduces within a node before it crosses nodes.
"""

from __future__ import annotations

import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def host_device_counts() -> tuple[int, int]:
    """(world size, CUDA devices of this host). The world is 1 without a
    process group; the device count is 1 on a host with no CUDA device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return world, (torch.cuda.device_count() or 1)


def make_mesh(hybrid: bool = False) -> DeviceMesh:
    """The mesh of every rank of the initialised process group: flat,
    ("data",), or with ``hybrid`` 2-D ("dcn", "ici"), shaped (nodes, ranks
    per node). Nodes are told apart by host name and must hold equal,
    consecutive blocks of ranks. Raises without a process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group")
    world = dist.get_world_size()
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    ranks = torch.arange(world)
    if not hybrid:
        return DeviceMesh(device_type, ranks, mesh_dim_names=("data",))
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    per = hosts.count(hosts[0])
    if world % per or any(h != hosts[i - i % per] for i, h in enumerate(hosts)):
        raise RuntimeError(f"ranks are not in equal per-node blocks: {hosts}")
    return DeviceMesh(device_type, ranks.reshape(world // per, per),
                      mesh_dim_names=("dcn", "ici"))


def batch_slice(mesh: DeviceMesh, B: int) -> slice:
    """This rank's contiguous share of a batch of ``B``: place r of W holds
    ``[r*B/W, (r+1)*B/W)``, r counted row-major over the mesh's dimensions
    (the order of the JAX package's ``batch_sharding``). Raises when W does
    not divide B."""
    W = mesh.size()
    if B % W:
        raise ValueError(f"a batch of {B} does not split over {W} ranks")
    r = 0
    for c, n in zip(mesh.get_coordinate(), mesh.shape):
        r = r * n + c
    return slice(r * B // W, (r + 1) * B // W)


def _group(mesh: DeviceMesh):
    """The process group of every rank of ``mesh``: its own for a flat
    mesh, the world's for a 2-D one, which must span the world (as every
    mesh of ``make_mesh`` does). One collective over it serves the whole
    mesh; the backend orders the traffic within and across nodes."""
    if mesh.ndim == 1:
        return mesh.get_group()
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a {mesh.ndim}-D mesh of {mesh.size()} ranks does "
                         f"not span the world of {dist.get_world_size()}")
    return dist.group.WORLD


def all_reduce_sum(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Sum ``t`` in place over every rank of ``mesh``, in one
    ``all_reduce``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=_group(mesh))
    return t


def all_gather(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's ``t``, stacked in the order of the mesh's group: shape
    (W, *t.shape), in one ``all_gather``."""
    rows = [torch.empty_like(t) for _ in range(mesh.size())]
    dist.all_gather(rows, t, group=_group(mesh))
    return torch.stack(rows)
