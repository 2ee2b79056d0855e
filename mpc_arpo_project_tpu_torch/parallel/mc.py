"""Monte-Carlo scenario sweeps: the reference's serial MC loops as batched,
chunked, distributed runs.

Counterpart of ``mpc_arpo_project_tpu/parallel/mc.py``. ``run_sweep`` runs
a study's scenarios as chunks of batched closed-loop rollouts, each chunk
reduced on the device to eight statistics (one host read per chunk),
accumulated on the host, checkpointed and resumable. Under a
``torch.distributed`` process group every rank runs its own slice of each
chunk and the statistics meet in one ``all_gather`` (``parallel.mesh``):
the sums are added, the per-step ADMM iterations take the most, as over
one whole batch. Without one the whole chunk runs in this process.

Randomness: chunk ``ci`` draws its noise from a ``torch.Generator`` on the
engine's device seeded from ``(seed, ci)`` alone, the part of the JAX
package's ``fold_in(key, ci)``. Every rank draws the whole chunk and keeps
its slice, so a chunk's scenarios depend neither on resuming nor on the
world size. The draws are not the JAX package's (threefry), so the two
packages' sweeps agree in distribution, not draw for draw.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from mpc_arpo_project_tpu_torch.parallel import mesh as mesh_lib
from mpc_arpo_project_tpu_torch.rollout import continuous as cont
from mpc_arpo_project_tpu_torch.rollout import discrete

# the checkpoint key the port writes beside the JAX package's four: the
# seed of the torch draws. A file without it holds JAX draws' sums.
_SEED_KEY = "torch_seed"


class SweepStats(NamedTuple):
    """Per-chunk reduced statistics: device scalars from ``chunk_stats``,
    Python numbers once reduced over the ranks."""

    n: torch.Tensor  # scenarios in chunk
    n_success: torch.Tensor
    sum_final_dist: torch.Tensor  # sum over scenarios of terminal distance to xr
    sum_i_term: torch.Tensor
    n_mpc: torch.Tensor  # controller-usage step counts
    n_failsafe: torch.Tensor
    n_deadbeat: torch.Tensor
    # total ADMM iterations: per step the most of the whole chunk (over
    # every rank's slice), summed over the steps
    sum_iters: torch.Tensor


def _distance_at(x_hist, i_term, xr):
    """Per scenario, the distance of the state at ``i_term - 1`` (clipped
    to the history) from the target ``xr`` over all 4 states."""
    T1 = x_hist.shape[0]
    idx = (i_term.long() - 1).clamp(0, T1 - 1)
    xf = torch.gather(x_hist, 0, idx[None, :, None].expand(1, -1, 4))[0]
    return torch.linalg.vector_norm(xf - xr[None, :], dim=1)


def _final_distance(out: discrete.RolloutOut, xr: torch.Tensor) -> torch.Tensor:
    """Distance of the state at i_term-1 from the target — the
    disturbance-rejection metric (the reference's ``x_true_pcw[:, i_term-1]
    - xr`` over all 4 states)."""
    return _distance_at(out.x_true, out.i_term, xr)


def _rollout(engine, noise: torch.Tensor):
    """The closed loop of a ``DiscreteEngine`` (noise: (T, B, 4)) or a
    ``ContinuousEngine`` (noise: held draws (n_draws, B, 2)); the
    continuous one needs at least 2 ticks, so that one runs."""
    if isinstance(engine, cont.ContinuousEngine):
        if engine.n_ticks < 2:
            raise ValueError(f"n_ticks={engine.n_ticks}: the sweep's "
                             "continuous loop needs at least 2 ticks")
        return cont.rollout(engine, noise)
    return discrete.rollout(engine, noise)


def _out_stats(engine, out):
    """A rollout output reduced to device scalars, and its per-step ADMM
    iterations (the batch's most) moved to the device."""
    if isinstance(engine, cont.ContinuousEngine):
        xr = engine.base.xr
        x_hist, i_term = out.x_true_ticks, out.i_term_sub // engine.n_sub
    else:
        xr = engine.xr
        x_hist, i_term = out.x_true, out.i_term
    fd = _distance_at(x_hist, i_term, xr)
    codes = out.ctrl_seq  # (T, B)
    # the per-step iteration counts are built on the host
    iters = out.iters.to(fd.device)
    count = lambda v: v.sum(dtype=torch.int64)
    return SweepStats(
        n=torch.tensor(i_term.shape[0], dtype=torch.int64, device=fd.device),
        n_success=count(out.success),
        sum_final_dist=fd.sum(),
        sum_i_term=count(i_term),
        n_mpc=count(codes == 1),
        n_failsafe=count(codes == 2),
        n_deadbeat=count(codes == 3),
        sum_iters=count(iters),
    ), iters


def chunk_stats(engine, noise: torch.Tensor) -> SweepStats:
    """Roll out one scenario chunk and reduce it to device scalars.

    Accepts a ``DiscreteEngine`` (noise: (T, B, 4)) or a
    ``ContinuousEngine`` (noise: held draws (n_draws, B, 2)); the continuous
    one needs at least 2 ticks, so that one runs."""
    return _out_stats(engine, _rollout(engine, noise))[0]


def _reduce(st: SweepStats, iters: torch.Tensor, mesh) -> SweepStats:
    """Combine one chunk's stats over the ranks of ``mesh`` (None: this
    process alone) and read them. Each rank packs its seven sums and its
    per-step iterations into one float64 tensor (counts are exact there
    below 2^53; the float sum keeps the engine's rounding); one
    ``all_gather`` brings every rank's, the sums are added and the
    iterations take the most per step, as over one whole batch. So a chunk
    costs one collective and one host read."""
    k = len(SweepStats._fields) - 1
    packed = torch.cat([torch.stack([v.to(torch.float64) for v in st[:k]]),
                        iters.to(torch.float64)])
    if mesh is not None:
        rows = mesh_lib.all_gather(packed, mesh)
        packed = torch.cat([rows[:, :k].sum(0), rows[:, k:].amax(0)])
    vals = packed.tolist()
    sums = [v if name == "sum_final_dist" else int(v)
            for name, v in zip(SweepStats._fields, vals[:k])]
    return SweepStats(*sums, sum_iters=int(sum(vals[k:])))


def sharded_stats_fn(engine, mesh):
    """``f(engine, noise) -> SweepStats`` (Python numbers) with the batch
    split over ``mesh``: each rank rolls out its ``batch_slice`` of the
    whole chunk's noise (batch axis 1) and the stats are combined over the
    ranks. ``mesh=None``: the whole chunk in this process."""
    def f(e, noise):
        if mesh is not None:
            noise = noise[:, mesh_lib.batch_slice(mesh, noise.shape[1])]
        return _reduce(*_out_stats(e, _rollout(e, noise)), mesh)
    return f


class SweepState(NamedTuple):
    """Host-side accumulated sweep state (checkpointable)."""

    done_scenarios: int
    acc: dict  # accumulated python floats/ints


def _acc_update(acc: Optional[dict], st: SweepStats) -> dict:
    vals = st._asdict()
    if acc is None:
        return vals
    return {k: acc[k] + vals[k] for k in vals}


def _default_mesh(mesh):
    """``mesh``, or where it is None the flat mesh of every rank of an
    initialised process group (the JAX package's default of all devices)."""
    if mesh is None and dist.is_initialized():
        return mesh_lib.make_mesh()
    return mesh


def chunk_generator(engine, seed: int, ci: int) -> torch.Generator:
    """The generator of chunk ``ci``'s draws, on the engine's device, seeded
    from ``(seed, ci)`` alone: the port's ``fold_in(key(seed), ci)``."""
    base = engine.base if isinstance(engine, cont.ContinuousEngine) else engine
    s = np.random.SeedSequence([seed, ci]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=base.device).manual_seed(int(s) >> 1)


def _draw_chunk(engine, seed: int, ci: int, chunk: int) -> torch.Tensor:
    gen = chunk_generator(engine, seed, ci)
    if isinstance(engine, cont.ContinuousEngine):
        return cont.make_noise_draws(engine, gen, chunk)
    return discrete.make_noise_sequence(engine, gen, chunk)


def _read_checkpoint(path: Optional[str], total: int, chunk: int,
                     seed: int):
    """(first chunk to run, accumulated sums) from ``path``: a checkpoint of
    the same total, chunk and seed resumes, any other starts over. Raises on
    a file the JAX package wrote: its sums are of other draws."""
    if not (path and os.path.exists(path)):
        return 0, None
    with open(path) as fh:
        ck = json.load(fh)
    if _SEED_KEY not in ck:
        raise ValueError(f"{path} holds no {_SEED_KEY!r}: a sweep of the JAX "
                         "package wrote it, whose draws this port cannot "
                         "continue")
    if (ck.get("total"), ck.get("chunk"), ck[_SEED_KEY]) != (total, chunk,
                                                            seed):
        return 0, None
    return ck["next_chunk"], ck["acc"]


def run_sweep(
    engine,
    total: int,
    chunk: int,
    seed: int,
    mesh=None,
    checkpoint_path: Optional[str] = None,
) -> dict:
    """Run ``total`` scenarios in chunks of ``chunk``, resumable.

    ``engine``: a ``DiscreteEngine`` or a ``ContinuousEngine``. ``mesh``: a
    ``parallel.mesh`` mesh to split each chunk over; None takes
    ``make_mesh()`` under an initialised process group and runs each chunk
    whole in this process without one. Chunks always run full width, so a
    ragged total runs extra scenarios (all counts use the executed n).

    Checkpointing: after every chunk, rank 0 writes the accumulated sums
    and the next chunk's index to ``checkpoint_path`` (JSON: ``total``,
    ``chunk``, ``next_chunk``, ``acc`` and the port's ``torch_seed``)
    through a ``.tmp`` file and ``os.replace``; a sweep restarted with the
    same arguments resumes after the last chunk written, on every rank."""
    mesh = _default_mesh(mesh)
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    f = sharded_stats_fn(engine, mesh)
    start, acc = _read_checkpoint(checkpoint_path, total, chunk, seed)

    n_chunks = (total + chunk - 1) // chunk
    for ci in range(start, n_chunks):
        acc = _acc_update(acc, f(engine, _draw_chunk(engine, seed, ci, chunk)))
        if checkpoint_path and rank0:
            tmp = checkpoint_path + ".tmp"
            with open(tmp, "w") as fh:
                json.dump({"total": total, "chunk": chunk,
                           "next_chunk": ci + 1, "acc": acc,
                           _SEED_KEY: seed}, fh)
            os.replace(tmp, checkpoint_path)

    n = acc["n"]
    return {
        "n": int(n),
        "success_rate": acc["n_success"] / n,
        "mean_final_dist": acc["sum_final_dist"] / n,
        "mean_i_term": acc["sum_i_term"] / n,
        "ctrl_usage": {
            "mpc": acc["n_mpc"],
            "failsafe": acc["n_failsafe"],
            "deadbeat": acc["n_deadbeat"],
        },
        "total_admm_iters": acc["sum_iters"],
    }


def success_rate_study(
    sim, mpc, fail, debris, n_runs: int, chunk: int, seed: int, mesh=None,
    checkpoint_path: Optional[str] = None, **engine_kw
) -> dict:
    """The success-rate MC (the reference's ``success_rates_test.py``),
    batched: N offset-free noisy runs, count successes, resumable from
    ``checkpoint_path`` as ``run_sweep`` is. ``engine_kw`` goes to
    ``build_engine`` (``device``, ``dtype``, ``settings``, ...)."""
    engine = discrete.build_engine(sim, mpc, fail, debris, **engine_kw)
    return run_sweep(engine, n_runs, chunk, seed, mesh=mesh,
                     checkpoint_path=checkpoint_path)


def disturbance_rejection_study_fused(
    sim,
    mpc,
    fail,
    debris,
    noise_lengths,
    runs_per_setting: int,
    seed: int,
    mesh=None,
    **engine_kw,
):
    """The disturbance-rejection study (the reference's
    ``disturbRejComp.py``) as ONE batch: the noise hold length becomes
    per-scenario noise data (``make_noise_sequence_multi``) and the
    offset-free switch a per-scenario ``is_reject``, so the (lengths x runs
    x 2 arms) grid runs under one engine build. Common random numbers
    across arms: both halves of the batch take the same draws, from a
    generator on the engine's device seeded with ``seed``. Under a process
    group each rank rolls out its slice and sums its final distances into
    the (2, L) sums by global index; one ``all_reduce`` sums them.

    Returns (noise_lengths, dist_ratios)."""
    L = len(noise_lengths)
    R = runs_per_setting
    sim_rej = dataclasses.replace(sim, isReject=True)
    engine = discrete.build_engine(sim_rej, mpc, fail, debris, **engine_kw)
    hold = np.repeat(np.asarray(noise_lengths, dtype=np.int64), R)  # (L*R,)
    gen = torch.Generator(device=engine.device).manual_seed(seed)
    noise_half = discrete.make_noise_sequence_multi(engine, gen, hold)
    noise = torch.cat([noise_half, noise_half], 1)  # (T, 2LR, 4)
    kw = dict(dtype=engine.dtype, device=engine.device)
    is_rej = torch.cat([torch.ones(L * R, **kw), torch.zeros(L * R, **kw)])

    mesh = _default_mesh(mesh)
    sl = (slice(0, 2 * L * R) if mesh is None
          else mesh_lib.batch_slice(mesh, 2 * L * R))
    out = discrete.rollout(engine, noise[:, sl], is_reject_b=is_rej[sl])
    # this rank's final distances in their global places, zeros elsewhere:
    # summed in a fixed order (no atomics), then over the ranks
    fd = torch.zeros(2 * L * R, **kw)
    fd[sl] = _final_distance(out, engine.xr)
    sums = fd.reshape(2, L, R).sum(-1).reshape(-1)
    if mesh is not None:
        mesh_lib.all_reduce_sum(sums, mesh)
    sums = sums.reshape(2, L).cpu().double().numpy()
    ratios = sums[0] / np.maximum(sums[1], 1e-12)
    return np.asarray(noise_lengths), ratios


def disturbance_rejection_study(
    sim_norej,
    sim_rej,
    mpc,
    fail,
    debris,
    noise_lengths,
    runs_per_setting: int,
    seed: int,
    mesh=None,
    **engine_kw,
):
    """The offset-free vs plain-MPC comparison (the reference's
    ``disturbRejComp.py``): for each noise hold length, the ratio of mean
    final distances (reject / no-reject), with common random numbers across
    the two arms (setting ``i`` draws from ``(seed, i)``).

    Returns (noise_lengths, dist_ratios)."""
    mesh = _default_mesh(mesh)
    ratios = []
    for i, nl in enumerate(noise_lengths):
        noise = dataclasses.replace(sim_rej.noise, noise_length=int(nl))
        s_rej = dataclasses.replace(sim_rej, noise=noise)
        s_norej = dataclasses.replace(sim_norej, noise=noise)
        e_rej = discrete.build_engine(s_rej, mpc, fail, debris, **engine_kw)
        e_norej = discrete.build_engine(s_norej, mpc, fail, debris, **engine_kw)
        # common random numbers: same noise for both arms
        noise_seq = discrete.make_noise_sequence(
            e_rej, chunk_generator(e_rej, seed, i), runs_per_setting)
        st_rej = sharded_stats_fn(e_rej, mesh)(e_rej, noise_seq)
        st_norej = sharded_stats_fn(e_norej, mesh)(e_norej, noise_seq)
        ratios.append(st_rej.sum_final_dist
                      / max(st_norej.sum_final_dist, 1e-12))
    return np.asarray(noise_lengths), np.asarray(ratios)
