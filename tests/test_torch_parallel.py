"""The port's Monte-Carlo sweeps (``parallel/mc.py``, ``parallel/mesh.py``)
and per-scenario noise hold lengths against the JAX package, on the small
engines of ``tests/test_parallel.py`` at T_final=10 s (fp64, CPU; JAX's
Pallas 'eig' kernel runs as its own tests run it). torch's generators do
not draw JAX's threefry stream, so both packages get the same draws: JAX's
own where the port has a from-draws form, numpy's or the port's otherwise.
In one process, without a process group (the two-process sweep is
``tests/test_torch_distributed.py``)."""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.parallel import mc as jmc
from mpc_arpo_project_tpu.rollout import continuous as jc
from mpc_arpo_project_tpu.rollout import discrete as jd
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.parallel import mc as tmc
from mpc_arpo_project_tpu_torch.parallel import mesh as tmesh
from mpc_arpo_project_tpu_torch.rollout import continuous as tc
from mpc_arpo_project_tpu_torch.rollout import discrete as td
from tests.test_parallel import _build_small_engine, _small_configs
from tests.test_torch_continuous import radial_c
from tests.torch_helpers import SWEEP_SETTINGS, sweep_engine
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

COUNTS = ("n", "n_success", "sum_i_term", "n_mpc", "n_failsafe", "n_deadbeat",
          "sum_iters")


@pytest.fixture(scope="module")
def engines():
    cache = {}

    def get(mode):
        if mode not in cache:
            cache[mode] = sweep_engine(mode)
        return cache[mode]
    return get


def _jax_engine(mode):
    return _build_small_engine(
        10.0, settings=jadmm.ADMMSettings(**SWEEP_SETTINGS[mode]))


@pytest.mark.parametrize("case", ["uniform", "mixed"])
def test_noise_sequence_multi_matches_jax(engines, case):
    """The cases of ``test_noise_sequence_multi_matches_uniform``: JAX's own
    draws through the port's from-draws form give JAX's sequence bit for
    bit; uniform hold lengths give ``make_noise_sequence``'s sequence from
    the same generator state; mixed ones hold each scenario's noise."""
    teng = engines("chol")
    jeng = _jax_engine("chol")
    key = jax.random.key(11)
    holds = (np.full(8, teng.noise_rep) if case == "uniform"
             else np.array([1, 2, 4, 5, 8, 10, 20, 40]))
    n_draws = teng.nsim // holds.min() + 2
    draws = jax.random.normal(key, (n_draws, 8, 4), dtype=jnp.float64)
    ref = np.asarray(jd.make_noise_sequence_multi(jeng, key, holds))
    got = td.noise_sequence_multi_from_draws(teng, np.array(draws), holds)
    np.testing.assert_array_equal(got.numpy(), ref)

    seq = td.make_noise_sequence_multi(
        teng, torch.Generator().manual_seed(3), holds).numpy()
    assert seq.shape == (teng.nsim, 8, 4)
    if case == "uniform":
        np.testing.assert_array_equal(seq, td.make_noise_sequence(
            teng, torch.Generator().manual_seed(3), 8).numpy())
    for b, h in enumerate(holds):
        for t0 in range(0, teng.nsim, h):
            blk = seq[t0: t0 + h, b]
            assert (blk == blk[0]).all()


def _assert_stats_equal(t, j):
    for k in COUNTS:
        assert int(getattr(t, k)) == int(getattr(j, k)), k
    np.testing.assert_allclose(float(t.sum_final_dist),
                               float(j.sum_final_dist), rtol=1e-9)


@pytest.mark.parametrize("mode", ["chol", "eig"])
def test_chunk_stats_matches_jax(engines, mode):
    """B=16 on the same numpy draws: counts and ``sum_iters`` equal, the
    final-distance sum to 1e-9."""
    teng = engines(mode)
    jeng = _jax_engine(mode)
    draws = np.random.RandomState(5).normal(
        size=(teng.nsim // teng.noise_rep + 2, 16, 4))
    jst = jax.jit(jmc.chunk_stats)(jeng, jd.noise_sequence_from_draws(jeng, draws))
    tst = tmc.chunk_stats(teng, td.noise_sequence_from_draws(teng, draws))
    _assert_stats_equal(tst, jst)
    assert tst.n_mpc + tst.n_failsafe > 0


def test_continuous_chunk_stats_matches_jax():
    """The continuous branch (``x_true_ticks``, ``i_term_sub // n_sub``) on
    the radialC scenario for 3 s (5 ticks of 500 substeps), B=4, 'chol',
    on the same pre-scaled draws; a loop of one tick is refused."""
    sim, mpc, fail, debris = radial_c(True, False, 3.0, noise_length=2)
    st = dict(max_iter=1000)
    jeng = jc.build_engine(sim, mpc, fail, debris,
                           settings=jadmm.ADMMSettings(**st), dtype=jnp.float64)
    teng = tc.build_engine(sim, mpc, fail, debris,
                           settings=tadmm.ADMMSettings(**st),
                           dtype=torch.float64, device="cpu")
    n_draws = teng.n_ticks * teng.n_sub // teng.noise_int_sub + 2
    draws = float(teng.sig_cont) * np.random.RandomState(4).normal(
        size=(n_draws, 4, 2))
    jst = jax.jit(jmc.chunk_stats)(jeng, jnp.asarray(draws))
    tst = tmc.chunk_stats(teng, torch.as_tensor(draws))
    _assert_stats_equal(tst, jst)

    short = tc.build_engine(*radial_c(True, False, 0.5), device="cpu",
                            dtype=torch.float64)
    with pytest.raises(ValueError, match="at least 2 ticks"):
        tmc.chunk_stats(short, torch.zeros((3, 4, 2), dtype=torch.float64))


def _sum_chunks(engine, seed, n_chunks, chunk):
    st = [tmc.sharded_stats_fn(engine, None)(
        engine, tmc._draw_chunk(engine, seed, ci, chunk))
        for ci in range(n_chunks)]
    return {k: sum(getattr(s, k) for s in st) for k in tmc.SweepStats._fields}


def test_run_sweep_equals_its_chunks(engines):
    """A sweep is the sum of ``chunk_stats`` over its chunks' draws; a
    ragged total (12 in chunks of 8) runs its last chunk at full width;
    ``success_rate_study`` on the same engine gives the same result."""
    engine = engines("chol")
    res = tmc.run_sweep(engine, total=12, chunk=8, seed=7)
    acc = _sum_chunks(engine, 7, 2, 8)
    assert res["n"] == acc["n"] == 16
    assert res["ctrl_usage"] == {"mpc": acc["n_mpc"],
                                 "failsafe": acc["n_failsafe"],
                                 "deadbeat": acc["n_deadbeat"]}
    assert res["total_admm_iters"] == acc["sum_iters"]
    assert res["success_rate"] == acc["n_success"] / 16
    assert res["mean_i_term"] == acc["sum_i_term"] / 16
    np.testing.assert_allclose(res["mean_final_dist"],
                               acc["sum_final_dist"] / 16, rtol=1e-12)
    assert isinstance(res["ctrl_usage"]["mpc"], int)

    sim, mpc, fail, debris = _small_configs(10.0)
    study = tmc.success_rate_study(
        sim, mpc, fail, debris, 16, 8, 7, dtype=torch.float64, device="cpu",
        settings=tadmm.ADMMSettings(**SWEEP_SETTINGS["chol"]))
    assert study == res


def test_continuous_run_sweep_equals_its_chunks():
    """``run_sweep`` on a continuous engine (2 s: 3 ticks run, B=2) draws
    each chunk with ``make_noise_draws`` and sums its ``chunk_stats``."""
    sim, mpc, fail, debris = radial_c(True, False, 2.0, noise_length=2)
    engine = tc.build_engine(sim, mpc, fail, debris, dtype=torch.float64,
                             settings=tadmm.ADMMSettings(max_iter=1000),
                             device="cpu")
    res = tmc.run_sweep(engine, total=4, chunk=2, seed=3)
    acc = _sum_chunks(engine, 3, 2, 2)
    assert res["n"] == 4
    assert res["total_admm_iters"] == acc["sum_iters"]
    assert res["mean_i_term"] == acc["sum_i_term"] / 4
    np.testing.assert_allclose(res["mean_final_dist"],
                               acc["sum_final_dist"] / 4, rtol=1e-12)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A checkpoint written by the JAX package's ``run_sweep``."""
    path = str(tmp_path_factory.mktemp("jax_ck") / "sweep.json")
    jmc.run_sweep(_jax_engine("chol"), total=8, chunk=8,
                  key=jax.random.key(7), checkpoint_path=path)
    return path


def test_sweep_checkpoint_resume(engines, tmp_path, jax_checkpoint):
    """A checkpoint cut after chunk 0 resumes to the uninterrupted sweep;
    the file has JAX's keys and the port's seed; a JAX-written file is
    refused; a checkpoint of another seed is not resumed."""
    engine = engines("chol")
    full = tmc.run_sweep(engine, total=16, chunk=8, seed=7)

    ck = str(tmp_path / "sweep.json")
    tmc.run_sweep(engine, total=8, chunk=8, seed=7, checkpoint_path=ck)
    with open(ck) as fh:
        state = json.load(fh)
    with open(jax_checkpoint) as fh:
        jstate = json.load(fh)
    assert set(state) == set(jstate) | {"torch_seed"}
    assert set(state["acc"]) == set(jstate["acc"])
    assert state["next_chunk"] == 1 and state["torch_seed"] == 7
    state["total"] = 16  # as if a 16-scenario sweep stopped after chunk 0
    with open(ck, "w") as fh:
        json.dump(state, fh)
    resumed = tmc.run_sweep(engine, total=16, chunk=8, seed=7,
                            checkpoint_path=ck)
    assert resumed == full
    with open(ck) as fh:
        assert json.load(fh)["next_chunk"] == 2
    # a finished sweep resumes to its result without running a chunk
    assert tmc.run_sweep(engine, total=16, chunk=8, seed=7,
                         checkpoint_path=ck) == full

    with pytest.raises(ValueError, match="JAX"):
        tmc.run_sweep(engine, total=8, chunk=8, seed=7,
                      checkpoint_path=jax_checkpoint)
    # a finished seed-7 sweep with sums no run gives: seed 8 starts over
    with open(ck) as fh:
        state = json.load(fh)
    state["acc"] = {k: 1000 for k in state["acc"]}
    with open(ck, "w") as fh:
        json.dump(state, fh)
    other = tmc.run_sweep(engine, total=16, chunk=8, seed=8,
                          checkpoint_path=ck)
    assert other["n"] == 16 and other != full
    with open(ck) as fh:
        assert json.load(fh)["torch_seed"] == 8


def test_fused_disturbance_study_matches_per_setting():
    """The one-batch study reproduces per-setting rollouts of the port on
    the same draws (rtol 1e-9), and each arm's final-distance sum is the
    JAX package's ``_final_distance`` sum on those draws (rtol 1e-9)."""
    import dataclasses

    sim, mpc, fail, debris = _small_configs()
    sim = dataclasses.replace(sim, T_final=10.0)
    lengths, R, seed = [5, 10], 4, 9
    kw = dict(settings=tadmm.ADMMSettings(max_iter=500), dtype=torch.float64,
              device="cpu")
    nls, ratios = tmc.disturbance_rejection_study_fused(
        sim, mpc, fail, debris, lengths, R, seed, **kw)
    assert list(nls) == lengths and ratios.shape == (2,)
    assert np.isfinite(ratios).all() and (ratios > 0).all()

    sim_rej = dataclasses.replace(sim, isReject=True)
    sim_norej = dataclasses.replace(sim, isReject=False)
    e_rej = td.build_engine(sim_rej, mpc, fail, debris, **kw)
    e_norej = td.build_engine(sim_norej, mpc, fail, debris, **kw)
    hold = np.repeat(np.asarray(lengths), R)
    draws = torch.randn((e_rej.nsim // 5 + 2, 2 * R, 4), dtype=torch.float64,
                        generator=torch.Generator().manual_seed(seed))
    half = td.noise_sequence_multi_from_draws(e_rej, draws, hold)
    jst = jadmm.ADMMSettings(max_iter=500)
    j_rej = jd.build_engine(sim_rej, mpc, fail, debris, settings=jst,
                            dtype=jnp.float64)
    j_norej = jd.build_engine(sim_norej, mpc, fail, debris, settings=jst,
                              dtype=jnp.float64)
    jroll = jax.jit(jd.rollout)
    for li in range(len(lengths)):
        ns = half[:, li * R: (li + 1) * R]
        fd = {}
        for arm, te, je in (("rej", e_rej, j_rej), ("norej", e_norej, j_norej)):
            fd[arm] = float(tmc._final_distance(td.rollout(te, ns), te.xr).sum())
            jout = jroll(je, jnp.asarray(ns.numpy()))
            np.testing.assert_allclose(
                fd[arm], float(jmc._final_distance(jout, je.xr).sum()),
                rtol=1e-9, err_msg=f"{arm} arm, length {lengths[li]}")
        np.testing.assert_allclose(ratios[li], fd["rej"] / fd["norej"],
                                   rtol=1e-9)


def test_disturbance_study_per_setting():
    """The per-setting study: for each hold length, the ratio of the two
    arms' final-distance sums on the draws of ``(seed, i)``."""
    import dataclasses

    sim, mpc, fail, debris = _small_configs(10.0)
    kw = dict(settings=tadmm.ADMMSettings(max_iter=500), dtype=torch.float64,
              device="cpu")
    sim_rej = dataclasses.replace(sim, isReject=True)
    sim_norej = dataclasses.replace(sim, isReject=False)
    nls, ratios = tmc.disturbance_rejection_study(
        sim_norej, sim_rej, mpc, fail, debris, [10], 4, 5, **kw)
    e_rej = td.build_engine(sim_rej, mpc, fail, debris, **kw)
    e_norej = td.build_engine(sim_norej, mpc, fail, debris, **kw)
    ns = td.make_noise_sequence(e_rej, tmc.chunk_generator(e_rej, 5, 0), 4)
    sums = [float(tmc.chunk_stats(e, ns).sum_final_dist)
            for e in (e_rej, e_norej)]
    assert list(nls) == [10]
    np.testing.assert_allclose(ratios, [sums[0] / sums[1]], rtol=1e-12)


def test_mesh_without_process_group():
    """Without a process group: a world of one, no mesh to make, and the
    sweep runs whole in this process."""
    world, devices = tmesh.host_device_counts()
    assert world == 1 and devices >= 1
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
