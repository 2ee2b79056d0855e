"""The port's ``bench`` module against the repository's ``bench.py``: the
settings its ``BENCH_*`` knobs give, the flagship engine it builds, the
metrics it reports (bench.py's formulas applied to the JAX rollout on the
same numpy noise), its one stdout line, and that it refuses to run on a
CUDA device that is not there."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch import bench as tb
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from mpc_arpo_project_tpu_torch.tools import kernel_probe
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's own stdout line, parsed, from its round-5 run on a TPU v5e
with open(os.path.join(REPO, "BENCH_r05.json")) as _fh:
    BENCH_LINE = json.load(_fh)["parsed"]

# the same float64 host arithmetic on both sides
RTOL = ATOL = 1e-12
# a few control steps of the flagship at B=4 (the first steps of the
# approach: every scenario alive, SOLVED and MAX_ITER exits)
B, T_FINAL = 4, 2.5
# the tiny run of the passes and of main(): 'chol' fp32, a low cap
TINY_ENV = {"BENCH_QUICK": "1", "BENCH_BATCH": "2",
            "BENCH_SOLVE_MODE": "chol", "BENCH_MAX_ITER": "100"}


def _bench_py_settings(check_every=25, solve_mode="eig",
                       compact=(2, 4, 8, 16, 24)):
    """The JAX ``ADMMSettings`` of ``bench.py:94-128``, written with its
    literals for these knob values and every other knob at its default."""
    scale = check_every / 25
    return jadmm.ADMMSettings(
        max_iter=4000, solve_mode=solve_mode, check_every=check_every,
        stall_exit_chunks=max(1, round(12 / scale)),
        stall_tighten_chunks=max(1, round(24 / scale)),
        adaptive_rho=True, ns_refresh_drift=0.02, ir_steps=1,
        pallas_tile=32, eig_tail_mult=1, eig_refresh_cap_div=32,
        eig_apply="loop", eig_deb_equil_smax=32.0, eig_warm_iters=3,
        eig_cold_iters=30, eig_compact_chunks=compact)


@pytest.mark.parametrize("env,expect", [
    ({}, dict()),
    ({"BENCH_CHECK_EVERY": "50", "BENCH_SOLVE_MODE": "pallas",
      "BENCH_COMPACT": "4,8"},
     dict(check_every=50, solve_mode="pallas", compact=(4, 8))),
], ids=["defaults", "check50-pallas-compact"])
def test_bench_settings_match_bench_py(env, expect):
    got = tb.bench_settings(env)
    ref = _bench_py_settings(**expect)
    assert tadmm.ADMMSettings._fields == jadmm.ADMMSettings._fields
    assert got._asdict() == ref._asdict()
    # the stall windows stay constant in iterations: 12/24 chunks of 25
    # are 6/12 chunks of 50
    stall = (12, 24) if not env else (6, 12)
    assert (got.stall_exit_chunks, got.stall_tighten_chunks) == stall
    assert tb.bench_settings({})._replace(solve_mode="pallas") \
        == tb.bench_settings({"BENCH_SOLVE_MODE": "pallas"})


def _engines(mode, T_final, tile=None):
    """The bench flagship in ``mode`` (fp64, CPU) built by both packages
    from ``T.bench``'s configuration and bench.py's settings."""
    env = {"BENCH_SOLVE_MODE": mode}
    if tile:
        env["BENCH_TILE"] = str(tile)
    st = tb.bench_settings(env)
    mpc, fail, debris = tb.flagship_parts()
    sim = tb.flagship_sim(T_final)
    teng = tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                              dtype=torch.float64, device="cpu")
    jeng = jdisc.build_engine(sim, mpc, fail, debris,
                              settings=jadmm.ADMMSettings(**st._asdict()),
                              dtype=jnp.float64)
    return jeng, teng


@pytest.mark.parametrize("mode", ["eig", "pallas", "chol"])
def test_flagship_engine_matches_jax(mode):
    jeng, teng = _engines(mode, 150.0)
    assert teng.nsim == jeng.nsim == 300
    assert (teng.dims.nz, teng.dims.m) == (241, 496)
    for name in jadmm.ADMMProblem._fields:
        jv, tv = getattr(jeng.prob, name), getattr(teng.prob, name)
        assert (jv is None) == (tv is None), name
        if jv is not None:
            np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                                       atol=ATOL, err_msg=name)
    for name in ("Ad", "Bd", "Kpf", "Kif", "K_total", "K_i", "Crefx", "Ao",
                 "Bou", "Qw", "R_meas", "leq0", "umin", "umax", "x0", "xr",
                 "sig_diag"):
        np.testing.assert_allclose(getattr(teng, name).numpy(),
                                   np.asarray(getattr(jeng, name)),
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert teng.noise_rep == jeng.noise_rep == 50


@pytest.fixture(scope="module", params=["chol", "eig"])
def rollouts(request):
    """Both packages' rollouts of the bench flagship (fp64, B=4, 5 steps;
    'eig' with ``pallas_tile=4``) on the same numpy draws."""
    mode = request.param
    jeng, teng = _engines(mode, T_FINAL, tile=4 if mode == "eig" else None)
    draws = np.random.RandomState(3).normal(
        size=(teng.nsim // teng.noise_rep + 2, B, 4))
    jout = jax.tree.map(np.asarray, jax.jit(jdisc.rollout)(
        jeng, jdisc.noise_sequence_from_draws(jeng, draws)))
    tout = tdisc.rollout(teng, tdisc.noise_sequence_from_draws(teng, draws))
    return mode, jeng, teng, jout, tout


def test_summarize_matches_bench_py_formulas(rollouts):
    mode, jeng, teng, j, t = rollouts
    np.testing.assert_array_equal(t.status.numpy(), j.status)
    wall = 2.0
    s = tb.summarize(t, teng, B, wall, [])
    # bench.py:179-204 on the JAX output
    alive_steps = int((j.ctrl_seq > 0).sum())
    names = {0: "UNSOLVED", 1: "SOLVED", 2: "MAX_ITER", 3: "PINF", 4: "DINF"}
    hist = {names[k]: int((j.status == k).sum()) for k in names}
    mix = {k: round(v / max(alive_steps, 1), 4) for k, v in hist.items()}
    assert s["alive_steps"] == alive_steps == B * jeng.nsim
    assert s["total_steps"] == jeng.nsim * B
    assert s["status_hist"] == hist and s["status_mix_alive"] == mix
    assert hist["SOLVED"] and hist["MAX_ITER"]
    assert s["success_rate"] == float(j.success.mean())
    assert s["mean_admm_iters_per_step"] == float(j.iters.mean())
    assert s["solves_per_sec"] == alive_steps / wall
    assert s["raw_steps_per_sec"] == jeng.nsim * B / wall
    alive = j.ctrl_seq > 0
    for code in (1, 2, 3):
        sel = j.done_iters[(j.status == code) & alive]
        if sel.size:
            q = np.percentile(sel, [50, 90, 99])
            got = s["done_iters"][names[code]]
            assert [got["p50"], got["p90"], got["p99"]] == q.tolist()
            assert (got["max"], got["n"]) == (sel.max(), sel.size)
        else:
            assert names[code] not in s["done_iters"]
    # without a latency pass p50 = p95 = the timed pass's mean step
    assert s["p50_step_ms"] == s["p95_step_ms"] == wall / jeng.nsim * 1000.0
    lat = tb.summarize(t, teng, B, wall, [0.1, 0.2, 0.3, 0.4], lat_seg=2)
    assert lat["p50_step_ms"] == np.percentile([50, 100, 150, 200], 50)
    assert lat["p95_step_ms"] == np.percentile([50, 100, 150, 200], 95)


def test_passes_on_the_cpu():
    """``run``'s first and timed passes (quick: no latency pass) on the
    CPU, the timed pass on the draws of ``seed + 1``; the latency pass
    times one segment per ``lat_seg`` steps."""
    st = tb.bench_settings(TINY_ENV)
    r = tb.run(st, 2, True, device="cpu", seed=5)
    assert r.engine.nsim == 60 and r.engine.dtype == torch.float32
    assert r.build_and_first_s > 0 and r.wall > 0
    assert r.seg_times == [] and r.max_memory_allocated_bytes is None
    gen = torch.Generator().manual_seed(6)
    noise = tdisc.make_noise_sequence(r.engine, gen, 2)
    assert torch.equal(r.out.noise[1:], noise)
    assert tuple(r.out.status.shape) == (60, 2)
    skipped = tb.run(st, 2, True, device="cpu", seed=5, first_pass=False)
    assert skipped.build_and_first_s is None
    assert torch.equal(skipped.out.status, r.out.status)
    short = tdisc.build_engine(
        tb.flagship_sim(T_FINAL), *tb.flagship_parts(), settings=st,
        dtype=torch.float32, device="cpu")
    for lat_seg, n in ((1, 5), (5, 1)):
        times = tb.latency_pass(short, noise[:5], lat_seg)
        assert len(times) == n and all(v > 0 for v in times)


def test_main_prints_one_line_with_bench_py_keys(monkeypatch, capsys):
    """``main()`` on the CPU (the device check and the card's name stood in
    for): exactly one stdout line, bench.py's top-level keys, ``extras`` a
    superset of bench.py's with the port's backend, dtype and device."""
    monkeypatch.setattr(tadmm, "resolve_device",
                        lambda device: torch.device("cpu"))
    monkeypatch.setattr(kernel_probe, "card_line",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    assert tb.main(TINY_ENV) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == set(BENCH_LINE)
    assert line["metric"] == BENCH_LINE["metric"]
    assert set(line["extras"]) >= set(BENCH_LINE["extras"])
    assert set(line["extras"]["solver"]) == set(BENCH_LINE["extras"]["solver"])
    extras = line["extras"]
    assert (extras["backend"], extras["dtype"]) == ("torch", "float32")
    assert extras["device"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert extras["batch"] == 2 and extras["solver"]["solve_mode"] == "chol"
    assert "BENCH_APPLY=loop" in extras["bench_apply"]
    assert line["value"] == round(extras["alive_steps"] / extras["wall_s"], 1)


def test_refuses_a_missing_card(monkeypatch):
    """No CUDA device: ``run(device="cuda")`` and ``main()`` raise (no
    fallback to the CPU, no smaller retry, no zero line)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.run(tb.bench_settings({}), 2, True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tb.main(TINY_ENV)
