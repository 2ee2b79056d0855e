"""The port's oracle tools against the JAX package's, on the CPU in fp64:

* the status-mix ``refsim`` arm (``mpc_arpo_project_tpu_torch/tools/
  status_mix.py``) through ``run`` against ``tools/status_mix.py``'s arm on
  the same draws, at the reference success-rate configuration's full 300 s
  horizon with 2 runs: every summary key equal but ``wall_s``; its shard
  files (the configuration cut to 5 s) merge with the unchanged
  ``tools/merge_shards.py``;
* ``continuous_fullscale``: the parity record at T=5 s (the port's fp64
  engine on the CPU against the port's ``simulate_continuous``) against the
  JAX tool's ``run_parity`` record (termination substep, controller
  sequence and success equal, both tick deviations within 1e-6); and
  ``fullscale_record`` at B=2 on draws handed to both packages' engines
  (fp64, T=3 s) against the numbers the JAX tool's ``run_tpu`` records;
* ``deviation_bench``: ``--record --steps 4`` writes arrays equal to the
  JAX tool's; ``replay`` of the first 3 steps of ``artifacts/devseq_r5.npz``
  in fp64 'chol', 'eig' and 'pallas' gives per-step deviations within
  1e-10 of the JAX tool's replay loop (``tools/deviation_bench.py:177-193``)
  with the same statuses, and for 'chol' the JAX tool's ``--replay``
  returns the same maximum;
* the entry points that run on the card raise without one (those of the
  dissection tools and of ``scaling_bench`` too).

The JAX references are computed in module-scoped fixtures.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
from threadpoolctl import threadpool_limits
import torch

import jax.numpy as jnp

from tools import continuous_fullscale as jcf
from tools import deviation_bench as jdb
from tools import merge_shards
from tools import status_mix as jsm
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import continuous as jcont
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.tools import continuous_fullscale as tcf
from mpc_arpo_project_tpu_torch.tools import deviation_bench as tdb
from mpc_arpo_project_tpu_torch.tools import first_divergence as tfd
from mpc_arpo_project_tpu_torch.tools import probe_stall as tps
from mpc_arpo_project_tpu_torch.tools import scaling_bench as tsb
from mpc_arpo_project_tpu_torch.tools import status_mix as tsm
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEVSEQ = os.path.join(REPO, "artifacts", "devseq_r5.npz")
REFSIM = ["--arm", "refsim", "--config", "ref", "--runs", "2", "--device",
          "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """The numpy oracles on one BLAS thread: their matrices are small
    (nz=201, m=406), and several test workers whose BLAS threads spin on
    the same cores ran the refsim arm 6x slower than one thread."""
    with threadpool_limits(1):
        yield


NO_CARD = pytest.mark.skipif(torch.cuda.is_available(),
                             reason="checks the refusal without a CUDA device")


# ----------------------------- the refsim arm -----------------------------

@pytest.fixture(scope="module")
def refsim(tmp_path_factory):
    """The port's arm through ``run`` and the JAX arm on the same draws."""
    out = str(tmp_path_factory.mktemp("refsim") / "whole.json")
    got = tsm.run(REFSIM + ["--out", out])
    sim, mpc, fail, debris = jsm.build_configs("ref")
    draws = np.random.RandomState(20260818).normal(
        0.0, 1.0, size=(sim.nsim // 50 + 2, 2, 4))
    ref = jsm.run_refsim_arm(sim, mpc, fail, debris, draws, max_iter=4000,
                             stall=12)
    return got, out, ref


def test_refsim_arm_matches_jax(refsim):
    summary, out, ref = refsim
    got = summary["arms"]["refsim"]
    assert set(got) == set(ref)
    for k in set(ref) - {"wall_s"}:
        assert got[k] == ref[k], (k, got[k], ref[k])
    assert summary["nsim"] == 600 and summary["shard"] is None
    with open(out) as fh:
        assert json.load(fh) == summary


def test_refsim_shards_merge(tmp_path, monkeypatch, capsys):
    """``--shard 0/2`` and ``1/2`` of the arm (the configuration cut to
    5 s), merged by ``tools/merge_shards.py``, give the unsharded arm's
    counts."""
    def cut(which, sigma=None):
        sim, mpc, fail, debris = build(which, sigma)
        return dataclasses.replace(sim, T_final=5.0), mpc, fail, debris

    build = tsm.build_configs
    monkeypatch.setattr(tsm, "build_configs", cut)
    whole = tsm.run(REFSIM + ["--out", str(tmp_path / "whole.json")])
    whole = whole["arms"]["refsim"]
    paths = [str(tmp_path / f"s{i}.json") for i in range(2)]
    for i, p in enumerate(paths):
        tsm.run(REFSIM + ["--shard", f"{i}/2", "--out", p])
    capsys.readouterr()
    merge_shards.main(paths)
    merged = json.loads(capsys.readouterr().out)["arms"]["refsim"]
    for k in ("alive_steps", "counts", "n_success", "ctrl_usage", "mix",
              "success_rate"):
        assert merged[k] == whole[k], k
    assert merged["runs"] == 2 and merged["shards"] == 2
    np.testing.assert_allclose(merged["mean_i_term"], whole["mean_i_term"],
                               rtol=1e-12)


# ----------------------------- continuous_fullscale -----------------------

def test_parity_record_matches_jax(tmp_path):
    jpath = str(tmp_path / "jax.json")
    jcf.run_parity(5.0, jpath)
    with open(jpath) as fh:
        ref = json.load(fh)
    got = tcf.run_parity(5.0, str(tmp_path / "port.json"), device="cpu")
    assert got["backend"] == "cpu" and got["device"] == "cpu"
    assert got["substeps"] == ref["substeps"] == 5000
    assert got["i_term_sub_port"] == ref["i_term_sub_jax"]
    assert got["i_term_sub_oracle"] == ref["i_term_sub_oracle"]
    assert got["ctrl_seq_equal"] and ref["ctrl_seq_equal"]
    assert got["success_port"] == ref["success_jax"]
    assert got["success_oracle"] == ref["success_oracle"]
    assert got["tick_traj_max_abs_dev"] <= 1e-6
    assert ref["tick_traj_max_abs_dev"] <= 1e-6
    assert tcf.parity_ok(got)


def test_fullscale_record_matches_jax():
    """B=2, T=3 s, fp64: the port's record holds the numbers the JAX tool's
    ``run_tpu`` records (``tools/continuous_fullscale.py:66-85``) from the
    JAX engine on the same draws."""
    T = 3.0
    jeng = jcont.build_engine(*jcf._configs(T),
                              settings=jadmm.ADMMSettings(max_iter=1000),
                              dtype=jnp.float64)
    teng = tcf.build(T, torch.float64, "cpu")
    n_draws = teng.n_ticks * teng.n_sub // teng.noise_int_sub + 2
    draws = float(teng.sig_cont) * np.random.RandomState(2).normal(
        size=(n_draws, 2, 2))
    out = jcont.rollout_chunked(jeng, jnp.asarray(draws), seg=25)
    codes = np.asarray(out.ctrl_seq)
    ref = {
        "batch": 2,
        "substeps_per_scenario": 3000,
        "T_final_s": 3.0,
        "alive_ticks": int((codes > 0).sum()),
        "i_term_sub": np.asarray(out.i_term_sub).tolist(),
        "success": np.asarray(out.success).astype(int).tolist(),
        "ctrl_usage": {"mpc": int((codes == 1).sum()),
                       "failsafe": int((codes == 2).sum()),
                       "deadbeat": int((codes == 3).sum())},
        "status_mix_alive": {str(k): int((np.asarray(out.status) == k).sum())
                             for k in (1, 2, 3)},
    }
    rec, tout = tcf.fullscale_record(teng, torch.as_tensor(draws))
    for k, v in ref.items():
        assert rec[k] == v, (k, rec[k], v)
    assert rec["dtype"] == "f64" and rec["solve_mode"] == "chol"
    assert rec["launches"] == {"eig_chunk": 0, "rk4_tick": 0}  # the twins
    assert rec["wall_cold_s"] is None
    np.testing.assert_allclose(tout.x_true_ticks.numpy(),
                               np.asarray(out.x_true_ticks), rtol=0,
                               atol=1e-9)


# ----------------------------- deviation_bench ----------------------------

def test_record_matches_jax(tmp_path):
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jdb.main(["--record", jpath, "--steps", "4"])
    assert tdb.main(["--record", tpath, "--steps", "4"]) is None
    ref, got = np.load(jpath), np.load(tpath)
    assert sorted(got.files) == sorted(ref.files)
    for k in ref.files:
        assert np.array_equal(got[k], ref[k]), k
    assert got["l"].shape == (4, 406)


def _jax_replay(mode, dtype, rec):
    """The JAX tool's replay loop (``tools/deviation_bench.py:160-193``,
    the CPU's batch of one): per-step deviations and statuses."""
    _, dims, static, nominal = tdb.problem_setup(60)
    settings = jadmm.ADMMSettings(solve_mode=mode)
    prob = jadmm.prepare_problem(static, dims, settings,
                                 nominal_coeffs=nominal, dtype=dtype,
                                 pad=(mode in ("pallas", "eig")))
    state = jadmm.init_state(prob, 1, settings)
    i0 = (dims.Nx + 1) * 4
    devs, statuses = [], []
    for k in range(rec["l"].shape[0]):
        cc = tuple(jnp.full(1, c, dtype=dtype) for c in rec["coeffs"][k])
        lk = jnp.asarray(rec["l"][k], dtype=dtype)[None]
        uk = jnp.asarray(rec["u"][k], dtype=dtype)[None]
        res = jadmm.admm_solve(prob, cc, lk, uk, state, settings)
        state = res.state
        devs.append(float(np.abs(np.asarray(res.x[0, i0: i0 + 2])
                                 - rec["u_true"][k]).max()))
        statuses.append(int(res.status[0]))
    return np.asarray(devs), np.asarray(statuses)


@pytest.fixture(scope="module")
def devseq3():
    rec = np.load(DEVSEQ)
    return {k: rec[k][:3] for k in ("l", "u", "coeffs", "u_true")}


def test_replay_chol_matches_jax(devseq3, tmp_path):
    ref_devs, ref_st = _jax_replay("chol", jnp.float64, devseq3)
    prob, settings = tdb.prepare("chol", torch.float64, "cpu")
    devs, st = tdb.replay(prob, settings, devseq3["l"], devseq3["u"],
                          devseq3["coeffs"], devseq3["u_true"])
    np.testing.assert_array_equal(st, ref_st)
    np.testing.assert_allclose(devs, ref_devs, rtol=0, atol=1e-10)
    # the JAX tool itself, on the same three steps
    path = str(tmp_path / "devseq3.npz")
    np.savez(path, **devseq3)
    jmax = jdb.main(["--replay", path, "--mode", "chol", "--dtype", "f64"])
    assert (st == admm.SOLVED).all()
    assert abs(jmax - devs.max()) <= 1e-10
    assert tdb.main(["--replay", path, "--cpu"]) == pytest.approx(devs.max(),
                                                                 abs=1e-15)


@pytest.mark.parametrize("mode", ["eig", "pallas"])
def test_replay_fp64_matches_jax(devseq3, mode):
    """The first 3 recorded steps in 'eig' and 'pallas' (the padded
    problem, their kernels' CPU twins) in fp64: the statuses of the JAX
    tool's replay loop, and each step's deviation within 1e-10 of it."""
    ref_devs, ref_st = _jax_replay(mode, jnp.float64, devseq3)
    prob, settings = tdb.prepare(mode, torch.float64, "cpu")
    devs, st = tdb.replay(prob, settings, devseq3["l"], devseq3["u"],
                          devseq3["coeffs"], devseq3["u_true"])
    np.testing.assert_array_equal(st, ref_st)
    np.testing.assert_allclose(devs, ref_devs, rtol=0, atol=1e-10)


# ----------------------------- no card, no run ---------------------------

CAP65 = os.path.join(REPO, "artifacts", "fd_cap65_r5.npz")
STALL = os.path.join(REPO, "artifacts", "stall_probe_r5.npz")
MAINS = {"cf": tcf.main, "db": tdb.main, "fd": tfd.main, "ps": tps.main,
         "sb": tsb.main}


@NO_CARD
@pytest.mark.parametrize("argv", [
    ("cf", ["--gpu", "--T", "1"]),
    ("cf", ["--parity", "--T", "1"]),
    ("db", ["--replay", DEVSEQ]),
    ("db", ["--steps", "2"]),
    ("fd", ["--prod", "prod.npz"]),
    ("fd", ["--oracle", "oracle.npz", "--cols", "0,1"]),
    ("fd", ["--capture", "cap.npz", "--scen", "0", "--step", "65"]),
    ("fd", ["--resolve", CAP65]),
    ("ps", ["--dump", "probe.npz"]),
    ("ps", ["--analyze", STALL]),
    ("ps", ["--dump-full", "full.npz"]),
    ("ps", ["--resolve-full", CAP65]),
    ("sb", ["--devices", "1"]),
], ids=["gpu", "parity", "replay", "record-and-solve", "fd-prod",
        "fd-oracle", "fd-capture", "fd-resolve", "ps-dump", "ps-analyze",
        "ps-dump-full", "ps-resolve-full", "scaling-bench"])
def test_card_entry_points_raise_without_a_card(argv):
    tool, args = argv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MAINS[tool](args)
