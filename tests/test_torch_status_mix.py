"""The port's status-mix tool (``mpc_arpo_project_tpu_torch/tools/
status_mix.py``) against ``tools/status_mix.py``: the same arms on the same
``RandomState`` draws give the same summary (fp64, CPU; JAX's Pallas 'eig'
kernel runs as its own tests run it); its shard files merge with the
unmodified ``tools/merge_shards.py`` into the unsharded counts. The refsim
arm is held to the JAX tool's in ``tests/test_torch_oracle_tools.py``."""

import dataclasses
import json

import numpy as np
import pytest

from tools import merge_shards
from tools import status_mix as jsm
from mpc_arpo_project_tpu_torch.tools import status_mix as tsm
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

T_FINAL, RUNS = 5.0, 4


def _cut(build):
    def f(which, sigma=None):
        sim, mpc, fail, debris = build(which, sigma)
        return dataclasses.replace(sim, T_final=T_FINAL), mpc, fail, debris
    return f


@pytest.fixture(scope="module")
def draws():
    sim = _cut(tsm.build_configs)("bench")[0]
    d, shard = tsm.draw_matrix(sim, RUNS, 20260818)
    assert shard is None
    # the JAX tool's own draws (`tools/status_mix.py:283-288`)
    ref = np.random.RandomState(20260818).normal(
        0.0, 1.0, size=(sim.nsim // 50 + 2, RUNS, 4))
    np.testing.assert_array_equal(d, ref)
    return d


# (arm name, run_rollout_arm's solver keywords)
ARMS = {
    "oracle": tsm.arm_options("oracle"),
    "oracle-nostall": tsm.arm_options("oracle-nostall"),
    "eig-f64": dict(tsm.arm_options("prod"), dtype_str="f64"),
}


@pytest.mark.parametrize("arm", list(ARMS))
def test_rollout_arm_matches_jax(draws, arm):
    """The bench configuration cut to 5 s, 4 runs: every key of the summary
    equal but ``wall_s`` and ``backend``; the exit-residual percentiles
    within 1e-8 relative."""
    kw = dict(ARMS[arm], max_iter=4000, tile=32, seg=10)
    ref = jsm.run_rollout_arm(arm, *_cut(jsm.build_configs)("bench"), draws,
                              **kw)
    got = tsm.run_rollout_arm(arm, *_cut(tsm.build_configs)("bench"), draws,
                              device="cpu", **kw)
    assert got["backend"] == "cpu"
    assert set(got) == set(ref)
    pct = "pctiles_10_50_90_99"
    for k in set(ref) - {"wall_s", "backend", "exit_residuals_over_tol"}:
        assert got[k] == ref[k], (k, got[k], ref[k])
    gres, rres = got["exit_residuals_over_tol"], ref["exit_residuals_over_tol"]
    assert set(gres) == set(rres) and "SOLVED" in rres
    for nm, r in rres.items():
        assert {k: v for k, v in gres[nm].items() if k != pct} == {
            k: v for k, v in r.items() if k != pct}, nm
        if r[pct] is None:
            assert gres[nm][pct] is None
        else:
            np.testing.assert_allclose(gres[nm][pct], r[pct], rtol=1e-8)


def test_shards_merge_into_the_unsharded_run(tmp_path, monkeypatch, capsys):
    """``--shard 0/2`` and ``1/2`` of the 'oracle' arm, merged by
    ``tools/merge_shards.py``, give the unsharded run's counts."""
    monkeypatch.setattr(tsm, "build_configs", _cut(tsm.build_configs))
    base = ["--config", "ref", "--sigma", "0.3", "--runs", str(RUNS),
            "--arm", "oracle", "--device", "cpu"]
    whole = tsm.run(base + ["--out", str(tmp_path / "whole.json")])
    paths = []
    for i in range(2):
        p = str(tmp_path / f"s{i}.json")
        s = tsm.run(base + ["--shard", f"{i}/2", "--out", p])
        assert s["shard"] == {"index": i, "of": 2, "lo": 2 * i, "hi": 2 * i + 2}
        with open(p) as fh:
            assert json.load(fh) == s
        paths.append(p)
    capsys.readouterr()
    merge_shards.main(paths)
    merged = json.loads(capsys.readouterr().out)["arms"]["oracle"]
    w = whole["arms"]["oracle"]
    for k in ("alive_steps", "counts", "n_success", "ctrl_usage", "mix"):
        assert merged[k] == w[k], k
    assert merged["runs"] == RUNS and merged["shards"] == 2
    np.testing.assert_allclose(merged["mean_i_term"], w["mean_i_term"],
                               rtol=1e-12)
    assert merged["success_rate"] == w["success_rate"]
