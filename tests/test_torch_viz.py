"""The port's reporting and animation (``mpc_arpo_project_tpu_torch/viz``)
against the JAX package's: the rollout-to-SimRun adaptor on the same
closed loop run by both packages (discrete and continuous, fp64 'chol' on
the CPU, the same draws), the report figures written from a port run
through the radial driver, the interactive HTML byte for byte, and the
GIF export."""

import dataclasses
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu import viz as jviz
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import continuous as jc
from mpc_arpo_project_tpu.rollout import discrete as jd
from mpc_arpo_project_tpu_torch import viz as tviz
from mpc_arpo_project_tpu_torch.config import SimRun
from mpc_arpo_project_tpu_torch.examples import common, traj_eval_radial
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.rollout import continuous as tc
from mpc_arpo_project_tpu_torch.rollout import discrete as td
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

B = 2


@pytest.fixture(scope="module")
def discrete_runs():
    """(sim, debris, JAX output, port output): the radial driver's
    configuration for 10 s, B=2, on the same numpy draws."""
    sim, mpc, fail, debris = common.radial_config(noisy=True, T_final=10.0)
    st = dict(max_iter=1000)
    jeng = jd.build_engine(sim, mpc, fail, debris,
                           settings=jadmm.ADMMSettings(**st), dtype=jnp.float64)
    teng = td.build_engine(sim, mpc, fail, debris,
                           settings=tadmm.ADMMSettings(**st),
                           dtype=torch.float64, device="cpu")
    draws = np.random.RandomState(2).normal(
        size=(teng.nsim // teng.noise_rep + 2, B, 4))
    jout = jax.jit(jd.rollout)(jeng, jd.noise_sequence_from_draws(jeng, draws))
    tout = td.rollout(teng, td.noise_sequence_from_draws(teng, draws))
    return sim, debris, jout, tout


@pytest.fixture(scope="module")
def continuous_runs():
    """JAX and port outputs of the radialC configuration for 3 s (5 ticks
    of 500 substeps), B=2, on the same pre-scaled draws."""
    sim, mpc, fail, debris = common.radial_config(noisy=True, T_final=3.0,
                                                  T_cont=1e-3)
    sim = dataclasses.replace(sim, noise=dataclasses.replace(sim.noise,
                                                             noise_length=2))
    st = dict(max_iter=1000)
    jeng = jc.build_engine(sim, mpc, fail, debris,
                           settings=jadmm.ADMMSettings(**st), dtype=jnp.float64)
    teng = tc.build_engine(sim, mpc, fail, debris,
                           settings=tadmm.ADMMSettings(**st),
                           dtype=torch.float64, device="cpu")
    n_draws = teng.n_ticks * teng.n_sub // teng.noise_int_sub + 2
    draws = float(teng.sig_cont) * np.random.RandomState(6).normal(
        size=(n_draws, B, 2))
    jout = jax.jit(jc.rollout)(jeng, jnp.asarray(draws))
    tout = tc.rollout(teng, torch.as_tensor(draws))
    return jout, tout


def _assert_runs_match(t, j):
    assert isinstance(t, SimRun)
    assert (t.i_term, t.isSuccess) == (j.i_term, j.isSuccess)
    np.testing.assert_array_equal(t.ctrlr_seq, j.ctrlr_seq)
    for name in ("x_true_pcw", "x_est", "ctrl_hist", "noise_hist"):
        a, b = getattr(t, name), getattr(j, name)
        if b is None:
            assert a is None, name
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, name
        np.testing.assert_allclose(a, b, rtol=1e-9, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("b", range(B))
def test_simrun_from_discrete_rollout_matches_jax(discrete_runs, b):
    _, _, jout, tout = discrete_runs
    _assert_runs_match(tviz.simrun_from_rollout(tout, b),
                       jviz.simrun_from_rollout(jout, b))


@pytest.mark.parametrize("b", range(B))
def test_simrun_from_continuous_rollout_matches_jax(continuous_runs, b):
    jout, tout = continuous_runs
    t = tviz.simrun_from_rollout(tout, b, continuous=True)
    _assert_runs_match(t, jviz.simrun_from_rollout(jout, b, continuous=True))
    assert t.x_true_pcw.shape[1] == tout.x_true_ticks.shape[0]


def test_report_figures_from_the_radial_driver(tmp_path, monkeypatch, capsys):
    """``traj_eval_radial``'s compute and report steps write the three
    report figures (each > 10 kB) under RunFigs/ from a port run."""
    monkeypatch.chdir(tmp_path)
    sim, debris, out = traj_eval_radial.compute(cpu=True, T_final=10.0)
    run = traj_eval_radial.report(sim, debris, out, save=7)
    assert "i_term=" in capsys.readouterr().out
    assert run.x_true_pcw.shape == (4, sim.nsim + 1)
    for stem in ("combCons7", "trueANDest7", "contrHist7"):
        p = tmp_path / "RunFigs" / f"{stem}.png"
        assert p.exists() and p.stat().st_size > 10_000, stem


def test_export_html_is_the_originals(discrete_runs, tmp_path):
    """The same SimRun gives byte-identical HTML from both packages."""
    sim, debris, _, tout = discrete_runs
    run = tviz.simrun_from_rollout(tout, 0)
    a = tviz.export_html(sim, run, debris, out_path=str(tmp_path / "t.html"))
    b = jviz.export_html(sim, run, debris, out_path=str(tmp_path / "j.html"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ta, tb = fa.read(), fb.read()
    assert ta == tb
    # the telemetry of every step after the first is embedded
    data = json.loads(ta.decode().split("const D=", 1)[1].split(";\n", 1)[0])
    assert len(data["x"]) == len(data["seq"]) == sim.nsim


def test_animation_export(discrete_runs, tmp_path):
    sim, debris, _, tout = discrete_runs
    run = tviz.simrun_from_rollout(tout, 1)
    out = tviz.animate_trajectory(sim, run, debris,
                                  out_path=str(tmp_path / "anim.gif"),
                                  stride=10, max_frames=6, fps=4)
    assert os.path.exists(out) and os.path.getsize(out) > 20_000
