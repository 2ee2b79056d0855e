"""The port's ``utils``: run archives round-trip in the reference's pickle
layout (as ``tests/test_viz.py`` checks the JAX package's), the finite
guards name the field that holds a non-finite value, and the timers and
spans."""

import os
import pickle
from typing import NamedTuple

import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu_torch.config import Noise, SimRun
from mpc_arpo_project_tpu_torch.ops import admm
from mpc_arpo_project_tpu_torch.rollout import discrete
from mpc_arpo_project_tpu_torch.utils import (
    check_finite_tree, device_time, host_read, profile_trace, span)
from mpc_arpo_project_tpu_torch.utils.archive import load_run, save_run
from mpc_arpo_project_tpu_torch.utils.guards import finite_or
from tests.torch_helpers import flagship_parts, sim_conditions
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_run_archive_roundtrip(tmp_path):
    """A SimRun of a port rollout (one noisy scenario, 5 s) saved and
    loaded: the same conditions, run and debris, under the reference's
    keys."""
    mpc, fail, debris = flagship_parts()
    sim = sim_conditions(noise=Noise((0.4, 0.4), 20), T_final=5.0)
    engine = discrete.build_engine(
        sim, mpc, fail, debris, settings=admm.ADMMSettings(max_iter=500),
        dtype=torch.float64, device="cpu")
    out = discrete.rollout(engine, discrete.make_noise_sequence(
        engine, torch.Generator().manual_seed(0), 1))
    run = SimRun(
        i_term=int(out.i_term[0]), isSuccess=bool(out.success[0]),
        x_true_pcw=out.x_true[:, 0].numpy().T,
        x_est=out.x_est[:, 0].numpy().T, ctrl_hist=out.ctrls[:, 0].numpy().T,
        ctrlr_seq=out.ctrl_seq[:, 0].numpy(),
        noise_hist=out.noise[:, 0].numpy().T)
    p = save_run(str(tmp_path / "RunObjs" / "Run0.pkl"), sim, run, debris)
    sim2, run2, debris2 = load_run(p)
    assert sim2.T_final == sim.T_final
    assert run2.i_term == run.i_term
    np.testing.assert_allclose(run2.x_true_pcw, run.x_true_pcw)
    np.testing.assert_array_equal(run2.ctrlr_seq, run.ctrlr_seq)
    assert debris2.center == debris.center
    with open(p, "rb") as fh:
        assert set(pickle.load(fh)) == {"simcond", "simrun", "debris"}
    assert load_run(save_run(str(tmp_path / "Run1.pkl"), sim, run))[2] is None


class _Out(NamedTuple):
    x_true: torch.Tensor
    i_term: torch.Tensor
    extra: dict


def test_check_finite_tree_names_the_field():
    ok = _Out(torch.zeros(3, 2), torch.arange(3),
              {"a": np.ones(2), "b": [1.0, torch.ones(1)], "c": None})
    check_finite_tree(ok)
    bad = ok._replace(x_true=torch.tensor([[0.0, float("nan")]]))
    with pytest.raises(FloatingPointError, match=r"in out: \['\.x_true'\]"):
        check_finite_tree(bad, "out")
    bad = ok._replace(extra={"a": np.array([np.inf]),
                             "b": [1.0, torch.tensor([-np.inf])]})
    with pytest.raises(FloatingPointError) as e:
        check_finite_tree(bad)
    assert ".extra['a']" in str(e.value) and ".extra['b'][1]" in str(e.value)


def test_finite_or():
    x = torch.tensor([1.0, float("nan"), float("inf"), -2.0])
    np.testing.assert_array_equal(finite_or(x, 0.5).numpy(),
                                  [1.0, 0.5, 0.5, -2.0])


def test_timers(tmp_path):
    # no profiler: one shared context that does nothing, and a plain read
    assert span("solve") is span("loop.step")
    with span("solve"):
        assert host_read(torch.tensor([True, False]).any()) is True
        assert host_read(torch.arange(4).sum()) == 6

    calls = []
    dt = device_time(lambda v: calls.append(1) or v * 2, torch.ones(4),
                     reps=3, warmup=2)
    assert dt >= 0.0 and len(calls) == 5

    with profile_trace(str(tmp_path / "trace")) as prof:
        with span("solve"):
            torch.ones(64, 64) @ torch.ones(64, 64)
            for _ in range(2):
                host_read(torch.ones(3).sum())
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
    counts = {e.key: e.count for e in prof.key_averages()}
    assert any("mm" in k for k in counts)
    assert counts["solve"] == 1 and counts["solve.read"] == 2
