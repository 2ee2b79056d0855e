"""The port's drivers (``mpc_arpo_project_tpu_torch/examples``) against the
JAX package's: the canonical configurations of ``examples/common.py``, the
in-track discrete closed loop that the mixed sweep runs half of its
engines on, the mixed sweep's per-engine statistics, and the compute
functions of the study drivers at tiny sizes (fp64 on the CPU; JAX's
Pallas 'eig' kernel runs as its own tests run it). Both packages get the
same noise arrays."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from examples import common as jcommon
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch.examples import common as tcommon
from mpc_arpo_project_tpu_torch.examples import (
    disturb_rej_comp, mixed_sweep_10k as ms, pod_sweep, success_curve,
    success_rates)
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def _assert_same(a, b, path):
    """Field for field, exactly: dataclasses recursively, arrays by value
    and dtype, everything else by ==."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            _assert_same(getattr(a, f.name), getattr(b, f.name),
                         f"{path}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, path


@pytest.mark.parametrize("which", ["radial", "radialC", "radial_noiseless",
                                   "in_track"])
def test_configs_equal_the_originals(which):
    make = {
        "radial": lambda m: m.radial_config(),
        "radialC": lambda m: m.radial_config(noisy=True, T_final=70.0,
                                             T_cont=1e-3),
        "radial_noiseless": lambda m: m.radial_config(
            noisy=False, Nx=50, is_reject=False, is_delta_v=True),
        "in_track": lambda m: m.in_track_config(T_final=30.0),
    }[which]
    for a, b, name in zip(make(tcommon), make(jcommon),
                          ("sim", "mpc", "fail", "debris")):
        _assert_same(a, b, name)
    assert make(tcommon)[0].nsim == make(jcommon)[0].nsim


# ---------------------------------------------------------------------------
# the in-track closed loop
# ---------------------------------------------------------------------------

# (solve mode, noisy offset-free as the mixed sweep runs it | noiseless plain
# MPC as traj_eval_in_track runs it): (T_final, B)
IN_TRACK = {
    ("chol", "noisy"): (8.0, 3),
    ("chol", "quiet"): (15.0, 2),
    ("eig", "noisy"): (8.0, 3),
    ("eig", "quiet"): (10.0, 2),
}


def _in_track_arm(mode, case):
    T_final, B = IN_TRACK[mode, case]
    sim, mpc, fail, debris = tcommon.in_track_config(T_final=T_final)
    x0b = is_rej = None
    if case == "noisy":
        # the mixed sweep's in-track engine, its settings and inputs
        cell = next(c for c in ms.grid((1.0,), T_final=T_final)
                    if c.orient == "in-track")
        sim, mpc, fail, debris = cell.sim, cell.mpc, cell.fail, cell.debris
        x0b, hold, is_rej = ms.scenario_inputs(
            np.random.RandomState(3), "in-track", sim.x0, B)
    kw = dict(max_iter=500, solve_mode=mode, stall_exit_chunks=12,
              stall_tighten_chunks=24)
    jeng = jdisc.build_engine(sim, mpc, fail, debris,
                              settings=jadmm.ADMMSettings(**kw),
                              dtype=jnp.float64)
    teng = tdisc.build_engine(sim, mpc, fail, debris,
                              settings=tadmm.ADMMSettings(**kw),
                              dtype=torch.float64, device="cpu")
    if case == "noisy":
        noise = np.asarray(jdisc.make_noise_sequence_multi(
            jeng, jax.random.key(5), hold))
        assert np.abs(noise).max() > 0
    else:
        noise = np.zeros((teng.nsim, B, 4))
    jkw = ({} if x0b is None else
           dict(x0b=jnp.asarray(x0b), is_reject_b=jnp.asarray(is_rej)))
    jout = jax.tree.map(np.asarray, jax.jit(jdisc.rollout)(
        jeng, jnp.asarray(noise), **jkw))
    tkw = ({} if x0b is None else
           dict(x0b=torch.as_tensor(x0b), is_reject_b=torch.as_tensor(is_rej)))
    tout = tdisc.rollout(teng, torch.as_tensor(noise), **tkw)
    return jout, tout


@pytest.mark.parametrize("mode,case", list(IN_TRACK))
def test_in_track_closed_loop_matches_jax(mode, case):
    """Statuses, controller codes, termination, success and done_iters
    equal; the true trajectory within 1e-10 per row (of the row's largest
    entry, at least 1 m)."""
    j, t = _in_track_arm(mode, case)
    for name in ("status", "ctrl_seq", "i_term", "success", "done_iters"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(j, name), err_msg=name)
    scale = np.maximum(np.abs(j.x_true).max(-1), 1.0)
    row = np.abs(t.x_true.numpy() - j.x_true).max(-1) / scale
    assert (row <= 1e-10).all(), row.max()
    assert (j.ctrl_seq > 0).any()


# ---------------------------------------------------------------------------
# the mixed sweep's per-engine statistics
# ---------------------------------------------------------------------------

def _jax_stats(engine, out):
    """The JAX driver's ``stats`` (``examples/mixed_sweep_10k.py:109-132``)
    on a JAX rollout, in numpy."""
    out = jax.tree.map(np.asarray, out)
    T1 = out.x_true.shape[0]
    idx = np.clip(out.i_term - 1, 0, T1 - 1)
    xf = np.take_along_axis(out.x_true, idx[None, :, None], axis=0)[0]
    fd = np.linalg.norm(xf - np.asarray(engine.xr)[None, :], axis=1)
    div = ~np.isfinite(fd)
    st = out.status
    return dict(n_success=out.success.sum(), n_diverged=div.sum(),
                sum_final_dist=np.where(div, 0.0, fd).sum(),
                sum_i_term=out.i_term.sum(), alive_steps=(out.ctrl_seq > 0).sum(),
                n_solved=(st == 1).sum(), n_maxiter=(st == 2).sum(),
                n_pinf=(st == 3).sum(), total_iters=out.iters.sum())


def test_engine_stats_match_jax():
    """A 2 orientations x 2 R_input scales grid, B=4, 5 s, 'chol': the
    port's engine_stats against the JAX driver's statistics of the JAX
    rollout on the same noise, x0b and reject arrays: counts equal, sums
    within 1e-9 relative."""
    B = 4
    cells = ms.grid((0.5, 2.0), T_final=5.0)
    assert [(c.orient, c.w) for c in cells] == [
        ("radial", 0.5), ("in-track", 0.5), ("radial", 2.0), ("in-track", 2.0)]
    rng = np.random.RandomState(ms.SEED)
    kw = dict(max_iter=500, stall_exit_chunks=12, stall_tighten_chunks=24)
    for gi, c in enumerate(cells):
        teng = tdisc.build_engine(c.sim, c.mpc, c.fail, c.debris,
                                  settings=tadmm.ADMMSettings(**kw),
                                  dtype=torch.float64, device="cpu")
        x0b, hold, is_rej = ms.scenario_inputs(rng, c.orient, c.sim.x0, B)
        noise = ms.engine_noise(teng, gi, hold)
        got, _ = ms.engine_stats(teng, noise, x0b, is_rej)
        jeng = jdisc.build_engine(c.sim, c.mpc, c.fail, c.debris,
                                  settings=jadmm.ADMMSettings(**kw),
                                  dtype=jnp.float64)
        ref = _jax_stats(jeng, jax.jit(jdisc.rollout)(
            jeng, jnp.asarray(noise.numpy()), x0b=jnp.asarray(x0b),
            is_reject_b=jnp.asarray(is_rej)))
        assert set(got) == set(ref)
        for k, v in ref.items():
            if k == "sum_final_dist":
                np.testing.assert_allclose(got[k], v, rtol=1e-9, err_msg=k)
            else:
                assert got[k] == int(v), (gi, k, got[k], v)
        assert got["alive_steps"] > 0


def test_scenario_inputs_follow_the_jax_driver():
    """The per-scenario draws come from the RandomState in the JAX driver's
    order (`examples/mixed_sweep_10k.py:160-171`)."""
    rng = np.random.RandomState(1)
    x0b, hold, is_rej = ms.scenario_inputs(rng, "in-track", [-10.0, 100, 0, 0], 6)
    r = np.random.RandomState(1)
    jx, jy = r.uniform(-10, 10, size=6), r.uniform(-5, 5, size=6)
    np.testing.assert_array_equal(x0b[:, 0], -10.0 + jy)
    np.testing.assert_array_equal(x0b[:, 1], 100.0 + jx)
    np.testing.assert_array_equal(hold, r.choice([10, 25, 50, 100], size=6))
    np.testing.assert_array_equal(is_rej, [1, 0, 1, 0, 1, 0])


# ---------------------------------------------------------------------------
# the study drivers' compute functions, tiny
# ---------------------------------------------------------------------------

def test_success_rates_compute(tmp_path):
    ck = str(tmp_path / "ck.json")
    res = success_rates.compute(runs=4, chunk=2, sigma=0.3, checkpoint=ck,
                                T_final=5.0, cpu=True)
    assert res["n"] == 4 and np.isfinite(res["mean_final_dist"])
    assert sum(res["ctrl_usage"].values()) > 0
    # a second call resumes from the finished checkpoint: the same result
    assert success_rates.compute(runs=4, chunk=2, sigma=0.3, checkpoint=ck,
                                 T_final=5.0, cpu=True) == res


@pytest.mark.parametrize("per_setting", [False, True])
def test_disturb_rej_comp_compute(per_setting):
    nls, ratios = disturb_rej_comp.compute(
        runs=2, quick=True, max_iter=300, per_setting=per_setting, cpu=True,
        T_final=5.0)
    np.testing.assert_array_equal(nls, disturb_rej_comp.QUICK_NOISE_LENGTHS)
    assert ratios.shape == (3,) and np.isfinite(ratios).all()
    assert (ratios > 0).all()


def test_pod_sweep_compute(tmp_path):
    res, engine = pod_sweep.compute(scenarios=4, chunk=2,
                                    checkpoint=str(tmp_path / "ck.json"),
                                    device="cpu", T_final=5.0)
    assert res["n"] == 4 and engine.dtype == torch.float64
    assert np.isfinite(res["mean_final_dist"]) and res["total_admm_iters"] > 0


@pytest.mark.parametrize("oracle", [False, True])
def test_success_curve_compute(oracle):
    rows = success_curve.compute(sigmas=(0.0, 0.03), runs=2, oracle=oracle,
                                 device="cpu", T_final=5.0)
    assert [r["runs"] for r in rows] == [2, 2]
    for r in rows:
        assert 0 <= r["n_success"] <= 2 and np.isfinite(r["mean_i_term"])
        assert abs(sum(r["mix"].values()) - 1.0) < 1e-3


def test_drivers_need_a_card_without_cpu():
    """Without --cpu a driver runs on the card; with none it raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        success_rates.compute(runs=2, chunk=2, T_final=1.0)
