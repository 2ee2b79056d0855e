"""The port's continuous-time closed loop against the JAX package: the
nonlinear plant on drawn states, the noise scaling, and closed-loop arms of
the radialC scenario (Nx=40) through both packages on the same numpy noise
draws and initial states (fp64, CPU; JAX's Pallas 'eig' kernel runs as its
own tests run it). Four initial states per arm: the scenario's own start
(100, 10), one that docks within the run, one that stays in the approach
and one that terminates on its first tick, so termination and success are
both exercised. Also ``rollout_chunked`` against ``rollout``, a run with a
single tick, and an fp32 smoke run of the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.config import Noise
from mpc_arpo_project_tpu.models import nonlinear as jnl
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import continuous as jc
from mpc_arpo_project_tpu_torch.config import SimConditions
from mpc_arpo_project_tpu_torch.models import nonlinear as tnl
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import rk4_tick as trk
from mpc_arpo_project_tpu_torch.rollout import continuous as tc
from tests.torch_helpers import flagship_parts, radial_c_plant
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)

X0B = np.array([[100.0, 10.0, 0.0, 0.0], [3.1, 0.05, -0.4, 0.0],
                [6.0, 0.5, -0.5, 0.02], [0.8, 3.0, 0.1, -0.3]])
OUTCOMES = ("ctrl_seq", "status", "done_iters", "i_term_sub", "success")


def radial_c(noisy=True, delta_v=False, T_final=10.0, noise_length=50):
    """The radialC scenario (``examples/common.py`` with ``T_cont=1e-3``):
    noise sigma 0.0012 held ``noise_length`` ticks."""
    mpc, fail, debris = flagship_parts(Nx=40)
    noise = Noise((0.0012, 0.0012), noise_length) if noisy else None
    sim = SimConditions(
        np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0]),
        2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5, True, (0.2, 45.0), noise,
        False, T_cont=1e-3, T_final=T_final, isDeltaV=delta_v)
    return sim, mpc, fail, debris


ARMS = {
    # name: (noisy, delta_v, estimator, T_final, settings keywords)
    "noisy_ukf": (True, False, "ukf", 10.0, dict(max_iter=1000)),
    "quiet_delta_v": (False, True, "ukf", 10.0, dict(max_iter=1000)),
    "noisy_kf": (True, False, "kf", 10.0, dict(max_iter=1000)),
    "eig": (True, False, "ukf", 3.0,
            dict(max_iter=500, solve_mode="eig", pallas_tile=4)),
    "telemetry": (True, False, "ukf", 3.0, dict(max_iter=1000)),
}


def _run_arm(name):
    noisy, delta_v, est, T_final, st = ARMS[name]
    telemetry = name == "telemetry"
    sim, mpc, fail, debris = radial_c(noisy, delta_v, T_final)
    jeng = jc.build_engine(sim, mpc, fail, debris,
                           settings=jadmm.ADMMSettings(**st),
                           dtype=jnp.float64, estimator=est)
    B = X0B.shape[0]
    n_draws = jeng.n_ticks * jeng.n_sub // jeng.noise_int_sub + 2
    draws = np.random.RandomState(3).normal(size=(n_draws, B, 2))
    scaled = np.array(jeng.sig_cont * jnp.asarray(draws))
    jout = jax.jit(jc.rollout, static_argnames=("substep_telemetry",))(
        jeng, jnp.asarray(scaled), jnp.asarray(X0B),
        substep_telemetry=telemetry)
    jout = jax.tree.map(lambda v: None if v is None else np.asarray(v), jout)
    teng = tc.build_engine(sim, mpc, fail, debris,
                           settings=tadmm.ADMMSettings(**st),
                           dtype=torch.float64, estimator=est, device="cpu")
    tout = tc.rollout(teng, scaled, torch.as_tensor(X0B),
                      substep_telemetry=telemetry)
    return dict(jax=jout, torch=tout, engine=teng, draws=scaled)


@pytest.fixture(scope="module")
def arms():
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = _run_arm(name)
        return cache[name]
    return get


def test_plant_matches_jax():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(-100, 120, (64, 2)),
                        rng.uniform(-1, 1, (64, 2))], 1)
    u = rng.uniform(-0.2, 0.2, (64, 2))
    n, dt = 1.107e-3, 1e-3
    t64 = lambda v: torch.tensor(v, dtype=torch.float64)
    jd = jnl.two_body_deriv(jnp.asarray(x), jnp.asarray(u), jnp.asarray(n))
    td = tnl.two_body_deriv(t64(x), t64(u), t64(n))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-13, atol=0)
    jr = jnl.rk4_step(jnp.asarray(x), jnp.asarray(u), jnp.asarray(n),
                      jnp.asarray(dt))
    tr = tnl.rk4_step(t64(x), t64(u), t64(n), t64(dt))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-13, atol=0)
    assert tnl.R_T == jnl.R_T


@pytest.mark.parametrize("convention", ["brownian", "white_noise_per_dt"])
def test_noise_scaling_matches_jax(convention):
    sim, mpc, fail, debris = radial_c(True, False, 2.0, noise_length=10)
    jeng = jc.build_engine(sim, mpc, fail, debris, dtype=jnp.float64,
                           noise_convention=convention)
    teng = tc.build_engine(sim, mpc, fail, debris, dtype=torch.float64,
                           noise_convention=convention, device="cpu")
    assert float(teng.sig_cont) == float(jeng.sig_cont)
    assert (teng.n_sub, teng.noise_int_sub, teng.n_ticks) == (
        jeng.n_sub, jeng.noise_int_sub, jeng.n_ticks)
    np.testing.assert_array_equal(teng.base.Qw.numpy(), np.asarray(jeng.base.Qw))
    B = 3
    d = tc.make_noise_draws(teng, torch.Generator().manual_seed(0), B)
    n_draws = teng.n_ticks * teng.n_sub // teng.noise_int_sub + 2
    assert d.shape == (n_draws, B, 2) and d.dtype == torch.float64
    ref = teng.sig_cont * torch.randn((n_draws, B, 2),
                                      generator=torch.Generator().manual_seed(0),
                                      dtype=torch.float64)
    torch.testing.assert_close(d, ref, rtol=0, atol=0)


@pytest.mark.parametrize("arm", ["noisy_ukf", "quiet_delta_v", "noisy_kf",
                                 "eig"])
def test_rollout_matches_jax(arms, arm):
    r = arms(arm)
    j, t = r["jax"], r["torch"]
    for name in OUTCOMES:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.iters.numpy(), j.iters)
    np.testing.assert_allclose(t.x_true_ticks.numpy(), j.x_true_ticks,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.ctrls.numpy(), j.ctrls, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.x_est.numpy(), j.x_est, rtol=0, atol=1e-5)
    assert t.x_sub is None
    # the arms reach the outcomes they were set up for: one scenario docks
    # (in the 10 s arms), one terminates on its first tick
    if arm != "eig":
        assert bool(t.success[1])
    assert int(t.i_term_sub[3]) == r["engine"].n_sub


def test_substep_telemetry_matches_jax(arms):
    r = arms("telemetry")
    j, t = r["jax"], r["torch"]
    for name in OUTCOMES:
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(j, name), err_msg=name)
    eng = r["engine"]
    assert t.x_sub.shape == (eng.n_ticks - 1, eng.n_sub, X0B.shape[0], 4)
    np.testing.assert_allclose(t.x_sub.numpy(), j.x_sub, rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.x_true_ticks.numpy(), j.x_true_ticks,
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.x_est.numpy(), j.x_est, rtol=0, atol=1e-5)
    # each tick's last substep is the tick's end state
    np.testing.assert_array_equal(t.x_sub[:, -1].numpy(),
                                  t.x_true_ticks[2:].numpy())


def test_rollout_chunked_matches_rollout(arms):
    """19 ticks in segments of 8: a remainder segment of 3, the same
    results as ``rollout`` and a progress call after each segment."""
    r = arms("noisy_ukf")
    calls = []
    out = tc.rollout_chunked(r["engine"], r["draws"], torch.as_tensor(X0B),
                             seg=8, progress=lambda d, n, c: calls.append((d, n)))
    assert calls == [(9, 20), (17, 20), (20, 20)]
    ref = r["torch"]
    for name in ref._fields:
        a, b = getattr(out, name), getattr(ref, name)
        assert (a is None and b is None) or torch.equal(a, b), name


def test_rollout_with_one_tick():
    """n_ticks == 1 runs no tick and returns the initial state, where the
    JAX package's ``rollout_chunked`` fails on an empty concatenation."""
    sim, mpc, fail, debris = radial_c(True, False, 0.5)
    eng = tc.build_engine(sim, mpc, fail, debris, dtype=torch.float64,
                          device="cpu")
    assert eng.n_ticks == 1
    B = 2
    draws = tc.make_noise_draws(eng, torch.Generator().manual_seed(1), B)
    for out in (tc.rollout(eng, draws),
                tc.rollout_chunked(eng, draws, seg=8, substep_telemetry=True)):
        assert out.x_true_ticks.shape == (2, B, 4)
        assert out.ctrl_seq.shape == (0, B) and out.iters.shape == (0,)
        assert torch.equal(out.x_true_ticks[1], eng.base.x0.expand(B, 4))
        assert (out.i_term_sub == eng.n_ticks * eng.n_sub).all()
        assert not out.success.any()
    assert out.x_sub.shape == (0, eng.n_sub, B, 4)


def test_rk4_tick_refuses_a_device_without_a_kernel():
    B = 2
    m = lambda *s, dtype=torch.float64: torch.zeros(s, dtype=dtype,
                                                    device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        trk.rk4_tick(m(B, 4), m(B, dtype=torch.bool), m(B, dtype=torch.int32),
                     m(B, dtype=torch.bool), m(B, 2), m(B, 2), m(3, B, 2), 1,
                     radial_c_plant())


def test_fp32_rollout_smoke():
    """fp32 port rollout of the noisy radialC scenario with the 'eig'
    solve: finite outputs of the expected shapes and types."""
    sim, mpc, fail, debris = radial_c(True, False, 3.0)
    st = tadmm.ADMMSettings(max_iter=1000, solve_mode="eig", pallas_tile=4,
                            stall_exit_chunks=12, stall_tighten_chunks=24)
    eng = tc.build_engine(sim, mpc, fail, debris, settings=st,
                          dtype=torch.float32, device="cpu")
    B = 4
    draws = tc.make_noise_draws(eng, torch.Generator().manual_seed(0), B)
    out = tc.rollout_chunked(eng, draws, torch.as_tensor(X0B,
                                                         dtype=torch.float32),
                             seg=2)
    n = eng.n_ticks
    assert out.x_true_ticks.shape == (n + 1, B, 4)
    assert out.status.shape == (n - 1, B)
    for name in ("x_true_ticks", "x_est", "ctrls"):
        v = getattr(out, name)
        assert v.dtype == torch.float32 and torch.isfinite(v).all(), name
    alive = out.ctrl_seq > 0
    assert alive.any()
    assert ((out.status[alive] >= 0) & (out.status[alive] <= 4)).all()
    assert (out.status[~alive] == -1).all()
    assert out.i_term_sub.dtype == torch.int32
    assert int(out.i_term_sub[3]) == eng.n_sub
