"""The port's discrete closed loop in its default settings ('chol' solve)
and its remaining options (``estimator='kf'``, ``synthesis='torch'``),
with the synthesis and dynamics modules they rest on:

* the port version of ``tests/test_rollout.py::test_rollout_matches_oracle``
  against the fp64 oracle simulator ``tools/ref_sim.simulate_discrete``,
  both arms, with exact termination and controller sequence;
* the port's default-settings engine and rollout against the JAX
  package's on the same draws (``noise_sequence_from_draws``);
* ``estimator='kf'`` against the JAX package's 'kf' loop;
* ``ops/riccati.py`` (``synthesis='torch'``) against the JAX package's
  ``ops/riccati.py`` and the scipy goldens of ``tests/test_riccati.py``;
* ``models/cw.py`` against the JAX package's ``models/cw.py`` and the
  scipy goldens of ``tests/test_dynamics.py``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import scipy.linalg
import torch

from mpc_arpo_project_tpu.config import Noise
from mpc_arpo_project_tpu.models import cw as jcw
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.ops import kalman as jkalman
from mpc_arpo_project_tpu.ops import riccati as jric
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch.models import cw as tcw
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import kalman as tkalman
from mpc_arpo_project_tpu_torch.ops import riccati as tric
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tests.test_dynamics import _scipy_discretize
from tests.test_rollout import _configs
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from tools.ref_sim import simulate_discrete

N_MEAN = 1.107e-3
T_STEP = 0.5


@pytest.mark.parametrize("noisy", [False, True])
def test_rollout_matches_oracle(noisy):
    """The port of ``tests/test_rollout.py::test_rollout_matches_oracle``:
    the fp64 'chol' closed loop against the oracle simulator with the
    port's own equilibration pinned into it. Termination, the controller
    sequence and success exactly; trajectories to the JAX test's
    tolerances (1e-8 quiet; 5e-2 noisy, where MAX_ITER steps amplify
    last-bit differences through the closed loop)."""
    sim, mpc, fail, debris = _configs(noisy)
    engine = tdisc.build_engine(sim, mpc, fail, debris,
                                settings=tadmm.ADMMSettings(max_iter=1000),
                                dtype=torch.float64, device="cpu")
    rng = np.random.RandomState(42)
    draws = rng.normal(0.0, 1.0, size=(engine.nsim // engine.noise_rep + 2, 4))
    out = tdisc.rollout(engine,
                        tdisc.noise_sequence_from_draws(engine,
                                                        draws[:, None, :]))
    D, E = engine.prob.D.numpy(), engine.prob.E.numpy()
    runo = simulate_discrete(
        sim, mpc, fail, debris, noise_draws=draws,
        solver_kwargs=dict(scaling_override=(D, E, float(engine.prob.c)),
                           max_iter=1000))
    assert int(out.i_term[0]) == runo.i_term
    it = runo.i_term
    np.testing.assert_array_equal(out.ctrl_seq[:it, 0].numpy(),
                                  runo.ctrl_seq[:it].astype(np.int32))
    tol = 5e-2 if noisy else 1e-8
    for name in ("x_true", "ctrls", "x_est"):
        np.testing.assert_allclose(
            getattr(out, name)[: it + 1, 0, :].numpy().T,
            getattr(runo, name)[:, : it + 1], atol=tol, err_msg=name)
    assert bool(out.success[0]) == runo.success


def _both(sim, mpc, fail, debris, B, seed, **kw):
    """The same closed loop through both packages (fp64), on the same numpy
    draws; ``kw`` goes to both ``build_engine`` calls."""
    settings = kw.pop("settings", None)
    jkw = dict(kw, settings=settings or jadmm.ADMMSettings())
    tkw = dict(kw, settings=tadmm.ADMMSettings(
        **(settings or jadmm.ADMMSettings())._asdict()))
    jeng = jdisc.build_engine(sim, mpc, fail, debris, dtype=jnp.float64, **jkw)
    draws = np.random.RandomState(seed).normal(
        size=(jeng.nsim // jeng.noise_rep + 2, B, 4))
    jout = jax.tree.map(np.asarray, jax.jit(jdisc.rollout)(
        jeng, jdisc.noise_sequence_from_draws(jeng, draws)))
    teng = tdisc.build_engine(sim, mpc, fail, debris, dtype=torch.float64,
                              device="cpu", **tkw)
    tout = tdisc.rollout(teng, tdisc.noise_sequence_from_draws(teng, draws))
    return jeng, teng, jout, tout


def _assert_same_outcomes(j, t, x_tol):
    for name in ("status", "ctrl_seq", "i_term", "success", "done_iters"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      getattr(j, name), err_msg=name)
    np.testing.assert_array_equal(t.iters.numpy(), j.iters)
    for name in ("x_true", "x_est", "ctrls"):
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(j, name),
                                   atol=x_tol, err_msg=name)


def test_default_settings_closed_loop_matches_jax():
    """``build_engine`` with default settings ('chol', UKF, scipy
    synthesis), noisy debris scenario, B=3: every discrete outcome equal,
    trajectories to 1e-8."""
    sim, mpc, fail, debris = _configs(True, T_final=15.0)
    jeng, teng, j, t = _both(sim, mpc, fail, debris, 3, 7)
    assert teng.settings.solve_mode == "chol" == jeng.settings.solve_mode
    assert teng.prob.Pbar.shape == (201, 201)  # unpadded in 'chol' mode
    _assert_same_outcomes(j, t, 1e-8)


def test_kf_estimator_matches_jax():
    """``estimator='kf'``: the same steady-state gain, and the closed loop
    with the KF gives every discrete outcome of the JAX package's."""
    sim, mpc, fail, debris = _configs(True, T_final=15.0)
    jeng, teng, j, t = _both(sim, mpc, fail, debris, 3, 11, estimator="kf",
                             settings=jadmm.ADMMSettings(max_iter=1000))
    np.testing.assert_allclose(teng.L_kf.numpy(), np.asarray(jeng.L_kf),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(teng.Co.numpy(), np.asarray(jeng.Co))
    _assert_same_outcomes(j, t, 1e-8)
    assert not np.allclose(t.x_est[-1, :, 4:].numpy(), 0.0)


def test_kf_step_matches_jax():
    rng = np.random.default_rng(3)
    Ap, Bp, Cm = jcw.cw_continuous(N_MEAN)
    Ad, Bd = jcw.discretize(Ap, Bp, T_STEP)
    Ao, Bou, Co = (np.asarray(v) for v in jcw.observer_matrices(Ad, Bd, Cm))
    L, _ = jkalman.steady_state_gain_np(Ao, Co, 1e-3 * np.eye(6),
                                        1e-4 * np.eye(2))
    x, u, z = (rng.normal(size=(16, 6)), rng.normal(size=(16, 2)),
               rng.normal(size=(16, 2)))
    j = jax.vmap(lambda a, b, c: jkalman.kf_step(
        a, b, c, jnp.asarray(Ao), jnp.asarray(Bou), jnp.asarray(Co),
        jnp.asarray(L)))(jnp.asarray(x), jnp.asarray(u), jnp.asarray(z))
    T = torch.as_tensor
    t = tkalman.kf_step(T(x), T(u), T(z), T(Ao), T(Bou), T(Co), T(L))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13,
                               atol=1e-13)
    # the torch DARE gives the scipy gain
    Lt, _ = tkalman.steady_state_gain(T(Ao), T(Co), T(1e-3 * np.eye(6)),
                                      T(1e-4 * np.eye(2)))
    np.testing.assert_allclose(Lt.numpy(), L, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# synthesis='torch': ops/riccati.py
# ---------------------------------------------------------------------------

def _system():
    Ap, Bp, _ = tcw.cw_continuous(N_MEAN)
    return tcw.discretize(Ap, Bp, T_STEP)


Q_MPC = 8e2 * np.diag([0.2 ** 2, 10 ** 2, 3.8 ** 2, 900.0])
R_MPC = 1000 ** 2 * np.eye(2)
Q_FAIL = 0.005 * np.diag([0.0001, 1, 100000.0, 1.0, 0.01])
R_FAIL = 100 * np.eye(2)
C_INT = np.eye(1, 4)


def test_dare_and_dlqr_match_jax_and_scipy():
    Ad, Bd = _system()
    T = torch.as_tensor
    X = tric.solve_dare(Ad, Bd, T(Q_MPC), T(R_MPC))
    K, X2 = tric.dlqr(Ad, Bd, T(Q_MPC), T(R_MPC))
    a, b = Ad.numpy(), Bd.numpy()
    Xj = np.asarray(jric.solve_dare(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(Q_MPC), jnp.asarray(R_MPC)))
    Kj, _ = jric.dlqr(jnp.asarray(a), jnp.asarray(b), jnp.asarray(Q_MPC),
                      jnp.asarray(R_MPC))
    np.testing.assert_allclose(X.numpy(), Xj, rtol=1e-10)
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-10)
    X_ref = scipy.linalg.solve_discrete_are(a, b, Q_MPC, R_MPC)
    K_ref = np.linalg.solve(R_MPC + b.T @ X_ref @ b, b.T @ X_ref @ a)
    np.testing.assert_allclose(X.numpy(), X_ref, rtol=1e-9)
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-8)
    np.testing.assert_array_equal(X2.numpy(), X.numpy())
    assert np.all(np.linalg.eigvalsh(X.numpy()) > 0)
    assert np.all(np.abs(np.linalg.eigvals(a - b @ K.numpy())) < 1.0)


def test_dlqr_integral_matches_jax_and_scipy():
    Ad, Bd = _system()
    T = torch.as_tensor
    K, Kp, Ki = tric.dlqr_integral(Ad, Bd, T(Q_FAIL), T(R_FAIL), T(C_INT))
    a, b = Ad.numpy(), Bd.numpy()
    Kj, _, _ = jric.dlqr_integral(jnp.asarray(a), jnp.asarray(b),
                                  jnp.asarray(Q_FAIL), jnp.asarray(R_FAIL),
                                  jnp.asarray(C_INT))
    np.testing.assert_allclose(K.numpy(), np.asarray(Kj), rtol=1e-10)
    A_aug = np.block([[a, np.zeros((4, 1))], [C_INT, np.eye(1)]])
    B_aug = np.vstack([b, np.zeros((1, 2))])
    X_ref = scipy.linalg.solve_discrete_are(A_aug, B_aug, Q_FAIL, R_FAIL)
    K_ref = np.linalg.solve(R_FAIL + B_aug.T @ X_ref @ B_aug,
                            B_aug.T @ X_ref @ A_aug)
    np.testing.assert_allclose(K.numpy(), K_ref, rtol=1e-7)
    np.testing.assert_array_equal(Kp.numpy(), K.numpy()[:, :4])
    np.testing.assert_array_equal(Ki.numpy(), K.numpy()[:, 4:])


def test_deadbeat_gains_match_jax_and_place_zeros():
    Ad, Bd = _system()
    K_total, K_i = tric.deadbeat_debris_gains(Ad, Bd)
    a, b = Ad.numpy(), Bd.numpy()
    Ktj, Kij = jric.deadbeat_debris_gains(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(K_total.numpy(), np.asarray(Ktj), rtol=1e-10)
    np.testing.assert_allclose(K_i.numpy(), np.asarray(Kij), rtol=1e-10)
    A_aug = np.block([[a[np.ix_([1, 3], [1, 3])], np.zeros((2, 1))],
                      [np.array([[1.0, 0.0]]), np.eye(1)]])
    B_aug = np.vstack([b[[1, 3], 1].reshape(2, 1), np.zeros((1, 1))])
    Kt, Ki = K_total.numpy(), K_i.numpy()
    A_cl = A_aug - B_aug @ np.array([[Kt[1, 1], Kt[1, 3], Ki[1, 0]]])
    np.testing.assert_allclose(np.linalg.matrix_power(A_cl, 3), 0.0,
                               atol=1e-8)


def test_torch_synthesis_engine_matches_jax_and_scipy():
    """``build_engine(synthesis='torch')`` takes the JAX package's
    'jax'-synthesis gains (to 1e-10) and the scipy engine's (to the goldens'
    tolerance); the JAX name raises, naming the port's."""
    sim, mpc, fail, debris = _configs(False, T_final=5.0)
    st = tadmm.ADMMSettings(max_iter=200)
    teng = tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                              dtype=torch.float64, synthesis="torch",
                              device="cpu")
    jeng = jdisc.build_engine(sim, mpc, fail, debris,
                              settings=jadmm.ADMMSettings(max_iter=200),
                              dtype=jnp.float64, synthesis="jax")
    seng = tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                              dtype=torch.float64, device="cpu")
    for name in ("Kpf", "Kif", "K_total", "K_i"):
        np.testing.assert_allclose(getattr(teng, name).numpy(),
                                   np.asarray(getattr(jeng, name)),
                                   rtol=1e-10, atol=1e-14, err_msg=name)
        np.testing.assert_allclose(getattr(teng, name).numpy(),
                                   getattr(seng, name).numpy(), rtol=1e-7,
                                   atol=1e-12, err_msg=name)
    np.testing.assert_allclose(teng.prob.Pbar.numpy(),
                               np.asarray(jeng.prob.Pbar), rtol=1e-10,
                               atol=1e-14)
    with pytest.raises(ValueError, match="'torch'"):
        tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                           synthesis="jax", device="cpu")
    with pytest.raises(ValueError, match="estimator"):
        tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                           estimator="ekf", device="cpu")


# ---------------------------------------------------------------------------
# models/cw.py
# ---------------------------------------------------------------------------

def test_cw_matrices_match_jax():
    Ap, Bp, Cm = tcw.cw_continuous(N_MEAN)
    for t, j in zip((Ap, Bp, Cm), jcw.cw_continuous(N_MEAN)):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    n = N_MEAN
    assert Ap[2, 0] == 3 * n ** 2 and Ap[2, 3] == 2 * n and Ap[3, 2] == -2 * n


@pytest.mark.parametrize("delta_v", [False, True])
def test_discretization_matches_jax_and_scipy(delta_v):
    Ap, Bp, _ = tcw.cw_continuous(N_MEAN)
    Ad, Bd = tcw.discretize(Ap, Bp, T_STEP, is_delta_v=delta_v)
    Adj, Bdj = jcw.discretize(*jcw.cw_continuous(N_MEAN)[:2], T_STEP,
                              is_delta_v=delta_v)
    np.testing.assert_allclose(Ad.numpy(), np.asarray(Adj), rtol=1e-13,
                               atol=1e-16)
    np.testing.assert_allclose(Bd.numpy(), np.asarray(Bdj), rtol=1e-13,
                               atol=1e-16)
    Ad_ref, Bd_ref = _scipy_discretize(Ap.numpy(), Bp.numpy(), T_STEP)
    np.testing.assert_allclose(Ad.numpy(), Ad_ref, rtol=1e-12, atol=1e-15)
    if delta_v:
        Bd_ref = Ad.numpy() @ np.vstack([np.zeros((2, 2)), np.eye(2)])
        np.testing.assert_allclose(Bd.numpy(), Bd_ref, rtol=1e-12, atol=0)
    else:
        np.testing.assert_allclose(Bd.numpy(), Bd_ref, rtol=1e-9, atol=1e-13)


def test_observer_augmentation_matches_jax():
    Ap, Bp, Cm = tcw.cw_continuous(N_MEAN)
    Ad, Bd = tcw.discretize(Ap, Bp, T_STEP)
    Ao, Bou, Co = tcw.observer_matrices(Ad, Bd, Cm)
    Apj, Bpj, Cmj = jcw.cw_continuous(N_MEAN)
    jo = jcw.observer_matrices(*jcw.discretize(Apj, Bpj, T_STEP), Cmj)
    for t, j in zip((Ao, Bou, Co), jo):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-13,
                                   atol=1e-16)
    assert Ao[0, 4] == 1.0 and Ao[1, 5] == 1.0
    np.testing.assert_array_equal(Ao[4:, 4:].numpy(), np.eye(2))
    np.testing.assert_array_equal(Bou[4:].numpy(), 0.0)
    np.testing.assert_array_equal(Co[:, 4:].numpy(), 0.0)
