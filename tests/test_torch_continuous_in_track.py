"""The in-track continuous arm: the port's counterpart of
``tests/test_continuous.py::test_continuous_in_track_matches_oracle``.

The in-track variant (swap_xy weights, debris at (0, 40), the hatch turned
90 degrees, termination along the in-track axis) of the continuous loop on
the nonlinear plant, noiseless, fp64 'chol', T_final 15 s, through the
port's engine, the JAX package's engine and the port's NumPy oracle
``tools/ref_sim.simulate_continuous`` (with the engine's scaling): the
termination substep and the controller sequence equal, the tick states and
the controls within 1e-6, as the JAX test holds its engine to its oracle.
"""

import numpy as np
import jax
import jax.numpy as jnp
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.rollout import continuous as jc
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.rollout import continuous as tc
from mpc_arpo_project_tpu_torch.tools.ref_sim import simulate_continuous
from tests.test_continuous import _in_track_configs
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)


def test_in_track_continuous_matches_jax_and_oracle():
    cfg = _in_track_configs(T_final=15.0)
    teng = tc.build_engine(*cfg, settings=tadmm.ADMMSettings(max_iter=1000),
                           dtype=torch.float64, device="cpu")
    jeng = jc.build_engine(*cfg, settings=jadmm.ADMMSettings(max_iter=1000),
                           dtype=jnp.float64)
    rng = np.random.RandomState(5)
    draws = rng.normal(size=(teng.n_ticks * teng.n_sub // teng.noise_int_sub
                             + 2, 2))
    scaled = float(teng.sig_cont) * draws[:, None, :]

    tout = tc.rollout(teng, torch.as_tensor(scaled))
    jout = jax.jit(jc.rollout, static_argnames=("substep_telemetry",))(
        jeng, jeng.sig_cont * jnp.asarray(draws)[:, None, :])
    jout = jax.tree.map(lambda v: None if v is None else np.asarray(v), jout)
    prob = teng.base.prob
    runo = simulate_continuous(
        *cfg, noise_draws=draws,
        solver_kwargs=dict(scaling_override=(prob.D.numpy(), prob.E.numpy(),
                                             float(prob.c)), max_iter=1000))

    i_term = int(tout.i_term_sub[0])
    assert i_term == int(jout.i_term_sub[0]) == runo["i_term_sub"]
    ctrl = tout.ctrl_seq[:, 0].numpy()
    np.testing.assert_array_equal(ctrl, jout.ctrl_seq[:, 0])
    np.testing.assert_array_equal(ctrl, runo["ctrl_seq"][1:])
    assert bool(tout.success[0]) == bool(jout.success[0]) == runo["success"]
    x, u = tout.x_true_ticks[:, 0].numpy(), tout.ctrls[:, 0].numpy()
    for ref_x, ref_u in ((jout.x_true_ticks[:, 0], jout.ctrls[:, 0]),
                         (runo["x_ticks"], runo["ctrls"])):
        np.testing.assert_allclose(x, ref_x, rtol=0, atol=1e-6)
        np.testing.assert_allclose(u, ref_u, rtol=0, atol=1e-6)
