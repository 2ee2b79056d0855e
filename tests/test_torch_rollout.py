"""The port's discrete closed loop against the JAX package: the dynamic
constraints and the UKF step on drawn inputs, then the two closed-loop arms
of ``tests/test_admm_eig_robust.py`` with the JAX 'eig' rollout as the
reference (same numpy noise draws through ``noise_sequence_from_draws``),
and an fp32 smoke run of the port."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.config import Debris, Noise
from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu.ops import constraints as jcon
from mpc_arpo_project_tpu.ops import ukf as jukf
from mpc_arpo_project_tpu.ops.qp_builder import QPDims
from mpc_arpo_project_tpu.rollout import discrete as jdisc
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from mpc_arpo_project_tpu_torch.ops import constraints as tcon
from mpc_arpo_project_tpu_torch.ops import ukf as tukf
from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
from tools.ref_sim import discretize_np
from tests.torch_helpers import flagship_parts, sim_conditions
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("in_track", [False, True])
def test_constraints_match_jax(in_track):
    sim = sim_conditions(in_track)
    debris = Debris((0.0, 40.0) if in_track else (40.0, 0.0), 5.0, 20.0)
    rng = np.random.default_rng(11)
    n = 64
    xest = np.concatenate([rng.uniform(-80, 120, (n, 2)),
                           rng.uniform(-2, 2, (n, 2)),
                           rng.uniform(-0.5, 0.5, (n, 2))], axis=1)
    xest[:4, :2] = [[42.5, 3.0], [37.5, -3.0], [50.0, 0.0], [20.0, -1.0]]
    dims = QPDims(Nx=40, Nc=5, Nb=5)
    umin, umax = np.array([-0.2, -0.2, 0, 0, 0, 0, 0]), np.array([0.2, 0.2] + [np.inf] * 5)
    is_rej = rng.integers(0, 2, n).astype(np.float64)

    jg = jcon.make_geometry(sim, debris)
    jd = jax.vmap(lambda e: jcon.configure(jg, e))(jnp.asarray(xest))
    jl, ju = jax.vmap(lambda d, e, r: jcon.assemble_bounds(
        d, e, dims, jnp.asarray(umin), jnp.asarray(umax), r))(
            jd, jnp.asarray(xest), jnp.asarray(is_rej))

    tg = tcon.make_geometry(sim, debris)
    xt = torch.as_tensor(xest)
    td = tcon.configure(tg, xt)
    tl, tu = tcon.assemble_bounds(td, xt, dims, torch.as_tensor(umin),
                                  torch.as_tensor(umax), torch.as_tensor(is_rej))
    for name in ("c1", "c2", "s", "xmin", "xmax", "xest_stored"):
        np.testing.assert_array_equal(getattr(td, name).numpy(),
                                      np.asarray(getattr(jd, name)), err_msg=name)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))


def test_ukf_step_matches_jax():
    Ad, Bd = discretize_np(1.107e-3, 0.5, False)
    Ao = np.zeros((6, 6))
    Ao[:4, :4] = Ad
    Ao[4:, 4:] = np.eye(2)
    Ao[0, 4] = Ao[1, 5] = 1.0
    Bou = np.vstack([Bd, np.zeros((2, 2))])
    Qw = np.diag([1e-3] * 4 + [0.14, 0.14])
    rng = np.random.default_rng(5)
    B = 16
    x = np.concatenate([rng.uniform(20, 100, (B, 2)), rng.normal(0, 0.5, (B, 4))], 1)
    L = rng.normal(0, 0.3, (B, 6, 6))
    P = L @ L.transpose(0, 2, 1) + 1e-3 * np.eye(6)
    u = rng.uniform(-0.2, 0.2, (B, 2))
    z = np.stack([np.linalg.norm(x[:, :2], axis=1) + rng.normal(0, 0.5, B),
                  np.arctan2(x[:, 1], x[:, 0]) + rng.normal(0, 0.01, B)], 1)
    R = np.zeros((2, 2))

    jw = jukf.merwe_weights(6, 0.1, 2.0, -1.0)
    js = jax.vmap(lambda xx, pp, uu, zz: jukf.step(
        jukf.UKFState(x=xx, P=pp), uu, zz, jw, jnp.asarray(Ao),
        jnp.asarray(Bou), jnp.asarray(Qw), jnp.asarray(R)))(
            jnp.asarray(x), jnp.asarray(P), jnp.asarray(u), jnp.asarray(z))
    tw = tukf.merwe_weights(6, 0.1, 2.0, -1.0)
    T = torch.as_tensor
    ts = tukf.step(tukf.UKFState(x=T(x), P=T(P)), T(u), T(z), tw, T(Ao),
                   T(Bou), T(Qw), T(R))
    # x per row, relative to the row's max-abs: the positions are ~100, so
    # an element-wise 1e-12 fails on round-off of the order of an ulp of
    # the largest entry (measured on an AVX-512 CPU: 2.8e-12 absolute,
    # 2.8e-14 of the row's max-abs, on 2 of 96 entries); 10x that
    xj = np.asarray(js.x)
    row_err = np.abs(ts.x.numpy() - xj).max(1) / np.abs(xj).max(1)
    assert (row_err <= 3e-13).all(), row_err.max()
    np.testing.assert_allclose(ts.P.numpy(), np.asarray(js.P), rtol=1e-12,
                               atol=1e-12)
    # non-PD covariance: NaN sigma points, not an exception
    bad = tukf._chol_unrolled(T(-np.eye(6)[None]))
    assert torch.isnan(bad).any()


def _arm(noise, B, seed, T_final):
    """One closed-loop arm through both packages (fp64, 'eig', tile 4)."""
    mpc, fail, debris = flagship_parts()
    sim = sim_conditions(False, noise, T_final)
    jst = jadmm.ADMMSettings(max_iter=500, solve_mode="eig", pallas_tile=4)
    jeng = jdisc.build_engine(sim, mpc, fail, debris, settings=jst,
                              dtype=jnp.float64)
    draws = np.random.RandomState(seed).normal(
        size=(jeng.nsim // jeng.noise_rep + 2, B, 4))
    jout = jax.tree.map(np.asarray, jax.jit(jdisc.rollout)(
        jeng, jdisc.noise_sequence_from_draws(jeng, draws)))
    tst = tadmm.ADMMSettings(max_iter=500, solve_mode="eig", pallas_tile=4)
    teng = tdisc.build_engine(sim, mpc, fail, debris, settings=tst,
                              dtype=torch.float64, device="cpu")
    tout = tdisc.rollout(teng, tdisc.noise_sequence_from_draws(teng, draws))
    return jout, tout


def test_closed_loop_quiet_arm_matches_jax():
    """Noiseless, B=2: the iteration map itself — statuses, controller codes
    and termination equal, trajectories to round-off."""
    j, t = _arm(None, 2, 0, 15.0)
    np.testing.assert_array_equal(t.status.numpy(), j.status)
    np.testing.assert_array_equal(t.ctrl_seq.numpy(), j.ctrl_seq)
    np.testing.assert_array_equal(t.i_term.numpy(), j.i_term)
    np.testing.assert_allclose(t.x_true.numpy(), j.x_true, atol=1e-6)
    np.testing.assert_array_equal(t.done_iters.numpy(), j.done_iters)


def test_closed_loop_noisy_arm_matches_jax():
    """sigma=0.3, hold 10, B=8: termination and success per scenario equal,
    status mix within 2 points per status."""
    j, t = _arm(Noise((0.3, 0.3), 10), 8, 9, 15.0)
    np.testing.assert_array_equal(t.i_term.numpy(), j.i_term)
    np.testing.assert_array_equal(t.success.numpy(), j.success)
    ts = t.status.numpy()
    for code in (1, 2, 3, 4):
        fa = (j.status == code)[j.status >= 0].mean()
        fb = (ts == code)[ts >= 0].mean()
        assert abs(fa - fb) <= 0.02, (code, fa, fb)


def test_fp32_rollout_smoke():
    """fp32 port rollout of the noisy debris scenario (Nx=50, production
    solver profile, small batch): finite outputs of the expected shapes."""
    mpc, fail, debris = flagship_parts(Nx=50)
    sim = sim_conditions(False, Noise((0.75, 0.75), 50), 5.0)
    st = tadmm.ADMMSettings(max_iter=1000, solve_mode="eig", pallas_tile=8,
                            stall_exit_chunks=12, stall_tighten_chunks=24)
    eng = tdisc.build_engine(sim, mpc, fail, debris, settings=st,
                             dtype=torch.float32, device="cpu")
    B = 8
    gen = torch.Generator().manual_seed(0)
    ns = tdisc.make_noise_sequence(eng, gen, B)
    out = tdisc.rollout_chunked(eng, ns, seg=5)
    T = eng.nsim
    assert out.x_true.shape == (T + 1, B, 4) and out.status.shape == (T, B)
    for name in ("x_true", "x_est", "ctrls", "noise"):
        assert torch.isfinite(getattr(out, name)).all(), name
    alive = out.ctrl_seq > 0
    assert alive.any()
    assert ((out.status[alive] >= 0) & (out.status[alive] <= 4)).all()
    assert out.x_true.dtype == torch.float32
