"""Problem data of the PyTorch port against the JAX package: every
``ADMMProblem`` field of ``prepare_problem(solve_mode='eig', pad=True)`` in
fp64, the numpy bridge ``problem_from_numpy``, and ``init_state``."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mpc_arpo_project_tpu.ops import admm as jadmm
from mpc_arpo_project_tpu_torch.ops import admm as tadmm
from tests.torch_helpers import one_torch_thread  # noqa: F401 (autouse)
from tests.torch_helpers import static_problem

RTOL = ATOL = 1e-12  # same float64 host arithmetic on both sides


@pytest.fixture(scope="module")
def problems():
    out = {}
    for Nx in (40, 50):
        static, dims, _ = static_problem(Nx)
        kw = dict(nominal_coeffs=(1.0, -1.0, 0.25), pad=True)
        jp = jadmm.prepare_problem(
            static, dims, jadmm.ADMMSettings(solve_mode="eig"),
            dtype=jnp.float64, **kw)
        tp = tadmm.prepare_problem(
            static, dims, tadmm.ADMMSettings(solve_mode="eig"),
            dtype=torch.float64, device="cpu", **kw)
        out[Nx] = (jp, tp)
    return out


def _assert_fields_equal(jp, tp):
    for name in jadmm.ADMMProblem._fields:
        jv, tv = getattr(jp, name), getattr(tp, name)
        assert (jv is None) == (tv is None), name
        if jv is None:
            continue
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("Nx", [40, 50])
def test_prepare_problem_matches_jax(problems, Nx):
    jp, tp = problems[Nx]
    assert tuple(tp.Pbar.shape) == (256, 256)
    assert tuple(tp.A0bar.shape) == (512, 256)
    assert tuple(tp.eig_YT.shape) == (4, 128, 256)
    _assert_fields_equal(jp, tp)


@pytest.mark.parametrize("Nx", [40, 50])
def test_problem_from_numpy_matches_own_build(problems, Nx):
    jp, tp = problems[Nx]
    bridged = tadmm.problem_from_numpy(jp, dtype=torch.float64,
                                      device="cpu")
    for name in tadmm.ADMMProblem._fields:
        a, b = getattr(bridged, name), getattr(tp, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    f32 = tadmm.problem_from_numpy(jp, dtype=torch.float32, device="cpu")
    assert f32.Pbar.dtype == torch.float32 and f32.fun_rows.dtype == torch.int64


def test_init_state_matches_jax(problems):
    jp, tp = problems[50]
    st = tadmm.ADMMSettings(solve_mode="eig")
    js = jadmm.init_state(jp, 6, jadmm.ADMMSettings(solve_mode="eig"))
    ts = tadmm.init_state(tp, 6, st)
    for name in jadmm.ADMMState._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    bridged = tadmm.state_from_numpy(js, dtype=torch.float64, device="cpu")
    for name in tadmm.ADMMState._fields:
        assert torch.equal(getattr(bridged, name), getattr(ts, name)), name


def test_settings_mirror_jax():
    assert tadmm.ADMMSettings._fields == jadmm.ADMMSettings._fields
    assert tadmm.ADMMSettings() == tuple(jadmm.ADMMSettings())


@pytest.mark.parametrize("Nx", [40, 50])
def test_port_copies_match_the_originals(Nx):
    """The port's own copies of the JAX package's JAX-free host code give
    the originals' arrays exactly."""
    from mpc_arpo_project_tpu.config import Debris as JDebris
    from mpc_arpo_project_tpu.ops import qp_builder as jqp
    from mpc_arpo_project_tpu_torch.ops import host_synthesis as ths
    from mpc_arpo_project_tpu_torch.ops import qp_builder as tqp
    from tests.torch_helpers import flagship_parts, sim_conditions
    from tools import ref_sim

    mpc, fail, debris = flagship_parts(Nx)
    for in_track in (False, True):
        sim = sim_conditions(in_track)
        Ad, Bd = ths.discretize_np(sim.mean_mtn, sim.time_stp, False)
        jAd, jBd = ref_sim.discretize_np(sim.mean_mtn, sim.time_stp, False)
        np.testing.assert_array_equal(Ad, jAd)
        np.testing.assert_array_equal(Bd, jBd)
        np.testing.assert_array_equal(
            ths.discretize_np(sim.mean_mtn, sim.time_stp, True)[1],
            ref_sim.discretize_np(sim.mean_mtn, sim.time_stp, True)[1])
        gains = ths.synth_gains_np(Ad, Bd, mpc, fail)
        for a, b in zip(gains, ref_sim.synth_gains_np(Ad, Bd, mpc, fail)):
            np.testing.assert_array_equal(a, b)
        dims = tqp.QPDims(Nx=Nx, Nc=5, Nb=5)
        st = tqp.build_qp(dims, sim, mpc, Ad, Bd, gains[0], gains[1])
        jst = jqp.build_qp(jqp.QPDims(Nx=Nx, Nc=5, Nb=5), sim, mpc, Ad, Bd,
                           gains[0], gains[1])
        for name in jqp.QPStatic._fields:
            np.testing.assert_array_equal(getattr(st, name),
                                          getattr(jst, name), err_msg=name)
        np.testing.assert_array_equal(tqp.materialize_A(st, -1.0, 1.0, 0.7),
                                      jqp.materialize_A(jst, -1.0, 1.0, 0.7))
        np.testing.assert_array_equal(tqp.static_C(sim, 0.3),
                                      jqp.static_C(sim, 0.3))
        for xe in ([100.0, 10.0, -0.2, 0.1], [42.0, 1.0, 0.3, -0.1],
                   [50.0, -4.0, 0.1, 0.1], [20.0, -1.0, -0.1, -0.2]):
            for deb in (debris, JDebris((40.0, 0.0), 5.0, 20.0), None):
                a = ths.configure_dynamic_np(sim, deb, np.array(xe + [0, 0.]))
                b = ref_sim.configure_dynamic_np(sim, deb,
                                                 np.array(xe + [0, 0.]))
                for u, v in zip(a, b):
                    np.testing.assert_array_equal(u, v)


def test_entry_points_default_to_cuda(monkeypatch):
    """Without ``device=``, the entry points put the engine on the CUDA
    device; where there is none they raise instead of running on the CPU."""
    from mpc_arpo_project_tpu_torch.rollout import discrete as tdisc
    from tests.torch_helpers import flagship_parts, sim_conditions

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mpc, fail, debris = flagship_parts(40)
    static, dims, sim = static_problem(40)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdisc.build_engine(sim_conditions(), mpc, fail, debris,
                           settings=tadmm.ADMMSettings(solve_mode="pallas"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadmm.prepare_problem(static, dims)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadmm.problem_from_numpy({"Pbar": np.eye(2)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tadmm.state_from_numpy({})
    eng = tdisc.build_engine(sim_conditions(T_final=1.0), mpc, fail, debris,
                             dtype=torch.float64, device="cpu")
    assert eng.device.type == "cpu" and eng.prob.Pbar.device.type == "cpu"
