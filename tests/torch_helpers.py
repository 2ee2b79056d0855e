"""Shared pieces of the PyTorch port's tests. Imports no JAX and nothing of
the JAX package, so the tests that run on a machine with the card and
without JAX can use it too.

* ``one_torch_thread``: an autouse, module-scoped fixture. A test module
  imports it to run PyTorch on one intra-op thread. The suite runs in
  several worker processes at once, and PyTorch's CPU kernels default to
  one OpenMP thread per core. OpenMP threads spin while they wait, so a
  few workers running the port's many small batched ops starve one
  another: three files that take 106 s on one thread each took over 15
  minutes together with the default.
* The flagship-family problem (Nx=40 or 50, radial approach, debris box at
  (40, 0)) built from the port's own config and QP builder.
* ``capture_chunks``, ``chunk_inputs`` and ``pallas_inputs``: real inputs
  of the chunk kernels (``eig_chunk``, ``admm_chunk``) and of the
  Newton–Schulz refresh, taken from port solves on the CPU.
* ``radial_c_plant`` and ``tick_inputs``: the radialC plant's tick
  constants and one tick's inputs of ``rk4_tick``.
* ``SWEEP_SETTINGS`` and ``sweep_engine``: the small engines of the JAX
  package's sweep tests (``tests/test_parallel.py``), built by the port.
* ``in_track_rollout``: the mixed sweep's noisy offset-free in-track
  engine rolled out from seeded per-scenario inputs on a given device
  (the card-against-CPU check of the in-track loop).
"""

import types

import numpy as np
import pytest
import torch

from mpc_arpo_project_tpu_torch import bench
from mpc_arpo_project_tpu_torch.config import Noise, SimConditions
from mpc_arpo_project_tpu_torch.ops import admm, admm_eig
from mpc_arpo_project_tpu_torch.ops.host_synthesis import (
    discretize_np, synth_gains_np)
from mpc_arpo_project_tpu_torch.ops.qp_builder import QPDims, build_qp
from mpc_arpo_project_tpu_torch.ops.rk4_tick import TickPlant
from mpc_arpo_project_tpu_torch.rollout import discrete


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def flagship_parts(Nx=40):
    """MPC weights, failsafe gains and the debris box of the flagship (the
    bench's configuration at horizon ``Nx``)."""
    return bench.flagship_parts(Nx)


def sim_conditions(in_track=False, noise=None, T_final=150.0):
    if in_track:
        x0, xr = np.array([-10.0, 100.0, 0.0, 0.0]), np.array([0.0, 2.5, 0.0, 0.0])
    else:
        x0, xr = np.array([100.0, 10.0, 0.0, 0.0]), np.array([2.5, 0.0, 0.0, 0.0])
    return SimConditions(x0, xr, 2.5, 10 * np.pi / 180, 1.5, 1.107e-3, 0.5,
                         True, (0.2, 45.0), noise, in_track, T_final=T_final)


def static_problem(Nx):
    """(static QP data, dims, sim) of the noiseless radial scenario."""
    mpc, fail, _ = flagship_parts(Nx)
    sim = sim_conditions()
    Ad, Bd = discretize_np(sim.mean_mtn, sim.time_stp, False)
    K, QN, *_ = synth_gains_np(Ad, Bd, mpc, fail)
    dims = QPDims(Nx=Nx, Nc=5, Nb=5)
    return build_qp(dims, sim, mpc, Ad, Bd, K, QN), dims, sim


def capture_chunks(prob, coeffs, l, u, state, settings, active=None):
    """Every chunk-kernel call of one port solve (``eig_chunk`` in 'eig'
    mode, ``admm_chunk`` in 'pallas' mode): (args, kwargs) clones."""
    attr, name = (("admm_eig", "eig_chunk") if settings.solve_mode == "eig"
                  else ("admm_pallas", "admm_chunk"))
    mod = getattr(admm, attr)
    real = getattr(mod, name)
    calls = []

    def rec(*a, **k):
        # n_live only sizes the CUDA kernel's slot groups: the twins and
        # the JAX kernels take no such keyword
        calls.append((tuple(v.clone() if torch.is_tensor(v) else v for v in a),
                      {kk: v.clone() if torch.is_tensor(v) else v
                       for kk, v in k.items() if kk != "n_live"}))
        return real(*a, **k)

    # the solver's view of the kernel module records; the module itself
    # stays as it is (its entries count their launches on themselves)
    view = types.SimpleNamespace(**vars(mod))
    setattr(view, name, rec)
    setattr(admm, attr, view)
    try:
        admm.admm_solve(prob, coeffs, l, u, state, settings, active=active)
    finally:
        setattr(admm, attr, mod)
    return calls


def chunk_inputs(prob, dims, coeffs, l, u):
    """Two real chunk inputs on the B=8, tile-4 problem ``prob``:
    ``warm``, the first chunk of a solve warm-started from a converged one
    on shifted bounds, with two inactive problems; ``infeasible``, the
    first chunk of a solve in which the Farkas certificate fires."""
    B = l.shape[0]
    st = admm.ADMMSettings(solve_mode="eig", pallas_tile=4, max_iter=300)
    r1 = admm.admm_solve(prob, coeffs, l, u, admm.init_state(prob, B, st), st)
    l2, u2 = l.clone(), u.clone()
    l2[:, :4] -= 0.01
    u2[:, :4] -= 0.01
    active = torch.tensor([True, False, True, True, True, False, True, True])
    warm = capture_chunks(prob, coeffs, l2, u2, r1.state, st, active=active)[0]
    l3 = l.clone()
    for j in range(dims.Nb + 1):
        l3[:, dims.n_eq + j * 5 + 4] = 1e3
    st3 = admm.ADMMSettings(solve_mode="eig", pallas_tile=4)
    calls = capture_chunks(prob, coeffs, l3, u, admm.init_state(prob, B, st3),
                           st3)
    infeas = next(c for c in calls
                  if (admm_eig.eig_chunk_ref(*c[0], **c[1])[3][:, 4] > 0).any())
    return {"warm": warm, "infeasible": infeas}


def pallas_inputs(prob, l, u):
    """Real inputs of the 'pallas' kernels on the B=8 problem ``prob`` (fp64,
    CPU): ``chunk``, the second chunk of a solve with all four funnel-sign
    combos, debris slopes s != 0 and two inactive problems; ``stack``,
    ``w``, ``M``, ``X_warm`` and ``need`` for the Newton–Schulz refresh
    (weights over mixed combos and rho scales, the true M of each problem,
    and the exact inverse at a 3% rho drift as the warm start)."""
    B = l.shape[0]
    t = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    coeffs = (t([1.0, 1.0, -1.0, -1.0, 1.0, 1.0, -1.0, -1.0]),
              t([1.0, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0, -1.0]),
              t([0.0, 0.4, -0.3, 0.7, 1.9, -2.4, 0.7, -0.4]))
    active = torch.tensor([True, False, True, True, True, False, True, True])
    st = admm.ADMMSettings(solve_mode="pallas", max_iter=50)
    chunk = capture_chunks(prob, coeffs, l, u, admm.init_state(prob, B, st),
                           st, active=active)[1]
    rng = np.random.default_rng(4)
    c1 = rng.choice([-1.0, 1.0], B)
    c2 = rng.choice([-1.0, 1.0], B)
    s = rng.uniform(-2.0, 2.0, B)
    r = rng.uniform(0.5, 2.0, B)
    nz = prob.Pbar.shape[0]
    sigma = 1e-6
    stack = torch.cat([(prob.Pbar + sigma * torch.eye(nz, dtype=torch.float64))
                       [None], prob.G[None], prob.Fstack], 0)
    w = np.stack([np.ones(B), r, r * c1, r * c2, r * c1 * c2, r * s,
                  r * s * s, np.zeros(B)], 1)
    ns_coeffs = (t(c1), t(c2), t(s))
    M = admm._build_M(prob, ns_coeffs, t(r), sigma)
    X_warm = torch.linalg.inv(admm._build_M(prob, ns_coeffs, t(1.03 * r),
                                            sigma)).contiguous()
    need = torch.tensor([True, False, True, True, False, True, True, False])
    return dict(chunk=chunk, stack=stack, w=t(w), M=M, X_warm=X_warm,
                need=need, coeffs=ns_coeffs, r=r, sigma=sigma)


def radial_c_plant(dtype=torch.float64, **changes):
    """The tick constants of the radialC scenario (T = 0.5 s, T_cont = 1 ms:
    500 substeps; noise held 50 ticks), rounded to ``dtype`` as
    ``continuous.build_engine`` rounds them; ``changes`` replace fields."""
    r = lambda v: float(torch.tensor(float(v), dtype=dtype))
    plant = TickPlant(n_sub=500, noise_int_sub=25000, is_delta_v=False,
                      in_track=False, mean_mtn=r(1.107e-3), T_cont=r(1e-3),
                      rp=r(2.5), rtol=r(1.5), xr=(r(2.5), r(0.0)),
                      dist_tol=r(0.2), ang_tol=r(45.0))
    return plant._replace(**changes)


def tick_inputs(plant, B, seed, j=3):
    """One tick's ``rk4_tick`` inputs (float64 CPU tensors, in the
    function's argument order up to ``noise_draws``), and ``j``: states
    spread over the approach (ranges 3-100 m within 30 degrees of the
    x-axis, speeds ~0.3 m/s) with every eighth scenario placed to dock
    within the tick (a step short of the target, closing at 0.8 m/s: it
    succeeds, then terminates inside the platform radius), every eighth
    to cross the x < rp - rtol plane, a few at rest beside the target
    (atan(0/0) is NaN, which must fail the success test), every 16th
    dead on entry and every tenth already successful; controls within the
    0.2 m/s^2 disk; draws of the radialC sigma (0.0012 sqrt(1 ms))."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(3.0, 100.0, B)
    th = rng.uniform(-0.5, 0.5, B)
    x = np.stack([r * np.cos(th), r * np.sin(th),
                  rng.normal(0, 0.3, B), rng.normal(0, 0.3, B)], 1)
    idx = np.arange(B)
    dock, cross = idx % 8 == 1, idx % 8 == 2
    nd, nc = int(dock.sum()), int(cross.sum())
    x[dock] = np.stack([2.62 + 0.1 * rng.random(nd),
                        0.05 * rng.standard_normal(nd), np.full(nd, -0.8),
                        0.05 * rng.standard_normal(nd)], 1)
    x[cross] = np.stack([1.1 + 0.2 * rng.random(nc), 4.0 + rng.random(nc),
                         np.full(nc, -1.5), np.zeros(nc)], 1)
    x[idx % 37 == 5] = [2.55, 0.0, 0.0, 0.0]
    alive = idx % 16 != 3
    i_term = np.where(alive, 10 ** 6, j * plant.n_sub - 17).astype(np.int32)

    def disk(n):
        a = rng.uniform(0, 2 * np.pi, n)
        return 0.2 * np.sqrt(rng.random(n))[:, None] * np.stack(
            [np.cos(a), np.sin(a)], 1)

    n_draws = ((j + 1) * plant.n_sub - 1) // plant.noise_int_sub + 2
    draws = 0.0012 * np.sqrt(1e-3) * rng.standard_normal((n_draws, B, 2))
    t = torch.as_tensor
    return (t(x), t(alive), t(i_term), t(idx % 10 == 7), t(disk(B)),
            t(disk(B)), t(draws)), j


# the solver settings of the JAX package's sweep tests, by solve mode
# (``tests/test_parallel.py``, ``tests/test_distributed.py``)
SWEEP_SETTINGS = {
    "chol": dict(max_iter=500),
    "eig": dict(solve_mode="eig", max_iter=500, stall_exit_chunks=12,
                stall_tighten_chunks=24, pallas_tile=4),
}


def sweep_configs(T_final=10.0):
    """(sim, mpc, fail, debris) of the sweep tests' small engine (Nx=40,
    radial, noise sigma 0.2 held 10 steps, debris box at (40, 0))."""
    mpc, fail, debris = flagship_parts(Nx=40)
    sim = sim_conditions(noise=Noise((0.2, 0.2), 10), T_final=T_final)
    return sim, mpc, fail, debris


def sweep_engine(mode, T_final=10.0, device="cpu", dtype=torch.float64):
    """The port's build of the sweep tests' small engine in ``mode``."""
    return discrete.build_engine(
        *sweep_configs(T_final),
        settings=admm.ADMMSettings(**SWEEP_SETTINGS[mode]), dtype=dtype,
        device=device)


def in_track_rollout(device, seed, B=8, T_final=2.0):
    """The mixed sweep's noisy offset-free in-track engine (R_input scale
    1, its ``--quick`` solver settings in 'eig', fp64) on ``device``,
    rolled out for ``T_final`` s (4 control steps by default) from the
    per-scenario x0, hold lengths, offset-free switches and numpy draws of
    ``np.random.RandomState(seed)``: the same inputs on every device."""
    from mpc_arpo_project_tpu_torch.examples import mixed_sweep_10k as ms

    cell = next(c for c in ms.grid((1.0,), T_final=T_final)
                if c.orient == "in-track")
    eng = discrete.build_engine(cell.sim, cell.mpc, cell.fail, cell.debris,
                                settings=ms.settings(quick=True),
                                dtype=torch.float64, device=device)
    rng = np.random.RandomState(seed)
    x0b, hold, is_rej = ms.scenario_inputs(rng, "in-track", cell.sim.x0, B)
    draws = rng.standard_normal((eng.nsim // int(hold.min()) + 2, B, 4))
    noise = discrete.noise_sequence_multi_from_draws(eng, draws, hold)
    kw = dict(dtype=eng.dtype, device=eng.device)
    return discrete.rollout(eng, noise, x0b=torch.as_tensor(x0b, **kw),
                            is_reject_b=torch.as_tensor(is_rej, **kw))
