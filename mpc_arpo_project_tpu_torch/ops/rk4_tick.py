"""One control tick of the continuous plant: the n_sub RK4 substeps between
two controller updates, batched over scenarios.

Counterpart of the inner substep scan of the JAX package's continuous loop
(``mpc_arpo_project_tpu/rollout/continuous.py``, ``_tick``: the scan over
``substep`` and the recomputed first substep after it). XLA fuses that scan
into a short device loop; in plain torch one substep is about 120 small
tensor operations, so a 500-substep tick is ~60,000 launches. Two pieces:

* ``rk4_tick_plain`` — the plain torch twin: the substep body looped over
  the tick, on any device.
* ``rk4_tick`` — the dispatching entry. A CPU tensor goes to the twin; a
  CUDA tensor goes to the hand-written kernel ``csrc/rk4_tick.cu`` (one
  thread per scenario, the state in registers for the whole tick, one
  launch per tick; built with nvcc at first use) or the call raises.

Each substep k of tick j (global substep gi = j n_sub + k), per scenario:
the termination check on the current state (range below ``rp``, or the
approach axis below ``rp - rtol``), the success check (within ``dist_tol``
of the target and a velocity heading within ``ang_tol`` degrees, for a
state still alive with gi >= 1), one RK4 step of the two-body plant with
the input held (the previous tick's control on substep 0, a one-substep
delay, then this tick's; the delta-v model integrates unforced and adds
the previous tick's impulse to the velocity after substep 0), the held
noise draw ``noise_draws[gi // noise_int_sub]`` added to the positions,
and the new state kept only where the scenario is alive.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.models import nonlinear
from mpc_arpo_project_tpu_torch.ops import _build


class TickPlant(NamedTuple):
    """What a tick's substeps need besides the batch: sizes, switches and
    the plant and check constants as Python floats already rounded to the
    engine's dtype (so the kernel's launch reads nothing from the device)."""

    n_sub: int  # substeps per tick
    noise_int_sub: int  # substeps per held noise draw
    is_delta_v: bool
    in_track: bool  # termination axis: y (in-track) or x (radial)
    mean_mtn: float
    T_cont: float
    rp: float
    rtol: float
    xr: tuple  # target position (x, y)
    dist_tol: float
    ang_tol: float


def rk4_tick_plain(x, alive, i_term_sub, succ, prev_u, ctrl, noise_draws,
                   j: int, plant: TickPlant, telemetry: bool = False):
    """The substep loop of one tick in plain torch. Shapes: x (B, 4);
    alive, succ (B,) bool; i_term_sub (B,) int32; prev_u, ctrl (B, 2);
    noise_draws (n_draws, B, 2), already scaled. Returns (x_end, alive,
    i_term_sub, succ, x_after_first, x_sub): x_after_first is the state one
    substep after the tick, which the measurement reads; with ``telemetry``
    it is x_sub[0] (masked by the aliveness after substep 0's termination
    check), without it the first substep masked by the tick's entry
    aliveness, as the JAX package computes each. x_sub (n_sub, B, 4) with
    ``telemetry``, else None."""
    c = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)
    n, dt = c(plant.mean_mtn), c(plant.T_cont)
    rp, rtol, xr2 = c(plant.rp), c(plant.rtol), c(plant.xr)
    dist_tol, ang_tol = c(plant.dist_tol), c(plant.ang_tol)
    n_sub = plant.n_sub
    x0, alive0 = x, alive
    zero_u = torch.zeros_like(ctrl)
    x_sub = []
    for k in range(n_sub):
        gi = j * n_sub + k
        pos_norm = torch.linalg.vector_norm(x[:, :2], dim=1)
        back = x[:, 1] if plant.in_track else x[:, 0]
        term_now = (pos_norm < rp) | (back < rp - rtol)
        newly_dead = alive & term_now
        alive = alive & ~term_now
        i_term_sub = i_term_sub.masked_fill(newly_dead, gi)

        dist_k = torch.linalg.vector_norm(x[:, :2] - xr2[None, :], dim=1)
        ang_k = torch.atan(x[:, 3] / x[:, 2]).abs() * (180.0 / math.pi)
        ok_k = (dist_k <= dist_tol) & (ang_k <= ang_tol)
        if gi >= 1:
            succ = succ | (alive & ok_k)

        if plant.is_delta_v:
            x_next = nonlinear.rk4_step(x, zero_u, n, dt)
            if k == 0:
                x_next = torch.cat([x_next[:, :2], x_next[:, 2:] + prev_u], 1)
        else:
            x_next = nonlinear.rk4_step(x, prev_u if k == 0 else ctrl, n, dt)
        draw = noise_draws[gi // plant.noise_int_sub]
        x_next = torch.cat([x_next[:, :2] + draw, x_next[:, 2:]], 1)
        if k == 0:
            x_first = x_next
        x = torch.where(alive[:, None], x_next, x)
        if telemetry:
            x_sub.append(x)
    if telemetry:
        return x, alive, i_term_sub, succ, x_sub[0], torch.stack(x_sub, 0)
    x_after_first = torch.where(alive0[:, None], x_first, x0)
    return x, alive, i_term_sub, succ, x_after_first, None


def rk4_tick(x, alive, i_term_sub, succ, prev_u, ctrl, noise_draws,
             j: int, plant: TickPlant, telemetry: bool = False):
    """One tick's substeps; arguments and results as ``rk4_tick_plain``.

    CPU tensors run ``rk4_tick_plain``; CUDA tensors run the CUDA kernel
    and count one launch in ``rk4_tick.launches``; anything else raises."""
    args = (x, alive, i_term_sub, succ, prev_u, ctrl, noise_draws, j, plant,
            telemetry)
    if x.device.type == "cpu":
        return rk4_tick_plain(*args)
    if x.device.type != "cuda":
        raise ValueError(f"rk4_tick: no kernel for device {x.device}")
    return _rk4_tick_cuda(*args)


rk4_tick.launches = 0

_C_TYPES = {torch.float32: ("f32", np.float32),
            torch.float64: ("f64", np.float64)}
_N_CONSTS = 16  # _kernel_constants; struct Consts in csrc/rk4_tick.cu


def _lib():
    lib = _build.load_library("rk4_tick", ("rk4_tick.cu",))
    if not getattr(lib, "_rk4_tick_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        for suffix, _ in _C_TYPES.values():
            fn = getattr(lib, f"rk4_tick_{suffix}")
            fn.argtypes = [P] * 13 + [I] * 7 + [P, P]
            fn.restype = I
        lib._rk4_tick_typed = True
    return lib


def _kernel_constants(plant: TickPlant, dtype) -> list:
    """The kernel's constants, each computed in ``dtype`` (numpy scalars of
    the same IEEE type) in the order and with the roundings of
    ``nonlinear.two_body_deriv``, ``nonlinear.rk4_step`` and the checks of
    ``rk4_tick_plain``: n², 2n, -2n, mu = n² R_T³, mu / R_T², R_T, dt/2,
    dt, dt/6, rp, rp - rtol, xr, dist_tol, ang_tol, 180/pi (the order of
    ``struct Consts`` in ``csrc/rk4_tick.cu``)."""
    ft = _C_TYPES[dtype][1]
    R = nonlinear.R_T
    n, dt = ft(plant.mean_mtn), ft(plant.T_cont)
    n2 = n * n
    mu = n2 * ft(R ** 3)
    rp = ft(plant.rp)
    vals = (n2, ft(2) * n, ft(-2) * n, mu, mu / ft(R ** 2), ft(R),
            ft(0.5) * dt, dt, dt / ft(6.0), rp, rp - ft(plant.rtol),
            ft(plant.xr[0]), ft(plant.xr[1]), ft(plant.dist_tol),
            ft(plant.ang_tol), ft(180.0 / math.pi))
    return [float(v) for v in vals]


def _rk4_tick_cuda(x, alive, i_term_sub, succ, prev_u, ctrl, noise_draws, j,
                   plant, telemetry):
    dt = x.dtype
    if dt not in _C_TYPES:
        raise TypeError(f"rk4_tick: CUDA kernel takes float32 or float64, "
                        f"not {dt}")
    B = x.shape[0]
    n_draws = noise_draws.shape[0]
    shapes = dict(
        x=(x, (B, 4), dt), alive=(alive, (B,), torch.bool),
        i_term_sub=(i_term_sub, (B,), torch.int32),
        succ=(succ, (B,), torch.bool), prev_u=(prev_u, (B, 2), dt),
        ctrl=(ctrl, (B, 2), dt), noise_draws=(noise_draws, (n_draws, B, 2), dt),
    )
    for name, (t, shape, tdt) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"rk4_tick: {name} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"rk4_tick: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if t.dtype != tdt:
            raise TypeError(f"rk4_tick: {name} is {t.dtype}, expected {tdt}")
        if not t.is_contiguous():
            raise ValueError(f"rk4_tick: {name} is not contiguous")
    n_sub, nis = plant.n_sub, plant.noise_int_sub
    if n_sub < 1 or nis < 1 or j < 0:
        raise ValueError(f"rk4_tick: n_sub={n_sub}, noise_int_sub={nis}, "
                         f"j={j}")
    last = ((j + 1) * n_sub - 1) // nis
    if last >= n_draws or (j + 1) * n_sub >= 2 ** 31:
        raise ValueError(f"rk4_tick: tick {j} reads draw {last} of "
                         f"{n_draws}")
    fn = getattr(_lib(), f"rk4_tick_{_C_TYPES[dt][0]}")
    x_end = torch.empty_like(x)
    alive_o = torch.empty_like(alive)
    i_term_o = torch.empty_like(i_term_sub)
    succ_o = torch.empty_like(succ)
    x_first = torch.empty_like(x)
    x_sub = (torch.empty((n_sub, B, 4), dtype=dt, device=x.device)
             if telemetry else None)
    consts = (ctypes.c_double * _N_CONSTS)(*_kernel_constants(plant, dt))
    ptrs = [t.data_ptr() for t in (x, alive, i_term_sub, succ, prev_u, ctrl,
                                   noise_draws, x_end, alive_o, i_term_o,
                                   succ_o, x_first)]
    ptrs.append(x_sub.data_ptr() if telemetry else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(*ptrs, B, n_draws, j, n_sub, nis, int(plant.is_delta_v),
                 int(plant.in_track), consts, stream)
    if err != 0:
        raise RuntimeError(f"rk4_tick: CUDA kernel launch failed "
                           f"(cudaError {err})")
    rk4_tick.launches += 1
    return x_end, alive_o, i_term_o, succ_o, x_first, x_sub
