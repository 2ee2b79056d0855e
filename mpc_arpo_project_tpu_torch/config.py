"""Host-side configuration objects (the framework's "flag system").

Copy of ``mpc_arpo_project_tpu/config.py:1-219`` (below this paragraph
unchanged but for the reference project's paths, given from its root),
kept in the port so that it imports nothing of the JAX package.
The port's ``build_engine`` reads these objects by attribute only, so the
JAX package's own objects work there too.

These mirror the tunable surface of the reference parameter classes
(`src/mpcsim.py:13-176`: Noise, SimConditions, SimRun, Debris,
MPCParams, FailsafeParams) so a user of the reference finds the same knobs, but
they are plain frozen dataclasses that *compile into* an array-only engine
pytree (see ``rollout.discrete.build_engine``).

What can vary at which granularity:

* **per-scenario, inside one compiled batch** — initial state
  (``rollout(x0b=)``), offset-free switch (``rollout(is_reject_b=)``), noise
  draws and hold lengths (``make_noise_sequence_multi``), and the three
  dynamic constraint scalars the engine recomputes every step. These are
  pure array data.
* **per-engine (one host-side ``build_engine`` each)** — everything that
  shapes the batch-SHARED matrices: Q/Ru/slack weights and ECR scaling
  (they set the DARE terminal policy K and hence the constraint-matrix
  stitching, ``ops/qp_builder.py``), horizons, geometry, orientation,
  input model. The solver's structured normal-matrix stack
  (``ops/admm.py``) is shared across the batch by design, so weights canNOT
  vary per scenario; weight sweeps run as an engine grid — engines with
  identical shapes reuse one compiled executable, so the grid costs
  host-side builds (~seconds), not recompiles. See
  ``examples/mixed_sweep_10k.py``.

Shape-affecting fields (horizons Nx/Nc/Nb, inTrack, isDeltaV, noise presence)
are static and force a recompile when changed.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple, Mapping, Any

import numpy as np


def _as_diag4(x) -> np.ndarray:
    """Accept a dense matrix, a 1-D array of diagonal entries, or scipy sparse."""
    if hasattr(x, "toarray"):
        x = x.toarray()
    x = np.asarray(x, dtype=np.float64)
    if x.ndim == 1:
        return np.diag(x)
    return x


@dataclass(frozen=True)
class Noise:
    """Additive output-noise statistics (reference `src/mpcsim.py:13-32`).

    Attributes:
        noise_std: (sigma_x, sigma_y) standard deviations of the position
            disturbances, held piecewise-constant.
        noise_length: hold interval in control steps between redraws.
    """

    noise_std: Tuple[float, float]
    noise_length: int

    def constructSigMat(self) -> np.ndarray:
        """diag(sigma_x, sigma_y, 0, 0) (reference `src/mpcsim.py:26-32`)."""
        return np.diag([self.noise_std[0], self.noise_std[1], 0.0, 0.0])


@dataclass(frozen=True)
class Debris:
    """Debris bounding-box geometry (reference `src/mpcsim.py:99-123`)."""

    center: Tuple[float, float]
    side_length: float
    detect_distance: float

    def constructVertArr(self) -> np.ndarray:
        """4x2 vertex array, ordering matches reference `src/mpcsim.py:114-123`:
        [++, -+, --, +-] relative to center."""
        cx, cy = self.center
        h = self.side_length / 2.0
        return np.array(
            [[cx + h, cy + h], [cx - h, cy + h], [cx - h, cy - h], [cx + h, cy - h]]
        )


@dataclass(frozen=True)
class SimConditions:
    """General simulation conditions (reference `src/mpcsim.py:35-73`).

    Attributes:
        x0: initial LVLH state [dx, dy, dvx, dvy] (m, m/s).
        xr: target state.
        r_p: target platform radius (m).
        los_ang: LOS cone half-angle (rad).
        r_tol: LOS cone inlay distance (m).
        mean_mtn: target-orbit mean motion (rad/s).
        time_stp: control interval T (s).
        isReject: offset-free disturbance rejection switch.
        suc_cond: (distance tol (m), flight-path-angle tol (deg)).
        noise: Noise object or None.
        inTrack: in-track (vs radial) initial-condition geometry.
        T_cont: continuous-sim substep (s); NaN for discrete-only runs.
        T_final: maximum simulated time (s).
        isDeltaV: impulsive delta-v input model switch.
    """

    x0: np.ndarray
    xr: np.ndarray
    r_p: float
    los_ang: float
    r_tol: float
    mean_mtn: float
    time_stp: float
    isReject: bool
    suc_cond: Tuple[float, float]
    noise: Optional[Noise] = None
    inTrack: bool = False
    T_cont: float = float("nan")
    T_final: float = 100.0
    isDeltaV: bool = False

    def __post_init__(self):
        object.__setattr__(self, "x0", np.asarray(self.x0, dtype=np.float64))
        object.__setattr__(self, "xr", np.asarray(self.xr, dtype=np.float64))

    @property
    def hatch_ofst(self) -> float:
        """Docking-hatch offset angle: 90 deg for in-track runs
        (reference `src/mpcsim.py:64`)."""
        return (self.inTrack * 90.0) * (math.pi / 180.0)

    @property
    def nsim(self) -> int:
        """Number of discrete control steps (reference `trajectorySimulate.py:54`)."""
        return int(self.T_final / self.time_stp)


@dataclass(frozen=True)
class MPCParams:
    """MPC controller tunables (reference `src/mpcsim.py:127-157`).

    Q_state / R_input / R_slack accept dense matrices, diagonal vectors, or
    scipy sparse; they are normalized to dense float64. ``swap_xy`` permutes
    the Q/R diagonals for in-track runs exactly as the reference does
    (`src/mpcsim.py:145-151`).
    """

    Q_state: Any
    R_input: Any
    R_slack: Any
    V_ecr: np.ndarray
    horizons: Mapping[str, int]
    u_lim: Tuple[float, float]
    swap_xy: bool = False

    def __post_init__(self):
        Q = _as_diag4(self.Q_state)
        R = _as_diag4(self.R_input)
        if self.swap_xy:
            Q = Q.copy()
            R = R.copy()
            Q[0, 0], Q[1, 1], Q[2, 2], Q[3, 3] = Q[1, 1], Q[0, 0], Q[3, 3], Q[2, 2]
            R[0, 0], R[1, 1] = R[1, 1], R[0, 0]
        object.__setattr__(self, "Q_state", Q)
        object.__setattr__(self, "R_input", R)
        object.__setattr__(self, "R_slack", _as_diag4(self.R_slack))
        object.__setattr__(self, "V_ecr", np.asarray(self.V_ecr, dtype=np.float64))
        object.__setattr__(self, "horizons", dict(self.horizons))

    @property
    def Nx(self) -> int:
        return self.horizons["Nx"]

    @property
    def Nc(self) -> int:
        return self.horizons["Nc"]

    @property
    def Nb(self) -> int:
        return self.horizons["Nb"]


@dataclass(frozen=True)
class FailsafeParams:
    """Failsafe-controller tunables (reference `src/mpcsim.py:160-176`)."""

    Q_fail: np.ndarray
    R_fail: np.ndarray
    C_int: np.ndarray
    K_dead: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "Q_fail", np.asarray(self.Q_fail, dtype=np.float64))
        object.__setattr__(self, "R_fail", np.asarray(self.R_fail, dtype=np.float64))
        object.__setattr__(self, "C_int", np.asarray(self.C_int, dtype=np.float64))
        object.__setattr__(self, "K_dead", np.asarray(self.K_dead, dtype=np.float64))


# Controller-sequence codes (reference `src/trajectorySimulate.py:379-385`).
CTRL_MPC = 1
CTRL_LQR_FAILSAFE = 2
CTRL_DEADBEAT = 3


@dataclass
class SimRun:
    """Simulation telemetry record (reference `src/mpcsim.py:75-97`).

    Produced host-side from the stacked arrays a rollout returns.
    """

    i_term: int
    isSuccess: bool
    x_true_pcw: np.ndarray  # (nx, i_term) ground-truth trajectory
    x_est: np.ndarray  # (nx+ndi, nsim+1) estimates incl. disturbance states
    ctrl_hist: np.ndarray  # (nu, nsim+1) control history
    ctrlr_seq: np.ndarray  # (i_term,) controller codes (CTRL_*)
    noise_hist: np.ndarray  # (nx, nsim+1) injected noise
