"""Dense assembly of the MPC QP for the plain reference.

Frozen copy of ``mpc_arpo_project_tpu_torch/ops/qp_builder.py:42-261``
(``QPDims``, ``QPStatic``, ``static_C``, ``build_qp``, ``materialize_A``),
itself a copy of the JAX package's ``ops/qp_builder.py:1-256``. Kept here so
that the benchmark's reference builds its QPs from the configuration alone,
and a later change to the program cannot move it. numpy only.

Decision vector (reference `trajectorySimulate.py:216-229`):
    z = [ x_0..x_Nx | (u,s)_0..(u,s)_{Nc-1} | d ],   nz = (Nx+1)nx + Nc(nu+ny) + ndi
Constraint rows:
    [ dynamics equalities | state inequalities (C blocks) | input/slack box | d equality ]
    m = (Nx+1)nx + (Nx+1)ny + Nc(nu+ny) + ndi
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

NX_STATE = 4
NU = 2
NY = 5
NDI = 2


@dataclass(frozen=True)
class QPDims:
    """Static problem dimensions derived from the MPC horizons."""

    Nx: int
    Nc: int
    Nb: int
    nx: int = NX_STATE
    nu: int = NU
    ny: int = NY
    ndi: int = NDI

    @property
    def nz(self) -> int:
        return (self.Nx + 1) * self.nx + self.Nc * (self.nu + self.ny) + self.ndi

    @property
    def m(self) -> int:
        return (
            (self.Nx + 1) * self.nx
            + (self.Nx + 1) * self.ny
            + self.Nc * (self.nu + self.ny)
            + self.ndi
        )

    @property
    def n_eq(self) -> int:
        """Leading dynamics-equality rows."""
        return (self.Nx + 1) * self.nx

    @property
    def off_state_rows(self) -> int:
        return self.n_eq

    @property
    def off_input_rows(self) -> int:
        return self.n_eq + (self.Nx + 1) * self.ny

    @property
    def off_d_rows(self) -> int:
        return self.off_input_rows + self.Nc * (self.nu + self.ny)

    @property
    def off_u_cols(self) -> int:
        return (self.Nx + 1) * self.nx

    @property
    def off_d_cols(self) -> int:
        return self.off_u_cols + self.Nc * (self.nu + self.ny)


class QPStatic(NamedTuple):
    """Fixed problem data shared across the scenario batch (float64 numpy)."""

    P: np.ndarray  # (nz, nz) quadratic cost
    q: np.ndarray  # (nz,) linear cost
    A0: np.ndarray  # (m, nz) constraint matrix with dynamic entries zeroed
    # scatter patterns for the three dynamic coefficients:
    fun_rows: np.ndarray  # (Nx+1,) row index of the velocity-funnel row per block
    deb_rows: np.ndarray  # (Nx+1,) row index of the debris row per block
    velx_cols: np.ndarray  # (Nx+1,) column of x-velocity per block (c1 target)
    vely_cols: np.ndarray  # (Nx+1,) column of y-velocity per block (c2 target)
    posx_cols: np.ndarray  # (Nx+1,) column of x-position per block (s target)
    # base bound vectors (entries that never change; dynamic slots zeroed):
    leq: np.ndarray  # (n_eq,) equality rhs template ([-x0; 0...])
    umin: np.ndarray  # (nu+ny,) input/slack lower box
    umax: np.ndarray  # (nu+ny,) input/slack upper box
    eq_mask: np.ndarray  # (m,) True where l==u structurally (dynamics + d rows)


def static_C(sim, slope0: float) -> np.ndarray:
    """The 5x4 state-constraint matrix C at setup (reference
    `trajectorySimulate.py:133-156`): LOS-cone rows, position wall, velocity
    funnel and debris half-plane. Rows 3 (funnel signs) and 4 (slope) hold the
    *initial* dynamic values; A0 stores those entries as zero and the dynamic
    path supplies them per step.
    """
    gam, rp, rtol, phi = sim.los_ang, sim.r_p, sim.r_tol, sim.hatch_ofst
    den = (rp - rtol) * np.sin(gam)
    C = np.array(
        [
            [np.sin(phi + gam) / den, -np.cos(phi + gam) / den, 0.0, 0.0],
            [-np.sin(phi - gam) / den, np.cos(phi - gam) / den, 0.0, 0.0],
            [1.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 1.0, 1.0],
            [-slope0, 1.0, 0.0, 0.0],
        ]
    )
    if sim.inTrack:
        C[2, :] = np.array([0.0, 1.0, 0.0, 0.0])
    return C


def build_qp(dims: QPDims, sim, mpc, Ad: np.ndarray, Bd: np.ndarray, K: np.ndarray,
             QN: np.ndarray) -> QPStatic:
    """Assemble the dense QP data.

    Mirrors, block for block: the cost (`trajectorySimulate.py:216-218`), the
    equality structure with the virtual-LQR closed-loop stitching
    (`simhelpers.py:142-172`), the inequality blocks with ECR slack coupling
    (`trajectorySimulate.py:225-229`), and the offset-free disturbance border
    (AextCol/AextRow). Entries that change at runtime (funnel signs, debris
    slope) are left ZERO in A0.
    """
    Nx, Nc, Nb = dims.Nx, dims.Nc, dims.Nb
    nx, nu, ny, ndi = dims.nx, dims.nu, dims.ny, dims.ndi
    nz, m = dims.nz, dims.m

    Q = np.asarray(mpc.Q_state, dtype=np.float64)
    Ru = np.asarray(mpc.R_input, dtype=np.float64)
    Rs = np.asarray(mpc.R_slack, dtype=np.float64)
    Vecr = np.asarray(mpc.V_ecr, dtype=np.float64)
    xr = np.asarray(sim.xr, dtype=np.float64)
    x0 = np.asarray(sim.x0, dtype=np.float64)

    # ---- cost: P = blkdiag(kron(I_Nx, Q), QN, kron(I_Nc, blkdiag(Ru, Rs)), I_ndi)
    P = np.zeros((nz, nz))
    for i in range(Nx):
        P[i * nx : (i + 1) * nx, i * nx : (i + 1) * nx] = Q
    P[Nx * nx : (Nx + 1) * nx, Nx * nx : (Nx + 1) * nx] = QN
    ou = dims.off_u_cols
    for i in range(Nc):
        o = ou + i * (nu + ny)
        P[o : o + nu, o : o + nu] = Ru
        P[o + nu : o + nu + ny, o + nu : o + nu + ny] = Rs
    od = dims.off_d_cols
    P[od : od + ndi, od : od + ndi] = np.eye(ndi)

    # ---- linear cost
    q = np.zeros(nz)
    for i in range(Nx):
        q[i * nx : (i + 1) * nx] = -Q @ xr
    q[Nx * nx : (Nx + 1) * nx] = -QN @ xr

    # ---- constraint matrix
    A = np.zeros((m, nz))
    Acl = Ad - Bd @ K

    # equality rows (constructOsqpAeq, `simhelpers.py:142-172`):
    #   block 0..Nx diagonal -I; subdiagonal Ad for k=1..Nc, (Ad-BdK) for k=Nc+1..Nx
    for i in range(Nx + 1):
        A[i * nx : (i + 1) * nx, i * nx : (i + 1) * nx] = -np.eye(nx)
    for i in range(1, Nx + 1):
        sub = Ad if i <= Nc else Acl
        A[i * nx : (i + 1) * nx, (i - 1) * nx : i * nx] = sub
    # input coupling Bu = kron(BuI, [Bd 0]) — u_{k-1} enters dynamics row k, k=1..Nc
    for i in range(1, Nc + 1):
        o = ou + (i - 1) * (nu + ny)
        A[i * nx : (i + 1) * nx, o : o + nu] = Bd
    # disturbance border AextCol: position rows of dynamics blocks 1..Nx get +I2
    for i in range(1, Nx + 1):
        A[i * nx : i * nx + ndi, od : od + ndi] = np.eye(ndi)

    # state-inequality rows: kron(I_{Nx+1}, C) with dynamic entries zeroed
    C = static_C(sim, slope0=0.0)
    C0 = C.copy()
    C0[3, 2] = 0.0  # c1 slot
    C0[3, 3] = 0.0  # c2 slot
    C0[4, 0] = 0.0  # s slot
    r0 = dims.off_state_rows
    for j in range(Nx + 1):
        A[r0 + j * ny : r0 + (j + 1) * ny, j * nx : (j + 1) * nx] = C0
    # ECR slack coupling Block12 = [kron(I_Nc, D); 0], D = [0 diag(Vecr)]
    for j in range(Nc):
        o = ou + j * (nu + ny)
        A[r0 + j * ny : r0 + (j + 1) * ny, o + nu : o + nu + ny] = np.diag(Vecr)
    # input/slack identity block
    ri = dims.off_input_rows
    A[ri : ri + Nc * (nu + ny), ou : ou + Nc * (nu + ny)] = np.eye(Nc * (nu + ny))
    # disturbance equality AextRow
    rd = dims.off_d_rows
    A[rd : rd + ndi, od : od + ndi] = np.eye(ndi)

    # ---- dynamic-entry scatter indices
    blocks = np.arange(Nx + 1)
    fun_rows = r0 + blocks * ny + 3
    deb_rows = r0 + blocks * ny + 4
    velx_cols = blocks * nx + 2
    vely_cols = blocks * nx + 3
    posx_cols = blocks * nx + 0

    # ---- bounds templates
    leq = np.concatenate([-x0, np.zeros(Nx * nx)])
    ulim = mpc.u_lim
    umin = np.concatenate([[-ulim[0], -ulim[1]], np.zeros(ny)])
    umax = np.concatenate([[ulim[0], ulim[1]], np.inf * np.ones(ny)])

    eq_mask = np.zeros(m, dtype=bool)
    eq_mask[: dims.n_eq] = True
    eq_mask[rd : rd + ndi] = True

    return QPStatic(
        P=P,
        q=q,
        A0=A,
        fun_rows=fun_rows,
        deb_rows=deb_rows,
        velx_cols=velx_cols,
        vely_cols=vely_cols,
        posx_cols=posx_cols,
        leq=leq,
        umin=umin,
        umax=umax,
        eq_mask=eq_mask,
    )


def materialize_A(static: QPStatic, c1: float, c2: float, s: float) -> np.ndarray:
    """Dense A for given dynamic coefficients (test/oracle path)."""
    A = static.A0.copy()
    A[static.fun_rows, static.velx_cols] = c1
    A[static.fun_rows, static.vely_cols] = c2
    A[static.deb_rows, static.posx_cols] = s
    return A
