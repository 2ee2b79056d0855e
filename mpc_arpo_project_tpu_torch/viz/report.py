"""Result plotting with reference figure parity.

Copy of ``mpc_arpo_project_tpu/viz/report.py:1-183`` (below this paragraph
unchanged but for the port's config classes and the reference project's
paths, given from its root), kept in the port so that it imports nothing
of the JAX package; ``simrun_from_rollout`` reads the port's torch
outputs, on any device.

Reproduces the three figures of `figurePlotSave`
(`src/mpcsim.py:179-416`):
  1. trajectory + constraint geometry (LOS cone lines, platform circle,
     vertical wall, debris box) with controller-colored segments, plus the
     relative-velocity-L1 vs relative-position-L1 funnel plot;
  2. true vs estimated states (4 rows; +2 disturbance rows for noisy runs);
  3. actuator command history with delta-v-aware units.
Headless by default (Agg); saves under RunFigs/ with a counter when given one,
exactly like the reference.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib.lines import Line2D

from mpc_arpo_project_tpu_torch.config import SimConditions, Debris, SimRun


def simrun_from_rollout(out, b: int = 0, continuous: bool = False) -> SimRun:
    """Convert batched rollout outputs to a reference-layout SimRun for
    scenario ``b`` (arrays transposed to the reference's (state, time) layout).
    Tensors are copied to the host from whatever device holds them."""
    to = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    if continuous:
        i_term = int(to(out.i_term_sub)[b])
        x_true = to(out.x_true_ticks)[:, b, :].T
        ctrl_seq = to(out.ctrl_seq)[:, b]
    else:
        i_term = int(to(out.i_term)[b])
        x_true = to(out.x_true)[:, b, :].T
        ctrl_seq = to(out.ctrl_seq)[:, b]
    return SimRun(
        i_term=i_term,
        isSuccess=bool(to(out.success)[b]),
        x_true_pcw=x_true,
        x_est=to(out.x_est)[:, b, :].T,
        ctrl_hist=to(out.ctrls)[:, b, :].T,
        ctrlr_seq=ctrl_seq,
        noise_hist=to(out.noise)[:, b, :].T if hasattr(out, "noise") and out.noise is not None else None,
    )


_COLORS = {0: "b", 1: "b", 2: "r", 3: "y"}  # reference `mpcsim.py:198-205`


def figurePlotSave(
    sim_conditions: SimConditions,
    debris: Optional[Debris],
    sim_run: SimRun,
    saveCounter=None,
    out_dir: str = "RunFigs",
    show: bool = False,
):
    """Plot (and optionally save) a run; mirrors `mpcsim.py:179-416`."""
    xtruePiece = sim_run.x_true_pcw
    xestO = sim_run.x_est
    noiseStored = sim_run.noise_hist
    ctrls = sim_run.ctrl_hist
    controllerSeq = sim_run.ctrlr_seq

    gam = sim_conditions.los_ang
    rp = sim_conditions.r_p
    rtot = sim_conditions.r_tol
    phi = sim_conditions.hatch_ofst
    T = sim_conditions.time_stp
    T_cont = sim_conditions.T_cont
    rx, ry = sim_conditions.xr[0], sim_conditions.xr[1]

    # for continuous runs telemetry is at tick rate here (decimated), so the
    # time base is T in both cases; i_term is clamped to available columns
    iterm = min(sim_run.i_term if math.isnan(T_cont) else len(controllerSeq),
                xtruePiece.shape[1] - 1, len(controllerSeq))
    tgrid = T * np.arange(iterm + 1)

    xInt = 0.1
    if sim_conditions.inTrack:
        xSampsU = np.arange(-20, 0 + xInt, xInt)
        xSampsL = np.arange(0, 20 + xInt, xInt)
    else:
        xSampsU = np.arange(0, 110, xInt)
        xSampsL = xSampsU

    # constraint geometry (`mpcsim.py:251-261`)
    yVertSamps = np.arange(-10, 10 + xInt, xInt)
    yConeL = ((rp - rtot) * math.sin(gam) / math.cos(phi - gam)) + math.tan(phi - gam) * xSampsL
    yConeU = -((rp - rtot) * math.sin(gam) / math.cos(phi + gam)) + math.tan(phi + gam) * xSampsU
    xVertSamps = np.ones_like(yVertSamps) * rp
    xCirc = np.arange(-rp, rp + xInt, xInt)
    top = np.sqrt(np.maximum(rp**2 - np.round(np.square(xCirc), 2), 0.0))

    if sim_conditions.inTrack:
        fig1, (geo, vel) = plt.subplots(nrows=1, ncols=2, figsize=(7, 5), dpi=150)
    else:
        fig1, (geo, vel) = plt.subplots(nrows=2, ncols=1, figsize=(5, 5.5), dpi=150)

    if debris is not None:
        v = debris.constructVertArr()
        for a, bxy in [(0, 1), (2, 3), (1, 2), (3, 0)]:
            geo.plot([v[a, 0], v[bxy, 0]], [v[a, 1], v[bxy, 1]], color="#994F00")
    geo.plot(xCirc, top, color="0.5")
    geo.plot(xCirc, -top, color="0.5")
    geo.plot(xSampsL, yConeL, color="#994F00", label="Constraints")
    geo.plot(xSampsU, yConeU, color="#994F00")
    if sim_conditions.inTrack:
        geo.plot(yVertSamps, xVertSamps, color="#994F00")
    else:
        geo.plot(xVertSamps, yVertSamps, color="#994F00")

    # controller-colored trajectory segments (`mpcsim.py:288-289`)
    for i in range(iterm - 1):
        col = _COLORS.get(int(controllerSeq[i + 1]) if i + 1 < len(controllerSeq) else 1, "b")
        geo.plot(xtruePiece[0, i : i + 2], xtruePiece[1, i : i + 2], color=col)
    geo.set_aspect("equal")
    geo.set_xlabel(r"$\delta$x (m)")
    geo.set_ylabel(r"$\delta$y (m)")
    geo.set_title("Trajectory and Constraints (LVLH)")
    custom = [Line2D([0], [0], color=c) for c in ("b", "r", "y")]
    geo.legend(custom, ["MPC Controller", "LQR Failsafe", "LQR Debris Avoidance"],
               loc="lower right", prop={"size": 5})

    l1_pos = np.abs(xtruePiece[0, : iterm + 1] - rx) + np.abs(xtruePiece[1, : iterm + 1] - ry)
    l1_vel = np.abs(xtruePiece[2, : iterm + 1]) + np.abs(xtruePiece[3, : iterm + 1])
    vel.plot(l1_pos, l1_pos, color="#994F00")
    vel.plot(l1_pos, l1_vel, color="b", label="Relative Velocity L1 Norm")
    vel.set_xlabel("Relative Position L1 Norm (m)")
    vel.set_ylabel("Relative Velocity L1 Norm (m/s)")
    fig1.tight_layout()

    # figure 2: true vs estimated states (+ disturbances for noisy runs)
    noisy = sim_conditions.noise is not None and noiseStored is not None
    rows = 6 if noisy else 4
    fig2, axes = plt.subplots(rows, 1, figsize=(7, 7.5), dpi=150, sharex=True)
    labels = [r"$\delta$x (m)", r"$\delta$y (m)", r"$\delta\dot{x}$ (m/s)", r"$\delta\dot{y}$ (m/s)"]
    ncols = min(iterm + 1, xestO.shape[1])
    for k in range(4):
        axes[k].plot(tgrid, xtruePiece[k, : iterm + 1], label="Ground Truth")
        if noisy:
            axes[k].plot(T * np.arange(ncols), xestO[k, :ncols], label="Estimated")
        axes[k].set_ylabel(labels[k])
    if noisy:
        axes[0].legend(loc="upper right")
        for k, lab in [(4, r"$d_x$ (m)"), (5, r"$d_y$ (m)")]:
            nn = min(ncols, noiseStored.shape[1])
            axes[k].plot(T * np.arange(nn), noiseStored[k - 4, :nn])
            axes[k].plot(T * np.arange(ncols), xestO[k, :ncols])
            axes[k].set_ylabel(lab)
    axes[0].set_title("True and Estimated States (LVLH)")
    axes[-1].set_xlabel("Time (s)")
    fig2.align_labels()

    # figure 3: actuator history with delta-v-aware units (`mpcsim.py:388-404`)
    fig3, (u1, u2) = plt.subplots(2, 1, figsize=(7, 5), dpi=150, sharex=True)
    nu_cols = min(iterm + 1, ctrls.shape[1])
    u1.plot(T * np.arange(nu_cols), ctrls[0, :nu_cols])
    u2.plot(T * np.arange(nu_cols), ctrls[1, :nu_cols])
    unit = "(m/s)" if sim_conditions.isDeltaV else "(m/s$^2$)"
    u1.set_title("Actuator Commands (LVLH)")
    u1.set_ylabel(f"$u_x$ {unit}")
    u2.set_ylabel(f"$u_y$ {unit}")
    u2.set_xlabel("Time (s)")

    if saveCounter is not None:
        os.makedirs(out_dir, exist_ok=True)
        suff = f"{saveCounter}.png"
        fig2.savefig(os.path.join(out_dir, "trueANDest" + suff), dpi=150)
        fig3.savefig(os.path.join(out_dir, "contrHist" + suff), dpi=150)
        fig1.savefig(os.path.join(out_dir, "combCons" + suff), dpi=150)
        plt.close("all")
        return None
    if show:  # pragma: no cover
        plt.show()
    return fig1, fig2, fig3
