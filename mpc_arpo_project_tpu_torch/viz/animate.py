"""Headless trajectory animation export — parity with `animateTrajectory`.

Copy of ``mpc_arpo_project_tpu/viz/animate.py:1-183`` (below this paragraph
unchanged but for the port's config classes, the reference project's
paths, given from its root, and the word TPU), kept in the port so that it imports nothing
of the JAX package.

The reference renders a live VPython ECI-frame scene
(`src/animateTrajectory.py:16-235`): Earth, gravity-propagated
target orbit, rotating LOS-cone lines, debris box, chaser with trail,
controller-colored thrust arrows, disturbance arrows, and live control /
disturbance graphs. VPython needs a browser; this framework targets headless
hosts, so the same scene is rendered with matplotlib and exported to GIF
(PillowWriter — no ffmpeg dependency):

  * the same LVLH -> ECI rotation by (pi + theta_target) (`:200`);
  * the target orbit propagated by explicit gravity integration (`:109-114,
    186-188`) rather than a parametric circle;
  * a chaser-following camera window (`:151-155`);
  * thrust arrows colored by the active controller, scaled 50x (`:105,135`);
  * green disturbance arrows (`:144-145`) and control/disturbance strip charts.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
from matplotlib import animation
from matplotlib.patches import Circle, Polygon, FancyArrow

from mpc_arpo_project_tpu_torch.config import SimConditions, Debris, SimRun

MU = 3.986e14
RE = 6371e3
ALT = 500e3

_CTRL_COLORS = {0: "tab:blue", 1: "tab:blue", 2: "tab:red", 3: "gold"}
_CTRL_NAMES = {1: "MPC", 2: "LQR Failsafe", 3: "Deadbeat Collision Avoidance"}


def _rot(theta: float) -> np.ndarray:
    c, s = math.cos(theta), math.sin(theta)
    return np.array([[c, -s], [s, c]])


def animate_trajectory(
    sim_conditions: SimConditions,
    sim_run: SimRun,
    debris: Optional[Debris] = None,
    out_path: str = "RunFigs/animation.gif",
    fps: int = 8,
    stride: int = 2,
    max_frames: int = 200,
    view_range: float = 30.0,
):
    """Export the run animation to ``out_path`` (GIF)."""
    xk = sim_run.x_true_pcw
    ctrls = sim_run.ctrl_hist
    seq = sim_run.ctrlr_seq
    disturbs = sim_run.noise_hist
    has_dist = disturbs is not None and np.asarray(disturbs).size > 0

    n = sim_conditions.mean_mtn
    dt = (
        sim_conditions.time_stp
        if math.isnan(sim_conditions.T_cont)
        else sim_conditions.T_cont
    )
    nanim = min(xk.shape[1], len(seq) + 1)
    frames = list(range(1, nanim, stride))[:max_frames]

    gam, rp, rtot, phi = (
        sim_conditions.los_ang,
        sim_conditions.r_p,
        sim_conditions.r_tol,
        sim_conditions.hatch_ofst,
    )

    # gravity-propagated target orbit (reference `:109-114,186-188`)
    r0 = RE + ALT
    pos = np.array([r0, 0.0])
    vel = np.array([0.0, r0 * n])
    targ_pos = np.zeros((nanim, 2))
    for i in range(nanim):
        targ_pos[i] = pos
        rmag = np.linalg.norm(pos)
        acc = -MU / rmag**2 * pos / rmag
        vel = vel + acc * dt * stride
        pos = pos + vel * dt * stride

    input_scale, dist_scale = 50.0, 50.0

    fig = plt.figure(figsize=(10, 6), dpi=100)
    ax = fig.add_subplot(1, 2, 1)
    axu = fig.add_subplot(2, 2, 2)
    axd = fig.add_subplot(2, 2, 4)
    ax.set_aspect("equal")
    axu.set_title("Control Inputs (ECI)")
    axu.set_ylabel("u " + ("(m/s)" if sim_conditions.isDeltaV else "(m/s$^2$)"))
    axd.set_title("Disturbances (ECI)" if has_dist else "")
    axd.set_xlabel("Time (s)")

    t_hist, ux_hist, uy_hist, dx_hist, dy_hist = [], [], [], [], []

    def draw(frame_idx):
        i = frames[frame_idx]
        k = frame_idx
        ax.clear()
        ax.set_aspect("equal")
        tp = targ_pos[k]
        theta = math.atan2(tp[1], tp[0])
        R = _rot(math.pi + theta)

        # platform
        ax.add_patch(Circle(tp, rp, color="0.5", alpha=0.6))
        # LOS cone lines rotating with the platform (`:103-104,179-181`)
        L = 120.0
        for sgn in (+1, -1):
            ang = phi + sgn * gam
            tip = tp + R @ np.array([0.0, 0.0])
            end = tp + R @ np.array([L, L * math.tan(ang)])
            ax.plot([tip[0], end[0]], [tip[1], end[1]], color="#ffa571", lw=1.5)
        # debris box (`:123-125,193-197`)
        if debris is not None:
            v = debris.constructVertArr()
            ax.add_patch(
                Polygon((R @ v.T).T + tp, closed=True, fill=False, color="#ffa571")
            )
        # chaser + trail (`:127-128,199-202`)
        trail = (R @ xk[:2, : i + 1]).T + tp  # note: same R for trail (visual aid)
        ax.plot(trail[:, 0], trail[:, 1], color="purple", lw=0.8, alpha=0.6)
        ch = tp + R @ xk[:2, i]
        ax.add_patch(Circle(ch, 0.6, color="purple"))

        code = int(seq[i]) if i < len(seq) else 1
        col = _CTRL_COLORS.get(code, "tab:blue")
        u_eci = R @ ctrls[:2, i] if i < ctrls.shape[1] else np.zeros(2)
        if np.linalg.norm(u_eci) > 1e-9:
            ax.add_patch(
                FancyArrow(ch[0], ch[1], input_scale * u_eci[0], input_scale * u_eci[1],
                           width=0.3, color=col)
            )
        if has_dist and i < disturbs.shape[1]:
            d_eci = R @ disturbs[:2, i]
            if np.linalg.norm(d_eci) > 1e-9:
                ax.add_patch(
                    FancyArrow(tp[0], tp[1], dist_scale * d_eci[0], dist_scale * d_eci[1],
                               width=0.3, color="green")
                )
        else:
            d_eci = np.zeros(2)

        ax.set_xlim(ch[0] - view_range, ch[0] + view_range * 3)
        ax.set_ylim(ch[1] - view_range * 2, ch[1] + view_range * 2)
        ax.set_title(f"Using controller: {_CTRL_NAMES.get(code, 'MPC')}")

        t_hist.append(i * dt * 1.0)
        ux_hist.append(u_eci[0])
        uy_hist.append(u_eci[1])
        axu.clear()
        axu.plot(t_hist, ux_hist, color="tab:blue", label="Ux")
        axu.plot(t_hist, uy_hist, color="tab:red", label="Uy")
        axu.legend(loc="upper right", fontsize=7)
        axu.set_title("Control Inputs (ECI)")
        if has_dist:
            dx_hist.append(d_eci[0])
            dy_hist.append(d_eci[1])
            axd.clear()
            axd.plot(t_hist, dx_hist, color="orange", label="X Disturbance")
            axd.plot(t_hist, dy_hist, color="cyan", label="Y Disturbance")
            axd.legend(loc="upper right", fontsize=7)
            axd.set_title("Disturbances (ECI)")
        return []

    anim = animation.FuncAnimation(fig, draw, frames=len(frames), blit=False)
    import os

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    anim.save(out_path, writer=animation.PillowWriter(fps=fps))
    plt.close(fig)
    return out_path
