"""The PyTorch port must never import JAX nor anything of the JAX package:
importing the package and every ported module in a fresh interpreter leaves
``jax``, ``mpc_arpo_project_tpu`` (and its submodules), the JAX package's
``tools`` and the top-level ``examples`` out of ``sys.modules``. The
package, its drivers, its entry programs and the status-mix tool run
without matplotlib: only ``viz`` (which they import inside their plot
steps) loads it."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mpc_arpo_project_tpu_torch\n"
        "from mpc_arpo_project_tpu_torch import bench, config, graft_entry\n"
        "from mpc_arpo_project_tpu_torch.ops import _build, admm, admm_eig, "
        "admm_pallas, constraints, host_synthesis, kalman, qp_builder, "
        "riccati, rk4_tick, ukf\n"
        "from mpc_arpo_project_tpu_torch.models import cw, nonlinear\n"
        "from mpc_arpo_project_tpu_torch.rollout import continuous, discrete\n"
        "from mpc_arpo_project_tpu_torch.tools import kernel_probe\n"
        "from mpc_arpo_project_tpu_torch.parallel import mc, mesh\n"
        "from mpc_arpo_project_tpu_torch.utils import archive, guards, "
        "timing\n"
        "from mpc_arpo_project_tpu_torch.tools import status_mix\n"
        "from mpc_arpo_project_tpu_torch.tools import continuous_fullscale, "
        "deviation_bench, osqp_ref, ref_sim\n"
        "from mpc_arpo_project_tpu_torch.tools import first_divergence, "
        "probe_stall, profile_step, scaling_bench\n"
        "from mpc_arpo_project_tpu_torch.examples import animate_results, "
        "common, disturb_rej_comp, mixed_sweep_10k, pod_sweep, "
        "success_curve, success_rates, traj_eval_in_track, "
        "traj_eval_radial, traj_eval_radialC\n"
        "from mpc_arpo_project_tpu_torch import viz\n"
        "from mpc_arpo_project_tpu_torch.viz import animate, animate_html, "
        "report\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') or m == 'flax' "
        "or m == 'mpc_arpo_project_tpu' "
        "or m.startswith('mpc_arpo_project_tpu.') "
        "or m == 'tools' or m.startswith('tools.') "
        "or m == 'examples' or m.startswith('examples.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_drivers_run_without_matplotlib():
    """The package and every driver module import neither ``viz`` nor
    matplotlib: a machine without matplotlib runs their compute steps."""
    code = (
        "import sys\n"
        "import mpc_arpo_project_tpu_torch\n"
        "from mpc_arpo_project_tpu_torch import bench, graft_entry\n"
        "from mpc_arpo_project_tpu_torch.tools import status_mix\n"
        "from mpc_arpo_project_tpu_torch.tools import continuous_fullscale, "
        "deviation_bench, osqp_ref, ref_sim\n"
        "from mpc_arpo_project_tpu_torch.tools import first_divergence, "
        "probe_stall, profile_step, scaling_bench\n"
        "from mpc_arpo_project_tpu_torch.examples import animate_results, "
        "common, disturb_rej_comp, mixed_sweep_10k, pod_sweep, "
        "success_curve, success_rates, traj_eval_in_track, "
        "traj_eval_radial, traj_eval_radialC\n"
        "bad = sorted(m for m in sys.modules if m == 'matplotlib' "
        "or m.startswith('matplotlib.') "
        "or m.startswith('mpc_arpo_project_tpu_torch.viz'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
