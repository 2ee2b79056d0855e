"""The PyTorch port must never import JAX nor anything of the JAX package:
importing the package and every ported module in a fresh interpreter leaves
``jax``, ``mpc_arpo_project_tpu`` (and its submodules) and the JAX
package's ``tools`` out of ``sys.modules``."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import mpc_arpo_project_tpu_torch\n"
        "from mpc_arpo_project_tpu_torch import config\n"
        "from mpc_arpo_project_tpu_torch.ops import _build, admm, admm_eig, "
        "admm_pallas, constraints, host_synthesis, kalman, qp_builder, "
        "riccati, rk4_tick, ukf\n"
        "from mpc_arpo_project_tpu_torch.models import cw, nonlinear\n"
        "from mpc_arpo_project_tpu_torch.rollout import continuous, discrete\n"
        "from mpc_arpo_project_tpu_torch.tools import kernel_probe\n"
        "from mpc_arpo_project_tpu_torch.parallel import mc, mesh\n"
        "from mpc_arpo_project_tpu_torch.utils import archive, guards, "
        "timing\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith('jax.') or m.startswith('jaxlib') or m == 'flax' "
        "or m == 'mpc_arpo_project_tpu' "
        "or m.startswith('mpc_arpo_project_tpu.') "
        "or m == 'tools' or m.startswith('tools.'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
