"""mpc_arpo_project_tpu_torch — the MPC rendezvous engine in PyTorch and CUDA.

A port of ``mpc_arpo_project_tpu`` (JAX/Pallas on a TPU) to PyTorch on an
NVIDIA H100, with the same module layout and public names. The JAX package
stays the reference every part of the port is tested against. This package
never imports JAX nor anything of the JAX package: what it needs of the
reference's JAX-free modules it keeps as its own copies (``config``,
``ops.qp_builder``, ``ops.host_synthesis``).

Ported so far: the discrete closed loop (``rollout.discrete``) and the
continuous-time closed loop on the nonlinear two-body plant
(``rollout.continuous``, ``models.nonlinear`` and the CUDA tick kernel
``ops.rk4_tick``), with the
'chol' solve (``ops.admm``: batched Cholesky, the default), the 'eig' solve
(``ops.admm_eig`` and its CUDA chunk kernel) and the 'pallas' solve
(``ops.admm_pallas`` and its CUDA chunk and Newton–Schulz kernels), the UKF
(``ops.ukf``) and the KF (``ops.kalman``), the synthesis (``ops.riccati``),
the CW model (``models.cw``), the dynamic constraints (``ops.constraints``),
the chunk-parts timing probe (``tools.kernel_probe`` and its CUDA
kernels), the Monte-Carlo sweeps and studies over ``torch.distributed``
ranks (``parallel``: ``mc``, ``mesh``), the utilities (``utils``:
timing, numeric guards, run archives) and the repository's two top-level
programs (``bench``: the flagship measurement; ``graft_entry``: one
control step and a multi-rank dry run). Entry points run on the CUDA
device unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"

from mpc_arpo_project_tpu_torch.config import (
    Noise,
    Debris,
    SimConditions,
    MPCParams,
    FailsafeParams,
    SimRun,
)
from mpc_arpo_project_tpu_torch.rollout import continuous, discrete
from mpc_arpo_project_tpu_torch import parallel

__all__ = [
    "Noise",
    "Debris",
    "SimConditions",
    "MPCParams",
    "FailsafeParams",
    "SimRun",
    "continuous",
    "discrete",
    "parallel",
]
