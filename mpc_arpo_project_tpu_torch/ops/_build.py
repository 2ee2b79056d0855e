"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each library is compiled at first use from ``mpc_arpo_project_tpu_torch/
csrc/`` into ``mpc_arpo_project_tpu_torch/build/`` as a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The file
name carries a hash of the sources, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source builds anew and an unchanged one is loaded
as it is. Libraries of distinct names may be built from several threads at
once (``nvcc`` runs as a subprocess).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict = {}
build_seconds: dict = {}
ptxas_log: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def load_library(name: str, sources) -> ctypes.CDLL:
    """Compile ``sources`` (file names under csrc/) into ``build/`` unless a
    library of the same content hash exists, then load it. Raises on any
    build failure with nvcc's output."""
    if name in _loaded:
        return _loaded[name]
    paths = [os.path.join(CSRC, s) for s in sources]
    headers = sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                     if f.endswith(".cuh"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in paths + headers:
        with open(p, "rb") as f:
            h.update(f.read())
    out = os.path.join(BUILD, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        os.makedirs(BUILD, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *paths],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed building {name}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)  # atomic: concurrent builds agree
        build_seconds[name] = time.perf_counter() - t0
        ptxas_log[name] = proc.stderr
    _loaded[name] = ctypes.CDLL(out)
    return _loaded[name]
