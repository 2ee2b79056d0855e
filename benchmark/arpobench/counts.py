"""The yardstick's arithmetic: published peaks, the operations a chunk of
the 'eig' solve needs, and the alive/status bookkeeping of a rollout.

Frozen copies, so that a later change to the program cannot move them:

* ``PEAK_FP32``: ``chip_smoke.py:210`` (NVIDIA's data sheet for the H100
  SXM: 67 TFLOP/s in float32 outside the tensor cores; its 3.35 TB/s of
  HBM bound a chunk below the operations, so the count is of operations);
* ``eig_chunk_ops``: the operation count of ``chip_smoke.py:618-632``
  (``eig_chunk_bound``), per live problem: ``it`` per iteration (A'v with
  the s-part gather and scatter, the eigenbasis solve with the rank-K
  Woodbury term, Av) and ``end`` per chunk (the end-of-chunk residuals and
  certificates: 2 Av, 2 A'v, 2 Pv), two operations a multiply-add;
* ``SOLVED``, ``UNSOLVED`` and the alive rule: ``mpc_arpo_project_tpu_
  torch/bench.py:44-45 and :207-224`` (``STATUS_NAMES``, ``summarize``): a
  step is alive where its controller code (``ctrl_seq``) is above 0, and
  statuses are counted over alive steps.
"""

from __future__ import annotations

import numpy as np

PEAK_FP32 = 67e12  # FLOP/s, float32 on the CUDA cores

UNSOLVED, SOLVED = 0, 1  # QP statuses
CHECK_EVERY = 25  # iterations per chunk of the 'eig' solve


def eig_chunk_terms(m: int, nz: int, K: int, gw: int) -> tuple:
    """(it, end): multiply-adds per live problem per iteration, and per
    chunk's end, of ``eig_chunk`` at constraint rows ``m``, variables
    ``nz``, Woodbury rank ``K`` and s-part width ``gw``."""
    a_mv = m * nz + nz * gw + gw * m
    it = 2 * a_mv + 2 * nz * nz + 2 * K * nz + K * K
    end = 4 * a_mv + 2 * nz * nz
    return it, end


def eig_chunk_ops(done_iters, terms) -> float:
    """Operations the solves of ``done_iters`` (iterations each, one entry
    per alive solve) need in ``eig_chunk``: their iterations, and the end of
    each chunk they ran."""
    it, end = terms
    d = np.asarray(done_iters, dtype=np.float64)
    chunks = np.ceil(d / CHECK_EVERY)
    return 2.0 * float((d * it + chunks * end).sum())


def alive_mask(ctrl_seq) -> np.ndarray:
    """Alive (scenario, step) pairs: a controller code above 0."""
    return np.asarray(ctrl_seq) > 0
