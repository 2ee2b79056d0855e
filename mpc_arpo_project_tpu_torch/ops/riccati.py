"""Control synthesis in torch: DARE, (integral-action) discrete LQR,
Ackermann deadbeat.

Counterpart of ``mpc_arpo_project_tpu/ops/riccati.py`` (the derivations and
the reference calls each one replaces are documented there): the same
structured-doubling DARE and closed forms, on torch tensors, so that a
sweep can synthesize its gains on tensors. ``rollout.discrete.build_engine``
runs them in float64 on the CPU (``synthesis='torch'``), as the JAX package
runs its version on its CPU backend. Each function takes the tensors it is
given and computes in their dtype and on their device.
"""

from __future__ import annotations

import torch


def solve_dare(A, B, Q, R, iters: int = 30):
    """X = A'XA - A'XB (R + B'XB)^{-1} B'XA + Q by the structured doubling
    algorithm: A_{k+1} = A_k W^{-1} A_k, G_{k+1} = G_k + A_k W^{-1} G_k A_k',
    H_{k+1} = H_k + A_k' H_k W^{-1} A_k with W = I + G_k H_k, from A_0 = A,
    G_0 = B R^{-1} B', H_0 = Q; H_k -> X (symmetrized)."""
    eye = torch.eye(A.shape[0], dtype=A.dtype, device=A.device)
    Ak, Gk, Hk = A, B @ torch.linalg.solve(R, B.T), Q
    for _ in range(iters):
        W = eye + Gk @ Hk
        WinvA = torch.linalg.solve(W, Ak)
        WinvG = torch.linalg.solve(W, Gk)
        Ak, Gk, Hk = (Ak @ WinvA, Gk + Ak @ WinvG @ Ak.T,
                      Hk + Ak.T @ Hk @ WinvA)
    return 0.5 * (Hk + Hk.T)


def dlqr(A, B, Q, R, iters: int = 30):
    """Discrete LQR gain K = (R + B'XB)^{-1} B'XA with X the DARE solution.
    Returns (K, X)."""
    X = solve_dare(A, B, Q, R, iters=iters)
    return torch.linalg.solve(R + B.T @ X @ B, B.T @ X @ A), X


def dlqr_integral(A, B, Q, R, C, iters: int = 30):
    """LQR with integral action on C x (python-control's convention): the
    DARE of A_aug = [[A, 0], [C, I]], B_aug = [[B], [0]]. Returns the full
    gain and its (Kp, Ki) split."""
    nx, nu, nr = A.shape[0], B.shape[1], C.shape[0]
    kw = dict(dtype=A.dtype, device=A.device)
    A_aug = torch.zeros((nx + nr, nx + nr), **kw)
    A_aug[:nx, :nx] = A
    A_aug[nx:, :nx] = C
    A_aug[nx:, nx:] = torch.eye(nr, **kw)
    B_aug = torch.cat([B, torch.zeros((nr, nu), **kw)], 0)
    K, _ = dlqr(A_aug, B_aug, Q, R, iters=iters)
    return K, K[:, :nx], K[:, nx:]


def acker_deadbeat(A, B):
    """Single-input Ackermann gain placing every closed-loop eigenvalue at
    0: K = e_n' Ctrb(A, B)^{-1} A^n."""
    n = A.shape[0]
    cols = []
    v = B.reshape(n)
    for _ in range(n):
        cols.append(v)
        v = A @ v
    ctrb = torch.stack(cols, 1)
    en = torch.zeros((n,), dtype=A.dtype, device=A.device)
    en[-1] = 1.0
    K = torch.linalg.solve(ctrb.T, en) @ torch.linalg.matrix_power(A, n)
    return K.reshape(1, n)


def deadbeat_debris_gains(Ad, Bd):
    """Deadbeat collision-avoidance gains on the pruned (y, ydot) system
    with an integrator on y, scattered back: K_total (2, 4) with
    K_total[1, 1], K_total[1, 3] from the pruned gain, K_i (2, 1) =
    [0; k_int]."""
    kw = dict(dtype=Ad.dtype, device=Ad.device)
    idx = torch.tensor([1, 3], device=Ad.device)
    A_aug = torch.zeros((3, 3), **kw)
    A_aug[:2, :2] = Ad[idx][:, idx]
    A_aug[2, 0] = 1.0
    A_aug[2, 2] = 1.0
    B_aug = torch.cat([Bd[idx, 1].reshape(2, 1), torch.zeros((1, 1), **kw)], 0)
    K_prune = acker_deadbeat(A_aug, B_aug)
    K_total = torch.zeros((2, 4), **kw)
    K_total[1, 1] = K_prune[0, 0]
    K_total[1, 3] = K_prune[0, 1]
    K_i = torch.stack([torch.zeros((), **kw), K_prune[0, 2]]).reshape(2, 1)
    return K_total, K_i
