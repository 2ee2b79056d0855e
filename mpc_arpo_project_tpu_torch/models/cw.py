"""Clohessy-Wiltshire (CW) planar relative-motion model and its
discretization, in torch.

Counterpart of ``mpc_arpo_project_tpu/models/cw.py``: the continuous-time
matrices, the zero-order-hold discretization as one matrix exponential of
the augmented block

    matrix_exp([[A, B], [0, 0]] T) = [[Ad, int_0^T e^{As} ds B], [0, I]]

(``torch.linalg.matrix_exp``), the impulsive delta-v input model
Bd = Ad [[0], [I]], and the offset-free observer augmentation.
"""

from __future__ import annotations

import torch

NX = 4  # state [dx, dy, dvx, dvy]
NU = 2  # input
NDI = 2  # disturbance states (offset-free layer)
NYM = 2  # measured outputs


def cw_continuous(n, dtype=torch.float64, device="cpu"):
    """(Ap, Bp, Cm): the 4x4 CW state matrix for mean motion ``n`` (rad/s),
    the 4x2 input matrix and the 2x4 position output map."""
    kw = dict(dtype=dtype, device=device)
    n = torch.as_tensor(n, **kw)
    z, o = torch.zeros((), **kw), torch.ones((), **kw)
    Ap = torch.stack([
        torch.stack([z, z, o, z]),
        torch.stack([z, z, z, o]),
        torch.stack([3 * n ** 2, z, z, 2 * n]),
        torch.stack([z, z, -2 * n, z]),
    ])
    Bp = torch.tensor([[0.0, 0.0], [0.0, 0.0], [1.0, 0.0], [0.0, 1.0]], **kw)
    Cm = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 1.0, 0.0, 0.0]], **kw)
    return Ap, Bp, Cm


def discretize(Ap, Bp, T, is_delta_v: bool = False):
    """Exact zero-order hold: Ad = e^{Ap T}, Bd = (int_0^T e^{Ap s} ds) Bp
    from one augmented matrix exponential; with ``is_delta_v`` the input is
    a velocity change at the start of the step, Bd = Ad [[0], [I]]."""
    nx, nu = Ap.shape[0], Bp.shape[1]
    kw = dict(dtype=Ap.dtype, device=Ap.device)
    M = torch.zeros((nx + nu, nx + nu), **kw)
    M[:nx, :nx] = Ap * T
    M[:nx, nx:] = Bp * T
    eM = torch.linalg.matrix_exp(M)
    Ad = eM[:nx, :nx]
    if is_delta_v:
        Bd = Ad @ torch.cat([torch.zeros((2, 2), **kw), torch.eye(2, **kw)], 0)
    else:
        Bd = eM[:nx, nx:]
    return Ad, Bd


def observer_matrices(Ad, Bd, Cm):
    """The offset-free observer: Ao = blkdiag(Ad, I_2) with the position <-
    disturbance coupling Ao[0, 4] = Ao[1, 5] = 1, Bou = [Bd; 0], Co =
    [Cm 0]."""
    kw = dict(dtype=Ad.dtype, device=Ad.device)
    nx = Ad.shape[0]
    Ao = torch.zeros((nx + NDI, nx + NDI), **kw)
    Ao[:nx, :nx] = Ad
    Ao[nx:, nx:] = torch.eye(NDI, **kw)
    Ao[0, 4] = 1.0
    Ao[1, 5] = 1.0
    Bou = torch.cat([Bd, torch.zeros((NDI, Bd.shape[1]), **kw)], 0)
    Co = torch.cat([Cm, torch.zeros((Cm.shape[0], NDI), **kw)], 1)
    return Ao, Bou, Co
