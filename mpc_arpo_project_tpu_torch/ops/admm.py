"""Batched OSQP-style ADMM QP solver, in PyTorch: the 'chol', 'eig' and
'pallas' solve modes.

Counterpart of ``mpc_arpo_project_tpu/ops/admm.py``: the same settings, the
same problem data and the same iteration. 'chol' (the default, the fp64
oracle mode) factors each problem's normal matrix with a batched Cholesky
and runs every iteration in plain torch, as the JAX package runs it in
XLA; 'eig' runs the per-iteration work in the fused chunk of
``ops.admm_eig``; 'pallas' in the fused chunk and the Newton–Schulz inverse
maintenance of ``ops.admm_pallas`` (each a hand-written CUDA kernel on the
GPU, its plain torch twin on the CPU). The rationale behind each setting
and each piece of solver machinery is documented at its definition in the
JAX package; this module keeps the names so each piece is found there at
once.

What differs from the JAX package:

* the ``lax.while_loop`` chunk loops are Python loops with one host read per
  chunk (the all-done flag or live count, read together with the refresh
  flag), and the ``lax.cond`` refresh branches are Python ``if``s on host
  reads — each such read is a device sync;
* ``eig_rescue_mode`` must be ``'dual'`` or ``'near'``: any other string
  is refused, where the JAX package silently runs the 'near' rescue for
  it (a typo of 'dual' included); a rescue window that can never fire
  (``eig_rescue_chunks >= stall_exit_chunks``) is refused too;
* 'eig' and 'pallas' run every product in full precision:
  ``mxu_precision`` other than ``'highest'`` is refused in both, and
  ``eig_refresh_precision`` other than ``'highest'`` in 'eig';
  ``minv_two_limb`` has no effect.

Problem setup (``prepare_problem``) stays numpy/scipy float64 on the host and
converts to torch only at the end. The entry points put their tensors on the
CUDA device unless the caller passes ``device="cpu"``; with no CUDA device
they raise rather than fall back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from mpc_arpo_project_tpu_torch.ops.qp_builder import QPDims, QPStatic, materialize_A
from mpc_arpo_project_tpu_torch.ops import admm_eig, admm_pallas
from mpc_arpo_project_tpu_torch.utils.timing import host_read, span

MIN_SCALING = 1e-4
MAX_SCALING = 1e4
RHO_MIN = 1e-6
RHO_MAX = 1e6
RHO_EQ_SCALE = 1e3

UNSOLVED = 0
SOLVED = 1
MAX_ITER = 2
PRIMAL_INFEASIBLE = 3
DUAL_INFEASIBLE = 4


class ADMMSettings(NamedTuple):
    """Solver settings: field for field the JAX package's ``ADMMSettings``
    (same names, same defaults; measured rationale at each field there).

    TPU layout knobs kept for a common surface, with no effect here:
    ``eig_apply`` (three TPU layouts of one product a·T⁻¹; the CUDA kernel
    has one) and ``minv_two_limb``. Every product here is full fp32/fp64
    FMA: ``mxu_precision`` (in 'eig' and 'pallas') and
    ``eig_refresh_precision`` (in 'eig') refuse any value but 'highest'.
    ``pallas_tile`` keeps its meaning as the combo-pure slot-group width
    ``bt`` of 'eig' mode and the tile width that sizes 'pallas' mode's
    refresh and cascade buffers."""

    sigma: float = 1e-6
    alpha: float = 1.6
    rho_bar: float = 0.1
    eps_abs: float = 1e-3
    eps_rel: float = 1e-3
    eps_pinf: float = 1e-4
    eps_dinf: float = 1e-4
    max_iter: int = 4000
    check_every: int = 25
    scaling_iters: int = 10
    adaptive_rho: bool = True
    adaptive_rho_interval: int = 50
    adaptive_rho_tol: float = 5.0
    pinf_support_margin: float = 1.0
    solve_mode: str = "chol"
    ns_warm_iters: int = 3
    ns_cold_iters: int = 45
    eig_warm_iters: int = 3
    eig_cold_iters: int = 30
    eig_refresh_cap_div: int = 32
    eig_refresh_precision: str = "highest"
    eig_nan_reset: bool = True
    eig_apply: str = "loop"
    eig_deb_equil_smax: float = 32.0
    eig_rho_rescue: bool = True
    eig_rescue_mode: str = "dual"
    eig_rescue_chunks: int = 6
    eig_rescue_max: int = 4
    eig_rescue_amin: float = 2.0
    eig_rescue_factor: float = 0.1
    eig_rescue_near: float = 50.0
    eig_exit_rho_down: float = 0.0
    eig_compact_chunks: tuple = (2, 4, 8, 16, 24)
    eig_tail_mult: int = 1
    pallas_tile: int = 32
    ir_steps: int = 1
    ns_refresh_drift: float = 0.02
    stall_exit_chunks: int = 0
    stall_improve: float = 0.95
    stall_improve2: float = 0.75
    stall_tighten_chunks: int = 40
    refresh_compact_div: int = 8
    overtime_div: int = 32
    mxu_precision: str = "highest"
    minv_two_limb: bool = True


class ADMMProblem(NamedTuple):
    """Problem data shared across the scenario batch (see the JAX package's
    ``ADMMProblem`` for each field). Index fields are int64 tensors."""

    Pbar: torch.Tensor
    qbar: torch.Tensor
    A0bar: torch.Tensor
    AK: torch.Tensor
    G: torch.Tensor
    Fstack: torch.Tensor
    rho_vec: torch.Tensor
    D: torch.Tensor
    E: torch.Tensor
    Dinv: torch.Tensor
    Einv: torch.Tensor
    c: torch.Tensor
    sc1: torch.Tensor
    sc2: torch.Tensor
    sc3: torch.Tensor
    fun_rows: torch.Tensor
    deb_rows: torch.Tensor
    velx_cols: torch.Tensor
    vely_cols: torch.Tensor
    posx_cols: torch.Tensor
    gsel: torch.Tensor
    scat: torch.Tensor
    rsel: torch.Tensor
    gscat: torch.Tensor
    eig_A: Optional[torch.Tensor] = None
    eig_W: Optional[torch.Tensor] = None
    eig_lam: Optional[torch.Tensor] = None
    eig_YT: Optional[torch.Tensor] = None
    eig_w33row: Optional[torch.Tensor] = None
    eig_w33col: Optional[torch.Tensor] = None
    eig_K1: Optional[torch.Tensor] = None
    eig_wuurow: Optional[torch.Tensor] = None
    eig_wuucol: Optional[torch.Tensor] = None


_INDEX_FIELDS = ("fun_rows", "deb_rows", "velx_cols", "vely_cols", "posx_cols")


class ADMMState(NamedTuple):
    """Warm-start state carried across control steps (scaled iterates).
    ``minv`` holds the (B, nz, nz) approximate inverse normal matrix in
    'pallas' mode and the (B, K, K) Woodbury inner inverse in 'eig' mode."""

    xbar: torch.Tensor  # (B, nz)
    ybar: torch.Tensor  # (B, m)
    zbar: torch.Tensor  # (B, m)
    rho_scale: torch.Tensor  # (B,)
    minv: torch.Tensor  # (B, K, K)
    minv_ok: torch.Tensor  # () bool
    ref_coef: torch.Tensor  # (B, 4): c1, c2, s, rho_scale at last refresh


class ADMMResult(NamedTuple):
    x: torch.Tensor  # (B, nz) unscaled primal solution
    status: torch.Tensor  # (B,) int32
    iters: int  # iterations executed (batch-uniform)
    pri_res: torch.Tensor  # (B,)
    dua_res: torch.Tensor  # (B,)
    state: ADMMState
    done_iters: torch.Tensor  # (B,) int32
    pri_tol: torch.Tensor  # (B,)
    dua_tol: torch.Tensor  # (B,)


# --------------------------------------------------------------------------
# setup (host-side, float64 numpy)
# --------------------------------------------------------------------------

def _ruiz(P, q, A, iters):
    n = P.shape[0]
    D = np.ones(n)
    E = np.ones(A.shape[0])
    c = 1.0
    Ps, As, qs = P.copy(), A.copy(), q.copy()
    for _ in range(iters):
        norm_cols_n = np.maximum(np.abs(Ps).max(axis=0, initial=0.0),
                                 np.abs(As).max(axis=0, initial=0.0))
        norm_cols_m = np.abs(As).max(axis=1, initial=0.0)
        norms = np.clip(np.concatenate([norm_cols_n, norm_cols_m]),
                        MIN_SCALING, MAX_SCALING)
        delta = 1.0 / np.sqrt(norms)
        dn, dm = delta[:n], delta[n:]
        Ps = Ps * dn[:, None] * dn[None, :]
        As = As * dm[:, None] * dn[None, :]
        qs = qs * dn
        D *= dn
        E *= dm
        norm_P_cols = np.abs(Ps).max(axis=0, initial=0.0)
        gamma = 1.0 / max(
            np.clip(max(norm_P_cols.mean(), np.abs(qs).max(initial=0.0)),
                    MIN_SCALING, MAX_SCALING),
            MIN_SCALING,
        )
        Ps *= gamma
        qs *= gamma
        c *= gamma
    return Ps, qs, As, D, E, c


def prepare_problem(
    static: QPStatic,
    dims: QPDims,
    settings: ADMMSettings = ADMMSettings(),
    nominal_coeffs=(1.0, 1.0, 0.0),
    dtype=torch.float32,
    pad: bool = False,
    device="cuda",
) -> ADMMProblem:
    """Equilibrate once on the nominal problem and precompute the structured
    normal-matrix pieces, in host float64; the result lands on ``device`` in
    ``dtype``. ``pad=True`` rounds nz up to a multiple of 128 and m to a
    multiple of 256 with inert rows/columns, as the JAX package does."""
    device = resolve_device(device)
    P, q, A0 = static.P, static.q, static.A0
    A_nom = materialize_A(static, *nominal_coeffs)
    _, _, _, D, E, c = _ruiz(P, q, A_nom, settings.scaling_iters)

    Pbar = c * (P * D[:, None] * D[None, :])
    qbar = c * (D * q)
    A0bar = A0 * E[:, None] * D[None, :]

    rho = np.full(dims.m, np.clip(settings.rho_bar, RHO_MIN, RHO_MAX))
    rho[static.eq_mask] = np.clip(settings.rho_bar * RHO_EQ_SCALE, RHO_MIN, RHO_MAX)

    fr, dr = static.fun_rows, static.deb_rows
    vx, vy, px = static.velx_cols, static.vely_cols, static.posx_cols
    sc1 = E[fr] * D[vx]
    sc2 = E[fr] * D[vy]
    sc3 = E[dr] * D[px]
    rho_f = rho[fr]
    rho_d = rho[dr]

    nz = dims.nz
    af = A0bar[fr, :]
    ad = A0bar[dr, :]

    def sym_outer(rows_vals, cols, weights):
        Mx = np.zeros((nz, nz))
        np.add.at(Mx, cols, weights[:, None] * rows_vals)
        return Mx + Mx.T

    F1 = sym_outer(af, vx, rho_f * sc1)
    F2 = sym_outer(af, vy, rho_f * sc2)
    F3 = sym_outer(ad, px, rho_d * sc3)
    F12 = np.zeros((nz, nz))
    np.add.at(F12, (vx, vy), rho_f * sc1 * sc2)
    F12 = F12 + F12.T
    F33 = np.zeros((nz, nz))
    np.add.at(F33, (px, px), rho_d * sc3 ** 2)

    G = A0bar.T @ (rho[:, None] * A0bar)
    np.add.at(G, (vx, vx), rho_f * sc1 ** 2)
    np.add.at(G, (vy, vy), rho_f * sc2 ** 2)

    m_rows = dims.m
    S1b = np.zeros((m_rows, nz))
    S1b[fr, vx] = sc1
    S2b = np.zeros((m_rows, nz))
    S2b[fr, vy] = sc2
    S3b = np.zeros((m_rows, nz))
    S3b[dr, px] = sc3

    if pad:
        nz_p = -(-nz // 128) * 128
        m_p = -(-m_rows // 256) * 256

        def pad_mat(Mx, r, cdim):
            out = np.zeros((r, cdim))
            out[: Mx.shape[0], : Mx.shape[1]] = Mx
            return out

        def pad_vec(v, n, fill=0.0):
            out = np.full(n, fill)
            out[: v.shape[0]] = v
            return out

        Pbar = pad_mat(Pbar, nz_p, nz_p)
        Pbar[nz:, nz:] = np.eye(nz_p - nz)
        qbar = pad_vec(qbar, nz_p)
        A0bar = pad_mat(A0bar, m_p, nz_p)
        S1b = pad_mat(S1b, m_p, nz_p)
        S2b = pad_mat(S2b, m_p, nz_p)
        S3b = pad_mat(S3b, m_p, nz_p)
        G = pad_mat(G, nz_p, nz_p)
        F1 = pad_mat(F1, nz_p, nz_p)
        F2 = pad_mat(F2, nz_p, nz_p)
        F12 = pad_mat(F12, nz_p, nz_p)
        F3 = pad_mat(F3, nz_p, nz_p)
        F33 = pad_mat(F33, nz_p, nz_p)
        rho = pad_vec(rho, m_p, fill=np.clip(settings.rho_bar, RHO_MIN, RHO_MAX))
        D = pad_vec(D, nz_p, fill=1.0)
        E = pad_vec(E, m_p, fill=1.0)

    # compact [c1|c2|s] gather/scatter factors, groups of width gw
    L = fr.shape[0]
    nz_now, m_now = Pbar.shape[0], A0bar.shape[0]
    gw = -(-L // 64) * 64
    jj = np.arange(L)
    gsel = np.zeros((nz_now, 3 * gw))
    gsel[vx, jj] = sc1
    gsel[vy, gw + jj] = sc2
    gsel[px, 2 * gw + jj] = sc3
    scat = np.zeros((3 * gw, m_now))
    scat[jj, fr] = 1.0
    scat[gw + jj, fr] = 1.0
    scat[2 * gw + jj, dr] = 1.0
    rsel = np.zeros((m_now, 3 * gw))
    rsel[fr, jj] = sc1
    rsel[fr, gw + jj] = sc2
    rsel[dr, 2 * gw + jj] = sc3
    gscat = np.zeros((3 * gw, nz_now))
    gscat[jj, vx] = 1.0
    gscat[gw + jj, vy] = 1.0
    gscat[2 * gw + jj, px] = 1.0

    fields = dict(
        Pbar=Pbar, qbar=qbar, A0bar=A0bar,
        AK=np.concatenate([A0bar, S1b, S2b, S3b], axis=0), G=G,
        Fstack=np.stack([F1, F2, F12, F3, F33]), rho_vec=rho, D=D, E=E,
        Dinv=1.0 / D, Einv=1.0 / E, c=np.asarray(c), sc1=sc1, sc2=sc2,
        sc3=sc3, fun_rows=fr, deb_rows=dr, velx_cols=vx, vely_cols=vy,
        posx_cols=px, gsel=gsel, scat=scat, rsel=rsel, gscat=gscat,
    )

    # shared-basis ('eig') data: per-combo generalized eigendecompositions
    # and the debris Woodbury factor (see ops.admm_eig)
    if settings.solve_mode == "eig":
        import scipy.linalg as sla

        base = Pbar + settings.sigma * np.eye(nz_now)
        w3 = rho[dr] * sc3
        Kw = 2 * gw
        Z = np.zeros((nz_now, Kw))
        for j in range(L):
            Z[:, j] = w3[j] * A0bar[dr[j], :]
            Z[px[j], gw + j] = 1.0
        w33 = np.zeros(Kw)
        w33[gw : gw + L] = rho[dr] * sc3 ** 2
        K1 = np.zeros((Kw, Kw))
        K1[:gw, gw:] = np.eye(gw)
        K1[gw:, :gw] = np.eye(gw)

        A_st, W_st, lam_st, YT_st = [], [], [], []
        for combo in range(4):
            c1v = 1.0 if combo & 2 else -1.0
            c2v = 1.0 if combo & 1 else -1.0
            H = G + c1v * F1 + c2v * F2 + c1v * c2v * F12
            lam, V = sla.eigh(H, base)
            A_st.append(A0bar + c1v * S1b + c2v * S2b)
            W_st.append(V)
            lam_st.append(lam)
            YT_st.append(Z.T @ V)
        wuu = np.zeros(Kw)
        wuu[:L] = 1.0 / (rho[dr] * sc3 ** 2)
        fields.update(
            eig_A=np.stack(A_st), eig_W=np.stack(W_st),
            eig_lam=np.stack(lam_st), eig_YT=np.stack(YT_st),
            eig_w33row=w33[None, :], eig_w33col=np.tile(w33[:, None], (1, Kw)),
            eig_K1=K1, eig_wuurow=wuu[None, :],
            eig_wuucol=np.tile(wuu[:, None], (1, Kw)),
        )
    return problem_from_numpy(fields, device=device, dtype=dtype)


def resolve_device(device) -> torch.device:
    """The device an entry point puts its tensors on; raises when it names
    CUDA and no CUDA device is present (no quiet move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available: pass device='cpu' "
                           "to run on the CPU")
    return device


def _as_fields(fields) -> dict:
    return fields._asdict() if hasattr(fields, "_asdict") else dict(fields)


def problem_from_numpy(fields, device="cuda", dtype=torch.float64) -> ADMMProblem:
    """Build the port's ``ADMMProblem`` from numpy arrays: a mapping, or any
    named tuple with the same field names (such as the JAX package's
    ``ADMMProblem``, whose device arrays ``np.asarray`` reads)."""
    device = resolve_device(device)
    fields = _as_fields(fields)
    out = {}
    for name in ADMMProblem._fields:
        v = fields.get(name)
        if v is None:
            out[name] = None
            continue
        dt = torch.int64 if name in _INDEX_FIELDS else dtype
        out[name] = torch.as_tensor(np.array(v, order="C"), dtype=dt,
                                    device=device)
    return ADMMProblem(**out)


def state_from_numpy(fields, device="cuda", dtype=torch.float64) -> ADMMState:
    """Build the port's ``ADMMState`` from numpy arrays (mapping or named
    tuple with the JAX package's field names) — lets tests warm-start both
    packages from one iterate."""
    device = resolve_device(device)
    fields = _as_fields(fields)
    out = {}
    for name in ADMMState._fields:
        dt = torch.bool if name == "minv_ok" else dtype
        out[name] = torch.as_tensor(np.array(fields[name]), dtype=dt, device=device)
    return ADMMState(**out)


def init_state(prob: ADMMProblem, batch: int,
               settings: ADMMSettings = ADMMSettings()) -> ADMMState:
    nz = prob.Pbar.shape[0]
    m = prob.A0bar.shape[0]
    kw = dict(dtype=prob.Pbar.dtype, device=prob.Pbar.device)
    if settings.solve_mode == "pallas":
        minv_shape = (batch, nz, nz)
    elif settings.solve_mode == "eig":
        K = prob.eig_YT.shape[1]
        minv_shape = (batch, K, K)
    else:
        minv_shape = (batch, 1, 1)
    return ADMMState(
        xbar=torch.zeros((batch, nz), **kw),
        ybar=torch.zeros((batch, m), **kw),
        zbar=torch.zeros((batch, m), **kw),
        rho_scale=torch.ones((batch,), **kw),
        minv=torch.zeros(minv_shape, **kw),
        minv_ok=torch.zeros((), dtype=torch.bool, device=prob.Pbar.device),
        ref_coef=torch.zeros((batch, 4), **kw),
    )


# --------------------------------------------------------------------------
# batched structured matvecs (scaled space)
# --------------------------------------------------------------------------

def _matvec_A(prob: ADMMProblem, coeffs, x):
    """Abar_k x for the batch: A0bar + c1 S1bar + c2 S2bar + s S3bar through
    the stacked AK. x: (B, nz) -> (B, m)."""
    c1, c2, s = coeffs
    m = prob.A0bar.shape[0]
    y = x @ prob.AK.T
    return (y[:, :m] + c1[:, None] * y[:, m:2 * m]
            + c2[:, None] * y[:, 2 * m:3 * m] + s[:, None] * y[:, 3 * m:])


def _matvec_AT(prob: ADMMProblem, coeffs, w):
    """Abar_k' w = [w, c1 w, c2 w, s w] AK. w: (B, m) -> (B, nz)."""
    c1, c2, s = coeffs
    w4 = torch.cat([w, c1[:, None] * w, c2[:, None] * w, s[:, None] * w], 1)
    return w4 @ prob.AK


def _build_M(prob: ADMMProblem, coeffs, rho_scale, sigma):
    """Batched normal matrix M_k = Pbar + sigma I + r_k (G + sum w_t F_t)."""
    c1, c2, s = coeffs
    w = torch.stack([c1, c2, c1 * c2, s, s * s], -1)
    corr = torch.tensordot(w, prob.Fstack, dims=([1], [0]))
    nz = prob.Pbar.shape[0]
    base = prob.Pbar + sigma * torch.eye(nz, dtype=prob.Pbar.dtype,
                                         device=prob.Pbar.device)
    return base[None] + rho_scale[:, None, None] * (prob.G[None] + corr)


# --------------------------------------------------------------------------
# solve
# --------------------------------------------------------------------------

def admm_solve(
    prob: ADMMProblem,
    coeffs,
    l: torch.Tensor,
    u: torch.Tensor,
    state: ADMMState,
    settings: ADMMSettings = ADMMSettings(),
    qbar: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> ADMMResult:
    """Solve the batch of QPs (prob, coeffs=(c1, c2, s), l, u), warm-started
    from ``state``; ``l``/``u`` are UNscaled (B, m) bounds and ``active`` an
    optional (B,) mask of problems to solve (the rest stay frozen, UNSOLVED).
    Same contract as the JAX package's ``admm_solve``."""
    with span("solve"):
        if settings.solve_mode not in ("chol", "eig", "pallas"):
            raise ValueError(f"unknown solve_mode {settings.solve_mode!r}")
        B = l.shape[0]
        if qbar is None:
            qbar = prob.qbar.expand(B, prob.qbar.shape[-1])
        m_prob = prob.A0bar.shape[0]
        if l.shape[1] < m_prob:
            padw = (0, m_prob - l.shape[1])
            l = torch.nn.functional.pad(l, padw)
            u = torch.nn.functional.pad(u, padw)
        lbar = prob.E * l
        ubar = prob.E * u
        if active is None:
            active = torch.ones((B,), dtype=torch.bool, device=l.device)
        if settings.solve_mode == "pallas":
            return _solve_pallas(prob, coeffs, lbar, ubar, state, settings, qbar,
                                 active)
        if settings.solve_mode == "eig":
            return _solve_eig(prob, coeffs, lbar, ubar, state, settings, qbar,
                              active)
        return _solve_chol(prob, coeffs, lbar, ubar, state, settings, qbar, active)


def _chol_factor(prob: ADMMProblem, coeffs, rho_scale, sigma):
    """Batched Cholesky factor of M_k. A row whose M is not positive
    definite gets a NaN factor, as ``jnp.linalg.cholesky`` returns, so that
    it runs to MAX_ITER as in the JAX package (``cholesky_ex`` neither
    raises nor syncs)."""
    L, info = torch.linalg.cholesky_ex(_build_M(prob, coeffs, rho_scale, sigma))
    return torch.where((info != 0)[:, None, None], torch.nan, L)


def _chol_solve(L, rhs):
    """M^{-1} rhs by the two batched triangular solves with the factor."""
    ylow = torch.linalg.solve_triangular(L, rhs[..., None], upper=False)
    return torch.linalg.solve_triangular(L.mT, ylow, upper=True)[..., 0]


def _solve_chol(prob, coeffs, lbar, ubar, state, settings, qbar, active):
    """The 'chol' solve: the XLA branch of the JAX package's
    ``_admm_solve_impl``, step for step. Every problem runs every iteration
    of a check chunk (done ones too; their iterates are frozen after it);
    the factor is rebuilt only in a chunk where some row's adaptive-rho
    trigger fires. One host read per chunk: the all-done flag, with the
    trigger flag on adaptive-rho chunks."""
    dt = prob.Pbar.dtype
    dev = prob.Pbar.device
    B = lbar.shape[0]
    sigma = float(settings.sigma)
    alpha = float(settings.alpha)
    zero = torch.zeros((), dtype=dt, device=dev)
    cinv = 1.0 / prob.c
    eps_pinf, eps_dinf = settings.eps_pinf, settings.eps_dinf
    u_fin, l_fin = torch.isfinite(ubar), torch.isfinite(lbar)

    def residuals(x, y, z):
        Ax = _matvec_A(prob, coeffs, x)
        rp = (prob.Einv * (Ax - z)).abs().amax(1)
        rp_rel = torch.maximum((prob.Einv * Ax).abs().amax(1),
                               (prob.Einv * z).abs().amax(1))
        Px = x @ prob.Pbar
        Aty = _matvec_AT(prob, coeffs, y)
        rd = cinv * (prob.Dinv * (Px + qbar + Aty)).abs().amax(1)
        rd_rel = cinv * torch.maximum(
            (prob.Dinv * Px).abs().amax(1),
            torch.maximum((prob.Dinv * Aty).abs().amax(1),
                          (prob.Dinv * qbar).abs().amax(1)))
        return rp, rp_rel, rd, rd_rel

    def prim_infeas(dy):
        """Farkas certificate of the chunk's accumulated dy, in scaled
        space (see the JAX package's ``prim_infeas``)."""
        v = torch.where(~u_fin & ~l_fin, 0.0, dy)
        v = torch.where(~u_fin & l_fin, torch.minimum(v, zero), v)
        v = torch.where(~l_fin & u_fin, torch.maximum(v, zero), v)
        nv = v.abs().amax(1)
        t1 = _matvec_AT(prob, coeffs, v).abs().amax(1) <= eps_pinf * nv
        vp = torch.maximum(v, zero)
        vm = torch.minimum(v, zero)
        sup = ((torch.where(vp > 0, ubar, 0.0) * vp).sum(1)
               + (torch.where(vm < 0, lbar, 0.0) * vm).sum(1))
        thresh = max(eps_pinf, settings.pinf_support_margin)
        t2 = (sup <= -thresh * nv) & torch.isfinite(sup)
        return t1 & t2 & (nv > eps_pinf)

    def dual_infeas(dx):
        """Unboundedness certificate of the chunk's accumulated dx."""
        nv = dx.abs().amax(1)
        t1 = (dx @ prob.Pbar).abs().amax(1) <= eps_dinf * nv
        t2 = (qbar * dx).sum(1) <= -eps_dinf * nv
        Av = _matvec_A(prob, coeffs, dx)
        eps = eps_dinf * nv[:, None]
        up_ok = torch.where(u_fin, Av <= eps, True).all(1)
        lo_ok = torch.where(l_fin, Av >= -eps, True).all(1)
        return t1 & t2 & up_ok & lo_ok & (nv > eps_dinf)

    n_checks = settings.max_iter // settings.check_every
    adapt_stride = max(1, settings.adaptive_rho_interval // settings.check_every)
    rho_lo = RHO_MIN / settings.rho_bar
    rho_hi = RHO_MAX / (settings.rho_bar * RHO_EQ_SCALE)

    x, y, z = state.xbar, state.ybar, state.zbar
    rho_scale = state.rho_scale
    L = _chol_factor(prob, coeffs, rho_scale, sigma)
    rp = rd = best_rp = best_rd = torch.full((B,), torch.inf, dtype=dt,
                                             device=dev)
    tp = td = torch.zeros((B,), dtype=dt, device=dev)
    done = ~active
    status = torch.zeros((B,), dtype=torch.int32, device=dev)
    last_prog = torch.zeros((B,), dtype=torch.int64, device=dev)
    done_chunk = torch.zeros((B,), dtype=torch.int64, device=dev)
    chunk = 0
    all_done = host_read(done.all())
    while not all_done and chunk < n_checks:
        with span("solve.chunk"):
            nc = chunk + 1
            done_in = done
            rho = rho_scale[:, None] * prob.rho_vec
            xi, yi, zi = x, y, z
            for _ in range(settings.check_every):
                rhs = sigma * xi - qbar + _matvec_AT(prob, coeffs, rho * zi - yi)
                xt = _chol_solve(L, rhs)
                zt = _matvec_A(prob, coeffs, xt)
                z_tmp = alpha * zt + (1 - alpha) * zi
                z_n = torch.minimum(torch.maximum(z_tmp + yi / rho, lbar), ubar)
                yi = yi + rho * (z_tmp - z_n)
                xi = alpha * xt + (1 - alpha) * xi
                zi = z_n
            pinf = prim_infeas(yi - y)
            dinf = dual_infeas(xi - x)
            rp_n, rp_rel, rd_n, rd_rel = residuals(xi, yi, zi)
            # done problems keep the residuals they finished at
            rp = torch.where(done, rp, rp_n)
            rd = torch.where(done, rd, rd_n)
            tp = torch.where(done, tp, settings.eps_abs + settings.eps_rel * rp_rel)
            td = torch.where(done, td, settings.eps_abs + settings.eps_rel * rd_rel)
            conv = ((rp <= settings.eps_abs + settings.eps_rel * rp_rel)
                    & (rd <= settings.eps_abs + settings.eps_rel * rd_rel))
            new_status = torch.where(
                conv, SOLVED,
                torch.where(pinf, PRIMAL_INFEASIBLE,
                            torch.where(dinf, DUAL_INFEASIBLE, UNSOLVED)),
            ).to(torch.int32)
            status = torch.where(done, status, new_status)
            keep = done[:, None]
            x = torch.where(keep, x, xi)
            y = torch.where(keep, y, yi)
            z = torch.where(keep, z, zi)
            done = done | conv | pinf | dinf

            if settings.stall_exit_chunks:
                thr = (settings.stall_improve2 if nc >= settings.stall_tighten_chunks
                       else settings.stall_improve)
                improved = (rp <= thr * best_rp) | (rd <= thr * best_rd)
                last_prog = last_prog.masked_fill(done | improved, nc)
                stalled = ~done & (nc - last_prog >= settings.stall_exit_chunks)
                status = status.masked_fill(stalled, MAX_ITER)
                done = done | stalled
            best_rp = torch.minimum(best_rp, rp)
            best_rd = torch.minimum(best_rd, rd)

            if settings.adaptive_rho and nc % adapt_stride == 0:
                num = rp / rp_rel.clamp(min=1e-10)
                den = (rd / rd_rel.clamp(min=1e-10)).clamp(min=1e-10)
                ratio = torch.sqrt(num / den)
                tol = settings.adaptive_rho_tol
                trig = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
                new_scale = torch.where(trig, rho_scale * ratio, rho_scale)
                new_scale = new_scale.clamp(rho_lo, rho_hi)
                any_trig, all_done = host_read(
                    torch.stack([trig.any(), done.all()]))
                if any_trig:
                    L = _chol_factor(prob, coeffs, new_scale, sigma)
                rho_scale = new_scale
            else:
                if settings.adaptive_rho:
                    # off-stride chunks keep the scale, clipped as the JAX
                    # branch clips it on every chunk
                    rho_scale = rho_scale.clamp(rho_lo, rho_hi)
                all_done = host_read(done.all())
            done_chunk = done_chunk.masked_fill(done & ~done_in, nc)
            chunk = nc

    status = torch.where(done, status, MAX_ITER).to(torch.int32)
    done_chunk = torch.where(active & (done_chunk == 0), chunk, done_chunk)
    return ADMMResult(
        x=prob.D * x,
        status=status,
        iters=chunk * settings.check_every,
        pri_res=rp,
        dua_res=rd,
        state=ADMMState(xbar=x, ybar=y, zbar=z, rho_scale=rho_scale,
                        minv=state.minv, minv_ok=state.minv_ok,
                        ref_coef=state.ref_coef),
        done_iters=(done_chunk * settings.check_every).to(torch.int32),
        pri_tol=tp,
        dua_tol=td,
    )


def _tile_width(B: int, pallas_tile: int) -> int:
    bt = max(1, pallas_tile)
    while B % bt:
        bt //= 2
    return max(bt, 1)


def _check_full_precision(settings: ADMMSettings, *names: str) -> None:
    for name in names:
        if getattr(settings, name) != "highest":
            raise ValueError(
                f"{name}={getattr(settings, name)!r}: the port runs every "
                "product in full precision; only 'highest' is supported")


def _check_eig_settings(settings: ADMMSettings) -> None:
    _check_full_precision(settings, "mxu_precision", "eig_refresh_precision")
    if settings.eig_rescue_mode not in ("dual", "near"):
        raise ValueError(
            f"eig_rescue_mode={settings.eig_rescue_mode!r}: only 'dual' and "
            "'near' are supported")
    if (settings.adaptive_rho and settings.eig_rho_rescue
            and settings.stall_exit_chunks
            and settings.eig_rescue_chunks >= settings.stall_exit_chunks):
        raise ValueError(
            f"eig_rescue_chunks={settings.eig_rescue_chunks} >= "
            f"stall_exit_chunks={settings.stall_exit_chunks}: the rho rescue "
            "could never fire before the stall exit")


class _Carry(NamedTuple):
    """Per-slot solver state of the chunk loop (every field is permuted by
    straggler compaction)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    rp: torch.Tensor
    rd: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    tinv: torch.Tensor
    rho_scale: torch.Tensor
    ref: torch.Tensor
    best_rp: torch.Tensor
    best_rd: torch.Tensor
    last_prog: torch.Tensor
    done_chunk: torch.Tensor
    tp: torch.Tensor
    td: torch.Tensor
    rescue_cnt: torch.Tensor
    post_rescue: torch.Tensor


def _solve_eig(prob, coeffs, lbar, ubar, state, settings, qbar, active):
    """Shared-basis solve path; see the JAX package's ``_solve_eig`` for the
    slot packing, refresh gating, compaction and rescue machinery, which
    this follows step for step."""
    _check_eig_settings(settings)
    dt = prob.Pbar.dtype
    dev = prob.Pbar.device
    B = lbar.shape[0]
    K = prob.eig_YT.shape[1]
    bt = _tile_width(B, settings.pallas_tile)
    c1, c2, s = coeffs
    i64 = dict(dtype=torch.int64, device=dev)
    combo = (c1 > 0).long() * 2 + (c2 > 0).long()

    gw = prob.gsel.shape[1] // 3
    if K != 2 * gw:
        raise ValueError(f"Woodbury rank K={K} must be 2*gw={2 * gw}")
    gsel_s = prob.gsel[:, 2 * gw:].contiguous()
    scat_s = prob.scat[2 * gw:].contiguous()
    rsel_s = prob.rsel[:, 2 * gw:].contiguous()
    gscat_s = prob.gscat[2 * gw:].contiguous()

    # ---- combo-pure, alive-first slot assignment padded to tile multiples
    with span("solve.setup"):
        n_groups = 4
        n_slots = B + n_groups * bt
        counts = (combo[:, None] == torch.arange(n_groups, **i64)[None, :]).sum(0)
        padded = ((counts + bt - 1) // bt) * bt
        bounds = torch.cumsum(padded, 0)
        goff = bounds - padded
        cstart = torch.cumsum(counts, 0) - counts
        arB = torch.arange(B, **i64)
        key = combo * (2 * B) + (~active).long() * B + arB
        perm = torch.argsort(key)  # unique keys
        combo_sorted = combo[perm]
        slot = torch.empty(B, **i64)
        slot[perm] = goff[combo_sorted] + arB - cstart[combo_sorted]
        src = torch.full((n_slots,), B, **i64)
        src[slot] = arB
        dummy = src >= B
        srcc = src.clamp(0, B - 1)
        n_tiles = n_slots // bt
        tpos = torch.arange(n_tiles, **i64) * bt
        tile_combo = (tpos[:, None] >= bounds[None, :n_groups - 1]).sum(1).to(
            torch.int32)

        def gat(a):
            return a[srcc]

        c1s, c2s, ss = gat(c1), gat(c2), gat(s)
        rsc = gat(state.rho_scale)
        lb, ub = gat(lbar), gat(ubar)
        qb = gat(qbar)
        act = gat(active) & ~dummy
        ref = gat(state.ref_coef)
        tinv = gat(state.minv)
        lam_s = prob.eig_lam[gat(combo)]

        # non-finite warm iterates or a poisoned inner inverse reset to cold
        xg, yg, zg = gat(state.xbar), gat(state.ybar), gat(state.zbar)
        it_finite = (torch.isfinite(xg).all(1) & torch.isfinite(yg).all(1)
                     & torch.isfinite(zg).all(1))[:, None]
        x0 = torch.where(it_finite, xg, 0.0)
        y0 = torch.where(it_finite, yg, 0.0)
        z0 = torch.where(it_finite, zg, 0.0)
        tv_finite = torch.isfinite(tinv).all(2).all(1)
        tinv = torch.where(tv_finite[:, None, None], tinv, 0.0)

        # ---- debris-row equilibration: alpha = smax/|s| where |s| > smax; a
        # non-finite s keeps alpha = 1 (the nan-reset machinery owns that row)
        smax = float(settings.eig_deb_equil_smax)

        def al_of(ssv):
            if smax <= 0:
                return torch.ones_like(ssv)
            sa = ssv.abs()
            return torch.where(torch.isfinite(ssv) & (sa > smax), smax / sa,
                               torch.ones_like(ssv))

        dmask_m = scat_s.amax(0)  # (m,) 1.0 on debris rows
        dmask_row = dmask_m.reshape(1, -1)

        def rowsc_of(ssv):
            return 1.0 + (al_of(ssv)[:, None] - 1.0) * dmask_m[None, :]

        rowsc0 = rowsc_of(ss)
        lb = lb * rowsc0
        ub = ub * rowsc0
        z0 = z0 * rowsc0
        y0 = y0 / rowsc0

        sz0 = ss != 0.0
        need = act & sz0 & (
            (ref[:, 0] != c1s) | (ref[:, 1] != c2s) | (ref[:, 2] != ss)
            | (ref[:, 3] != rsc) | ~tv_finite)

        # slot-space per-problem data that compaction permutes with the carry
        sdata = dict(qb=qb, lb=lb, ub=ub, c1s=c1s, c2s=c2s, ss=ss, lam=lam_s,
                     src=src)

        def dg_of(sd, r):
            return 1.0 / (1.0 + r[:, None] * sd["lam"])

        def scal_of(sd, r):
            return torch.cat([r[:, None], sd["ss"][:, None],
                              al_of(sd["ss"])[:, None],
                              torch.zeros((n_slots, 5), dtype=dt, device=dev)], 1)

        cap_div = max(0, int(settings.eig_refresh_cap_div))
        cap = n_slots // cap_div if cap_div > 1 else n_slots

        def refresh_rows(combo_r, scal_r, dg_r, tv_r, mask_r):
            return admm_eig.tinv_safe_refresh(
                combo_r, scal_r, dg_r, tv_r, mask_r, prob.eig_YT,
                prob.eig_w33col, warm_iters=settings.eig_warm_iters,
                cold_iters=settings.eig_cold_iters, wuucol=prob.eig_wuucol,
                cold_cap=(max(2 * bt, cap) if cap_div > 1 else 0))

        def refresh(sd, tv, r, mask):
            with span("solve.refresh"):
                combo_r = (sd["c1s"] > 0).long() * 2 + (sd["c2s"] > 0).long()
                scal_r, dg_r = scal_of(sd, r), dg_of(sd, r)
                if cap >= n_slots or host_read(mask.sum()) > cap:
                    return refresh_rows(combo_r, scal_r, dg_r, tv, mask)
                # needy rows first (stable: slot order); bit-identical to the
                # full-width refresh because per-row math is independent
                idx = torch.argsort((~mask).to(torch.int32), stable=True)[:cap]
                out = tv.clone()
                out[idx] = refresh_rows(combo_r[idx], scal_r[idx], dg_r[idx],
                                        tv[idx], mask[idx])
                return out

        if host_read(need.any()):
            tinv = refresh(sdata, tinv, rsc, need)
        ref = torch.where(need[:, None], torch.stack([c1s, c2s, ss, rsc], 1), ref)

    sigma = float(settings.sigma)
    n_checks = settings.max_iter // settings.check_every
    adapt_stride = max(1, settings.adaptive_rho_interval // settings.check_every)
    rho_lo = RHO_MIN / settings.rho_bar
    rho_hi = RHO_MAX / (settings.rho_bar * RHO_EQ_SCALE)
    rescue_on = bool(settings.eig_rho_rescue and settings.stall_exit_chunks)

    def body(sd, cy: _Carry, chunk: int, mult: int, n_live: int):
        """One check chunk on ``n_live`` running problems; returns the new
        carry and the host-read count of running problems after it (the
        chunk's one device sync, shared with the refresh decision)."""
        done = cy.done
        nc = chunk + mult
        rho_scale = cy.rho_scale
        x_n, y_n, z_n, stats = admm_eig.eig_chunk(
            tile_combo, cy.tinv, scal_of(sd, rho_scale), sd["qb"], sd["lb"],
            sd["ub"], dg_of(sd, rho_scale), cy.x, cy.y, cy.z,
            prob.eig_A, prob.eig_W, prob.eig_YT, prob.Pbar, prob.eig_K1,
            prob.eig_w33row, gsel_s, scat_s, rsel_s, gscat_s,
            prob.rho_vec, prob.Einv, prob.Dinv,
            done=done,
            n_live=n_live,
            n_iter=settings.check_every * mult,
            sigma=sigma,
            alpha=float(settings.alpha),
            eps_pinf=float(settings.eps_pinf),
            eps_dinf=float(settings.eps_dinf),
            pinf_margin=float(settings.pinf_support_margin),
            bt=bt,
            wuu_row=prob.eig_wuurow,
            dmask=dmask_row,
        )
        cinv = 1.0 / prob.c
        rp = torch.where(done, cy.rp, stats[:, 0])
        rd = torch.where(done, cy.rd, cinv * stats[:, 2])
        rp_rel, rd_rel = stats[:, 1], cinv * stats[:, 3]
        tp = torch.where(done, cy.tp,
                         settings.eps_abs + settings.eps_rel * rp_rel)
        td = torch.where(done, cy.td,
                         settings.eps_abs + settings.eps_rel * rd_rel)
        pinf = stats[:, 4] > 0
        dinf = stats[:, 5] > 0
        if settings.eig_nan_reset:
            # cold-restart rows whose residuals went non-finite (an
            # unconditional select: identical to the JAX cond branch)
            badrow = (~torch.isfinite(rp) | ~torch.isfinite(rd)) & ~done
            b = badrow[:, None]
            x_n = torch.where(b, 0.0, x_n)
            y_n = torch.where(b, 0.0, y_n)
            z_n = torch.where(b, 0.0, z_n)
            rp = torch.where(badrow, torch.inf, rp)
            rd = torch.where(badrow, torch.inf, rd)
            tp = torch.where(badrow, 0.0, tp)
            td = torch.where(badrow, 0.0, td)
            pinf = pinf & ~badrow
            dinf = dinf & ~badrow
        # certificate blackout for the chunk right after a rho rescue
        pinf = pinf & ~cy.post_rescue
        dinf = dinf & ~cy.post_rescue
        conv = ((rp <= settings.eps_abs + settings.eps_rel * rp_rel)
                & (rd <= settings.eps_abs + settings.eps_rel * rd_rel)
                & torch.isfinite(rp_rel) & torch.isfinite(rd_rel))
        new_status = torch.where(
            conv, SOLVED,
            torch.where(pinf, PRIMAL_INFEASIBLE,
                        torch.where(dinf, DUAL_INFEASIBLE, UNSOLVED)),
        ).to(torch.int32)
        status = torch.where(done, cy.status, new_status)
        keep = done[:, None]
        x = torch.where(keep, cy.x, x_n)
        y = torch.where(keep, cy.y, y_n)
        z = torch.where(keep, cy.z, z_n)
        done = done | conv | pinf | dinf

        last_prog = cy.last_prog
        if settings.stall_exit_chunks:
            thr = (settings.stall_improve2 if nc >= settings.stall_tighten_chunks
                   else settings.stall_improve)
            improved = (rp <= thr * cy.best_rp) | (rd <= thr * cy.best_rd)
            last_prog = last_prog.masked_fill(done | improved, nc)
            stalled = ~done & (nc - last_prog >= settings.stall_exit_chunks)
            status = status.masked_fill(stalled, MAX_ITER)
            done = done | stalled
        best_rp = torch.minimum(cy.best_rp, rp)
        best_rd = torch.minimum(cy.best_rd, rd)

        tinv, ref, rescue_cnt = cy.tinv, cy.ref, cy.rescue_cnt
        rescue = torch.zeros_like(done)
        if settings.adaptive_rho:
            num = rp / rp_rel.clamp(min=1e-10)
            den = (rd / rd_rel.clamp(min=1e-10)).clamp(min=1e-10)
            ratio = torch.sqrt(num / den)
            tol = settings.adaptive_rho_tol
            trig = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
            if nc % adapt_stride:
                trig = torch.zeros_like(trig)
            if rescue_on:
                # no residual progress for eig_rescue_chunks and, 'dual':
                # primal converged, dual plateaued; 'near': both residuals
                # within eig_rescue_near of tolerance, one above it
                if settings.eig_rescue_mode == "dual":
                    gate = (rp <= tp) & (rd > td)
                else:
                    nm = settings.eig_rescue_near
                    gate = ((rp <= nm * tp.clamp(min=1e-30))
                            & (rd <= nm * td.clamp(min=1e-30))
                            & ((rp > tp) | (rd > td)))
                rescue = (~done & gate
                          & (nc - last_prog >= settings.eig_rescue_chunks)
                          & (rescue_cnt < settings.eig_rescue_max)
                          & torch.isfinite(ratio))
                trig = trig | rescue
                last_prog = last_prog.masked_fill(rescue, nc)
                rescue_cnt = rescue_cnt + rescue.to(torch.int32)
            amin = settings.eig_rescue_amin
            decisive = (ratio > amin) | (ratio < 1.0 / amin)
            factor = torch.where(rescue & ~decisive,
                                 settings.eig_rescue_factor, ratio)
            new_scale = torch.where(trig, rho_scale * factor, rho_scale)
            new_scale = new_scale.clamp(rho_lo, rho_hi)
            # rho enters the solve exactly through dg; only debris-active
            # problems carry a (combo, r, s)-dependent inner inverse
            mask = trig & (sd["ss"] != 0.0)
            any_mask, n_live = host_read(
                torch.stack([mask.any().long(), (~done).sum()]))
            if any_mask:
                tinv = refresh(sd, tinv, new_scale, mask)
            ref = torch.where(
                mask[:, None],
                torch.stack([sd["c1s"], sd["c2s"], sd["ss"], new_scale], 1),
                ref)
            rho_scale = new_scale
        else:
            n_live = host_read((~done).sum())

        done_chunk = cy.done_chunk.masked_fill(done & ~cy.done, nc)
        new = _Carry(x, y, z, rp, rd, done, status, tinv, rho_scale, ref,
                     best_rp, best_rd, last_prog, done_chunk, tp, td,
                     rescue_cnt, rescue)
        return new, n_live

    slot_pos = torch.arange(n_slots, **i64)
    group_of_slot = (slot_pos[:, None] >= bounds[None, :n_groups - 1]).sum(1)

    def compact(sd, cy: _Carry):
        """Pack still-running problems to the front of their combo group:
        a pure permutation of independent problems."""
        key = (group_of_slot * (2 * n_slots)
               + cy.done.long() * n_slots + slot_pos)
        g = torch.argsort(key)  # unique keys; new slot i pulls old slot g[i]
        return ({k: v[g] for k, v in sd.items()},
                _Carry(*(v[g] for v in cy)))

    rp0 = torch.full((n_slots,), torch.inf, dtype=dt, device=dev)
    zi = torch.zeros((n_slots,), **i64)
    cy = _Carry(
        x=x0, y=y0, z=z0, rp=rp0, rd=rp0, done=~act,
        status=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        tinv=tinv, rho_scale=rsc, ref=ref, best_rp=rp0, best_rd=rp0,
        last_prog=zi, done_chunk=zi,
        tp=torch.zeros((n_slots,), dtype=dt, device=dev),
        td=torch.zeros((n_slots,), dtype=dt, device=dev),
        rescue_cnt=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        post_rescue=torch.zeros((n_slots,), dtype=torch.bool, device=dev),
    )
    chunk = 0
    n_live = host_read((~cy.done).sum())

    def run(sd, cy, chunk, n_live, end, mult):
        while n_live and chunk + mult <= end:
            with span("solve.chunk"):
                cy, n_live = body(sd, cy, chunk, mult, n_live)
            chunk += mult
        return cy, chunk, n_live

    prev_end = 0
    for b in settings.eig_compact_chunks:
        end = min(int(b), n_checks)
        if end <= prev_end:
            continue
        cy, chunk, n_live = run(sdata, cy, chunk, n_live, end, 1)
        with span("solve.compact"):
            sdata, cy = compact(sdata, cy)
        prev_end = end
    mult = max(1, int(settings.eig_tail_mult))
    if mult > 1 and prev_end + mult <= n_checks:
        tail_end = prev_end + ((n_checks - prev_end) // mult) * mult
        cy, chunk, n_live = run(sdata, cy, chunk, n_live, tail_end, mult)
    if prev_end < n_checks:
        cy, chunk, n_live = run(sdata, cy, chunk, n_live, n_checks, 1)

    # ---- scatter back to problem order: dummy slots (src == B) land in a
    # spare last entry that is dropped
    with span("solve.finish"):
        final_slot = torch.zeros(B + 1, **i64)
        final_slot[sdata["src"]] = slot_pos
        final_slot = final_slot[:B]

        def sc(a):
            return a[final_slot]

        x, y, z = sc(cy.x), sc(cy.y), sc(cy.z)
        # leave the alpha-scaled problem: slacks /= alpha, duals *= alpha
        rowsc_b = rowsc_of(s)
        z = z / rowsc_b
        y = y * rowsc_b
        rp, rd = sc(cy.rp), sc(cy.rd)
        rp_tol, rd_tol = sc(cy.tp), sc(cy.td)
        done = sc(cy.done)
        status = torch.where(done, sc(cy.status), MAX_ITER).to(torch.int32)
        done_chunk = sc(cy.done_chunk)
        done_chunk = torch.where(active & (done_chunk == 0), chunk, done_chunk)
        tinv = sc(cy.tinv)
        rho_scale = sc(cy.rho_scale)
        ref = sc(cy.ref)

        down = float(settings.eig_exit_rho_down)
        if 0.0 < down < 1.0:
            pp = ((status == MAX_ITER) & (rp > rp_tol.clamp(min=1e-30))
                  & (rd <= rd_tol.clamp(min=1e-30)))
            rho_scale = torch.where(pp, (rho_scale * down).clamp(rho_lo, rho_hi),
                                    rho_scale)

        return ADMMResult(
            x=prob.D * x,
            status=status,
            iters=chunk * settings.check_every,
            pri_res=rp,
            dua_res=rd,
            state=ADMMState(xbar=x, ybar=y, zbar=z, rho_scale=rho_scale,
                            minv=tinv,
                            minv_ok=torch.ones((), dtype=torch.bool, device=dev),
                            ref_coef=ref),
            done_iters=(done_chunk * settings.check_every).to(torch.int32),
            pri_tol=rp_tol,
            dua_tol=rd_tol,
        )


class _PCarry(NamedTuple):
    """Per-problem solver state of the 'pallas' chunk loop (every field is
    gathered by the overtime cascade; the chunk counter is a separate
    scalar)."""

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor
    rp: torch.Tensor
    rd: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    minv: torch.Tensor
    rho_scale: torch.Tensor
    best_rp: torch.Tensor
    best_rd: torch.Tensor
    last_prog: torch.Tensor
    done_chunk: torch.Tensor


def _solve_pallas(prob, coeffs, lbar, ubar, state, settings, qbar, active):
    """Fused-chunk solve path with Newton–Schulz inverse maintenance; see
    the JAX package's ``_solve_pallas`` for the refresh gating, the
    compacted needy refresh and the overtime cascade, which this follows
    step for step."""
    _check_full_precision(settings, "mxu_precision")
    dt = prob.Pbar.dtype
    dev = prob.Pbar.device
    B = lbar.shape[0]
    nz = prob.Pbar.shape[0]
    bt = _tile_width(B, settings.pallas_tile)
    c1, c2, s = coeffs
    coef = torch.stack([torch.ones_like(c1), c1, c2, s], 1)
    qbar = qbar.contiguous()
    sigma = float(settings.sigma)

    # the 7 shared structure matrices of M_k = base + r_k (G + c1 F1 + c2 F2
    # + c1 c2 F12 + s F3 + s^2 F33), stacked for the refresh kernel and
    # side by side for the chunk kernel's refinement products
    eye = torch.eye(nz, dtype=dt, device=dev)
    ns_stack = torch.cat([(prob.Pbar + sigma * eye)[None], prob.G[None],
                          prob.Fstack], 0).contiguous()
    stack7 = torch.cat(list(ns_stack), 1).contiguous()

    def make_ns_weights(coef_l):
        cc1, cc2, ss = coef_l[:, 1], coef_l[:, 2], coef_l[:, 3]

        def ns_weights(r):
            return torch.stack(
                [torch.ones_like(r), r, r * cc1, r * cc2, r * cc1 * cc2,
                 r * ss, r * ss * ss, torch.zeros_like(r)], 1)

        return ns_weights

    def make_ns_refresh(coef_l, bt_l):
        ns_weights = make_ns_weights(coef_l)
        B_l = coef_l.shape[0]

        def full_refresh(minv, rho_scale, needmask, n_need=None):
            return admm_pallas.masked_safe_refresh(
                ns_stack, ns_weights(rho_scale), minv, needmask,
                warm_iters=settings.ns_warm_iters,
                cold_iters=settings.ns_cold_iters, bt=bt_l, n_need=n_need)

        # compact the (usually sparse) needy rows into a K-slot buffer;
        # the full-width refresh when they do not fit
        div = settings.refresh_compact_div
        K = -(-max(bt_l, B_l // max(div, 1)) // bt_l) * bt_l
        if not div or K >= B_l:
            return full_refresh

        def compact_refresh(minv, rho_scale, needmask):
            n_need = host_read(needmask.sum())
            if n_need > K:
                return full_refresh(minv, rho_scale, needmask, n_need)
            idx = torch.argsort((~needmask).to(torch.int32), stable=True)[:K]
            sub = admm_pallas.masked_safe_refresh(
                ns_stack, make_ns_weights(coef_l[idx])(rho_scale[idx]),
                minv[idx], needmask[idx], warm_iters=settings.ns_warm_iters,
                cold_iters=settings.ns_cold_iters,
                bt=_tile_width(K, settings.pallas_tile), n_need=n_need)
            out = minv.clone()
            out[idx] = sub
            return out

        return compact_refresh

    # iterate sanitation: non-finite warm iterates restart cold
    it_finite = (torch.isfinite(state.xbar).all(1)
                 & torch.isfinite(state.ybar).all(1)
                 & torch.isfinite(state.zbar).all(1))
    xbar0 = torch.where(it_finite[:, None], state.xbar, 0.0)
    ybar0 = torch.where(it_finite[:, None], state.ybar, 0.0)
    zbar0 = torch.where(it_finite[:, None], state.zbar, 0.0)

    # refresh gating: sign flips, slope drift, rho rescale, cold state, the
    # NaN mark of a MAX_ITER solve (NaN compares unequal), non-finite
    # iterates; skipped problems never refresh
    rc = state.ref_coef
    drift = settings.ns_refresh_drift
    need = ((~it_finite) | (rc[:, 0] != c1) | (rc[:, 1] != c2)
            | ~((rc[:, 2] - s).abs() <= drift * (1.0 + rc[:, 2].abs()))
            | (rc[:, 3] != state.rho_scale) | ~state.minv_ok) & active
    minv0 = state.minv
    if host_read(need.any()):
        minv0 = make_ns_refresh(coef, bt)(state.minv, state.rho_scale, need)
    ref0 = torch.where(need[:, None],
                       torch.stack([c1, c2, s, state.rho_scale], 1), rc)

    n_checks = settings.max_iter // settings.check_every
    adapt_stride = max(1, settings.adaptive_rho_interval // settings.check_every)
    rho_lo = RHO_MIN / settings.rho_bar
    rho_hi = RHO_MAX / (settings.rho_bar * RHO_EQ_SCALE)
    cinv = 1.0 / prob.c

    def run_loop(cy: _PCarry, chunk: int, coef_l, qbar_l, lbar_l, ubar_l,
                 bt_l, stop_at=None):
        """The chunk loop over a (possibly compacted) problem subset, until
        every problem is done, the iteration cap, or (``stop_at``) the live
        count fits that many slots. One host read per chunk: the live count,
        together with the adaptive-rho trigger flag."""
        ns_refresh = make_ns_refresh(coef_l, bt_l)
        ns_weights = make_ns_weights(coef_l)
        n_live = host_read((~cy.done).sum())
        while (n_live > 0 and chunk < n_checks
               and (stop_at is None or n_live > stop_at)):
            with span("solve.chunk"):
                nc = chunk + 1
                done = cy.done
                rho_scale = cy.rho_scale
                rho = (rho_scale[:, None] * prob.rho_vec).contiguous()
                x_n, y_n, z_n, stats = admm_pallas.admm_chunk(
                    cy.minv, coef_l, qbar_l, lbar_l, ubar_l, rho, cy.x, cy.y,
                    cy.z, ns_weights(rho_scale), prob.A0bar, prob.Pbar,
                    prob.gsel, prob.scat, prob.rsel, prob.gscat, stack7,
                    prob.Einv, prob.Dinv, done=done, n_live=n_live,
                    n_iter=settings.check_every, sigma=sigma,
                    alpha=float(settings.alpha),
                    eps_pinf=float(settings.eps_pinf),
                    eps_dinf=float(settings.eps_dinf),
                    pinf_margin=float(settings.pinf_support_margin), bt=bt_l,
                    ir_steps=settings.ir_steps, two_limb=settings.minv_two_limb)
                rp = torch.where(done, cy.rp, stats[:, 0])
                rd = torch.where(done, cy.rd, cinv * stats[:, 2])
                rp_rel, rd_rel = stats[:, 1], cinv * stats[:, 3]
                pinf = stats[:, 4] > 0
                dinf = stats[:, 5] > 0
                conv = ((rp <= settings.eps_abs + settings.eps_rel * rp_rel)
                        & (rd <= settings.eps_abs + settings.eps_rel * rd_rel))
                new_status = torch.where(
                    conv, SOLVED,
                    torch.where(pinf, PRIMAL_INFEASIBLE,
                                torch.where(dinf, DUAL_INFEASIBLE, UNSOLVED)),
                ).to(torch.int32)
                status = torch.where(done, cy.status, new_status)
                keep = done[:, None]
                x = torch.where(keep, cy.x, x_n)
                y = torch.where(keep, cy.y, y_n)
                z = torch.where(keep, cy.z, z_n)
                done = done | conv | pinf | dinf

                last_prog = cy.last_prog
                if settings.stall_exit_chunks:
                    thr = (settings.stall_improve2
                           if nc >= settings.stall_tighten_chunks
                           else settings.stall_improve)
                    improved = (rp <= thr * cy.best_rp) | (rd <= thr * cy.best_rd)
                    last_prog = last_prog.masked_fill(done | improved, nc)
                    stalled = ~done & (nc - last_prog >= settings.stall_exit_chunks)
                    status = status.masked_fill(stalled, MAX_ITER)
                    done = done | stalled
                best_rp = torch.minimum(cy.best_rp, rp)
                best_rd = torch.minimum(cy.best_rd, rd)

                minv = cy.minv
                if settings.adaptive_rho:
                    num = rp / rp_rel.clamp(min=1e-10)
                    den = (rd / rd_rel.clamp(min=1e-10)).clamp(min=1e-10)
                    ratio = torch.sqrt(num / den)
                    tol = settings.adaptive_rho_tol
                    trig = ((ratio > tol) | (ratio < 1.0 / tol)) & ~done
                    if nc % adapt_stride:
                        trig = torch.zeros_like(trig)
                    new_scale = torch.where(trig, rho_scale * ratio, rho_scale)
                    new_scale = new_scale.clamp(rho_lo, rho_hi)
                    any_trig, n_live = host_read(torch.stack(
                        [trig.any().long(), (~done).sum()]))
                    if any_trig:
                        minv = ns_refresh(minv, new_scale, trig)
                    rho_scale = new_scale
                else:
                    n_live = host_read((~done).sum())

                done_chunk = cy.done_chunk.masked_fill(done & ~cy.done, nc)
                cy = _PCarry(x, y, z, rp, rd, done, status, minv, rho_scale,
                             best_rp, best_rd, last_prog, done_chunk)
                chunk = nc
        return cy, chunk, n_live

    # overtime cascade widths: halve from B/2 down to ~B/overtime_div
    # (tile-rounded, strictly decreasing); empty = no compaction
    widths = []
    if settings.overtime_div and settings.overtime_div > 1:
        target = max(bt, B // settings.overtime_div)
        w = B // 2
        while w >= target and w >= bt:
            wq = -(-w // bt) * bt
            if 0 < wq <= B // 2 and (not widths or wq < widths[-1]):
                widths.append(wq)
            w //= 2

    rp0 = torch.full((B,), torch.inf, dtype=dt, device=dev)
    zi = torch.zeros((B,), dtype=torch.int64, device=dev)
    cy = _PCarry(
        x=xbar0, y=ybar0, z=zbar0, rp=rp0, rd=rp0, done=~active,
        status=torch.zeros((B,), dtype=torch.int32, device=dev),
        minv=minv0, rho_scale=state.rho_scale, best_rp=rp0, best_rd=rp0,
        last_prog=zi, done_chunk=zi)
    cy, chunk, n_live = run_loop(cy, 0, coef, qbar, lbar, ubar, bt,
                                 stop_at=widths[0] if widths else None)

    for li, w in enumerate(widths):
        if n_live == 0:
            break
        next_stop = widths[li + 1] if li + 1 < len(widths) else None
        # stragglers first (stable: done=False rows in problem order); the
        # previous lane stops only once they fit, so idx covers every live
        # row (at the iteration cap the leftovers finish as MAX_ITER)
        idx = torch.argsort(cy.done.to(torch.int32), stable=True)[:w]
        sub = _PCarry(*(v[idx] for v in cy))
        sub, chunk, n_live_sub = run_loop(
            sub, chunk, coef[idx], qbar[idx], lbar[idx], ubar[idx],
            _tile_width(w, settings.pallas_tile), stop_at=next_stop)
        merged = []
        for full, part in zip(cy, sub):
            full = full.clone()
            full[idx] = part
            merged.append(full)
        cy = _PCarry(*merged)
        n_live = host_read((~cy.done).sum())

    done_chunk = torch.where(active & (cy.done_chunk == 0), chunk,
                             cy.done_chunk)
    status = torch.where(cy.done, cy.status, MAX_ITER).to(torch.int32)
    # the rho the inverse now reflects; NaN-mark MAX_ITER rows so that the
    # next solve refreshes their inverse
    ref_out = ref0.clone()
    ref_out[:, 3] = cy.rho_scale
    ref_out = torch.where((status == MAX_ITER)[:, None], torch.nan, ref_out)
    zeros = torch.zeros((B,), dtype=dt, device=dev)
    return ADMMResult(
        x=prob.D * cy.x,
        status=status,
        iters=chunk * settings.check_every,
        pri_res=cy.rp,
        dua_res=cy.rd,
        state=ADMMState(xbar=cy.x, ybar=cy.y, zbar=cy.z,
                        rho_scale=cy.rho_scale, minv=cy.minv,
                        minv_ok=torch.ones((), dtype=torch.bool, device=dev),
                        ref_coef=ref_out),
        done_iters=(done_chunk * settings.check_every).to(torch.int32),
        pri_tol=zeros,
        dua_tol=zeros,
    )
