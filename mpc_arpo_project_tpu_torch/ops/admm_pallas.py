"""'pallas'-mode ADMM chunk and the Newton–Schulz inverse maintenance.

Counterpart of ``mpc_arpo_project_tpu/ops/admm_pallas.py`` (the rationale
of the fused chunk and of the inverse maintenance is documented there).
Three kernel entry points, each with a plain torch twin of the same math:

* ``admm_chunk`` / ``admm_chunk_ref`` — ``n_iter`` fused OSQP iterations
  whose solve applies each problem's dense approximate inverse Minv plus
  ``ir_steps`` refinement steps against the true normal matrix (built from
  the 7-term structured stack), then the scaled residuals and the Farkas
  certificates of the chunk (kernel: ``csrc/admm_chunk.cu``);
* ``ns_fused`` / ``ns_fused_ref`` — masked Newton–Schulz refresh
  X <- X(2I - MX) of each needy problem's inverse, with
  M_p = sum_j w[p, j] stack[j] built from the 7 shared matrices, warm or
  cold started, and the residual ||I - MX||_inf (kernel:
  ``csrc/ns_inverse.cu``);
* ``newton_schulz_inverse`` / ``newton_schulz_inverse_ref`` — the same
  iteration on a given per-problem M (second entry point of
  ``csrc/ns_inverse.cu``).

Dispatch, as in ``ops.admm_eig.eig_chunk``: a CPU tensor goes to the twin, a
CUDA tensor to the hand-written kernel (built with nvcc at first use), and
anything else raises; so does a wrong dtype, shape or stride, a failed build
or a refused launch. Each entry counts its kernel launches in
``<entry>.launches`` (one per call that reached the kernel).

What differs from the JAX package:

* no ``interpret`` and no ``precision``: every product here is full fp32 or
  fp64 FMA. ``two_limb`` is accepted and ignored: the TPU's two-limb bf16
  Minv apply is a trick for its matrix unit, and Hopper runs the fp32
  matvec;
* done rows (``admm_chunk``) and rows without need (``ns_fused``) pass
  through per problem, not per tile;
* rows without need pass through by select, where the JAX kernel blends
  ``nd*Xf + (1-nd)*X`` (which turns a non-finite X on either side into
  NaN). The two differ only where the JAX kernel gives NaN.

``masked_safe_refresh``, ``safe_inverse`` and ``cold_start_inverse`` are
plain torch around the entries, as in the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from mpc_arpo_project_tpu_torch.ops import _build, admm_eig
from mpc_arpo_project_tpu_torch.utils.timing import host_read


# ---------------------------------------------------------------------------
# fused ADMM chunk: plain twin
# ---------------------------------------------------------------------------

def _chunk_rows(minv, coef, qbar, lbar, ubar, rho, x, y, z, w7, a0, pbar,
                gsel, scat, rsel, gscat, stack7, einv, dinv, *, n_iter, sigma,
                alpha, eps_pinf, eps_dinf, pinf_margin, ir_steps):
    """The chunk math of ``_chunk_kernel`` on a block of rows (row form:
    vectors are rows, as in the JAX kernel)."""
    nz = x.shape[1]
    gw = gsel.shape[1] // 3
    rows = x.shape[0]
    # per-problem [c1 | c2 | s] weights over the 3*gw correction lanes
    wsel = torch.cat([coef[:, 1:2].expand(rows, gw),
                      coef[:, 2:3].expand(rows, gw),
                      coef[:, 3:4].expand(rows, gw)], 1)

    def matvec_A(xv):
        return xv @ a0.T + (wsel * (xv @ gsel)) @ scat

    def matvec_AT(wv):
        return wv @ a0 + (wsel * (wv @ rsel)) @ gscat

    def apply_minv(v):
        return torch.bmm(v[:, None, :], minv)[:, 0]

    def matvec_M(v):
        xs = v @ stack7
        acc = w7[:, 0:1] * xs[:, :nz]
        for t in range(1, 7):
            acc = acc + w7[:, t:t + 1] * xs[:, t * nz:(t + 1) * nz]
        return acc

    def solve_M(rhs):
        xt = apply_minv(rhs)
        for _ in range(ir_steps):
            xt = xt + apply_minv(rhs - matvec_M(xt))
        return xt

    x0, y0 = x, y
    for _ in range(n_iter):
        rhs = sigma * x - qbar + matvec_AT(rho * z - y)
        xt = solve_M(rhs)
        zt = matvec_A(xt)
        x_n = alpha * xt + (1.0 - alpha) * x
        z_tmp = alpha * zt + (1.0 - alpha) * z
        z_n = torch.minimum(torch.maximum(z_tmp + y / rho, lbar), ubar)
        y = y + rho * (z_tmp - z_n)
        x, z = x_n, z_n
    stats = admm_eig.chunk_certificates(
        x, y, z, x - x0, y - y0, qbar, lbar, ubar, matvec_A, matvec_AT, pbar,
        einv, dinv, eps_pinf=eps_pinf, eps_dinf=eps_dinf,
        pinf_margin=pinf_margin)
    return x, y, z, stats


def admm_chunk_ref(
    minv, coef, qbar, lbar, ubar, rho, x, y, z, w7,
    a0, pbar, gsel, scat, rsel, gscat, stack7, einv, dinv, *,
    n_iter: int, sigma: float, alpha: float, eps_pinf: float,
    eps_dinf: float, pinf_margin: float, bt: int = 8, ir_steps: int = 1,
    two_limb: bool = True, done=None,
):
    """Plain torch twin of the chunk kernel: same arguments and outputs as
    ``admm_chunk``. Done rows pass through with zero stats; the live rows
    go through shared batched matmuls together."""
    if done is None:
        done = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    xo, yo, zo = x.clone(), y.clone(), z.clone()
    stats = torch.zeros((x.shape[0], 8), dtype=x.dtype, device=x.device)
    rows = torch.nonzero(~done).squeeze(1)
    if rows.numel():
        out = _chunk_rows(
            minv[rows], coef[rows], qbar[rows], lbar[rows], ubar[rows],
            rho[rows], x[rows], y[rows], z[rows], w7[rows], a0, pbar, gsel,
            scat, rsel, gscat, stack7, einv, dinv, n_iter=n_iter,
            sigma=sigma, alpha=alpha, eps_pinf=eps_pinf, eps_dinf=eps_dinf,
            pinf_margin=pinf_margin, ir_steps=ir_steps)
        xo[rows], yo[rows], zo[rows], stats[rows] = out
    return xo, yo, zo, stats


# ---------------------------------------------------------------------------
# Newton–Schulz: plain twins
# ---------------------------------------------------------------------------

def _stack_matrix(stack, w):
    """M_p = sum_j w[p, j] stack[j], summed in the JAX kernel's order."""
    M = w[:, 0, None, None] * stack[0][None]
    for j in range(1, 7):
        M = M + w[:, j, None, None] * stack[j][None]
    return M


def _ns_iterate(M, X, n_iter):
    eye = torch.eye(M.shape[1], dtype=M.dtype, device=M.device)
    I2 = 2.0 * eye
    for _ in range(n_iter):
        X = torch.matmul(X, I2 - torch.matmul(M, X))
    res = (eye - torch.matmul(M, X)).abs().amax((1, 2))
    return X, res


def cold_start_inverse(M):
    """X0 = M' / (||M||_1 ||M||_inf): spectral-radius-safe NS start."""
    n1 = M.abs().sum(-2).amax(-1)
    ninf = M.abs().sum(-1).amax(-1)
    return (M.transpose(-1, -2) / (n1 * ninf)[:, None, None]).contiguous()


def ns_fused_ref(stack, w, X_prev, need, *, n_iter: int, cold: bool,
                 bt: int = 8):
    """Plain twin of ``ns_fused``. Only the needy rows are computed (each
    row's math is independent); the others pass through, residual 0."""
    res = torch.zeros((X_prev.shape[0],), dtype=X_prev.dtype,
                      device=X_prev.device)
    rows = torch.nonzero(need).squeeze(1)
    if rows.numel() == 0:
        return X_prev.clone(), res
    M = _stack_matrix(stack, w[rows])
    X0 = cold_start_inverse(M) if cold else X_prev[rows]
    Xf, r = _ns_iterate(M, X0, n_iter)
    out = X_prev.clone()
    out[rows] = Xf
    res[rows] = r
    return out, res


def newton_schulz_inverse_ref(M, X0, n_iter: int = 4, bt: int = 8):
    """Plain twin of ``newton_schulz_inverse``."""
    return _ns_iterate(M, X0, n_iter)


# ---------------------------------------------------------------------------
# dispatching entries
# ---------------------------------------------------------------------------

def _dispatch(name, x):
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {x.device}")
    return True


# layouts (cluster size C, slots per block S) of the CUDA kernel: a cluster
# of C blocks per slot, or S slots per block. Clusters of 4 were never the
# fastest by more than the sweep's noise (PERF.md section 6) and cost a
# build; in fp64 the Minv slice of a two-block cluster (256 KiB) does not
# fit a block's shared memory, nor do the vectors of eight slots (~400 KB),
# and four slots' registers would spill
LAYOUTS = {
    torch.float32: ((1, 1), (1, 2), (1, 4), (1, 8), (2, 1), (8, 1)),
    torch.float64: ((1, 1), (1, 2), (8, 1)),
}
# groups of each layout an NVIDIA H100 80GB HBM3 holds at once at the
# flagship's nz=256, m=512, gw=64 (cudaOccupancyMaxActiveClusters; blocks
# for C = 1): one wave. The kernel's wrapper asks the card itself
# (``_waves``); chip_smoke prints both.
WAVES = {
    torch.float32: {(1, 1): 528, (1, 2): 264, (1, 4): 264, (1, 8): 132,
                    (2, 1): 66, (8, 1): 30},
    torch.float64: {(1, 1): 264, (1, 2): 264, (8, 1): 15},
}


# a cluster layout stays ahead of the slot groups while its clusters fill
# at most this many waves (chip_smoke's sweep, PERF.md section 6: fp32
# clusters of 2 at 264 live slots, four waves; fp64 clusters of 8 at 66,
# five)
CLUSTER_WAVES = 5


def admm_layout(n_live: int, dtype, waves=None):
    """Layout (C, S) of the CUDA kernel for a chunk with ``n_live`` live
    slots: the largest cluster size C > 1 whose clusters (one a slot) fit
    one wave of the card; else the smallest whose clusters fit
    ``CLUSTER_WAVES`` waves; else the smallest slots-per-block S whose
    groups fit one wave; else the largest S that fits the card at all.
    ``waves`` maps each layout of ``LAYOUTS[dtype]`` to the groups one wave
    holds, 0 for one that does not fit (default ``WAVES[dtype]``). Pure:
    the live count comes from a host read the solver makes anyway."""
    waves = WAVES[dtype] if waves is None else waves
    lay = LAYOUTS[dtype]
    clusters = sorted(c for c, _ in lay if c > 1)
    for C in reversed(clusters):
        if n_live <= waves[(C, 1)]:
            return (C, 1)
    for C in clusters:
        if n_live <= CLUSTER_WAVES * waves[(C, 1)]:
            return (C, 1)
    groups = sorted(S for c, S in lay if c == 1 and waves[(1, S)] > 0)
    for S in groups:
        if -(-n_live // S) <= waves[(1, S)]:
            return (1, S)
    if not groups:
        raise ValueError(f"admm_chunk: no layout fits the card ({waves})")
    return (1, groups[-1])


def admm_chunk(
    minv, coef, qbar, lbar, ubar, rho, x, y, z, w7,
    a0, pbar, gsel, scat, rsel, gscat, stack7, einv, dinv, *,
    n_iter: int, sigma: float, alpha: float, eps_pinf: float,
    eps_dinf: float, pinf_margin: float, bt: int = 8, ir_steps: int = 1,
    two_limb: bool = True, done=None, n_live=None, layout=None,
):
    """Run ``n_iter`` fused ADMM iterations and the termination diagnostics.

    Shapes as the JAX package's ``admm_chunk``: minv (B,nz,nz); coef (B,4)
    [1, c1, c2, s]; qbar/x (B,nz); lbar/ubar/rho/y/z (B,m); w7 (B,8)
    structured weights [1, r, r c1, r c2, r c1 c2, r s, r s^2, 0]; a0
    (m,nz); pbar (nz,nz); gsel (nz,3gw); scat (3gw,m); rsel (m,3gw); gscat
    (3gw,nz); stack7 (nz,7nz); einv (m,); dinv (nz,); done (B,) bool.
    Returns (x, y, z, stats) with stats (B,8) = rp, rp_rel, rd, rd_rel,
    pinf, dinf, ||dy||_inf, ||dx||_inf. ``bt`` and ``two_limb`` are
    accepted for the JAX signature and have no effect.

    ``n_live`` (the count of not-done rows, None: B) sizes the kernel's
    grid, which covers the live rows only (a live row beyond it reads NaN),
    and picks its layout, ``admm_layout(n_live, dtype)``; ``layout`` forces
    one of ``LAYOUTS[dtype]``. Neither moves a bit of the result. The twin
    ignores both."""
    args = (minv, coef, qbar, lbar, ubar, rho, x, y, z, w7, a0, pbar, gsel,
            scat, rsel, gscat, stack7, einv, dinv)
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, eps_pinf=eps_pinf,
              eps_dinf=eps_dinf, pinf_margin=pinf_margin, ir_steps=ir_steps,
              done=done)
    if not _dispatch("admm_chunk", x):
        return admm_chunk_ref(*args, **kw)
    return _admm_chunk_cuda(*args, n_live=n_live, layout=layout, **kw)


admm_chunk.launches = 0


def ns_fused(stack, w, X_prev, need, *, n_iter: int, cold: bool,
             bt: int = 8, n_need=None):
    """Masked batched inverse refresh. stack (7,nz,nz) shared structure
    matrices; w (B,8) per-problem weights; X_prev (B,nz,nz); need (B,)
    bool. Returns (X, residual): rows with need=False pass through and
    read residual 0. ``cold`` starts from M'/(||M||_1 ||M||_inf) instead
    of X_prev. ``n_need``, the count of ``need`` where the caller knows it
    (None: B), sizes the kernel's grid and work buffers; a needy row beyond
    it reads NaN. The twin ignores it. ``bt`` has no effect."""
    if not _dispatch("ns_fused", X_prev):
        return ns_fused_ref(stack, w, X_prev, need, n_iter=n_iter, cold=cold)
    return _ns_cuda(ns_fused, stack, w, X_prev, need, n_iter, cold, n_need)


ns_fused.launches = 0


def newton_schulz_inverse(M, X0, n_iter: int = 4, bt: int = 8,
                          n_need=None):
    """Batched inverse refinement X <- X(2I - MX), ``n_iter`` times, on
    M, X0 (B,nz,nz). Returns (X, residual (B,) = ||I - MX||_inf). Every
    problem is needy, so ``n_need`` is None or B. ``bt`` has no effect."""
    if not _dispatch("newton_schulz_inverse", X0):
        return newton_schulz_inverse_ref(M, X0, n_iter)
    return _ns_cuda(newton_schulz_inverse, M, None, X0, None, n_iter, False,
                    n_need)


newton_schulz_inverse.launches = 0


def masked_safe_refresh(ns_stack, w, X_prev, need, *, warm_iters: int,
                        cold_iters: int, bt: int = 8, n_need=None):
    """Warm masked refresh; rows whose warm residual is bad (> 1e-2 or
    non-finite) are zeroed and cold-restarted (see the JAX package's
    ``masked_safe_refresh`` for why they are zeroed first). ``n_need``
    goes to the warm ``ns_fused``; the cold one gets the bad rows' count,
    read at the one host sync this function makes."""
    Xw, r = ns_fused(ns_stack, w, X_prev, need, n_iter=warm_iters,
                     cold=False, bt=bt, n_need=n_need)
    bad = need & ((r > 1e-2) | ~torch.isfinite(r))
    Xw = torch.where(bad[:, None, None], 0.0, Xw)
    n_bad = host_read(bad.sum())
    if not n_bad:
        return Xw
    return ns_fused(ns_stack, w, Xw, bad, n_iter=cold_iters, cold=True,
                    bt=bt, n_need=n_bad)[0]


def safe_inverse(M, X_prev, prev_ok, warm_iters: int, cold_iters: int,
                 bt: int = 8):
    """Warm-refresh the inverse of a given M; cold-restart the problems
    whose refreshed residual is bad."""
    Xw, r = newton_schulz_inverse(M, X_prev, n_iter=warm_iters, bt=bt)
    bad = (~prev_ok) | (r > 1e-2) | ~torch.isfinite(r)
    if not bool(bad.any()):
        return Xw
    Xc, _ = newton_schulz_inverse(M, cold_start_inverse(M),
                                  n_iter=cold_iters, bt=bt)
    return torch.where(bad[:, None, None], Xc, Xw)


# ---------------------------------------------------------------------------
# CUDA kernels: build, checks, launch
# ---------------------------------------------------------------------------

_C_TYPES = {torch.float32: "f32", torch.float64: "f64"}
_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SMS = 132  # streaming multiprocessors of an H100 SXM


def ns_tile(rows: int, n: int) -> int:
    """Output-tile rows of the Newton–Schulz GEMM (``csrc/ns_inverse.cu``)
    for a call on ``rows`` needy problems of size n: 128 (128x256 tiles in
    fp32, one block per SM; 128x64 in fp64) when those tiles give every SM
    of the card a block (rows * ceil(n/128) * ceil(n/256) >= 132: 66 rows
    at n=256), else 64 (64x64 tiles, several blocks per SM). The main
    path's refreshes hold at most 61 needy rows or at least 444 (PERF.md,
    sections 5 and 6)."""
    return 128 if rows * (-(-n // 128)) * (-(-n // 256)) >= _SMS else 64


# the chunk kernel's libraries, each with its own layouts (one nvcc each,
# so chip_smoke builds them side by side): name -> (source, C entry)
CHUNK_LIBS = {
    "admm_chunk": ("admm_chunk.cu", "admm_chunk_f32"),      # fp32, C = 1
    "admm_cluster": ("admm_cluster.cu", "admm_cluster_f32"),  # fp32, C > 1
    "admm_chunk_f64": ("admm_chunk_f64.cu", "admm_chunk_f64"),
}


def _chunk_lib(name):
    src, entry = CHUNK_LIBS[name]
    lib = _build.load_library(name, (src,))
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, entry)
        fn.argtypes = [_P] * 25 + [_I] * 9 + [_D] * 5 + [_P]
        fn.restype = _I
        cap = getattr(lib, f"{entry}_capacity")
        cap.argtypes = [_I] * 5 + [ctypes.POINTER(_I)]
        cap.restype = _I
        lib._typed = True
    return lib


def _chunk_fn(dt, C, capacity=False):
    """The C entry of the chunk kernel's library for type ``dt`` and
    cluster size C."""
    name = ("admm_chunk_f64" if dt == torch.float64
            else "admm_cluster" if C > 1 else "admm_chunk")
    entry = CHUNK_LIBS[name][1]
    return getattr(_chunk_lib(name),
                   f"{entry}_capacity" if capacity else entry)


_wave_cache: dict = {}


def _waves(dt, nz, m, gw, device):
    """The groups of each layout one wave of ``device`` holds (0 where the
    layout's shared memory does not fit these shapes), asked of the card
    once per (type, shape, device)."""
    key = (dt, nz, m, gw, device)
    if key not in _wave_cache:
        out = {}
        with torch.cuda.device(device):
            for C, S in LAYOUTS[dt]:
                n = _I(0)
                err = _chunk_fn(dt, C, capacity=True)(C, S, nz, m, gw,
                                                      ctypes.byref(n))
                out[(C, S)] = n.value if err == 0 else 0
        _wave_cache[key] = out
    return _wave_cache[key]


def _ns_lib():
    lib = _build.load_library("ns_inverse", ("ns_inverse.cu",))
    if not getattr(lib, "_typed", False):
        for suffix in _C_TYPES.values():
            fn = getattr(lib, f"ns_run_{suffix}")
            fn.argtypes = [_P] * 14 + [_I] * 6 + [_P]
            fn.restype = _I
        lib._typed = True
    return lib


def _check(name, ref, tensors):
    """Raise unless every (tensor, shape, dtype) sits on ``ref``'s device,
    with that shape and dtype, contiguous."""
    for tname, (t, shape, tdt) in tensors.items():
        if t.device != ref.device:
            raise ValueError(f"{name}: {tname} is on {t.device}, expected "
                             f"{ref.device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: {tname} has shape {tuple(t.shape)}, "
                             f"expected {tuple(shape)}")
        if t.dtype != tdt:
            raise TypeError(f"{name}: {tname} is {t.dtype}, expected {tdt}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {tname} is not contiguous")


def _dtype_of(name, t):
    if t.dtype not in _C_TYPES:
        raise TypeError(f"{name}: CUDA kernel takes float32 or float64, not "
                        f"{t.dtype}")
    return t.dtype


def _admm_chunk_cuda(minv, coef, qbar, lbar, ubar, rho, x, y, z, w7, a0,
                     pbar, gsel, scat, rsel, gscat, stack7, einv, dinv, *,
                     n_iter, sigma, alpha, eps_pinf, eps_dinf, pinf_margin,
                     ir_steps, done, n_live, layout):
    dt = _dtype_of("admm_chunk", x)
    B, nz = x.shape
    m = y.shape[1]
    gw3 = gsel.shape[1]
    if done is None:
        done = torch.zeros((B,), dtype=torch.bool, device=x.device)
    _check("admm_chunk", x, dict(
        minv=(minv, (B, nz, nz), dt), coef=(coef, (B, 4), dt),
        qbar=(qbar, (B, nz), dt), lbar=(lbar, (B, m), dt),
        ubar=(ubar, (B, m), dt), rho=(rho, (B, m), dt), x=(x, (B, nz), dt),
        y=(y, (B, m), dt), z=(z, (B, m), dt), w7=(w7, (B, 8), dt),
        a0=(a0, (m, nz), dt), pbar=(pbar, (nz, nz), dt),
        gsel=(gsel, (nz, gw3), dt), scat=(scat, (gw3, m), dt),
        rsel=(rsel, (m, gw3), dt), gscat=(gscat, (gw3, nz), dt),
        stack7=(stack7, (nz, 7 * nz), dt), einv=(einv, (m,), dt),
        dinv=(dinv, (nz,), dt), done=(done, (B,), torch.bool)))
    if gw3 % 3:
        raise ValueError(f"admm_chunk: gsel width {gw3} is not 3*gw")
    n_grid = B if n_live is None else int(n_live)
    if not 0 <= n_grid <= B:
        raise ValueError(f"admm_chunk: n_live={n_live} for {B} rows")
    if layout is None:
        layout = admm_layout(n_grid, dt,
                             _waves(dt, nz, m, gw3 // 3, x.device))
    elif tuple(layout) not in LAYOUTS[dt]:
        raise ValueError(f"admm_chunk: layout {layout} is not one of "
                         f"{LAYOUTS[dt]} ({dt})")
    C, S = layout
    fn = _chunk_fn(dt, C)
    xo, yo, zo = torch.empty_like(x), torch.empty_like(y), torch.empty_like(z)
    stats = torch.empty((B, 8), dtype=dt, device=x.device)
    # the live rows first, in row order (no host read)
    slots = torch.argsort(done.to(torch.int8), stable=True)[:n_grid].to(
        torch.int32)
    ptrs = [t.data_ptr() if t.numel() else 0 for t in (
        minv, coef, qbar, lbar, ubar, rho, x, y, z, w7, done, a0, pbar, gsel,
        scat, rsel, gscat, stack7, einv, dinv, xo, yo, zo, stats, slots)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = fn(*ptrs, B, n_grid, C, S, nz, m, gw3 // 3, n_iter, ir_steps,
                 float(sigma), float(alpha), float(eps_pinf),
                 float(eps_dinf), float(max(eps_pinf, pinf_margin)), stream)
    if err != 0:
        raise RuntimeError(f"admm_chunk: CUDA kernel launch failed "
                           f"(cudaError {err})")
    admm_chunk.launches += 1
    return xo, yo, zo, stats


def _ns_cuda(entry, mat, w, X_prev, need, n_iter, cold, n_need):
    """``ns_fused`` (mat = the (7,nz,nz) stack, w and need given) or
    ``newton_schulz_inverse`` (mat = the per-problem M, w = need = None)
    through the one C entry point of ``csrc/ns_inverse.cu``. The work
    buffers hold ``n_need`` slots (B when None)."""
    name = entry.__name__
    dt = _dtype_of(name, X_prev)
    B, nz = X_prev.shape[0], X_prev.shape[1]
    fused = w is not None
    specs = dict(X=(X_prev, (B, nz, nz), dt))
    if fused:
        specs.update(stack=(mat, (7, nz, nz), dt), w=(w, (B, 8), dt),
                     need=(need, (B,), torch.bool))
    else:
        specs.update(M=(mat, (B, nz, nz), dt))
    _check(name, X_prev, specs)
    if n_iter < 0:
        raise ValueError(f"{name}: n_iter={n_iter} < 0")
    cap = B if n_need is None else int(n_need)
    if not 0 <= cap <= B or (not fused and cap != B):
        raise ValueError(f"{name}: n_need={n_need} for {B} rows")
    fn = getattr(_ns_lib(), f"ns_run_{_C_TYPES[dt]}")
    kw = dict(dtype=dt, device=X_prev.device)
    out = torch.empty_like(X_prev)
    res = torch.empty((B,), **kw)
    work = torch.empty((4 if fused else 3, cap, nz, nz), **kw)
    mscr, w1, w2, tmp = ([work[0]] if fused else [None]) + list(work[-3:])
    # residual partials per slot: the 64x64 tile's count, the most of any
    partial = torch.empty((cap, (-(-nz // 64)) ** 2), **kw)
    denom = torch.empty((cap,), **kw)
    ibuf = torch.empty((2 * B + 1,), dtype=torch.int32, device=X_prev.device)
    ptr = lambda t: 0 if t is None or t.numel() == 0 else t.data_ptr()
    ptrs = [mat if fused else None, w, None if fused else mat, X_prev, need,
            out, res, mscr, w1, w2, tmp, partial, denom, ibuf]
    stream = torch.cuda.current_stream(X_prev.device).cuda_stream
    with torch.cuda.device(X_prev.device):
        err = fn(*map(ptr, ptrs), B, cap, nz, int(n_iter), int(bool(cold)),
                 int(ns_tile(cap, nz) == 128), stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed "
                           f"(cudaError {err})")
    entry.launches += 1
    return out, res
