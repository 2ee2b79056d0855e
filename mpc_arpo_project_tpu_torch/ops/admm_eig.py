"""Shared-basis ('eig') ADMM chunk and Woodbury inner-inverse refresh.

Counterpart of ``mpc_arpo_project_tpu/ops/admm_eig.py`` (the factorization
is documented there). Three pieces:

* ``eig_chunk_ref`` — the plain torch twin of the Pallas kernel
  ``_eig_chunk_kernel`` (with ``with_s=True``, the only form the solver
  uses): ``n_iter`` fused OSQP iterations with the exact per-combo
  eigenbasis solve and the rank-K debris Woodbury correction, then the
  scaled residuals and the Farkas certificates of the chunk.
* ``eig_chunk`` — the dispatching wrapper. A CPU tensor goes to the twin;
  a CUDA tensor goes to the hand-written kernel ``csrc/eig_chunk.cu``
  (built with nvcc at first use) or the call raises. Done rows are passed
  through with zero stats, per problem, in both versions. The kernel runs
  a thread-block cluster of C blocks for each live slot (narrow fp32
  calls) or groups of S slots per block; ``eig_layout`` picks the layout
  from the call's live count.
* ``tinv_refresh`` / ``tinv_safe_refresh`` — batched Newton–Schulz refresh
  of each problem's T⁻¹; plain batched matmuls, as the JAX package computes
  them in XLA.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from mpc_arpo_project_tpu_torch.ops import _build
from mpc_arpo_project_tpu_torch.utils.timing import host_read, span


# ---------------------------------------------------------------------------
# fused ADMM chunk: plain twin
# ---------------------------------------------------------------------------

def _chunk_rows(Ac, W, YT, tinv, scal, qbar, lbar, ubar, dg, x, y, z, pbar,
                K1, w33row, gsel, scat, rsel, gscat, rho_vec, einv, dinv,
                wuu_row, dmask, *, n_iter, sigma, alpha, eps_pinf, eps_dinf,
                pinf_margin):
    """The chunk math of ``_eig_chunk_kernel`` on rows sharing one combo
    (row form: vectors are rows, as in the JAX kernel)."""
    r = scal[:, 0:1]
    s = scal[:, 1:2]
    al = scal[:, 2:3]
    al = torch.where(al == 0.0, 1.0, al)
    alsq = al * al
    rs = r * alsq * s
    rss = r * alsq * s * s
    ruu = r * (alsq - 1.0)
    als = al * s
    rho = r * rho_vec[None, :]
    rowsc = 1.0 + (al - 1.0) * dmask

    def matvec_A(xv):
        return (xv @ Ac.T) * rowsc + (als * (xv @ gsel)) @ scat

    def matvec_AT(wv):
        h = wv @ rsel
        return (wv * rowsc) @ Ac + (als * h) @ gscat

    def solve_M(v):
        u = v @ W
        d = u * dg
        a = d @ YT.T
        t = torch.bmm(a[:, None, :], tinv)[:, 0]
        h = rs * (t @ K1) + rss * (t * w33row) + ruu * (t * wuu_row)
        e = h @ YT
        return ((u - e) * dg) @ W.T

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
    stats = chunk_certificates(x, y, z, x - x0, y - y0, qbar, lbar, ubar,
                               matvec_A, matvec_AT, pbar, einv, dinv,
                               eps_pinf=eps_pinf, eps_dinf=eps_dinf,
                               pinf_margin=pinf_margin)
    return x, y, z, stats


def chunk_certificates(x, y, z, dx, dy, qbar, lbar, ubar, matvec_A,
                       matvec_AT, pbar, einv, dinv, *, eps_pinf, eps_dinf,
                       pinf_margin):
    """End-of-chunk scaled residuals and Farkas certificates of a row block,
    in the JAX kernels' float-mask arithmetic: stats (rows, 8) = rp,
    rp_rel, rd, rd_rel, pinf, dinf, ||dy||_inf, ||dx||_inf. Shared by the
    'eig' and the 'pallas' chunk twins, which differ only in their A
    matvecs."""
    amax = lambda a: torch.amax(a, dim=1)
    Ax = matvec_A(x)
    rp = amax((einv * (Ax - z)).abs())
    rp_rel = torch.maximum(amax((einv * Ax).abs()), amax((einv * z).abs()))
    Px = x @ pbar
    Aty = matvec_AT(y)
    rd = amax((dinv * (Px + qbar + Aty)).abs())
    rd_rel = torch.maximum(
        amax((dinv * Px).abs()),
        torch.maximum(amax((dinv * Aty).abs()), amax((dinv * qbar).abs())))

    uinf = (~torch.isfinite(ubar)).to(x.dtype)
    linf = (~torch.isfinite(lbar)).to(x.dtype)
    ucap = torch.where(torch.isfinite(ubar), ubar, 0.0)
    lcap = torch.where(torch.isfinite(lbar), lbar, 0.0)
    both = uinf * linf
    uo = uinf * (1.0 - linf)
    lo = linf * (1.0 - uinf)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    v = dy * (1.0 - both)
    v = v * (1.0 - uo) + torch.minimum(v, zero) * uo
    v = v * (1.0 - lo) + torch.maximum(v, zero) * lo
    nv = amax(v.abs())
    atv_n = amax(matvec_AT(v).abs())
    sup = ((ucap * torch.maximum(v, zero)).sum(1)
           + (lcap * torch.minimum(v, zero)).sum(1))
    thresh = max(eps_pinf, pinf_margin)
    pos = lambda a: torch.clamp(torch.sign(a), min=0.0)
    pinf = (pos(eps_pinf * nv - atv_n) * pos(-thresh * nv - sup)
            * pos(nv - eps_pinf))

    nvx = amax(dx.abs())
    pdx_n = amax((dx @ pbar).abs())
    qv = (qbar * dx).sum(1)
    Adx = matvec_A(dx)
    eps_b = eps_dinf * nvx[:, None]
    up_viol = amax(torch.maximum(Adx - eps_b, zero) * (1.0 - uinf))
    lo_viol = amax(torch.maximum(-eps_b - Adx, zero) * (1.0 - linf))
    dinf = (pos(eps_dinf * nvx - pdx_n) * pos(-eps_dinf * nvx - qv)
            * (1.0 - torch.sign(up_viol)) * (1.0 - torch.sign(lo_viol))
            * pos(nvx - eps_dinf))
    return torch.stack([rp, rp_rel, rd, rd_rel, pinf, dinf, nv, nvx], 1)


def _defaults(x, m, K, wuu_row, dmask, done):
    kw = dict(dtype=x.dtype, device=x.device)
    if wuu_row is None:
        wuu_row = torch.zeros((1, K), **kw)
    if dmask is None:
        dmask = torch.zeros((1, m), **kw)
    if done is None:
        done = torch.zeros((x.shape[0],), dtype=torch.bool, device=x.device)
    return wuu_row, dmask, done


def eig_chunk_ref(
    tile_combo, tinv, scal, qbar, lbar, ubar, dg, x, y, z,
    Ast, Wst, YTst, pbar, K1, w33row, gsel_s, scat_s, rsel_s, gscat_s,
    rho_vec, einv, dinv, *, n_iter: int, sigma: float, alpha: float,
    eps_pinf: float, eps_dinf: float, pinf_margin: float, bt: int = 32,
    done=None, wuu_row=None, dmask=None,
):
    """Plain torch twin of the chunk kernel: same arguments and outputs as
    ``eig_chunk``. Each problem slot reads its combo from
    ``tile_combo[slot // bt]``; the rows of one combo go through shared
    matmuls together (a fixed row count per combo, so a row's result does
    not depend on where compaction put it). Done rows pass through with
    zero stats."""
    B, nz = x.shape
    m, K = y.shape[1], tinv.shape[1]
    wuu_row, dmask, done = _defaults(x, m, K, wuu_row, dmask, done)
    combo = tile_combo.long().repeat_interleave(bt)
    xo, yo, zo = x.clone(), y.clone(), z.clone()
    stats = torch.zeros((B, 8), dtype=x.dtype, device=x.device)
    for c in range(Ast.shape[0]):
        rows = torch.nonzero(combo == c).squeeze(1)
        if rows.numel() == 0:
            continue
        xr, yr, zr, st = _chunk_rows(
            Ast[c], Wst[c], YTst[c], tinv[rows], scal[rows], qbar[rows],
            lbar[rows], ubar[rows], dg[rows], x[rows], y[rows], z[rows],
            pbar, K1, w33row, gsel_s, scat_s, rsel_s, gscat_s, rho_vec,
            einv, dinv, wuu_row, dmask, n_iter=n_iter, sigma=sigma,
            alpha=alpha, eps_pinf=eps_pinf, eps_dinf=eps_dinf,
            pinf_margin=pinf_margin)
        xo[rows], yo[rows], zo[rows], stats[rows] = xr, yr, zr, st
    keep = done[:, None]
    return (torch.where(keep, x, xo), torch.where(keep, y, yo),
            torch.where(keep, z, zo), torch.where(keep, 0.0, stats))


# ---------------------------------------------------------------------------
# fused ADMM chunk: dispatching wrapper and the CUDA kernel
# ---------------------------------------------------------------------------

# slots per block of the CUDA kernel: 8 slots' vectors (~25 KB each in
# fp32) fit the 227 KB of shared memory a block can hold; in fp64 (~50 KB
# each) 4 would, but 4 fp64 slots' registers spill, so 2
GROUP_CAP = {torch.float32: 8, torch.float64: 2}
# one block per SM of an H100: the groups of a chunk should fill one wave
GROUPS_PER_CARD = 132


def eig_group(n_live: int, bt: int, dtype) -> int:
    """Slots per block S for a chunk with ``n_live`` running slots in tiles
    of ``bt``: the smallest power of two whose groups, with one partial
    group in each of the four combos, fit one wave of ``GROUPS_PER_CARD``
    blocks; within ``GROUP_CAP[dtype]`` and dividing ``bt``. A block
    iterates slower the more slots it holds (chip_smoke's sweep over S and
    live counts), so S grows only when another wave would start. Pure: the
    live count comes from a host read the solver makes anyway. In fp32
    ``eig_layout`` gives calls of up to ``CLUSTER_WAVES`` waves of clusters
    to the cluster layout, so there S serves only the wider calls."""
    cap = GROUP_CAP[dtype]
    S = 1
    while (2 * S <= cap and bt % (2 * S) == 0
           and -(-n_live // S) + 4 > GROUPS_PER_CARD):
        S *= 2
    return S


# cluster sizes C of the kernel's cluster layout, C blocks a live slot
# (fp32 only: fp64 keeps its slot groups)
CLUSTERS = {torch.float32: (2, 4, 8, 16), torch.float64: ()}
# the smallest cluster stays ahead of the slot groups while its clusters
# fill at most this many waves (the sweep of PERF.md section 6: clusters of
# 2 at 330 live slots, five waves, 4.00 ms against 4.80 for the fastest
# group)
CLUSTER_WAVES = 5


def eig_layout(n_live: int, bt: int, dtype, waves):
    """Layout (C, S) of the CUDA kernel for a chunk with ``n_live`` running
    slots in tiles of ``bt``: the largest cluster size C whose clusters,
    one a live slot, fit one wave of the card; else the smallest whose
    clusters fit ``CLUSTER_WAVES`` waves; else ``eig_group``'s slots per
    block, as (1, S). ``waves`` maps each cluster size to the clusters a
    wave holds, 0 where the size does not fit (the card's: ``_waves``).
    Pure: the live count comes from a host read the solver makes anyway."""
    sizes = sorted(C for C in CLUSTERS[dtype] if waves.get(C, 0) > 0)
    if n_live > 0:
        for C in reversed(sizes):
            if n_live <= waves[C]:
                return (C, 1)
        if sizes and n_live <= CLUSTER_WAVES * waves[sizes[0]]:
            return (sizes[0], 1)
    return (1, eig_group(n_live, bt, dtype))


def eig_chunk(
    tile_combo, tinv, scal, qbar, lbar, ubar, dg, x, y, z,
    Ast, Wst, YTst, pbar, K1, w33row, gsel_s, scat_s, rsel_s, gscat_s,
    rho_vec, einv, dinv, *, n_iter: int, sigma: float, alpha: float,
    eps_pinf: float, eps_dinf: float, pinf_margin: float, bt: int = 32,
    done=None, wuu_row=None, dmask=None, n_live: Optional[int] = None,
    layout=None,
):
    """Run ``n_iter`` fused ADMM iterations with the shared-basis solve.

    Shapes as the JAX package's ``eig_chunk``: tile_combo (B//bt,) int32;
    tinv (B,K,K); scal (B,8) [rho_scale, s, alpha, 0...]; qbar/x/dg (B,nz);
    lbar/ubar/y/z (B,m); Ast (4,m,nz); Wst (4,nz,nz); YTst (4,K,nz); pbar
    (nz,nz); K1 (K,K) block swap; w33row/wuu_row (1,K); gsel_s (nz,gw);
    scat_s (gw,m); rsel_s (m,gw); gscat_s (gw,nz); rho_vec/einv (m,); dinv
    (nz,); dmask (1,m); done (B,) bool. Returns (x, y, z, stats) with stats
    (B,8) = rp, rp_rel, rd, rd_rel, pinf, dinf, ‖Δy‖∞, ‖Δx‖∞.

    CPU tensors run ``eig_chunk_ref``; CUDA tensors run the CUDA kernel and
    count one launch in ``eig_chunk.launches``; anything else raises.

    ``n_live`` (the count of not-done slots, None: all B) picks the
    kernel's layout, ``eig_layout(n_live, bt, dtype, waves)``: a cluster
    of C blocks for each live slot, whose grid covers ``n_live`` slots (a
    live slot beyond them gets NaN x, y, z and stats), or groups of S slots
    a block. ``layout`` forces (C, S): (C, 1) with C one of
    ``CLUSTERS[dtype]``, or (1, S) with S a power of two up to
    ``GROUP_CAP[dtype]`` that divides ``bt``. Neither moves a bit of the
    result. The twin ignores both."""
    kw = dict(n_iter=n_iter, sigma=sigma, alpha=alpha, eps_pinf=eps_pinf,
              eps_dinf=eps_dinf, pinf_margin=pinf_margin, bt=bt, done=done,
              wuu_row=wuu_row, dmask=dmask)
    args = (tile_combo, tinv, scal, qbar, lbar, ubar, dg, x, y, z, Ast, Wst,
            YTst, pbar, K1, w33row, gsel_s, scat_s, rsel_s, gscat_s,
            rho_vec, einv, dinv)
    if x.device.type == "cpu":
        return eig_chunk_ref(*args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"eig_chunk: no kernel for device {x.device}")
    with span("kernel.eig_chunk"):
        return _eig_chunk_cuda(*args, n_live=n_live, layout=layout, **kw)


eig_chunk.launches = 0

_CUDA_SOURCES = ("eig_chunk.cu",)
_C_TYPES = {torch.float32: "f32", torch.float64: "f64"}


def _lib():
    lib = _build.load_library("eig_chunk", _CUDA_SOURCES)
    if not getattr(lib, "_eig_chunk_typed", False):
        P, I, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
        for suffix in _C_TYPES.values():
            fn = getattr(lib, f"eig_chunk_{suffix}")
            fn.argtypes = [P] * 29 + [I] * 8 + [D] * 5 + [P]
            fn.restype = I
        lib.eig_cluster_f32.argtypes = ([P] * 29 + [I] * 11 + [P] + [D] * 5
                                        + [P])
        lib.eig_cluster_f32.restype = I
        lib.eig_cluster_shape.argtypes = [I] * 5 + [P] * 3 + [I]
        lib.eig_cluster_shape.restype = I
        lib._eig_chunk_typed = True
    return lib


_shape_cache: dict = {}


def _cluster_shapes(dt, nz, m, K, gw, device):
    """The cluster layouts of ``CLUSTERS[dt]`` at these shapes on
    ``device``, asked of the card once per (type, shape, device): the
    clusters of each size one wave holds (0 where a size does not fit), and
    for each size the block's shared-memory bytes and its matrix shares'
    offsets, which its launches pass on."""
    key = (dt, nz, m, K, gw, device)
    if key not in _shape_cache:
        waves, plans = {}, {}
        with torch.cuda.device(device):
            for C in CLUSTERS[dt]:
                n, smem = ctypes.c_int(0), ctypes.c_int(0)
                moff = (ctypes.c_int * 16)()
                err = _lib().eig_cluster_shape(
                    C, nz, m, K, gw, ctypes.addressof(n),
                    ctypes.addressof(smem), ctypes.addressof(moff), len(moff))
                waves[C] = n.value if err == 0 else 0
                plans[C] = (smem.value, ctypes.addressof(moff), moff)
        _shape_cache[key] = (waves, plans)
    return _shape_cache[key]


def _waves(dt, nz, m, K, gw, device):
    """Clusters of each size of ``CLUSTERS[dt]`` one wave of ``device``
    holds at these shapes (0 where a size does not fit)."""
    return _cluster_shapes(dt, nz, m, K, gw, device)[0]


def _eig_chunk_cuda(
    tile_combo, tinv, scal, qbar, lbar, ubar, dg, x, y, z,
    Ast, Wst, YTst, pbar, K1, w33row, gsel_s, scat_s, rsel_s, gscat_s,
    rho_vec, einv, dinv, *, n_iter, sigma, alpha, eps_pinf, eps_dinf,
    pinf_margin, bt, done, wuu_row, dmask, n_live, layout,
):
    B, nz = x.shape
    m, K = y.shape[1], tinv.shape[1]
    gw = gsel_s.shape[1]
    wuu_row, dmask, done = _defaults(x, m, K, wuu_row, dmask, done)
    dt = x.dtype
    if dt not in _C_TYPES:
        raise TypeError(f"eig_chunk: CUDA kernel takes float32 or float64, "
                        f"not {dt}")
    if K != 2 * gw:
        raise ValueError(f"eig_chunk: K={K} must be 2*gw={2 * gw} (K1 is the "
                         "block swap of two gw-halves)")
    if B % bt:
        raise ValueError(f"eig_chunk: B={B} is not a multiple of bt={bt}")
    if nz > 256:
        raise ValueError(f"eig_chunk: nz={nz} > 256 (the kernel keeps a "
                         "row's vector in eight registers per lane)")
    n_combo = Ast.shape[0]
    shapes = dict(
        tile_combo=(tile_combo, (B // bt,), torch.int32),
        tinv=(tinv, (B, K, K), dt), scal=(scal, (B, 8), dt),
        qbar=(qbar, (B, nz), dt), lbar=(lbar, (B, m), dt),
        ubar=(ubar, (B, m), dt), dg=(dg, (B, nz), dt), x=(x, (B, nz), dt),
        y=(y, (B, m), dt), z=(z, (B, m), dt), done=(done, (B,), torch.bool),
        Ast=(Ast, (n_combo, m, nz), dt), Wst=(Wst, (n_combo, nz, nz), dt),
        YTst=(YTst, (n_combo, K, nz), dt), pbar=(pbar, (nz, nz), dt),
        K1=(K1, (K, K), dt), w33row=(w33row, (1, K), dt),
        gsel_s=(gsel_s, (nz, gw), dt), scat_s=(scat_s, (gw, m), dt),
        rsel_s=(rsel_s, (m, gw), dt), gscat_s=(gscat_s, (gw, nz), dt),
        rho_vec=(rho_vec, (m,), dt), einv=(einv, (m,), dt),
        dinv=(dinv, (nz,), dt), wuu_row=(wuu_row, (1, K), dt),
        dmask=(dmask, (1, m), dt),
    )
    for name, (t, shape, tdt) in shapes.items():
        if t.device != x.device:
            raise ValueError(f"eig_chunk: {name} is on {t.device}, x on "
                             f"{x.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"eig_chunk: {name} has shape {tuple(t.shape)},"
                             f" expected {shape}")
        if t.dtype != tdt:
            raise TypeError(f"eig_chunk: {name} is {t.dtype}, expected {tdt}")
        if not t.is_contiguous():
            raise ValueError(f"eig_chunk: {name} is not contiguous")
    n_grid = B if n_live is None else int(n_live)
    if not 0 <= n_grid <= B:
        raise ValueError(f"eig_chunk: n_live={n_live} for {B} slots")
    waves, plans = (_cluster_shapes(dt, nz, m, K, gw, x.device)
                    if CLUSTERS[dt] else ({}, {}))
    if layout is None:
        layout = eig_layout(n_grid, bt, dt, waves)
    C, group = layout
    if C != 1 and (C not in CLUSTERS[dt] or group != 1):
        raise ValueError(f"eig_chunk: layout {layout}: a cluster takes C in "
                         f"{CLUSTERS[dt]} for {dt}, one slot each")
    if group not in (1, 2, 4, 8) or group > GROUP_CAP[dt] or bt % group:
        raise ValueError(f"eig_chunk: layout {layout}: S={group} slots per "
                         f"group must be a power of two up to "
                         f"{GROUP_CAP[dt]} for {dt} that divides bt={bt}")
    xo = torch.empty_like(x)
    yo = torch.empty_like(y)
    zo = torch.empty_like(z)
    stats = torch.empty((B, 8), dtype=dt, device=x.device)
    ptrs = [t.data_ptr() for t in (
        tile_combo, tinv, scal, qbar, lbar, ubar, dg, x, y, z, done,
        Ast, Wst, YTst, pbar, w33row, gsel_s, scat_s, rsel_s, gscat_s,
        rho_vec, einv, dinv, wuu_row, dmask, xo, yo, zo, stats)]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    floats = (float(sigma), float(alpha), float(eps_pinf), float(eps_dinf),
              float(max(eps_pinf, pinf_margin)))
    with torch.cuda.device(x.device):
        if C > 1:
            # a wave of clusters at least: those past the live slots copy
            # the done slots through beside them
            smem, moff, _ = plans[C]
            err = _lib().eig_cluster_f32(*ptrs, B, nz, m, K, gw, bt, n_iter,
                                         C, n_grid, max(n_grid, 1, waves[C]),
                                         smem, moff, *floats, stream)
        else:
            fn = getattr(_lib(), f"eig_chunk_{_C_TYPES[dt]}")
            err = fn(*ptrs, B, nz, m, K, gw, bt, n_iter, group, *floats,
                     stream)
    if err != 0:
        raise RuntimeError(f"eig_chunk: CUDA kernel launch failed "
                           f"(cudaError {err})")
    eig_chunk.launches += 1
    return xo, yo, zo, stats


# ---------------------------------------------------------------------------
# Woodbury inner-inverse refresh: T = I + C(r,s) G,  G = Y' diag(dg) Y
# ---------------------------------------------------------------------------

def tinv_refresh(combo_row, scal, dg, X_prev, need, YTst, w33col, *,
                 n_iter: int, cold: bool, wuucol=None):
    """Masked per-problem Newton–Schulz refresh of T⁻¹ (rows with
    need=False pass through and report residual 0); ``combo_row`` is the
    per-row combo, so any row subset is valid. Returns (X, residual)."""
    K = X_prev.shape[1]
    half = K // 2
    YTg = YTst[combo_row]  # (B, K, nz)
    al = torch.where(scal[:, 2] == 0.0, 1.0, scal[:, 2])
    alsq = (al * al)[:, None, None]
    rs = (scal[:, 0] * scal[:, 1])[:, None, None] * alsq
    rss = (scal[:, 0] * scal[:, 1] ** 2)[:, None, None] * alsq
    ruu = scal[:, 0][:, None, None] * (alsq - 1.0)
    G = torch.matmul(YTg * dg[:, None, :], YTg.transpose(1, 2))
    Gsw = torch.cat([G[:, half:], G[:, :half]], 1)
    eye = torch.eye(K, dtype=X_prev.dtype, device=X_prev.device)
    T = eye[None] + rs * Gsw + rss * (w33col[None] * G)
    if wuucol is not None:
        T = T + ruu * (wuucol[None] * G)
    if cold:
        n1 = T.abs().sum(1).amax(1)
        ninf = T.abs().sum(2).amax(1)
        X = T.transpose(1, 2) / (n1 * ninf)[:, None, None]
    else:
        X = X_prev
    for _ in range(n_iter):
        X = torch.matmul(X, 2.0 * eye[None] - torch.matmul(T, X))
    res = (eye[None] - torch.matmul(T, X)).abs().amax((1, 2))
    X_out = torch.where(need[:, None, None], X, X_prev)
    return X_out, torch.where(need, res, 0.0)


def tinv_safe_refresh(combo_row, scal, dg, X_prev, need, YTst, w33col, *,
                      warm_iters: int, cold_iters: int, wuucol=None,
                      cold_cap: int = 0):
    """Warm refresh with cold restarts for rows whose warm residual is bad
    (> 1e-2 or non-finite); bad rows are zeroed before the cold retry.
    ``cold_cap`` > 0 compacts the retry to that many bad-first rows when
    they fit (bit-identical to the full-width retry)."""
    Xw, r = tinv_refresh(combo_row, scal, dg, X_prev, need, YTst, w33col,
                         n_iter=warm_iters, cold=False, wuucol=wuucol)
    bad = need & ((r > 1e-2) | ~torch.isfinite(r))
    Xw = torch.where(bad[:, None, None], 0.0, Xw)
    n_bad = host_read(bad.sum())
    if n_bad == 0:
        return Xw

    def cold_rows(cr, sc, dgr, xr, br):
        return tinv_refresh(cr, sc, dgr, xr, br, YTst, w33col,
                            n_iter=cold_iters, cold=True, wuucol=wuucol)[0]

    n = combo_row.shape[0]
    if cold_cap <= 0 or cold_cap >= n or n_bad > cold_cap:
        return cold_rows(combo_row, scal, dg, Xw, bad)
    idx = torch.argsort((~bad).to(torch.int32), stable=True)[:cold_cap]
    out = Xw.clone()
    out[idx] = cold_rows(combo_row[idx], scal[idx], dg[idx], Xw[idx],
                         bad[idx])
    return out
