// Fused 'pallas'-mode ADMM chunk, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mpc_arpo_project_tpu/ops/admm_pallas.py::_chunk_kernel
// and computes what its plain torch twin
//   mpc_arpo_project_tpu_torch/ops/admm_pallas.py::admm_chunk_ref
// computes: n_iter OSQP iterations of one problem slot,
//   rhs = sigma x - qbar + A'(rho z - y)
//   xt  = rhs Minv, then ir_steps refinements xt += (rhs - M xt) Minv with
//         M xt = sum_t w7[t] (xt stack7[:, t nz:(t+1) nz]) (the true normal
//         matrix from the 7-term structured stack)
//   zt  = A xt, where A v = A0 v + scat'(wsel * (gsel' v)) and wsel is the
//         slot's [c1 | c2 | s] over the 3 gw correction lanes
//   relaxation (alpha), clip to [lbar, ubar], y update
// then the scaled residuals and the Farkas pinf/dinf certificates of the
// chunk's accumulated dy, dx (the infinite-bound masks and capped bounds are
// formed here from lbar/ubar, as the JAX wrapper forms them on its side).
// Stats per slot: rp, rp_rel, rd, rd_rel, pinf, dinf, |dy|_inf, |dx|_inf. A
// done slot copies x, y, z through and writes zero stats (the caller
// discards every output of a done row).
//
// Design. One 256-thread block per problem slot. The slot's vectors (x,
// qbar and four nz temporaries; y, z, lbar, ubar, rho and two m
// temporaries; the 3 gw correction lanes) live in dynamic shared memory:
// ~25 KB in fp32, ~50 KB in fp64. The shared matrices (A0 m x nz, Pbar,
// gsel/scat/rsel/gscat, stack7 nz x 7nz: ~3.5 MiB in fp32) are read through
// L2 on every use; the slot's own Minv (nz x nz, 256 KiB in fp32) does not
// fit a block's 227 KB of shared memory, nor do 1024 of them (256 MiB) fit
// the 50 MB L2, so it streams from HBM on each apply: 1 + ir_steps times per
// iteration. All arithmetic is CUDA-core FMA in full fp32 or fp64 (reduced
// precision stalls this solver); v M products run in eight interleaved
// chains (block_ops.cuh).
//
// What bounds it. Per problem-iteration at nz=256, m=512, gw=64, ir_steps=1
// the chunk does ~1.15 M FMAs and reads as many matrix elements, so the
// FLOP bound of a full 1024-slot, 25-iteration chunk is ~0.9 ms on the
// H100's 67 TFLOP/s fp32 CUDA cores, while streaming Minv twice per
// iteration moves 13.4 GB from HBM, ~4.0 ms at 3.35 TB/s: that HBM stream
// is this design's floor. The shared matrices come from L2 with no reuse
// across slots, so L2 read bandwidth is the next limit. Several slots per
// block (each matrix read serving all of them) and Minv kept in registers
// across a block's slots are the next steps.

#include "block_ops.cuh"

namespace {

template <typename T>
struct Args {
  const T* minv;   // (B, nz, nz)
  const T* coef;   // (B, 4): 1, c1, c2, s
  const T* qbar;   // (B, nz)
  const T* lbar;   // (B, m)
  const T* ubar;   // (B, m)
  const T* rho;    // (B, m)
  const T* x;      // (B, nz)
  const T* y;      // (B, m)
  const T* z;      // (B, m)
  const T* w7;     // (B, 8)
  const unsigned char* done;  // (B,)
  const T* a0;     // (m, nz)
  const T* pbar;   // (nz, nz)
  const T* gsel;   // (nz, 3gw)
  const T* scat;   // (3gw, m)
  const T* rsel;   // (m, 3gw)
  const T* gscat;  // (3gw, nz)
  const T* stack7; // (nz, 7nz)
  const T* einv;   // (m,)
  const T* dinv;   // (nz,)
  T* xo;
  T* yo;
  T* zo;
  T* stats;        // (B, 8)
  int B, nz, m, gw, n_iter, ir_steps;
  T sigma, alpha, one_m_alpha, eps_pinf, eps_dinf, thresh;
};

// Per-slot view shared by the helpers below.
template <typename T>
struct Slot {
  const T* minv;  // the slot's Minv
  T c1, c2, s;
  T w7[7];
  T* g;     // 3 gw correction lanes
  T* part;  // kThreads scratch for vecmat
};

template <typename T>
__device__ __forceinline__ T lane_weight(const Slot<T>& s, int k, int gw) {
  return k < gw ? s.c1 : (k < 2 * gw ? s.c2 : s.s);
}

// out(m) = A0 xin + scat'(wsel * (gsel' xin))
template <typename T>
__device__ void apply_A(const Args<T>& a, const Slot<T>& s, const T* xin,
                        T* out) {
  const int gw3 = 3 * a.gw;
  matvec(a.a0, xin, out, a.m, a.nz);
  vecmat(a.gsel, xin, s.g, a.nz, gw3, s.part);
  for (int k = threadIdx.x; k < gw3; k += kThreads)
    s.g[k] = lane_weight(s, k, a.gw) * s.g[k];
  __syncthreads();
  for (int i = threadIdx.x; i < a.m; i += kThreads)
    out[i] = out[i] + dot_col(a.scat, a.m, i, s.g, 0, gw3);
  __syncthreads();
}

// out(nz) = A0' win + gscat'(wsel * (rsel' win))
template <typename T>
__device__ void apply_AT(const Args<T>& a, const Slot<T>& s, const T* win,
                         T* out) {
  const int gw3 = 3 * a.gw;
  vecmat(a.rsel, win, s.g, a.m, gw3, s.part);
  for (int k = threadIdx.x; k < gw3; k += kThreads)
    s.g[k] = lane_weight(s, k, a.gw) * s.g[k];
  __syncthreads();
  vecmat(a.a0, win, out, a.m, a.nz, s.part);
  for (int j = threadIdx.x; j < a.nz; j += kThreads)
    out[j] = out[j] + dot_col(a.gscat, a.nz, j, s.g, 0, gw3);
  __syncthreads();
}

// out(nz) = sum_t w7[t] (v stack_t): the true normal matrix times v.
template <typename T>
__device__ void apply_M(const Args<T>& a, const Slot<T>& s, const T* v,
                        T* out) {
  const int nz = a.nz, ld = 7 * nz;
  for (int j = threadIdx.x; j < nz; j += kThreads) {
    T acc = s.w7[0] * dot_col(a.stack7, ld, j, v, 0, nz);
#pragma unroll
    for (int t = 1; t < 7; ++t)
      acc = acc + s.w7[t] * dot_col(a.stack7, ld, t * nz + j, v, 0, nz);
    out[j] = acc;
  }
  __syncthreads();
}

// At most 64 registers a thread in fp32, so that four 256-thread blocks
// fit an SM (1024 slots take two waves of 528 instead of 2.6 of 396).
template <typename T>
__global__ void __launch_bounds__(kThreads, 16 / sizeof(T))
    admm_chunk_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = a.nz, m = a.m, tid = threadIdx.x;
  const int slot = blockIdx.x;
  const size_t onz = static_cast<size_t>(slot) * nz;
  const size_t om = static_cast<size_t>(slot) * m;

  if (a.done[slot]) {
    for (int j = tid; j < nz; j += kThreads) a.xo[onz + j] = a.x[onz + j];
    for (int i = tid; i < m; i += kThreads) {
      a.yo[om + i] = a.y[om + i];
      a.zo[om + i] = a.z[om + i];
    }
    if (tid < 8) a.stats[static_cast<size_t>(slot) * 8 + tid] = T(0);
    return;
  }

  T* sx = sm;
  T* sq = sx + nz;
  T* v1 = sq + nz;
  T* v2 = v1 + nz;
  T* v3 = v2 + nz;
  T* v4 = v3 + nz;
  T* sy = v4 + nz;
  T* sz = sy + m;
  T* slb = sz + m;
  T* sub = slb + m;
  T* srho = sub + m;
  T* sw = srho + m;
  T* sAx = sw + m;
  T* sg = sAx + m;
  T* part = sg + 3 * a.gw;
  T* red = part + kThreads;

  Slot<T> s;
  s.minv = a.minv + static_cast<size_t>(slot) * nz * nz;
  s.c1 = a.coef[slot * 4 + 1];
  s.c2 = a.coef[slot * 4 + 2];
  s.s = a.coef[slot * 4 + 3];
#pragma unroll
  for (int t = 0; t < 7; ++t) s.w7[t] = a.w7[slot * 8 + t];
  s.g = sg;
  s.part = part;

  for (int j = tid; j < nz; j += kThreads) {
    sx[j] = a.x[onz + j];
    sq[j] = a.qbar[onz + j];
  }
  for (int i = tid; i < m; i += kThreads) {
    sy[i] = a.y[om + i];
    sz[i] = a.z[om + i];
    slb[i] = a.lbar[om + i];
    sub[i] = a.ubar[om + i];
    srho[i] = a.rho[om + i];
  }
  __syncthreads();

  for (int it = 0; it < a.n_iter; ++it) {
    // rhs = sigma x - qbar + A'(rho z - y)  -> v3
    for (int i = tid; i < m; i += kThreads) sw[i] = srho[i] * sz[i] - sy[i];
    __syncthreads();
    apply_AT(a, s, sw, v1);
    for (int j = tid; j < nz; j += kThreads)
      v3[j] = (a.sigma * sx[j] - sq[j]) + v1[j];
    __syncthreads();

    // xt = rhs Minv, refined against the true M  -> v1
    vecmat(s.minv, v3, v1, nz, nz, part);
    for (int r = 0; r < a.ir_steps; ++r) {
      apply_M(a, s, v1, v2);
      for (int j = tid; j < nz; j += kThreads) v2[j] = v3[j] - v2[j];
      __syncthreads();
      vecmat(s.minv, v2, v4, nz, nz, part);
      for (int j = tid; j < nz; j += kThreads) v1[j] = v1[j] + v4[j];
      __syncthreads();
    }

    // zt = A xt; relaxation, clip, dual update
    apply_A(a, s, v1, sAx);
    for (int i = tid; i < m; i += kThreads) {
      const T ztmp = a.alpha * sAx[i] + a.one_m_alpha * sz[i];
      T zn = ztmp + sy[i] / srho[i];
      zn = pmin(pmax(zn, slb[i]), sub[i]);
      sy[i] = sy[i] + srho[i] * (ztmp - zn);
      sz[i] = zn;
    }
    for (int j = tid; j < nz; j += kThreads)
      sx[j] = a.alpha * v1[j] + a.one_m_alpha * sx[j];
    __syncthreads();
  }

  for (int j = tid; j < nz; j += kThreads) a.xo[onz + j] = sx[j];
  for (int i = tid; i < m; i += kThreads) {
    a.yo[om + i] = sy[i];
    a.zo[om + i] = sz[i];
  }

  // ---- scaled residuals
  const MaxOp mx{};
  const SumOp sum{};
  apply_A(a, s, sx, sAx);
  T rp = T(0), ax = T(0), azz = T(0);
  for (int i = tid; i < m; i += kThreads) {
    const T e = a.einv[i];
    rp = pmax(rp, fabs(e * (sAx[i] - sz[i])));
    ax = pmax(ax, fabs(e * sAx[i]));
    azz = pmax(azz, fabs(e * sz[i]));
  }
  rp = block_reduce(rp, red, mx);
  const T rp_rel = pmax(block_reduce(ax, red, mx), block_reduce(azz, red, mx));

  vecmat(a.pbar, sx, v1, nz, nz, part);  // Px
  apply_AT(a, s, sy, v2);                // A'y
  T rd = T(0), dpx = T(0), daty = T(0), dq = T(0);
  for (int j = tid; j < nz; j += kThreads) {
    const T d = a.dinv[j];
    rd = pmax(rd, fabs(d * ((v1[j] + sq[j]) + v2[j])));
    dpx = pmax(dpx, fabs(d * v1[j]));
    daty = pmax(daty, fabs(d * v2[j]));
    dq = pmax(dq, fabs(d * sq[j]));
  }
  rd = block_reduce(rd, red, mx);
  dpx = block_reduce(dpx, red, mx);
  daty = block_reduce(daty, red, mx);
  dq = block_reduce(dq, red, mx);
  const T rd_rel = pmax(dpx, pmax(daty, dq));

  // ---- primal infeasibility (Farkas) certificate from dy, projected onto
  // the polar of the recession cone of [l, u]
  T nv = T(0), sup_u = T(0), sup_l = T(0);
  for (int i = tid; i < m; i += kThreads) {
    const T uinf = isfinite(sub[i]) ? T(0) : T(1);
    const T linf = isfinite(slb[i]) ? T(0) : T(1);
    const T both = uinf * linf;
    const T uo = uinf * (T(1) - linf);
    const T lo = linf * (T(1) - uinf);
    T v = (sy[i] - a.y[om + i]) * (T(1) - both);
    v = v * (T(1) - uo) + pmin(v, T(0)) * uo;
    v = v * (T(1) - lo) + pmax(v, T(0)) * lo;
    sw[i] = v;
    nv = pmax(nv, fabs(v));
    const T ucap = uinf == T(0) ? sub[i] : T(0);
    const T lcap = linf == T(0) ? slb[i] : T(0);
    sup_u += ucap * pmax(v, T(0));
    sup_l += lcap * pmin(v, T(0));
  }
  nv = block_reduce(nv, red, mx);
  const T sup = block_reduce(sup_u, red, sum) + block_reduce(sup_l, red, sum);
  apply_AT(a, s, sw, v1);
  T atv = T(0);
  for (int j = tid; j < nz; j += kThreads) atv = pmax(atv, fabs(v1[j]));
  atv = block_reduce(atv, red, mx);
  const bool pinf = (a.eps_pinf * nv - atv > T(0)) &&
                    (-a.thresh * nv - sup > T(0)) && (nv - a.eps_pinf > T(0));

  // ---- dual infeasibility certificate from dx
  T nvx = T(0), qv = T(0);
  for (int j = tid; j < nz; j += kThreads) {
    const T d = sx[j] - a.x[onz + j];
    v2[j] = d;
    nvx = pmax(nvx, fabs(d));
    qv += sq[j] * d;
  }
  nvx = block_reduce(nvx, red, mx);
  qv = block_reduce(qv, red, sum);
  vecmat(a.pbar, v2, v1, nz, nz, part);  // P dx
  T pdx = T(0);
  for (int j = tid; j < nz; j += kThreads) pdx = pmax(pdx, fabs(v1[j]));
  pdx = block_reduce(pdx, red, mx);
  apply_A(a, s, v2, sAx);  // A dx
  const T eps_b = a.eps_dinf * nvx;
  T up_viol = T(0), lo_viol = T(0);
  for (int i = tid; i < m; i += kThreads) {
    const T uinf = isfinite(sub[i]) ? T(0) : T(1);
    const T linf = isfinite(slb[i]) ? T(0) : T(1);
    up_viol = pmax(up_viol, pmax(sAx[i] - eps_b, T(0)) * (T(1) - uinf));
    lo_viol = pmax(lo_viol, pmax(-eps_b - sAx[i], T(0)) * (T(1) - linf));
  }
  up_viol = block_reduce(up_viol, red, mx);
  lo_viol = block_reduce(lo_viol, red, mx);
  const bool dinf = (a.eps_dinf * nvx - pdx > T(0)) &&
                    (-a.eps_dinf * nvx - qv > T(0)) && up_viol == T(0) &&
                    lo_viol == T(0) && (nvx - a.eps_dinf > T(0));

  if (tid == 0) {
    T* st = a.stats + static_cast<size_t>(slot) * 8;
    st[0] = rp;
    st[1] = rp_rel;
    st[2] = rd;
    st[3] = rd_rel;
    st[4] = pinf ? T(1) : T(0);
    st[5] = dinf ? T(1) : T(0);
    st[6] = nv;
    st[7] = nvx;
  }
}

template <typename T>
int launch(void* const* p, int B, int nz, int m, int gw, int n_iter,
           int ir_steps, double sigma, double alpha, double eps_pinf,
           double eps_dinf, double thresh, void* stream) {
  Args<T> a;
  a.minv = static_cast<const T*>(p[0]);
  a.coef = static_cast<const T*>(p[1]);
  a.qbar = static_cast<const T*>(p[2]);
  a.lbar = static_cast<const T*>(p[3]);
  a.ubar = static_cast<const T*>(p[4]);
  a.rho = static_cast<const T*>(p[5]);
  a.x = static_cast<const T*>(p[6]);
  a.y = static_cast<const T*>(p[7]);
  a.z = static_cast<const T*>(p[8]);
  a.w7 = static_cast<const T*>(p[9]);
  a.done = static_cast<const unsigned char*>(p[10]);
  a.a0 = static_cast<const T*>(p[11]);
  a.pbar = static_cast<const T*>(p[12]);
  a.gsel = static_cast<const T*>(p[13]);
  a.scat = static_cast<const T*>(p[14]);
  a.rsel = static_cast<const T*>(p[15]);
  a.gscat = static_cast<const T*>(p[16]);
  a.stack7 = static_cast<const T*>(p[17]);
  a.einv = static_cast<const T*>(p[18]);
  a.dinv = static_cast<const T*>(p[19]);
  a.xo = static_cast<T*>(p[20]);
  a.yo = static_cast<T*>(p[21]);
  a.zo = static_cast<T*>(p[22]);
  a.stats = static_cast<T*>(p[23]);
  a.B = B;
  a.nz = nz;
  a.m = m;
  a.gw = gw;
  a.n_iter = n_iter;
  a.ir_steps = ir_steps;
  a.sigma = static_cast<T>(sigma);
  a.alpha = static_cast<T>(alpha);
  a.one_m_alpha = static_cast<T>(1.0 - alpha);
  a.eps_pinf = static_cast<T>(eps_pinf);
  a.eps_dinf = static_cast<T>(eps_dinf);
  a.thresh = static_cast<T>(thresh);
  if (B == 0) return 0;
  const size_t smem =
      sizeof(T) * (6 * static_cast<size_t>(nz) + 7 * static_cast<size_t>(m) +
                   3 * static_cast<size_t>(gw) + kThreads + 32);
  cudaError_t e = cudaFuncSetAttribute(
      admm_chunk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  admm_chunk_kernel<T>
      <<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------

#define ADMM_CHUNK_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                         \
      void* p0, void* p1, void* p2, void* p3, void* p4, void* p5, void* p6,    \
      void* p7, void* p8, void* p9, void* p10, void* p11, void* p12,           \
      void* p13, void* p14, void* p15, void* p16, void* p17, void* p18,        \
      void* p19, void* p20, void* p21, void* p22, void* p23, int B, int nz,    \
      int m, int gw, int n_iter, int ir_steps, double sigma, double alpha,     \
      double eps_pinf, double eps_dinf, double thresh, void* stream) {         \
    void* const p[24] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,                \
                         p8,  p9,  p10, p11, p12, p13, p14, p15,               \
                         p16, p17, p18, p19, p20, p21, p22, p23};              \
    return launch<T>(p, B, nz, m, gw, n_iter, ir_steps, sigma, alpha,          \
                     eps_pinf, eps_dinf, thresh, stream);                      \
  }

ADMM_CHUNK_ENTRY(admm_chunk_f32, float)
ADMM_CHUNK_ENTRY(admm_chunk_f64, double)
