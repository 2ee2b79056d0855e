// Masked batched Newton–Schulz inverse, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels
//   mpc_arpo_project_tpu/ops/admm_pallas.py::_ns_fused_kernel  (ns_fused)
//   mpc_arpo_project_tpu/ops/admm_pallas.py::_ns_kernel        (newton_schulz_inverse)
// and computes what their plain torch twins (ns_fused_ref,
// newton_schulz_inverse_ref in mpc_arpo_project_tpu_torch/ops/admm_pallas.py)
// compute, for every problem p that needs it:
//   X <- X (2I - M_p X), n_iter times, from X_prev (warm) or from
//   X0 = M_p' / (||M_p||_1 ||M_p||_inf) (cold); residual ||I - M_p X||_inf.
// M_p is either the weighted sum of seven shared matrices,
// sum_j w[p, j] stack[j] (ns_fused), or a given per-problem matrix
// (newton_schulz_inverse). Problems without need pass X_prev through, bit
// for bit, and read residual 0.
//
// What bounds it. One iteration is two n x n x n products per needy
// problem, in full fp32/fp64 FMA: TF32 tensor cores are refused (their
// ~1e-3 error stalls ADMM). At n = 256 each product is 2 n^3 = 34 MFLOP on
// 0.75 MiB of operands, so a large call is bound by the CUDA cores: 128
// fp32 FMAs per clock and SM (67 TFLOP/s on an H100 SXM), fed from shared
// memory at 128 bytes per clock and SM. A thread that keeps an 8 x 8 block
// of C in registers reads 4 shared-memory wavefronts per 64 FMAs per warp,
// which is that port's whole rate at the FMA peak; an 8 x 16 block reads 6
// per 128. A call on a few problems is bound by latency instead: 2 n_iter
// + 1 dependent launches, each too small to fill the card.
//
// Design.
// * Needy problems only. ns_compact writes the needy problems' indices in
//   ascending order (slot -> problem), each problem's slot and their count,
//   on the device. Every later kernel runs over slots: the grid is sized by
//   the caller's n_need (cap), blocks beyond the device count exit, and a
//   problem without need is never touched by a product. A needy problem
//   whose slot lies beyond cap (a wrong n_need) reads NaN.
// * M once per call. ns_fused first builds each needy problem's M into a
//   per-call scratch of cap slots, in the first version's contraction
//   (ns_build_m). The TPU kernel never wrote M to HBM, which saved XLA from
//   materialising M for all B rows on every refresh; here the scratch holds
//   the needy rows only, once per call, and spares every product of M the
//   seven stack reads per element it would cost to rebuild M on load.
// * A register-blocked, pipelined GEMM. A block computes a BM x BN output
//   tile of one slot with 256 threads, each a TM x TN register block read
//   from shared memory as 16-byte fragments by warps of 4 x 8 threads (4 A
//   and 8 B addresses: one wavefront each). Operands go through a 3-stage
//   ring in dynamic shared memory by cp.async, so the next two 16-deep
//   slices load while this one computes. B is copied in 16-byte pieces when
//   n allows it (element-wise otherwise); A is copied element-wise, one
//   32-byte sector per row and warp, into a k-major (transposed) layout
//   whose row stride keeps the copies and the fragment reads free of bank
//   conflicts. Tiles: fp32 128 x 256 (8 x 16 per thread, one block per SM)
//   or 64 x 64 (4 x 4); fp64 128 x 64 (8 x 4) or 64 x 64. The host takes
//   the large tile when the call's slots give every SM one such block
//   (ns_tile in ops/admm_pallas.py), the 64 x 64 tile otherwise: most
//   refreshes of the main path touch a few problems, where more, smaller
//   blocks win.
// * The launches of a call (2 n_iter + 1 products and up to six small
//   kernels) are chained by programmatic dependent launch, so each is
//   scheduled while the one before drains.
// * The same arithmetic as the parent kernel, bit for bit: each output
//   element is one k-ascending fma chain from 0 over all of k (no split-K,
//   no reordering; the zero padding of a ragged n adds fma(0, 0, acc)), and
//   the norms, the cold start, the epilogues (2I - MX after the first
//   product of an iteration, max |I - MX| per tile after the residual
//   product) and the reductions are unchanged. So X and the residuals do
//   not depend on the tile, the cap or the order of the slots.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int NT = 256;  // threads of a block outside the GEMM
constexpr int TT = 32;   // transpose tile
constexpr int BK = 16;   // depth of a pipeline slice
constexpr int STAGES = 3;

template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

template <typename T>
__device__ __forceinline__ T qnan();
template <>
__device__ __forceinline__ float qnan<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ double qnan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// ---- programmatic dependent launch ---------------------------------------
// Every kernel after ns_compact is launched with launch_chained: it may be
// scheduled while its predecessor in the stream drains, and wait_prior, its
// first statement, holds it until that predecessor has finished and its
// writes are visible (each predecessor waited on its own, so on all earlier
// kernels too). No kernel triggers its successor early: GEMM blocks that
// launched early would wait on SMs the running GEMM still needs.

__device__ __forceinline__ void wait_prior() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// ---- cp.async -------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copy BYTES from global src to shared dst, or zeros when !pred.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool pred) {
  const int n = pred ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "n"(BYTES), "r"(n));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four consecutive elements from 16-byte aligned shared memory.
__device__ __forceinline__ void lds4(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void lds4(const double* p, double* v) {
  const double2 q0 = reinterpret_cast<const double2*>(p)[0];
  const double2 q1 = reinterpret_cast<const double2*>(p)[1];
  v[0] = q0.x;
  v[1] = q0.y;
  v[2] = q1.x;
  v[3] = q1.y;
}

// VB consecutive elements to global memory (aligned to VB elements).
template <int VB>
__device__ __forceinline__ void stv(float* p, const float* v) {
  if constexpr (VB == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    p[0] = v[0];
  }
}
template <int VB>
__device__ __forceinline__ void stv(double* p, const double* v) {
  if constexpr (VB == 2) {
    *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// ---- the GEMM -------------------------------------------------------------

enum Epilogue { kTwoIMinus = 0, kStore = 1, kResidual = 2 };

// C = A B for the slots of a call. An operand is indexed by problem
// (full = 1: a (B, n, n) input, row idx[slot]) or by slot (full = 0: a
// per-call buffer of cap rows).
template <typename T>
struct Gemm {
  const T* a;
  const T* b;
  int a_full, b_full;
  T* c;        // (cap, n, n) by slot, epilogues kTwoIMinus and kStore
  T* partial;  // (cap, tiles) by slot, epilogue kResidual
  const int* idx;    // slot -> problem, or nullptr (slot == problem)
  const int* count;  // slots in use, or nullptr (all)
  int n, epi;
};

template <typename T, int BM, int BN, int TM, int TN>
struct Tile {
  static constexpr int TX = BN / TN, TY = BM / TM, THREADS = TX * TY;
  // k-major A slice row stride: 4 mod 32 words (fp32) or 8 mod 16 double
  // words (fp64), so a warp's copy patch lands on 32 distinct banks
  static constexpr int SA = BM + (sizeof(T) == 4 ? 4 : 8);
  static constexpr int SB = BN;      // B slice row stride
  static constexpr int STAGE = BK * (SA + SB);
  static constexpr size_t SMEM = sizeof(T) * STAGES * STAGE;
  static_assert(TX % 8 == 0 && TY % 4 == 0, "warps of 4 x 8 threads");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "fragments of 4");
};

// VB: elements per copy of a B row piece (16 bytes when n and the pointers
// allow it, else 1).
template <typename T, int BM, int BN, int TM, int TN, int VB>
__global__ void __launch_bounds__((BM / TM) * (BN / TN),
                                  TM * TN > 64 ? 1 : 2) ns_gemm(Gemm<T> g) {
  using C = Tile<T, BM, BN, TM, TN>;
  constexpr int NTG = C::THREADS, W = NTG / 32;
  wait_prior();
  const int slot = blockIdx.y;
  if (g.count != nullptr && slot >= *g.count) return;
  const int p = g.idx != nullptr ? g.idx[slot] : slot;
  const int n = g.n;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* A = g.a + static_cast<size_t>(g.a_full ? p : slot) * nn;
  const T* Bg = g.b + static_cast<size_t>(g.b_full ? p : slot) * nn;
  const int tiles_n = (n + BN - 1) / BN;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ T red[W];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp holds 4 x 8 threads of the TY x TX grid: its fragment reads
  // touch 4 A and 8 B addresses (one shared-memory wavefront each)
  const int tx = (lane & 7) + 8 * (warp % (C::TX / 8));
  const int ty = (lane >> 3) + 4 * (warp / (C::TX / 8));
  const int KT = (n + BK - 1) / BK;

  // One slice (k0 = kt BK) into a stage. A: each warp copies patches of
  // PR rows x PK k (one 32-byte sector per row), lane -> (row lane % PR,
  // k lane / PR), into the k-major layout. B: row pieces of VB elements,
  // a warp along a row.
  auto load = [&](int stage, int kt) {
    T* As = smem + stage * C::STAGE;
    T* Bs = As + BK * C::SA;
    const int k0 = kt * BK;
    constexpr int PR = sizeof(T) == 4 ? 4 : 8, PK = 32 / PR;
    constexpr int RW = BM / PR / W;  // row patches of a warp per PK k
    static_assert(RW * W * PR == BM, "patches cover the tile");
#pragma unroll
    for (int r = 0; r < BM * BK / NTG; ++r) {
      const int i = (warp + W * (r % RW)) * PR + lane % PR;
      const int k = (r / RW) * PK + lane / PR;
      const int gi = row0 + i, gk = k0 + k;
      const bool in = gi < n && gk < n;
      cp_async<sizeof(T)>(As + k * C::SA + i,
                          in ? A + static_cast<size_t>(gi) * n + gk : A, in);
    }
    constexpr int CPR = BN / VB;  // pieces per row
    static_assert(NTG % CPR == 0, "a copy round covers whole rows");
#pragma unroll
    for (int r = 0; r < BK * CPR / NTG; ++r) {
      const int k = tid / CPR + r * (NTG / CPR), j = (tid % CPR) * VB;
      const int gk = k0 + k, gj = col0 + j;
      const bool in = gk < n && gj < n;  // n % VB == 0: a piece is all in
      cp_async<VB * sizeof(T)>(
          Bs + k * C::SB + j, in ? Bg + static_cast<size_t>(gk) * n + gj : Bg,
          in);
    }
  };

  T acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = T(0);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice kt is in; every thread is done with kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load(nk % STAGES, nk);
    cp_async_commit();
    const T* As = smem + (kt % STAGES) * C::STAGE;
    const T* Bs = As + BK * C::SA;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T av[TM], bv[TN];
#pragma unroll
      for (int c = 0; c < TM / 4; ++c)
        lds4(As + k * C::SA + c * C::TY * 4 + ty * 4, av + 4 * c);
#pragma unroll
      for (int c = 0; c < TN / 4; ++c)
        lds4(Bs + k * C::SB + c * C::TX * 4 + tx * 4, bv + 4 * c);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
  }

  // element (i, j) of the register block is C[row0 + ri, col0 + cj]
  auto ri = [&](int i) { return (i / 4) * C::TY * 4 + ty * 4 + i % 4; };
  auto cj = [&](int j) { return (j / 4) * C::TX * 4 + tx * 4 + j % 4; };
  if (g.epi == kResidual) {
    T r = T(0);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int gi = row0 + ri(i), gj = col0 + cj(j);
        if (gi < n && gj < n)
          r = pmax(r, fabs((gi == gj ? T(1) : T(0)) - acc[i][j]));
      }
    for (int o = 16; o > 0; o >>= 1)
      r = pmax(r, __shfl_xor_sync(0xffffffffu, r, o));
    if (lane == 0) red[warp] = r;
    __syncthreads();
    if (tid == 0) {
      T v = red[0];
      for (int w = 1; w < W; ++w) v = pmax(v, red[w]);
      g.partial[static_cast<size_t>(slot) * gridDim.x + blockIdx.x] = v;
    }
    return;
  }
  T* cp = g.c + static_cast<size_t>(slot) * nn;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = row0 + ri(i);
    if (gi >= n) continue;
#pragma unroll
    for (int j = 0; j < TN; j += VB) {
      const int gj = col0 + cj(j);  // VB consecutive columns from here
      if (gj >= n) continue;
      T v[VB];
#pragma unroll
      for (int u = 0; u < VB; ++u)
        v[u] = g.epi == kTwoIMinus
                   ? (gi == gj + u ? T(2) : T(0)) - acc[i][j + u]
                   : acc[i][j + u];
      stv<VB>(cp + static_cast<size_t>(gi) * n + gj, v);
    }
  }
}

// ---- the kernels around it -----------------------------------------------

// Needy problems in ascending order: idx[slot] = p, slot_of[p] (-1 without
// need), *count. One block of 1024 threads, a ballot scan per 1024 rows.
__global__ void __launch_bounds__(1024) ns_compact(const unsigned char* need,
                                                   int B, int* idx,
                                                   int* slot_of, int* count) {
  __shared__ int warp_n[32];
  __shared__ int base;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int nw = blockDim.x / 32;
  if (threadIdx.x == 0) base = 0;
  __syncthreads();
  for (int c0 = 0; c0 < B; c0 += blockDim.x) {
    const int p = c0 + threadIdx.x;
    const bool f = p < B && need[p] != 0;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) warp_n[wid] = __popc(m);
    __syncthreads();
    int off = base, total = 0;
    for (int w = 0; w < nw; ++w) {
      if (w < wid) off += warp_n[w];
      total += warp_n[w];
    }
    const int s = off + __popc(m & ((1u << lane) - 1u));
    if (p < B) {
      slot_of[p] = f ? s : -1;
      if (f) idx[s] = p;
    }
    __syncthreads();
    if (threadIdx.x == 0) base += total;
    __syncthreads();
  }
  if (threadIdx.x == 0) *count = base;
}

// m[slot] = sum_j w[p, j] stack[j] for the needy problem p of each slot,
// in the contraction nvcc chose for the first version's
// w0 s0 + w1 s1 + ... + w6 s6 (checked bit for bit on the card):
// fma(w0, s0, w1 s1), then fma(w_t, s_t, .) for t = 2..6.
template <typename T>
__global__ void __launch_bounds__(NT) ns_build_m(const T* stack, const T* w,
                                                 const int* idx,
                                                 const int* count, T* m,
                                                 int n) {
  wait_prior();
  const int slot = blockIdx.y;
  if (slot >= *count) return;
  const T* wp = w + static_cast<size_t>(idx[slot]) * 8;
  T wt[7];
#pragma unroll
  for (int t = 0; t < 7; ++t) wt[t] = wp[t];
  const size_t nn = static_cast<size_t>(n) * n;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < nn; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    T v = fma(wt[0], stack[e], wt[1] * stack[nn + e]);
#pragma unroll
    for (int t = 2; t < 7; ++t) v = fma(wt[t], stack[t * nn + e], v);
    m[static_cast<size_t>(slot) * nn + e] = v;
  }
}

// Row of M for a slot: by problem (m_full) or by slot.
template <typename T>
__device__ __forceinline__ const T* slot_matrix(const T* m, int m_full,
                                                const int* idx, int slot,
                                                size_t nn) {
  const int row = (m_full && idx != nullptr) ? idx[slot] : slot;
  return m + static_cast<size_t>(row) * nn;
}

// denom[slot] = ||M||_1 ||M||_inf (max column and max row abs-sum).
template <typename T>
__global__ void __launch_bounds__(NT) ns_norms(const T* m, int m_full,
                                               const int* idx,
                                               const int* count, T* denom,
                                               int n) {
  wait_prior();
  const int slot = blockIdx.x;
  if (count != nullptr && slot >= *count) return;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* mp = slot_matrix(m, m_full, idx, slot, nn);
  __shared__ T red[2][NT / 32];
  T cmax = T(0), rmax = T(0);
  for (int j = threadIdx.x; j < n; j += NT) {  // column sums, coalesced
    T s = T(0);
#pragma unroll 8
    for (int i = 0; i < n; ++i) s += fabs(mp[static_cast<size_t>(i) * n + j]);
    cmax = pmax(cmax, s);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = wid; i < n; i += NT / 32) {  // row sums, a warp per row
    T s = T(0);
    for (int j = lane; j < n; j += 32)
      s += fabs(mp[static_cast<size_t>(i) * n + j]);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    rmax = pmax(rmax, s);
  }
  for (int o = 16; o > 0; o >>= 1) {
    cmax = pmax(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
    rmax = pmax(rmax, __shfl_xor_sync(0xffffffffu, rmax, o));
  }
  if (lane == 0) {
    red[0][wid] = cmax;
    red[1][wid] = rmax;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = red[0][0], r = red[1][0];
    for (int k = 1; k < NT / 32; ++k) {
      c = pmax(c, red[0][k]);
      r = pmax(r, red[1][k]);
    }
    denom[slot] = c * r;
  }
}

// x0[slot] = M' / denom[slot], through a 32 x 32 shared-memory transpose.
template <typename T>
__global__ void ns_cold_init(const T* m, int m_full, const int* idx,
                             const int* count, const T* denom, T* x0, int n) {
  wait_prior();
  const int slot = blockIdx.y;
  if (count != nullptr && slot >= *count) return;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* mp = slot_matrix(m, m_full, idx, slot, nn);
  const int tiles = (n + TT - 1) / TT;
  const int r0 = (blockIdx.x / tiles) * TT, c0 = (blockIdx.x % tiles) * TT;
  __shared__ T tile[TT][TT + 1];
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;  // 32 x 8 threads
  for (int i = ty; i < TT; i += 8) {
    const int gi = r0 + i, gj = c0 + tx;
    tile[i][tx] =
        (gi < n && gj < n) ? mp[static_cast<size_t>(gi) * n + gj] : T(0);
  }
  __syncthreads();
  const T d = denom[slot];
  for (int j = ty; j < TT; j += 8) {
    const int oi = c0 + j, oj = r0 + tx;  // X0[oi, oj] = M[oj, oi] / d
    if (oi < n && oj < n)
      x0[static_cast<size_t>(slot) * nn + static_cast<size_t>(oi) * n + oj] =
          tile[tx][j] / d;
  }
}

// res[p] = max over its slot's tiles of the residual partials; 0 without
// need, NaN for a needy problem beyond cap.
template <typename T>
__global__ void ns_reduce(const T* partial, int tiles,
                          const unsigned char* need, const int* slot_of,
                          int cap, T* res, int B) {
  wait_prior();
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < B;
       p += gridDim.x * blockDim.x) {
    if (need != nullptr && !need[p]) {
      res[p] = T(0);
      continue;
    }
    const int s = slot_of != nullptr ? slot_of[p] : p;
    if (s >= cap) {
      res[p] = qnan<T>();
      continue;
    }
    T v = partial[static_cast<size_t>(s) * tiles];
    for (int t = 1; t < tiles; ++t)
      v = pmax(v, partial[static_cast<size_t>(s) * tiles + t]);
    res[p] = v;
  }
}

// out[p] = need[p] ? xf[its slot] : x_prev[p]
template <typename T>
__global__ void ns_select(const T* xf, int xf_full, const T* x_prev,
                          const unsigned char* need, const int* slot_of,
                          int cap, T* out, int n) {
  wait_prior();
  const int p = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* src = x_prev + static_cast<size_t>(p) * nn;
  bool lost = false;
  if (need == nullptr || need[p]) {
    const int s = slot_of != nullptr ? slot_of[p] : p;
    lost = s >= cap;
    if (!lost) src = xf + static_cast<size_t>(xf_full ? p : s) * nn;
  }
  T* dst = out + static_cast<size_t>(p) * nn;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < nn; e += static_cast<size_t>(gridDim.x) * blockDim.x)
    dst[e] = lost ? qnan<T>() : src[e];
}

// ---- host -----------------------------------------------------------------

template <typename... P, typename... A>
cudaError_t launch_chained(void (*kern)(P...), dim3 grid, dim3 block,
                           size_t smem, cudaStream_t st, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename T, int BM, int BN, int TM, int TN, int VB>
cudaError_t gemm(const Gemm<T>& g, int cap, cudaStream_t st) {
  using C = Tile<T, BM, BN, TM, TN>;
  const auto kern = ns_gemm<T, BM, BN, TM, TN, VB>;
  static unsigned opted_in = 0;  // devices whose limit was raised
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (!((opted_in >> dev) & 1u)) {  // above 48 KB only after opting in
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::SMEM));
    if (e != cudaSuccess) return e;
    opted_in |= 1u << dev;
  }
  const int tiles = ((g.n + BM - 1) / BM) * ((g.n + BN - 1) / BN);
  return launch_chained(kern, dim3(tiles, cap), dim3(C::THREADS), C::SMEM, st,
                        g);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

template <typename T, int BM, int BN, int TM, int TN>
int run(const T* stack, const T* w, const T* mat, const T* x_prev,
        const unsigned char* need, T* out, T* res, T* mscr, T* w1, T* w2,
        T* tmp, T* partial, T* denom, int* ibuf, int B, int cap, int n,
        int n_iter, int cold, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  // 16-byte B pieces need n % V == 0 and aligned rows of every B operand
  // (X_prev, the cold start and the work buffers)
  const bool vec = n % V == 0 && aligned16(x_prev) && aligned16(w1) &&
                   aligned16(w2) && aligned16(tmp);
  auto product = [&](const Gemm<T>& g) {
    return vec ? gemm<T, BM, BN, TM, TN, V>(g, cap, st)
               : gemm<T, BM, BN, TM, TN, 1>(g, cap, st);
  };
  int *idx = nullptr, *slot_of = nullptr, *count = nullptr;
  if (need != nullptr) {
    idx = ibuf;
    slot_of = ibuf + B;
    count = ibuf + 2 * B;
    ns_compact<<<1, 1024, 0, st>>>(need, B, idx, slot_of, count);
  }
  cudaError_t e = cudaGetLastError();
  auto ok = [&](cudaError_t r) { return (e = r) == cudaSuccess; };
  const T* cur = x_prev;
  int cur_full = 1;
  const size_t nn = static_cast<size_t>(n) * n;
  if (e == cudaSuccess && cap > 0) {
    const T* M = mat;
    int m_full = 1;
    if (stack != nullptr) {
      const int blocks = static_cast<int>((nn + NT * 4 - 1) / (NT * 4));
      if (!ok(launch_chained(ns_build_m<T>, dim3(blocks, cap), dim3(NT), 0,
                             st, stack, w, idx, count, mscr, n)))
        return static_cast<int>(e);
      M = mscr;
      m_full = 0;
    }
    if (cold) {
      const int tt = (n + TT - 1) / TT;
      if (!ok(launch_chained(ns_norms<T>, dim3(cap), dim3(NT), 0, st, M,
                             m_full, idx, count, denom, n)) ||
          !ok(launch_chained(ns_cold_init<T>, dim3(tt * tt, cap),
                             dim3(TT * 8), 0, st, M, m_full, idx, count,
                             denom, w1, n)))
        return static_cast<int>(e);
      cur = w1;
      cur_full = 0;
    }
    for (int it = 0; it < n_iter; ++it) {
      T* nxt = (cur == w1) ? w2 : w1;
      if (!ok(product(Gemm<T>{M, cur, m_full, cur_full, tmp, nullptr, idx,
                              count, n, kTwoIMinus})) ||
          !ok(product(Gemm<T>{cur, tmp, cur_full, 0, nxt, nullptr, idx,
                              count, n, kStore})))
        return static_cast<int>(e);
      cur = nxt;
      cur_full = 0;
    }
    if (!ok(product(Gemm<T>{M, cur, m_full, cur_full, nullptr, partial, idx,
                            count, n, kResidual})))
      return static_cast<int>(e);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles = ((n + BM - 1) / BM) * ((n + BN - 1) / BN);
  const int sel_blocks = static_cast<int>((nn + NT * 8 - 1) / (NT * 8));
  if (ok(launch_chained(ns_reduce<T>, dim3((B + NT - 1) / NT), dim3(NT), 0,
                        st, partial, tiles, need, slot_of, cap, res, B)))
    ok(launch_chained(ns_select<T>, dim3(sel_blocks, B), dim3(NT), 0, st,
                      cur, cur_full, x_prev, need, slot_of, cap, out, n));
  return static_cast<int>(e);
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------
// stack/w (ns_fused) or mat (newton_schulz_inverse) is null; need is null
// for newton_schulz_inverse (every problem, cap == B). mscr (ns_fused
// only), w1, w2, tmp: (cap, n, n) work buffers; partial: (cap,
// ceil(n/64)^2); denom: (cap,); ibuf: 2 B + 1 ints (ns_fused only). big
// selects the 128-row tile.

#define NS_ENTRY(NAME, T, BIG_BN, BIG_TM, BIG_TN)                                     \
  extern "C" int NAME(void* stack, void* w, void* mat, void* x_prev,          \
                      void* need, void* out, void* res, void* mscr, void* w1, \
                      void* w2, void* tmp, void* partial, void* denom,        \
                      void* ibuf, int B, int cap, int n, int n_iter,          \
                      int cold, int big, void* stream) {                      \
    if (B == 0) return 0;                                                     \
    auto go = [&](auto fn) {                                                  \
      return fn(static_cast<const T*>(stack), static_cast<const T*>(w),       \
                static_cast<const T*>(mat), static_cast<const T*>(x_prev),    \
                static_cast<const unsigned char*>(need), static_cast<T*>(out), \
                static_cast<T*>(res), static_cast<T*>(mscr),                  \
                static_cast<T*>(w1), static_cast<T*>(w2),                     \
                static_cast<T*>(tmp), static_cast<T*>(partial),               \
                static_cast<T*>(denom), static_cast<int*>(ibuf), B, cap, n,   \
                n_iter, cold, static_cast<cudaStream_t>(stream));             \
    };                                                                        \
    return big ? go(run<T, 128, BIG_BN, BIG_TM, BIG_TN>)                      \
               : go(run<T, 64, 64, 4, 4>);                                    \
  }

NS_ENTRY(ns_run_f32, float, 256, 8, 16)
NS_ENTRY(ns_run_f64, double, 64, 8, 4)
