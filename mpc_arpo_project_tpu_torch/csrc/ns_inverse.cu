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
// (newton_schulz_inverse). Problems without need pass X_prev through and
// read residual 0. The two entries differ only in where a tile of M comes
// from; the iteration, the residual and the pass-through are shared.
//
// Design. Each half-iteration is a batched n x n x n product, one launch
// over a grid of (64 x 64 output tile, problem): a tiled GEMM with 64 x 16
// and 16 x 64 operand tiles in shared memory and a 4 x 4 register block
// per thread, in full fp32/fp64 FMA (no TF32, no tensor cores). Blocks of a
// problem without need return at once, so a sparse need mask costs only
// those blocks' launch. In ns_fused the A operand M is built tile by tile
// as it is loaded (seven stack reads per element, from L2): M is never
// written to device memory, which is the property the TPU kernel was
// designed for. The first product's epilogue stores 2I - MX; the residual
// product's epilogue reduces max |I - MX| per tile, and a small pass takes
// the max over tiles. The cold start takes M's column and row abs-sums in
// one block per problem and writes X0 through a shared-memory transpose.
//
// What bounds it. One iteration on K needy problems is 2 K n^3 FMAs: at
// n=256 and K=128 (the compacted refresh of the flagship), 8.6 GFLOP per
// iteration, 0.13 ms at the H100's 67 TFLOP/s fp32 CUDA-core peak, against
// 2 x 3 x 32 MiB of operands and results (~0.06 ms at 3.35 TB/s): bound by
// the FMA rate. This simple tiling feeds the FMA units from shared memory
// at two FMAs per operand load, far below that peak; wgmma in TF32 is
// refused here (its ~1e-3 error stalls ADMM), so the way up is a larger
// register block and double-buffered tiles.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int NT = 256;
constexpr int TT = 32;  // transpose tile

template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}

// Element (i, k) of problem p's M.
template <typename T>
__device__ __forceinline__ T m_elem(const T* stack, const T* w, const T* mat,
                                    int p, size_t nn, size_t off) {
  if (stack != nullptr) {
    const T* wp = w + static_cast<size_t>(p) * 8;
    T v = wp[0] * stack[off];
#pragma unroll
    for (int t = 1; t < 7; ++t) v = v + wp[t] * stack[t * nn + off];
    return v;
  }
  return mat[static_cast<size_t>(p) * nn + off];
}

enum Epilogue { kTwoIMinus = 0, kStore = 1, kResidual = 2 };

template <typename T>
struct Gemm {
  // A operand: M (stack + w, or mat) when a == nullptr, else the batch a
  const T* stack;
  const T* w;
  const T* mat;
  const T* a;
  const T* b;  // (B, n, n)
  T* c;        // (B, n, n), epilogues 0 and 1
  T* partial;  // (B, tiles), epilogue 2
  const unsigned char* need;  // (B,) or nullptr: every problem
  int n, epi;
};

template <typename T>
__global__ void __launch_bounds__(NT) ns_gemm(Gemm<T> g) {
  const int p = blockIdx.y;
  if (g.need != nullptr && !g.need[p]) return;
  const int n = g.n;
  const size_t nn = static_cast<size_t>(n) * n;
  const int tiles_n = (n + BN - 1) / BN;
  const int row0 = (blockIdx.x / tiles_n) * BM;
  const int col0 = (blockIdx.x % tiles_n) * BN;
  __shared__ T As[BK][BM + 1];
  __shared__ T Bs[BK][BN];
  __shared__ T red[NT / 32];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const T* bp = g.b + static_cast<size_t>(p) * nn;
  const T* ap = g.a == nullptr ? nullptr : g.a + static_cast<size_t>(p) * nn;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < n; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += NT) {
      const int i = e / BK, k = e % BK;
      const int gi = row0 + i, gk = k0 + k;
      T v = T(0);
      if (gi < n && gk < n) {
        const size_t off = static_cast<size_t>(gi) * n + gk;
        v = ap != nullptr ? ap[off] : m_elem(g.stack, g.w, g.mat, p, nn, off);
      }
      As[k][i] = v;
    }
    for (int e = threadIdx.x; e < BK * BN; e += NT) {
      const int k = e / BN, j = e % BN;
      const int gk = k0 + k, gj = col0 + j;
      Bs[k][j] = (gk < n && gj < n) ? bp[static_cast<size_t>(gk) * n + gj]
                                    : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      T av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fma(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (g.epi == kResidual) {
    T r = T(0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int gi = row0 + ty + 16 * i, gj = col0 + tx + 16 * j;
        if (gi < n && gj < n)
          r = pmax(r, fabs((gi == gj ? T(1) : T(0)) - acc[i][j]));
      }
    for (int o = 16; o > 0; o >>= 1)
      r = pmax(r, __shfl_xor_sync(0xffffffffu, r, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = r;
    __syncthreads();
    if (threadIdx.x == 0) {
      T v = red[0];
      for (int w = 1; w < NT / 32; ++w) v = pmax(v, red[w]);
      g.partial[static_cast<size_t>(p) * gridDim.x + blockIdx.x] = v;
    }
    return;
  }
  T* cp = g.c + static_cast<size_t>(p) * nn;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gi = row0 + ty + 16 * i, gj = col0 + tx + 16 * j;
      if (gi < n && gj < n) {
        const T v = acc[i][j];
        cp[static_cast<size_t>(gi) * n + gj] =
            g.epi == kTwoIMinus ? (gi == gj ? T(2) : T(0)) - v : v;
      }
    }
}

// denom[p] = ||M_p||_1 ||M_p||_inf (max column and max row abs-sum).
template <typename T>
__global__ void __launch_bounds__(NT) ns_norms(const T* stack, const T* w,
                                               const T* mat,
                                               const unsigned char* need,
                                               T* denom, int n) {
  const int p = blockIdx.x;
  if (need != nullptr && !need[p]) return;
  const size_t nn = static_cast<size_t>(n) * n;
  __shared__ T red[2][NT / 32];
  T cmax = T(0), rmax = T(0);
  for (int j = threadIdx.x; j < n; j += NT) {  // column sums, coalesced
    T s = T(0);
    for (int i = 0; i < n; ++i)
      s += fabs(m_elem(stack, w, mat, p, nn, static_cast<size_t>(i) * n + j));
    cmax = pmax(cmax, s);
  }
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  for (int i = wid; i < n; i += NT / 32) {  // row sums, a warp per row
    T s = T(0);
    for (int j = lane; j < n; j += 32)
      s += fabs(m_elem(stack, w, mat, p, nn, static_cast<size_t>(i) * n + j));
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
    denom[p] = c * r;
  }
}

// X0[p] = M_p' / denom[p], through a 32 x 32 shared-memory transpose.
template <typename T>
__global__ void ns_cold_init(const T* stack, const T* w, const T* mat,
                             const unsigned char* need, const T* denom, T* x0,
                             int n) {
  const int p = blockIdx.y;
  if (need != nullptr && !need[p]) return;
  const size_t nn = static_cast<size_t>(n) * n;
  const int tiles = (n + TT - 1) / TT;
  const int r0 = (blockIdx.x / tiles) * TT, c0 = (blockIdx.x % tiles) * TT;
  __shared__ T tile[TT][TT + 1];
  const int tx = threadIdx.x % TT, ty = threadIdx.x / TT;  // 32 x 8 threads
  for (int i = ty; i < TT; i += 8) {
    const int gi = r0 + i, gj = c0 + tx;
    tile[i][tx] = (gi < n && gj < n)
                      ? m_elem(stack, w, mat, p, nn,
                               static_cast<size_t>(gi) * n + gj)
                      : T(0);
  }
  __syncthreads();
  const T d = denom[p];
  for (int j = ty; j < TT; j += 8) {
    const int oi = c0 + j, oj = r0 + tx;  // X0[oi, oj] = M[oj, oi] / d
    if (oi < n && oj < n)
      x0[static_cast<size_t>(p) * nn + static_cast<size_t>(oi) * n + oj] =
          tile[tx][j] / d;
  }
}

// res[p] = max over tiles of the residual partials (0 without need).
template <typename T>
__global__ void ns_reduce(const T* partial, int tiles,
                          const unsigned char* need, T* res, int B) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < B;
       p += gridDim.x * blockDim.x) {
    if (need != nullptr && !need[p]) {
      res[p] = T(0);
      continue;
    }
    T v = partial[static_cast<size_t>(p) * tiles];
    for (int t = 1; t < tiles; ++t)
      v = pmax(v, partial[static_cast<size_t>(p) * tiles + t]);
    res[p] = v;
  }
}

// out[p] = need[p] ? xf[p] : x_prev[p]
template <typename T>
__global__ void ns_select(const T* xf, const T* x_prev,
                          const unsigned char* need, T* out, int n) {
  const int p = blockIdx.y;
  const size_t nn = static_cast<size_t>(n) * n;
  const T* src = (need == nullptr || need[p]) ? xf : x_prev;
  for (size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < nn; e += static_cast<size_t>(gridDim.x) * blockDim.x)
    out[static_cast<size_t>(p) * nn + e] = src[static_cast<size_t>(p) * nn + e];
}

template <typename T>
int run(const T* stack, const T* w, const T* mat, const T* x_prev,
        const unsigned char* need, T* out, T* res, T* w1, T* w2, T* tmp,
        T* partial, T* denom, int B, int n, int n_iter, int cold,
        cudaStream_t st) {
  if (B == 0) return 0;
  const int tiles_n = (n + BN - 1) / BN;
  const dim3 ggrid(tiles_n * tiles_n, B);
  cudaError_t e;
  const T* cur = x_prev;
  if (cold) {
    ns_norms<T><<<B, NT, 0, st>>>(stack, w, mat, need, denom, n);
    const int tt = (n + TT - 1) / TT;
    ns_cold_init<T><<<dim3(tt * tt, B), TT * 8, 0, st>>>(stack, w, mat, need,
                                                         denom, w1, n);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    cur = w1;
  }
  for (int it = 0; it < n_iter; ++it) {
    T* nxt = (cur == w1) ? w2 : w1;
    Gemm<T> g1{stack, w, mat, nullptr, cur, tmp, nullptr, need, n, kTwoIMinus};
    ns_gemm<T><<<ggrid, NT, 0, st>>>(g1);
    Gemm<T> g2{nullptr, nullptr, nullptr, cur, tmp, nxt, nullptr, need, n,
               kStore};
    ns_gemm<T><<<ggrid, NT, 0, st>>>(g2);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
    cur = nxt;
  }
  Gemm<T> g3{stack, w, mat, nullptr, cur, nullptr, partial, need, n,
             kResidual};
  ns_gemm<T><<<ggrid, NT, 0, st>>>(g3);
  ns_reduce<T><<<(B + NT - 1) / NT, NT, 0, st>>>(partial, tiles_n * tiles_n,
                                                 need, res, B);
  const int sel_blocks = static_cast<int>((static_cast<size_t>(n) * n + NT * 8 - 1) / (NT * 8));
  ns_select<T><<<dim3(sel_blocks, B), NT, 0, st>>>(cur, x_prev, need, out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------
// stack/w (ns_fused) or mat (newton_schulz_inverse) is null; need is null
// for newton_schulz_inverse (every problem). w1, w2, tmp: (B, n, n) work
// buffers; partial: (B, ceil(n/64)^2); denom: (B,).

#define NS_ENTRY(NAME, T)                                                      \
  extern "C" int NAME(void* stack, void* w, void* mat, void* x_prev,          \
                      void* need, void* out, void* res, void* w1, void* w2,   \
                      void* tmp, void* partial, void* denom, int B, int n,    \
                      int n_iter, int cold, void* stream) {                   \
    return run<T>(static_cast<const T*>(stack), static_cast<const T*>(w),     \
                  static_cast<const T*>(mat), static_cast<const T*>(x_prev),  \
                  static_cast<const unsigned char*>(need),                    \
                  static_cast<T*>(out), static_cast<T*>(res),                 \
                  static_cast<T*>(w1), static_cast<T*>(w2),                   \
                  static_cast<T*>(tmp), static_cast<T*>(partial),             \
                  static_cast<T*>(denom), B, n, n_iter, cold,                 \
                  static_cast<cudaStream_t>(stream));                         \
  }

NS_ENTRY(ns_run_f32, float)
NS_ENTRY(ns_run_f64, double)
