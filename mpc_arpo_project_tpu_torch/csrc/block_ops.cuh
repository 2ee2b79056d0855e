// Block-level vector helpers shared by the per-problem-slot kernels.
//
// Copied from csrc/eig_chunk.cu (which keeps its own copy): NaN-propagating
// max/min, block reductions, and the two matrix-vector products of a
// 256-thread block on row-major matrices read through L2 —
//   matvec: out[i] = sum_j M[i, j] v[j], a warp per row, lanes along it;
//   vecmat: out[j] = sum_i v[i] M[i, j], a thread per column walking down
//           the rows in eight interleaved FMA chains (dot_col).
// Both read M coalesced, so no transposed copies are needed.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// NaN-propagating max/min (jnp.maximum / torch.maximum semantics).
template <typename T>
__device__ __forceinline__ T pmax(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T pmin(T a, T b) {
  return (a != a) ? a : ((b != b) ? b : (a < b ? a : b));
}

struct SumOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return a + b; }
};
struct MaxOp {
  template <typename T>
  __device__ __forceinline__ T operator()(T a, T b) const { return pmax(a, b); }
};

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reduce one value per thread over the block; every thread gets the result.
template <typename T, typename Op>
__device__ T block_reduce(T v, T* red, Op op) {
  for (int o = 16; o > 0; o >>= 1) v = op(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0) red[w] = v;
  __syncthreads();
  v = red[0];
  for (int i = 1; i < kWarps; ++i) v = op(v, red[i]);
  return v;
}

// sum_{i0 <= i < i1} v[i] * M[i, j]: eight interleaved FMA chains, summed
// pairwise — independent chains hide FMA latency, and the shorter chains
// keep fp32 round-off near a blocked GEMM's (a single chain over 512 rows
// measured ~10x the plain version's error in the eig chunk).
template <typename T>
__device__ __forceinline__ T dot_col(const T* __restrict__ M, int ncol, int j,
                                     const T* v, int i0, int i1) {
  T acc[8] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  int i = i0;
  for (; i + 8 <= i1; i += 8) {
#pragma unroll
    for (int q = 0; q < 8; ++q)
      acc[q] = fma(v[i + q], __ldg(M + static_cast<size_t>(i + q) * ncol + j),
                   acc[q]);
  }
  for (; i < i1; ++i)
    acc[0] = fma(v[i], __ldg(M + static_cast<size_t>(i) * ncol + j), acc[0]);
  return ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
         ((acc[4] + acc[5]) + (acc[6] + acc[7]));
}

// out[j] = sum_i v[i] * M[i, j] for row-major M (nrow x ncol); v and out in
// shared memory. A thread per column; when ncol < kThreads / 2 the rows are
// split over kThreads / ncol groups whose partial sums go through `part`
// (kThreads entries).
template <typename T>
__device__ void vecmat(const T* __restrict__ M, const T* v, T* out, int nrow,
                       int ncol, T* part) {
  const int groups = kThreads / ncol;
  if (groups <= 1) {
    for (int j = threadIdx.x; j < ncol; j += kThreads)
      out[j] = dot_col(M, ncol, j, v, 0, nrow);
  } else {
    const int j = threadIdx.x % ncol, g = threadIdx.x / ncol;
    if (g < groups) {
      const int rows = (nrow + groups - 1) / groups;
      const int i0 = g * rows, i1 = min(nrow, i0 + rows);
      part[g * ncol + j] = dot_col(M, ncol, j, v, i0, i1);
    }
    __syncthreads();
    for (int jj = threadIdx.x; jj < ncol; jj += kThreads) {
      T acc = part[jj];
      for (int gg = 1; gg < groups; ++gg) acc += part[gg * ncol + jj];
      out[jj] = acc;
    }
  }
  __syncthreads();
}

// out[i] = sum_j M[i, j] * v[j] for row-major M (nrow x ncol): a warp per
// row, lanes striding along it.
template <typename T>
__device__ void matvec(const T* __restrict__ M, const T* v, T* out, int nrow,
                       int ncol) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  for (int i = w; i < nrow; i += kWarps) {
    const T* row = M + static_cast<size_t>(i) * ncol;
    T acc = T(0);
    for (int j = lane; j < ncol; j += 32) acc = fma(__ldg(row + j), v[j], acc);
    acc = warp_sum(acc);
    if (lane == 0) out[i] = acc;
  }
  __syncthreads();
}

}  // namespace
