// Chunk-parts timing probe, for Hopper (sm_90a).
//
// Replaces the six Pallas TPU kernels of
//   tools/kernel_probe.py::main (the bodies of its one pallas_call)
// and computes what their plain torch twins
//   mpc_arpo_project_tpu_torch/tools/kernel_probe.py::*_ref
// compute. Each variant maps x (B, nz) to out (B, nz) through n_it dependent
// iterations inside one launch, in fp32 on the CUDA cores (no TF32):
//   matvec_pair     x <- 1e-3 (x a0') a0, a0 (m, nz) shared by every problem
//   minv_rowvec     x_p <- x_p Minv_p (row vector times the problem's matrix)
//   minv_lhs        x_p <- (Minv_p x_p')' (the same data, other orientation)
//   minv_bf16       hi = bf16(M), lo = bf16(M - hi), xb = bf16(x_p);
//                   x_p <- xb hi + xb lo (exact products, fp32 sums; M is
//                   read in fp32 and split here, as the TPU kernel does)
//   minv_blockdiag  the tile's x expanded to (bt, bt nz) under the
//                   block-diagonal mask, times the tile's Minv flattened to
//                   (bt nz, nz): bt-fold redundant MACs, kept on purpose
//   stack7          xs = x s7 (s7 nz x 7nz shared); x <- 1e-3 sum_t
//                   (0.1 + t) xs[:, t nz:(t+1) nz]
//
// Design. The probe measures the parts of the chunk kernels
// (csrc/admm_chunk.cu, csrc/eig_chunk.cu) as those kernels do them, so five
// variants use the chunk kernels' layout: one 256-thread block per problem,
// the problem's vectors in shared memory, the block_ops.cuh products (a warp
// per row for M v, a thread per column in eight FMA chains for v M). The
// shared matrices (a0 512 KiB, s7 1.8 MiB) are read through L2 by every
// block; the per-problem Minv (256 KiB, 256 MiB for 1024 problems) streams
// from HBM on every iteration. The block-diagonal variant keeps the TPU's
// layout instead: one (bt, bt nz) x (bt nz, nz) product per tile and
// iteration, its nz output columns split over a cluster of 8 blocks (so
// B/bt tiles fill 8 B/bt blocks: 256 at B=1024, bt=32), the tile's x in
// shared memory, the iterate exchanged through L2 behind a cluster barrier.
//
// What bounds it (nz=256, m=512, B=1024, n_it=25, fp32): matvec_pair and
// stack7 are bound by operations (13.4 and 23.5 GFLOP, 0.20 and 0.35 ms at
// 67 TFLOP/s) if the shared matrices are read from L2 fast enough; the
// three Minv variants by the HBM stream of Minv (6.7 GB, 2.0 ms at 3.35
// TB/s); the block-diagonal one by its 107 GFLOP of executed (mostly zero)
// MACs, 1.6 ms.

#include <cooperative_groups.h>
#include <cuda_bf16.h>

#include "block_ops.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;   // blocks per tile in the block-diagonal variant
constexpr int kRowsPerThread = 4;  // bt <= 8 warps x 4 rows = 32

struct ProbeArgs {
  const float* x;    // (B, nz)
  const float* mat;  // a0 (m, nz), Minv (B, nz, nz), mflat (B/bt, bt nz, nz)
                     // or s7 (nz, 7 nz)
  float* out;        // (B, nz)
  float* buf;        // (2, B, nz) iterate exchange (block-diagonal only)
  int B, bt, nz, m, n_it;
};

__device__ __forceinline__ void load_row(const ProbeArgs& a, float* sx) {
  const size_t o = static_cast<size_t>(blockIdx.x) * a.nz;
  for (int j = threadIdx.x; j < a.nz; j += kThreads) sx[j] = a.x[o + j];
  __syncthreads();
}

__device__ __forceinline__ void store_row(const ProbeArgs& a, const float* sx) {
  const size_t o = static_cast<size_t>(blockIdx.x) * a.nz;
  for (int j = threadIdx.x; j < a.nz; j += kThreads) a.out[o + j] = sx[j];
}

// x <- 1e-3 (a0 x) a0: y = a0 x (a warp per row of a0), x = 1e-3 y a0.
__global__ void __launch_bounds__(kThreads) matvec_pair_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* sx = smem;
  float* sy = sx + a.nz;
  float* part = sy + a.m;
  load_row(a, sx);
  for (int it = 0; it < a.n_it; ++it) {
    matvec(a.mat, sx, sy, a.m, a.nz);
    vecmat(a.mat, sy, sx, a.m, a.nz, part);
    for (int j = threadIdx.x; j < a.nz; j += kThreads) sx[j] = 1e-3f * sx[j];
    __syncthreads();
  }
  store_row(a, sx);
}

// x_p <- x_p Minv_p: a thread per column of Minv_p, eight FMA chains.
__global__ void __launch_bounds__(kThreads) minv_rowvec_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = cur + a.nz;
  float* part = nxt + a.nz;
  const float* M = a.mat + static_cast<size_t>(blockIdx.x) * a.nz * a.nz;
  load_row(a, cur);
  for (int it = 0; it < a.n_it; ++it) {
    vecmat(M, cur, nxt, a.nz, a.nz, part);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  store_row(a, cur);
}

// x_p <- Minv_p x_p': a warp per row of Minv_p, lanes along the row.
__global__ void __launch_bounds__(kThreads) minv_lhs_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = cur + a.nz;
  const float* M = a.mat + static_cast<size_t>(blockIdx.x) * a.nz * a.nz;
  load_row(a, cur);
  for (int it = 0; it < a.n_it; ++it) {
    matvec(M, cur, nxt, a.nz, a.nz);
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  store_row(a, cur);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// x_p <- xb hi + xb lo with hi = bf16(M), lo = bf16(M - hi), xb = bf16(x_p):
// each product of two bf16 values is exact in fp32; the hi and lo sums run
// apart (eight chains each, as dot_col) and are added at the end, as the TPU
// kernel adds its two products.
__global__ void __launch_bounds__(kThreads) minv_bf16_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* xb = cur + a.nz;
  const int nz = a.nz;
  const float* M = a.mat + static_cast<size_t>(blockIdx.x) * nz * nz;
  load_row(a, cur);
  for (int it = 0; it < a.n_it; ++it) {
    for (int i = threadIdx.x; i < nz; i += kThreads) xb[i] = bf16_round(cur[i]);
    __syncthreads();
    for (int j = threadIdx.x; j < nz; j += kThreads) {
      float ah[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      float al[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      int i = 0;
      for (; i + 8 <= nz; i += 8) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const float mv = __ldg(M + static_cast<size_t>(i + q) * nz + j);
          const float hi = bf16_round(mv);
          const float lo = bf16_round(mv - hi);
          ah[q] = fmaf(xb[i + q], hi, ah[q]);
          al[q] = fmaf(xb[i + q], lo, al[q]);
        }
      }
      for (; i < nz; ++i) {
        const float mv = __ldg(M + static_cast<size_t>(i) * nz + j);
        const float hi = bf16_round(mv);
        ah[0] = fmaf(xb[i], hi, ah[0]);
        al[0] = fmaf(xb[i], bf16_round(mv - hi), al[0]);
      }
      const float sh = ((ah[0] + ah[1]) + (ah[2] + ah[3])) +
                       ((ah[4] + ah[5]) + (ah[6] + ah[7]));
      const float sl = ((al[0] + al[1]) + (al[2] + al[3])) +
                       ((al[4] + al[5]) + (al[6] + al[7]));
      cur[j] = sh + sl;  // xb holds this iteration's input; cur is free
    }
    __syncthreads();
  }
  store_row(a, cur);
}

// One tile of bt problems per cluster of kCluster blocks; block `rank` owns
// output columns [rank cpb, (rank + 1) cpb) for all bt rows. Thread (g, c):
// column c of the block's slice, rows g, g + 8, g + 16, g + 24. The tile's x
// sits in shared memory; element (p, k) of the expanded (bt, bt nz) operand
// is x[k div nz, k mod nz] times the mask [k div nz == p] (x[p, k mod nz]
// wherever the mask is 1, as the TPU kernel's concatenate-and-mask has it),
// formed per element, and every one of the bt nz rows of the flattened Minv
// is multiplied in.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    minv_blockdiag_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float xs[];  // (bt, nz)
  cg::cluster_group cluster = cg::this_cluster();
  const int nz = a.nz, bt = a.bt;
  const int tile = blockIdx.x / kCluster;
  const int rank = blockIdx.x % kCluster;
  const int cpb = (nz + kCluster - 1) / kCluster;
  const int c = threadIdx.x & 31, g = threadIdx.x >> 5;
  const int col = rank * cpb + c;
  const bool col_ok = c < cpb && col < nz;
  const int tile_elems = bt * nz;
  const size_t xo = static_cast<size_t>(tile) * tile_elems;
  const float* mf = a.mat + xo * nz;  // (bt nz, nz) of this tile
  const float* src = a.x + xo;
  if (a.n_it == 0 && rank == 0)
    for (int e = threadIdx.x; e < tile_elems; e += kThreads)
      a.out[xo + e] = src[e];
  for (int it = 0; it < a.n_it; ++it) {
    for (int e = threadIdx.x; e < tile_elems; e += kThreads)
      xs[e] = __ldcg(src + e);  // L2: written by the cluster's other blocks
    __syncthreads();
    float acc[kRowsPerThread] = {0.f, 0.f, 0.f, 0.f};
    if (col_ok) {
      for (int kb = 0; kb < bt; ++kb) {
        float mask[kRowsPerThread];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r)
          mask[r] = (g + 8 * r == kb) ? 1.f : 0.f;
        const float* mcol = mf + static_cast<size_t>(kb) * nz * nz + col;
        const float* xrow = xs + kb * nz;
        for (int kk = 0; kk < nz; ++kk) {
          const float mv = __ldg(mcol + static_cast<size_t>(kk) * nz);
          const float xv = xrow[kk];
#pragma unroll
          for (int r = 0; r < kRowsPerThread; ++r)
            acc[r] = fmaf(xv * mask[r], mv, acc[r]);
        }
      }
    }
    float* dst = (it + 1 == a.n_it)
                     ? a.out + xo
                     : a.buf + static_cast<size_t>(it & 1) * a.B * nz + xo;
    if (col_ok) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int p = g + 8 * r;
        if (p < bt) dst[p * nz + col] = acc[r];
      }
    }
    cluster.sync();  // release the slice, acquire the others'
    src = dst;
  }
}

// x <- 1e-3 sum_t (0.1 + t) (x s7)[:, t nz:(t+1) nz], the terms added in
// order t = 0..6 as the twin adds them.
__global__ void __launch_bounds__(kThreads) stack7_kernel(ProbeArgs a) {
  extern __shared__ __align__(16) float smem[];
  float* cur = smem;
  float* nxt = cur + a.nz;
  const int nz = a.nz, ld = 7 * nz;
  load_row(a, cur);
  for (int it = 0; it < a.n_it; ++it) {
    for (int j = threadIdx.x; j < nz; j += kThreads) {
      float acc = static_cast<float>(0.1) * dot_col(a.mat, ld, j, cur, 0, nz);
#pragma unroll
      for (int t = 1; t < 7; ++t)
        acc = acc + static_cast<float>(0.1 + t) *
                        dot_col(a.mat, ld, t * nz + j, cur, 0, nz);
      nxt[j] = 1e-3f * acc;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  store_row(a, cur);
}

template <typename K>
int launch(K kernel, int blocks, size_t smem, const ProbeArgs& a,
           void* stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------
// variant: 0 matvec_pair, 1 minv_rowvec, 2 minv_lhs, 3 minv_bf16,
// 4 minv_blockdiag, 5 stack7. Returns a cudaError_t (0 on success); -1 for
// an unknown variant.
extern "C" int probe_run(int variant, const void* x, const void* mat,
                         void* out, void* buf, int B, int bt, int nz, int m,
                         int n_it, void* stream) {
  ProbeArgs a;
  a.x = static_cast<const float*>(x);
  a.mat = static_cast<const float*>(mat);
  a.out = static_cast<float*>(out);
  a.buf = static_cast<float*>(buf);
  a.B = B;
  a.bt = bt;
  a.nz = nz;
  a.m = m;
  a.n_it = n_it;
  if (B == 0) return 0;
  const size_t f = sizeof(float);
  switch (variant) {
    case 0:
      return launch(matvec_pair_kernel, B, f * (nz + m + kThreads), a, stream);
    case 1:
      return launch(minv_rowvec_kernel, B, f * (2 * nz + kThreads), a, stream);
    case 2:
      return launch(minv_lhs_kernel, B, f * 2 * nz, a, stream);
    case 3:
      return launch(minv_bf16_kernel, B, f * 2 * nz, a, stream);
    case 4:
      return launch(minv_blockdiag_kernel, (B / bt) * kCluster,
                    f * static_cast<size_t>(bt) * nz, a, stream);
    case 5:
      return launch(stack7_kernel, B, f * 2 * nz, a, stream);
    default:
      return -1;
  }
}
