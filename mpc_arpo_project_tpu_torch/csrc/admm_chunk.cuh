// Fused 'pallas'-mode ADMM chunk, for Hopper (sm_90a): the kernel, its
// launch and its C entries. Three files instantiate it, each for its own
// layouts and built as a library of its own, so that the builds run side
// by side: admm_chunk.cu (fp32, one slot or slot groups a block),
// admm_cluster.cu (fp32 clusters), admm_chunk_f64.cu (fp64). Each defines
// ADMM_LAYOUTS(X) as its list of X(C, S) before including this file and
// invokes ADMM_CHUNK_ENTRY after.
//
// Replaces the Pallas TPU kernel
//   mpc_arpo_project_tpu/ops/admm_pallas.py::_chunk_kernel
// and computes what its plain torch twin
//   mpc_arpo_project_tpu_torch/ops/admm_pallas.py::admm_chunk_ref
// computes: n_iter OSQP iterations of each live problem slot,
//   rhs = sigma x - qbar + A'(rho z - y)
//   xt  = rhs Minv, then ir_steps refinements xt += (rhs - M xt) Minv with
//         M xt = sum_t w7[t] (xt stack7[:, t nz:(t+1) nz]) (the true normal
//         matrix from the 7-term structured stack)
//   zt  = A xt, where A v = A0 v + scat'(wsel * (gsel' v)) and wsel is the
//         slot's [c1 | c2 | s] over the 3 gw correction lanes
//   relaxation (alpha), clip to [lbar, ubar], y update
// then the scaled residuals and the Farkas pinf/dinf certificates of the
// chunk's accumulated dy, dx. Stats per slot: rp, rp_rel, rd, rd_rel, pinf,
// dinf, |dy|_inf, |dx|_inf. A done slot passes x, y, z through with zero
// stats (a pass-through kernel launched first writes them).
//
// Layouts. The grid covers the live slots only (the caller's slot list:
// live slots first); a layout (C, S) serves them as
// * a thread-block cluster of C blocks per slot (C = 2, 8; S = 1), for
//   calls with few live slots, where one block per slot leaves most SMs idle
//   and each slot's iteration is a chain of L2 round trips on one SM. Block
//   `rank` owns 1/C of the output columns of every v M product (A0', gsel,
//   rsel, scat, gscat, each stack7 block, Minv, Pbar) and 1/C of the rows
//   of A0 v. After each product the blocks push their slices into each
//   other's copies of the vector through distributed shared memory and meet
//   at a cluster barrier: seven exchanges an iteration. The elementwise
//   updates run in every block on the replicated vectors. The slot's Minv
//   column slice (nz x nz/C) is loaded into shared memory once and kept for
//   the whole chunk, so Minv no longer streams from HBM.
// * a group of S slots per block (S = 1, 2, 4, 8; C = 1), for wide calls:
//   slot vectors interleaved in shared memory (~26 KB per slot in fp32), each
//   shared-matrix element read from L2 once for the S slots; each slot's
//   Minv still streams from HBM on every apply.
// Every layout gives the bits of C = S = 1, which are those of the one-slot
// kernel of the port's first 'pallas' version: each dot product keeps its
// eight interleaved FMA chains (dot_col) and their pairwise sum, split over
// C threads a column in the cluster layout (each thread 8/C chains, the
// partial sums added in the same tree); each A0 row keeps its warp of 32
// lane chains and butterfly; the end-of-chunk reductions run on one block's
// 256 threads in the one-slot kernel's map; the elementwise expressions are
// written with the contractions nvcc chose there.
//
// What bounds it. Per problem-iteration at nz=256, m=512, gw=64, ir_steps=1
// the chunk does ~1.15 M FMAs and reads as many matrix elements, so the
// FLOP bound of a full 1024-slot, 25-iteration chunk is ~0.9 ms on the
// H100's 67 TFLOP/s fp32 CUDA cores. With slot groups the shared matrices
// come from L2 once per group (S times fewer reads than one slot per
// block); each slot's Minv (256 KiB in fp32) still streams from HBM
// 1 + ir_steps times an iteration, 13.4 GB for 1024 slots, ~4.0 ms at
// 3.35 TB/s: that stream is the floor of the wide layout. A narrow call is
// bound by latency: C blocks split each slot's L2 reads C ways and meet at
// seven cluster barriers an iteration.

#pragma once

#include <cooperative_groups.h>

#include <algorithm>
#include <type_traits>

#include "block_ops.cuh"

namespace cg = cooperative_groups;

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
  const int* slots;  // (n_grid,): the slots the grid serves, live first
  int n_grid, nz, m, gw, n_iter, ir_steps;
  T sigma, alpha, one_m_alpha, eps_pinf, eps_dinf, thresh;
};

// Rounded arithmetic that nvcc may not contract: the elementwise updates
// are written out with the contractions nvcc chose in the one-slot kernel
// (its SASS: which mul/add pairs became one FFMA/DFMA), so that every
// layout, whatever the context, rounds as that kernel did.
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}

// Pairwise sum of N consecutive chain sums: dot_col's
// ((a0+a1)+(a2+a3))+((a4+a5)+(a6+a7)) for N = 8, its sub-trees below.
template <int N, typename T>
__device__ __forceinline__ T tree(const T* h) {
  if constexpr (N == 1) {
    return h[0];
  } else {
    return add_rn(tree<N / 2>(h), tree<N / 2>(h + N / 2));
  }
}

// Columns [c0, c0 + nc) of one block's share of an ncol-wide product.
struct Slice {
  int c0, nc;
};
template <int C>
__device__ __forceinline__ Slice slice(int ncol, int rank) {
  const int per = (ncol + C - 1) / C;
  const int c0 = min(ncol, rank * per);
  return {c0, min(ncol, c0 + per) - c0};
}

// The S slot values v[0..S) of one row of slot-interleaved vectors, in
// vector loads where the alignment allows (shared memory).
template <typename T, int S>
__device__ __forceinline__ void vload(const T* p, T (&out)[S]) {
  if constexpr (sizeof(T) == 4 && S % 4 == 0) {
#pragma unroll
    for (int q = 0; q < S / 4; ++q) {
      const float4 f = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = f.x;
      out[4 * q + 1] = f.y;
      out[4 * q + 2] = f.z;
      out[4 * q + 3] = f.w;
    }
  } else if constexpr (sizeof(T) == 4 && S == 2) {
    const float2 f = *reinterpret_cast<const float2*>(p);
    out[0] = f.x;
    out[1] = f.y;
  } else if constexpr (sizeof(T) == 8 && S % 2 == 0) {
#pragma unroll
    for (int q = 0; q < S / 2; ++q) {
      const double2 f = reinterpret_cast<const double2*>(p)[q];
      out[2 * q] = f.x;
      out[2 * q + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = p[s];
  }
}

// For the nc columns of M (row-major, leading dimension ld; with K > 1 also
// the columns kst, 2 kst, ... further on) and the S slots' nrow-vectors v
// (v[i * VS + s]), call epi(c, s, d) with d[t] = sum_i v[i*VS+s]
// M[i, c + t kst], summed as dot_col sums it: eight chains over the rows
// i = q mod 8 (the rows past the last full eight into chain 0), then the
// pairwise tree. P threads share a column, each with 8/P chains
// (q = p * 8/P + k), their partial trees added by one thread through
// `part`. Each thread issues the loads of several row-steps (up to B
// loads, as its registers allow) before their FMAs.
template <typename T, int S, int P, int K, int VS, int B, class Epi>
__device__ __forceinline__ void cols(const T* __restrict__ M, int ld, int kst,
                                     int nrow, const T* v, int nc, T* part,
                                     Epi epi) {
  constexpr int R = 8 / P;                     // chains a thread
  constexpr int L = K * R;                     // loads a row-step
  constexpr int U = L >= B ? 1 : B / L;        // row-steps a batch
  const int full = nrow & ~7;
  const int nsteps = full >> 3;
  for (int u = threadIdx.x; u < nc * P; u += kThreads) {
    const int c = u % nc, p = u / nc;
    const T* Mc = M + c;
    T acc[S][K][R];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int t = 0; t < K; ++t)
#pragma unroll
        for (int k = 0; k < R; ++k) acc[s][t][k] = T(0);
    for (int st = 0; st < nsteps; st += U) {
      T mv[U][K][R];
#pragma unroll
      for (int b = 0; b < U; ++b)
        if (st + b < nsteps) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const size_t row = static_cast<size_t>(((st + b) << 3) + p * R + k);
#pragma unroll
            for (int t = 0; t < K; ++t)
              mv[b][t][k] = __ldg(Mc + row * ld + t * kst);
          }
        }
#pragma unroll
      for (int b = 0; b < U; ++b)
        if (st + b < nsteps) {
#pragma unroll
          for (int k = 0; k < R; ++k) {
            const int i = ((st + b) << 3) + p * R + k;
            T vv[S];
            vload<T, S>(v + i * VS, vv);
#pragma unroll
            for (int t = 0; t < K; ++t)
#pragma unroll
              for (int s = 0; s < S; ++s)
                acc[s][t][k] = fma(vv[s], mv[b][t][k], acc[s][t][k]);
          }
        }
    }
    if (p == 0)
      for (int i = full; i < nrow; ++i) {
        T vv[S];
        vload<T, S>(v + i * VS, vv);
#pragma unroll
        for (int t = 0; t < K; ++t) {
          const T mi = __ldg(Mc + static_cast<size_t>(i) * ld + t * kst);
#pragma unroll
          for (int s = 0; s < S; ++s)
            acc[s][t][0] = fma(vv[s], mi, acc[s][t][0]);
        }
      }
    if constexpr (P == 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        T d[K];
#pragma unroll
        for (int t = 0; t < K; ++t) d[t] = tree<8>(acc[s][t]);
        epi(c, s, d);
      }
    } else {
#pragma unroll
      for (int t = 0; t < K; ++t)
        part[(t * P + p) * nc + c] = tree<R>(acc[0][t]);
    }
  }
  if constexpr (P > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      T d[K];
#pragma unroll
      for (int t = 0; t < K; ++t) {
        T h[P];
#pragma unroll
        for (int p = 0; p < P; ++p) h[p] = part[(t * P + p) * nc + c];
        d[t] = tree<P>(h);
      }
      epi(c, 0, d);
    }
    __syncthreads();  // part is reused by the next product
  }
}

// cols for one slot's matrix in shared memory (the cluster layout's Minv
// column slice, ld apart).
template <typename T, int P, class Epi>
__device__ __forceinline__ void cols_smem(const T* M, int ld, int nrow,
                                          const T* v, int nc, T* part,
                                          Epi epi) {
  constexpr int R = 8 / P;
  const int full = nrow & ~7;
  for (int u = threadIdx.x; u < nc * P; u += kThreads) {
    const int c = u % nc, p = u / nc;
    T acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = T(0);
#pragma unroll 4
    for (int i = 0; i < full; i += 8)
#pragma unroll
      for (int k = 0; k < R; ++k)
        acc[k] = fma(v[i + p * R + k], M[(i + p * R + k) * ld + c], acc[k]);
    if (p == 0)
      for (int i = full; i < nrow; ++i)
        acc[0] = fma(v[i], M[i * ld + c], acc[0]);
    if constexpr (P == 1) {
      const T d[1] = {tree<8>(acc)};
      epi(c, 0, d);
    } else {
      part[p * nc + c] = tree<R>(acc);
    }
  }
  if constexpr (P > 1) {
    __syncthreads();
    for (int c = threadIdx.x; c < nc; c += kThreads) {
      T h[P];
#pragma unroll
      for (int p = 0; p < P; ++p) h[p] = part[p * nc + c];
      const T d[1] = {tree<P>(h)};
      epi(c, 0, d);
    }
    __syncthreads();
  }
}

// A block of the cluster (C > 1) or a lone block (C == 1).
template <int C>
struct Team {
  // v into element e of `vec` in every block of the cluster
  template <typename T>
  __device__ __forceinline__ static void put(T* vec, int e, T v) {
    if constexpr (C == 1) {
      vec[e] = v;
    } else {
      cg::cluster_group cl = cg::this_cluster();
#pragma unroll
      for (int r = 0; r < C; ++r) cl.map_shared_rank(vec, r)[e] = v;
    }
  }
  // every block's puts are visible to every block
  __device__ __forceinline__ static void sync() {
    if constexpr (C == 1) {
      __syncthreads();
    } else {
      cg::this_cluster().sync();
    }
  }
};

template <typename T, int C, int S>
struct Kernel {
  using Tm = Team<C>;
  static constexpr int P = C;  // threads a column (the cluster layout)
  // loads a thread keeps in flight: 32 registers' worth where the launch
  // bounds leave room (16 for one fp32 slot a block, at 64 registers)
  static constexpr int B = (sizeof(T) == 4 && !(C == 1 && S == 1)) ? 32 : 16;

  const Args<T>& a;
  int rank, nz, m, gw3;
  Slice sz_, sm_, sg_;  // this block's columns of nz-, m- and 3gw-wide products
  T c1[S], c2[S], sv[S], w7[S][7];
  T* g;     // 3 gw correction lanes (S-interleaved)
  T* part;  // chain partials (P > 1)
  T* tnz;   // scratch: the A0' part of A' w (nz)
  T* tm;    // scratch: the A0 part of A v (m)

  __device__ __forceinline__ T weight(int k, int s) const {
    const int gw = a.gw;
    return k < gw ? c1[s] : (k < 2 * gw ? c2[s] : sv[s]);
  }

  // out = A' w over the S slots: epi(j, s, value) on this block's columns
  // j; every block's values are in place after the call.
  template <class Epi>
  __device__ __forceinline__ void apply_AT(const T* w, Epi epi) {
    cols<T, S, P, 1, S, B>(a.rsel + sg_.c0, gw3, 0, m, w, sg_.nc, part,
                        [&](int c, int s, const T* d) {
                          const int k = sg_.c0 + c;
                          Tm::put(g, k * S + s, mul_rn(weight(k, s), d[0]));
                        });
    cols<T, S, P, 1, S, B>(a.a0 + sz_.c0, nz, 0, m, w, sz_.nc, part,
                        [&](int c, int s, const T* d) {
                          tnz[(sz_.c0 + c) * S + s] = d[0];
                        });
    Tm::sync();
    cols<T, S, P, 1, S, B>(a.gscat + sz_.c0, nz, 0, gw3, g, sz_.nc, part,
                        [&](int c, int s, const T* d) {
                          const int j = sz_.c0 + c;
                          epi(j, s, add_rn(tnz[j * S + s], d[0]));
                        });
    Tm::sync();
  }

  // out = A v over the S slots: epi(i, s, value) on this block's rows i.
  template <class Epi>
  __device__ __forceinline__ void apply_A(const T* v, Epi epi) {
    // A0 v on this block's rows: a warp per row, lanes along it (each
    // lane's chain j = lane, lane + 32, ...), the S slots' sums each reduced
    // by warp_sum; a warp loads RB rows at once
    constexpr int RB = 4;
    const int lane = threadIdx.x & 31, wp = threadIdx.x >> 5;
    const int r1 = sm_.c0 + sm_.nc;
    for (int i0 = sm_.c0 + wp; i0 < r1; i0 += kWarps * RB) {
      T acc[RB][S];
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int s = 0; s < S; ++s) acc[q][s] = T(0);
#pragma unroll 2
      for (int j = lane; j < nz; j += 32) {
        T mv[RB];
#pragma unroll
        for (int q = 0; q < RB; ++q) {
          const int i = min(i0 + q * kWarps, r1 - 1);
          mv[q] = __ldg(a.a0 + static_cast<size_t>(i) * nz + j);
        }
        T vv[S];
        vload<T, S>(v + j * S, vv);
#pragma unroll
        for (int q = 0; q < RB; ++q)
#pragma unroll
          for (int s = 0; s < S; ++s) acc[q][s] = fma(mv[q], vv[s], acc[q][s]);
      }
#pragma unroll
      for (int q = 0; q < RB; ++q)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const T r = warp_sum(acc[q][s]);
          const int i = i0 + q * kWarps;
          if (lane == 0 && i < r1) tm[i * S + s] = r;
        }
    }
    cols<T, S, P, 1, S, B>(a.gsel + sg_.c0, gw3, 0, nz, v, sg_.nc, part,
                        [&](int c, int s, const T* d) {
                          const int k = sg_.c0 + c;
                          Tm::put(g, k * S + s, mul_rn(weight(k, s), d[0]));
                        });
    Tm::sync();
    cols<T, S, P, 1, S, B>(a.scat + sm_.c0, m, 0, gw3, g, sm_.nc, part,
                        [&](int c, int s, const T* d) {
                          const int i = sm_.c0 + c;
                          epi(i, s, add_rn(tm[i * S + s], d[0]));
                        });
    Tm::sync();
  }

  // out = v Pbar over the S slots, put into every block's `out`
  __device__ __forceinline__ void apply_P(const T* v, T* out) {
    cols<T, S, P, 1, S, B>(a.pbar + sz_.c0, nz, 0, nz, v, sz_.nc, part,
                        [&](int c, int s, const T* d) {
                          Tm::put(out, (sz_.c0 + c) * S + s, d[0]);
                        });
    Tm::sync();
  }

  // The refinement residual rhs - M xt = v3 - sum_t w7[t] (v stack_t), put
  // into every block's `out`, the weighted sum in the one-slot kernel's
  // contraction: fma(w0, d0, w1 d1), then fma(w_t, d_t, .) for t = 2..6.
  // One pass over the seven column blocks where a thread's chains allow
  // (the cluster layouts), else a pass a block.
  __device__ __forceinline__ void apply_M(const T* v, const T* v3, T* out) {
    const T* st7 = a.stack7 + sz_.c0;
    if constexpr (S == 1 && P > 1) {
      cols<T, 1, P, 7, 1, B>(st7, 7 * nz, nz, nz, v, sz_.nc, part,
                          [&](int c, int s, const T* d) {
                            T acc = fma(w7[0][0], d[0], mul_rn(w7[0][1], d[1]));
#pragma unroll
                            for (int t = 2; t < 7; ++t)
                              acc = fma(w7[0][t], d[t], acc);
                            const int j = sz_.c0 + c;
                            Tm::put(out, j, sub_rn(v3[j], acc));
                          });
    } else {
      for (int t = 0; t < 7; ++t)
        cols<T, S, P, 1, S, B>(st7 + t * nz, 7 * nz, 0, nz, v, sz_.nc, part,
                            [&](int c, int s, const T* d) {
          const int e = (sz_.c0 + c) * S + s;
          if (t == 0) {
            out[e] = d[0];
          } else if (t == 1) {
            out[e] = fma(w7[s][0], out[e], mul_rn(w7[s][1], d[0]));
          } else if (t < 6) {
            out[e] = fma(w7[s][t], d[0], out[e]);
          } else {
            Tm::put(out, e, sub_rn(v3[e], fma(w7[s][6], d[0], out[e])));
          }
        });
    }
    Tm::sync();
  }
};

// At most 64 registers a thread for one fp32 slot a block (four blocks an
// SM, as the one-slot kernel), 128 for two or four slots (two blocks an SM);
// a group of eight fills an SM's shared memory alone. Cluster blocks: two
// an SM.
template <typename T, int C, int S>
struct Bounds {
  static constexpr int min_blocks =
      C > 1 ? 2 : (S == 1 ? 16 / sizeof(T) : (S == 8 ? 1 : 2));
};

// Chain partials of a cluster block: C partial sums of each of its columns
// of the widest product, or of its nz/C columns in the seven stack blocks.
template <int C>
__host__ __device__ __forceinline__ int part_elems(int nz, int wide) {
  const int a = C * ((wide + C - 1) / C), b = 7 * C * ((nz + C - 1) / C);
  return a > b ? a : b;
}

// Shared-memory elements of one block: the S slots' vectors (8 of nz, 8 of
// m, the 3 gw lanes), the chain partials, the reduction scratch, and (C > 1)
// the slot's Minv column slice.
template <typename T, int C, int S>
size_t smem_elems(int nz, int m, int gw) {
  const int wide = std::max(std::max(nz, m), 3 * gw);
  size_t n = static_cast<size_t>(S) * (8 * nz + 8 * m + 3 * gw) + 32 +
             (C > 1 ? part_elems<C>(nz, wide) : 0);
  if (C > 1) n += static_cast<size_t>(nz) * ((nz + C - 1) / C);
  return n;
}

template <typename T, int C, int S>
__global__ void __launch_bounds__(kThreads, (Bounds<T, C, S>::min_blocks))
    admm_chunk_kernel(Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = a.nz, m = a.m, gw3 = 3 * a.gw, tid = threadIdx.x;
  const int group = blockIdx.x / C;
  const int rank = C > 1 ? static_cast<int>(cg::this_cluster().block_rank())
                         : 0;
  // the group's slots; a lane past the list or on a done slot computes on
  // the group's first slot and writes nothing
  int slot[S];
  bool active[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int e = group * S + s;
    slot[s] = a.slots[e < a.n_grid ? e : group * S];
    active[s] = e < a.n_grid && !a.done[slot[s]];
  }

  T* sx = sm;                 // the 8 nz vectors
  T* sq = sx + S * nz;
  T* v1 = sq + S * nz;
  T* v2 = v1 + S * nz;
  T* v3 = v2 + S * nz;
  T* v4 = v3 + S * nz;
  T* v5 = v4 + S * nz;
  T* tnz = v5 + S * nz;
  T* sy = tnz + S * nz;       // the 8 m vectors
  T* szv = sy + S * m;
  T* slb = szv + S * m;
  T* sub = slb + S * m;
  T* srho = sub + S * m;
  T* sw = srho + S * m;
  T* sAx = sw + S * m;
  T* tm = sAx + S * m;
  T* sg = tm + S * m;         // 3 gw lanes
  T* red = sg + S * gw3;      // 32
  T* part = red + 32;
  const int wide = max(max(nz, m), gw3);
  T* sminv = part + (C > 1 ? part_elems<C>(nz, wide) : 0);

  Kernel<T, C, S> k{a, rank, nz, m, gw3, slice<C>(nz, rank),
                    slice<C>(m, rank), slice<C>(gw3, rank)};
  k.g = sg;
  k.part = part;
  k.tnz = tnz;
  k.tm = tm;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    k.c1[s] = a.coef[slot[s] * 4 + 1];
    k.c2[s] = a.coef[slot[s] * 4 + 2];
    k.sv[s] = a.coef[slot[s] * 4 + 3];
#pragma unroll
    for (int t = 0; t < 7; ++t) k.w7[s][t] = a.w7[slot[s] * 8 + t];
  }
  using Tm = Team<C>;

  for (int e = tid; e < S * nz; e += kThreads) {
    const size_t o = static_cast<size_t>(slot[e % S]) * nz + e / S;
    sx[e] = a.x[o];
    sq[e] = a.qbar[o];
  }
  for (int e = tid; e < S * m; e += kThreads) {
    const size_t o = static_cast<size_t>(slot[e % S]) * m + e / S;
    sy[e] = a.y[o];
    szv[e] = a.z[o];
    slb[e] = a.lbar[o];
    sub[e] = a.ubar[o];
    srho[e] = a.rho[o];
  }
  const Slice cz = k.sz_;
  if constexpr (C > 1) {
    // the slot's Minv columns [cz.c0, cz.c0 + cz.nc), kept for the chunk
    const T* mv = a.minv + static_cast<size_t>(slot[0]) * nz * nz + cz.c0;
    const int ld = (nz + C - 1) / C;
    for (int e = tid; e < nz * cz.nc; e += kThreads) {
      const int i = e / cz.nc, c = e % cz.nc;
      sminv[i * ld + c] = mv[static_cast<size_t>(i) * nz + c];
    }
  }
  Tm::sync();  // vectors loaded; every block of the cluster running

  // the S slots' Minv applies: epi(c, s, d) on this block's columns (the
  // cluster layout: from the slice in shared memory; slot groups: each
  // slot's own matrix from global memory, a slot at a time)
  auto apply_minv = [&](const T* v, auto epi) {
    if constexpr (C > 1) {
      cols_smem<T, C>(sminv, (nz + C - 1) / C, nz, v, cz.nc, part, epi);
    } else {
#pragma unroll 1
      for (int s = 0; s < S; ++s)
        cols<T, 1, 1, 1, S, Kernel<T, C, S>::B>(
            a.minv + static_cast<size_t>(slot[s]) * nz * nz,
                            nz, 0, nz, v + s, nz, part,
                            [&](int c, int, const T* d) {
                              const T dd[1] = {d[0]};
                              epi(c, s, dd);
                            });
    }
  };

  for (int it = 0; it < a.n_iter; ++it) {
    // rhs = sigma x - qbar + A'(rho z - y)  -> v3
    for (int e = tid; e < S * m; e += kThreads)
      sw[e] = fma(srho[e], szv[e], -sy[e]);
    __syncthreads();
    k.apply_AT(sw, [&](int j, int s, T v) {
      const int e = j * S + s;
      Tm::put(v3, e, add_rn(fma(a.sigma, sx[e], -sq[e]), v));
    });

    // xt = rhs Minv, refined against the true M  -> v1
    apply_minv(v3, [&](int c, int s, const T* d) {
      Tm::put(v1, (cz.c0 + c) * S + s, d[0]);
    });
    Tm::sync();
    for (int r = 0; r < a.ir_steps; ++r) {
      k.apply_M(v1, v3, v2);
      apply_minv(v2, [&](int c, int s, const T* d) {
        const int e = (cz.c0 + c) * S + s;
        Tm::put(v1, e, add_rn(v1[e], d[0]));
      });
      Tm::sync();
    }

    // zt = A xt; relaxation, clip, dual update
    k.apply_A(v1, [&](int i, int s, T v) { Tm::put(sAx, i * S + s, v); });
    for (int e = tid; e < S * m; e += kThreads) {
      const T ztmp = fma(a.alpha, sAx[e], mul_rn(a.one_m_alpha, szv[e]));
      T zn = add_rn(ztmp, div_rn(sy[e], srho[e]));
      zn = pmin(pmax(zn, slb[e]), sub[e]);
      sy[e] = fma(srho[e], sub_rn(ztmp, zn), sy[e]);
      szv[e] = zn;
    }
    for (int e = tid; e < S * nz; e += kThreads)
      sx[e] = fma(a.alpha, v1[e], mul_rn(a.one_m_alpha, sx[e]));
    __syncthreads();
  }

  if (rank == 0) {
    for (int e = tid; e < S * nz; e += kThreads)
      if (active[e % S])
        a.xo[static_cast<size_t>(slot[e % S]) * nz + e / S] = sx[e];
    for (int e = tid; e < S * m; e += kThreads)
      if (active[e % S]) {
        const size_t o = static_cast<size_t>(slot[e % S]) * m + e / S;
        a.yo[o] = sy[e];
        a.zo[o] = szv[e];
      }
  }

  // ---- the certificates' vectors: the Farkas vector of dy, projected onto
  // the polar of the recession cone of [l, u] (sw), and dx (v4)
  for (int e = tid; e < S * m; e += kThreads) {
    const T uinf = isfinite(sub[e]) ? T(0) : T(1);
    const T linf = isfinite(slb[e]) ? T(0) : T(1);
    const T uo = mul_rn(uinf, sub_rn(T(1), linf));
    const T lo = mul_rn(linf, sub_rn(T(1), uinf));
    T v = mul_rn(
        sub_rn(sy[e], a.y[static_cast<size_t>(slot[e % S]) * m + e / S]),
        fma(-uinf, linf, T(1)));
    v = fma(v, sub_rn(T(1), uo), mul_rn(pmin(v, T(0)), uo));
    v = fma(v, sub_rn(T(1), lo), mul_rn(pmax(v, T(0)), lo));
    sw[e] = v;
  }
  for (int e = tid; e < S * nz; e += kThreads)
    v4[e] = sub_rn(sx[e], a.x[static_cast<size_t>(slot[e % S]) * nz + e / S]);
  __syncthreads();

  // ---- the products: A x -> sAx, P x -> v1, A'y -> v2, A'v -> v3,
  // P dx -> v5, A dx -> srho
  k.apply_A(sx, [&](int i, int s, T v) { Tm::put(sAx, i * S + s, v); });
  k.apply_P(sx, v1);
  k.apply_AT(sy, [&](int j, int s, T v) { Tm::put(v2, j * S + s, v); });
  k.apply_AT(sw, [&](int j, int s, T v) { Tm::put(v3, j * S + s, v); });
  k.apply_P(v4, v5);
  k.apply_A(v4, [&](int i, int s, T v) { Tm::put(srho, i * S + s, v); });
  if (rank != 0) return;

  // ---- the reductions, per slot in the one-slot kernel's thread map
  const MaxOp mx{};
  const SumOp sum{};
#pragma unroll 1
  for (int s = 0; s < S; ++s) {
    T rp = T(0), ax = T(0), azz = T(0);
    for (int i = tid; i < m; i += kThreads) {
      const int e = i * S + s;
      const T ei = a.einv[i];
      rp = pmax(rp, fabs(mul_rn(ei, sub_rn(sAx[e], szv[e]))));
      ax = pmax(ax, fabs(mul_rn(ei, sAx[e])));
      azz = pmax(azz, fabs(mul_rn(ei, szv[e])));
    }
    rp = block_reduce(rp, red, mx);
    const T rp_rel =
        pmax(block_reduce(ax, red, mx), block_reduce(azz, red, mx));

    T rd = T(0), dpx = T(0), daty = T(0), dq = T(0);
    for (int j = tid; j < nz; j += kThreads) {
      const int e = j * S + s;
      const T d = a.dinv[j];
      rd = pmax(rd, fabs(mul_rn(d, add_rn(add_rn(v1[e], sq[e]), v2[e]))));
      dpx = pmax(dpx, fabs(mul_rn(d, v1[e])));
      daty = pmax(daty, fabs(mul_rn(d, v2[e])));
      dq = pmax(dq, fabs(mul_rn(d, sq[e])));
    }
    rd = block_reduce(rd, red, mx);
    dpx = block_reduce(dpx, red, mx);
    daty = block_reduce(daty, red, mx);
    dq = block_reduce(dq, red, mx);
    const T rd_rel = pmax(dpx, pmax(daty, dq));

    T nv = T(0), sup_u = T(0), sup_l = T(0);
    for (int i = tid; i < m; i += kThreads) {
      const int e = i * S + s;
      const T v = sw[e];
      nv = pmax(nv, fabs(v));
      const T ucap = isfinite(sub[e]) ? sub[e] : T(0);
      const T lcap = isfinite(slb[e]) ? slb[e] : T(0);
      sup_u = fma(ucap, pmax(v, T(0)), sup_u);
      sup_l = fma(lcap, pmin(v, T(0)), sup_l);
    }
    nv = block_reduce(nv, red, mx);
    const T sup =
        add_rn(block_reduce(sup_u, red, sum), block_reduce(sup_l, red, sum));
    T atv = T(0);
    for (int j = tid; j < nz; j += kThreads)
      atv = pmax(atv, fabs(v3[j * S + s]));
    atv = block_reduce(atv, red, mx);
    const bool pinf = (fma(a.eps_pinf, nv, -atv) > T(0)) &&
                      (fma(-a.thresh, nv, -sup) > T(0)) &&
                      (sub_rn(nv, a.eps_pinf) > T(0));

    T nvx = T(0), qv = T(0);
    for (int j = tid; j < nz; j += kThreads) {
      const int e = j * S + s;
      const T d = v4[e];
      nvx = pmax(nvx, fabs(d));
      qv = fma(sq[e], d, qv);
    }
    nvx = block_reduce(nvx, red, mx);
    qv = block_reduce(qv, red, sum);
    T pdx = T(0);
    for (int j = tid; j < nz; j += kThreads)
      pdx = pmax(pdx, fabs(v5[j * S + s]));
    pdx = block_reduce(pdx, red, mx);
    // |A dx| against eps_dinf |dx|, the product fused into each side
    T up_viol = T(0), lo_viol = T(0);
    for (int i = tid; i < m; i += kThreads) {
      const int e = i * S + s;
      const T uinf = isfinite(sub[e]) ? T(0) : T(1);
      const T linf = isfinite(slb[e]) ? T(0) : T(1);
      up_viol = pmax(up_viol,
                     mul_rn(pmax(fma(-a.eps_dinf, nvx, srho[e]), T(0)),
                            sub_rn(T(1), uinf)));
      lo_viol = pmax(lo_viol,
                     mul_rn(pmax(fma(-a.eps_dinf, nvx, -srho[e]), T(0)),
                            sub_rn(T(1), linf)));
    }
    up_viol = block_reduce(up_viol, red, mx);
    lo_viol = block_reduce(lo_viol, red, mx);
    // fp32 compared the rounded eps_dinf |dx|; fp64 fused it
    bool dinf_p, dinf_q;
    if constexpr (sizeof(T) == 4) {
      const T p = mul_rn(a.eps_dinf, nvx);
      dinf_p = sub_rn(p, pdx) > T(0);
      dinf_q = sub_rn(-p, qv) > T(0);
    } else {
      dinf_p = fma(a.eps_dinf, nvx, -pdx) > T(0);
      dinf_q = fma(-a.eps_dinf, nvx, -qv) > T(0);
    }
    const bool dinf = dinf_p && dinf_q && up_viol == T(0) &&
                      lo_viol == T(0) && (sub_rn(nvx, a.eps_dinf) > T(0));

    if (tid == 0 && active[s]) {
      T* st = a.stats + static_cast<size_t>(slot[s]) * 8;
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
}

template <typename T>
__device__ __forceinline__ T quiet_nan();
template <>
__device__ __forceinline__ float quiet_nan<float>() {
  return __int_as_float(0x7fffffff);
}
template <>
__device__ __forceinline__ double quiet_nan<double>() {
  return __longlong_as_double(0x7ff8000000000000LL);
}

// A block per row: a done slot's x, y, z through and zero stats; a live
// slot NaN, which the chunk kernel launched after overwrites (so a live
// slot missing from the slot list reads NaN).
template <typename T>
__global__ void __launch_bounds__(kThreads) pass_kernel(Args<T> a) {
  const int slot = blockIdx.x, tid = threadIdx.x;
  const bool done = a.done[slot];
  const T nan = quiet_nan<T>();
  const size_t onz = static_cast<size_t>(slot) * a.nz;
  const size_t om = static_cast<size_t>(slot) * a.m;
  for (int j = tid; j < a.nz; j += kThreads)
    a.xo[onz + j] = done ? a.x[onz + j] : nan;
  for (int i = tid; i < a.m; i += kThreads) {
    a.yo[om + i] = done ? a.y[om + i] : nan;
    a.zo[om + i] = done ? a.z[om + i] : nan;
  }
  if (tid < 8) a.stats[static_cast<size_t>(slot) * 8 + tid] = done ? T(0) : nan;
}

template <int V>
using Int = std::integral_constant<int, V>;

// Calls f(Int<C>, Int<S>) for a layout of the including file's
// ADMM_LAYOUTS list, else returns cudaErrorInvalidValue.
#define ADMM_LAYOUT_CASE(c, s) \
  if (C == (c) && S == (s)) return f(Int<(c)>{}, Int<(s)>{});
template <class F>
int with_layout(int C, int S, F f) {
  ADMM_LAYOUTS(ADMM_LAYOUT_CASE)
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T, int C, int S>
cudaError_t prepare(int nz, int m, int gw, size_t* smem) {
  *smem = sizeof(T) * smem_elems<T, C, S>(nz, m, gw);
  return cudaFuncSetAttribute(admm_chunk_kernel<T, C, S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

template <typename T>
int launch(void* const* p, int B, int n_grid, int C, int S, int nz, int m,
           int gw, int n_iter, int ir_steps, double sigma, double alpha,
           double eps_pinf, double eps_dinf, double thresh, void* stream) {
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
  a.slots = static_cast<const int*>(p[24]);
  a.n_grid = n_grid;
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
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  pass_kernel<T><<<B, kThreads, 0, st>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_grid == 0) return static_cast<int>(e);
  return with_layout(C, S, [&](auto c_, auto s_) -> int {
    constexpr int Cc = decltype(c_)::value, Sc = decltype(s_)::value;
    size_t smem;
    cudaError_t err = prepare<T, Cc, Sc>(nz, m, gw, &smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>((n_grid + Sc - 1) / Sc * Cc));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, admm_chunk_kernel<T, Cc, Sc>, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  });
}

// How many groups (C = 1: blocks; C > 1: clusters) of layout (C, S) the
// card holds at once: one wave. An error (the layout's shared memory does
// not fit these shapes) is returned and cleared, so that no later launch
// check reads it.
template <typename T>
int capacity(int C, int S, int nz, int m, int gw, int* out) {
  return with_layout(C, S, [&](auto c_, auto s_) -> int {
    constexpr int Cc = decltype(c_)::value, Sc = decltype(s_)::value;
    size_t smem;
    cudaError_t err = prepare<T, Cc, Sc>(nz, m, gw, &smem);
    if (err != cudaSuccess) {
      cudaGetLastError();
      return static_cast<int>(err);
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(Cc);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = Cc;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaOccupancyMaxActiveClusters(out, admm_chunk_kernel<T, Cc, Sc>,
                                         &cfg);
    if (err != cudaSuccess) cudaGetLastError();
    return static_cast<int>(err);
  });
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------

#define ADMM_CHUNK_ENTRY(NAME, T)                                              \
  extern "C" int NAME(                                                         \
      void* p0, void* p1, void* p2, void* p3, void* p4, void* p5, void* p6,    \
      void* p7, void* p8, void* p9, void* p10, void* p11, void* p12,           \
      void* p13, void* p14, void* p15, void* p16, void* p17, void* p18,        \
      void* p19, void* p20, void* p21, void* p22, void* p23, void* p24,        \
      int B, int n_grid, int C, int S, int nz, int m, int gw, int n_iter,      \
      int ir_steps, double sigma, double alpha, double eps_pinf,               \
      double eps_dinf, double thresh, void* stream) {                          \
    void* const p[25] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,  p8,           \
                         p9,  p10, p11, p12, p13, p14, p15, p16, p17,          \
                         p18, p19, p20, p21, p22, p23, p24};                   \
    return launch<T>(p, B, n_grid, C, S, nz, m, gw, n_iter, ir_steps, sigma,   \
                     alpha, eps_pinf, eps_dinf, thresh, stream);               \
  }                                                                            \
  extern "C" int NAME##_capacity(int C, int S, int nz, int m, int gw,          \
                                 int* out) {                                   \
    return capacity<T>(C, S, nz, m, gw, out);                                  \
  }

