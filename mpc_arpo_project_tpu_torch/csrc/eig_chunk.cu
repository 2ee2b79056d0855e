// Fused ADMM chunk with the shared-eigenbasis solve, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   mpc_arpo_project_tpu/ops/admm_eig.py::_eig_chunk_kernel   (with_s=True)
// and computes what its plain torch twin
//   mpc_arpo_project_tpu_torch/ops/admm_eig.py::eig_chunk_ref
// computes: n_iter OSQP iterations of each problem slot,
//   rhs = sigma x - qbar + A'(rho z - y)
//   xt  = W diag(dg) W' rhs  minus the rank-K debris Woodbury term through
//         the slot's own T^-1
//   zt  = A xt   (A = the combo's A_c, debris rows scaled by alpha, plus the
//                 s-correction through gsel/scat)
//   relaxation (alpha), clip to [lbar, ubar], y update
// then the scaled residuals and the Farkas pinf/dinf certificates of the
// chunk's accumulated dy, dx. Stats per slot: rp, rp_rel, rd, rd_rel, pinf,
// dinf, |dy|_inf, |dx|_inf. A done slot copies x, y, z through and writes
// zero stats (the caller discards every output of a done row).
//
// Two layouts. Calls with few live slots run a thread-block cluster of C
// blocks for each live slot (the cluster layout, described at
// eig_chunk_kernel_cluster below; fp32); every other call runs slot groups.
//
// Slot groups. One block serves S consecutive slots of one tile (S
// divides bt, so the group is combo-pure; S = 1, 2, 4 or 8 in fp32, 1 or 2
// in fp64). The group's vectors live in dynamic shared memory
// slot-interleaved, v[i * S + s], ~25 KB per slot in fp32 and ~50 KB in
// fp64 (S = 1 is the one-slot layout of the first version of this kernel,
// which ran one 256-thread block per slot). Each shared-matrix element a
// thread loads from L2 serves the S slots:
//   vecmat  out_s[j] = sum_i v_s[i] M[i, j]: the first version's thread per
//           column (split over row groups when M is narrower than 256) ran
//           eight interleaved FMA chains; here, in fp32, two threads share
//           a column, four chains each (4 S accumulators; in fp64 one thread
//           runs all eight), the S values of row i read as one vector load,
//           ~32 fp32 registers of M loads in flight;
//   matvec  out_s[i] = sum_j M[i, j] v_s[j]: a warp per row, each lane
//           holding its eight v_s[j] in registers (nz <= 256), one chain per
//           slot, 2-4 rows of M in flight; the S lane sums are reduced by a
//           transposed butterfly (S - 1 + 5 - log2 S shuffles, not 5 S).
// So an fp32 block has 512 threads, 16 warps where the first version had 8:
// with few live slots the chunk is a chain of L2 round trips, and more
// warps keep more of them in flight. (An fp64 block keeps 256 threads: at
// 512 its registers spilled and it ran at half the first version's speed.)
// The products are functions of their own (__noinline__), one copy per
// slot count, which keeps the build short.
//
// Each slot's result is bit for bit that of the one-slot kernel: every dot
// product keeps its chains, its pairwise sum (the two halves meet in one
// shuffle), its row-group partials and its butterfly tree (the transposed
// butterfly adds the same pairs at the same stages); the end-of-chunk
// reductions run on the first 256 threads in the first version's order;
// and every elementwise expression is written out with the contractions
// nvcc chose there (fma where it fused, _rn operations where it did not).
// So S, the grid, a slot's position and the live count move no bit of the
// result.
//
// What bounds it, per slot-iteration (nz=256, m=512, K=128, gw=64, fp32):
//   shared matrices (A_c twice, W_c twice, YT_c twice, gsel/scat/rsel/gscat)
//     ~0.54 M elements, 2.2 MB from L2: the one-slot kernel moved 56 GB per
//     1024-slot chunk, ~5.7 ms of its 10.3 at ~10 TB/s. A group reads them
//     once for S slots: 2.2 MB / S per slot;
//   FMAs ~0.56 M per slot: 14.3 G per 1024-slot chunk, 0.43 ms at the fp32
//     peak. Vector loads of the S slot values keep one shared-memory
//     wavefront per 4 (S >= 4) FMAs;
//   T^-1 (K x K, the slot's own) 64 KiB per slot-iteration, 1.68 GB per
//     1024-slot chunk, 0.50 ms at HBM rate: too large for L2 (64 MiB) and,
//     beside S slots' vectors, for shared memory (a cp.async ring of it
//     would cost the group size). Each iteration prefetches the group's
//     T^-1 into L2 at its start, so the stream overlaps the A' product and
//     the W/YT products before the T^-1 product reads it, and the S slots'
//     T^-1 loads go out together.
// Blocks of all-done groups copy through and exit. All arithmetic, in both
// layouts, is CUDA-core FMA in full fp32 or fp64: reduced-precision
// products are known to stall this solver.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// The one-slot kernel's block of 256 threads sets every summation order
// below. In fp32 a block of this kernel runs two threads for each of those
// logical threads, each with half of its FMA chains; in fp64 one, whose
// registers a 512-thread block could not hold.
constexpr int kThreads = 256;          // logical threads
constexpr int kWarps = kThreads / 32;  // their warps (block_reduce)
constexpr int kLaneCols = 8;           // matvec: v columns per lane (nz <= 256)

template <typename T>
struct Layout {
  static constexpr int split = sizeof(T) == 4 ? 2 : 1;  // threads per logical
  static constexpr int block = kThreads * split;        // threads per block
  static constexpr int warps = block / 32;
  static constexpr int chains = 8 / split;  // vecmat FMA chains per thread
};

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

// Uncontracted multiply, add and subtract: where nvcc did not fuse.
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// N consecutive values from shared memory, as vector loads where aligned
// (the slot-interleaved layout keeps row starts at N * sizeof(T)).
template <typename T, int N>
struct alignas(N * sizeof(T)) Pack {
  T v[N];
};
template <typename T, int N>
__device__ __forceinline__ void lds(const T* p, T (&o)[N]) {
  const Pack<T, N> pk = *reinterpret_cast<const Pack<T, N>*>(p);
#pragma unroll
  for (int n = 0; n < N; ++n) o[n] = pk.v[n];
}

// Reduce S values per logical thread over the logical block, one butterfly
// and one pass over the eight warps' partials each, in the one-slot order;
// every thread gets the S results (threads past the logical block take
// part in the barriers only).
template <typename T, int S, typename Op>
__device__ void block_reduce(T (&v)[S], T* red, Op op) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    for (int o = 16; o > 0; o >>= 1)
      v[s] = op(v[s], __shfl_xor_sync(0xffffffffu, v[s], o));
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  __syncthreads();  // red may still be read by a previous reduction
  if (lane == 0 && w < kWarps) {
#pragma unroll
    for (int s = 0; s < S; ++s) red[w * S + s] = v[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    v[s] = red[s];
    for (int i = 1; i < kWarps; ++i) v[s] = op(v[s], red[i * S + s]);
  }
}

// r_s = sum_{i0 <= i < i1} v[i * vs + s] * M_s[i, j] (s < NS) in the
// one-slot kernel's arithmetic: eight interleaved FMA chains (chain q takes
// rows i0 + 8b + q of the full batches of eight; the rows left over go to
// chain 0 after them), summed pairwise, ((c0 + c1) + (c2 + c3)) +
// ((c4 + c5) + (c6 + c7)). In fp32 the two threads of a pair (lanes 2l and
// 2l + 1, half h) run chains 4h..4h+3 and add their halves with one
// shuffle, so both get that sum; in fp64 one thread runs all eight. Independent chains hide FMA latency, and the shorter
// chains keep fp32 round-off near a blocked GEMM's (a single chain over 512
// rows measured ~10x the twin's error on debris rows, whose Woodbury term
// cancels most of the solve). With OWN each slot reads its own matrix,
// M_s = M + s * mstride (the slots' T^-1); otherwise the NS slots share M
// and each load serves all of them. About 32 fp32 registers of loads are in
// flight per thread.
template <typename T, int NS, bool OWN>
__device__ __forceinline__ void dot_col(const T* __restrict__ M,
                                        size_t mstride, int ncol, int j,
                                        const T* v, int vs, int i0, int i1,
                                        int h, T (&r)[NS]) {
  constexpr int kChains = Layout<T>::chains;
  constexpr int kL = OWN ? NS : 1;  // loads per row
  constexpr int kLoadBytes = kChains * kL * static_cast<int>(sizeof(T));
  constexpr int kBatches = kLoadBytes >= 128 ? 1 : 128 / kLoadBytes;
  T acc[NS][kChains];
#pragma unroll
  for (int s = 0; s < NS; ++s)
#pragma unroll
    for (int c = 0; c < kChains; ++c) acc[s][c] = T(0);
  const int nb = i1 > i0 ? (i1 - i0) / 8 : 0;
  const T* col = M + static_cast<size_t>(i0 + kChains * h) * ncol + j;
  T mv[kBatches][kChains][kL];
#pragma unroll
  for (int d = 0; d < kBatches; ++d)
    if (d < nb) {
#pragma unroll
      for (int c = 0; c < kChains; ++c)
#pragma unroll
        for (int l = 0; l < kL; ++l)
          mv[d][c][l] = __ldg(col + l * mstride +
                              static_cast<size_t>(8 * d + c) * ncol);
    }
  for (int b0 = 0; b0 < nb; b0 += kBatches) {
#pragma unroll
    for (int d = 0; d < kBatches; ++d) {
      const int b = b0 + d;
      if (b < nb) {
        const T* vr = v + static_cast<size_t>(i0 + 8 * b + kChains * h) * vs;
#pragma unroll
        for (int c = 0; c < kChains; ++c) {
          T vq[NS];
          lds<T, NS>(vr + c * vs, vq);
#pragma unroll
          for (int s = 0; s < NS; ++s)
            acc[s][c] = fma(vq[s], mv[d][c][OWN ? s : 0], acc[s][c]);
        }
        if (b + kBatches < nb) {
#pragma unroll
          for (int c = 0; c < kChains; ++c)
#pragma unroll
            for (int l = 0; l < kL; ++l)
              mv[d][c][l] = __ldg(col + l * mstride +
                                  static_cast<size_t>(8 * (b + kBatches) + c) *
                                      ncol);
        }
      }
    }
  }
  if (h == 0) {
    for (int i = i0 + 8 * nb; i < i1; ++i) {
      T vq[NS];
      lds<T, NS>(v + static_cast<size_t>(i) * vs, vq);
      const T* mi = M + static_cast<size_t>(i) * ncol + j;
#pragma unroll
      for (int s = 0; s < NS; ++s)
        acc[s][0] = fma(vq[s], __ldg(mi + (OWN ? s * mstride : 0)), acc[s][0]);
    }
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const T t = (acc[s][0] + acc[s][1]) + (acc[s][2] + acc[s][3]);
    if constexpr (kChains == 8) {
      r[s] = t + ((acc[s][4] + acc[s][5]) + (acc[s][6] + acc[s][7]));
    } else {
      r[s] = t + __shfl_xor_sync(3u << (threadIdx.x & 30), t, 1);
    }
  }
}

// out[j * S + s] = sum_i v[i * S + s] * M_s[i, j] for row-major M (nrow x
// ncol), shared by the S slots (M_s = M) or, with OWN, each slot's own
// (M_s = M + s * mstride). A logical thread per column; when ncol <
// kThreads the rows are split over kThreads / ncol groups whose partial
// sums go through `part` (kThreads * S entries) and are added in group
// order.
template <typename T, int S, bool OWN>
__device__ __noinline__ void vecmat(const T* __restrict__ M, size_t mstride,
                                    const T* v, T* out, int nrow, int ncol,
                                    T* part) {
  const int lt = threadIdx.x / Layout<T>::split;
  const int h = threadIdx.x % Layout<T>::split;
  const int groups = kThreads / ncol;
  if (groups <= 1) {
    for (int j = lt; j < ncol; j += kThreads) {
      T r[S];
      dot_col<T, S, OWN>(M, mstride, ncol, j, v, S, 0, nrow, h, r);
      if (h == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) out[j * S + s] = r[s];
      }
    }
  } else {
    const int j = lt % ncol, g = lt / ncol;
    if (g < groups) {
      const int rows = (nrow + groups - 1) / groups;
      const int i0 = g * rows, i1 = min(nrow, i0 + rows);
      T r[S];
      dot_col<T, S, OWN>(M, mstride, ncol, j, v, S, i0, i1, h, r);
      if (h == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) part[(g * ncol + j) * S + s] = r[s];
      }
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < ncol * S; idx += Layout<T>::block) {
      T acc = part[idx];
      for (int gg = 1; gg < groups; ++gg) acc += part[gg * ncol * S + idx];
      out[idx] = acc;
    }
  }
  __syncthreads();
}

// Sum of each of a lane's S values over the warp, as the one-slot
// butterfly (o = 16, 8, 4, 2, 1) sums one: in the first log2 S stages a
// lane keeps the half of its slots named by its lane bit and receives the
// partner's partials of that half, so each stage adds the same pairs. The
// lane's slot is returned in `slot`; its sum in v[0]. (H, the half kept at
// this stage, is a template argument so that every index into v is a
// constant and v stays in registers.)
template <typename T, int S, int H>
struct WarpSums {
  static __device__ __forceinline__ void run(T (&v)[S], int lane, int& slot,
                                             int o) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int t = 0; t < H; ++t) {
      const T send = upper ? v[t] : v[t + H];
      const T keep = upper ? v[t + H] : v[t];
      v[t] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    slot = 2 * slot + (upper ? 1 : 0);
    WarpSums<T, S, H / 2>::run(v, lane, slot, o >> 1);
  }
};
template <typename T, int S>
struct WarpSums<T, S, 0> {
  static __device__ __forceinline__ void run(T (&v)[S], int, int&, int o) {
    for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
};
template <typename T, int S>
__device__ __forceinline__ void warp_sums(T (&v)[S], int lane, int& slot) {
  slot = 0;
  WarpSums<T, S, S / 2>::run(v, lane, slot, 16);
}

// out[i * S + s] = sum_j M[i, j] * v[j * S + s] for row-major M (nrow x
// ncol, ncol <= 32 kLaneCols): a warp per row, lanes striding along it with
// their v columns in registers, 2-4 rows of M in flight per warp.
template <typename T, int S>
__device__ __noinline__ void matvec(const T* __restrict__ M, const T* v,
                                    T* out, int nrow, int ncol) {
  constexpr int kRows = S * sizeof(T) >= 32 ? 2 : 4;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  T vf[kLaneCols][S];
#pragma unroll
  for (int k = 0; k < kLaneCols; ++k) {
    const int j = lane + 32 * k;
    if (j < ncol) {
      lds<T, S>(v + static_cast<size_t>(j) * S, vf[k]);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) vf[k][s] = T(0);
    }
  }
  // rows of this warp: i = w + Layout<T>::warps * r, r < nr
  const int nr = nrow > w ? (nrow - w + Layout<T>::warps - 1) / Layout<T>::warps : 0;
  T mr[kRows][kLaneCols];
#pragma unroll
  for (int d = 0; d < kRows; ++d)
    if (d < nr) {
      const T* row = M + static_cast<size_t>(w + Layout<T>::warps * d) * ncol;
#pragma unroll
      for (int k = 0; k < kLaneCols; ++k)
        if (lane + 32 * k < ncol) mr[d][k] = __ldg(row + lane + 32 * k);
    }
  for (int r0 = 0; r0 < nr; r0 += kRows) {
#pragma unroll
    for (int d = 0; d < kRows; ++d) {
      const int r = r0 + d;
      if (r < nr) {
        T acc[S];
#pragma unroll
        for (int s = 0; s < S; ++s) acc[s] = T(0);
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k)
          if (lane + 32 * k < ncol) {
#pragma unroll
            for (int s = 0; s < S; ++s) acc[s] = fma(mr[d][k], vf[k][s], acc[s]);
          }
        if (r + kRows < nr) {
          const T* row =
              M + static_cast<size_t>(w + Layout<T>::warps * (r + kRows)) * ncol;
#pragma unroll
          for (int k = 0; k < kLaneCols; ++k)
            if (lane + 32 * k < ncol) mr[d][k] = __ldg(row + lane + 32 * k);
        }
        int slot;
        warp_sums<T, S>(acc, lane, slot);
        if ((lane & (32 / S - 1)) == 0)
          out[static_cast<size_t>(w + Layout<T>::warps * r) * S + slot] = acc[0];
      }
    }
  }
  __syncthreads();
}

template <typename T>
struct Args {
  const int* tile_combo;
  const T* tinv;
  const T* scal;
  const T* qbar;
  const T* lbar;
  const T* ubar;
  const T* dg;
  const T* x;
  const T* y;
  const T* z;
  const unsigned char* done;
  const T* A;      // (n_combo, m, nz)
  const T* W;      // (n_combo, nz, nz)
  const T* YT;     // (n_combo, K, nz)
  const T* pbar;   // (nz, nz)
  const T* w33;    // (K,)
  const T* gsel;   // (nz, gw)
  const T* scat;   // (gw, m)
  const T* rsel;   // (m, gw)
  const T* gscat;  // (gw, nz)
  const T* rhov;   // (m,)
  const T* einv;   // (m,)
  const T* dinv;   // (nz,)
  const T* wuu;    // (K,)
  const T* dmask;  // (m,)
  T* xo;
  T* yo;
  T* zo;
  T* stats;  // (B, 8)
  int B, nz, m, K, gw, bt, n_iter;
  T sigma, alpha, one_m_alpha, eps_pinf, eps_dinf, thresh;
};

// Per-slot scalars in shared memory, sc[c * S + s], and the end-of-chunk
// reductions, fin[c * S + s].
enum { kR = 0, kAl, kRs, kRss, kRuu, kAls, kDone, kScalars };
enum { kRp = 0, kRpRel, kRd, kRdRel, kNv, kSup, kAtv, kNvx, kQv, kPdx, kFin };

// Group view shared by the helpers below.
template <typename T>
struct Group {
  const T* A;
  const T* rsc;  // debris row scale (m x S)
  const T* sc;   // per-slot scalars
  T* g;          // gw x S temporary
  T* part;       // kThreads x S scratch for vecmat
};

// out(m x S) = A_c x scaled by the debris row scale, plus the s-correction.
template <typename T, int S>
__device__ void apply_A(const Args<T>& a, const Group<T>& gp, const T* xin,
                        T* out) {
  matvec<T, S>(gp.A, xin, out, a.m, a.nz);
  vecmat<T, S, false>(a.gsel, 0, xin, gp.g, a.nz, a.gw, gp.part);
  for (int idx = threadIdx.x; idx < a.gw * S; idx += Layout<T>::block)
    gp.g[idx] = mul_rn(gp.sc[kAls * S + idx % S], gp.g[idx]);
  __syncthreads();
  // corr_s[i] = sum_k g_s[k] scat[k, i], one chain in k order, with
  // 16 rows of scat loaded ahead
  constexpr int kAhead = 16;
  for (int i = threadIdx.x; i < a.m; i += Layout<T>::block) {
    T corr[S];
#pragma unroll
    for (int s = 0; s < S; ++s) corr[s] = T(0);
    const T* col = a.scat + i;
    T sk[kAhead];
#pragma unroll
    for (int d = 0; d < kAhead; ++d)
      if (d < a.gw) sk[d] = __ldg(col + static_cast<size_t>(d) * a.m);
    for (int k0 = 0; k0 < a.gw; k0 += kAhead) {
#pragma unroll
      for (int d = 0; d < kAhead; ++d) {
        const int k = k0 + d;
        if (k < a.gw) {
          T gk[S];
          lds<T, S>(gp.g + k * S, gk);
#pragma unroll
          for (int s = 0; s < S; ++s) corr[s] = fma(gk[s], sk[d], corr[s]);
          if (k + kAhead < a.gw)
            sk[d] = __ldg(col + static_cast<size_t>(k + kAhead) * a.m);
        }
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s)
      out[i * S + s] = fma(out[i * S + s], gp.rsc[i * S + s], corr[s]);
  }
  __syncthreads();
}

// out(nz x S) = A' w with the same scaling and correction; tm (m x S) and
// tn (nz x S) are temporaries.
template <typename T, int S>
__device__ void apply_AT(const Args<T>& a, const Group<T>& gp, const T* win,
                         T* out, T* tm, T* tn) {
  vecmat<T, S, false>(a.rsel, 0, win, gp.g, a.m, a.gw, gp.part);
  for (int idx = threadIdx.x; idx < a.m * S; idx += Layout<T>::block)
    tm[idx] = mul_rn(win[idx], gp.rsc[idx]);
  for (int idx = threadIdx.x; idx < a.gw * S; idx += Layout<T>::block)
    gp.g[idx] = mul_rn(gp.sc[kAls * S + idx % S], gp.g[idx]);
  __syncthreads();
  vecmat<T, S, false>(gp.A, 0, tm, out, a.m, a.nz, gp.part);
  vecmat<T, S, false>(a.gscat, 0, gp.g, tn, a.gw, a.nz, gp.part);
  for (int idx = threadIdx.x; idx < a.nz * S; idx += Layout<T>::block)
    out[idx] = add_rn(out[idx], tn[idx]);
  __syncthreads();
}

template <typename T, int S>
__global__ void __launch_bounds__(Layout<T>::block) eig_chunk_kernel(Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = a.nz, m = a.m, K = a.K, tid = threadIdx.x;
  const int slot0 = blockIdx.x * S;
  const size_t onz = static_cast<size_t>(slot0) * nz;
  const size_t om = static_cast<size_t>(slot0) * m;

  bool all_done = true;
#pragma unroll
  for (int s = 0; s < S; ++s) all_done = all_done && a.done[slot0 + s] != 0;
  if (all_done) {
    for (int idx = tid; idx < S * nz; idx += Layout<T>::block) a.xo[onz + idx] = a.x[onz + idx];
    for (int idx = tid; idx < S * m; idx += Layout<T>::block) {
      a.yo[om + idx] = a.y[om + idx];
      a.zo[om + idx] = a.z[om + idx];
    }
    if (tid < 8 * S) a.stats[static_cast<size_t>(slot0) * 8 + tid] = T(0);
    return;
  }

  const size_t vnz = static_cast<size_t>(nz) * S, vm = static_cast<size_t>(m) * S;
  T* sx = sm;
  T* sq = sx + vnz;
  T* sdg = sq + vnz;
  T* v1 = sdg + vnz;
  T* v2 = v1 + vnz;
  T* v3 = v2 + vnz;
  T* sy = v3 + vnz;
  T* sz = sy + vm;
  T* slb = sz + vm;
  T* sub = slb + vm;
  T* srho = sub + vm;
  T* srsc = srho + vm;
  T* sw = srsc + vm;
  T* sAx = sw + vm;
  T* ka = sAx + vm;
  T* kt = ka + K * S;
  T* sg = kt + K * S;
  T* part = sg + a.gw * S;
  T* red = part + kThreads * S;
  T* sc = red + 32 * S;
  T* fin = sc + kScalars * S;

  const int combo = a.tile_combo[slot0 / a.bt];
  Group<T> gp;
  gp.A = a.A + static_cast<size_t>(combo) * m * nz;
  const T* W = a.W + static_cast<size_t>(combo) * nz * nz;
  const T* YT = a.YT + static_cast<size_t>(combo) * K * nz;
  const size_t kk = static_cast<size_t>(K) * K;
  const T* tinv = a.tinv + static_cast<size_t>(slot0) * kk;
  gp.rsc = srsc;
  gp.sc = sc;
  gp.g = sg;
  gp.part = part;

  if (tid < S) {
    const size_t o = static_cast<size_t>(slot0 + tid) * 8;
    const T r = a.scal[o + 0];
    const T sv = a.scal[o + 1];
    T al = a.scal[o + 2];
    if (al == T(0)) al = T(1);
    const T alsq = mul_rn(al, al);
    const T ralsq = mul_rn(r, alsq);
    sc[kR * S + tid] = r;
    sc[kAl * S + tid] = al;
    sc[kRs * S + tid] = mul_rn(ralsq, sv);
    sc[kRss * S + tid] = mul_rn(mul_rn(ralsq, sv), sv);
    sc[kRuu * S + tid] = mul_rn(r, sub_rn(alsq, T(1)));
    sc[kAls * S + tid] = mul_rn(al, sv);
    sc[kDone * S + tid] = a.done[slot0 + tid] ? T(1) : T(0);
  }
  __syncthreads();

  // group loads: coalesced in global memory, slot-interleaved in shared
  for (int idx = tid; idx < S * nz; idx += Layout<T>::block) {
    const int s = idx / nz, j = idx - s * nz, p = j * S + s;
    sx[p] = a.x[onz + idx];
    sq[p] = a.qbar[onz + idx];
    sdg[p] = a.dg[onz + idx];
  }
  for (int idx = tid; idx < S * m; idx += Layout<T>::block) {
    const int s = idx / m, i = idx - s * m, p = i * S + s;
    sy[p] = a.y[om + idx];
    sz[p] = a.z[om + idx];
    slb[p] = a.lbar[om + idx];
    sub[p] = a.ubar[om + idx];
    srho[p] = mul_rn(sc[kR * S + s], a.rhov[i]);
    srsc[p] = fma(sub_rn(sc[kAl * S + s], T(1)), a.dmask[i], T(1));
  }
  __syncthreads();

  const int half = K / 2;
  const size_t tbytes = static_cast<size_t>(S) * kk * sizeof(T);
  for (int it = 0; it < a.n_iter; ++it) {
    // the group's T^-1 into L2 ahead of its product
    for (size_t off = static_cast<size_t>(tid) * 128; off < tbytes;
         off += static_cast<size_t>(Layout<T>::block) * 128)
      asm volatile("prefetch.global.L2 [%0];" ::"l"(
          reinterpret_cast<const char*>(tinv) + off));

    // rhs = sigma x - qbar + A'(rho z - y)  -> v3
    for (int idx = tid; idx < m * S; idx += Layout<T>::block)
      sw[idx] = fma(srho[idx], sz[idx], -sy[idx]);
    __syncthreads();
    apply_AT<T, S>(a, gp, sw, v1, sAx, v2);
    for (int idx = tid; idx < nz * S; idx += Layout<T>::block)
      v3[idx] = add_rn(fma(a.sigma, sx[idx], -sq[idx]), v1[idx]);
    __syncthreads();

    // exact solve: u = rhs W; d = u dg; a = d YT'; t = a T^-1;
    // h = rs (t K1) + rss (t w33) + ruu (t wuu); xt = ((u - h YT) dg) W'
    vecmat<T, S, false>(W, 0, v3, v1, nz, nz, part);
    for (int idx = tid; idx < nz * S; idx += Layout<T>::block)
      v2[idx] = mul_rn(v1[idx], sdg[idx]);
    __syncthreads();
    matvec<T, S>(YT, v2, ka, K, nz);
    vecmat<T, S, true>(tinv, kk, ka, kt, K, K, part);
    for (int idx = tid; idx < K * S; idx += Layout<T>::block) {
      const int l = idx / S, s = idx - l * S;
      const T t = kt[idx];
      const T tsw = kt[(l < half ? l + half : l - half) * S + s];
      ka[idx] = fma(sc[kRuu * S + s], mul_rn(t, a.wuu[l]),
                    fma(sc[kRs * S + s], tsw,
                        mul_rn(sc[kRss * S + s], mul_rn(t, a.w33[l]))));
    }
    __syncthreads();
    vecmat<T, S, false>(YT, 0, ka, v2, K, nz, part);
    for (int idx = tid; idx < nz * S; idx += Layout<T>::block)
      v3[idx] = mul_rn(sub_rn(v1[idx], v2[idx]), sdg[idx]);
    __syncthreads();
    matvec<T, S>(W, v3, v1, nz, nz);  // v1 = xt

    // zt = A xt; relaxation, clip, dual update
    apply_A<T, S>(a, gp, v1, sAx);
    for (int idx = tid; idx < m * S; idx += Layout<T>::block) {
      const T ztmp = fma(a.alpha, sAx[idx], mul_rn(a.one_m_alpha, sz[idx]));
      T zn = add_rn(ztmp, sy[idx] / srho[idx]);
      zn = zn < slb[idx] ? slb[idx] : zn;  // NaN stays NaN, as in jnp.clip
      zn = zn > sub[idx] ? sub[idx] : zn;
      sy[idx] = fma(srho[idx], sub_rn(ztmp, zn), sy[idx]);
      sz[idx] = zn;
    }
    for (int idx = tid; idx < nz * S; idx += Layout<T>::block)
      sx[idx] = fma(a.alpha, v1[idx], mul_rn(a.one_m_alpha, sx[idx]));
    __syncthreads();
  }

  for (int idx = tid; idx < S * nz; idx += Layout<T>::block) {
    const int s = idx / nz, j = idx - s * nz;
    a.xo[onz + idx] = sc[kDone * S + s] != T(0) ? a.x[onz + idx] : sx[j * S + s];
  }
  for (int idx = tid; idx < S * m; idx += Layout<T>::block) {
    const int s = idx / m, i = idx - s * m;
    const bool dn = sc[kDone * S + s] != T(0);
    a.yo[om + idx] = dn ? a.y[om + idx] : sy[i * S + s];
    a.zo[om + idx] = dn ? a.z[om + idx] : sz[i * S + s];
  }

  // ---- scaled residuals; per-slot partials keep the one-slot thread map
  // (thread tid takes elements tid, tid + kThreads, ...)
  const MaxOp mx{};
  const SumOp sum{};
  apply_A<T, S>(a, gp, sx, sAx);
  {
    T rp[S], ax[S], azz[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      rp[s] = ax[s] = azz[s] = T(0);
      for (int i = tid; tid < kThreads && i < m; i += kThreads) {
        const T e = a.einv[i];
        const int p = i * S + s;
        rp[s] = pmax(rp[s], fabs(mul_rn(e, sub_rn(sAx[p], sz[p]))));
        ax[s] = pmax(ax[s], fabs(mul_rn(e, sAx[p])));
        azz[s] = pmax(azz[s], fabs(mul_rn(e, sz[p])));
      }
    }
    block_reduce<T, S>(rp, red, mx);
    block_reduce<T, S>(ax, red, mx);
    block_reduce<T, S>(azz, red, mx);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fin[kRp * S + s] = rp[s];
        fin[kRpRel * S + s] = pmax(ax[s], azz[s]);
      }
    }
  }

  vecmat<T, S, false>(a.pbar, 0, sx, v1, nz, nz, part);  // Px
  apply_AT<T, S>(a, gp, sy, v2, sw, v3);                 // A'y
  {
    T rd[S], dpx[S], daty[S], dq[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      rd[s] = dpx[s] = daty[s] = dq[s] = T(0);
      for (int j = tid; tid < kThreads && j < nz; j += kThreads) {
        const T d = a.dinv[j];
        const int p = j * S + s;
        rd[s] = pmax(rd[s], fabs(mul_rn(d, add_rn(add_rn(v1[p], sq[p]), v2[p]))));
        dpx[s] = pmax(dpx[s], fabs(mul_rn(d, v1[p])));
        daty[s] = pmax(daty[s], fabs(mul_rn(d, v2[p])));
        dq[s] = pmax(dq[s], fabs(mul_rn(d, sq[p])));
      }
    }
    block_reduce<T, S>(rd, red, mx);
    block_reduce<T, S>(dpx, red, mx);
    block_reduce<T, S>(daty, red, mx);
    block_reduce<T, S>(dq, red, mx);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fin[kRd * S + s] = rd[s];
        fin[kRdRel * S + s] = pmax(dpx[s], pmax(daty[s], dq[s]));
      }
    }
  }

  // ---- primal infeasibility (Farkas) certificate from dy, projected onto
  // the polar of the recession cone of [l, u]
  {
    T nv[S], sup_u[S], sup_l[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      nv[s] = sup_u[s] = sup_l[s] = T(0);
      for (int i = tid; tid < kThreads && i < m; i += kThreads) {
        const int p = i * S + s;
        const T uinf = isfinite(sub[p]) ? T(0) : T(1);
        const T linf = isfinite(slb[p]) ? T(0) : T(1);
        const T both = uinf * linf;
        const T uo = uinf * (T(1) - linf);
        const T lo = linf * (T(1) - uinf);
        T v = mul_rn(sub_rn(sy[p], a.y[om + static_cast<size_t>(s) * m + i]),
                     T(1) - both);
        v = fma(v, T(1) - uo, mul_rn(pmin(v, T(0)), uo));
        v = fma(v, T(1) - lo, mul_rn(pmax(v, T(0)), lo));
        sw[p] = v;
        nv[s] = pmax(nv[s], fabs(v));
        const T ucap = uinf == T(0) ? sub[p] : T(0);
        const T lcap = linf == T(0) ? slb[p] : T(0);
        sup_u[s] = fma(ucap, pmax(v, T(0)), sup_u[s]);
        sup_l[s] = fma(lcap, pmin(v, T(0)), sup_l[s]);
      }
    }
    block_reduce<T, S>(nv, red, mx);
    block_reduce<T, S>(sup_u, red, sum);
    block_reduce<T, S>(sup_l, red, sum);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fin[kNv * S + s] = nv[s];
        fin[kSup * S + s] = add_rn(sup_u[s], sup_l[s]);
      }
    }
  }
  apply_AT<T, S>(a, gp, sw, v1, sAx, v3);
  {
    T atv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      atv[s] = T(0);
      for (int j = tid; tid < kThreads && j < nz; j += kThreads)
        atv[s] = pmax(atv[s], fabs(v1[j * S + s]));
    }
    block_reduce<T, S>(atv, red, mx);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) fin[kAtv * S + s] = atv[s];
    }
  }

  // ---- dual infeasibility certificate from dx
  {
    T nvx[S], qv[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      nvx[s] = qv[s] = T(0);
      for (int j = tid; tid < kThreads && j < nz; j += kThreads) {
        const int p = j * S + s;
        const T d = sub_rn(sx[p], a.x[onz + static_cast<size_t>(s) * nz + j]);
        v2[p] = d;
        nvx[s] = pmax(nvx[s], fabs(d));
        qv[s] = fma(sq[p], d, qv[s]);
      }
    }
    block_reduce<T, S>(nvx, red, mx);
    block_reduce<T, S>(qv, red, sum);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        fin[kNvx * S + s] = nvx[s];
        fin[kQv * S + s] = qv[s];
      }
    }
  }
  vecmat<T, S, false>(a.pbar, 0, v2, v1, nz, nz, part);  // P dx
  {
    T pdx[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      pdx[s] = T(0);
      for (int j = tid; tid < kThreads && j < nz; j += kThreads)
        pdx[s] = pmax(pdx[s], fabs(v1[j * S + s]));
    }
    block_reduce<T, S>(pdx, red, mx);
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) fin[kPdx * S + s] = pdx[s];
    }
  }
  apply_A<T, S>(a, gp, v2, sAx);  // A dx
  {
    T up_viol[S], lo_viol[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T eps_b = mul_rn(a.eps_dinf, fin[kNvx * S + s]);
      up_viol[s] = lo_viol[s] = T(0);
      for (int i = tid; tid < kThreads && i < m; i += kThreads) {
        const int p = i * S + s;
        const T uinf = isfinite(sub[p]) ? T(0) : T(1);
        const T linf = isfinite(slb[p]) ? T(0) : T(1);
        up_viol[s] = pmax(up_viol[s],
                          pmax(sub_rn(sAx[p], eps_b), T(0)) * (T(1) - uinf));
        lo_viol[s] = pmax(lo_viol[s],
                          pmax(sub_rn(-eps_b, sAx[p]), T(0)) * (T(1) - linf));
      }
    }
    block_reduce<T, S>(up_viol, red, mx);
    block_reduce<T, S>(lo_viol, red, mx);
    if (tid < S) {
      const int s = tid;
      const T nv = fin[kNv * S + s], nvx = fin[kNvx * S + s];
      const T eps_b = mul_rn(a.eps_dinf, nvx);
      const bool pinf =
          (fma(a.eps_pinf, nv, -fin[kAtv * S + s]) > T(0)) &&
          (fma(-a.thresh, nv, -fin[kSup * S + s]) > T(0)) &&
          (nv - a.eps_pinf > T(0));
      const bool dinf =
          (sub_rn(eps_b, fin[kPdx * S + s]) > T(0)) &&
          (sub_rn(-eps_b, fin[kQv * S + s]) > T(0)) &&
          up_viol[s] == T(0) && lo_viol[s] == T(0) &&
          (nvx - a.eps_dinf > T(0));
      const bool dn = sc[kDone * S + s] != T(0);
      T* st = a.stats + static_cast<size_t>(slot0 + s) * 8;
      st[0] = dn ? T(0) : fin[kRp * S + s];
      st[1] = dn ? T(0) : fin[kRpRel * S + s];
      st[2] = dn ? T(0) : fin[kRd * S + s];
      st[3] = dn ? T(0) : fin[kRdRel * S + s];
      st[4] = (!dn && pinf) ? T(1) : T(0);
      st[5] = (!dn && dinf) ? T(1) : T(0);
      st[6] = dn ? T(0) : nv;
      st[7] = dn ? T(0) : nvx;
    }
  }
}

// ---- the cluster layout: a thread-block cluster of C blocks per slot -----
//
// For calls with few live slots. With one slot a block, a slot's iteration
// is a chain of L2 round trips on one SM (~2.2 MB of shared matrices behind
// about eight dependent products), whatever the other SMs do. Here C blocks
// on C SMs (C = 2, 4, 8 or 16) serve one live slot:
// * block `rank` owns 1/C of the output columns of every vec-times-matrix
//   product (A_c', W_c, YT_c, the slot's T^-1, rsel, gsel, gscat, Pbar) and
//   1/C of the rows of every matrix-times-vec product (A_c, W_c, YT_c) and
//   of the s-correction's scatter;
// * after each product the blocks put their slices into every block's copy
//   of the vector through distributed shared memory and meet at one cluster
//   barrier: nine an iteration. The elementwise updates run in every block
//   on the replicated vectors;
// * the block's shares of the shared matrices and of the slot's T^-1 are
//   loaded into shared memory once a launch, as many as fit beside the
//   vectors, largest first (at the flagship's nz=241, m=496, K=128: all of
//   them at C = 16; both shares of A_c and W_c and YT_c's column share,
//   ~197 KB, at C = 8); the rest stream from L2, C ways split;
// * 256 threads a block from C = 8 up, one FMA chain each; 512 below, where
//   a block has more columns (a build of 512 threads at C = 8 spilled).
// What bounds it: latency. At C = 8 an iteration took ~17 us on the H100
// (the one-slot kernel's ~100 us), of which the nine cluster barriers were
// ~5 us; a chunk of 25 iterations 0.52 ms against the one-slot 2.6 ms
// (PERF.md section 6).
// Each sum keeps the one-slot kernel's order: a vecmat column's eight FMA
// chains (over the same rows, in the same row groups) and their pairwise
// tree, here with P threads a column and 8/P chains each, the partial trees
// added by one thread; a matvec row's warp of lane chains and its
// butterfly; the scatter's one chain; the end-of-chunk reductions on the
// first 256 threads in the one-slot map (in every block, rank 0 writing);
// and the elementwise updates written as there. So a slot's x, y, z and
// stats are bit for bit those of S = 1.
// The grid covers the live slots only: cluster ci finds the ci-th live slot
// itself (a scan of `done`). Clusters past the live count, launched to fill
// one wave of the card, and every live block first copy a share of the done
// slots through (x, y, z; zero stats), so one call stays one launch.

// A cluster block's threads, and the threads P that share a vecmat column
// (each with 8/P of its chains).
template <int C>
struct ClShape {
  static constexpr int threads = C >= 8 ? 256 : 512;
  static constexpr int P = C >= 4 ? 8 : 4;
};
constexpr int kClWarpsMax = 16;
// the shared memory a block of an H100 can hold (227 KB)
constexpr int kClSmemCap = 232448;

// The products' matrices: column shares of the vecmat operands, row shares
// of the matvec operands, the scatter's column share (its columns are A's
// rows).
enum {
  kMAc, kMAr, kMWc, kMWr, kMYc, kMYr, kMTinv, kMRsel, kMGsel, kMGscat,
  kMScat, kMPbar, kMats
};

struct ClArgs {
  int n_grid;        // clusters that look for a live slot
  int moff[kMats];   // a share's offset in shared memory (elements), or -1
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// rows and columns of matrix k; whether blocks share its columns (else rows)
__host__ __device__ inline void mat_shape(int k, int nz, int m, int K, int gw,
                                          int* nrow, int* ncol, bool* cols) {
  const int r[kMats] = {m, m, nz, nz, K, K, K, m, nz, gw, gw, nz};
  const int c[kMats] = {nz, nz, nz, nz, nz, nz, K, gw, gw, nz, m, nz};
  *nrow = r[k];
  *ncol = c[k];
  *cols = !(k == kMAr || k == kMWr || k == kMYr);
}

// elements of a block's share of matrix k (the widest rank's)
template <int C>
__host__ __device__ inline int share_elems(int k, int nz, int m, int K,
                                           int gw) {
  int nrow, ncol;
  bool cols;
  mat_shape(k, nz, m, K, gw, &nrow, &ncol, &cols);
  return cols ? nrow * cdiv(ncol, C) : cdiv(nrow, C) * ncol;
}

// the one-slot kernel's row groups of a vecmat ncol wide
__host__ __device__ inline int row_groups(int ncol) {
  return ncol < kThreads ? kThreads / ncol : 1;
}

// chain partials of a cluster block: P per column of each row group
template <int C>
__host__ __device__ inline int cl_part_elems(int nz, int K, int gw) {
  const int w[3] = {nz, K, gw};
  int most = 0;
  for (int i = 0; i < 3; ++i) {
    const int e = row_groups(w[i]) * cdiv(w[i], C);
    most = e > most ? e : most;
  }
  return ClShape<C>::P * most;
}

// shared-memory elements of a cluster block's vectors: 9 of nz, 9 of m, 3 of
// K, the gw lanes, the chain partials, the reduction scratch, the scalars
// and the slot-finding scratch
template <int C>
__host__ __device__ inline int cl_vec_elems(int nz, int m, int K, int gw) {
  return 9 * nz + 9 * m + 3 * K + gw + cl_part_elems<C>(nz, K, gw) + 32 +
         kScalars + kClWarpsMax + 1;
}

// A block's share of a matrix: element (i, c) at p[i * ld + c].
template <typename T>
struct MatRef {
  const T* p;
  int ld;
};

// Columns (or rows) [c0, c0 + n) of a block's share of n_all.
struct Share {
  int c0, n;
};
template <int C>
__device__ __forceinline__ Share share_of(int n_all, int rank) {
  const int per = cdiv(n_all, C);
  const int c0 = min(n_all, rank * per);
  return {c0, min(n_all, c0 + per) - c0};
}

// Pairwise sum of N consecutive chain sums: ((h0+h1)+(h2+h3))+... as the
// one-slot kernel's dot_col adds its eight chains.
template <int N, typename T>
__device__ __forceinline__ T tree(const T* h) {
  if constexpr (N == 1) {
    return h[0];
  } else {
    return tree<N / 2>(h) + tree<N / 2>(h + N / 2);
  }
}

template <typename T, int C>
struct ClBlock {
  static constexpr int NT = ClShape<C>::threads;
  static constexpr int NW = NT / 32;
  static constexpr int P = ClShape<C>::P;  // threads a vecmat column
  static constexpr int R = 8 / P;          // chains a thread

  int nz, m, gw;
  // this block's columns of nz, K and gw wide products, and its rows of
  // A_c (W_c's and YT_c's rows are the shares of nz and K)
  Share sz_, sk_, sg_, rm_;
  MatRef<T> mat[kMats];
  T* part;                 // chain partials
  T* g;                    // the gw correction lanes
  T* tm;                   // scratch (m): A' input; this block's rows of A_c v
  T* tnz;                  // scratch (nz): this block's columns of A_c' w
  const T* rsc;            // debris row scale (m)
  T als;

  // v into element e of `vec` in every block of the cluster
  static __device__ __forceinline__ void put(T* vec, int e, T v) {
    cg::cluster_group cl = cg::this_cluster();
#pragma unroll
    for (int r = 0; r < C; ++r) cl.map_shared_rank(vec, r)[e] = v;
  }
  // every block's puts are visible to every block
  static __device__ __forceinline__ void sync() { cg::this_cluster().sync(); }

  // out[j] = val(j, sum_i v[i] M[i, j]) on this block's columns j of an
  // nrow x ncol vecmat, put into every block's `out` (PUT) or this block's.
  // The one-slot kernel's sums: the rows in row_groups(ncol) groups; in a
  // group eight FMA chains (chain q: rows i0 + 8 b + q, then the group's
  // rows past its last full eight in chain 0), P threads a column each with
  // R of them (q = p R + k), the pairwise tree; the groups added in order.
  template <bool PUT, class Val>
  __device__ __forceinline__ void vecmat(MatRef<T> M, const T* v, int nrow,
                                         int ncol, Share s, T* out, Val val) {
    const int G = row_groups(ncol);
    const int rows = G > 1 ? cdiv(nrow, G) : nrow;
    const int units = G * P * s.n;
    for (int u = threadIdx.x; u < units; u += NT) {
      const int c = u % s.n, gp = u / s.n, p = gp % P, g0 = (gp / P) * rows;
      const int g1 = min(nrow, g0 + rows);
      const int nb = g1 > g0 ? (g1 - g0) >> 3 : 0;
      const T* col = M.p + c;
      T acc[R];
#pragma unroll
      for (int k = 0; k < R; ++k) acc[k] = T(0);
#pragma unroll 8
      for (int b = 0; b < nb; ++b) {
#pragma unroll
        for (int k = 0; k < R; ++k) {
          const int i = g0 + 8 * b + p * R + k;
          acc[k] = fma(v[i], col[static_cast<size_t>(i) * M.ld], acc[k]);
        }
      }
      if (p == 0)
        for (int i = g0 + 8 * nb; i < g1; ++i)
          acc[0] = fma(v[i], col[static_cast<size_t>(i) * M.ld], acc[0]);
      part[gp * s.n + c] = tree<R>(acc);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < s.n; c += NT) {
      T d = T(0);
      for (int g = 0; g < G; ++g) {
        T h[P];
#pragma unroll
        for (int p = 0; p < P; ++p) h[p] = part[(g * P + p) * s.n + c];
        const T dg = tree<P>(h);
        d = g == 0 ? dg : d + dg;
      }
      const int j = s.c0 + c;
      const T o = val(j, d);
      if constexpr (PUT) {
        put(out, j, o);
      } else {
        out[j] = o;
      }
    }
    __syncthreads();  // part is reused by the next product
  }

  // out[i] = sum_j M[i, j] v[j] on this block's rows i (ncol <= 256), put
  // into every block's `out` (PUT) or this block's. The one-slot kernel's
  // sums: a warp per row, lane l's chain over j = l + 32 k, the warp's
  // butterfly (every lane ends with the row's sum; lane r puts it to block
  // r). A warp loads RB rows before it sums them.
  template <bool PUT>
  __device__ __forceinline__ void matvec(MatRef<T> M, const T* v, int ncol,
                                         Share s, T* out) {
    constexpr int RB = 4;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    T vf[kLaneCols];
#pragma unroll
    for (int k = 0; k < kLaneCols; ++k) {
      const int j = lane + 32 * k;
      vf[k] = j < ncol ? v[j] : T(0);
    }
    for (int r0 = w; r0 < s.n; r0 += RB * NW) {
      T mr[RB][kLaneCols];
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = r0 + q * NW;
        const T* row = M.p + static_cast<size_t>(r < s.n ? r : r0) * M.ld;
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k)
          mr[q][k] = lane + 32 * k < ncol ? row[lane + 32 * k] : T(0);
      }
#pragma unroll
      for (int q = 0; q < RB; ++q) {
        const int r = r0 + q * NW;  // the same in every lane
        T acc = T(0);
#pragma unroll
        for (int k = 0; k < kLaneCols; ++k)
          if (lane + 32 * k < ncol) acc = fma(mr[q][k], vf[k], acc);
        for (int o = 16; o > 0; o >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, o);
        if (r < s.n) {
          if constexpr (PUT) {
            if (lane < C)
              cg::this_cluster().map_shared_rank(out, lane)[s.c0 + r] = acc;
          } else {
            if (lane == 0) out[s.c0 + r] = acc;
          }
        }
      }
    }
    __syncthreads();
  }

  // out = A' w (the debris rows scaled, the s-correction added), val(j, .)
  // of it put into every block's `out`: the gw lanes g from rsel and this
  // block's columns of A_c' (w rsc), then gscat's columns. Two barriers.
  template <class Val>
  __device__ __forceinline__ void apply_AT(const T* w, T* out, Val val) {
    for (int i = threadIdx.x; i < m; i += NT) tm[i] = mul_rn(w[i], rsc[i]);
    vecmat<true>(mat[kMRsel], w, m, gw, sg_, g,
                 [&](int, T d) { return mul_rn(als, d); });
    vecmat<false>(mat[kMAc], tm, m, nz, sz_, tnz, [](int, T d) { return d; });
    sync();
    vecmat<true>(mat[kMGscat], g, gw, nz, sz_, out,
                 [&](int j, T d) { return val(j, add_rn(tnz[j], d)); });
    sync();
  }

  // out = A v, put into every block's `out`: this block's rows of A_c v and
  // the gw lanes g from gsel, then the scatter's chain on those rows and
  // the debris row scale. Two barriers.
  __device__ __forceinline__ void apply_A(const T* v, T* out) {
    matvec<false>(mat[kMAr], v, nz, rm_, tm);
    vecmat<true>(mat[kMGsel], v, nz, gw, sg_, g,
                 [&](int, T d) { return mul_rn(als, d); });
    sync();
    // one chain a row, in k order, as the one-slot kernel's
    const MatRef<T> sc = mat[kMScat];
    for (int r = threadIdx.x; r < rm_.n; r += NT) {
      const int i = rm_.c0 + r;
      T corr = T(0);
      for (int k = 0; k < gw; ++k)
        corr = fma(g[k], sc.p[static_cast<size_t>(k) * sc.ld + r], corr);
      put(out, i, fma(tm[i], rsc[i], corr));
    }
    sync();
  }

  // out = v Pbar, put into every block's `out`. One barrier.
  __device__ __forceinline__ void apply_P(const T* v, T* out) {
    vecmat<true>(mat[kMPbar], v, nz, nz, sz_, out, [](int, T d) { return d; });
    sync();
  }
};

// Copy a share of the done slots' x, y, z through and zero their stats:
// the grid's blocks split the arrays, eight elements a thread at a time.
template <int NT, typename T>
__device__ void pass_done(const Args<T>& a) {
  constexpr int U = 8;
  const size_t t0 = static_cast<size_t>(blockIdx.x) * NT + threadIdx.x;
  const size_t st = static_cast<size_t>(gridDim.x) * NT;
  auto copy = [&](const T* src, T* dst, size_t n, int w) {
    for (size_t e0 = t0; e0 < n; e0 += U * st) {
      T v[U];
      bool dn[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t e = e0 + u * st;
        dn[u] = e < n && a.done[e / w];
        v[u] = e < n ? src[e] : T(0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (dn[u]) dst[e0 + u * st] = v[u];
    }
  };
  const size_t B = a.B;
  copy(a.x, a.xo, B * a.nz, a.nz);
  copy(a.y, a.yo, B * a.m, a.m);
  copy(a.z, a.zo, B * a.m, a.m);
  for (size_t e = t0; e < B * 8; e += st)
    if (a.done[e / 8]) a.stats[e] = T(0);
}

// dst[i * dld + c] = src[i * sld + c] for a rows x w block, four loads a
// thread in flight.
template <int NT, typename T>
__device__ void copy_share(T* dst, int dld, const T* src, int sld, int rows,
                           int w) {
  constexpr int U = 4;
  const int n = rows * w;
  for (int e0 = threadIdx.x; e0 < n; e0 += U * NT) {
    T v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT, i = e / w;
      if (e < n) v[u] = src[static_cast<size_t>(i) * sld + (e - i * w)];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * NT, i = e / w;
      if (e < n) dst[i * dld + (e - i * w)] = v[u];
    }
  }
}

// The count of live slots before this thread's run [*i0, *i1) of slots: a
// block-wide scan of the runs' live counts. Leaves sh[NT / 32] at -1.
template <int NT>
__device__ int live_before(const unsigned char* done, int B, int* sh, int* i0,
                           int* i1) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int per = cdiv(B, NT);
  *i0 = min(B, tid * per);
  *i1 = min(B, *i0 + per);
  int cnt = 0;
  for (int i = *i0; i < *i1; ++i) cnt += done[i] ? 0 : 1;
  int inc = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) sh[w] = inc;
  if (tid == 0) sh[NT / 32] = -1;
  __syncthreads();
  int excl = inc - cnt;
  for (int k = 0; k < w; ++k) excl += sh[k];
  return excl;
}

// The index of the ci-th slot that is not done, in slot order, or -1.
template <int NT>
__device__ int live_slot(const unsigned char* done, int B, int ci, int* sh) {
  int i0, i1;
  int left = ci - live_before<NT>(done, B, sh, &i0, &i1);
  if (left >= 0)
    for (int i = i0; i < i1; ++i)
      if (!done[i] && left-- == 0) {
        sh[NT / 32] = i;
        break;
      }
  __syncthreads();
  return sh[NT / 32];
}

// Live slots past the first n_grid, which no cluster computes (a call that
// gives fewer live slots than it has), get NaN x, y, z and stats: the
// solver resets a row with non-finite stats, and a test sees them.
template <int NT, typename T>
__device__ void mark_uncomputed(const Args<T>& a, int n_grid, int* sh) {
  int i0, i1;
  int rank = live_before<NT>(a.done, a.B, sh, &i0, &i1);
  const T nan = static_cast<T>(NAN);
  for (int i = i0; i < i1; ++i) {
    if (a.done[i] || rank++ < n_grid) continue;
    const size_t onz = static_cast<size_t>(i) * a.nz;
    const size_t om = static_cast<size_t>(i) * a.m;
    for (int j = 0; j < a.nz; ++j) a.xo[onz + j] = nan;
    for (int j = 0; j < a.m; ++j) a.yo[om + j] = a.zo[om + j] = nan;
    for (int j = 0; j < 8; ++j) a.stats[static_cast<size_t>(i) * 8 + j] = nan;
  }
  __syncthreads();  // sh is read again
}

template <typename T, int C>
__global__ void __launch_bounds__(ClShape<C>::threads, 1)
    eig_chunk_kernel_cluster(Args<T> a, ClArgs cla) {
  constexpr int NT = ClShape<C>::threads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int nz = a.nz, m = a.m, K = a.K, gw = a.gw, tid = threadIdx.x;
  const int ci = blockIdx.x / C;
  const int rank = static_cast<int>(cg::this_cluster().block_rank());

  T* sx = sm;  // nz vectors
  T* sq = sx + nz;
  T* sdg = sq + nz;
  T* rhs = sdg + nz;
  T* u = rhs + nz;
  T* ud = u + nz;
  T* xs = ud + nz;
  T* xt = xs + nz;
  T* tnz = xt + nz;
  T* sy = tnz + nz;  // m vectors
  T* sz = sy + m;
  T* slb = sz + m;
  T* sub = slb + m;
  T* srho = sub + m;
  T* srsc = srho + m;
  T* sw = srsc + m;
  T* tm = sw + m;
  T* ax = tm + m;
  T* ka = ax + m;  // K vectors
  T* kt = ka + K;
  T* kh = kt + K;
  T* sg = kh + K;  // gw
  T* part = sg + gw;
  T* red = part + cl_part_elems<C>(nz, K, gw);
  T* sc = red + 32;
  int* sh = reinterpret_cast<int*>(sc + kScalars);

  pass_done<NT>(a);
  if (blockIdx.x == gridDim.x - 1) mark_uncomputed<NT>(a, cla.n_grid, sh);
  const int slot = ci < cla.n_grid ? live_slot<NT>(a.done, a.B, ci, sh) : -1;
  if (slot < 0) return;  // the whole cluster: no block touches another's memory

  const size_t onz = static_cast<size_t>(slot) * nz;
  const size_t om = static_cast<size_t>(slot) * m;
  const int combo = a.tile_combo[slot / a.bt];

  ClBlock<T, C> k{nz, m, gw};
  k.sz_ = share_of<C>(nz, rank);
  k.sk_ = share_of<C>(K, rank);
  k.sg_ = share_of<C>(gw, rank);
  k.rm_ = share_of<C>(m, rank);
  k.part = part;
  k.g = sg;
  k.tm = tm;
  k.tnz = tnz;
  k.rsc = srsc;

  // this block's shares: in shared memory where the plan placed them (loaded
  // once for the chunk), else in global memory
  {
    const T* Ac = a.A + static_cast<size_t>(combo) * m * nz;
    const T* Wc = a.W + static_cast<size_t>(combo) * nz * nz;
    const T* Yc = a.YT + static_cast<size_t>(combo) * K * nz;
    const T* base[kMats] = {Ac, Ac, Wc, Wc, Yc, Yc,
                            a.tinv + static_cast<size_t>(slot) * K * K,
                            a.rsel, a.gsel, a.gscat, a.scat, a.pbar};
    for (int q = 0; q < kMats; ++q) {
      int nrow, ncol;
      bool cols;
      mat_shape(q, nz, m, K, gw, &nrow, &ncol, &cols);
      const Share s = share_of<C>(cols ? ncol : nrow, rank);
      const T* g0 = base[q] + (cols ? s.c0 : static_cast<size_t>(s.c0) * ncol);
      if (cla.moff[q] < 0) {
        k.mat[q] = {g0, ncol};
        continue;
      }
      T* dst = sm + cla.moff[q];
      const int ld = cols ? cdiv(ncol, C) : ncol;
      copy_share<NT>(dst, ld, g0, ncol, cols ? nrow : s.n, cols ? s.n : ncol);
      k.mat[q] = {dst, ld};
    }
  }

  if (tid == 0) {
    const size_t o = static_cast<size_t>(slot) * 8;
    const T r = a.scal[o + 0];
    const T sv = a.scal[o + 1];
    T al = a.scal[o + 2];
    if (al == T(0)) al = T(1);
    const T alsq = mul_rn(al, al);
    const T ralsq = mul_rn(r, alsq);
    sc[kR] = r;
    sc[kAl] = al;
    sc[kRs] = mul_rn(ralsq, sv);
    sc[kRss] = mul_rn(mul_rn(ralsq, sv), sv);
    sc[kRuu] = mul_rn(r, sub_rn(alsq, T(1)));
    sc[kAls] = mul_rn(al, sv);
  }
  __syncthreads();
  k.als = sc[kAls];
  for (int j = tid; j < nz; j += NT) {
    sx[j] = a.x[onz + j];
    sq[j] = a.qbar[onz + j];
    sdg[j] = a.dg[onz + j];
  }
  for (int i = tid; i < m; i += NT) {
    sy[i] = a.y[om + i];
    sz[i] = a.z[om + i];
    slb[i] = a.lbar[om + i];
    sub[i] = a.ubar[om + i];
    srho[i] = mul_rn(sc[kR], a.rhov[i]);
    srsc[i] = fma(sub_rn(sc[kAl], T(1)), a.dmask[i], T(1));
  }
  ClBlock<T, C>::sync();  // loaded; every block of the cluster running

  const int half = K / 2;
  const T rs = sc[kRs], rss = sc[kRss], ruu = sc[kRuu];
  for (int it = 0; it < a.n_iter; ++it) {
    // rhs = sigma x - qbar + A'(rho z - y)
    for (int i = tid; i < m; i += NT)
      sw[i] = fma(srho[i], sz[i], -sy[i]);
    __syncthreads();
    k.apply_AT(sw, rhs, [&](int j, T d) {
      return add_rn(fma(a.sigma, sx[j], -sq[j]), d);
    });

    // exact solve: u = rhs W; d = u dg; a = d YT'; t = a T^-1;
    // h = rs (t K1) + rss (t w33) + ruu (t wuu); xt = ((u - h YT) dg) W'
    k.template vecmat<true>(k.mat[kMWc], rhs, nz, nz, k.sz_, ud,
                            [&](int j, T d) {
                              u[j] = d;
                              return mul_rn(d, sdg[j]);
                            });
    k.sync();
    k.template matvec<true>(k.mat[kMYr], ud, nz, k.sk_, ka);
    k.sync();
    k.template vecmat<true>(k.mat[kMTinv], ka, K, K, k.sk_, kt,
                            [](int, T d) { return d; });
    k.sync();
    for (int l = tid; l < K; l += NT) {
      const T t = kt[l];
      const T tsw = kt[l < half ? l + half : l - half];
      kh[l] = fma(ruu, mul_rn(t, a.wuu[l]),
                  fma(rs, tsw, mul_rn(rss, mul_rn(t, a.w33[l]))));
    }
    __syncthreads();
    k.template vecmat<true>(k.mat[kMYc], kh, K, nz, k.sz_, xs,
                            [&](int j, T d) {
                              return mul_rn(sub_rn(u[j], d), sdg[j]);
                            });
    k.sync();
    k.template matvec<true>(k.mat[kMWr], xs, nz, k.sz_, xt);
    k.sync();

    // zt = A xt; relaxation, clip, dual update
    k.apply_A(xt, ax);
    for (int i = tid; i < m; i += NT) {
      const T ztmp = fma(a.alpha, ax[i], mul_rn(a.one_m_alpha, sz[i]));
      T zn = add_rn(ztmp, sy[i] / srho[i]);
      zn = zn < slb[i] ? slb[i] : zn;  // NaN stays NaN, as in jnp.clip
      zn = zn > sub[i] ? sub[i] : zn;
      sy[i] = fma(srho[i], sub_rn(ztmp, zn), sy[i]);
      sz[i] = zn;
    }
    for (int j = tid; j < nz; j += NT)
      sx[j] = fma(a.alpha, xt[j], mul_rn(a.one_m_alpha, sx[j]));
    __syncthreads();
  }

  if (rank == 0) {
    for (int j = tid; j < nz; j += NT) a.xo[onz + j] = sx[j];
    for (int i = tid; i < m; i += NT) {
      a.yo[om + i] = sy[i];
      a.zo[om + i] = sz[i];
    }
  }

  // ---- scaled residuals and certificates: the products split over the
  // cluster; the reductions in every block in the one-slot thread map
  // (thread tid < kThreads takes elements tid, tid + kThreads, ...)
  const MaxOp mx{};
  const SumOp sum{};
  k.apply_A(sx, ax);  // A x
  T rp[1] = {T(0)}, axm[1] = {T(0)}, azz[1] = {T(0)};
  for (int i = tid; tid < kThreads && i < m; i += kThreads) {
    const T e = a.einv[i];
    rp[0] = pmax(rp[0], fabs(mul_rn(e, sub_rn(ax[i], sz[i]))));
    axm[0] = pmax(axm[0], fabs(mul_rn(e, ax[i])));
    azz[0] = pmax(azz[0], fabs(mul_rn(e, sz[i])));
  }
  block_reduce<T, 1>(rp, red, mx);
  block_reduce<T, 1>(axm, red, mx);
  block_reduce<T, 1>(azz, red, mx);
  const T rp_rel = pmax(axm[0], azz[0]);

  k.apply_P(sx, rhs);                                      // P x
  k.apply_AT(sy, ud, [](int, T d) { return d; });          // A'y
  T rd[1] = {T(0)}, dpx[1] = {T(0)}, daty[1] = {T(0)}, dq[1] = {T(0)};
  for (int j = tid; tid < kThreads && j < nz; j += kThreads) {
    const T d = a.dinv[j];
    rd[0] = pmax(rd[0], fabs(mul_rn(d, add_rn(add_rn(rhs[j], sq[j]), ud[j]))));
    dpx[0] = pmax(dpx[0], fabs(mul_rn(d, rhs[j])));
    daty[0] = pmax(daty[0], fabs(mul_rn(d, ud[j])));
    dq[0] = pmax(dq[0], fabs(mul_rn(d, sq[j])));
  }
  block_reduce<T, 1>(rd, red, mx);
  block_reduce<T, 1>(dpx, red, mx);
  block_reduce<T, 1>(daty, red, mx);
  block_reduce<T, 1>(dq, red, mx);
  const T rd_rel = pmax(dpx[0], pmax(daty[0], dq[0]));

  // primal infeasibility (Farkas) certificate from dy, projected onto the
  // polar of the recession cone of [l, u]
  T nv[1] = {T(0)}, sup_u[1] = {T(0)}, sup_l[1] = {T(0)};
  for (int i = tid; tid < kThreads && i < m; i += kThreads) {
    const T uinf = isfinite(sub[i]) ? T(0) : T(1);
    const T linf = isfinite(slb[i]) ? T(0) : T(1);
    const T both = uinf * linf;
    const T uo = uinf * (T(1) - linf);
    const T lo = linf * (T(1) - uinf);
    T v = mul_rn(sub_rn(sy[i], a.y[om + i]), T(1) - both);
    v = fma(v, T(1) - uo, mul_rn(pmin(v, T(0)), uo));
    v = fma(v, T(1) - lo, mul_rn(pmax(v, T(0)), lo));
    sw[i] = v;
    nv[0] = pmax(nv[0], fabs(v));
    const T ucap = uinf == T(0) ? sub[i] : T(0);
    const T lcap = linf == T(0) ? slb[i] : T(0);
    sup_u[0] = fma(ucap, pmax(v, T(0)), sup_u[0]);
    sup_l[0] = fma(lcap, pmin(v, T(0)), sup_l[0]);
  }
  block_reduce<T, 1>(nv, red, mx);
  block_reduce<T, 1>(sup_u, red, sum);
  block_reduce<T, 1>(sup_l, red, sum);
  const T sup = add_rn(sup_u[0], sup_l[0]);
  k.apply_AT(sw, xs, [](int, T d) { return d; });  // A'v
  T atv[1] = {T(0)};
  for (int j = tid; tid < kThreads && j < nz; j += kThreads)
    atv[0] = pmax(atv[0], fabs(xs[j]));
  block_reduce<T, 1>(atv, red, mx);

  // dual infeasibility certificate from dx
  T nvx[1] = {T(0)}, qv[1] = {T(0)};
  for (int j = tid; tid < kThreads && j < nz; j += kThreads) {
    const T d = sub_rn(sx[j], a.x[onz + j]);
    u[j] = d;
    nvx[0] = pmax(nvx[0], fabs(d));
    qv[0] = fma(sq[j], d, qv[0]);
  }
  block_reduce<T, 1>(nvx, red, mx);
  block_reduce<T, 1>(qv, red, sum);
  k.apply_P(u, xt);  // P dx
  T pdx[1] = {T(0)};
  for (int j = tid; tid < kThreads && j < nz; j += kThreads)
    pdx[0] = pmax(pdx[0], fabs(xt[j]));
  block_reduce<T, 1>(pdx, red, mx);
  k.apply_A(u, ax);  // A dx: the cluster's last exchange
  const T eps_b = mul_rn(a.eps_dinf, nvx[0]);
  T up_viol[1] = {T(0)}, lo_viol[1] = {T(0)};
  for (int i = tid; tid < kThreads && i < m; i += kThreads) {
    const T uinf = isfinite(sub[i]) ? T(0) : T(1);
    const T linf = isfinite(slb[i]) ? T(0) : T(1);
    up_viol[0] = pmax(up_viol[0],
                      pmax(sub_rn(ax[i], eps_b), T(0)) * (T(1) - uinf));
    lo_viol[0] = pmax(lo_viol[0],
                      pmax(sub_rn(-eps_b, ax[i]), T(0)) * (T(1) - linf));
  }
  block_reduce<T, 1>(up_viol, red, mx);
  block_reduce<T, 1>(lo_viol, red, mx);
  if (rank == 0 && tid == 0) {
    const bool pinf = (fma(a.eps_pinf, nv[0], -atv[0]) > T(0)) &&
                      (fma(-a.thresh, nv[0], -sup) > T(0)) &&
                      (nv[0] - a.eps_pinf > T(0));
    const bool dinf = (sub_rn(eps_b, pdx[0]) > T(0)) &&
                      (sub_rn(-eps_b, qv[0]) > T(0)) && up_viol[0] == T(0) &&
                      lo_viol[0] == T(0) && (nvx[0] - a.eps_dinf > T(0));
    T* st = a.stats + static_cast<size_t>(slot) * 8;
    st[0] = rp[0];
    st[1] = rp_rel;
    st[2] = rd[0];
    st[3] = rd_rel;
    st[4] = pinf ? T(1) : T(0);
    st[5] = dinf ? T(1) : T(0);
    st[6] = nv[0];
    st[7] = nvx[0];
  }
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------

namespace {

template <typename T, int S>
int launch_group(const Args<T>& a, void* stream) {
  const size_t smem =
      sizeof(T) * static_cast<size_t>(S) *
      (6 * static_cast<size_t>(a.nz) + 8 * static_cast<size_t>(a.m) +
       2 * a.K + a.gw + kThreads + 32 + kScalars + kFin);
  cudaError_t e = cudaFuncSetAttribute(
      eig_chunk_kernel<T, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  eig_chunk_kernel<T, S><<<a.B / S, Layout<T>::block, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(void* const* p, int B, int nz, int m, int K, int gw, int bt,
                  int n_iter, double sigma, double alpha, double eps_pinf,
                  double eps_dinf, double thresh) {
  Args<T> a;
  a.tile_combo = static_cast<const int*>(p[0]);
  a.tinv = static_cast<const T*>(p[1]);
  a.scal = static_cast<const T*>(p[2]);
  a.qbar = static_cast<const T*>(p[3]);
  a.lbar = static_cast<const T*>(p[4]);
  a.ubar = static_cast<const T*>(p[5]);
  a.dg = static_cast<const T*>(p[6]);
  a.x = static_cast<const T*>(p[7]);
  a.y = static_cast<const T*>(p[8]);
  a.z = static_cast<const T*>(p[9]);
  a.done = static_cast<const unsigned char*>(p[10]);
  a.A = static_cast<const T*>(p[11]);
  a.W = static_cast<const T*>(p[12]);
  a.YT = static_cast<const T*>(p[13]);
  a.pbar = static_cast<const T*>(p[14]);
  a.w33 = static_cast<const T*>(p[15]);
  a.gsel = static_cast<const T*>(p[16]);
  a.scat = static_cast<const T*>(p[17]);
  a.rsel = static_cast<const T*>(p[18]);
  a.gscat = static_cast<const T*>(p[19]);
  a.rhov = static_cast<const T*>(p[20]);
  a.einv = static_cast<const T*>(p[21]);
  a.dinv = static_cast<const T*>(p[22]);
  a.wuu = static_cast<const T*>(p[23]);
  a.dmask = static_cast<const T*>(p[24]);
  a.xo = static_cast<T*>(p[25]);
  a.yo = static_cast<T*>(p[26]);
  a.zo = static_cast<T*>(p[27]);
  a.stats = static_cast<T*>(p[28]);
  a.B = B;
  a.nz = nz;
  a.m = m;
  a.K = K;
  a.gw = gw;
  a.bt = bt;
  a.n_iter = n_iter;
  a.sigma = static_cast<T>(sigma);
  a.alpha = static_cast<T>(alpha);
  a.one_m_alpha = static_cast<T>(1.0 - alpha);
  a.eps_pinf = static_cast<T>(eps_pinf);
  a.eps_dinf = static_cast<T>(eps_dinf);
  a.thresh = static_cast<T>(thresh);
  return a;
}

template <typename T>
int launch(void* const* p, int B, int nz, int m, int K, int gw, int bt,
           int n_iter, int group, double sigma, double alpha, double eps_pinf,
           double eps_dinf, double thresh, void* stream) {
  const Args<T> a = make_args<T>(p, B, nz, m, K, gw, bt, n_iter, sigma, alpha,
                                 eps_pinf, eps_dinf, thresh);
  if (B == 0) return 0;
  if (nz > 32 * kLaneCols || group < 1 || bt % group || B % bt)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (group) {
    case 1: return launch_group<T, 1>(a, stream);
    case 2: return launch_group<T, 2>(a, stream);
    case 4:
      if constexpr (sizeof(T) == 4) return launch_group<T, 4>(a, stream);
      break;
    case 8:
      if constexpr (sizeof(T) == 4) return launch_group<T, 8>(a, stream);
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The cluster layout's shared memory: the vectors, then the block's matrix
// shares, largest first, each that still fits the 227 KB a block can hold
// (Pbar, read twice a chunk, streams); moff gets each share's offset or -1.
// Returns the block's bytes.
template <int C>
size_t cl_plan(int nz, int m, int K, int gw, int* moff) {
  const size_t cap = kClSmemCap / sizeof(float);
  size_t used = static_cast<size_t>(cl_vec_elems<C>(nz, m, K, gw));
  for (int q = 0; q < kMats; ++q) moff[q] = -1;
  for (;;) {
    int best = -1;
    size_t most = 0;
    for (int q = 0; q < kMats; ++q) {
      const size_t e = static_cast<size_t>(share_elems<C>(q, nz, m, K, gw));
      if (moff[q] < 0 && q != kMPbar && used + e <= cap && e > most) {
        best = q;
        most = e;
      }
    }
    if (best < 0) break;
    moff[best] = static_cast<int>(used);
    used += most;
  }
  return used * sizeof(float);
}

// Lets the kernel take up to all the shared memory a block can hold (each
// launch asks for its plan's part) and, at C = 16, clusters larger than the
// portable 8.
template <int C>
cudaError_t cl_prepare() {
  cudaError_t e = cudaFuncSetAttribute(
      eig_chunk_kernel_cluster<float, C>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kClSmemCap);
  if (e == cudaSuccess && C > 8)
    e = cudaFuncSetAttribute(eig_chunk_kernel_cluster<float, C>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  return e;
}

template <int C>
cudaLaunchConfig_t cl_config(unsigned blocks, size_t smem,
                             cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(ClShape<C>::threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// n_clusters clusters of C blocks, the first n_grid looking for a live slot
// each, with the block's shared memory and shares' offsets of cl_plan (the
// kernel prepared by cl_shape).
template <int C>
int launch_cluster(const Args<float>& a, int n_grid, int n_clusters,
                   int smem, const int* moff, void* stream) {
  ClArgs cla;
  cla.n_grid = n_grid;
  for (int q = 0; q < kMats; ++q) cla.moff[q] = moff[q];
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg =
      cl_config<C>(static_cast<unsigned>(n_clusters) * C, smem, attr);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, eig_chunk_kernel_cluster<float, C>, a, cla);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The layout of clusters of C blocks at these shapes, once per shape: the
// block's shared memory and shares' offsets (cl_plan), and how many
// clusters the card holds at once, one wave. An error (the plan does not
// fit) is returned and cleared.
template <int C>
int cl_shape(int nz, int m, int K, int gw, int* waves, int* smem,
             int* moff) {
  *smem = static_cast<int>(cl_plan<C>(nz, m, K, gw, moff));
  cudaError_t e = cl_prepare<C>();
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = cl_config<C>(C, *smem, attr);
    e = cudaOccupancyMaxActiveClusters(waves,
                                       eig_chunk_kernel_cluster<float, C>, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

template <class F>
int with_cluster(int C, F f) {
  switch (C) {
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

#define EIG_CHUNK_ENTRY(NAME, T)                                               \
  extern "C" int NAME(                                                         \
      void* p0, void* p1, void* p2, void* p3, void* p4, void* p5, void* p6,    \
      void* p7, void* p8, void* p9, void* p10, void* p11, void* p12,           \
      void* p13, void* p14, void* p15, void* p16, void* p17, void* p18,        \
      void* p19, void* p20, void* p21, void* p22, void* p23, void* p24,        \
      void* p25, void* p26, void* p27, void* p28, int B, int nz, int m, int K, \
      int gw, int bt, int n_iter, int group, double sigma, double alpha,       \
      double eps_pinf, double eps_dinf, double thresh, void* stream) {         \
    void* const p[29] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,  p8,  p9,      \
                         p10, p11, p12, p13, p14, p15, p16, p17, p18, p19,     \
                         p20, p21, p22, p23, p24, p25, p26, p27, p28};         \
    return launch<T>(p, B, nz, m, K, gw, bt, n_iter, group, sigma, alpha,      \
                     eps_pinf, eps_dinf, thresh, stream);                      \
  }

EIG_CHUNK_ENTRY(eig_chunk_f32, float)
EIG_CHUNK_ENTRY(eig_chunk_f64, double)

// The cluster layout (fp32): C blocks a live slot, n_clusters clusters of
// which the first n_grid each take a live slot (the rest, and every block,
// copy a share of the done slots through); smem and moff as
// eig_cluster_shape gave them for these shapes.
extern "C" int eig_cluster_f32(
    void* p0, void* p1, void* p2, void* p3, void* p4, void* p5, void* p6,
    void* p7, void* p8, void* p9, void* p10, void* p11, void* p12, void* p13,
    void* p14, void* p15, void* p16, void* p17, void* p18, void* p19,
    void* p20, void* p21, void* p22, void* p23, void* p24, void* p25,
    void* p26, void* p27, void* p28, int B, int nz, int m, int K, int gw,
    int bt, int n_iter, int C, int n_grid, int n_clusters, int smem,
    const int* moff, double sigma, double alpha, double eps_pinf,
    double eps_dinf, double thresh, void* stream) {
  void* const p[29] = {p0,  p1,  p2,  p3,  p4,  p5,  p6,  p7,  p8,  p9,
                       p10, p11, p12, p13, p14, p15, p16, p17, p18, p19,
                       p20, p21, p22, p23, p24, p25, p26, p27, p28};
  const Args<float> a = make_args<float>(p, B, nz, m, K, gw, bt, n_iter, sigma,
                                         alpha, eps_pinf, eps_dinf, thresh);
  if (B == 0) return 0;
  if (nz > 32 * kLaneCols || B % bt || n_grid < 0 || n_grid > n_clusters ||
      n_clusters < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return with_cluster(C, [&](auto c) {
    return launch_cluster<decltype(c)::value>(a, n_grid, n_clusters, smem,
                                              moff, stream);
  });
}

// The cluster layout of size C at these shapes (cl_shape); moff has room
// for n_moff offsets, at least the kernel's kMats.
extern "C" int eig_cluster_shape(int C, int nz, int m, int K, int gw,
                                 int* waves, int* smem, int* moff,
                                 int n_moff) {
  if (n_moff < kMats) return static_cast<int>(cudaErrorInvalidValue);
  return with_cluster(C, [&](auto c) {
    return cl_shape<decltype(c)::value>(nz, m, K, gw, waves, smem, moff);
  });
}
