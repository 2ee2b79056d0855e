// Chunk-parts timing probe, for Hopper (sm_90a).
//
// Replaces the six Pallas TPU kernels of
//   tools/kernel_probe.py::main (the bodies of its one pallas_call)
// and computes what their plain torch twins
//   mpc_arpo_project_tpu_torch/tools/kernel_probe.py::*_ref
// compute. Each variant maps x (B, nz) to out (B, nz) through n_it dependent
// iterations inside one launch:
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
// in one of the original's three precisions of a product a b:
//   highest  fp32 on the CUDA cores (no TF32);
//   default  one bf16 pass: both operands rounded to bf16 (nearest even),
//            exact products, fp32 sums;
//   high     bf16_3x: a = a_hi + a_lo, b = b_hi + b_lo (bf16 limbs, the lo
//            limb bf16 of the remainder), a_hi b_hi + a_hi b_lo + a_lo b_hi
//            summed in fp32.
// minv_bf16 names its bf16 limbs itself and is the same in every precision.
//
// What bounds each variant on the H100 and what the design does about it
// (nz=256, m=512, B=1024, bt=32, n_it=25, fp32 inputs):
//
// * matvec_pair, stack7 share one matrix (a0 512 KiB, s7 1.75 MiB) across
//   problems. A lone block per problem re-reads it from L2 every iteration
//   (26.8 and 47 GB: L2-bound, 14-15x their 0.20 / 0.35 ms operations
//   bound). Here a block runs a slot group of kSlots = 8 problems (128
//   blocks, one per SM) and streams the matrix through a kSlotStages-deep
//   ring of (kKc x kNb) tiles, each tile serving all 8 problems, which cuts
//   the L2 reads 8-fold. The Tensor Memory Accelerator stages each tile in
//   one or a few instructions (tensor maps made on the host; cp.async
//   where a map cannot be made), completing an mbarrier per stage: the
//   threads' own cp.async copies were bound by the requests an SM keeps in
//   flight (a block streamed ~24 GB/s whatever the number of blocks). The
//   ring runs across phases and iterations (the matrix does not depend on
//   the iterate), so it never drains; a block reads its tile sequence from
//   a table made once. What is left is still the stream of a block (~1 MiB (2 x
//   a0) or 1.75 MiB (s7) an iteration): the time does not change from 32
//   to 128 blocks. At 'highest' a thread holds a 4-column x 8-problem
//   register tile (32 FMAs per 3 shared loads) and thread groups split k;
//   at 'high' and 'default' each warp runs mma.sync m16n8k16 (bf16 ->
//   fp32) on 16-column slices with the 8 problems as the n8 side,
//   converting the fp32 tile to bf16 limbs in registers, the problems'
//   limbs prepared once a phase in fragment order.
// * minv_rowvec, minv_lhs, minv_bf16 read 256 KiB of Minv per problem; a
//   stream per iteration is 6.7 GB, a 2.003 ms floor. Here each problem's
//   Minv is held on chip for all n_it iterations: a cluster of 2 blocks,
//   each with half of it in shared memory (128 KiB: columns for the row
//   vector, rows for the matrix-lhs orientation), read from HBM once
//   (0.081 ms for all 1024). The blocks exchange their halves of the new
//   iterate through distributed shared memory behind one cluster barrier
//   an iteration. What is left is shared-memory bandwidth (the half-matrix
//   read each iteration) and the latency of n_it cluster-wide steps, in
//   waves of 66 clusters (one block an SM). 'high', 'default' and the bf16
//   variant keep M as packed (hi, lo) bf16 pairs, split once when it is
//   loaded; one row per problem would use 1/16 of a tensor-core tile, so
//   they stay on the CUDA cores with the operands rounded.
// * minv_blockdiag executes bt-fold masked MACs (107 GFLOP, 1.603 ms at the
//   fp32 peak) and streams every tile's Minv each iteration (2.003 ms). A
//   cluster of kBdCluster = 8 blocks runs a tile, each block owning nz / 8
//   output columns: its (bt nz x nz/8) slice of mflat streams through a
//   cp.async ring of 64-row tiles (the Tensor Memory Accelerator gains
//   nothing on these 128-byte rows), each staged element used for all bt
//   rows; the tile's x stays in shared memory, and the new iterate goes to
//   the 8 blocks' copies through distributed shared memory (two cluster
//   barriers an iteration), so nothing of it leaves the chip between
//   iterations. A block keeps under 76 KB of shared memory so that 3 fit
//   an SM: at 2 the card holds 30 clusters of 8, and the flagship's 32
//   tiles would take two waves. That leaves room for a 3-deep ring of
//   8 KB tiles, which holds the stream well under the HBM rate. At
//   'high' and 'default' warp (k-step, 16-column slice) runs mma.sync for
//   all of the tile's 8-row n-tiles, the expanded x's B fragments formed
//   once a tile by the block.

#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSlots = 8;        // problems per block, shared-matrix variants
constexpr int kKc = 32;          // k extent of a slot-kernel tile
constexpr int kNb = 256;         // most outputs of a slot-kernel n-block
constexpr int kSlotStages = 4;   // depth of the slot kernels' ring
constexpr int kSlotStage = kNb * kKc;  // floats of a slot-kernel stage
constexpr int kMaxTiles = 64;    // a slot kernel's tiles per iteration
constexpr int kBdCluster = 8;    // blocks per tile, block-diagonal variant
constexpr int kBdKc = 64;        // k extent of a block-diagonal tile
constexpr int kBdStages = 3;     // depth of the block-diagonal ring
constexpr int kBdSteps = kBdKc / 16;  // its tensor-core k-steps a tile

enum Variant { kMatvec = 0, kRowvec = 1, kLhs = 2, kBf16 = 3, kBlockdiag = 4,
               kStack7 = 5 };
enum Prec { kHighest = 0, kHigh = 1, kDefault = 2 };

__host__ __device__ constexpr int up(int a, int b) { return (a + b - 1) / b * b; }
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- cp.async ------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp16(float* dst, const float* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp4(float* dst, const float* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows [r0, r0 + nr) x columns [c0, c0 + nc) of the row-major (R,
// ldw) matrix W into dst (leading dimension sld), zeros outside W: 16-byte
// copies where the rows allow them, 4-byte ones otherwise.
__device__ __forceinline__ void copy_tile(float* dst, int sld, const float* W,
                                          int ldw, int R, int r0, int nr,
                                          int c0, int nc) {
  const bool vec = ((ldw | c0 | nc | sld) & 3) == 0 &&
                   (reinterpret_cast<uintptr_t>(W) & 15) == 0;
  if (vec) {
    const int q = nc >> 2;
    if ((q & (q - 1)) == 0 && q <= kThreads) {
      // q divides kThreads: a thread copies one column of quads, one
      // division in all
      const int lq = __ffs(q) - 1;
      const int i0 = threadIdx.x >> lq, j = (threadIdx.x & (q - 1)) << 2;
      const int c = c0 + j;
      for (int i = i0; i < nr; i += kThreads >> lq) {
        const int r = r0 + i;
        const bool in = r < R && c < ldw;
        cp16(dst + i * sld + j, in ? W + static_cast<size_t>(r) * ldw + c : W,
             in);
      }
      return;
    }
    for (int e = threadIdx.x; e < nr * q; e += kThreads) {
      const int i = e / q, j = (e - i * q) << 2;
      const int r = r0 + i, c = c0 + j;
      const bool in = r < R && c < ldw;
      cp16(dst + i * sld + j, in ? W + static_cast<size_t>(r) * ldw + c : W,
           in);
    }
  } else {
    for (int e = threadIdx.x; e < nr * nc; e += kThreads) {
      const int i = e / nc, j = e - i * nc;
      const int r = r0 + i, c = c0 + j;
      const bool in = r < R && c < ldw;
      cp4(dst + i * sld + j, in ? W + static_cast<size_t>(r) * ldw + c : W,
          in);
    }
  }
}

// ---- mbarriers and the Tensor Memory Accelerator ---------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// An arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Staged tiles are sub-tiles of 32 columns (128 bytes a row) in the
// Tensor Memory Accelerator's 128-byte swizzle: the 16-byte chunk c of row i
// lies at chunk c ^ (i mod 8), so that threads reading one chunk of 8
// consecutive rows, or 8 chunks of one row, hit distinct banks. The offset
// of element (i, j < 32) of a sub-tile:
__device__ __forceinline__ int sw(int i, int j) {
  return i * 32 + ((((j >> 2) ^ i) & 7) << 2) + (j & 3);
}

__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int col, int row, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col),
      "r"(row)
      : "memory");
}

// Stages `subs` sub-tiles of `rows` rows: sub-tile b holds rows [row0,
// row0 + rows) x columns [col0 + 32 b, col0 + 32 b + 32) of the row-major
// (R, ldw) matrix W, zeros outside it, at dst + b rows 32; `bar` completes
// when they have landed. With `map` (a tensor map of W in boxes of 32 x
// rows) warp 0 hands each sub-tile to the Tensor Memory Accelerator in one
// instruction; otherwise every thread issues 4-byte cp.async copies to the
// same swizzled places and arrives once they land.
__device__ __forceinline__ void stage_boxes(float* dst, const CUtensorMap* map,
                                            const float* W, int ldw, int R,
                                            int row0, int rows, int col0,
                                            int subs, uint64_t* bar) {
  if (map != nullptr) {
    if (threadIdx.x < 32) {
      if (threadIdx.x == 0)
        mbar_expect_tx(bar, static_cast<uint32_t>(subs * rows * 128));
      __syncwarp();
      if (static_cast<int>(threadIdx.x) < subs)
        tma_box(dst + threadIdx.x * rows * 32, map, col0 + 32 * threadIdx.x,
                row0, bar);
    }
    return;
  }
  const int per = rows * 32;
  for (int e = threadIdx.x; e < subs * per; e += kThreads) {
    const int b = e / per, i = (e - b * per) >> 5, j = e & 31;
    const int r = row0 + i, c = col0 + 32 * b + j;
    const bool in = r < R && c < ldw;
    cp4(dst + b * per + sw(i, j), in ? W + static_cast<size_t>(r) * ldw + c : W,
        in);
  }
  cp_async_arrive(bar);
}

// Stages rows [r0, r0 + nr) x columns [c0, c0 + nc) of W into dst with
// leading dimension sld (as copy_tile: 16-byte cp.async where the rows allow
// them, zeros outside W); `bar` completes when they have landed.
__device__ __forceinline__ void stage_rows(float* dst, int sld, const float* W,
                                           int ldw, int R, int r0, int nr,
                                           int c0, int nc, uint64_t* bar) {
  copy_tile(dst, sld, W, ldw, R, r0, nr, c0, nc);
  cp_async_arrive(bar);
}

// Stages rows [row0, row0 + rows) x columns [col0, col0 + cols) of W into
// dst densely (rows of `cols` floats), zeros outside W; `bar` completes when
// they have landed: one Tensor Memory Accelerator box with `map` (a tensor
// map of W in boxes of cols x rows, unswizzled), else 4-byte cp.async copies.
__device__ __forceinline__ void stage_dense(float* dst, const CUtensorMap* map,
                                            const float* W, int ldw, int R,
                                            int row0, int rows, int col0,
                                            int cols, uint64_t* bar) {
  if (map != nullptr) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(bar, static_cast<uint32_t>(rows * cols * 4));
      tma_box(dst, map, col0, row0, bar);
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
    const int i = e / cols, j = e - i * cols;
    const int r = row0 + i, c = col0 + j;
    const bool in = r < R && c < ldw;
    cp4(dst + e, in ? W + static_cast<size_t>(r) * ldw + c : W, in);
  }
  cp_async_arrive(bar);
}

// A ring of kDepth stages of kStage floats, stage s complete when bars[s]
// completes a phase; `copy(dst, bar)` stages the next tile (called for the
// tiles in order, by every thread). Step t: wait for tile t, release the
// stage tile t - 1 used, and start tile t + kDepth - 1 into it.
template <int kDepth>
__device__ __forceinline__ void ring_init(uint64_t* bars, bool tma) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < kDepth; ++i) mbar_init(bars + i, tma ? 1 : kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

template <int kDepth, int kStage, class Copy>
__device__ __forceinline__ const float* ring_step(int t, int n_tiles,
                                                  float* ring, uint64_t* bars,
                                                  Copy& copy) {
  mbar_wait(bars + t % kDepth, (t / kDepth) & 1);
  __syncthreads();
  const int nt = t + kDepth - 1;
  if (nt < n_tiles) copy(ring + (nt % kDepth) * kStage, bars + nt % kDepth);
  return ring + (t % kDepth) * kStage;
}

template <int kDepth, int kStage, class Copy>
__device__ __forceinline__ void ring_start(int n_tiles, float* ring,
                                           uint64_t* bars, Copy& copy) {
  for (int t = 0; t < kDepth - 1 && t < n_tiles; ++t)
    copy(ring + t * kStage, bars + t);
}

// ---- bf16 limbs and the tensor-core product -------------------------------

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The hi limbs of (a, b) packed as a bf16 pair (a in the low half), and,
// where wanted, their lo limbs bf16(a - hi(a)), bf16(b - hi(b)).
template <int PREC>
__device__ __forceinline__ void limbs2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = as_u32(h);
  if (PREC == kHigh) {
    const float2 hf = __bfloat1622float2(h);
    lo = as_u32(__floats2bfloat162_rn(a - hf.x, b - hf.y));
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in the precision's passes: hi hi (default); hi hi + hi lo + lo hi
// (high).
template <int PREC>
__device__ __forceinline__ void mma_passes(float (&c)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           uint2 bh, uint2 bl) {
  mma(c, ah, bh.x, bh.y);
  if (PREC == kHigh) {
    mma(c, ah, bl.x, bl.y);
    mma(c, al, bh.x, bh.y);
  }
}

// A fragment (16 x 16, row-major) of rows [r, r + 16) and columns
// [k, k + 16) of the matrix elem(row, col), as bf16 limbs.
template <int PREC, class Elem>
__device__ __forceinline__ void a_frag(Elem elem, int r, int k,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r + g + ((i & 1) << 3), col = k + 2 * t + ((i >> 1) << 3);
    limbs2<PREC>(elem(row, col), elem(row, col + 1), ah[i], al[i]);
  }
}

// ---- slot groups: matvec_pair and stack7 -----------------------------------

struct SlotArgs {
  CUtensorMap nt_map;  // matvec's a0 in boxes of 32 x kNb (phase 0 tiles)
  CUtensorMap nn_map;  // a0 or s7 in boxes of nn_width(nz) x kKc (CUDA
                       // cores, unswizzled) or 32 x kKc (tensor cores)
  const float* x;      // (B, nz)
  const float* mat;    // a0 (m, nz) or s7 (nz, 7 nz)
  float* out;          // (B, nz)
  int B, nz, m, n_it;
  int tma;             // the maps are made: stage tiles with them
};

// Shared memory of a slot kernel, in floats: the ring, the tile table (an
// int4 a tile of an iteration), the slot group's x (kSlots, ldx) and, for
// matvec, y (kSlots, ldy), stack7's combine (kSlots, nz), the CUDA-core
// kernel's partial sums, the tensor-core kernel's operand limbs (hi, lo: a
// uint2 per lane and k-step), the ring's mbarriers.
struct SlotSmem {
  int ldx, ldy, tab, xs, ys, xacc, part, limbs, bars, total;
  __host__ __device__ SlotSmem(int variant, int prec, int nz, int m) {
    ldx = up(nz, kKc);
    ldy = variant == kMatvec ? up(m, kKc) : 0;
    tab = kSlotStages * kSlotStage;
    xs = tab + 4 * kMaxTiles;
    ys = xs + kSlots * ldx;
    xacc = ys + kSlots * ldy;
    part = xacc + (variant == kStack7 ? up(kSlots * nz, 4) : 0);
    limbs = part + (prec == kHighest ? kSlots * 4 * kThreads : 0);
    const int kmax = ldx > ldy ? ldx : ldy;
    bars = limbs + (prec == kHighest ? 0 : 2 * (kmax / 16) * 64);
    total = bars + 2 * kSlotStages;
  }
};

// One tile of a slot kernel's per-iteration sequence. matvec: phase 0 is
// y = x a0' (tiles a0[n-block rows, 32 k columns], "nt"), phase 1 is
// x = 1e-3 y a0 (tiles a0[32 k rows, all nz columns]); stack7: the n-block
// t is s7's columns [t nz, (t + 1) nz), over 32-row tiles.
struct SlotTile {
  bool nt, first, last, phase_start;
  int phase, nb, n0, nn, k0;
};

// A SlotTile packed in an int4 of the tile table: (k0, n0, nn, flags and nb).
__device__ __forceinline__ int4 pack_tile(const SlotTile& s) {
  return make_int4(s.k0, s.n0, s.nn,
                   (s.nt ? 1 : 0) | (s.first ? 2 : 0) | (s.last ? 4 : 0) |
                       (s.phase_start ? 8 : 0) | (s.phase << 4) |
                       (s.nb << 8));
}

__device__ __forceinline__ SlotTile unpack_tile(int4 v) {
  SlotTile s;
  s.k0 = v.x;
  s.n0 = v.y;
  s.nn = v.z;
  s.nt = v.w & 1;
  s.first = v.w & 2;
  s.last = v.w & 4;
  s.phase_start = v.w & 8;
  s.phase = (v.w >> 4) & 15;
  s.nb = v.w >> 8;
  return s;
}

__device__ __forceinline__ SlotTile slot_tile(int variant, int r, int nz,
                                              int m) {
  SlotTile s;
  const int kz = cdiv(nz, kKc);
  if (variant == kMatvec) {
    const int na = cdiv(m, kNb) * kz;
    if (r < na) {
      const int kp = r % kz;
      s.nt = true;
      s.phase = 0;
      s.nb = r / kz;
      s.n0 = s.nb * kNb;
      s.nn = min(kNb, m - s.n0);
      s.k0 = kp * kKc;
      s.first = kp == 0;
      s.last = kp == kz - 1;
      s.phase_start = r == 0;
    } else {
      const int kp = r - na, km = cdiv(m, kKc);
      s.nt = false;
      s.phase = 1;
      s.nb = 0;
      s.n0 = 0;
      s.nn = nz;
      s.k0 = kp * kKc;
      s.first = kp == 0;
      s.last = kp == km - 1;
      s.phase_start = kp == 0;
    }
  } else {
    const int kp = r % kz;
    s.nt = false;
    s.phase = 0;
    s.nb = r / kz;
    s.n0 = s.nb * nz;
    s.nn = nz;
    s.k0 = kp * kKc;
    s.first = kp == 0;
    s.last = kp == kz - 1;
    s.phase_start = r == 0;
  }
  return s;
}

// The columns of a staged "nn" tile (one box): the n-block's, at least.
__host__ __device__ inline int nn_width(int nz) {
  return up(nz, 4) < kNb ? up(nz, 4) : kNb;
}

__host__ __device__ inline int slot_tiles_per_it(int variant, int nz, int m) {
  return variant == kMatvec ? cdiv(m, kNb) * cdiv(nz, kKc) + cdiv(m, kKc)
                            : 7 * cdiv(nz, kKc);
}

// Result element (slot sl, output n of the tile's n-block) with value v.
template <int VARIANT>
__device__ __forceinline__ void slot_emit(const SlotTile& s, const SlotSmem& L,
                                          float* smem, int nz, int sl, int n,
                                          float v) {
  if (VARIANT == kMatvec) {
    if (s.phase == 0)
      smem[L.ys + sl * L.ldy + s.n0 + n] = v;
    else
      smem[L.xs + sl * L.ldx + n] = static_cast<float>(1e-3) * v;
  } else {
    // the twin adds the terms t = 0..6 in order, products and sums apart
    const float w = static_cast<float>(0.1 + s.nb);
    float& xa = smem[L.xacc + sl * nz + n];
    const float term = __fmul_rn(w, v);
    const float acc = s.nb == 0 ? term : __fadd_rn(xa, term);
    if (s.nb == 6)
      smem[L.xs + sl * L.ldx + n] = __fmul_rn(static_cast<float>(1e-3), acc);
    else
      xa = acc;
  }
}

template <int VARIANT, int PREC>
__global__ void __launch_bounds__(kThreads, 1)
    slot_kernel(const __grid_constant__ SlotArgs a) {
  extern __shared__ __align__(1024) float smem[];
  const SlotSmem L(VARIANT, PREC, a.nz, a.m);
  const int tid = threadIdx.x, nz = a.nz, m = a.m;
  const int s0 = blockIdx.x * kSlots, ns = min(kSlots, a.B - s0);
  float* ring = smem;
  float* xs = smem + L.xs;
  for (int e = tid; e < L.xacc - L.xs; e += kThreads) xs[e] = 0.f;
  for (int e = tid; e < ns * nz; e += kThreads) {
    const int sl = e / nz, k = e - sl * nz;
    xs[sl * L.ldx + k] = a.x[static_cast<size_t>(s0) * nz + e];
  }
  const int per_it = slot_tiles_per_it(VARIANT, nz, m);
  const int n_tiles = per_it * a.n_it;
  const int K_rows = VARIANT == kMatvec ? m : nz;  // rows of an nn tile's W
  const int ldw = VARIANT == kMatvec ? nz : 7 * nz;
  int4* tab = reinterpret_cast<int4*>(smem + L.tab);
  for (int r = tid; r < per_it; r += kThreads)
    tab[r] = pack_tile(slot_tile(VARIANT, r, nz, m));
  __syncthreads();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  ring_init<kSlotStages>(bars, a.tma);
  const int nnw = nn_width(nz);
  int rc = 0;  // the next copied tile's place in its iteration
  auto copy = [&](float* dst, uint64_t* bar) {
    const SlotTile s = unpack_tile(tab[rc]);
    rc = rc + 1 == per_it ? 0 : rc + 1;
    if (s.nt)  // one sub-tile: rows n0 .., columns k0 .. k0 + 31
      stage_boxes(dst, a.tma ? &a.nt_map : nullptr, a.mat, ldw, m, s.n0, kNb,
                  s.k0, 1, bar);
    else if (PREC == kHighest)  // rows k0 .. k0 + 31, the n-block, dense
      stage_dense(dst, a.tma ? &a.nn_map : nullptr, a.mat, ldw, K_rows, s.k0,
                  kKc, s.n0, nnw, bar);
    else  // the same in swizzled sub-tiles of 32 columns (read by columns)
      stage_boxes(dst, a.tma ? &a.nn_map : nullptr, a.mat, ldw, K_rows, s.k0,
                  kKc, s.n0, cdiv(s.nn, 32), bar);
  };
  ring_start<kSlotStages, kSlotStage>(n_tiles, ring, bars, copy);
  int r = 0;  // the consumed tile's place in its iteration

  if constexpr (PREC == kHighest) {
    // CUDA cores: thread (g, q) holds columns (4 of the n-block) x kSlots,
    // over the k-quads g, g + G, ... of each tile; the G groups' partial
    // sums meet in `part` at the end of the n-block.
    float* part = smem + L.part;
    int c_nn = -1, nq = 1, G = 1, g = 0, q = 0;  // the thread's role, by nn
    float acc[4][kSlots];
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const float* T =
          ring_step<kSlotStages, kSlotStage>(t, n_tiles, ring, bars, copy);
      const SlotTile s = unpack_tile(tab[r]);
      r = r + 1 == per_it ? 0 : r + 1;
      const float* A = smem + (s.phase == 0 ? L.xs : L.ys);
      const int lda = s.phase == 0 ? L.ldx : L.ldy;
      if (s.nn != c_nn) {
        c_nn = s.nn;
        nq = cdiv(s.nn, 4);
        G = kThreads / nq;
        g = tid / nq;
        q = tid - g * nq;
      }
      if (s.first) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl) acc[r][sl] = 0.f;
      }
      if (g < G) {
        for (int kq = g; kq < kKc / 4; kq += G) {
          const int kk = 4 * kq;
          float4 av[kSlots];
#pragma unroll
          for (int sl = 0; sl < kSlots; ++sl)
            av[sl] = *reinterpret_cast<const float4*>(A + sl * lda + s.k0 + kk);
          if (s.nt) {
            // columns q, q + nq, q + 2 nq, q + 3 nq; T[n][k]
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float4 w =
                  *reinterpret_cast<const float4*>(T + sw(q + r * nq, kk));
#pragma unroll
              for (int sl = 0; sl < kSlots; ++sl) {
                float v = acc[r][sl];
                v = fmaf(av[sl].x, w.x, v);
                v = fmaf(av[sl].y, w.y, v);
                v = fmaf(av[sl].z, w.z, v);
                v = fmaf(av[sl].w, w.w, v);
                acc[r][sl] = v;
              }
            }
          } else {
            // columns 4q .. 4q + 3; T[k][n]
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 w =
                  *reinterpret_cast<const float4*>(T + (kk + i) * nnw + 4 * q);
#pragma unroll
              for (int sl = 0; sl < kSlots; ++sl) {
                const float xv = i == 0 ? av[sl].x
                                 : i == 1 ? av[sl].y
                                 : i == 2 ? av[sl].z
                                          : av[sl].w;
                acc[0][sl] = fmaf(xv, w.x, acc[0][sl]);
                acc[1][sl] = fmaf(xv, w.y, acc[1][sl]);
                acc[2][sl] = fmaf(xv, w.z, acc[2][sl]);
                acc[3][sl] = fmaf(xv, w.w, acc[3][sl]);
              }
            }
          }
        }
      }
      if (s.last) {
        const int nbp = 4 * nq;
        if (g < G) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int n = s.nt ? q + r * nq : 4 * q + r;
#pragma unroll
            for (int sl = 0; sl < kSlots; ++sl)
              part[(g * kSlots + sl) * nbp + n] = acc[r][sl];
          }
        }
        __syncthreads();
        for (int e = tid; e < kSlots * s.nn; e += kThreads) {
          const int sl = e / s.nn, n = e - sl * s.nn;
          float v = part[sl * nbp + n];
          for (int gg = 1; gg < G; ++gg) v += part[(gg * kSlots + sl) * nbp + n];
          slot_emit<VARIANT>(s, L, smem, nz, sl, n, v);
        }
        __syncthreads();
      }
    }
  } else {
    // Tensor cores: warp w owns the 16-column slices w and w + 8 of the
    // n-block; the kSlots problems are the n8 side of m16n8k16.
    uint2* bh = reinterpret_cast<uint2*>(smem + L.limbs);
    uint2* bl = bh + (max(L.ldx, L.ldy) / 16) * 32;
    const int warp = tid >> 5, lane = tid & 31, lg = lane >> 2, lt = lane & 3;
    float acc[2][4];
#pragma unroll 1
    for (int t = 0; t < n_tiles; ++t) {
      const float* T =
          ring_step<kSlotStages, kSlotStage>(t, n_tiles, ring, bars, copy);
      const SlotTile s = unpack_tile(tab[r]);
      r = r + 1 == per_it ? 0 : r + 1;
      if (s.phase_start) {
        // the phase's operand (x or y) as fragment-ordered bf16 limbs
        const float* A = smem + (s.phase == 0 ? L.xs : L.ys);
        const int lda = s.phase == 0 ? L.ldx : L.ldy;
        for (int e = tid; e < (lda / 16) * 32; e += kThreads) {
          const int ks = e >> 5, g = (e & 31) >> 2, tq = e & 3;
          const float* r = A + g * lda + ks * 16 + 2 * tq;
          uint2 h, l;
          limbs2<PREC>(r[0], r[1], h.x, l.x);
          limbs2<PREC>(r[8], r[9], h.y, l.y);
          bh[e] = h;
          if (PREC == kHigh) bl[e] = l;
        }
        __syncthreads();
      }
      const int mtiles = cdiv(s.nn, 16);
      if (s.first) {
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kKc / 16; ++ks) {
        const int e = (s.k0 / 16 + ks) * 32 + lane;
        const uint2 bhv = bh[e];
        const uint2 blv = PREC == kHigh ? bl[e] : bhv;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int mt = warp + 8 * j;
          if (mt >= mtiles) continue;
          uint32_t ah[4], al[4];
          if (s.nt)  // T[n][k]
            a_frag<PREC>([&](int row, int col) { return T[sw(row, col)]; },
                         mt * 16, ks * 16, ah, al);
          else  // T[k][n], sub-tile n / 32
            a_frag<PREC>(
                [&](int row, int col) {
                  return T[(row >> 5) * (kKc * 32) + sw(col, row & 31)];
                },
                mt * 16, ks * 16, ah, al);
          mma_passes<PREC>(acc[j], ah, al, bhv, blv);
        }
      }
      if (s.last) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int mt = warp + 8 * j;
          if (mt >= mtiles) continue;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int n = mt * 16 + lg + ((i >> 1) << 3), sl = 2 * lt + (i & 1);
            if (n < s.nn) slot_emit<VARIANT>(s, L, smem, nz, sl, n, acc[j][i]);
          }
        }
        __syncthreads();
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < ns * nz; e += kThreads) {
    const int sl = e / nz, k = e - sl * nz;
    a.out[static_cast<size_t>(s0) * nz + e] = xs[sl * L.ldx + k];
  }
}

// ---- the per-problem Minv variants: a cluster of 2 holds Minv_p -----------

struct MinvArgs {
  const float* x;    // (B, nz)
  const float* mat;  // Minv (B, nz, nz)
  float* out;        // (B, nz)
  int B, nz, n_it;
};

// Shared memory in floats: the half-matrix, x twice (the cluster's
// exchange is double-buffered), x's limbs (hi, lo), the partial sums.
struct MinvSmem {
  int h, nzp, lds, rows, ms, xs, xh, xl, part, total;
  __host__ __device__ MinvSmem(int op, int nz) {
    h = up(cdiv(nz, 2), 4);
    nzp = up(nz, 4);
    if (op == kLhs) {
      lds = (nzp / 4) % 2 ? nzp : nzp + 4;  // lds / 4 odd: rows hit apart
      rows = h;
    } else {
      lds = h;
      rows = nz;
    }
    ms = 0;
    xs = rows * lds;
    xh = xs + 2 * nzp;
    xl = xh + nzp;
    part = xl + nzp;
    total = part + 2 * kThreads * 4;
  }
};

__device__ __forceinline__ uint32_t pack_limbs(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(v - __bfloat162float(hi));
  return (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16) |
         __bfloat16_as_ushort(lo);
}

__device__ __forceinline__ float word_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float word_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}

// acc += x m in the precision: (xh, xl) are x's limbs, w m's packed word
// (or m itself at highest). The bf16 variant keeps its two sums apart.
template <int OP, int PREC>
__device__ __forceinline__ void minv_mac(float& acc, float& acc2, float x,
                                         float xh, float xl, float w) {
  if (OP == kBf16) {
    const uint32_t u = __float_as_uint(w);
    acc = fmaf(xh, word_hi(u), acc);
    acc2 = fmaf(xh, word_lo(u), acc2);
  } else if (PREC == kHighest) {
    acc = fmaf(x, w, acc);
  } else if (PREC == kDefault) {
    acc = fmaf(xh, word_hi(__float_as_uint(w)), acc);
  } else {
    const uint32_t u = __float_as_uint(w);
    acc = fmaf(xh, word_hi(u), acc);
    acc = fmaf(xh, word_lo(u), acc);
    acc = fmaf(xl, word_hi(u), acc);
  }
}

template <int OP, int PREC>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
    minv_kernel(MinvArgs a) {
  extern __shared__ __align__(1024) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const MinvSmem L(OP, a.nz);
  const int tid = threadIdx.x, nz = a.nz;
  const int p = blockIdx.x / 2, rank = static_cast<int>(cluster.block_rank());
  const int lo0 = rank * L.h, own = max(0, min(L.h, nz - lo0));
  const float* M = a.mat + static_cast<size_t>(p) * nz * nz;
  const float* xp = a.x + static_cast<size_t>(p) * nz;
  float* outp = a.out + static_cast<size_t>(p) * nz;
  if (a.n_it == 0) {
    if (rank == 0)
      for (int j = tid; j < nz; j += kThreads) outp[j] = xp[j];
    return;
  }
  float* Ms = smem + L.ms;
  float* xs = smem + L.xs;
  float* xh = smem + L.xh;
  float* xl = smem + L.xl;
  float* part = smem + L.part;
  // the half-matrix, read from HBM once
  if (OP == kLhs)
    copy_tile(Ms, L.lds, M, nz, nz, lo0, L.h, 0, L.nzp);
  else
    copy_tile(Ms, L.lds, M, nz, nz, 0, nz, lo0, L.h);
  cp_commit();
  for (int j = tid; j < 2 * L.nzp; j += kThreads)
    xs[j] = j < nz ? xp[j] : 0.f;
  cp_wait<0>();
  __syncthreads();
  constexpr bool kLimbs = OP == kBf16 || PREC != kHighest;
  if (kLimbs)
    for (int e = tid; e < L.rows * L.lds; e += kThreads)
      Ms[e] = __uint_as_float(pack_limbs(Ms[e]));
  cluster.sync();  // the partner's shared memory is live before it is written

  int cur = 0;
#pragma unroll 1
  for (int it = 0; it < a.n_it; ++it) {
    const float* xc = xs + cur * L.nzp;
    if (kLimbs) {
      for (int j = tid; j < L.nzp; j += kThreads) {
        const float hi = bf16_round(xc[j]);
        xh[j] = hi;
        xl[j] = bf16_round(xc[j] - hi);
      }
    }
    __syncthreads();
    float v_own = 0.f;
    int idx = -1;  // the index of x this thread's reduction produces
    if (OP == kLhs) {
      // thread (u, r): row r of the block's rows, column quads of part u
      const int nq = L.nzp / 4, U = kThreads / L.h;
      const int u = tid / L.h, r = tid - u * L.h;
      const int ch = cdiv(nq, U);
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, unused = 0.f;
      if (u < U) {
        const int q1 = min(nq, (u + 1) * ch);
        for (int jq = u * ch; jq < q1; ++jq) {
          const float4 w = *reinterpret_cast<const float4*>(Ms + r * L.lds +
                                                            4 * jq);
          const float4 x4 = *reinterpret_cast<const float4*>(xc + 4 * jq);
          const float4 h4 = *reinterpret_cast<const float4*>(xh + 4 * jq);
          const float4 l4 = *reinterpret_cast<const float4*>(xl + 4 * jq);
          minv_mac<OP, PREC>(acc[0], unused, x4.x, h4.x, l4.x, w.x);
          minv_mac<OP, PREC>(acc[1], unused, x4.y, h4.y, l4.y, w.y);
          minv_mac<OP, PREC>(acc[2], unused, x4.z, h4.z, l4.z, w.z);
          minv_mac<OP, PREC>(acc[3], unused, x4.w, h4.w, l4.w, w.w);
        }
        part[u * L.h + r] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      __syncthreads();
      if (tid < own) {
        float v = part[tid];
        for (int uu = 1; uu < U; ++uu) v += part[uu * L.h + tid];
        v_own = v;
        idx = lo0 + tid;
      }
    } else {
      // thread (g, q): columns 4q .. 4q + 3 of the block's half, rows of
      // chunk g
      const int nq = L.h / 4, G = kThreads / nq;
      const int g = tid / nq, q = tid - g * nq;
      const int ch = cdiv(nz, G);
      float acc[4] = {0.f, 0.f, 0.f, 0.f}, acc2[4] = {0.f, 0.f, 0.f, 0.f};
      if (g < G) {
        const int i1 = min(nz, (g + 1) * ch);
        for (int i = g * ch; i < i1; ++i) {
          const float4 w = *reinterpret_cast<const float4*>(Ms + i * L.lds +
                                                            4 * q);
          const float xv = xc[i], hv = xh[i], lv = xl[i];
          minv_mac<OP, PREC>(acc[0], acc2[0], xv, hv, lv, w.x);
          minv_mac<OP, PREC>(acc[1], acc2[1], xv, hv, lv, w.y);
          minv_mac<OP, PREC>(acc[2], acc2[2], xv, hv, lv, w.z);
          minv_mac<OP, PREC>(acc[3], acc2[3], xv, hv, lv, w.w);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          part[g * L.h + 4 * q + c] = acc[c];
          if (OP == kBf16) part[(G + g) * L.h + 4 * q + c] = acc2[c];
        }
      }
      __syncthreads();
      if (tid < own) {
        float v = part[tid];
        for (int gg = 1; gg < G; ++gg) v += part[gg * L.h + tid];
        if (OP == kBf16) {
          float v2 = part[G * L.h + tid];
          for (int gg = 1; gg < G; ++gg) v2 += part[(G + gg) * L.h + tid];
          v = v + v2;
        }
        v_own = v;
        idx = lo0 + tid;
      }
    }
    const int nxt = cur ^ 1;
    if (idx >= 0) {
      if (it + 1 == a.n_it) {
        outp[idx] = v_own;
      } else {
        xs[nxt * L.nzp + idx] = v_own;
        cluster.map_shared_rank(xs, rank ^ 1)[nxt * L.nzp + idx] = v_own;
      }
    }
    cluster.sync();
    cur = nxt;
  }
}

// ---- minv_blockdiag: a cluster of 8 per tile of bt problems ---------------

// acc[r][c] += xe_r w_c for one k of a run, where xe_r is x_k for the
// thread's row RS (4: none of its rows is this run's block) and zero for the
// others: the masked MACs are executed, as the TPU's expanded product
// executes them (`zero` is opaque to the compiler, so none is dropped).
template <int RS>
__device__ __forceinline__ void bd_fma(float (&acc)[4][4], float xv, float4 w,
                                       float zero) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float xe = r == RS ? xv : zero;
    acc[r][0] = fmaf(xe, w.x, acc[r][0]);
    acc[r][1] = fmaf(xe, w.y, acc[r][1]);
    acc[r][2] = fmaf(xe, w.z, acc[r][2]);
    acc[r][3] = fmaf(xe, w.w, acc[r][3]);
  }
}

// The k in [k, kend) of one run (one block kb of the expanded x): T holds
// mflat's rows from k0 on, the thread's 4 columns at 4q.
template <int RS>
__device__ __forceinline__ void bd_run(float (&acc)[4][4], const float* xs,
                                       const float* T, int sld, int k,
                                       int kend, float zero) {
  for (; k < kend && (k & 3); ++k)
    bd_fma<RS>(acc, xs[k], *reinterpret_cast<const float4*>(T + k * sld),
               zero);
  for (; k + 4 <= kend; k += 4) {
    const float4 xv = *reinterpret_cast<const float4*>(xs + k);
    const float* Tk = T + k * sld;
    const float4 w0 = *reinterpret_cast<const float4*>(Tk);
    const float4 w1 = *reinterpret_cast<const float4*>(Tk + sld);
    const float4 w2 = *reinterpret_cast<const float4*>(Tk + 2 * sld);
    const float4 w3 = *reinterpret_cast<const float4*>(Tk + 3 * sld);
    bd_fma<RS>(acc, xv.x, w0, zero);
    bd_fma<RS>(acc, xv.y, w1, zero);
    bd_fma<RS>(acc, xv.z, w2, zero);
    bd_fma<RS>(acc, xv.w, w3, zero);
  }
  for (; k < kend; ++k)
    bd_fma<RS>(acc, xs[k], *reinterpret_cast<const float4*>(T + k * sld),
               zero);
}

struct BdArgs {
  const float* x;    // (B, nz)
  const float* mat;  // mflat (B / bt, bt nz, nz)
  float* out;        // (B, nz)
  int B, bt, nz, n_it;
};

// A block's share of a tile at nz <= 256: at most 32 columns.
template <int PREC>
__host__ __device__ constexpr int bd_stage() {
  return PREC == kHighest ? kBdKc * 32 : kBdKc * 36;
}

// Shared memory in floats: the ring, the tile's x (bt, nz), the CUDA-core
// kernel's partial sums, or the tensor-core kernel's B fragments of a tile
// (a uint4 of limbs per n-tile, k-step and lane) and, at the end of an
// iteration, its warps' partial tiles; the ring's mbarriers. Under 76 KB,
// so that 3 blocks fit an SM and the card holds all 32 clusters of the
// flagship at once (at 2 an SM it holds 30).
struct BdSmem {
  int xs, part, bars, total;
  __host__ __device__ BdSmem(int prec, int bt, int nz) {
    xs = kBdStages * (prec == kHighest ? bd_stage<kHighest>()
                                       : bd_stage<kHigh>());
    part = xs + up(bt * nz, 4);
    bars = part + (prec == kHighest ? 32 * 32 * 4 : 2048);
    total = bars + 2 * kBdStages;
  }
};

template <int PREC>
__global__ void __cluster_dims__(kBdCluster, 1, 1) __launch_bounds__(kThreads, 3)
    blockdiag_kernel(BdArgs a) {
  extern __shared__ __align__(1024) float smem[];
  constexpr int kStage = bd_stage<PREC>();
  cg::cluster_group cluster = cg::this_cluster();
  const BdSmem L(PREC, a.bt, a.nz);
  const int tid = threadIdx.x, nz = a.nz, bt = a.bt, K = bt * nz;
  const int tile = blockIdx.x / kBdCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int cpb = cdiv(nz, kBdCluster), c0 = rank * cpb;
  const int nc = max(0, min(cpb, nz - c0));
  const size_t xo = static_cast<size_t>(tile) * K;
  const float* mf = a.mat + xo * nz;  // (bt nz, nz) of this tile
  if (a.n_it == 0) {
    if (rank == 0)
      for (int e = tid; e < K; e += kThreads) a.out[xo + e] = a.x[xo + e];
    return;
  }
  float* ring = smem;
  float* xs = smem + L.xs;
  for (int e = tid; e < K; e += kThreads) xs[e] = a.x[xo + e];
  const int sld = PREC == kHighest ? up(cpb, 4) : up(cpb, 16) + 4;
  const int wc = PREC == kHighest ? up(cpb, 4) : up(cpb, 16);
  const int kt = cdiv(K, kBdKc), n_tiles = kt * a.n_it;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);
  ring_init<kBdStages>(bars, false);
  int cr = 0;  // the next copied tile's place in its iteration
  auto copy = [&](float* dst, uint64_t* bar) {
    stage_rows(dst, sld, mf, nz, K, cr * kBdKc, kBdKc, c0, wc, bar);
    cr = cr + 1 == kt ? 0 : cr + 1;
  };
  ring_start<kBdStages, kStage>(n_tiles, ring, bars, copy);
  cluster.sync();  // every block's x is in place before any is written

  // the new iterate's element (p, c0 + c) goes to every block of the
  // cluster, or to out after the last iteration
  auto emit = [&](bool last, int p, int c, float v) {
    if (last) {
      a.out[xo + p * nz + c0 + c] = v;
    } else {
      for (int rr = 0; rr < kBdCluster; ++rr)
        cluster.map_shared_rank(xs, rr)[p * nz + c0 + c] = v;
    }
  };

  if constexpr (PREC == kHighest) {
    // thread (g, pg, q): rows pg, pg + 8, pg + 16, pg + 24, columns
    // 4q .. 4q + 3, over chunk g of each tile's rows
    float* part = smem + L.part;
    const int nq = wc / 4, G = kThreads / (8 * nq);
    const int g = tid / (8 * nq), pg = (tid / nq) % 8, q = tid % nq;
    const int ch = up(cdiv(kBdKc, G), 4);
    float zero;
    asm("mov.f32 %0, 0f00000000;" : "=f"(zero));
    float acc[4][4];
#pragma unroll 1
    for (int t = 0, ti = 0; t < n_tiles; ++t, ti = ti + 1 == kt ? 0 : ti + 1) {
      const float* T =
          ring_step<kBdStages, kStage>(t, n_tiles, ring, bars, copy);
      const int k0 = ti * kBdKc;
      if (ti == 0) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = 0.f;
      }
      if (g < G) {
        int k = k0 + g * ch;
        const int kend = min(K, k0 + min((g + 1) * ch, kBdKc));
        const float* Tq = T - k0 * sld + 4 * q;  // row k of mflat at Tq + k sld
        while (k < kend) {
          const int kb = k / nz, run = min(kend, (kb + 1) * nz);
          const int d = kb - pg;  // the thread's row in block kb, if any
          const int rs = d >= 0 && d < 32 && (d & 7) == 0 ? d >> 3 : 4;
          switch (rs) {
            case 0: bd_run<0>(acc, xs, Tq, sld, k, run, zero); break;
            case 1: bd_run<1>(acc, xs, Tq, sld, k, run, zero); break;
            case 2: bd_run<2>(acc, xs, Tq, sld, k, run, zero); break;
            case 3: bd_run<3>(acc, xs, Tq, sld, k, run, zero); break;
            default: bd_run<4>(acc, xs, Tq, sld, k, run, zero); break;
          }
          k = run;
        }
      }
      if (ti == kt - 1) {
        const bool last = t + 1 == n_tiles;
        if (g < G) {
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int p = pg + 8 * r;
            if (p < bt)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                part[(g * bt + p) * wc + 4 * q + c] = acc[r][c];
          }
        }
        cluster.sync();  // partials in place; every block is done with x
        for (int e = tid; e < bt * nc; e += kThreads) {
          const int p = e / nc, c = e - p * nc;
          float v = part[p * wc + c];
          for (int gg = 1; gg < G; ++gg) v += part[(gg * bt + p) * wc + c];
          emit(last, p, c, v);
        }
        cluster.sync();
      }
    }
  } else {
    // warp (ks, mt) takes k-step ks of every tile for the 16-column slice
    // mt and all (8-row) n-tiles: each A fragment is converted once and
    // serves every n-tile. The expanded x's B fragments of a tile (masked
    // per n-tile, as limbs) are formed once by the block, a thread an
    // entry; the 4 k-step warps' partial tiles meet in the same shared
    // memory at the end of an iteration.
    static_assert(kBdSteps * 2 == kThreads / 32, "a warp a (k-step, slice)");
    uint4* bfrag = reinterpret_cast<uint4*>(smem + L.part);
    float* red = smem + L.part;  // (2 k-step pairs, 2 slices, 4 x 4 x 32)
    const int warp = tid >> 5, lane = tid & 31, lt = lane & 3;
    const int lg = lane >> 2, ks = warp & 3, mt = warp >> 2;
    const int mtiles = cdiv(cpb, 16), ntiles = cdiv(bt, 8);
    float acc[4][4];
#pragma unroll 1
    for (int t = 0, ti = 0; t < n_tiles; ++t, ti = ti + 1 == kt ? 0 : ti + 1) {
      const float* T =
          ring_step<kBdStages, kStage>(t, n_tiles, ring, bars, copy);
      const int k0 = ti * kBdKc;
      if (ti == 0)
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
      if (tid < kBdSteps * 32) {
        // entry (k-step warp, lane) of every n-tile
        float xv[4];
        int kb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + warp * 16 + 2 * lt + (i & 1) + ((i >> 1) << 3);
          xv[i] = k < K ? xs[k] : 0.f;
          kb[i] = k < K ? k / nz : -1;
        }
        for (int n = 0; n < ntiles; ++n) {
          const int prow = n * 8 + lg;
          float xe[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) xe[i] = kb[i] == prow ? xv[i] : 0.f;
          uint4 f;
          limbs2<PREC>(xe[0], xe[1], f.x, f.z);
          limbs2<PREC>(xe[2], xe[3], f.y, f.w);
          bfrag[(n * kBdSteps + warp) * 32 + lane] = f;
        }
      }
      __syncthreads();
      if (mt < mtiles && k0 + ks * 16 < K) {
        uint32_t ah[4], al[4];
        a_frag<PREC>([&](int row, int col) { return T[col * sld + row]; },
                     mt * 16, ks * 16, ah, al);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          if (n >= ntiles) break;
          const uint4 f = bfrag[(n * kBdSteps + ks) * 32 + lane];
          mma_passes<PREC>(acc[n], ah, al, make_uint2(f.x, f.y),
                           make_uint2(f.z, f.w));
        }
      }
      if (ti == kt - 1) {
        const bool last = t + 1 == n_tiles;
        // k-steps 2, 3 into red, k-steps 0, 1 add theirs; each element is
        // then the sum of its slice's 2 slots
        __syncthreads();  // every warp is done with bfrag
        float* mine = red + ((ks & 1) * 2 + mt) * 512 + lane;
        if (ks >= 2)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) mine[(n * 4 + i) * 32] = acc[n][i];
        __syncthreads();
        if (ks < 2)
#pragma unroll
          for (int n = 0; n < 4; ++n)
#pragma unroll
            for (int i = 0; i < 4; ++i) mine[(n * 4 + i) * 32] += acc[n][i];
        cluster.sync();  // partials in place; every block is done with x
        for (int e = tid; e < 1024; e += kThreads) {
          const int l = e & 31, i = (e >> 5) & 3, n = (e >> 7) & 3,
                    m2 = e >> 9;
          const int c = m2 * 16 + (l >> 2) + ((i >> 1) << 3);
          const int p = n * 8 + 2 * (l & 3) + (i & 1);
          if (c < nc && p < bt)
            emit(last, p, c,
                 red[m2 * 512 + (e & 511)] + red[(2 + m2) * 512 + (e & 511)]);
        }
        cluster.sync();
      }
    }
  }
}

// ---- host ------------------------------------------------------------------

using EncodeTiled = PFN_cuTensorMapEncodeTiled_v12000;

bool make_map(CUtensorMap* map, const float* W, int rows, int cols,
              int box_cols, int box_rows, bool swizzle);

// The slot kernels' "nn" tiles: dense rows for the CUDA cores, which read
// them by rows; swizzled 32-column sub-tiles for the tensor cores, which
// read them by columns.
bool make_nn_map(CUtensorMap* map, const float* W, int rows, int cols,
                 int nz, int prec) {
  return prec == kHighest
             ? make_map(map, W, rows, cols, nn_width(nz), kKc, false)
             : make_map(map, W, rows, cols, 32, kKc, true);
}

// cuTensorMapEncodeTiled, from the driver through the runtime (the library
// links no libcuda); null where the driver has none.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  static bool looked = false;
  if (!looked) {
    looked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
    else
      cudaGetLastError();
  }
  return fn;
}

// A tensor map of the row-major fp32 (rows, cols) matrix W, read in boxes of
// box_cols x box_rows, with the 128-byte swizzle (box_cols 32) or none.
// False where it cannot be made (no encoder; rows not 16-byte multiples; W
// smaller than a box): the kernels then stage with cp.async.
bool make_map(CUtensorMap* map, const float* W, int rows, int cols,
              int box_cols, int box_rows, bool swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || cols % 4 != 0 || cols < box_cols || rows < box_rows ||
      (reinterpret_cast<uintptr_t>(W) & 15) != 0)
    return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) *
                                 sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(W),
            dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's dynamic shared memory, with the largest carveout (the
// kernels stage global memory in shared memory, not L1), so that as many
// blocks fit an SM as the shared memory allows.
template <typename Kern>
cudaError_t prepare(Kern kernel, int smem_floats, size_t* smem) {
  *smem = sizeof(float) * static_cast<size_t>(smem_floats);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
}

template <typename Kern, typename Args>
int launch(Kern kernel, int blocks, int smem_floats, const Args& a,
           void* stream) {
  size_t smem;
  const cudaError_t e = prepare(kernel, smem_floats, &smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// How many groups of the kernel (blocks, or clusters of `cluster` blocks)
// the card holds at once.
template <typename Kern>
int capacity(Kern kernel, int smem_floats, int cluster, int* out) {
  size_t smem;
  cudaError_t e = prepare(kernel, smem_floats, &smem);
  if (e == cudaSuccess && cluster == 1) {
    int dev = 0, sms = 0, per_sm = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    *out = sms * per_sm;
  } else if (e == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(out, kernel, &cfg);
  }
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

template <int VARIANT>
int run_slot(int prec, const SlotArgs& a, void* stream) {
  const int blocks = cdiv(a.B, kSlots);
  const int smem = SlotSmem(VARIANT, prec, a.nz, a.m).total;
  switch (prec) {
    case kHighest:
      return launch(slot_kernel<VARIANT, kHighest>, blocks, smem, a, stream);
    case kHigh:
      return launch(slot_kernel<VARIANT, kHigh>, blocks, smem, a, stream);
    case kDefault:
      return launch(slot_kernel<VARIANT, kDefault>, blocks, smem, a, stream);
  }
  return -1;
}

template <int OP>
int run_minv(int prec, const MinvArgs& a, void* stream) {
  const int smem = MinvSmem(OP, a.nz).total;
  if constexpr (OP == kBf16) {
    return launch(minv_kernel<kBf16, kHighest>, 2 * a.B, smem, a, stream);
  } else {
    switch (prec) {
      case kHighest:
        return launch(minv_kernel<OP, kHighest>, 2 * a.B, smem, a, stream);
      case kHigh:
        return launch(minv_kernel<OP, kHigh>, 2 * a.B, smem, a, stream);
      case kDefault:
        return launch(minv_kernel<OP, kDefault>, 2 * a.B, smem, a, stream);
    }
    return -1;
  }
}

int run_blockdiag(int prec, const BdArgs& a, void* stream) {
  const int blocks = (a.B / a.bt) * kBdCluster;
  const int smem = BdSmem(prec, a.bt, a.nz).total;
  switch (prec) {
    case kHighest:
      return launch(blockdiag_kernel<kHighest>, blocks, smem, a, stream);
    case kHigh:
      return launch(blockdiag_kernel<kHigh>, blocks, smem, a, stream);
    case kDefault:
      return launch(blockdiag_kernel<kDefault>, blocks, smem, a, stream);
  }
  return -1;
}

}  // namespace

// ---- host launch: plain C interface, loaded with ctypes ------------------
// probe_capacity: how many of the variant's groups (a block of kSlots
// problems; a cluster of 2 blocks per problem; a cluster of 8 blocks per
// tile) the card holds at once at these shapes, in *groups; a cudaError_t.
extern "C" int probe_capacity(int variant, int precision, int bt, int nz,
                              int m, int* groups) {
  if (precision < kHighest || precision > kDefault) return -1;
  switch (variant) {
    case kMatvec: {
      const int f = SlotSmem(kMatvec, precision, nz, m).total;
      return precision == kHighest
                 ? capacity(slot_kernel<kMatvec, kHighest>, f, 1, groups)
             : precision == kHigh
                 ? capacity(slot_kernel<kMatvec, kHigh>, f, 1, groups)
                 : capacity(slot_kernel<kMatvec, kDefault>, f, 1, groups);
    }
    case kStack7: {
      const int f = SlotSmem(kStack7, precision, nz, m).total;
      return precision == kHighest
                 ? capacity(slot_kernel<kStack7, kHighest>, f, 1, groups)
             : precision == kHigh
                 ? capacity(slot_kernel<kStack7, kHigh>, f, 1, groups)
                 : capacity(slot_kernel<kStack7, kDefault>, f, 1, groups);
    }
    case kRowvec:
    case kLhs:
    case kBf16: {
      const int f = MinvSmem(variant, nz).total;
      if (variant == kBf16)
        return capacity(minv_kernel<kBf16, kHighest>, f, 2, groups);
      if (variant == kRowvec)
        return precision == kHighest
                   ? capacity(minv_kernel<kRowvec, kHighest>, f, 2, groups)
               : precision == kHigh
                   ? capacity(minv_kernel<kRowvec, kHigh>, f, 2, groups)
                   : capacity(minv_kernel<kRowvec, kDefault>, f, 2, groups);
      return precision == kHighest
                 ? capacity(minv_kernel<kLhs, kHighest>, f, 2, groups)
             : precision == kHigh
                 ? capacity(minv_kernel<kLhs, kHigh>, f, 2, groups)
                 : capacity(minv_kernel<kLhs, kDefault>, f, 2, groups);
    }
    case kBlockdiag: {
      const int f = BdSmem(precision, bt, nz).total;
      return precision == kHighest
                 ? capacity(blockdiag_kernel<kHighest>, f, kBdCluster, groups)
             : precision == kHigh
                 ? capacity(blockdiag_kernel<kHigh>, f, kBdCluster, groups)
                 : capacity(blockdiag_kernel<kDefault>, f, kBdCluster, groups);
    }
    default:
      return -1;
  }
}

// variant: 0 matvec_pair, 1 minv_rowvec, 2 minv_lhs, 3 minv_bf16,
// 4 minv_blockdiag, 5 stack7; precision: 0 highest, 1 high, 2 default.
// Returns a cudaError_t (0 on success); -1 for an unknown variant or
// precision.
extern "C" int probe_run(int variant, int precision, const void* x,
                         const void* mat, void* out, int B, int bt, int nz,
                         int m, int n_it, void* stream) {
  if (precision < kHighest || precision > kDefault) return -1;
  if (B == 0) return 0;
  const float* xf = static_cast<const float*>(x);
  const float* mf = static_cast<const float*>(mat);
  float* of = static_cast<float*>(out);
  switch (variant) {
    case kMatvec:
    case kStack7: {
      SlotArgs a{};
      a.x = xf;
      a.mat = mf;
      a.out = of;
      a.B = B;
      a.nz = nz;
      a.m = m;
      a.n_it = n_it;
      if (variant == kMatvec) {
        a.tma = make_map(&a.nt_map, mf, m, nz, 32, kNb, true) &&
                make_nn_map(&a.nn_map, mf, m, nz, nz, precision);
        return run_slot<kMatvec>(precision, a, stream);
      }
      a.tma = make_nn_map(&a.nn_map, mf, nz, 7 * nz, nz, precision);
      return run_slot<kStack7>(precision, a, stream);
    }
    case kRowvec:
    case kLhs:
    case kBf16: {
      const MinvArgs a{xf, mf, of, B, nz, n_it};
      if (variant == kRowvec) return run_minv<kRowvec>(precision, a, stream);
      if (variant == kLhs) return run_minv<kLhs>(precision, a, stream);
      return run_minv<kBf16>(precision, a, stream);
    }
    case kBlockdiag: {
      const BdArgs a{xf, mf, of, B, bt, nz, n_it};
      return run_blockdiag(precision, a, stream);
    }
    default:
      return -1;
  }
}
