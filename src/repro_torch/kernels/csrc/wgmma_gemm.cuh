// The bf16 GEMM body for Hopper: TMA + mbarrier ring, wgmma on the tensor
// cores, with one weight (NW = 1) or two (NW = 2) against one x:
//
//   out[m, n] = epi(m, n, {sum_k x[m, k] * w0[k, n], sum_k x[m, k] * w1[k, n]})
//
// x [M, K] and w0 / w1 [K, N] row-major bf16, each sum in f32, epi on the
// f32 sums.  NW = 1: dense_matmul.cu (depth 1) and dense_matmul_pipelined.cu
// (depth 2 / 3) run it for the bf16 launches TMA can address (at decode,
// a few rows and TMA's zero fill past M, the k / v projections), epi RowEpilogue
// (epilogue.cuh: bias, activation, step program, one rounding store).
// NW = 2: fused_ffn.cu runs it for every bf16 ffn_gateup launch TMA can
// address, epi its GateUpEpilogue (act(gate) * up, one rounding store).
// bsr_matmul.cu runs it (NW = 1) on block-sparse weights: a K walk
// (BsrWalk, below) replaces the dense one (DenseWalk), so the packed blocks
// stream through the same ring.  The mma.sync body of mma_gemm.cuh keeps
// every other bf16 launch of the dense GEMMs and ffn_gateup (odd K or N,
// unaligned pointers), and flash attention keeps its own body.
//
// What bounds it on an H100: the decoders' prefill projections (M = 48, K
// and N 256..11008) and their gate/up at prefill and decode (M = 48 or a
// few rows) read ~2 bytes of weight a multiply-add pair or more, >= 150x
// below the card's bf16 ridge, so the weights' bytes over HBM bound them;
// at a few MB of weights the launch, the ramp and the epilogue are a large
// share of the time.  The design spreads the weights over every SM and
// keeps the copies in flight, with as little serial work around them as
// possible:
//
// * Grid (M tiles, N tiles, K ranges), a thread block cluster of (1, 1,
//   NS) CTAs: NS = the K ranges of kchunk rows (_build.tma_plan, with two
//   weights _build.ffn_tma_plan: at most MAX_CLUSTER, fixed by the shape,
//   never the tile or depth).
// * Warp specialisation: BM / 64 consumer warpgroups (one m64 row block
//   each) and one producer warp (the last), whose one thread issues every
//   copy.  Tile (BM, BN, BK, DEPTH): BN is wgmma's N (32 or 64), BK the K
//   rows a slab, and the ring holds 2 + 2 * DEPTH slabs as far as
//   RING_BUDGET (110 KB) holds them (at least MIN_STAGES): two CTAs fit an
//   SM, so the clusters of a launch are all resident at once (a 214 KB ring
//   of 13 slots, one CTA an SM, ran 1.8x slower: its clusters did not all
//   fit).  With two weights a 64 x 64 x 64 slot is 24 KB: 4 slots.
// * Copies: cp.async.bulk.tensor (TMA) from tensor maps the entry point
//   encodes (cuTensorMapEncodeTiled, reached through
//   cudaGetDriverEntryPoint: no -lcuda), passed as __grid_constant__
//   CUtensorMap (x, w0, w1; NW = 1 passes w0's map twice and never reads
//   the third).  A slot holds one x box and one box of each weight; its
//   full barrier counts all of the slot's bytes; the consumers release a
//   slot through its empty barrier.  Rows past M and
//   K rows past K come in as zeros (TMA's out-of-bounds fill), so ragged
//   edges need no masking.  Each N tile loads its own x slabs: sharing
//   them across the N tiles of a cluster by TMA multicast measured 1.7-5.5x
//   slower at the served shapes (PERF.md, Findings).
// * Swizzled slots: x K-major (128-byte swizzle for 64-deep boxes, 64-byte
//   for BK = 32; BK = 128 is two 64-deep boxes), w N-major (128-byte
//   swizzle at BN = 64, 64-byte at BN = 32), read by shared-memory
//   descriptors, w with wgmma's transpose flag: no ldmatrix, no register
//   staging.  Slots are 1024-byte aligned, as the swizzle atoms need.
// * Math: per k16 step one wgmma.mma_async.m64nBNk16.f32.bf16.bf16 per
//   warpgroup and weight, every weight's on the same x descriptor (x is
//   read from shared memory once for both products), into NW accumulators;
//   a slab's steps committed as one group; the slot of the previous slab
//   is released once its group has retired (wait_group 1).
// * K split: each CTA's NW f32 partial tiles go to its own shared memory
//   (over the drained ring); after one cluster barrier CTA `z` of the
//   cluster sums its share of the tiles' rows over the NS ranges through
//   distributed shared memory, in split order, and runs the epilogue on
//   the NW sums.  No workspace, no counters, no second pass.  One range
//   launches no cluster: a CTA barrier, its own partial tiles, the same
//   sums.
// * K walks (DenseWalk, BsrWalk): which x columns and weight rows each
//   slab reads, how many slabs a CTA has (the same in every warp), and
//   what a CTA stages in shared memory before the loop (BsrWalk: its steps
//   of block_rows, pads dropped when the producer walks them).
//
// Same result for every tile and depth: the K ranges are whole multiples of
// SPLIT_ALIGN (128) rows, which every BK divides, so every output sums the same k16 steps
// (absolute k = kb + 16 i, i ascending; steps past K multiply TMA's zero
// fill, adding exact zeros) from +0 into one f32 accumulator, and the
// ranges are added in split order; the tile changes only which CTA and
// warpgroup does it.  So every tile and depth is bit-equal for a shape.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace wgmma_gemm {

namespace cg = cooperative_groups;
using bf16 = __nv_bfloat16;

// The limits come from _build.WGMMA_LIMITS (nvcc -DREPRO_WGMMA_...), the
// one copy the wrappers' plan and the CPU tests read too.
#if !defined(REPRO_WGMMA_MAX_CLUSTER) || !defined(REPRO_WGMMA_SMEM_LIMIT) || \
    !defined(REPRO_WGMMA_RING_BUDGET) || !defined(REPRO_WGMMA_MIN_STAGES) ||  \
    !defined(REPRO_WGMMA_SPLIT_ALIGN)
#error "build through repro_torch.kernels._build, which defines the REPRO_WGMMA_ limits"
#endif
constexpr int MAX_CLUSTER = REPRO_WGMMA_MAX_CLUSTER;     // CTAs of a cluster: its K ranges
constexpr size_t SMEM_LIMIT = REPRO_WGMMA_SMEM_LIMIT;    // bytes a block can use
constexpr size_t RING_BUDGET = REPRO_WGMMA_RING_BUDGET;  // ring bytes: two CTAs an SM
constexpr int MIN_STAGES = REPRO_WGMMA_MIN_STAGES;       // the fewest ring slots
constexpr int SPLIT_ALIGN = REPRO_WGMMA_SPLIT_ALIGN;     // a K range's multiple of rows
constexpr int PART_PAD = 8;                              // f32 row pad of a partial tile

template <int BM, int BN, int BK, int DEPTH, int NW = 1>
struct Tile {
  static constexpr int WGS = BM / 64;          // consumer warpgroups
  static constexpr int NT = WGS * 128 + 32;    // + the producer warp
  static constexpr int XBOX = BK < 64 ? BK : 64;  // K extent of an x box
  static constexpr int XBOXES = BK / XBOX;       // x boxes a slab
  static constexpr int X_ROW = XBOX * 2;         // bytes: 64 or 128
  static constexpr int W_ROW = BN * 2;           // bytes: 64 or 128
  static constexpr int X_SLOT = BM * BK * 2;
  static constexpr int W_SLOT = BK * BN * 2;
  static constexpr int SLOT = X_SLOT + NW * W_SLOT;  // x, then each weight
  // ring slots: 2 + 2 * DEPTH, as far as RING_BUDGET holds them, but never
  // fewer than MIN_STAGES
  static constexpr int FIT = (int)(RING_BUDGET / SLOT) < 2 + 2 * DEPTH
                                 ? (int)(RING_BUDGET / SLOT) : 2 + 2 * DEPTH;
  static constexpr int STAGES = FIT > MIN_STAGES ? FIT : MIN_STAGES;
  static constexpr int PART_LD = BN + PART_PAD;  // floats a partial row
  static constexpr size_t RING = (size_t)STAGES * SLOT;
  static constexpr size_t PART = (size_t)BM * PART_LD * 4;  // one weight's
  // ring (its first bytes reused for the NW partial tiles), 2 * STAGES
  // barriers, 1024 bytes of slack to align the ring
  static constexpr size_t SMEM = RING + 2 * STAGES * 8 + 1024;
  static_assert(BM % 64 == 0 && (BN == 32 || BN == 64), "m64 warpgroups, wgmma N 32 or 64");
  static_assert(NW == 1 || NW == 2, "one weight or two");
  static_assert(BK == 32 || BK == 64 || BK == 128, "BK 32, 64 or 128");
  static_assert(SPLIT_ALIGN % BK == 0, "no slab crosses the end of a K range");
  static_assert(X_SLOT % 1024 == 0 && W_SLOT % 1024 == 0, "1024-byte aligned slots");
  static_assert(NW * PART <= RING, "the partial tiles fit the drained ring");
  static_assert(SMEM <= SMEM_LIMIT, "ring too large for a block");
  static_assert(STAGES > 3, "a ring deeper than three slots");
};

// --------------------------------------------------------------------------
// PTX wrappers
// --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra LAB_DONE;\n"
      "bra LAB_WAIT;\n"
      "LAB_DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// shared-memory matrix descriptor: start, leading / stride byte offsets,
// swizzle (1 = 128-byte, 2 = 64-byte)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | ((uint64_t)swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the accumulators in their registers across the asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x BN, f32) += A (64 x 16, K-major) * B (16 x BN, N-major: the
// transpose flag), both from shared memory
template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], uint64_t da, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// --------------------------------------------------------------------------
// K walks: which x columns and weight rows slab s of a CTA reads
// --------------------------------------------------------------------------

// A walk gives the kernel, for CTA (blockIdx.x, .y, .z) = (M tile, N tile,
// K range or split): its first output column and how many of its BN
// columns are live, the weight map's column of its boxes, and its slabs --
// the number (the same in every warp, so the k16 loop needs no branch) and,
// for the producer, each slab's x column and weight row.  TABLE ints of
// shared memory hold what a walk stages before the loop.

// The dense GEMM: x [M, K] @ w [K, N]; K range z covers rows [z * kchunk,
// (z + 1) * kchunk) of K, slab s x columns and weight rows kb + s * BK.
struct DenseWalk {
  int N, K, kchunk;
  static constexpr int TABLE = 0;
  __device__ __forceinline__ int out_col(int bn) const { return blockIdx.y * bn; }
  __device__ __forceinline__ int out_cols(int bn) const {
    return min(bn, N - (int)blockIdx.y * bn);
  }
  __device__ __forceinline__ int w_col(int bn) const { return blockIdx.y * bn; }
  __device__ __forceinline__ void stage(int*, int, int, int) const {}
  __device__ __forceinline__ int slabs(const int*, int bk) const {
    const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
    return ke > kb ? (ke - kb + bk - 1) / bk : 0;
  }
  template <typename F>
  __device__ __forceinline__ void for_each(const int* table, int, int bk, F&& issue) const {
    const int kb = blockIdx.z * kchunk, n = slabs(table, bk);
    for (int s = 0; s < n; ++s) issue(s, kb + s * bk, kb + s * bk);
  }
};

// One band of a block-sparse matmul over PBCSR weights (bsr_matmul.cu):
// values [Nb, S, bm, bn] seen as one [Nb * S * bm, bn] matrix, block_rows
// [Nb, S] (-1 = pad).  N tile y is BN columns of block-column col0 + y /
// (bn / BN); split z walks packed steps [z * schunk, (z + 1) * schunk) of
// the band's `count`, their block_rows staged in shared memory before the
// loop (one coalesced read, never a dependent global load a slab) and the
// pads dropped there: slab s is a BK-row part of the CTA's s-th live step,
// x columns block_rows * bm + u * BK, weight rows of the step's block.
// This is the TPU kernel's scalar prefetch (PrefetchScalarGridSpec): one
// tensor map covers x and one all of values, so a band needs no map of its
// own.
struct BsrWalk {
  const int* rows;
  int s_stride, col0, bm, bn, count, schunk;
  static constexpr int TABLE = 256;  // most packed steps a CTA walks
  __device__ __forceinline__ int col(int bnt) const { return col0 + blockIdx.y / (bn / bnt); }
  __device__ __forceinline__ int w_col(int bnt) const { return (blockIdx.y % (bn / bnt)) * bnt; }
  __device__ __forceinline__ int out_col(int bnt) const { return col(bnt) * bn + w_col(bnt); }
  __device__ __forceinline__ int out_cols(int bnt) const { return bnt; }
  __device__ __forceinline__ int steps() const {
    const int sb = blockIdx.z * schunk;
    return max(min(count, sb + schunk) - sb, 0);
  }
  // the CTA's first packed step: block-column col, step z * schunk
  __device__ __forceinline__ long long first(int bnt) const {
    return (long long)col(bnt) * s_stride + (long long)blockIdx.z * schunk;
  }
  // every thread: the CTA's steps of block_rows into the table
  __device__ __forceinline__ void stage(int* table, int bnt, int tid, int nt) const {
    const int n = steps();
    const int* src = rows + first(bnt);
    for (int i = tid; i < n; i += nt) table[i] = __ldg(src + i);
  }
  // the live steps' slabs, counted by each warp over the staged table
  __device__ __forceinline__ int slabs(const int* table, int bk) const {
    const int n = steps(), lane = threadIdx.x % 32;
    int live = 0;
    for (int b = 0; b < n; b += 32) {
      const bool v = b + lane < n && table[b + lane] >= 0;
      live += __popc(__ballot_sync(0xffffffffu, v));
    }
    return live * (bm / bk);
  }
  // the producer: each live step's bm / bk slabs in order, pads skipped
  template <typename F>
  __device__ __forceinline__ void for_each(const int* table, int bnt, int bk, F&& issue) const {
    const int n = steps();
    const long long f = first(bnt);
    int s = 0;
    for (int i = 0; i < n; ++i) {
      const int r = table[i];
      if (r < 0) continue;
      const int wrow = (int)((f + i) * bm);
      for (int u = 0; u < bm; u += bk) issue(s++, r * bm + u, wrow + u);
    }
  }
};

// --------------------------------------------------------------------------
// the kernel
// --------------------------------------------------------------------------

// grid (M tiles, N tiles, NS), cluster (1, 1, NS) where NS > 1 (one range
// or split launches no cluster): the walk says which K rows each CTA reads
template <int BM, int BN, int BK, int DEPTH, int NW, typename Walk, typename Epi>
__global__ void __launch_bounds__(Tile<BM, BN, BK, DEPTH, NW>::NT)
    wgmma_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap umap, int M, Walk walk, Epi epi) {
  using T = Tile<BM, BN, BK, DEPTH, NW>;
  constexpr int STAGES = T::STAGES, WGS = T::WGS, NT = T::NT;
  extern __shared__ unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte aligned slots
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + T::RING);
  uint64_t* empty = full + STAGES;
  int* table = reinterpret_cast<int*>(empty + STAGES);
  const uint32_t ring = smem_u32(smem);

  const int tid = threadIdx.x;
  const int ns = gridDim.z;
  const int zr = blockIdx.z;  // this CTA's K range or split: its rank in the cluster
  const int m0 = blockIdx.x * BM;
  cg::cluster_group cluster = cg::this_cluster();

  // the role of this thread's warpgroup, provably uniform (a shuffle), so
  // that ptxas keeps the consumers' wgmma pipelined
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(full + s), 1);
      mbar_init(smem_u32(empty + s), WGS);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid == WGS * 128) {
    prefetch_map(&xmap);
    prefetch_map(&wmap);
    if constexpr (NW == 2) prefetch_map(&umap);
  }
  walk.stage(table, BN, tid, NT);
  __syncthreads();  // the barriers initialised and the walk's table staged before any copy
  const int n_slabs = walk.slabs(table, BK);  // the same in every warp

  if (wg == WGS) {
    // ---- producer warp: one thread issues every copy ----
    if (tid == WGS * 128) {
      const int n0 = walk.w_col(BN);
      const CUtensorMap *xm = &xmap, *wm = &wmap, *um = &umap;
      walk.for_each(table, BN, BK, [&](int s, int xk, int k0) {
        const int slot = s % STAGES;
        if (s >= STAGES) mbar_wait(smem_u32(empty + slot), ((s / STAGES) - 1) & 1);
        const uint32_t fb = smem_u32(full + slot);
        mbar_expect_tx(fb, T::SLOT);
        const uint32_t xs = ring + slot * T::SLOT;
#pragma unroll
        for (int b = 0; b < T::XBOXES; ++b) {
          tma_load(xs + b * (BM * T::X_ROW), xm, fb, xk + b * T::XBOX, m0);
        }
        tma_load(xs + T::X_SLOT, wm, fb, n0, k0);
        if constexpr (NW == 2) tma_load(xs + T::X_SLOT + T::W_SLOT, um, fb, n0, k0);
      });
    }
    __syncwarp();
  } else {
    // ---- consumer warpgroups ----
    float acc[NW][BN / 2];  // one accumulator a weight
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[wi][i] = 0.f;
    }
    // x: K-major, rows of X_ROW bytes, 8-row atoms X_ROW * 8 apart (the
    // stride byte offset); w: N-major (the transpose flag), K rows of W_ROW
    // bytes, 8-row atoms W_ROW * 8 apart.  The leading byte offset (the
    // next swizzle-wide block along N) is never used at these N: wgmma's N
    // is one block, and it is given the atom stride too.
    constexpr uint32_t XSW = T::X_ROW == 128 ? 1 : 2, WSW = T::W_ROW == 128 ? 1 : 2;
    for (int s = 0; s < n_slabs; ++s) {
      const int slot = s % STAGES;
      mbar_wait(smem_u32(full + slot), (s / STAGES) & 1);
      const uint32_t xs = ring + slot * T::SLOT + wg * 64 * T::X_ROW;
      const uint32_t ws = ring + slot * T::SLOT + T::X_SLOT;
      // every k16 step of the slab: a range is whole slabs of every BK,
      // and steps past K multiply TMA's zero fill (exact zeros).  No branch
      // near a wgmma, or ptxas serialises them.
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) fence_regs(acc[wi]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t xa = xs + (kk * 16 / T::XBOX) * (BM * T::X_ROW) + (kk * 16 % T::XBOX) * 2;
        const uint64_t xd = smem_desc(xa, 16, 8 * T::X_ROW, XSW);
#pragma unroll
        for (int wi = 0; wi < NW; ++wi) {
          const uint32_t wa = ws + wi * T::W_SLOT + kk * 16 * T::W_ROW;
          wgmma_bf16<BN>(acc[wi], xd, smem_desc(wa, 8 * T::W_ROW, 8 * T::W_ROW, WSW));
        }
      }
      wgmma_commit();
      // the previous slab's group has retired: release its slot
      wgmma_wait<1>();
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) fence_regs(acc[wi]);
      if (s > 0 && tid % 128 == 0) mbar_arrive(smem_u32(empty + (s - 1) % STAGES));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) fence_regs(acc[wi]);
    // (the last slot needs no release: nothing more is loaded).  Every
    // consumer warpgroup done with the ring before any parks its partial
    // tile over it.
    if (WGS > 1) asm volatile("bar.sync 1, %0;\n" ::"n"(WGS * 128) : "memory");

    // park the partial tiles over the drained ring, weight wi's PART bytes
    // after weight wi - 1's: accumulator i of a thread is row 16 * warp +
    // lane / 4 (+ 8 for i % 4 >= 2), column 8 * (i / 4) + 2 * (lane % 4)
    // (+ 1 for odd i)
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      float* part = reinterpret_cast<float*>(smem + wi * T::PART);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = j * 8 + 2 * (lane % 4);
        *reinterpret_cast<float2*>(part + r * T::PART_LD + c) =
            make_float2(acc[wi][4 * j], acc[wi][4 * j + 1]);
        *reinterpret_cast<float2*>(part + (r + 8) * T::PART_LD + c) =
            make_float2(acc[wi][4 * j + 2], acc[wi][4 * j + 3]);
      }
    }
  }
  // CTA zr of the cluster sums rows [r0, r1) of the live tiles over the
  // ranges in split order, four columns a thread, every range's partials
  // requested before any is added
  const int out0 = walk.out_col(BN), ncols = walk.out_cols(BN);
  const int live = min(BM, M - m0);
  const int chunk = (live + ns - 1) / ns;
  const int r0 = zr * chunk, r1 = min(live, r0 + chunk);
  constexpr int G4 = BN / 4;
  const int groups = max(r1 - r0, 0) * G4;
  if (ns > 1) {
    cluster.sync();
  } else {
    __syncthreads();  // one range: no cluster, the CTA's own partial tiles
  }

  for (int e = tid; e < groups; e += NT) {
    const int rr = r0 + e / G4, c = (e % G4) * 4;
    if (c >= ncols) continue;
    float4 p[NW][MAX_CLUSTER];
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const float* own = reinterpret_cast<const float*>(smem + wi * T::PART) +
                         rr * T::PART_LD + c;
      p[wi][0] = *reinterpret_cast<const float4*>(ns > 1 ? cluster.map_shared_rank(own, 0)
                                                           : own);
#pragma unroll
      for (int sp = 1; sp < MAX_CLUSTER; ++sp) {
        if (sp < ns) {
          p[wi][sp] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(own, sp));
        }
      }
    }
    float vs[4][NW];  // column q's NW sums, as the epilogue takes them
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      float4 v = p[wi][0];
#pragma unroll
      for (int sp = 1; sp < MAX_CLUSTER; ++sp) {
        if (sp < ns) {
          v.x += p[wi][sp].x;
          v.y += p[wi][sp].y;
          v.z += p[wi][sp].z;
          v.w += p[wi][sp].w;
        }
      }
      vs[0][wi] = v.x;
      vs[1][wi] = v.y;
      vs[2][wi] = v.z;
      vs[3][wi] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (c + q < ncols) epi(m0 + rr, out0 + c + q, vs[q]);
    }
  }
  if (ns > 1) cluster.sync();  // no CTA leaves while another reads its partial tiles
}

// --------------------------------------------------------------------------
// host side
// --------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda)
inline EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &q);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    const bool ok = e == cudaSuccess && q == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiledFn>(p) : nullptr;
  }();
  return fn;
}

// a 2-D row-major bf16 matrix [outer, inner] read in boxes of
// [box_outer, box_inner] with the swizzle of a box_inner * 2-byte row
inline cudaError_t encode(CUtensorMap* map, const void* ptr, int inner, int outer, int box_inner,
                          int box_outer) {
  const EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUtensorMapSwizzle sw =
      box_inner * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The rule that sends a bf16 launch here (_build.bf16_body, _build.ffn_body):
// TMA addresses the operands -- x, the weights and out 16-byte aligned, K
// and N multiples of 8 (row strides of whole 16 bytes), K > 0.
inline bool addressable(const void* x, const void* w0, const void* w1, const void* out, int N,
                        int K) {
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  return K > 0 && K % 8 == 0 && N % 8 == 0 && a16(x) && a16(w0) && a16(w1) && a16(out);
}

// Launch the body on tensor maps the caller encoded: grid (M tiles, N
// tiles, NS), a thread block cluster of the NS CTAs along z where NS > 1,
// Walk's table after the ring's barriers.
template <int BM, int BN, int BK, int DEPTH, int NW, typename Walk, typename Epi>
cudaError_t run(const CUtensorMap& xmap, const CUtensorMap& wmap, const CUtensorMap& umap, int M,
                dim3 grid, const Walk& walk, const Epi& epi, cudaStream_t stream) {
  using T = Tile<BM, BN, BK, DEPTH, NW>;
  constexpr size_t SMEM = T::SMEM + Walk::TABLE * sizeof(int);
  static_assert(SMEM <= SMEM_LIMIT, "ring and table too large for a block");
  if (grid.z > (unsigned)MAX_CLUSTER) return cudaErrorInvalidValue;
  auto kernel = wgmma_gemm_kernel<BM, BN, BK, DEPTH, NW, Walk, Epi>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(T::NT);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = grid.z;
  cfg.attrs = attr;
  cfg.numAttrs = grid.z > 1 ? 1 : 0;  // one range or split: no cluster to form
  e = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, umap, M, walk, epi);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Launch one tile with NW weights (w1 unused at NW = 1) on `stream`: K
// ranges of kchunk rows (a multiple of SPLIT_ALIGN, at most MAX_CLUSTER
// ranges).  A launch the rule or the plan refuses returns
// cudaErrorInvalidValue: nothing falls back.
template <int BM, int BN, int BK, int DEPTH, int NW, typename Epi>
cudaError_t launch_nw(const bf16* x, const bf16* w0, const bf16* w1, const void* out, int M,
                      int N, int K, int kchunk, const Epi& epi, cudaStream_t stream) {
  using T = Tile<BM, BN, BK, DEPTH, NW>;
  if (NW == 1) w1 = w0;
  if (!addressable(x, w0, w1, out, N, K) || kchunk < SPLIT_ALIGN || kchunk % SPLIT_ALIGN) {
    return cudaErrorInvalidValue;
  }
  const int ns = (K + kchunk - 1) / kchunk;
  if (ns > MAX_CLUSTER) return cudaErrorInvalidValue;
  CUtensorMap xmap, wmap, umap;
  cudaError_t e = encode(&xmap, x, K, M, T::XBOX, BM);
  if (e != cudaSuccess) return e;
  e = encode(&wmap, w0, N, K, BN, BK);
  if (e != cudaSuccess) return e;
  umap = wmap;
  if (NW == 2) {
    e = encode(&umap, w1, N, K, BN, BK);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, ns);
  return run<BM, BN, BK, DEPTH, NW>(xmap, wmap, umap, M, grid, DenseWalk{N, K, kchunk}, epi,
                                    stream);
}

// One weight: the dense GEMMs' launch.
template <int BM, int BN, int BK, int DEPTH, typename Epi>
cudaError_t launch(const bf16* x, const bf16* w, const void* out, int M, int N, int K,
                   int kchunk, const Epi& epi, cudaStream_t stream) {
  return launch_nw<BM, BN, BK, DEPTH, 1>(x, w, nullptr, out, M, N, K, kchunk, epi, stream);
}

}  // namespace wgmma_gemm
