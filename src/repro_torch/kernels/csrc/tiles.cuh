// The tile configurations every GEMM-shaped kernel is built for: the only
// block sizes the tuning cache (kernels/ops.py:TuningCache) can name.
// kernels/_build.py:GEMM_TILES / CONV_TILES list the same tuples, and a CPU
// test holds the two lists equal.
//
// Each list is an X-macro: X(...) is expanded once per tile, so a kernel
// file instantiates and dispatches on exactly these tiles.
#pragma once

// dense_matmul.cu / quant_matmul.cu, the f32 and INT8 tiled kernels
// (pipeline depth 1): X(BM, BN, BK).  The first two are the shape-based
// defaults (N <= 32, wider).  Each body derives its thread layout from the
// tuple: the f32 / W8 body (simt_gemm.cuh Shape) takes 8 x 8 micro-tiles
// on 128 x 64 and 8 x 4 elsewhere, 128 threads a CTA, x slabs of BK k in
// a ring of depth + 1 slots; the W8A8 body (int8_gemm.cuh Shape) takes
// warps of 32 x min(BN, 32) outputs and slabs of 4 * BK k.
// _build.gemm_shape / gemm_w8a8_shape derive the same.
#define REPRO_GEMM_TILED_TILES(X) \
  X(128, 32, 16)                  \
  X(64, 64, 16)                   \
  X(128, 64, 16)                  \
  X(64, 64, 32)

// dense_matmul_pipelined.cu / quant_matmul_pipelined.cu, f32 and INT8:
// X(BM, BN, BK, DEPTH), the same bodies with DEPTH slabs in flight.
// Both default tiles at depth 2 and 3, so a pipeline pin alone always
// names a tile.
#define REPRO_GEMM_PIPELINED_TILES(X) \
  X(128, 32, 16, 2)                   \
  X(64, 64, 16, 2)                    \
  X(128, 32, 16, 3)                   \
  X(64, 64, 16, 3)

// The bf16 tensor-core kernel (mma_gemm.cuh), its own list:
// X(BM, BN, BK, DEPTH), 32 x 32 warp tiles, a ring of DEPTH + 2 slots.
// dense_matmul.cu and fused_ffn.cu run the depth-1 tiles (the first three
// are the shape-based defaults: M <= 64 with N > 256, M <= 64 with
// N <= 256, M > 64), dense_matmul_pipelined.cu the depth-2 / 3 ones (every
// default at both depths).
#define REPRO_BF16_TILED_TILES(X) \
  X(64, 64, 64, 1)                \
  X(64, 32, 64, 1)                \
  X(128, 64, 32, 1)               \
  X(64, 64, 128, 1)

#define REPRO_BF16_PIPELINED_TILES(X) \
  X(64, 64, 64, 2)                    \
  X(64, 32, 64, 2)                    \
  X(128, 64, 32, 2)                   \
  X(64, 64, 64, 3)                    \
  X(64, 32, 64, 3)                    \
  X(128, 64, 32, 3)

// fused_ffn.cu's two-weight wgmma body (wgmma_gemm.cuh with NW = 2), its own
// list: X(BM, BN, BK, DEPTH), a slot of one x box and a box of each weight,
// 4 slots: 96 KB (two CTAs an SM) and 48 KB (four).  _build.ffn_tma_plan
// runs the first while its grid fits two CTAs an SM, else the second;
// both sum the same k16 steps, so they are bit-equal for a shape.
#define REPRO_FFN_WGMMA_TILES(X) \
  X(64, 64, 64, 1)               \
  X(64, 64, 32, 1)

// bsr_matmul.cu's wgmma route (wgmma_gemm.cuh with wgmma_gemm::BsrWalk, a
// 64-row M tile, depth 1), its own list: X(BN, BK), BN the columns of a
// block-column an N tile (64 where bn % 64 == 0, else 32), BK the rows of
// a slab (the largest of 128 / 64 / 32 dividing bm).
// _build.BSR_TMA_TILES lists the same pairs.
#define REPRO_BSR_TMA_TILES(X) \
  X(64, 128)                   \
  X(64, 64)                    \
  X(64, 32)                    \
  X(32, 128)                   \
  X(32, 64)                    \
  X(32, 32)

// conv2d.cu, every scheme: X(BM, BN, BK, TM, TN).  The shape-based
// defaults by output-channel count (_build.conv_default_tile): f32 256 x 4
// (O <= 4), 256 x 16 (<= 16), 256 x 32 (<= 32), 64 x 64 (wider); W8 256 x 32
// and 64 x 64; W8A8 128 x 32 and 64 x 64.  TM x TN is the f32 /
// W8 body's micro-tile (8 x 8; 8 x 4 for the narrow heads and the 64 x 64
// tile, whose short K runs want more threads; 4 x 4 at BN = 4).  The W8A8
// body (int8 tensor cores) derives its own tile from the same tuple
// (conv2d.cu Int8ConvShape): BK8 = 4 * BK k a slab, max(BN, 8) channels,
// warps of 32 x min(BN, 32) outputs; TM and TN do not apply to it.
#define REPRO_CONV_TILES(X) \
  X(256, 4, 16, 4, 4)       \
  X(256, 16, 16, 8, 4)      \
  X(128, 32, 16, 8, 8)      \
  X(64, 64, 16, 8, 4)       \
  X(256, 32, 16, 8, 8)      \
  X(128, 64, 16, 8, 8)
