// The tile configurations every GEMM-shaped kernel is built for: the only
// block sizes the tuning cache (kernels/ops.py:TuningCache) can name.
// kernels/_build.py:GEMM_TILES / CONV_TILES list the same tuples, and a CPU
// test holds the two lists equal.
//
// Each list is an X-macro: X(...) is expanded once per tile, so a kernel
// file instantiates and dispatches on exactly these tiles.
#pragma once

// dense_matmul.cu / quant_matmul.cu, the tiled kernels (pipeline depth 1):
// X(BM, BN, BK), every thread a 4 x 4 micro-tile.  The first two are the
// shape-based defaults (N <= 32, wider).
#define REPRO_GEMM_TILED_TILES(X) \
  X(128, 32, 16)                  \
  X(64, 64, 16)                   \
  X(128, 64, 16)                  \
  X(64, 64, 32)

// dense_matmul_pipelined.cu / quant_matmul_pipelined.cu: X(BM, BN, BK,
// DEPTH), K slabs through a DEPTH-deep shared-memory ring.  Both default
// tiles at depth 2 and 3, so a pipeline pin alone always names a tile.
#define REPRO_GEMM_PIPELINED_TILES(X) \
  X(128, 32, 16, 2)                   \
  X(64, 64, 16, 2)                    \
  X(128, 32, 16, 3)                   \
  X(64, 64, 16, 3)

// conv2d.cu, every scheme: X(BM, BN, BK, TM, TN).  The first four are the
// shape-based defaults by output-channel count (O <= 4, <= 16, <= 32,
// wider; the INT8 schemes default to the last two).
#define REPRO_CONV_TILES(X) \
  X(256, 4, 16, 4, 1)       \
  X(256, 16, 16, 4, 4)      \
  X(128, 32, 16, 4, 4)      \
  X(64, 64, 16, 4, 4)       \
  X(256, 32, 16, 4, 4)      \
  X(128, 64, 16, 4, 4)
