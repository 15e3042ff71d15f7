// Dense GEMM with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dense_matmul.py:dense_matmul_kernel
// (wrapper dense_matmul): out = epilogue(act(x @ w + bias)).
//
// Element type T: f32 or bf16 (x, w, bias, the epilogue's side operands and
// out share it).  The accumulator and the whole epilogue run in f32, and
// the one store rounds to T -- the TPU kernel's jnp.dot(...,
// preferred_element_type=f32) and astype(x.dtype).
//
// Four kernels:
//
// * f32: the CUDA-core body of csrc/simt_gemm.cuh at ring depth 1 (a tile
//   of tiles.cuh's REPRO_GEMM_TILED_TILES, chosen by the wrapper), in one of
//   two layouts: row-major (x [M, K], w [K, N], out and sides [M, N]) or
//   NCHW (x [nb, K, P], w [N, K], out and sides [nb, N, P]: the 1x1-conv
//   path, read and written in place); 8 x 8 / 8 x 4 register micro-tiles,
//   cp.async slabs, float4 stores; true f32 FMA, no TF32; bit-equal to the
//   pipelined entries and across tiles and layouts.
// * bf16 where TMA addresses the operands (x, w, out 16-byte aligned; K, N
//   multiples of 8; K > 0) with M > 8 or a tile named, and at M <= 8 for N
//   <= 1024 (the decoders' k / v projections at decode, on
//   _build.TMA_DECODE_TILE and tma_plan's ranges, rows past M TMA's zero
//   fill): the Hopper body of csrc/wgmma_gemm.cuh at depth 1 (tiles.cuh's
//   REPRO_BF16_TILED_TILES): TMA into a ring of swizzled slots, wgmma
//   m64nBNk16 into f32 accumulators, K split into at most 8 ranges fixed
//   by the shape (the wrapper's _build.tma_plan) and summed in the thread
//   block cluster's shared memory; bit-equal to the pipelined entries.
//   Row-major.
// * any other bf16 launch with M > 8 or a tile named (odd K or N,
//   unaligned pointers): the tensor-core kernel of csrc/mma_gemm.cuh at
//   ring depth 1: bf16 slabs through a 3-slot cp.async ring, ldmatrix +
//   mma.sync m16n8k16 into f32 accumulators, K split into ranges fixed by
//   the shape (_build.gemm_split); bit-equal to the pipelined entries.
// * any other bf16 launch with M <= 8 and no tile named (q / o / down at
//   decode, where it measured faster than the wgmma body): the
//   weight-streaming split-K kernel of csrc/skinny_bf16.cuh.  Row-major.
// The pipelined variant (tuning winners with depth >= 2) is
// dense_matmul_pipelined.cu.
//
// What bounds it here: on the CNN path (1x1 convs, M = N*H*W pixels, K and
// N in 32..192) the arithmetic intensity is a few FLOP/byte, so device
// memory bounds it (simt_gemm.cuh says how the body meets it).  On the
// decoder's path (M = 48 at prefill, M <= 4 at decode) the weights' bytes
// bound it: the tensor cores keep the math far below the copy time, and
// the K split and the skinny kernel spread the weights over every SM.
// The whole epilogue (bias, activation, residual add/mul) runs on the
// accumulator before the single store, so no intermediate makes a second
// trip through memory.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_gemm.cuh"
#include "simt_gemm.cuh"
#include "skinny_bf16.cuh"
#include "tiles.cuh"
#include "wgmma_gemm.cuh"

// Message for an error code an entry point returned (shared by all kernels).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16; layout: LAYOUT_ROW or LAYOUT_NCHW (f32 only),
// P the pixels of an image (NCHW; M = nb * P).
// * f32: simt_gemm.cuh's body with the tile (bm, bn, bk), one of tiles.cuh's
//   REPRO_GEMM_TILED_TILES (ws, counters, kchunk and vec unused: 0).
// * bf16, vec > 0: the skinny kernel (M <= 8) with vec columns per lane (8
//   or 1), K ranges of kchunk rows and, with more than one range, the f32
//   workspace ws [ceil(K / kchunk), M, N] and zeroed tile counters.
// * bf16, vec == 0, use_wgmma == 1: the wgmma body with the tile (bm, bn,
//   bk), one of REPRO_BF16_TILED_TILES, K ranges of kchunk rows (ws,
//   counters unused); a launch TMA cannot address gives
//   cudaErrorInvalidValue (the wrapper's rule sends none).
// * bf16, vec == 0, use_wgmma == 0: the mma.sync kernel with the tile (bm, bn,
//   bk), one of REPRO_BF16_TILED_TILES, K ranges of kchunk rows and, with
//   more than one range, ws [ceil(K / kchunk), M, N] and zeroed tile
//   counters (ceil(M / bm) * ceil(N / bn)).
// A tile not built gives cudaErrorInvalidValue.
extern "C" int repro_dense_matmul(const void* x, const void* w, const void* bias, void* out,
                                  int M, int N, int K, int act, int n_steps, const int* prog,
                                  int n_sides, const void* const* sides, int dtype, void* ws,
                                  void* counters, int kchunk, int vec, int use_wgmma, int bm,
                                  int bn, int bk, int layout, int P, void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 || dtype < 0 || dtype > 1 || layout < LAYOUT_ROW ||
      layout > LAYOUT_NCHW || (dtype == 1 && layout != LAYOUT_ROW) || P < 1 ||
      (layout == LAYOUT_NCHW && M % P != 0) ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const gemm_args::Args a{x, w, nullptr, static_cast<const float*>(bias),
                            static_cast<float*>(out), M, N, K, P, act, p};
    return (int)simt_gemm::run<float, false>(a, layout, bm, bn, bk, 1, st);
  }
  using B = __nv_bfloat16;
  const B* xb = static_cast<const B*>(x);
  const B* wb = static_cast<const B*>(w);
  RowEpilogue<B> epi{static_cast<const B*>(bias), static_cast<B*>(out), N, act, p};
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (vec > 0) {
    return skinny_bf16::launch<1>(xb, wb, nullptr, M, N, K, kchunk, vec, wsf, cnt, epi, st);
  }
  if (use_wgmma) {
#define REPRO_TRY_TMA(BM, BN, BK, DEPTH)                                                 \
  if (bm == BM && bn == BN && bk == BK) {                                                \
    return (int)wgmma_gemm::launch<BM, BN, BK, DEPTH>(xb, wb, out, M, N, K, kchunk, epi, st); \
  }
    REPRO_BF16_TILED_TILES(REPRO_TRY_TMA)
#undef REPRO_TRY_TMA
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                                 \
  if (bm == BM && bn == BN && bk == BK) {                                                 \
    return (int)mma_gemm::launch<BM, BN, BK, DEPTH, 1>(xb, wb, nullptr, M, N, K, kchunk, wsf, \
                                                       cnt, epi, st);                    \
  }
  REPRO_BF16_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return (int)cudaErrorInvalidValue;
}
