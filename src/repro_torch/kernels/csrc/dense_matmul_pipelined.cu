// Dense GEMM with K slabs streamed through a shared-memory ring, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/dense_matmul.py:dense_matmul_pipelined_kernel (wrapper
// dense_matmul with pipeline >= 2): out = epilogue(act(x @ w + bias)), the
// same function as dense_matmul.cu, f32 or bf16 (x, w, bias, the side
// operands and out share the type; f32 accumulator and epilogue, one
// rounding at the store).  Only a tuning-cache winner (or a pin) with
// pipeline depth >= 2 selects it.
//
// It runs the tiled kernels' bodies at ring depth 2 / 3: f32 on
// csrc/simt_gemm.cuh (DEPTH slabs of x in flight by cp.async; row-major or
// NCHW, as dense_matmul.cu); bf16 on csrc/wgmma_gemm.cuh (TMA + wgmma, a
// ring of 2 + 2 * DEPTH slots) where TMA addresses the operands, else on
// csrc/mma_gemm.cuh (row-major), by the same rule as dense_matmul.cu.  The
// loop is the same at every depth, so the result is bit-equal to the tiled
// kernel's for the same inputs.
//
// What bounds it here: as for the tiled kernel -- the CNN path's GEMMs are
// a few FLOP per byte, so device memory; the decoder's, the weights'
// bytes.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_gemm.cuh"
#include "simt_gemm.cuh"
#include "tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

// the bf16 kernel's epilogue: bias, activation, step program, one store --
// dense_matmul.cu's order

// bf16: the tile must be one of tiles.cuh's REPRO_BF16_PIPELINED_TILES;
// use_wgmma == 1 runs the wgmma body, 0 the mma.sync body.
int dispatch_bf16(const void* x, const void* w, const void* bias, void* out, int M, int N, int K,
                  int act, const StepProgram& p, int bm, int bn, int bk, int depth, void* ws,
                  void* counters, int kchunk, int use_wgmma, cudaStream_t st) {
  using B = __nv_bfloat16;
  const B* xb = static_cast<const B*>(x);
  const B* wb = static_cast<const B*>(w);
  const RowEpilogue<B> epi{static_cast<const B*>(bias), static_cast<B*>(out), N, act, p};
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (use_wgmma) {
#define REPRO_TRY_TMA(BM, BN, BK, DEPTH)                                                 \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                              \
    return (int)wgmma_gemm::launch<BM, BN, BK, DEPTH>(xb, wb, out, M, N, K, kchunk, epi, st); \
  }
    REPRO_BF16_PIPELINED_TILES(REPRO_TRY_TMA)
#undef REPRO_TRY_TMA
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                                 \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                               \
    return (int)mma_gemm::launch<BM, BN, BK, DEPTH, 1>(xb, wb, nullptr, M, N, K, kchunk, wsf, \
                                                       cnt, epi, st);                    \
  }
  REPRO_BF16_PIPELINED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16; (bm, bn, bk, depth) one of tiles.cuh's
// pipelined tiles of that type (REPRO_GEMM_PIPELINED_TILES for f32,
// REPRO_BF16_PIPELINED_TILES for bf16); layout and P as for
// repro_dense_matmul (NCHW for f32 only).  bf16 takes K ranges of kchunk
// rows and either use_wgmma == 1 (the wgmma body, as repro_dense_matmul) or,
// with more than one range, the f32 workspace ws [ceil(K / kchunk), M, N]
// and zeroed tile counters; f32 ignores them.
extern "C" int repro_dense_matmul_pipelined(const void* x, const void* w, const void* bias,
                                            void* out, int M, int N, int K, int act,
                                            int n_steps, const int* prog, int n_sides,
                                            const void* const* sides, int dtype, void* ws,
                                            void* counters, int kchunk, int use_wgmma, int bm,
                                            int bn, int bk, int depth, int layout, int P,
                                            void* stream) {
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
    return (int)simt_gemm::run<float, true>(a, layout, bm, bn, bk, depth, st);
  }
  return dispatch_bf16(x, w, bias, out, M, N, K, act, p, bm, bn, bk, depth, ws, counters, kchunk,
                       use_wgmma, st);
}
