// INT8 GEMM with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py:quant_matmul_kernel
// (wrapper quant_matmul):  out = epilogue(act((x @ w_q) * ws + bias))
//
// Layouts (simt_gemm.cuh): row-major x [M, K], w_q [K, N], out and sides
// [M, N]; or NCHW x [nb, K, P], w_q [N, K] (a 1x1 OIHW filter), out and
// sides [nb, N, P] -- the 1x1-conv path, read and written in place.  ws
// [N] f32 is the combined per-column rescale (w_scale, times the
// activation scale for W8A8, folded by the wrapper); out is f32.
//
// The scheme follows the activation type:
// * W8 (f32 x): the CUDA-core body of csrc/simt_gemm.cuh, each int8 weight
//   widened to f32 as it is staged, one f32 fmaf chain an output;
// * W8A8 (int8 x): csrc/int8_gemm.cuh on int8 tensor cores (mma.sync
//   m16n8k32 s8, exact int32 sums).
// Either way, after the contraction and in this order (the TPU kernel's):
// the accumulator as f32, times ws[n], plus bias (two roundings), the
// activation, the epilogue steps, one store.  The tile is one of tiles.cuh's
// REPRO_GEMM_TILED_TILES (depth 1); the pipelined variant
// (quant_matmul_pipelined.cu) runs the same bodies at depth 2 / 3, so every
// tile and depth gives the same bits.
//
// What bounds it here: the main path's calls are 1x1 convs over M = batch *
// H * W pixels with K, N in 32..192 and the M = batch qlinear: a few
// operations per byte, so device memory bounds them; int8 weights (and
// W8A8's int8 activations) cut the bytes read.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "int8_gemm.cuh"
#include "simt_gemm.cuh"

// a8 != 0: W8A8 (x int8), else W8 (x f32); ws is required; layout
// LAYOUT_ROW or LAYOUT_NCHW with P the pixels of an image (M = nb * P).  The
// tile (bm, bn, bk) must be one of tiles.cuh's REPRO_GEMM_TILED_TILES (else
// cudaErrorInvalidValue).
extern "C" int repro_quant_matmul(const void* x, const void* w, const void* ws,
                                  const void* bias, void* out, int M, int N, int K, int a8,
                                  int act, int n_steps, const int* prog, int n_sides,
                                  const void* const* sides, int bm, int bn, int bk, int layout,
                                  int P, void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 || ws == nullptr || layout < LAYOUT_ROW || layout > LAYOUT_NCHW ||
      P < 1 || (layout == LAYOUT_NCHW && M % P != 0) ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const gemm_args::Args a{x, w, static_cast<const float*>(ws), static_cast<const float*>(bias),
                          static_cast<float*>(out), M, N, K, P, act, p};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)(a8 ? int8_gemm::run<false>(a, layout, bm, bn, bk, 1, st)
                  : simt_gemm::run<int8_t, false>(a, layout, bm, bn, bk, 1, st));
}
