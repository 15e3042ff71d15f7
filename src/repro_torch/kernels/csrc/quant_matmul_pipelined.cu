// INT8 GEMM with K slabs streamed through a shared-memory ring, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/quant_matmul.py:quant_matmul_pipelined_kernel (wrapper
// quant_matmul with pipeline >= 2):
//   out = epilogue(act((x @ w_q) * ws + bias))
// the same function, layouts and schemes as quant_matmul.cu, on the same
// bodies at ring depth 2 / 3 (W8: csrc/simt_gemm.cuh, DEPTH slabs of x in
// flight by cp.async; W8A8: csrc/int8_gemm.cuh, DEPTH slabs of its
// k-contiguous operand in flight), so the result is bit-equal to the tiled
// kernel's.  Only a tuning-cache winner (or a pin) with pipeline depth >= 2
// selects it.
//
// What bounds it here: device memory, as for the tiled kernel.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "int8_gemm.cuh"
#include "simt_gemm.cuh"

// As repro_quant_matmul, with (bm, bn, bk, depth) one of tiles.cuh's
// pipelined tiles.
extern "C" int repro_quant_matmul_pipelined(const void* x, const void* w, const void* ws,
                                            const void* bias, void* out, int M, int N, int K,
                                            int a8, int act, int n_steps, const int* prog,
                                            int n_sides, const void* const* sides, int bm,
                                            int bn, int bk, int depth, int layout, int P,
                                            void* stream) {
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
  return (int)(a8 ? int8_gemm::run<true>(a, layout, bm, bn, bk, depth, st)
                  : simt_gemm::run<int8_t, true>(a, layout, bm, bn, bk, depth, st));
}
