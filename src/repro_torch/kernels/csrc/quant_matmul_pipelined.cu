// INT8 GEMM with K slabs streamed through a shared-memory ring, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/quant_matmul.py:quant_matmul_pipelined_kernel (wrapper
// quant_matmul with pipeline >= 2):
//   out = epilogue(act((x @ w_q) * ws + bias))
// the same function as quant_matmul.cu.  The scheme follows the activation
// type (scheme.cuh): W8 streams f32 x slabs and int8 w slabs, widening each
// weight to f32 at its fmaf (f32 accumulator); W8A8 streams int8 slabs of
// both and sums int8 x int8 products in an exact int32 accumulator.  Then,
// in quant_matmul.cu's order: the accumulator to f32 (round to nearest),
// times ws[n], plus bias, the activation, the epilogue steps, one store.
// Only a tuning-cache winner (or a pin) with pipeline depth >= 2 selects it.
//
// The ring, the cp.async order and the edge handling are
// pipelined_gemm.cuh's.  int8 rows take 4-byte (or wider) copies only when
// their length is a multiple of 4 (K % 4 for x, N % 4 for w) and the
// pointer allows it; otherwise the kernel stages that operand with element
// loads.  Each output sums k in ascending order as the tiled kernel does,
// so the result is bit-equal to quant_matmul.cu's.
//
// What bounds it here: device memory, as for the tiled kernel (a few
// operations per byte on the main path); int8 slabs are a quarter of the
// f32 bytes, so a ring slot holds 4x the K of an f32 one for the same
// shared memory.  Integer multiply-add on the CUDA cores; int8 tensor
// cores are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "pipelined_gemm.cuh"
#include "tiles.cuh"

namespace {

// rescale, bias, activation, step program, one f32 store
struct QuantEpilogue {
  const float* ws;
  const float* bias;
  float* out;
  int N;
  int act;
  StepProgram prog;
  template <typename Acc>
  __device__ __forceinline__ void operator()(int m, int n, Acc acc) const {
    float v = (float)acc * ws[n];
    if (bias) v += bias[n];
    v = apply_act(act, v);
    const long long idx = (long long)m * N + n;
    out[idx] = apply_pointwise_steps(prog, v, idx);
  }
};

// XE: the activations' type (f32 for W8, int8 for W8A8); the tile must be
// one of tiles.cuh's REPRO_GEMM_PIPELINED_TILES (else
// cudaErrorInvalidValue).
template <typename XE, typename Acc>
int dispatch(const void* x, const int8_t* w, const QuantEpilogue& epi, int M, int N, int K,
             int bm, int bn, int bk, int depth, cudaStream_t st) {
  const XE* xt = static_cast<const XE*>(x);
  const int xvb = pipelined::copy_bytes(x, (long long)K * sizeof(XE));
  const int wvb = pipelined::copy_bytes(w, (long long)N);
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                                   \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                                 \
    return (int)pipelined::launch<XE, int8_t, Acc, BM, BN, BK, DEPTH>(xt, w, M, N, K, xvb, \
                                                                      wvb, epi, st);        \
  }
  REPRO_GEMM_PIPELINED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a8 != 0: W8A8 (x int8), else W8 (x f32).  ws is required; (bm, bn, bk,
// depth) one of tiles.cuh's pipelined tiles.
extern "C" int repro_quant_matmul_pipelined(const void* x, const void* w, const void* ws,
                                            const void* bias, void* out, int M, int N, int K,
                                            int a8, int act, int n_steps, const int* prog,
                                            int n_sides, const void* const* sides, int bm,
                                            int bn, int bk, int depth, void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 || ws == nullptr ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const QuantEpilogue epi{static_cast<const float*>(ws), static_cast<const float*>(bias),
                          static_cast<float*>(out), N, act, p};
  const int8_t* wq = static_cast<const int8_t*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a8) return dispatch<int8_t, int>(x, wq, epi, M, N, K, bm, bn, bk, depth, st);
  return dispatch<float, float>(x, wq, epi, M, N, K, bm, bn, bk, depth, st);
}
