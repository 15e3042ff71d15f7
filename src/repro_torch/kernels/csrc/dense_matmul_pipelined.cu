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
// The ring, the cp.async order and the edge handling are
// pipelined_gemm.cuh's: x and w slabs stay in their element type in shared
// memory and each term is widened at its fmaf, summed in ascending k as
// dense_matmul.cu sums it, so the result is bit-equal to the tiled kernel's
// for the same inputs.
//
// What bounds it here: as for the tiled kernel -- the CNN path's GEMMs are
// a few FLOP per byte, so device memory; the ring keeps DEPTH - 1 slabs of
// loads in flight behind each step's FMAs instead of the tiled kernel's
// load-then-compute.  TMA (cuTensorMapEncodeTiled + mbarrier) and wgmma
// are later work.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "mma_gemm.cuh"
#include "pipelined_gemm.cuh"
#include "tiles.cuh"

namespace {

// bias, activation, step program, one store -- dense_matmul.cu's order
template <typename T>
struct DenseEpilogue {
  const T* bias;
  T* out;
  int N;
  int act;
  StepProgram prog;
  __device__ __forceinline__ void operator()(int m, int n, float acc) const {
    float v = acc;
    if (bias) v += to_f32(bias[n]);
    v = apply_act(act, v);
    const long long idx = (long long)m * N + n;
    out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, v, idx));
  }
  __device__ __forceinline__ void operator()(int m, int n, const float* v) const {
    (*this)(m, n, v[0]);
  }
};

// f32: the tile must be one of tiles.cuh's REPRO_GEMM_PIPELINED_TILES;
// returns cudaErrorInvalidValue for any other.
int dispatch_f32(const void* x, const void* w, const void* bias, void* out, int M, int N, int K,
                 int act, const StepProgram& p, int bm, int bn, int bk, int depth,
                 cudaStream_t st) {
  using T = float;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const int xvb = pipelined::copy_bytes(x, (long long)K * sizeof(T));
  const int wvb = pipelined::copy_bytes(w, (long long)N * sizeof(T));
  const DenseEpilogue<T> epi{static_cast<const T*>(bias), static_cast<T*>(out), N, act, p};
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                                \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                              \
    return (int)pipelined::launch<T, T, float, BM, BN, BK, DEPTH>(xt, wt, M, N, K, xvb, \
                                                                  wvb, epi, st);         \
  }
  REPRO_GEMM_PIPELINED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return (int)cudaErrorInvalidValue;
}

// bf16: the tile must be one of tiles.cuh's REPRO_BF16_PIPELINED_TILES.
int dispatch_bf16(const void* x, const void* w, const void* bias, void* out, int M, int N, int K,
                  int act, const StepProgram& p, int bm, int bn, int bk, int depth, void* ws,
                  void* counters, int kchunk, cudaStream_t st) {
  using B = __nv_bfloat16;
  const B* xb = static_cast<const B*>(x);
  const B* wb = static_cast<const B*>(w);
  const DenseEpilogue<B> epi{static_cast<const B*>(bias), static_cast<B*>(out), N, act, p};
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
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
// REPRO_BF16_PIPELINED_TILES for bf16).  bf16 takes K ranges of kchunk
// rows and, with more than one range, the f32 workspace ws
// [ceil(K / kchunk), M, N] and zeroed tile counters; f32 ignores them.
extern "C" int repro_dense_matmul_pipelined(const void* x, const void* w, const void* bias,
                                            void* out, int M, int N, int K, int act,
                                            int n_steps, const int* prog, int n_sides,
                                            const void* const* sides, int dtype, void* ws,
                                            void* counters, int kchunk, int bm, int bn, int bk,
                                            int depth, void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 || dtype < 0 || dtype > 1 ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(x, w, bias, out, M, N, K, act, p, bm, bn, bk, depth, st);
  return dispatch_bf16(x, w, bias, out, M, N, K, act, p, bm, bn, bk, depth, ws, counters, kchunk,
                       st);
}
