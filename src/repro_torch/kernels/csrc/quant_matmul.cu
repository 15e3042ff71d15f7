// INT8 GEMM with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py:quant_matmul_kernel
// (wrapper quant_matmul):  out = epilogue(act((x @ w_q) * ws + bias))
//
// Layout: x [M, K] (int8 for W8A8, f32 for W8), w_q [K, N] int8, ws [N] f32
// (the combined per-column rescale: w_scale, times the activation scale for
// W8A8, folded by the wrapper), out [M, N] f32, row-major; side operands of
// the epilogue are [M, N] like the output.
//
// The scheme follows the activation type (scheme.cuh): W8A8 stages int8 x
// and int8 w tiles in shared memory and accumulates int8 x int8 products in
// an exact int32 register accumulator; W8 stages f32 x and converts each
// int8 weight element to f32 as it is staged, accumulating in f32.  Either
// way the weights stream from device memory at a quarter of the f32 bytes.
// After the contraction, in this order (the TPU kernel's): the accumulator
// converted to f32 (round to nearest), times ws[n], plus bias, the
// activation, then the epilogue steps, before the one store.
//
// Structure as dense_matmul.cu: each block owns a BM x BN output tile (one
// of tiles.cuh's, chosen by the wrapper) and walks K in BK slabs; each
// thread accumulates a TM x TN micro-tile in registers.  Ragged M / N / K
// edges are masked (zero-filled loads, guarded stores), so nothing is
// padded in device memory.
//
// What bounds it here: the main path's calls are 1x1 convs over M = batch *
// H * W pixels with K, N in 32..192 and the M = batch qlinear: a few
// operations per byte, so device memory bounds them.  The integer
// multiply-add runs on the CUDA cores; __dp4a, mma.sync s8 or wgmma s8 are
// later work.  The pipelined variant is quant_matmul_pipelined.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "scheme.cuh"
#include "tiles.cuh"

namespace {

template <int S, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    quant_matmul_kernel(const typename Scheme<S>::X* __restrict__ x,
                        const int8_t* __restrict__ w, const float* __restrict__ ws,
                        const float* __restrict__ bias, float* __restrict__ out, int M, int N,
                        int K, int act, StepProgram prog) {
  using X = typename Scheme<S>::X;
  using SW = typename Scheme<S>::SW;
  using Acc = typename Scheme<S>::Acc;
  constexpr int TY = BN / TN;  // threads along n (fastest: coalesced stores)
  constexpr int TX = BM / TM;  // threads along m
  constexpr int NT = TX * TY;
  __shared__ X As[BK][BM + 1];
  __shared__ SW Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid % TY;
  const int tx = tid / TY;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slab [BM, BK]: neighbouring threads read neighbouring k
    for (int e = tid; e < BM * BK; e += NT) {
      const int kk = e % BK, mm = e / BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? x[(long long)m * K + k] : X(0);
    }
    // w slab [BK, BN]: neighbouring threads read neighbouring n; W8 converts
    // each int8 weight to f32 here, once per element
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? SW(w[(long long)k * N + n]) : SW(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      X a[TM];
      SW b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + i * TX];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][ty + j * TY];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tx + i * TX;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + ty + j * TY;
      if (n >= N) continue;
      const long long idx = (long long)m * N + n;
      float v = (float)acc[i][j] * ws[n];
      if (bias) v += bias[n];
      v = apply_act(act, v);
      out[idx] = apply_pointwise_steps(prog, v, idx);
    }
  }
}

template <int S, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const int8_t* w, const float* ws, const float* bias, float* out,
            int M, int N, int K, int act, const StepProgram& prog, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  quant_matmul_kernel<S, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const typename Scheme<S>::X*>(x), w, ws, bias, out, M, N, K, act, prog);
}

// The tile (bm, bn, bk) must be one of tiles.cuh's REPRO_GEMM_TILED_TILES;
// returns false for any other.
template <int S>
bool dispatch(const void* x, const int8_t* w, const float* ws, const float* bias, float* out,
              int M, int N, int K, int act, const StepProgram& prog, int bm, int bn, int bk,
              cudaStream_t stream) {
#define REPRO_TRY_TILE(BM, BN, BK)                                                  \
  if (bm == BM && bn == BN && bk == BK) {                                           \
    launch<S, BM, BN, BK, 4, 4>(x, w, ws, bias, out, M, N, K, act, prog, stream); \
    return true;                                                                    \
  }
  REPRO_GEMM_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return false;
}

}  // namespace

// a8 != 0: W8A8 (x int8), else W8 (x f32).  ws is required.  The tile
// (bm, bn, bk) must be one of tiles.cuh's (else cudaErrorInvalidValue).
extern "C" int repro_quant_matmul(const void* x, const void* w, const void* ws,
                                  const void* bias, void* out, int M, int N, int K, int a8,
                                  int act, int n_steps, const int* prog, int n_sides,
                                  const void* const* sides, int bm, int bn, int bk,
                                  void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 || ws == nullptr ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const int8_t* wq = static_cast<const int8_t*>(w);
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool known = a8 ? dispatch<SCHEME_W8A8>(x, wq, wsf, bf, of, M, N, K, act, p, bm, bn, bk, st)
                        : dispatch<SCHEME_W8>(x, wq, wsf, bf, of, M, N, K, act, p, bm, bn, bk, st);
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
