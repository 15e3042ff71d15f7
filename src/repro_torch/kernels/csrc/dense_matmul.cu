// Dense f32 GEMM with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dense_matmul.py:dense_matmul_kernel
// (wrapper dense_matmul): out = epilogue(act(x @ w + bias)).
//
// Layout: x [M, K], w [K, N], out [M, N], row-major, f32; side operands of
// the epilogue are [M, N] like the output.  Each thread block owns a BM x BN
// output tile and walks K in BK slabs staged in shared memory; each thread
// accumulates a TM x TN micro-tile in registers with FMA on the CUDA cores
// (true f32, no TF32).  Ragged M / N / K edges are masked (zero-filled
// loads, guarded stores), so the wrapper pads nothing in device memory.
//
// What bounds it here: on the main path (1x1 convs, M = N*H*W pixels, K and
// N in 32..192) the arithmetic intensity is a few FLOP/byte, so device
// memory bounds it: x is read once per N-tile and the output written once.
// The design keeps the whole epilogue (bias, activation, residual add/mul)
// on the accumulator before the single store, so no intermediate makes a
// second trip through memory.  No wgmma, TMA or multistage pipeline yet.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    dense_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, int M,
                        int N, int K, int act, StepProgram prog) {
  constexpr int TY = BN / TN;  // threads along n (fastest: coalesced stores)
  constexpr int TX = BM / TM;  // threads along m
  constexpr int NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid % TY;
  const int tx = tid / TY;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // x slab [BM, BK]: neighbouring threads read neighbouring k
    for (int e = tid; e < BM * BK; e += NT) {
      const int kk = e % BK, mm = e / BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? x[(long long)m * K + k] : 0.f;
    }
    // w slab [BK, BN]: neighbouring threads read neighbouring n
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? w[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + i * TX];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][ty + j * TY];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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
      float v = acc[i][j];
      if (bias) v += bias[n];
      v = apply_act(act, v);
      out[idx] = apply_pointwise_steps(prog, v, idx);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const float* w, const float* bias, float* out, int M, int N,
            int K, int act, const StepProgram& prog, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  dense_matmul_kernel<BM, BN, BK, TM, TN>
      <<<grid, block, 0, stream>>>(x, w, bias, out, M, N, K, act, prog);
}

}  // namespace

// Message for an error code an entry point returned (shared by all kernels).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int repro_dense_matmul(const void* x, const void* w, const void* bias, void* out,
                                  int M, int N, int K, int act, int n_steps, const int* prog,
                                  int n_sides, const void* const* sides, void* stream) {
  StepProgram p;
  if (M < 0 || N < 0 || K < 0 ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || N == 0) return (int)cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= 32) {
    launch<128, 32, 16, 4, 4>(xf, wf, bf, of, M, N, K, act, p, st);
  } else {
    launch<64, 64, 16, 4, 4>(xf, wf, bf, of, M, N, K, act, p, st);
  }
  return (int)cudaGetLastError();
}
