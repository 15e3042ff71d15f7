// Fused gated-FFN first half, for Hopper (sm_90a): out = act(x @ Wg) * (x @ Wu).
//
// Replaces the TPU kernel repro/kernels/fused_ffn.py:ffn_gateup_kernel
// (wrapper ffn_gateup): one pass streams each x tile once against both
// weights, keeps two f32 accumulators, and applies the gate in the
// epilogue, so neither [M, F] projection ever reaches device memory.
//
// Element type T: f32 or bf16 (x, Wg, Wu and out share it); operands are
// widened to f32 as they are loaded, both accumulators are f32, and the one
// store rounds act(g) * u to T (the TPU kernel's preferred_element_type=f32
// and astype(x.dtype)).  Activations: relu, gelu (tanh form), silu, tanh.
//
// Layout: x [M, K], Wg / Wu [K, F], out [M, F], row-major.  Two kernels:
//
// * tiled (M > 8, prefill): a 64 x 64 output tile per block, K walked in
//   16-deep slabs staged in shared memory (one x slab, one slab of each
//   weight); each thread holds a 4 x 4 micro-tile of both accumulators.
//   Ragged M / F / K are masked.
// * skinny split-K (M <= 8, decode; csrc/skinny_gemm.cuh with two weights):
//   128 columns per block, the K range split so that about two blocks run
//   per SM (qwen2.5-3b, F = 11008, K = 2048: 86 column tiles x 4 splits).
//
// What bounds it here: at decode (M = batch <= 4) the bytes of Wg + Wu --
// 2 x 2048 x 11008 x 2 B = 90 MB a layer for qwen2.5-3b, at least 27 us at
// 3.35 TB/s -- so the design is about spreading F (and K) over all 132 SMs
// with wide loads; at prefill M = B * S rows share each weight tile.  No
// tensor cores (mma.sync / wgmma) or TMA yet.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "skinny_gemm.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ffn_gateup_kernel(const T* __restrict__ x, const T* __restrict__ wg,
                      const T* __restrict__ wu, T* __restrict__ out, int M, int F, int K,
                      int act) {
  constexpr int TY = BN / TN;
  constexpr int TX = BM / TM;
  constexpr int NT = TX * TY;
  __shared__ float As[BK][BM + 1];
  __shared__ float Gs[BK][BN + 1];
  __shared__ float Us[BK][BN + 1];

  const int tid = threadIdx.x;
  const int ty = tid % TY;
  const int tx = tid / TY;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  float ag[TM][TN], au[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ag[i][j] = au[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += NT) {
      const int kk = e % BK, mm = e / BK;
      const int m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, k = k0 + kk;
      const bool in = n < F && k < K;
      Gs[kk][nn] = in ? to_f32(wg[(long long)k * F + n]) : 0.f;
      Us[kk][nn] = in ? to_f32(wu[(long long)k * F + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], g[TN], u[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + i * TX];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        g[j] = Gs[kk][ty + j * TY];
        u[j] = Us[kk][ty + j * TY];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          ag[i][j] = fmaf(a[i], g[j], ag[i][j]);
          au[i][j] = fmaf(a[i], u[j], au[i][j]);
        }
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
      if (n >= F) continue;
      out[(long long)m * F + n] = from_f32<T>(apply_act(act, ag[i][j]) * au[i][j]);
    }
  }
}

// The skinny kernel's epilogue: act(g) * u, one store.
template <typename T>
struct GateUpEpilogue {
  T* out;
  int F;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, const float* v) const {
    out[(long long)m * F + n] = from_f32<T>(apply_act(act, v[0]) * v[1]);
  }
};

template <typename T>
int run(const void* x, const void* wg, const void* wu, void* out, int M, int F, int K, int act,
        void* ws, void* counters, int kchunk, int vec, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(wg);
  const T* ut = static_cast<const T*>(wu);
  T* ot = static_cast<T*>(out);
  if (kchunk > 0) {
    if (M > SKINNY_MT) return (int)cudaErrorInvalidValue;
    GateUpEpilogue<T> epi{ot, F, act};
    float* wsf = static_cast<float*>(ws);
    int* cnt = static_cast<int*>(counters);
    if (vec == 4) {
      const uintptr_t align = 4 * sizeof(T);
      if (F % 4 || reinterpret_cast<uintptr_t>(wg) % align ||
          reinterpret_cast<uintptr_t>(wu) % align) {
        return (int)cudaErrorInvalidValue;
      }
      return launch_skinny<T, 2, 4>(xt, gt, ut, M, F, K, kchunk, wsf, cnt, epi, st);
    }
    if (vec != 1) return (int)cudaErrorInvalidValue;
    return launch_skinny<T, 2, 1>(xt, gt, ut, M, F, K, kchunk, wsf, cnt, epi, st);
  }
  constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
  dim3 grid((M + BM - 1) / BM, (F + BN - 1) / BN);
  ffn_gateup_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, st>>>(xt, gt, ut, ot, M, F, K, act);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.  kchunk > 0 selects the skinny split-K kernel
// (M <= 8) with vec columns per lane (4 or 1) and, when K spans more than
// one chunk, the f32 workspace ws [ceil(K / kchunk), 2, M, F] and zeroed
// tile counters; kchunk == 0 selects the tiled kernel.
extern "C" int repro_ffn_gateup(const void* x, const void* wg, const void* wu, void* out,
                                int M, int F, int K, int act, int dtype, void* ws,
                                void* counters, int kchunk, int vec, void* stream) {
  if (M < 0 || F < 0 || K < 0 || act < ACT_NONE || act > ACT_TANH || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return run<float>(x, wg, wu, out, M, F, K, act, ws, counters, kchunk, vec, st);
  return run<__nv_bfloat16>(x, wg, wu, out, M, F, K, act, ws, counters, kchunk, vec, st);
}
