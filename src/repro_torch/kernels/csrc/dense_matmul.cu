// Dense GEMM with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/dense_matmul.py:dense_matmul_kernel
// (wrapper dense_matmul): out = epilogue(act(x @ w + bias)).
//
// Element type T: f32 or bf16 (x, w, bias, the epilogue's side operands and
// out share it).  Operands are converted to f32 as tiles are staged, the
// accumulator and the whole epilogue run in f32, and the one store rounds
// to T -- the TPU kernel's jnp.dot(..., preferred_element_type=f32) and
// astype(x.dtype).  The f32 instances compute exactly what they computed
// before bf16 was added.
//
// Layout: x [M, K], w [K, N], out [M, N], row-major; side operands of the
// epilogue are [M, N] like the output.  Two kernels:
//
// * tiled (every f32 call; bf16 with M > 8 or a tile named): each thread
//   block owns a BM x BN output tile (one of tiles.cuh's, chosen by the
//   wrapper) and walks K in BK slabs staged in shared memory;
//   each thread accumulates a TM x TN micro-tile in registers with FMA on
//   the CUDA cores (true f32, no TF32).  Ragged M / N / K edges are masked
//   (zero-filled loads, guarded stores), so the wrapper pads nothing.
// * skinny split-K (bf16 with M <= 8 and no tile named: the decoder's
//   q/k/v/o/down projections at decode, csrc/skinny_gemm.cuh).
// The pipelined variant (K slabs through a cp.async ring, tuning winners
// with depth >= 2) is dense_matmul_pipelined.cu.
//
// What bounds it here: on the CNN path (1x1 convs, M = N*H*W pixels, K and
// N in 32..192) the arithmetic intensity is a few FLOP/byte, so device
// memory bounds it: x is read once per N-tile and the output written once.
// At decode the weights' bytes bound it (M = batch rows, one FMA per weight
// element per row): the skinny kernel spreads them over every SM.  The
// design keeps the whole epilogue (bias, activation, residual add/mul) on
// the accumulator before the single store, so no intermediate makes a
// second trip through memory.  No wgmma or TMA yet.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "skinny_gemm.cuh"
#include "tiles.cuh"

namespace {

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    dense_matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const T* __restrict__ bias, T* __restrict__ out, int M,
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
      As[kk][mm] = (m < M && k < K) ? to_f32(x[(long long)m * K + k]) : 0.f;
    }
    // w slab [BK, BN]: neighbouring threads read neighbouring n
    for (int e = tid; e < BK * BN; e += NT) {
      const int nn = e % BN, kk = e / BN;
      const int n = n0 + nn, k = k0 + kk;
      Bs[kk][nn] = (n < N && k < K) ? to_f32(w[(long long)k * N + n]) : 0.f;
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
      if (bias) v += to_f32(bias[n]);
      v = apply_act(act, v);
      out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, v, idx));
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch(const T* x, const T* w, const T* bias, T* out, int M, int N, int K, int act,
            const StepProgram& prog, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  dense_matmul_kernel<T, BM, BN, BK, TM, TN>
      <<<grid, block, 0, stream>>>(x, w, bias, out, M, N, K, act, prog);
}

// The tile (bm, bn, bk) must be one of tiles.cuh's REPRO_GEMM_TILED_TILES
// (the wrapper picks it: the tuning cache's winner, a pin, or the
// shape-based default); returns false for any other.
template <typename T>
bool launch_tiled(const void* x, const void* w, const void* bias, void* out, int M, int N,
                  int K, int act, const StepProgram& p, int bm, int bn, int bk,
                  cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(bias);
  T* ot = static_cast<T*>(out);
#define REPRO_TRY_TILE(BM, BN, BK)                                  \
  if (bm == BM && bn == BN && bk == BK) {                           \
    launch<T, BM, BN, BK, 4, 4>(xt, wt, bt, ot, M, N, K, act, p, st); \
    return true;                                                    \
  }
  REPRO_GEMM_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return false;
}

// The skinny kernel's epilogue: bias, activation, step program, one store.
template <typename T>
struct DenseEpilogue {
  const T* bias;
  T* out;
  int N;
  int act;
  StepProgram prog;
  __device__ __forceinline__ void operator()(int m, int n, const float* v) const {
    float y = v[0];
    if (bias) y += to_f32(bias[n]);
    y = apply_act(act, y);
    const long long idx = (long long)m * N + n;
    out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, y, idx));
  }
};

}  // namespace

// Message for an error code an entry point returned (shared by all kernels).
extern "C" const char* repro_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// dtype: 0 = f32, 1 = bf16.  kchunk > 0 selects the skinny split-K kernel
// (bf16, M <= 8) with vec columns per lane (8 or 1) and, when K spans more
// than one chunk, the f32 workspace ws [ceil(K / kchunk), M, N] and zeroed
// tile counters; kchunk == 0 selects the tiled kernel with the tile
// (bm, bn, bk), which must be one of tiles.cuh's (else cudaErrorInvalidValue).
extern "C" int repro_dense_matmul(const void* x, const void* w, const void* bias, void* out,
                                  int M, int N, int K, int act, int n_steps, const int* prog,
                                  int n_sides, const void* const* sides, int dtype, void* ws,
                                  void* counters, int kchunk, int vec, int bm, int bn, int bk,
                                  void* stream) {
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
  if (kchunk > 0) {
    if (dtype != 1 || M > SKINNY_MT) return (int)cudaErrorInvalidValue;
    using B = __nv_bfloat16;
    const B* xb = static_cast<const B*>(x);
    const B* wb = static_cast<const B*>(w);
    DenseEpilogue<B> epi{static_cast<const B*>(bias), static_cast<B*>(out), N, act, p};
    float* wsf = static_cast<float*>(ws);
    int* cnt = static_cast<int*>(counters);
    if (vec == 8) {
      if (N % 8 || reinterpret_cast<uintptr_t>(w) % 16) return (int)cudaErrorInvalidValue;
      return launch_skinny<B, 1, 8>(xb, wb, nullptr, M, N, K, kchunk, wsf, cnt, epi, st);
    }
    if (vec != 1) return (int)cudaErrorInvalidValue;
    return launch_skinny<B, 1, 1>(xb, wb, nullptr, M, N, K, kchunk, wsf, cnt, epi, st);
  }
  const bool known =
      dtype == 0 ? launch_tiled<float>(x, w, bias, out, M, N, K, act, p, bm, bn, bk, st)
                 : launch_tiled<__nv_bfloat16>(x, w, bias, out, M, N, K, act, p, bm, bn, bk, st);
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
