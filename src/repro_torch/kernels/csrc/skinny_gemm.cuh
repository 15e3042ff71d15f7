// Split-K "skinny" GEMM for a few rows: out = epi(x @ w0 [, x @ w1]).
//
// Shared by dense_matmul.cu (one weight) and fused_ffn.cu (gate and up
// weights, NW = 2).  It serves the decode step, where M is the batch (a
// handful of rows) and every weight byte is read once: the bound is the
// weights' bytes over the memory rate.  A tiled GEMM launches one block
// per 64-column tile there (32 blocks for N = 2048) and leaves most SMs
// idle; this kernel spreads the work over about two blocks per SM:
//
//   grid (ceil(N / BN), nsplit, ceil(M / MT)), BN = 32 * VEC columns,
//   MT = 8 rows, 8 warps per block.
//
// Each block stages its x rows for its K chunk (at most 1024) in shared
// memory as f32; each lane owns VEC adjacent columns and loads them as one
// 16- or 8-byte word per weight row; the 8 warps take interleaved K rows
// and their partial sums meet in shared memory in warp order.  With
// nsplit > 1 every block writes its partial tile to the f32 workspace
// ws[nsplit][NW][M][N]; the block that finishes a column tile last (an
// atomic counter per tile, zeroed by the wrapper) sums the nsplit partials
// in split order -- deterministic, no float atomics -- and runs the
// epilogue.  Accumulation is f32 whatever the element type T.
#pragma once

#include "epilogue.cuh"

#define SKINNY_MT 8
#define SKINNY_WARPS 8
#define SKINNY_KC 1024

template <typename T, int NW, int VEC, typename Epi>
__global__ void __launch_bounds__(SKINNY_WARPS * 32)
    skinny_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w0,
                       const T* __restrict__ w1, int M, int N, int K, int kchunk,
                       float* __restrict__ ws, int* __restrict__ counters, Epi epi) {
  constexpr int BN = 32 * VEC;
  __shared__ float xs[SKINNY_MT][SKINNY_KC];
  __shared__ float tile[NW][SKINNY_MT][BN];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.z * SKINNY_MT;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const int kn = max(ke - kb, 0);

  // x rows of this block for its K chunk (neighbouring threads, neighbouring k)
  for (int e = tid; e < SKINNY_MT * kn; e += blockDim.x) {
    const int mm = e / kn, kk = e % kn;
    const int m = m0 + mm;
    xs[mm][kk] = m < M ? to_f32(x[(long long)m * K + kb + kk]) : 0.f;
  }
  __syncthreads();

  const int nc = n0 + lane * VEC;
  const bool live = nc < N;  // VEC > 1 only when N % VEC == 0 (wrapper)
  const T* wp[2] = {w0, w1};
  float acc[NW][SKINNY_MT][VEC];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int m = 0; m < SKINNY_MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[wi][m][j] = 0.f;

  if (live) {
#pragma unroll 4
    for (int k = kb + warp; k < ke; k += SKINNY_WARPS) {
      float wv[NW][VEC];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) load_vec<T, VEC>(wp[wi] + (long long)k * N + nc, wv[wi]);
#pragma unroll
      for (int m = 0; m < SKINNY_MT; ++m) {
        const float xv = xs[m][k - kb];
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[wi][m][j] = fmaf(xv, wv[wi][j], acc[wi][m][j]);
      }
    }
  }

  // the warps' partial sums, added in warp order
  for (int w = 0; w < SKINNY_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int wi = 0; wi < NW; ++wi)
#pragma unroll
        for (int m = 0; m < SKINNY_MT; ++m)
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            float& t = tile[wi][m][lane * VEC + j];
            t = (w == 0) ? acc[wi][m][j] : t + acc[wi][m][j];
          }
    }
    __syncthreads();
  }

  const int nsplit = gridDim.y;
  if (nsplit == 1) {
    for (int e = tid; e < SKINNY_MT * BN; e += blockDim.x) {
      const int mm = e / BN, c = e % BN;
      const int m = m0 + mm, n = n0 + c;
      if (m >= M || n >= N) continue;
      float v[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) v[wi] = tile[wi][mm][c];
      epi(m, n, v);
    }
    return;
  }

  // publish this split's partial tile, then the last block of the tile
  // sums all splits in order and runs the epilogue
  for (int e = tid; e < SKINNY_MT * BN; e += blockDim.x) {
    const int mm = e / BN, c = e % BN;
    const int m = m0 + mm, n = n0 + c;
    if (m >= M || n >= N) continue;
#pragma unroll
    for (int wi = 0; wi < NW; ++wi)
      ws[(((long long)blockIdx.y * NW + wi) * M + m) * N + n] = tile[wi][mm][c];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = blockIdx.z * gridDim.x + blockIdx.x;
    s_last = atomicAdd(&counters[t], 1) == nsplit - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < SKINNY_MT * BN; e += blockDim.x) {
    const int mm = e / BN, c = e % BN;
    const int m = m0 + mm, n = n0 + c;
    if (m >= M || n >= N) continue;
    float v[NW];
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      float s = 0.f;
      for (int sp = 0; sp < nsplit; ++sp)
        s += __ldcg(&ws[(((long long)sp * NW + wi) * M + m) * N + n]);
      v[wi] = s;
    }
    epi(m, n, v);
  }
}

// Host side: check a skinny launch's arguments (kchunk within the shared
// x stage, the splits covering K) and launch it.
template <typename T, int NW, int VEC, typename Epi>
static inline int launch_skinny(const T* x, const T* w0, const T* w1, int M, int N, int K,
                                int kchunk, float* ws, int* counters, const Epi& epi,
                                cudaStream_t stream) {
  if (kchunk < 1 || kchunk > SKINNY_KC || K < 1) return (int)cudaErrorInvalidValue;
  const int nsplit = (K + kchunk - 1) / kchunk;
  if (nsplit > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  dim3 grid((N + 32 * VEC - 1) / (32 * VEC), nsplit, (M + SKINNY_MT - 1) / SKINNY_MT);
  skinny_gemm_kernel<T, NW, VEC, Epi>
      <<<grid, SKINNY_WARPS * 32, 0, stream>>>(x, w0, w1, M, N, K, kchunk, ws, counters, epi);
  return (int)cudaGetLastError();
}
