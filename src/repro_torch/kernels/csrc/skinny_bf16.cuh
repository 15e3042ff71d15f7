// Weight-streaming split-K GEMM for a few bf16 rows: out = epi(x @ w0 [, x @ w1]).
//
// Shared by dense_matmul.cu (one weight) and fused_ffn.cu (gate and up,
// NW = 2) for bf16 with M <= 8: the decode step, where M is the batch and
// every weight byte is read once, so the bound is the weights' bytes over
// the memory rate.  What keeps such a kernel from that bound is the number
// of 16-byte loads in flight on each SM, and the fixed cost of each block
// (staging x, reducing partial sums, publishing them).  So:
//
// * a block is 8 warps over BN = 8 * VEC columns: lane l owns VEC adjacent
//   columns (one 16-byte word of each weight row for VEC = 8) at column
//   group l % 8 and takes the K rows kb + 4 * warp + l / 8 + 32 i, so each
//   128-byte row segment is one coalesced access and the block covers 32
//   rows per step;
// * each lane issues UNROLL rows of loads (x NW weights) before it uses any
//   of them: UNROLL * NW 16-byte words in flight a lane, 32 KB a block;
// * only MT = M rounded up to 1, 2, 4 or 8 rows are staged (f32, shared
//   memory) and multiplied, not a fixed 8;
// * the partial sums meet in a fixed order with one barrier: the four row
//   groups of a warp by two xor shuffles, then the 8 warps' sums, written
//   once to shared memory, added in warp order by the threads that own
//   the outputs;
// * _build.skinny_plan splits K into a few long ranges (>= 128 rows, at
//   most SKINNY_KC) so that the grid holds about two blocks per SM; with
//   more than one range every block writes its partial tile to the f32
//   workspace ws[nsplit][NW][M][N], and the block that finishes a column
//   tile last (an int counter per tile, which it resets to 0 for the next
//   launch) sums the ranges in order -- deterministic, no float atomics --
//   and runs the epilogue.
//
// Accumulation is f32: each lane sums its rows in ascending k, fixed by the
// shape, so the result does not change from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace skinny_bf16 {

using bf16 = __nv_bfloat16;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = WARPS * 4;  // K rows a block covers per step
constexpr int KC = 1024;         // most K rows a range stages (_build.SKINNY_KC)
constexpr int MAX_M = 8;

// One weight row segment of VEC bf16 as raw bits, and its widening.
template <int VEC>
struct Raw;
template <>
struct Raw<8> {
  uint4 v;
  __device__ __forceinline__ void load(const bf16* p) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ __forceinline__ void widen(float (&o)[8]) const {
    Elem<bf16>::unpack(v.x, o + 0);
    Elem<bf16>::unpack(v.y, o + 2);
    Elem<bf16>::unpack(v.z, o + 4);
    Elem<bf16>::unpack(v.w, o + 6);
  }
};
template <>
struct Raw<1> {
  bf16 v;
  __device__ __forceinline__ void load(const bf16* p) { v = p[0]; }
  __device__ __forceinline__ void widen(float (&o)[1]) const { o[0] = to_f32(v); }
};

template <int NW, int VEC, int MT>
struct Smem {
  static constexpr int XS = MT * KC;                  // x rows of the range, f32
  static constexpr int RED = WARPS * NW * MT * 8 * VEC;  // the warps' partial sums
  static constexpr int FLOATS = XS > RED ? XS : RED;  // one buffer, used in turn
};

template <int NW, int VEC, int MT, typename Epi>
__global__ void __launch_bounds__(THREADS)
    skinny_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                       const bf16* __restrict__ w1, int M, int N, int K, int kchunk,
                       float* __restrict__ ws, int* __restrict__ counters, Epi epi) {
  constexpr int BN = 8 * VEC;
  constexpr int UNROLL = 8 / NW;
  __shared__ __align__(16) float buf[Smem<NW, VEC, MT>::FLOATS];
  __shared__ int s_last;
  float* xs = buf;   // [MT][KC] during the loop
  float* red = buf;  // [WARPS][NW][MT][BN] after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane & 7;   // column group
  const int rg = lane >> 3;  // row within the warp's 4
  const int n0 = blockIdx.x * BN;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const int kn = max(ke - kb, 0);

  for (int e = tid; e < MT * kn; e += THREADS) {
    const int mm = e / kn, kk = e % kn;
    xs[mm * KC + kk] = mm < M ? to_f32(x[(long long)mm * K + kb + kk]) : 0.f;
  }
  __syncthreads();

  const int nc = n0 + cg * VEC;
  const bool live = nc < N;  // VEC > 1 only when N % VEC == 0 (wrapper)
  const bf16* wp[2] = {w0, w1};
  float acc[NW][MT][VEC];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[wi][m][j] = 0.f;

  auto fma_row = [&](const Raw<VEC> (&raw)[NW], int k) {
    float xv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xv[m] = xs[m * KC + (k - kb)];
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      float wv[VEC];
      raw[wi].widen(wv);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[wi][m][j] = fmaf(xv[m], wv[j], acc[wi][m][j]);
    }
  };

  if (live) {
    int k = kb + warp * 4 + rg;
    for (; k + (UNROLL - 1) * ROWS < ke; k += UNROLL * ROWS) {
      Raw<VEC> raw[UNROLL][NW];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
          raw[u][wi].load(wp[wi] + (long long)(k + u * ROWS) * N + nc);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) fma_row(raw[u], k + u * ROWS);
    }
    for (; k < ke; k += ROWS) {
      Raw<VEC> raw[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) raw[wi].load(wp[wi] + (long long)k * N + nc);
      fma_row(raw, k);
    }
  }

  // the warp's four row groups (lanes cg, cg + 8, cg + 16, cg + 24)
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float v = acc[wi][m][j];
        v += __shfl_xor_sync(0xffffffffu, v, 8);
        v += __shfl_xor_sync(0xffffffffu, v, 16);
        acc[wi][m][j] = v;
      }
  __syncthreads();  // every warp is done with xs: red reuses the buffer
  if (rg == 0) {
#pragma unroll
    for (int wi = 0; wi < NW; ++wi)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[((warp * NW + wi) * MT + m) * BN + cg * VEC + j] = acc[wi][m][j];
  }
  __syncthreads();

  // thread e of MT * BN owns output (m, c) = (e / BN, e % BN): the block's
  // sum over the warps, in warp order
  auto block_sum = [&](int e, float (&v)[NW]) {
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const float* r = red + wi * MT * BN + e;
      float s = r[0];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) s += r[w * NW * MT * BN];
      v[wi] = s;
    }
  };

  const int nsplit = gridDim.y;
  if (nsplit == 1) {
    for (int e = tid; e < MT * BN; e += THREADS) {
      const int m = e / BN, n = n0 + e % BN;
      if (m >= M || n >= N) continue;
      float v[NW];
      block_sum(e, v);
      epi(m, n, v);
    }
    return;
  }

  for (int e = tid; e < MT * BN; e += THREADS) {
    const int m = e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    float v[NW];
    block_sum(e, v);
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) ws[(((long long)blockIdx.y * NW + wi) * M + m) * N + n] = v[wi];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long stride = (long long)NW * M * N;
  for (int e = tid; e < MT * BN; e += THREADS) {
    const int m = e / BN, n = n0 + e % BN;
    if (m >= M || n >= N) continue;
    float v[NW];
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const float* p = ws + ((long long)wi * M + m) * N + n;
      float s = __ldcg(p);
      for (int sp = 1; sp < nsplit; ++sp) s += __ldcg(p + sp * stride);
      v[wi] = s;
    }
    epi(m, n, v);
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int NW, int VEC, int MT, typename Epi>
cudaError_t launch_mt(const bf16* x, const bf16* w0, const bf16* w1, int M, int N, int K,
                      int kchunk, float* ws, int* counters, const Epi& epi, cudaStream_t st) {
  const int nsplit = (K + kchunk - 1) / kchunk;
  const dim3 grid((N + 8 * VEC - 1) / (8 * VEC), nsplit);
  skinny_bf16_kernel<NW, VEC, MT, Epi>
      <<<grid, THREADS, 0, st>>>(x, w0, w1, M, N, K, kchunk, ws, counters, epi);
  return cudaGetLastError();
}

template <int NW, int VEC, typename Epi>
cudaError_t launch_vec(const bf16* x, const bf16* w0, const bf16* w1, int M, int N, int K,
                       int kchunk, float* ws, int* counters, const Epi& epi, cudaStream_t st) {
  if (M <= 1) return launch_mt<NW, VEC, 1>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
  if (M <= 2) return launch_mt<NW, VEC, 2>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
  if (M <= 4) return launch_mt<NW, VEC, 4>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
  return launch_mt<NW, VEC, 8>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
}

// Host side: check a skinny launch's arguments (M <= 8, a range within the
// x stage, ws and counters when K spans several ranges, VEC = 8 only on
// 16-byte aligned rows) and launch it.
template <int NW, typename Epi>
int launch(const bf16* x, const bf16* w0, const bf16* w1, int M, int N, int K, int kchunk,
           int vec, float* ws, int* counters, const Epi& epi, cudaStream_t st) {
  if (M < 1 || M > MAX_M || K < 1 || kchunk < 1 || kchunk > KC) return (int)cudaErrorInvalidValue;
  const int nsplit = (K + kchunk - 1) / kchunk;
  if (nsplit > 65535 || (nsplit > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 8) {
    const bool aligned = reinterpret_cast<uintptr_t>(w0) % 16 == 0 &&
                         (NW == 1 || reinterpret_cast<uintptr_t>(w1) % 16 == 0);
    if (N % 8 || !aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_vec<NW, 8>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_vec<NW, 1>(x, w0, w1, M, N, K, kchunk, ws, counters, epi, st);
}

}  // namespace skinny_bf16
