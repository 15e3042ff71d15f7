// Fused gated-FFN first half, for Hopper (sm_90a): out = act(x @ Wg) * (x @ Wu).
//
// Replaces the TPU kernel repro/kernels/fused_ffn.py:ffn_gateup_kernel
// (wrapper ffn_gateup): one pass streams each x tile once against both
// weights, keeps two f32 accumulators, and applies the gate in the
// epilogue, so neither [M, F] projection ever reaches device memory.
//
// Element type T: f32 or bf16 (x, Wg, Wu and out share it); both
// accumulators are f32, and the one store rounds act(g) * u to T (the TPU
// kernel's preferred_element_type=f32 and astype(x.dtype)).  Activations:
// relu, gelu (tanh form), silu, tanh.
//
// Layout: x [M, K], Wg / Wu [K, F], out [M, F], row-major.  Kernels:
//
// * bf16 where TMA addresses the operands (x, Wg, Wu, out 16-byte aligned;
//   K, F multiples of 8): the Hopper body of csrc/wgmma_gemm.cuh with two
//   weights (NW = 2): a ring slot holds one x box and one box of each
//   weight, all through TMA against one full barrier; each consumer
//   warpgroup issues one wgmma per weight a k16 step on the same x
//   descriptor into two f32 accumulators; the K ranges (fixed by the
//   shape, _build.ffn_tma_plan) meet in a thread block cluster's shared
//   memory, both partial tiles summed in split order; act(g) * u on the
//   sums before the one store.  No workspace, no counters.  Tile: one of
//   tiles.cuh's REPRO_FFN_WGMMA_TILES.  Prefill and decode alike: at M <= 8
//   TMA fills the x box's rows past M with zeros, which cost no bytes of
//   device memory.
// * any other bf16 launch (odd K or F, unaligned pointers): the
//   tensor-core kernel of csrc/mma_gemm.cuh with two weights (NW = 2):
//   ldmatrix + mma.sync m16n8k16 into both accumulators, a 3-slot cp.async
//   ring, a tile of REPRO_BF16_TILED_TILES and the K ranges of
//   _build.gemm_split (a workspace and tile counters when split).
// * f32 (csrc/ffn_f32.cuh), M > 8: a two-weight CUDA-core GEMM -- a BM x
//   64 tile a CTA (BM 48 or 64, by M), 16-deep slabs of x and both weights
//   through a 4-slot cp.async ring, TM x 4 micro-tiles of both
//   accumulators -- whose K ranges (_build.ffn_split_f32, fixed by the
//   shape) meet in a thread block cluster through distributed shared
//   memory; M <= 8: a weight-streaming split-K kernel with the row count
//   templated (1 / 2 / 4 / 8) and 16-byte weight loads where F % 4 == 0.
//   Ragged M / F / K and unaligned weights are masked in the kernels.
//
// What bounds it here, at qwen2.5-3b's widths: bf16, the bytes of Wg + Wu
// -- 2 x 2048 x 11008 x 2 B = 90 MB a layer, at least 27 us at 3.35 TB/s --
// at decode and at the M = 48 prefill alike (the tensor cores do the
// prefill's 4.3 GFLOP in ~4 us); f32, twice the bytes (54 us) at decode and
// the FMAs at the M = 48 prefill (4.3 GFLOP at 67 TFLOP/s: 65 us).  So the
// designs stream both weights through one TMA ring into wgmma (bf16, and the
// K split keeps every SM's ring full), spread them over every SM with
// 16-byte loads (f32 decode), and keep every loaded x value busy for 8 FMAs
// (f32 prefill).

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "ffn_f32.cuh"
#include "mma_gemm.cuh"
#include "tiles.cuh"
#include "wgmma_gemm.cuh"

namespace {

// The bf16 kernels' epilogue: act(g) * u, one store.
template <typename T>
struct GateUpEpilogue {
  T* out;
  int F;
  int act;
  __device__ __forceinline__ void operator()(int m, int n, const float* v) const {
    out[(long long)m * F + n] = from_f32<T>(apply_act(act, v[0]) * v[1]);
  }
};

int run_f32(const void* x, const void* wg, const void* wu, void* out, int M, int F, int K,
            int act, void* ws, void* counters, int kchunk, int vec, int bm, cudaStream_t st) {
  const float* xf = static_cast<const float*>(x);
  const float* gf = static_cast<const float*>(wg);
  const float* uf = static_cast<const float*>(wu);
  float* of = static_cast<float*>(out);
  if (vec > 0) {
    return ffn_f32::launch_skinny(xf, gf, uf, of, M, F, K, kchunk, vec, act,
                                  static_cast<float*>(ws), static_cast<int*>(counters), st);
  }
  if (bm == 48) return ffn_f32::launch_tiled<48>(xf, gf, uf, of, M, F, K, kchunk, act, st);
  if (bm == 64) return ffn_f32::launch_tiled<64>(xf, gf, uf, of, M, F, K, kchunk, act, st);
  return (int)cudaErrorInvalidValue;
}

int run_bf16(const void* x, const void* wg, const void* wu, void* out, int M, int F, int K,
             int act, void* ws, void* counters, int kchunk, int use_wgmma, int bm, int bn,
             int bk, int depth, cudaStream_t st) {
  using B = __nv_bfloat16;
  const B* xb = static_cast<const B*>(x);
  const B* gb = static_cast<const B*>(wg);
  const B* ub = static_cast<const B*>(wu);
  const GateUpEpilogue<B> epi{static_cast<B*>(out), F, act};
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (use_wgmma) {
#define REPRO_TRY_TMA(BM, BN, BK, DEPTH)                                                     \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                                  \
    return (int)wgmma_gemm::launch_nw<BM, BN, BK, DEPTH, 2>(xb, gb, ub, out, M, F, K, kchunk, \
                                                           epi, st);                        \
  }
    REPRO_FFN_WGMMA_TILES(REPRO_TRY_TMA)
#undef REPRO_TRY_TMA
    return (int)cudaErrorInvalidValue;
  }
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                                   \
  if (bm == BM && bn == BN && bk == BK) {                                                   \
    return (int)mma_gemm::launch<BM, BN, BK, DEPTH, 2>(xb, gb, ub, M, F, K, kchunk, wsf, cnt, \
                                                       epi, st);                           \
  }
  REPRO_BF16_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = f32, 1 = bf16.
// * f32, vec > 0: the weight-streaming kernel (M <= 8) with vec columns
//   per lane (4 or 1), K ranges of kchunk rows and, with more than one
//   range, ws [ceil(K / kchunk), 2, M, F] and zeroed tile counters (one per
//   8 * vec columns; the kernel leaves them zeroed).
// * f32, vec == 0: the two-weight GEMM on a bm x 64 tile (bm 48 or 64), K
//   ranges of kchunk rows (a multiple of 16, at most 8 ranges; ws and
//   counters unused; bn, bk unused).
// * bf16 (vec unused), use_wgmma == 1: the two-weight wgmma body with the
//   tile (bm, bn, bk, depth), one of REPRO_FFN_WGMMA_TILES, K ranges of
//   kchunk rows (a multiple of 128, at most 8 ranges; ws, counters
//   unused); a launch TMA cannot address gives cudaErrorInvalidValue (the
//   wrapper's rule sends none).
// * bf16, use_wgmma == 0: the mma.sync kernel with the tile (bm, bn, bk),
//   one of REPRO_BF16_TILED_TILES (depth unused), K ranges of kchunk rows
//   and, with more than one range, ws [ceil(K / kchunk), 2, M, F] and
//   zeroed tile counters.
// A tile not built gives cudaErrorInvalidValue.
extern "C" int repro_ffn_gateup(const void* x, const void* wg, const void* wu, void* out,
                                int M, int F, int K, int act, int dtype, void* ws,
                                void* counters, int kchunk, int vec, int use_wgmma, int bm,
                                int bn, int bk, int depth, void* stream) {
  if (M < 0 || F < 0 || K < 0 || act < ACT_NONE || act > ACT_TANH || dtype < 0 || dtype > 1) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || F == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return run_f32(x, wg, wu, out, M, F, K, act, ws, counters, kchunk, vec, bm, st);
  }
  return run_bf16(x, wg, wu, out, M, F, K, act, ws, counters, kchunk, use_wgmma, bm, bn, bk,
                  depth, st);
}
