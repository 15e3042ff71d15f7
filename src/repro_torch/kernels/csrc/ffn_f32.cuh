// The f32 gate/up FFN bodies, for Hopper (sm_90a): out = act(x @ Wg) * (x @ Wu)
// with x [M, K], Wg / Wu [K, F] and out [M, F] row-major f32; both products
// accumulate in f32 FMAs on the CUDA cores (no TF32), the activation is
// applied to the gate sum and act(g) * u is stored once.  fused_ffn.cu
// launches them; the bf16 routes are csrc/wgmma_gemm.cuh and
// csrc/mma_gemm.cuh.
//
// M > 8 (prefill): ffn_gateup_simt_kernel<BM>, a two-weight GEMM.
//
// * A CTA of 128 threads covers a BM x 64 output tile (BM = 48 or 64, the
//   one that pads M less: the served prefills have 45 or 48 rows) over one
//   K range; K is walked in 16-deep slabs through a ring of 4 slots filled
//   by cp.async, three slabs in flight, one barrier a slab.  A slot holds
//   the x slab transposed ([16][BM + 4], 4-byte copies) and both weights'
//   slabs ([16][64 + 4], 16-byte copies where F and the pointers allow).
// * Warp w owns TM = BM / 4 rows of the tile and lane l its columns 2 l,
//   2 l + 1, of both accumulators (48 or 64 registers).  A k step reads the
//   warp's TM x values as float4 broadcasts (one address for every lane)
//   and the lane's two gate and two up weights (a conflict-free 256-byte
//   row a warp): 4 TM FMAs for TM / 4 + 2 shared-memory loads.  (A 6 x 4
//   micro-tile per thread -- as many loads per FMA, but 8 distinct x
//   addresses a warp and 4 distinct weight groups -- ran 1.5x slower at
//   qwen2.5-3b's prefill.)
// * K ranges (_build.ffn_split_f32, fixed by the shape): where the tiles
//   are too few to fill the card -- the smoke prefill has 4 -- K is split
//   into up to 8 ranges, and the splits of one tile form a thread block
//   cluster.  After its slabs each CTA parks its two f32 partial tiles in
//   its own shared memory; after one cluster barrier CTA `rank` sums its
//   share of the tile's rows over every split, in split order, through
//   distributed shared memory, applies act(g) * u and stores along F as
//   float4s.  No workspace, no counters, no float atomics: the result is
//   fixed by the shape.  One range is a cluster of one, the same code.
//
// M <= 8 (decode): ffn_gateup_skinny_kernel<VEC, MT>, weight streaming.
//
// * A block of 8 warps covers 8 * VEC columns: lane l owns VEC adjacent
//   columns (one 16-byte word of each weight row for VEC = 4, where F % 4
//   == 0 and both weights are 16-byte aligned; else VEC = 1) at column
//   group l % 8 and takes the K rows kb + 4 * warp + l / 8 + 32 i; each
//   lane issues 4 rows of both weights' loads before it uses any.
// * Only MT = M rounded up to 1, 2, 4 or 8 rows are staged and multiplied.
// * _build.skinny_plan_f32 splits K into a few long ranges for about two
//   blocks an SM; with more than one range every block writes its partial
//   tile to the f32 workspace ws[nsplit][2][M][F], and the block that
//   finishes a column tile last (an int counter per tile, which it resets
//   to 0 for the next launch) sums the ranges in order and stores.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "pipelined_gemm.cuh"

namespace ffn_f32 {

namespace cg = cooperative_groups;

// ---------------------------------------------------------------------------
// M > 8: the two-weight GEMM
// ---------------------------------------------------------------------------

constexpr int BN = 64;          // output columns a CTA covers
constexpr int BK = 16;          // K rows a slab
constexpr int DEPTH = 3;        // slabs in flight
constexpr int SLOTS = DEPTH + 1;
constexpr int WARPS = 4;
constexpr int NT = WARPS * 32;  // threads a CTA
constexpr int TN = BN / 32;     // columns a thread, per accumulator
constexpr int MAX_SPLIT = 8;    // CTAs of a cluster (the portable most)

template <int BM>
struct Tiled {
  static constexpr int TM = BM / WARPS;           // rows a warp (and each of its threads)
  static constexpr int AP = BM + 4;               // x slab row (k-major)
  static constexpr int WP = BN + 4;               // weight slab row
  static constexpr int SLOT = BK * AP + 2 * BK * WP;
  static constexpr int PART = 2 * BM * WP;        // the parked partial tiles
  static constexpr int FLOATS = SLOTS * SLOT > PART ? SLOTS * SLOT : PART;
  static constexpr int BYTES = FLOATS * (int)sizeof(float);
  static constexpr int XC = BM * BK / NT;         // x copies a thread a slab
  static_assert(TM % 4 == 0 && TN == 2, "float4 rows, float2 columns a thread");
  static_assert(NT % BK == 0 && BM % (NT / BK) == 0, "whole x rows a thread");
};

// Warp w owns rows w * TM .. w * TM + TM - 1 of the tile, and lane l
// columns 2 l, 2 l + 1: every x value a warp reads is one address for all
// its lanes (a broadcast), every weight pair a lane's own (a conflict-free
// 256-byte row a warp).  The copies' offsets advance by whole slabs, with
// no division in the loop.
template <int BM>
__global__ void __launch_bounds__(NT, 4)
    ffn_gateup_simt_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                           const float* __restrict__ wu, float* __restrict__ out, int M, int F,
                           int K, int kchunk, int act, int wvb, int vec_out) {
  using S = Tiled<BM>;
  constexpr int TM = S::TM, AP = S::AP, WP = S::WP, XC = S::XC;
  extern __shared__ __align__(16) float smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ntn = (F + BN - 1) / BN;
  const int m0 = (int)blockIdx.x / ntn * BM, n0 = (int)blockIdx.x % ntn * BN;
  const int kb = (int)blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const int nslab = ke > kb ? (ke - kb + BK - 1) / BK : 0;

  // x: k xk of the slab, rows xm + j * (NT / BK), 4-byte copies (x is
  // transposed on its way); weights: 16-byte chunks (a slab row is 16 of
  // them) or 4-byte elements, wvb says which
  const int xk = tid % BK, xm = tid / BK;
  const bool w16 = wvb == 16;
  // slab s of the range into slot s % SLOTS (copies issued, not committed)
  auto issue = [&](int s) {
    float* slot = smem + (s % SLOTS) * S::SLOT;
    const int k0 = kb + s * BK;
    const int k = k0 + xk;
#pragma unroll
    for (int j = 0; j < XC; ++j) {
      const int mm = xm + j * (NT / BK), m = m0 + mm;
      const bool ok = k < ke && m < M;
      pipelined::cp_async4(slot + xk * AP + mm, x + (ok ? m * K + k : 0), ok ? 4 : 0);
    }
    float* gsl = slot + BK * AP;
    float* usl = gsl + BK * WP;
    if (w16) {
#pragma unroll
      for (int i = 0; i < BK * BN / 4 / NT; ++i) {
        const int c = tid + i * NT, kk = c / (BN / 4), nn = c % (BN / 4) * 4;
        const bool ok = k0 + kk < ke && n0 + nn < F;
        const int off = ok ? (k0 + kk) * F + n0 + nn : 0;
        pipelined::cp_async16(gsl + kk * WP + nn, wg + off, ok ? 16 : 0);
        pipelined::cp_async16(usl + kk * WP + nn, wu + off, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < BK * BN / NT; ++i) {
        const int c = tid + i * NT, kk = c / BN, nn = c % BN;
        const bool ok = k0 + kk < ke && n0 + nn < F;
        const int off = ok ? (k0 + kk) * F + n0 + nn : 0;
        pipelined::cp_async4(gsl + kk * WP + nn, wg + off, ok ? 4 : 0);
        pipelined::cp_async4(usl + kk * WP + nn, wu + off, ok ? 4 : 0);
      }
    }
  };

  float ag[TM][TN], au[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) ag[i][j] = au[i][j] = 0.f;

#pragma unroll
  for (int p = 0; p < DEPTH; ++p) {
    if (p < nslab) issue(p);
    pipelined::cp_async_commit();
  }
  for (int s = 0; s < nslab; ++s) {
    pipelined::cp_async_wait<DEPTH - 1>();  // slab s's copies (this thread's) landed
    __syncthreads();  // ... every thread's; slab s - 1's readers are done with its slot
    if (s + DEPTH < nslab) issue(s + DEPTH);
    pipelined::cp_async_commit();
    const float* as = smem + (s % SLOTS) * S::SLOT + warp * TM;
    const float* gs = smem + (s % SLOTS) * S::SLOT + BK * AP + 2 * lane;
    const float* us = gs + BK * WP;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int q = 0; q < TM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(as + kk * AP + 4 * q);
        a[4 * q] = v.x;
        a[4 * q + 1] = v.y;
        a[4 * q + 2] = v.z;
        a[4 * q + 3] = v.w;
      }
      const float2 gv = *reinterpret_cast<const float2*>(gs + kk * WP);
      const float2 uv = *reinterpret_cast<const float2*>(us + kk * WP);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        ag[i][0] = fmaf(a[i], gv.x, ag[i][0]);
        ag[i][1] = fmaf(a[i], gv.y, ag[i][1]);
        au[i][0] = fmaf(a[i], uv.x, au[i][0]);
        au[i][1] = fmaf(a[i], uv.y, au[i][1]);
      }
    }
  }
  pipelined::cp_async_wait<0>();  // the tail groups are empty
  __syncthreads();                // the ring is free: it holds the partial tiles now

  float* pg = smem;            // [BM][WP] gate sums of this range
  float* pu = smem + BM * WP;  // [BM][WP] up sums
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = warp * TM + i;
    *reinterpret_cast<float2*>(pg + r * WP + 2 * lane) = make_float2(ag[i][0], ag[i][1]);
    *reinterpret_cast<float2*>(pu + r * WP + 2 * lane) = make_float2(au[i][0], au[i][1]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();

  // CTA `rank` sums rows [r0, r1) of the live tile over the splits, in
  // split order, a float4 group at a time with every split's pair of
  // partials requested before any is added
  const int nsplit = gridDim.y;
  const int rank = blockIdx.y;  // the cluster spans gridDim.y
  const int live = min(BM, M - m0);
  const int chunk = (live + nsplit - 1) / nsplit;
  const int r0 = rank * chunk, r1 = min(live, r0 + chunk);
  constexpr int G4 = BN / 4;
  const int groups = max(r1 - r0, 0) * G4;
  for (int e = tid; e < groups; e += NT) {
    const int r = r0 + e / G4, c = (e % G4) * 4;
    const int n = n0 + c;
    if (n >= F) continue;
    float4 sg[MAX_SPLIT], su[MAX_SPLIT];
#pragma unroll
    for (int sp = 0; sp < MAX_SPLIT; ++sp) {
      if (sp < nsplit) {
        sg[sp] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pg + r * WP + c, sp));
        su[sp] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(pu + r * WP + c, sp));
      }
    }
    float4 g = sg[0], u = su[0];
#pragma unroll
    for (int sp = 1; sp < MAX_SPLIT; ++sp) {
      if (sp < nsplit) {
        g.x += sg[sp].x;
        g.y += sg[sp].y;
        g.z += sg[sp].z;
        g.w += sg[sp].w;
        u.x += su[sp].x;
        u.y += su[sp].y;
        u.z += su[sp].z;
        u.w += su[sp].w;
      }
    }
    const float v[4] = {apply_act(act, g.x) * u.x, apply_act(act, g.y) * u.y,
                        apply_act(act, g.z) * u.z, apply_act(act, g.w) * u.w};
    float* o = out + (long long)(m0 + r) * F + n;
    if (vec_out && n + 3 < F) {
      *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (n + q < F) o[q] = v[q];
    }
  }
  cluster.sync();  // no CTA leaves while another reads its tiles
}

template <int BM>
int launch_tiled(const float* x, const float* wg, const float* wu, float* out, int M, int F,
                 int K, int kchunk, int act, cudaStream_t st) {
  using S = Tiled<BM>;
  auto kernel = ffn_gateup_simt_kernel<BM>;
  if (kchunk < BK || kchunk % BK) return (int)cudaErrorInvalidValue;
  const int nsplit = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (nsplit > MAX_SPLIT) return (int)cudaErrorInvalidValue;
  // the bodies' offsets are 32-bit
  const long long lim = 1LL << 31;
  if ((long long)M * K >= lim || (long long)K * F >= lim) return (int)cudaErrorInvalidValue;
  const int wvb = min(pipelined::copy_bytes(wg, (long long)F * 4),
                      pipelined::copy_bytes(wu, (long long)F * 4));
  if (wvb == 0) return (int)cudaErrorInvalidValue;
  const int vec_out = F % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if constexpr (S::BYTES > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (long long)((M + BM - 1) / BM) * ((F + BN - 1) / BN);
  if (tiles >= lim) return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)tiles, nsplit, 1);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = S::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = nsplit;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, x, wg, wu, out, M, F, K, kchunk, act, wvb, vec_out);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M <= 8: weight streaming
// ---------------------------------------------------------------------------

constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = SK_WARPS * 32;
constexpr int SK_ROWS = SK_WARPS * 4;  // K rows a block covers per step
constexpr int SK_UNROLL = 4;           // rows of loads in flight a lane (x 2 weights)
constexpr int SK_KC = 1024;            // most K rows a range stages (_build.SKINNY_KC)
constexpr int SK_MAX_M = 8;

// VEC adjacent f32 weights of one row: one 16-byte or one 4-byte load.
template <int VEC>
struct Raw;
template <>
struct Raw<4> {
  float4 v;
  __device__ __forceinline__ void load(const float* p) {
    v = __ldg(reinterpret_cast<const float4*>(p));
  }
  __device__ __forceinline__ float operator[](int j) const {
    return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
  }
};
template <>
struct Raw<1> {
  float v;
  __device__ __forceinline__ void load(const float* p) { v = __ldg(p); }
  __device__ __forceinline__ float operator[](int) const { return v; }
};

template <int VEC, int MT>
struct SkSmem {
  static constexpr int XS = MT * SK_KC;                    // x rows of the range
  static constexpr int RED = SK_WARPS * 2 * MT * 8 * VEC;  // the warps' partial sums
  static constexpr int FLOATS = XS > RED ? XS : RED;       // one buffer, used in turn
};

template <int VEC, int MT>
__global__ void __launch_bounds__(SK_THREADS)
    ffn_gateup_skinny_kernel(const float* __restrict__ x, const float* __restrict__ wg,
                             const float* __restrict__ wu, float* __restrict__ out, int M, int F,
                             int K, int kchunk, int act, float* __restrict__ ws,
                             int* __restrict__ counters) {
  constexpr int BNS = 8 * VEC;
  __shared__ __align__(16) float buf[SkSmem<VEC, MT>::FLOATS];
  __shared__ int s_last;
  float* xs = buf;   // [MT][SK_KC] during the loop
  float* red = buf;  // [SK_WARPS][2][MT][BNS] after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cgp = lane & 7;  // column group
  const int rg = lane >> 3;  // row within the warp's 4
  const int n0 = blockIdx.x * BNS;
  const int kb = blockIdx.y * kchunk;
  const int ke = min(K, kb + kchunk);
  const int kn = max(ke - kb, 0);

  for (int e = tid; e < MT * kn; e += SK_THREADS) {
    const int mm = e / kn, kk = e % kn;
    xs[mm * SK_KC + kk] = mm < M ? x[mm * K + kb + kk] : 0.f;
  }
  __syncthreads();

  const int nc = n0 + cgp * VEC;
  const bool live = nc < F;  // VEC = 4 only when F % 4 == 0 (host)
  float acc[2][MT][VEC];
#pragma unroll
  for (int wi = 0; wi < 2; ++wi)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[wi][m][j] = 0.f;

  auto fma_row = [&](const Raw<VEC>& g, const Raw<VEC>& u, int k) {
    float xv[MT];
#pragma unroll
    for (int m = 0; m < MT; ++m) xv[m] = xs[m * SK_KC + (k - kb)];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[0][m][j] = fmaf(xv[m], g[j], acc[0][m][j]);
        acc[1][m][j] = fmaf(xv[m], u[j], acc[1][m][j]);
      }
  };

  if (live) {
    int k = kb + warp * 4 + rg;
    for (; k + (SK_UNROLL - 1) * SK_ROWS < ke; k += SK_UNROLL * SK_ROWS) {
      Raw<VEC> g[SK_UNROLL], u[SK_UNROLL];
#pragma unroll
      for (int q = 0; q < SK_UNROLL; ++q) {
        g[q].load(wg + (k + q * SK_ROWS) * F + nc);
        u[q].load(wu + (k + q * SK_ROWS) * F + nc);
      }
#pragma unroll
      for (int q = 0; q < SK_UNROLL; ++q) fma_row(g[q], u[q], k + q * SK_ROWS);
    }
    for (; k < ke; k += SK_ROWS) {
      Raw<VEC> g, u;
      g.load(wg + k * F + nc);
      u.load(wu + k * F + nc);
      fma_row(g, u, k);
    }
  }

  // the warp's four row groups (lanes cgp, cgp + 8, cgp + 16, cgp + 24)
#pragma unroll
  for (int wi = 0; wi < 2; ++wi)
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
    for (int wi = 0; wi < 2; ++wi)
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          red[((warp * 2 + wi) * MT + m) * BNS + cgp * VEC + j] = acc[wi][m][j];
  }
  __syncthreads();

  // thread e of MT * BNS owns output (m, c) = (e / BNS, e % BNS): the
  // block's sum over the warps, in warp order
  auto block_sum = [&](int e, float (&v)[2]) {
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      const float* r = red + wi * MT * BNS + e;
      float s = r[0];
#pragma unroll
      for (int w = 1; w < SK_WARPS; ++w) s += r[w * 2 * MT * BNS];
      v[wi] = s;
    }
  };

  const int nsplit = gridDim.y;
  if (nsplit == 1) {
    for (int e = tid; e < MT * BNS; e += SK_THREADS) {
      const int m = e / BNS, n = n0 + e % BNS;
      if (m >= M || n >= F) continue;
      float v[2];
      block_sum(e, v);
      out[m * F + n] = apply_act(act, v[0]) * v[1];
    }
    return;
  }

  for (int e = tid; e < MT * BNS; e += SK_THREADS) {
    const int m = e / BNS, n = n0 + e % BNS;
    if (m >= M || n >= F) continue;
    float v[2];
    block_sum(e, v);
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) ws[(((long long)blockIdx.y * 2 + wi) * M + m) * F + n] = v[wi];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&counters[blockIdx.x], 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const long long stride = 2LL * M * F;
  for (int e = tid; e < MT * BNS; e += SK_THREADS) {
    const int m = e / BNS, n = n0 + e % BNS;
    if (m >= M || n >= F) continue;
    float v[2];
#pragma unroll
    for (int wi = 0; wi < 2; ++wi) {
      const float* p = ws + ((long long)wi * M + m) * F + n;
      float s = __ldcg(p);
      for (int sp = 1; sp < nsplit; ++sp) s += __ldcg(p + sp * stride);
      v[wi] = s;
    }
    out[m * F + n] = apply_act(act, v[0]) * v[1];
  }
  if (tid == 0) counters[blockIdx.x] = 0;  // ready for the next launch
}

template <int VEC, int MT>
cudaError_t launch_mt(const float* x, const float* wg, const float* wu, float* out, int M, int F,
                      int K, int kchunk, int act, float* ws, int* counters, cudaStream_t st) {
  const int nsplit = (K + kchunk - 1) / kchunk;
  const dim3 grid((F + 8 * VEC - 1) / (8 * VEC), nsplit);
  ffn_gateup_skinny_kernel<VEC, MT>
      <<<grid, SK_THREADS, 0, st>>>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_vec(const float* x, const float* wg, const float* wu, float* out, int M,
                       int F, int K, int kchunk, int act, float* ws, int* counters,
                       cudaStream_t st) {
  if (M <= 1) return launch_mt<VEC, 1>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
  if (M <= 2) return launch_mt<VEC, 2>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
  if (M <= 4) return launch_mt<VEC, 4>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
  return launch_mt<VEC, 8>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
}

// Host side: check a skinny launch's arguments (M <= 8, a range within the
// x stage, ws and counters when K spans several ranges, VEC = 4 only on
// 16-byte aligned rows) and launch it.
inline int launch_skinny(const float* x, const float* wg, const float* wu, float* out, int M,
                         int F, int K, int kchunk, int vec, int act, float* ws, int* counters,
                         cudaStream_t st) {
  if (M < 1 || M > SK_MAX_M || K < 1 || kchunk < 1 || kchunk > SK_KC) {
    return (int)cudaErrorInvalidValue;
  }
  if ((long long)K * F >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int nsplit = (K + kchunk - 1) / kchunk;
  if (nsplit > 65535 || (nsplit > 1 && (ws == nullptr || counters == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (vec == 4) {
    const bool aligned = reinterpret_cast<uintptr_t>(wg) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(wu) % 16 == 0;
    if (F % 4 || !aligned) return (int)cudaErrorInvalidValue;
    return (int)launch_vec<4>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
  }
  if (vec != 1) return (int)cudaErrorInvalidValue;
  return (int)launch_vec<1>(x, wg, wu, out, M, F, K, kchunk, act, ws, counters, st);
}

}  // namespace ffn_f32
