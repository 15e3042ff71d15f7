// Flash attention (forward) for Hopper (sm_90a), GQA-aware, optional lengths.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:
// flash_attention_kernel (no lengths) and _flash_attention_kernel_len
// (valid-prefix mask col < length): one entry point, `lengths` may be null.
//
//   q [B, H, Sq, D], k / v [B, G, Skv, D] (H % G == 0: query head h reads
//   KV group h / (H / G), the grouping of the executor's _attn_heads), any
//   strides over (batch, head, seq) with a unit stride over D; out [B, H,
//   Sq, D] in q's type, strided the same way.  TQ is q's and out's type, TKV
//   k's and v's (the decode merge hands bf16 queries and f32 cache spans);
//   every score, p and the (m, l, acc) recurrence are f32, as the TPU
//   kernel keeps them.
//
// Semantics of the TPU kernel: scores q.k * scale (1/sqrt(D) unless given),
// masked to -1e30 -- causal keeps col <= row (top-left aligned), lengths
// keep col < length -- online softmax over the keys, out = acc / max(l,
// 1e-30).  A masked score is -1e30, not -inf: a row whose every key is
// masked (length 0) averages V uniformly and stays finite.  Keys that are
// masked for a row are skipped (the TPU grid runs them); whenever the row
// has one valid key, a skipped key would have added exp(-1e30 - m) = 0, so
// the result is the same.  Only a row with length 0 has no valid key, and
// it takes every key at score -1e30, as the reference does.  The split and
// tensor-core bodies run the softmax in base 2 (scores times scale * log2 e,
// exp2), which is the same function.
//
// Three bodies; the wrapper's plan (kernels/flash_attention.py:plan) picks
// one from the shape alone:
//
// * split (split_kv::, Sq <= 8, every type pair: decode).  What bounds it
//   is the K / V bytes of the span, and at B = 3 a span of 1024 keys is
//   only 6 (b, group) pairs.  So one CTA owns (b, group, key split): it
//   stages its split's K / V rows once with 16-byte cp.async copies (only
//   up to the longest valid row), scores all H / G heads x Sq query rows of
//   the group against them -- K / V are read once per group, not once per
//   head -- a lane a key (16-byte shared loads, conflict-free on the padded
//   rows), then p and p V a lane a slice of d.  Each split writes (m, l,
//   acc[D]) partials to an f32 workspace, and a combine kernel merges them
//   in split order, skipping empty partials (a split past a row's length or
//   above its diagonal), so every run gives the same bits.  The split count
//   is fixed by (B, G, Skv): about one CTA for every two SMs at any batch
//   (more, smaller splits measured slower: each CTA stages q and passes
//   three barriers, and the combine reads every partial).  One split
//   writes the output itself (no combine launch).
// * tensor_core (tc::, bf16 q and k / v, more rows: prefill).  A CTA of 4
//   warps owns 64 query rows of one (b, group), the rows of the group's
//   heads stacked (row t = s * H/G + head) so that one K / V tile serves
//   every head and a tile's rows are close in s; ldmatrix + mma.sync
//   m16n8k16 (bf16 x bf16 products are exact, f32 sums) computes Q K^T, the
//   online softmax stays in registers, and P V runs as two mmas on P's bf16
//   hi and lo parts, so P keeps ~16 bits, close to the f32 of the TPU
//   kernel.  K / V tiles of 64 keys go through a cp.async double buffer;
//   tiles past every row's length or above the causal diagonal are never
//   loaded, and a warp skips the tiles wholly above its own rows.  What
//   bounds it is the latency of that chain, not bytes or operations.
// * simt (Sq > 8 with f32 k / v, or operands not 16-byte aligned: the
//   smoke decoder's f32 prefill).  A block of 4 warps owns up to 4 query
//   rows of one (b, h); each row's key range is split over 4 / R warps,
//   a warp walks its part 8 keys at a time (a lane holds D / 32 elements;
//   the 8 dot products meet by shuffles), and the parts combine in order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"
#include "mma_gemm.cuh"
#include "pipelined_gemm.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -1e30f;  // the TPU kernel's masked score
constexpr float LOG2E = 1.4426950408889634f;

struct Strides {
  long long b, h, s;
};

// The valid keys of batch row b: query row s reads keys [0, end(s)).  A row
// with length 0 reads every key at score -1e30 (all_masked).
struct RowMask {
  int len, skv, causal;
  bool all_masked;
  __device__ __forceinline__ int end(int s) const {
    if (all_masked) return skv;
    int e = min(skv, len);
    if (causal) e = min(e, s + 1);
    return e;
  }
};

__device__ __forceinline__ RowMask row_mask(const int* lengths, int b, int skv, int causal) {
  RowMask r;
  r.skv = skv;
  r.causal = causal;
  r.len = lengths ? lengths[b] : skv;
  r.all_masked = lengths != nullptr && r.len <= 0;
  return r;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// N consecutive elements of T at p (shared memory, aligned to the load) as f32.
template <typename T, int N>
__device__ __forceinline__ void lds_vec(const T* p, float (&out)[N]) {
  constexpr int BYTES = N * (int)sizeof(T);
  constexpr int PW = Elem<T>::PER_WORD;
  if constexpr (BYTES == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(p);
    Elem<T>::unpack(r.x, out);
    Elem<T>::unpack(r.y, out + PW);
    Elem<T>::unpack(r.z, out + 2 * PW);
    Elem<T>::unpack(r.w, out + 3 * PW);
  } else if constexpr (BYTES == 8) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    Elem<T>::unpack(r.x, out);
    Elem<T>::unpack(r.y, out + PW);
  } else if constexpr (BYTES == 4) {
    Elem<T>::unpack(*reinterpret_cast<const unsigned*>(p), out);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

// =========================================================================
// split: split-KV decode
// =========================================================================
namespace split_kv {

constexpr int NT = 128;
constexpr int MAX_ROWS = 64;   // H / G x Sq rows a CTA (kernels/flash_attention.py)
constexpr int MAX_CHUNK = 128;  // keys a split
constexpr int ALIGN = 16;      // a split's keys are a multiple of this

template <int D, typename TKV>
struct Shape {
  static constexpr int VE = 16 / (int)sizeof(TKV);  // elements of a 16-byte word
  static constexpr int KP = D + VE;                 // K / V row in shared memory (16-byte pad)
  static constexpr int QP = D + 4;                  // staged q row (f32)
  static constexpr int VD = D / 32;                 // d elements a lane in p V
  static size_t bytes(int rows8, int chunk) {
    return (size_t)2 * chunk * KP * sizeof(TKV) + (size_t)rows8 * QP * sizeof(float) +
           (size_t)rows8 * chunk * sizeof(float) + (size_t)2 * rows8 * sizeof(float);
  }
};

// One CTA: (split, group, batch row).  work holds nrows * nsplit * D
// partial accumulators, then nrows * nsplit (m, l) pairs (nrows = B * H *
// Sq, row index (b * H + h) * Sq + s); with one split the CTA writes out.
template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(NT)
    flash_attention_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                 const TKV* __restrict__ v, TQ* __restrict__ out,
                                 float* __restrict__ work, const int* __restrict__ lengths, int H,
                                 int G, int Sq, int Skv, int chunk, float scale_log2, int causal,
                                 Strides qs, Strides ks, Strides vs, Strides os) {
  using Sh = Shape<D, TKV>;
  constexpr int VE = Sh::VE, KP = Sh::KP, QP = Sh::QP, VD = Sh::VD;
  constexpr int CPR = D * (int)sizeof(TKV) / 16;  // 16-byte copies a K / V row
  extern __shared__ __align__(16) unsigned char smem[];

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = H / G;
  const int R = rg * Sq;  // the group's query rows: row r = s * rg + head
  const int R8 = (R + 7) & ~7;
  const int j0 = split * chunk;
  const RowMask rm = row_mask(lengths, b, Skv, causal);
  // keys any row of the CTA reads (end() grows with s)
  const int kv_hi = min(min(Skv, j0 + chunk), rm.end(Sq - 1));
  const int n = max(kv_hi - j0, 0);  // live keys of this split
  float* ml = work + (size_t)gridDim.z * H * Sq * nsplit * D;
  auto row_index = [&](int r) {  // (b * H + h) * Sq + s of stacked row r
    const int s = r / rg;
    return ((long long)b * H + g * rg + (r - s * rg)) * Sq + s;
  };

  if (n == 0 && nsplit > 1) {  // past every row's length / diagonal: empty partials
    for (int r = tid; r < R; r += NT) {
      float* p = ml + (row_index(r) * nsplit + split) * 2;
      p[0] = -INFINITY;
      p[1] = 0.f;
    }
    return;
  }

  TKV* ksm = reinterpret_cast<TKV*>(smem);
  TKV* vsm = ksm + chunk * KP;
  float* qsm = reinterpret_cast<float*>(vsm + chunk * KP);
  float* ssm = qsm + R8 * QP;  // [R8][chunk] scores, then p
  float* msm = ssm + R8 * chunk;
  float* lsm = msm + R8;

  // stage the live K / V rows (16-byte copies), then q (scaled, f32)
  const TKV* kb = k + b * ks.b + g * ks.h;
  const TKV* vb = v + b * vs.b + g * vs.h;
  for (int e = tid; e < n * CPR; e += NT) {
    const int c = e / CPR, w = (e - c * CPR) * VE;
    pipelined::cp_async16(ksm + c * KP + w, kb + (long long)(j0 + c) * ks.s + w, 16);
    pipelined::cp_async16(vsm + c * KP + w, vb + (long long)(j0 + c) * vs.s + w, 16);
  }
  pipelined::cp_async_commit();
  constexpr int VQ = 16 / (int)sizeof(TQ);  // q elements of a 16-byte load
  for (int e = tid; e < R8 * (D / VQ); e += NT) {
    const int r = e / (D / VQ), c = (e - r * (D / VQ)) * VQ;
    float val[VQ];
    if (r < R) {
      const int s = r / rg;
      load_vec<TQ, VQ>(q + b * qs.b + (long long)(g * rg + r - s * rg) * qs.h + s * qs.s + c,
                       val);
    } else {
#pragma unroll
      for (int x = 0; x < VQ; ++x) val[x] = 0.f;
    }
#pragma unroll
    for (int x = 0; x < VQ; x += 4)
      *reinterpret_cast<float4*>(qsm + r * QP + c + x) =
          make_float4(val[x] * scale_log2, val[x + 1] * scale_log2, val[x + 2] * scale_log2,
                      val[x + 3] * scale_log2);
  }
  pipelined::cp_async_wait<0>();
  __syncthreads();

  // scores: a warp takes (RB rows, 32 keys) items, a lane one key (two rows
  // an item, so that one to four warps have work at decode's 8 rows)
  constexpr int RB = 2;
  const int KG = (n + 31) / 32;
  for (int it = warp; it < (R8 / RB) * KG; it += NT / 32) {
    const int rb = it / KG, c = (it - rb * KG) * 32 + lane;
    if (c >= n) continue;
    float acc[RB];
#pragma unroll
    for (int i = 0; i < RB; ++i) acc[i] = 0.f;
    const TKV* kr = ksm + c * KP;
    const float* q0 = qsm + rb * RB * QP;
#pragma unroll 4
    for (int e = 0; e < D; e += VE) {
      float kv[VE];
      lds_vec<TKV, VE>(kr + e, kv);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
#pragma unroll
        for (int x = 0; x < VE; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(q0 + i * QP + e + x);
          acc[i] = fmaf(qv.x, kv[x], acc[i]);
          acc[i] = fmaf(qv.y, kv[x + 1], acc[i]);
          acc[i] = fmaf(qv.z, kv[x + 2], acc[i]);
          acc[i] = fmaf(qv.w, kv[x + 3], acc[i]);
        }
      }
    }
    const int j = j0 + c;
#pragma unroll
    for (int i = 0; i < RB; ++i) {
      const int r = rb * RB + i;
      const float sc = rm.all_masked ? NEG_INF : (j < rm.end(r / rg) ? acc[i] : -INFINITY);
      ssm[r * chunk + c] = sc;
    }
  }
  __syncthreads();

  // p = exp2(s - m) over the split's keys, a warp a row
  for (int r = warp; r < R8; r += NT / 32) {
    float* sr = ssm + r * chunk;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, sr[c]);
    mx = warp_max(mx);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = exp2f(sr[c] - mu);
      sr[c] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      msm[r] = mx;
      lsm[r] = sum;
    }
  }
  __syncthreads();

  // p V: a warp four rows at a time, a lane D / 32 elements of d
  for (int r0 = warp; r0 < R; r0 += 4 * (NT / 32)) {
    float acc[4][VD];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int x = 0; x < VD; ++x) acc[i][x] = 0.f;
    for (int c = 0; c < n; ++c) {
      float vv[VD];
      lds_vec<TKV, VD>(vsm + c * KP + lane * VD, vv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = min(r0 + i * (NT / 32), R8 - 1);
        const float p = ssm[r * chunk + c];
#pragma unroll
        for (int x = 0; x < VD; ++x) acc[i][x] = fmaf(p, vv[x], acc[i][x]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i * (NT / 32);
      if (r >= R) break;
      const long long row = row_index(r);
      if (nsplit == 1) {
        const float inv = 1.f / fmaxf(lsm[r], 1e-30f);
        const int s = r / rg;
        TQ* op = out + b * os.b + (long long)(g * rg + r - s * rg) * os.h + s * os.s + lane * VD;
#pragma unroll
        for (int x = 0; x < VD; ++x) op[x] = from_f32<TQ>(acc[i][x] * inv);
      } else {
        float* wp = work + (row * nsplit + split) * D + lane * VD;
#pragma unroll
        for (int x = 0; x < VD; ++x) wp[x] = acc[i][x];
        if (lane == 0) {
          float* p = ml + (row * nsplit + split) * 2;
          p[0] = msm[r];
          p[1] = lsm[r];
        }
      }
    }
  }
}

// Merge the splits of each row in split order, a warp a row: empty
// partials (l = 0) are skipped, the rest weighted by exp2(m - max m).  The
// lanes read 32 splits' (m, l) at once and broadcast each split's weight;
// every lane sums its slice of d over the splits in order, its loads of
// the partials issued ahead (an empty split's slice is read, never used).
template <int D, typename TQ>
__global__ void __launch_bounds__(NT)
    flash_attention_combine_kernel(const float* __restrict__ work, TQ* __restrict__ out,
                                   int nrows, int H, int Sq, int nsplit, Strides os) {
  constexpr int VD = D / 32;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (NT / 32) + (threadIdx.x >> 5);
  if (row >= nrows) return;
  const float* ml = work + (size_t)nrows * nsplit * D + (size_t)row * nsplit * 2;
  float mx = -INFINITY;
  for (int sp = lane; sp < nsplit; sp += 32) {
    const float2 p = *reinterpret_cast<const float2*>(ml + 2 * sp);
    if (p.y > 0.f) mx = fmaxf(mx, p.x);
  }
  mx = warp_max(mx);
  float l = 0.f, acc[VD];
#pragma unroll
  for (int x = 0; x < VD; ++x) acc[x] = 0.f;
  const float* wp = work + (size_t)row * nsplit * D + lane * VD;
  for (int base = 0; base < nsplit; base += 32) {
    const int sp = base + lane;
    float w = 0.f, ls = 0.f;
    if (sp < nsplit) {
      const float2 p = *reinterpret_cast<const float2*>(ml + 2 * sp);
      if (p.y > 0.f) {
        w = exp2f(p.x - mx);
        ls = p.y;
      }
    }
    const int n = min(32, nsplit - base);
#pragma unroll 8
    for (int j = 0; j < n; ++j) {
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float lj = __shfl_sync(0xffffffffu, ls, j);
      float a[VD];
      load_vec<float, VD>(wp + (size_t)(base + j) * D, a);
      if (wj > 0.f) {
        l = fmaf(lj, wj, l);
#pragma unroll
        for (int x = 0; x < VD; ++x) acc[x] = fmaf(a[x], wj, acc[x]);
      }
    }
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  const int s = row % Sq;
  const int bh = row / Sq;
  TQ* op = out + (bh / H) * os.b + (long long)(bh % H) * os.h + s * os.s + lane * VD;
#pragma unroll
  for (int x = 0; x < VD; ++x) op[x] = from_f32<TQ>(acc[x] * inv);
}

template <int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, float* work,
           const int* lengths, int B, int H, int G, int Sq, int Skv, int nsplit, int chunk,
           float scale_log2, int causal, const Strides& qs, const Strides& ks,
           const Strides& vs, const Strides& os, cudaStream_t st) {
  using Sh = Shape<D, TKV>;
  const int R8 = ((H / G) * Sq + 7) & ~7;
  const size_t smem = Sh::bytes(R8, chunk);
  auto kernel = flash_attention_split_kernel<D, TQ, TKV>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Sh::bytes(MAX_ROWS, MAX_CHUNK));
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<dim3(nsplit, G, B), NT, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), work, lengths, H, G, Sq, Skv, chunk, scale_log2, causal, qs, ks, vs,
      os);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  const int nrows = B * H * Sq;
  flash_attention_combine_kernel<D, TQ><<<(nrows + NT / 32 - 1) / (NT / 32), NT, 0, st>>>(
      work, static_cast<TQ*>(out), nrows, H, Sq, nsplit, os);
  return (int)cudaGetLastError();
}

}  // namespace split_kv

// =========================================================================
// tensor_core: bf16 prefill on mma.sync
// =========================================================================
namespace tc {

constexpr int NT = 128;  // 4 warps, 16 query rows each
constexpr int BM = 64;   // stacked query rows a CTA
constexpr int KT = 64;   // keys a K / V tile

template <int D>
struct Shape {
  static constexpr int P = D + 8;  // shared row (16-byte pad: ldmatrix rows on distinct banks)
  static constexpr size_t BYTES = (size_t)(BM + 4 * KT) * P * sizeof(bf16);  // Q + 2 x (K, V)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int D>
__global__ void __launch_bounds__(NT)
    flash_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                              const bf16* __restrict__ v, bf16* __restrict__ out,
                              const int* __restrict__ lengths, int H, int G, int Sq, int Skv,
                              float scale_log2, int causal, Strides qs, Strides ks, Strides vs,
                              Strides os) {
  constexpr int P = Shape<D>::P;
  constexpr int CPR = D / 8;   // 16-byte copies a row
  constexpr int DK = D / 16;   // k16 steps over d (Q K^T)
  constexpr int DN = D / 8;    // n8 blocks over d (P V)
  constexpr int KN = KT / 8;   // n8 blocks over a tile's keys
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BM * P;      // [2][KT][P]
  bf16* Vs = Ks + 2 * KT * P;  // [2][KT][P]

  const int g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = H / G;
  const int R = rg * Sq;
  const int t0 = blockIdx.x * BM;
  const RowMask rm = row_mask(lengths, b, Skv, causal);
  auto s_of = [&](int t) { return min(t, R - 1) / rg; };
  const int kv_hi = rm.end(s_of(t0 + BM - 1));  // keys any row of the CTA reads
  const int ntiles = (kv_hi + KT - 1) / KT;

  // stage the CTA's query rows (zero past R) and the first K / V tile
  for (int e = tid; e < BM * CPR; e += NT) {
    const int r = e / CPR, c = (e - r * CPR) * 8;
    const int t = t0 + r, s = t / rg;
    const bool ok = t < R;
    const bf16* src = ok ? q + b * qs.b + (long long)(g * rg + t - s * rg) * qs.h + s * qs.s + c
                         : q;
    pipelined::cp_async16(Qs + r * P + c, src, ok ? 16 : 0);
  }
  const bf16* kb = k + b * ks.b + g * ks.h;
  const bf16* vb = v + b * vs.b + g * vs.h;
  auto issue_kv = [&](int j) {
    bf16* kd = Ks + (j & 1) * KT * P;
    bf16* vd = Vs + (j & 1) * KT * P;
    for (int e = tid; e < KT * CPR; e += NT) {
      const int r = e / CPR, c = (e - r * CPR) * 8;
      const int key = j * KT + r;
      const bool ok = key < kv_hi;
      pipelined::cp_async16(kd + r * P + c, ok ? kb + (long long)key * ks.s + c : kb, ok ? 16 : 0);
      pipelined::cp_async16(vd + r * P + c, ok ? vb + (long long)key * vs.s + c : vb, ok ? 16 : 0);
    }
  };
  if (ntiles > 0) issue_kv(0);
  pipelined::cp_async_commit();

  // this thread's accumulator rows: ra (elements 0, 1) and ra + 8 (2, 3)
  const int ra = t0 + warp * 16 + (lane >> 2);
  const int end_a = rm.end(s_of(ra)), end_b = rm.end(s_of(ra + 8));
  const int warp_lo = rm.end(s_of(t0 + warp * 16));
  const int warp_hi = rm.end(s_of(t0 + warp * 16 + 15));

  uint32_t qf[DK][4];
  float o[DN][4];
#pragma unroll
  for (int i = 0; i < DN; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int j = 0; j < ntiles; ++j) {
    if (j + 1 < ntiles) issue_kv(j + 1);
    pipelined::cp_async_commit();
    pipelined::cp_async_wait<1>();
    __syncthreads();  // Q (j = 0) and tile j landed
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DK; ++kk)
        mma_gemm::ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * P + kk * 16 +
                                           (lane >> 4) * 8);
    }
    const int kbase = j * KT;
    if (kbase < warp_hi) {
      const bf16* kt = Ks + (j & 1) * KT * P;
      const bf16* vt = Vs + (j & 1) * KT * P;
      float sacc[KN][4];
#pragma unroll
      for (int n = 0; n < KN; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
      // S = Q K^T: K rows [key][d] are the mma's col-major B
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
        for (int np = 0; np < KN / 2; ++np) {
          uint32_t kf[4];
          mma_gemm::ldmatrix_x4(kf, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                                        kk * 16 + ((lane >> 3) & 1) * 8);
          mma_gemm::mma_m16n8k16(sacc[2 * np], qf[kk], kf[0], kf[1]);
          mma_gemm::mma_m16n8k16(sacc[2 * np + 1], qf[kk], kf[2], kf[3]);
        }
      }
      // scale to base 2, mask, and the tile's row maxima
      const bool need_mask = rm.all_masked || kbase + KT > warp_lo;
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int n = 0; n < KN; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sacc[n][e] * scale_log2;
          if (need_mask) {
            const int col = kbase + n * 8 + 2 * (lane & 3) + (e & 1);
            if (rm.all_masked) {
              x = col < Skv ? NEG_INF : -INFINITY;
            } else if (col >= (e < 2 ? end_a : end_b)) {
              x = -INFINITY;
            }
          }
          sacc[n][e] = x;
        }
        mx_a = fmaxf(mx_a, fmaxf(sacc[n][0], sacc[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[n][2], sacc[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float mu_a = mn_a == -INFINITY ? 0.f : mn_a;
      const float mu_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int n = 0; n < KN; ++n) {
        sacc[n][0] = exp2f(sacc[n][0] - mu_a);
        sacc[n][1] = exp2f(sacc[n][1] - mu_a);
        sacc[n][2] = exp2f(sacc[n][2] - mu_b);
        sacc[n][3] = exp2f(sacc[n][3] - mu_b);
        ps_a += sacc[n][0] + sacc[n][1];
        ps_b += sacc[n][2] + sacc[n][3];
      }
      l_a = l_a * al_a + ps_a;
      l_b = l_b * al_b + ps_b;
#pragma unroll
      for (int i = 0; i < DN; ++i) {
        o[i][0] *= al_a;
        o[i][1] *= al_a;
        o[i][2] *= al_b;
        o[i][3] *= al_b;
      }
      // O += P V, P as bf16 hi + lo (the S accumulators of two n8 blocks
      // are the A fragment of one k16 step); V rows [key][d] are the mma's
      // row-major B, loaded transposed
#pragma unroll
      for (int kc = 0; kc < KT / 16; ++kc) {
        if (kbase + kc * 16 >= warp_hi) break;  // keys past every row of the warp
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const float* s = sacc[2 * kc + h2];
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const float x0 = s[2 * rr], x1 = s[2 * rr + 1];
            const __nv_bfloat162 hv = __floats2bfloat162_rn(x0, x1);
            hi[2 * h2 + rr] = *reinterpret_cast<const uint32_t*>(&hv);
            lo[2 * h2 + rr] = pack_bf16(x0 - __low2float(hv), x1 - __high2float(hv));
          }
        }
#pragma unroll
        for (int np = 0; np < DN / 2; ++np) {
          uint32_t vf[4];
          mma_gemm::ldmatrix_x4_trans(
              vf, vt + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + np * 16 +
                      (lane >> 4) * 8);
          mma_gemm::mma_m16n8k16(o[2 * np], hi, vf[0], vf[1]);
          mma_gemm::mma_m16n8k16(o[2 * np], lo, vf[0], vf[1]);
          mma_gemm::mma_m16n8k16(o[2 * np + 1], hi, vf[2], vf[3]);
          mma_gemm::mma_m16n8k16(o[2 * np + 1], lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // tile j's buffer is refilled by the next step's copy
  }
  pipelined::cp_async_wait<0>();

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / fmaxf(l_a, 1e-30f), inv_b = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = ra + half * 8;
    if (t >= R) continue;
    const int s = t / rg;
    bf16* op = out + b * os.b + (long long)(g * rg + t - s * rg) * os.h + s * os.s +
               2 * (lane & 3);
    const float inv = half ? inv_b : inv_a;
#pragma unroll
    for (int i = 0; i < DN; ++i) {
      *reinterpret_cast<__nv_bfloat162*>(op + i * 8) =
          __floats2bfloat162_rn(o[i][2 * half] * inv, o[i][2 * half + 1] * inv);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, const int* lengths, int B,
           int H, int G, int Sq, int Skv, float scale_log2, int causal, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, cudaStream_t st) {
  constexpr size_t smem = Shape<D>::BYTES;
  auto kernel = flash_attention_tc_kernel<D>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int R = (H / G) * Sq;
  kernel<<<dim3((R + BM - 1) / BM, G, B), NT, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), lengths, H, G, Sq, Skv, scale_log2, causal, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace tc

// =========================================================================
// simt: a warp a query row on the CUDA cores
// =========================================================================
namespace simt {

constexpr int KC = 8;  // keys per step of a warp

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(128)
    flash_attention_simt_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                                const TKV* __restrict__ v, TQ* __restrict__ out,
                                const int* __restrict__ lengths, int H, int G, int Sq, int Skv,
                                int R, float scale, int causal, Strides qs, Strides ks,
                                Strides vs, Strides os) {
  constexpr int E = D / 32;
  __shared__ float sm_m[4], sm_l[4];
  __shared__ float sm_acc[4][D];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int P = 4 / R;  // warps (key-range parts) per row
  const int r_local = warp % R;
  const int part = warp / R;
  const int row = blockIdx.x * R + r_local;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (H / G);
  const bool active = row < Sq;

  float m = NEG_INF, l = 0.f;
  float acc[E];
#pragma unroll
  for (int e = 0; e < E; ++e) acc[e] = 0.f;

  if (active) {
    float qv[E];
    load_vec<TQ, E>(q + b * qs.b + h * qs.h + row * qs.s + lane * E, qv);
    const RowMask rm = row_mask(lengths, b, Skv, causal);
    const int kv_end = rm.end(row);
    const int part_len = (kv_end + P - 1) / P;
    const int lo = part * part_len;
    const int hi = min(kv_end, lo + part_len);
    const TKV* kb = k + b * ks.b + g * ks.h + lane * E;
    const TKV* vb = v + b * vs.b + g * vs.h + lane * E;
    for (int j0 = lo; j0 < hi; j0 += KC) {
      float s[KC];
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float kr[E];
        if (j0 + c < hi) {
          load_vec<TKV, E>(kb + (long long)(j0 + c) * ks.s, kr);
        } else {
#pragma unroll
          for (int e = 0; e < E; ++e) kr[e] = 0.f;
        }
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < E; ++e) d = fmaf(qv[e], kr[e], d);
        s[c] = d;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
      float m_new = m;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        s[c] = rm.all_masked ? NEG_INF : s[c] * scale;
        if (j0 + c < hi) m_new = fmaxf(m_new, s[c]);
      }
      const float alpha = expf(m - m_new);
      float p[KC], psum = 0.f;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        p[c] = (j0 + c < hi) ? expf(s[c] - m_new) : 0.f;
        psum += p[c];
      }
      l = l * alpha + psum;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] *= alpha;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        if (j0 + c >= hi) continue;
        float vr[E];
        load_vec<TKV, E>(vb + (long long)(j0 + c) * vs.s, vr);
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = fmaf(p[c], vr[e], acc[e]);
      }
      m = m_new;
    }
  }

  // combine the parts of each row, in part order
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < E; ++e) sm_acc[warp][lane * E + e] = acc[e];
  __syncthreads();
  if (!active || part != 0) return;
  float mt = sm_m[r_local];
  for (int pp = 1; pp < P; ++pp) mt = fmaxf(mt, sm_m[pp * R + r_local]);
  float lt = 0.f, o[E];
#pragma unroll
  for (int e = 0; e < E; ++e) o[e] = 0.f;
  for (int pp = 0; pp < P; ++pp) {
    const int w = pp * R + r_local;
    const float sc = expf(sm_m[w] - mt);
    lt += sm_l[w] * sc;
#pragma unroll
    for (int e = 0; e < E; ++e) o[e] += sm_acc[w][lane * E + e] * sc;
  }
  const float inv = 1.f / fmaxf(lt, 1e-30f);
  TQ* op = out + b * os.b + h * os.h + row * os.s + lane * E;
#pragma unroll
  for (int e = 0; e < E; ++e) op[e] = from_f32<TQ>(o[e] * inv);
}

template <int D, typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, void* out, const int* lengths, int B,
           int H, int G, int Sq, int Skv, float scale, int causal, const Strides& qs,
           const Strides& ks, const Strides& vs, const Strides& os, cudaStream_t st) {
  const int R = Sq >= 4 ? 4 : (Sq >= 2 ? 2 : 1);
  dim3 grid((Sq + R - 1) / R, H, B);
  flash_attention_simt_kernel<D, TQ, TKV><<<grid, 128, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), lengths, H, G, Sq, Skv, R, scale, causal, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

}  // namespace simt

enum { ROUTE_SIMT = 0, ROUTE_TC = 1, ROUTE_SPLIT = 2 };

struct Call {
  const void *q, *k, *v;
  void* out;
  const int* lengths;
  int B, H, G, Sq, Skv;
  float scale;
  int causal, route, nsplit, chunk;
  float* work;
  Strides qs, ks, vs, os;
  cudaStream_t st;
};

template <int D, typename TQ, typename TKV>
int run(const Call& c) {
  switch (c.route) {
    case ROUTE_SPLIT:
      return split_kv::launch<D, TQ, TKV>(c.q, c.k, c.v, c.out, c.work, c.lengths, c.B, c.H,
                                          c.G, c.Sq, c.Skv, c.nsplit, c.chunk, c.scale * LOG2E,
                                          c.causal, c.qs, c.ks, c.vs, c.os, c.st);
    case ROUTE_TC:
      if constexpr (std::is_same<TQ, bf16>::value && std::is_same<TKV, bf16>::value) {
        return tc::launch<D>(c.q, c.k, c.v, c.out, c.lengths, c.B, c.H, c.G, c.Sq, c.Skv,
                             c.scale * LOG2E, c.causal, c.qs, c.ks, c.vs, c.os, c.st);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return simt::launch<D, TQ, TKV>(c.q, c.k, c.v, c.out, c.lengths, c.B, c.H, c.G, c.Sq,
                                      c.Skv, c.scale, c.causal, c.qs, c.ks, c.vs, c.os, c.st);
  }
}

template <int D>
int dispatch_types(int types, const Call& c) {
  switch (types) {
    case 0:  // q f32, k/v f32
      return run<D, float, float>(c);
    case 1:  // q bf16, k/v bf16
      return run<D, bf16, bf16>(c);
    case 2:  // q bf16, k/v f32 (decode: the cache span is f32)
      return run<D, bf16, float>(c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides -- (batch, head, seq) of q, k, v and out.
// types: 0 = (f32, f32), 1 = (bf16, bf16), 2 = (bf16 q and out, f32 k / v).
// route: 0 simt, 1 tensor_core (types 1 only), 2 split; the split route
// takes nsplit splits of chunk keys (a multiple of 16, at most 128; the
// splits cover Skv, none empty), at most 64 rows of a group (H / G x Sq),
// 16-byte aligned K / V rows, and, with nsplit > 1, an f32 workspace of
// B * H * Sq * nsplit * (D + 2) floats.  The tensor-core route takes
// 16-byte aligned q / K / V rows.  The wrapper (kernels/flash_attention.py:
// plan) picks them from the shape.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     const void* lengths, int B, int H, int G, int Sq,
                                     int Skv, int D, float scale, int causal, int types,
                                     const long long* strides, int route, int nsplit, int chunk,
                                     void* work, void* stream) {
  if (B < 0 || H < 1 || G < 1 || H % G || Sq < 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (route < ROUTE_SIMT || route > ROUTE_SPLIT) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_TC && types != 1) return (int)cudaErrorInvalidValue;
  if (route == ROUTE_SPLIT) {
    const bool covers = Skv == 0 ? nsplit == 1 && chunk == 0
                                 : nsplit >= 1 && chunk >= 1 && (long long)nsplit * chunk >= Skv &&
                                       (long long)(nsplit - 1) * chunk < Skv;
    if (!covers || chunk % split_kv::ALIGN || chunk > split_kv::MAX_CHUNK ||
        (H / G) * Sq > split_kv::MAX_ROWS || nsplit > 65535 || (nsplit > 1 && work == nullptr)) {
      return (int)cudaErrorInvalidValue;
    }
  }
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  if (B > 65535 || G > 65535) return (int)cudaErrorInvalidValue;
  Call c;
  c.q = q;
  c.k = k;
  c.v = v;
  c.out = out;
  c.lengths = static_cast<const int*>(lengths);
  c.B = B;
  c.H = H;
  c.G = G;
  c.Sq = Sq;
  c.Skv = Skv;
  c.scale = scale;
  c.causal = causal;
  c.route = route;
  c.nsplit = nsplit;
  c.chunk = chunk;
  c.work = static_cast<float*>(work);
  c.qs = Strides{strides[0], strides[1], strides[2]};
  c.ks = Strides{strides[3], strides[4], strides[5]};
  c.vs = Strides{strides[6], strides[7], strides[8]};
  c.os = Strides{strides[9], strides[10], strides[11]};
  c.st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch_types<32>(types, c);
    case 64:
      return dispatch_types<64>(types, c);
    case 128:
      return dispatch_types<128>(types, c);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
