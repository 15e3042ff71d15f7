// Flash attention (forward) for Hopper (sm_90a), GQA-aware, optional lengths.
//
// Replaces the TPU kernels repro/kernels/flash_attention.py:
// flash_attention_kernel (no lengths) and _flash_attention_kernel_len
// (valid-prefix mask col < length): one kernel, `lengths` may be null.
//
//   q [B, H, Sq, D], k / v [B, G, Skv, D] (H % G == 0: query head h reads
//   KV group h / (H / G), the grouping of the executor's _attn_heads), any
//   strides over (batch, head, seq) with a unit stride over D; out [B, H,
//   Sq, D] in q's type, strided the same way.  TQ is q's and out's type, TKV
//   k's and v's (the decode merge hands bf16 queries and f32 cache spans);
//   every product and the (m, l, acc) recurrence run in f32.
//
// Semantics of the TPU kernel: scores q.k * scale (1/sqrt(D) unless given),
// masked to -1e30 -- causal keeps col <= row (top-left aligned), lengths
// keep col < length -- online softmax over the keys, out = acc / max(l,
// 1e-30).  A masked score is -1e30, not -inf: a row whose every key is
// masked averages V uniformly and stays finite.  Keys that are masked for
// a row are skipped (the TPU grid runs them); whenever the row has one
// valid key, a skipped key would have added exp(-1e30 - m) = 0, so the
// result is the same.  Only a row with length 0 has no valid key, and it
// walks every key, masked, as the reference does.
//
// Work split: a block of 4 warps owns up to 4 query rows of one (b, h).
// With R rows in the block (R = 4 for Sq >= 4; 2; 1 at decode) each row
// gets 4 / R warps, which split its key range into contiguous parts; a
// warp walks its part 8 keys at a time, each lane holding D / 32 elements
// of q, of the 8 key rows and of the 8 value rows (coalesced 16- or 8-byte
// loads), and the 8 dot products are summed across the warp by shuffles.
// The parts' (m, l, acc) meet in shared memory and combine in part order.
//
// What bounds it here: at decode (one query per (b, h), a span of cached
// keys) the K/V bytes; the heads of a KV group re-read the same K/V, which
// stays in the 50 MB L2, and the split over 4 warps keeps 4x the loads in
// flight.  At prefill (S = 16) it is small either way.  No tensor cores
// (mma.sync / wgmma), TMA or split-KV across blocks yet.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int KC = 8;  // keys per step of a warp

struct Strides {
  long long b, h, s;
};

template <int D, typename TQ, typename TKV>
__global__ void __launch_bounds__(128)
    flash_attention_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
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
    const int len = lengths ? lengths[b] : Skv;
    const bool all_masked = lengths != nullptr && len <= 0;
    int kv_end = Skv;
    if (!all_masked) {
      if (lengths) kv_end = min(kv_end, len);
      if (causal) kv_end = min(kv_end, row + 1);
    }
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
        s[c] = all_masked ? NEG_INF : s[c] * scale;
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
  flash_attention_kernel<D, TQ, TKV><<<grid, 128, 0, st>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      static_cast<TQ*>(out), lengths, H, G, Sq, Skv, R, scale, causal, qs, ks, vs, os);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_types(int types, const void* q, const void* k, const void* v, void* out,
                   const int* lengths, int B, int H, int G, int Sq, int Skv, float scale,
                   int causal, const Strides& qs, const Strides& ks, const Strides& vs,
                   const Strides& os, cudaStream_t st) {
  using BF = __nv_bfloat16;
  switch (types) {
    case 0:  // q f32, k/v f32
      return launch<D, float, float>(q, k, v, out, lengths, B, H, G, Sq, Skv, scale, causal,
                                     qs, ks, vs, os, st);
    case 1:  // q bf16, k/v bf16
      return launch<D, BF, BF>(q, k, v, out, lengths, B, H, G, Sq, Skv, scale, causal, qs, ks,
                               vs, os, st);
    case 2:  // q bf16, k/v f32 (decode: the cache span is f32)
      return launch<D, BF, float>(q, k, v, out, lengths, B, H, G, Sq, Skv, scale, causal, qs,
                                  ks, vs, os, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// strides: 12 element strides -- (batch, head, seq) of q, k, v and out.
// types: 0 = (f32, f32), 1 = (bf16, bf16), 2 = (bf16 q and out, f32 k / v).
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v, void* out,
                                     const void* lengths, int B, int H, int G, int Sq,
                                     int Skv, int D, float scale, int causal, int types,
                                     const long long* strides, void* stream) {
  if (B < 0 || H < 1 || G < 1 || H % G || Sq < 0 || Skv < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || Sq == 0) return (int)cudaSuccess;
  const Strides qs{strides[0], strides[1], strides[2]};
  const Strides ks{strides[3], strides[4], strides[5]};
  const Strides vs{strides[6], strides[7], strides[8]};
  const Strides os{strides[9], strides[10], strides[11]};
  const int* len = static_cast<const int*>(lengths);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32:
      return dispatch_types<32>(types, q, k, v, out, len, B, H, G, Sq, Skv, scale, causal, qs,
                                ks, vs, os, st);
    case 64:
      return dispatch_types<64>(types, q, k, v, out, len, B, H, G, Sq, Skv, scale, causal, qs,
                                ks, vs, os, st);
    case 128:
      return dispatch_types<128>(types, q, k, v, out, len, B, H, G, Sq, Skv, scale, causal,
                                 qs, ks, vs, os, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
