// Implicit-GEMM conv2d with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/conv2d.py:conv2d_gemm_kernel
// (wrapper conv2d_gemm), every scheme: f32, channel-pruned
// ("channelcompact"), and the INT8 schemes W8 and W8A8 (scheme.cuh):
//   out = epilogue(act(conv(x[:, kept], w) * ws + bias))
// with ws the per-output-channel rescale of the INT8 schemes (absent for
// f32): w_scale for W8, w_scale * x_scale for W8A8, folded by the wrapper.
//
// GEMM view: M = N * OH * OW output pixels, N_gemm = O output channels,
// K = C * kh * kw with C the live (kept) input channels; K is ordered like
// the OIHW filter, k = (c * kh + ki) * kw + kj, so a filter row is a
// contiguous slice of w.
//
// Unlike the TPU kernel, which takes a zero-padded NHWC copy made in device
// memory, this one reads the NCHW input where it lies: each thread block
// owns a BM-pixel x BN-channel output tile; per K slab it gathers the patch
// elements x[n, kept[c], oh*s - pad_t + ki, ow*s - pad_l + kj] into shared
// memory (the zero border is a bounds check, the channel gather an index
// load), never materialising the im2col matrix anywhere.  Neighbouring
// threads take neighbouring output pixels, so patch loads and NCHW output
// stores are coalesced along the image row.  Ragged pixel / channel edges
// are masked.  The rescale, bias, activation and the epilogue steps (add/mul
// with NCHW side operands) run on the accumulator before the one store.
//
// What bounds it here: the demo apps' 3x3 / 7x7 layers carry K = 147..1728
// per output, so multiply-add throughput on the CUDA cores bounds them (f32
// FMA: true f32, no TF32, which would break the 1e-4 kernel tolerance),
// not memory.  So the f32 and W8 body (conv2d_igemm_kernel) spends its
// issue slots on FMAs:
//
// * register blocking: each thread owns a TM x TN micro-tile (8 x 8, or
//   8 x 4 / 4 x 4 for the narrow heads) of 4-pixel and 4-channel groups,
//   read from shared memory as float4 -- per k, TM / 4 + TN / 4 loads for
//   TM * TN FMAs (16 per load at 8 x 8);
// * overlap: the patch and filter slabs are double-buffered; the gather
//   of slab k + 1 is issued as 4-byte cp.async copies (zero-fill for the
//   border, the pruned channels and the ragged K tail) and the filter slab
//   k + 1 loaded into registers while slab k is multiplied; one barrier a
//   slab;
// * a cheap gather: every thread gathers fixed pixels (their image base,
//   first row and column computed once per CTA) over every k of the slab
//   (the slab's channel offset, ki and kj computed once per slab, two
//   slabs ahead, by BK threads into a shared table, k split by
//   multiply-high), so an element costs two adds, two unsigned range
//   checks and the copy: no per-element division, 32-bit offsets (the
//   wrapper refuses extents past 2^31);
// * an epilogue whose loads overlap: the common residual add (a one-step
//   add program) reads the TN side values of a pixel together before it
//   stores any output (a rolled step loop per output serialises them);
// * W8 widens each int8 filter element to f32 as it is staged.
//
// Every output sums K in ascending k in one f32 FMA chain from +0, with no
// split of K -- the same chain on every tile -- so every tile is bit-equal
// to every other (and to the previous body of this kernel).
//
// W8A8 (int8 patches and filters, exact int32 sums) has its own body,
// conv2d_igemm_int8_kernel, on int8 tensor cores: what bounded the old
// int8 body was issue slots (scalar int multiply-adds on a 4 x 4
// micro-tile, synchronous byte gathers, two barriers a slab), not bytes.
// The new one runs mma.sync m16n8k32 s8 (2 x NI per k32 step a warp, the
// fragments by ldmatrix from padded rows) on a [BM][BK8] patch slab and a
// [BN8][BK8] filter slab, k contiguous; double-buffered, one barrier a
// slab.  cp.async has no 1-byte copy, so the patch gather of slab k + 1
// (one pixel a thread, from the per-CTA pixel base and the per-slab k
// table as above, 4 bytes packed into a word) is loaded into registers
// while slab k multiplies and stored after; the filter slab (w [O, K]
// row-major is already the col-major B operand) comes by 16-byte cp.async
// where K % 16 == 0, else by byte loads through registers the same way.
// The epilogue keeps the old order -- int32 -> f32, * ws, + bias (never
// fused into one rounding), activation, step program, one store -- and the
// overlapped residual read.  Integer sums are exact in any order, so every
// tile gives the bits of every other, of the old body and of the plain
// version.
//
// Every scheme is built for the six tiles of tiles.cuh and the wrapper
// picks one: the tuning cache's winner, a pin, or the default -- for f32 by
// output-channel count, so narrow heads (O = 2..12) do not waste most of a
// 64-wide tile; for the INT8 schemes the O <= 32 / wider pair, the apps'
// quantized convs being 32..128 channels wide (_build.conv_default_tile).

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "imma.cuh"
#include "pipelined_gemm.cuh"
#include "scheme.cuh"
#include "tiles.cuh"

namespace {

// The f32 / W8 body's thread layout for a tile: TX threads along pixels,
// TY along channels; thread (tx, ty) owns pixels g * 4 * TX + 4 * tx +
// {0..3} (g < TM / 4) and channels g * 4 * TY + 4 * ty + {0..3} (g < TN / 4).
// A warp is LX x LY of them (8 x 4 where TY allows), so its float4 reads of
// a k row of either slab touch 8 and 4 distinct 16-byte words: one shared
// memory wavefront each.  For the gather each thread owns PPT pixels
// (tid % min(NT, BM) + p * NT) over every KT-th k of the slab from
// tid / BM on: no thread gathers a pixel another does at the same k.
template <int BM, int BN, int BK, int TM, int TN>
struct ConvShape {
  static constexpr int TX = BM / TM;
  static constexpr int TY = BN / TN;
  static constexpr int NT = TX * TY;
  static constexpr int LY = TY < 4 ? TY : 4;  // a warp's threads along channels
  static constexpr int LX = 32 / LY;          // ... and along pixels
  static constexpr int WX = TX / LX;          // warps along pixels
  static constexpr int PPT = BM > NT ? BM / NT : 1;  // pixels a thread gathers
  static constexpr int KT = NT > BM ? NT / BM : 1;   // threads sharing a pixel
  static constexpr int FPT = (BK * BN + NT - 1) / NT;  // filter elements a thread stages
  static constexpr int BP = BN + 4;                // filter slab row (float4-aligned pad)
  static_assert(TM % 4 == 0 && TN % 4 == 0, "micro-tiles of 4-element groups");
  static_assert(BM % TM == 0 && BN % TN == 0, "whole micro-tiles");
  static_assert(TX % LX == 0 && TY % LY == 0 && NT % 32 == 0, "whole warps");
  static_assert(BM % NT == 0 || NT % BM == 0, "gather: whole pixels a thread");
  static_assert(BK % KT == 0, "gather: whole k a thread");
};

// sentinel row of a pixel past M or a k past K: any sum of two stays out
// of [0, H)
constexpr int OUT_OF_RANGE = -(1 << 30);

// At most 128 registers a thread (512 / NT blocks an SM): at 8 x 8 the
// compiler would take 129, and one block fewer an SM costs more than the
// spill-free squeeze (measured on the 256 x 32 tile: 0.571 -> 0.565 ms).
template <int S, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__(ConvShape<BM, BN, BK, TM, TN>::NT,
                                  512 / ConvShape<BM, BN, BK, TM, TN>::NT)
    conv2d_igemm_kernel(const float* __restrict__ x, const typename Scheme<S>::WG* __restrict__ w,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        const int* __restrict__ kept, float* __restrict__ out, int Nb, int C_in,
                        int H, int W, int C, int O, int kh, int kw, int stride, int pad_t,
                        int pad_l, int OH, int OW, int act, StepProgram prog) {
  using WG = typename Scheme<S>::WG;
  using Sh = ConvShape<BM, BN, BK, TM, TN>;
  constexpr int TX = Sh::TX, TY = Sh::TY, NT = Sh::NT, LX = Sh::LX, WX = Sh::WX;
  constexpr int PPT = Sh::PPT, KT = Sh::KT, FPT = Sh::FPT, BP = Sh::BP;
  constexpr int GP = NT < BM ? NT : BM;  // distinct pixels per gather pass
  __shared__ __align__(16) float As[2][BK][BM];
  __shared__ __align__(16) float Bs[2][BK][BP];
  __shared__ int4 ktab[2][BK];  // (channel offset + ki * W + kj, ki, kj, -) of a slab's k

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % WX) * LX + lane % LX;
  const int ty = (warp / WX) * Sh::LY + lane / LX;
  const int gm = tid % GP;     // the gather's first pixel
  const int gk = tid / GP;     // ... and first k (< KT)
  const int M = Nb * OH * OW;  // < 2^31 (wrapper)
  const int K = C * kh * kw;
  const int khw = kh * kw;
  const int HW = H * W;
  const int OHW = OH * OW;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nslab = (K + BK - 1) / BK;

  // the gather's pixels: image base + first row / column, once per CTA
  int pbase[PPT], ih0[PPT], iw0[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int m = m0 + gm + j * NT;
    if (m < M) {
      const int n = m / OHW;
      const int p = m - n * OHW;
      const int oh = p / OW;
      ih0[j] = oh * stride - pad_t;
      iw0[j] = (p - oh * OW) * stride - pad_l;
      pbase[j] = n * C_in * HW + ih0[j] * W + iw0[j];
    } else {
      ih0[j] = OUT_OF_RANGE;
      iw0[j] = 0;
      pbase[j] = 0;
    }
  }

  // k = (c * kh + ki) * kw + kj by multiply-high with ceil(2^32 / d): exact
  // for k < 2^32 / khw (the C entry's bound), two divisions a CTA
  const unsigned inv_khw = 0xffffffffu / (unsigned)khw + 1u;
  const unsigned inv_kw = 0xffffffffu / (unsigned)kw + 1u;
  auto fill_ktab = [&](int t, int buf) {
    if (tid < BK) {
      const int k = t * BK + tid;
      int4 e = make_int4(0, OUT_OF_RANGE, 0, 0);
      if (k < K) {
        const int c = (int)__umulhi((unsigned)k, inv_khw);
        const int r = k - c * khw;
        const int ki = (int)__umulhi((unsigned)r, inv_kw), kj = r - ki * kw;
        const int ch = kept ? kept[c] : c;
        e = make_int4(ch * HW + ki * W + kj, ki, kj, 0);
      }
      ktab[buf][tid] = e;
    }
  };
  auto gather = [&](int buf) {
#pragma unroll
    for (int q = 0; q < BK / KT; ++q) {
      const int kk = gk + q * KT;
      const int4 e = ktab[buf][kk];
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        const bool ok = (unsigned)(ih0[j] + e.y) < (unsigned)H &&
                        (unsigned)(iw0[j] + e.z) < (unsigned)W;
        pipelined::cp_async4(&As[buf][kk][gm + j * NT], x + (ok ? pbase[j] + e.x : 0),
                             ok ? 4 : 0);
      }
    }
    pipelined::cp_async_commit();
  };
  WG wreg[FPT];
  auto load_w = [&](int t) {
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const int e = tid + i * NT;
      const int kk = e % BK, nn = e / BK;
      const int k = t * BK + kk, o = n0 + nn;
      wreg[i] = (e < BK * BN && k < K && o < O) ? w[o * K + k] : WG(0);
    }
  };
  auto store_w = [&](int buf) {
#pragma unroll
    for (int i = 0; i < FPT; ++i) {
      const int e = tid + i * NT;
      if (e < BK * BN) Bs[buf][e % BK][e / BK] = float(wreg[i]);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  fill_ktab(0, 0);
  fill_ktab(1, 1);
  __syncthreads();
  if (nslab > 0) {
    gather(0);
    load_w(0);
    store_w(0);
  }
  for (int t = 0; t < nslab; ++t) {
    const int buf = t & 1;
    pipelined::cp_async_wait<0>();
    __syncthreads();  // slab t landed; slab t - 1's readers are done
    if (t + 1 < nslab) {
      gather(buf ^ 1);
      load_w(t + 1);
    }
    if (t + 2 < nslab) fill_ktab(t + 2, buf);  // slab t's gather was issued last step
    // unrolled by two, not BK: a fully unrolled slab of 8 x 8 FMAs outgrows
    // the instruction cache (measured: 0.70 -> 0.61 ms on the 128 x 32 tile)
#pragma unroll 2
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&As[buf][kk][g * 4 * TX + 4 * tx]);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&Bs[buf][kk][g * 4 * TY + 4 * ty]);
        b[4 * g] = v.x;
        b[4 * g + 1] = v.y;
        b[4 * g + 2] = v.z;
        b[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < nslab) store_w(buf ^ 1);  // slab t - 1's readers passed the barrier
  }

  const bool residual = prog.n_steps == 1 && prog.kind[0] == STEP_ADD;
  const float* side = side_ptr(prog, prog.arg[0]);
  float wsv[TN], bv[TN];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int o = n0 + (j / 4) * 4 * TY + 4 * ty + (j % 4);
    wsv[j] = (ws && o < O) ? ws[o] : 1.f;
    bv[j] = (bias && o < O) ? bias[o] : 0.f;
  }
#pragma unroll
  for (int g = 0; g < TM / 4; ++g) {
    const int mg = m0 + g * 4 * TX + 4 * tx;
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int m = mg + ii;
      if (m >= M) continue;
      const int n = m / OHW;
      const int ob = n * O * OHW + (m - n * OHW);
      float sv[TN];
      if (residual) {  // every side read of the pixel before its first store
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int o = n0 + (j / 4) * 4 * TY + 4 * ty + (j % 4);
          sv[j] = o < O ? __ldg(side + ob + o * OHW) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int o = n0 + (j / 4) * 4 * TY + 4 * ty + (j % 4);
        if (o >= O) continue;
        const int idx = ob + o * OHW;
        float v = acc[4 * g + ii][j];
        if (ws) v *= wsv[j];
        v = apply_act(act, v + bv[j]);
        out[idx] = residual ? v + sv[j] : apply_pointwise_steps(prog, v, idx);
      }
    }
  }
}

// The W8A8 body (S = SCHEME_W8A8) on int8 tensor cores: per K slab an int8
// patch [BM][BK8] and filter [BN8][BK8] (k contiguous: the row-major A and
// col-major B operands of mma.sync m16n8k32 s8), double-buffered; exact
// int32 sums, so any order and any tile give the same bits.  Its tile is
// derived from the tiles.cuh tuple: BK8 = 4 * BK k a slab (the f32 body's
// slab row of 16 floats is 64 bytes; a multiple of the mma's 32); BN8 =
// max(2 * BN, 8) channels -- the byte gather of the patch, not the int8
// mma, is what this body spends its time on, so a CTA multiplies each
// gathered patch by twice the f32 tile's channels; warps of 32 x min(BN8,
// 32) outputs.  A thread gathers PPT pixels (two from BM = 64 on, so that
// one read of the slab's k table serves two elements) over every KT-th
// word of a slab row.
template <int BM, int BN, int BK>
struct Int8ConvShape {
  static constexpr int BN8 = 2 * BN < 8 ? 8 : 2 * BN;
  static constexpr int BK8 = 4 * BK;
  static constexpr int WTN = BN8 < 32 ? BN8 : 32;  // a warp's channels
  static constexpr int NI = WTN / 8;               // n8 blocks a warp
  static constexpr int WM = BM / 32;               // warps along pixels (2 m16 blocks each)
  static constexpr int WN = BN8 / WTN;             // warps along channels
  static constexpr int NT = WM * WN * 32;
  // a slab row in bytes (16-byte pad: an ldmatrix's 8 rows on distinct banks)
  static constexpr int AP = BK8 + 16;
  static constexpr int GW = BK8 / 4;           // 4-byte words of a slab row
  static constexpr int PPT = BM >= 64 ? 2 : 1;  // pixels a thread gathers
  static constexpr int PS = BM / PPT;          // pixel slots (a thread's first pixel)
  static constexpr int KT = NT / PS;           // threads sharing a pixel slot
  static constexpr int WPT = GW / KT;          // words of each of its pixels a thread gathers
  static constexpr int FW = (BN8 * GW + NT - 1) / NT;  // filter words a thread loads (unaligned K)
  static constexpr int SMEM = 2 * (BM + BN8) * AP + 2 * BK8 * 16;  // + the k tables
  static_assert(BM % 32 == 0 && BN8 % WTN == 0 && WTN % 8 == 0, "whole warp tiles");
  static_assert(BK8 % 32 == 0, "whole k32 steps");
  static_assert(PS % 32 == 0 && NT % PS == 0 && GW % KT == 0,
                "gather: a warp on 32 pixels, whole words a thread");
  static_assert(NT <= 1024 && BK8 <= NT, "one thread a k of the slab table");
};

// (channel offset + ki * W + kj, ki, kj) of a slab's k: 64-bit offsets,
// the W8A8 scheme's extents are not bounded to 2^31
struct KEntry {
  long long off;
  int ki, kj;
};

// S is always SCHEME_W8A8; it leads the template arguments as in
// conv2d_igemm_kernel, so the build log and the profiler name the scheme.
template <int S, int BM, int BN, int BK>
__global__ void __launch_bounds__(Int8ConvShape<BM, BN, BK>::NT)
    conv2d_igemm_int8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                             const float* __restrict__ ws, const float* __restrict__ bias,
                             const int* __restrict__ kept, float* __restrict__ out, int Nb,
                             int C_in, int H, int W, int C, int O, int kh, int kw, int stride,
                             int pad_t, int pad_l, int OH, int OW, int act, StepProgram prog) {
  static_assert(S == SCHEME_W8A8, "the int8 tensor-core body is W8A8's");
  using Sh = Int8ConvShape<BM, BN, BK>;
  constexpr int BN8 = Sh::BN8, BK8 = Sh::BK8, WTN = Sh::WTN, NI = Sh::NI, NT = Sh::NT;
  constexpr int AP = Sh::AP, GW = Sh::GW, PPT = Sh::PPT, PS = Sh::PS, KT = Sh::KT;
  constexpr int WPT = Sh::WPT, FW = Sh::FW;
  // As[2][BM][AP], Bs[2][BN8][AP], ktab[2][BK8] in dynamic shared memory
  // (the widest derived tile takes 52 KB)
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<int8_t(*)[BM][AP]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[BN8][AP]>(smem + 2 * BM * AP);
  auto ktab = reinterpret_cast<KEntry(*)[BK8]>(smem + 2 * (BM + BN8) * AP);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Sh::WM, wn = warp / Sh::WM;
  const long long M = (long long)Nb * OH * OW;
  const int K = C * kh * kw;
  const int khw = kh * kw;
  const long long HW = (long long)H * W;
  const long long OHW = (long long)OH * OW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN8;
  const int nslab = (K + BK8 - 1) / BK8;
  const bool w16 = K % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  // the gather's pixels (PPT a thread, PS apart) and its words (every
  // KT-th of a row): image base and first row / column, once per CTA
  const int ps = tid % PS, gk = tid / PS;
  int ih0[PPT], iw0[PPT];
  const int8_t* px[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const long long m = m0 + ps + j * PS;
    ih0[j] = OUT_OF_RANGE;
    iw0[j] = 0;
    px[j] = x;
    if (m < M) {
      const long long n = m / OHW;
      const int p = (int)(m - n * OHW);
      const int oh = p / OW;
      ih0[j] = oh * stride - pad_t;
      iw0[j] = (p - oh * OW) * stride - pad_l;
      px[j] = x + n * C_in * HW + (long long)ih0[j] * W + iw0[j];
    }
  }
  auto fill_ktab = [&](int t, int buf) {
    if (tid < BK8) {
      const int k = t * BK8 + tid;
      KEntry e{0, OUT_OF_RANGE, 0};
      if (k < K) {
        const int c = k / khw, r = k - c * khw;
        const int ki = r / kw, kj = r - ki * kw;
        e.off = (long long)(kept ? kept[c] : c) * HW + (long long)ki * W + kj;
        e.ki = ki;
        e.kj = kj;
      }
      ktab[buf][tid] = e;
    }
  };
  uint32_t areg[WPT][PPT], wreg[FW];
  auto load_a = [&](int buf) {  // the slab's patch words into registers
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      const int kw4 = gk + i * KT;
#pragma unroll
      for (int j = 0; j < PPT; ++j) areg[i][j] = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const KEntry e = ktab[buf][4 * kw4 + b];
#pragma unroll
        for (int j = 0; j < PPT; ++j) {
          const bool ok = (unsigned)(ih0[j] + e.ki) < (unsigned)H &&
                          (unsigned)(iw0[j] + e.kj) < (unsigned)W;
          const uint32_t byte = ok ? (uint32_t)(uint8_t)__ldg(px[j] + e.off) : 0u;
          areg[i][j] |= byte << (8 * b);
        }
      }
    }
  };
  auto store_a = [&](int buf) {
#pragma unroll
    for (int i = 0; i < WPT; ++i)
#pragma unroll
      for (int j = 0; j < PPT; ++j)
        *reinterpret_cast<uint32_t*>(&As[buf][ps + j * PS][4 * (gk + i * KT)]) = areg[i][j];
  };
  auto load_w = [&](int t, int buf) {  // 16-byte cp.async, or words into registers
    const int k0 = t * BK8;
    if (w16) {
      for (int e = tid; e < BN8 * (BK8 / 16); e += NT) {
        const int nn = e / (BK8 / 16), c = (e % (BK8 / 16)) * 16;
        const int o = n0 + nn, k = k0 + c;
        const bool ok = o < O && k < K;
        pipelined::cp_async16(&Bs[buf][nn][c], ok ? w + (long long)o * K + k : w, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < FW; ++i) {
        const int e = tid + i * NT;
        const int nn = e / GW, c = (e % GW) * 4;
        const int o = n0 + nn;
        uint32_t word = 0;
        if (e < BN8 * GW && o < O) {
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const int k = k0 + c + b;
            if (k < K) word |= (uint32_t)(uint8_t)__ldg(w + (long long)o * K + k) << (8 * b);
          }
        }
        wreg[i] = word;
      }
    }
  };
  auto store_w = [&](int buf) {
    if (w16) return;
#pragma unroll
    for (int i = 0; i < FW; ++i) {
      const int e = tid + i * NT;
      if (e < BN8 * GW) *reinterpret_cast<uint32_t*>(&Bs[buf][e / GW][(e % GW) * 4]) = wreg[i];
    }
  };

  int acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  fill_ktab(0, 0);
  fill_ktab(1, 1);
  __syncthreads();
  if (nslab > 0) {
    load_a(0);
    load_w(0, 0);
    pipelined::cp_async_commit();
    store_a(0);
    store_w(0);
  }
  // per-lane ldmatrix rows: A rows lane % 16, k half lane / 16; B channels
  // lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2
  const int a_row = wm * 32 + (lane & 15), a_k = (lane >> 4) * 16;
  const int b_row = wn * WTN + (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 16;
  for (int t = 0; t < nslab; ++t) {
    const int buf = t & 1;
    pipelined::cp_async_wait<0>();
    __syncthreads();  // slab t landed; slab t - 1's readers are done
    if (t + 1 < nslab) {
      load_a(buf ^ 1);  // slab t + 1's words, in flight during this slab's mma
      load_w(t + 1, buf ^ 1);
      pipelined::cp_async_commit();
    }
    if (t + 2 < nslab) fill_ktab(t + 2, buf);  // slab t's table was read last step
#pragma unroll
    for (int ks = 0; ks < BK8 / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) imma::ldsm_x4(a[i], &As[buf][a_row + i * 16][ks * 32 + a_k]);
      if constexpr (NI == 1) {
        uint32_t b[2];
        imma::ldsm_x2(b, &Bs[buf][b_row][ks * 32 + b_k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) imma::mma_s8(acc[i][0], a[i], b[0], b[1]);
      } else {
#pragma unroll
        for (int jj = 0; jj < NI / 2; ++jj) {
          uint32_t b[4];
          imma::ldsm_x4(b, &Bs[buf][b_row + jj * 16][ks * 32 + b_k]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            imma::mma_s8(acc[i][2 * jj], a[i], b[0], b[1]);
            imma::mma_s8(acc[i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if (t + 1 < nslab) {  // slab t - 1's readers passed the barrier
      store_a(buf ^ 1);
      store_w(buf ^ 1);
    }
  }

  // epilogue: int32 -> f32, * ws, + bias, activation, step program, one
  // store; accumulator element e of fragment (i, j) is pixel row lane / 4
  // (+ 8 for e >= 2), channel 2 * (lane % 4) (+ 1 for odd e)
  const bool residual = prog.n_steps == 1 && prog.kind[0] == STEP_ADD;
  const float* side = side_ptr(prog, prog.arg[0]);
  float wsv[NI][2], bv[NI][2];
#pragma unroll
  for (int j = 0; j < NI; ++j)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int o = n0 + wn * WTN + j * 8 + 2 * (lane & 3) + c;
      wsv[j][c] = o < O ? ws[o] : 1.f;
      bv[j][c] = (bias && o < O) ? bias[o] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long m = m0 + wm * 32 + i * 16 + (lane >> 2) + hr * 8;
      if (m >= M) continue;
      const long long n = m / OHW;
      const long long ob = n * O * OHW + (m - n * OHW);
      float sv[NI][2];
      if (residual) {  // every side read of the pixel before its first store
#pragma unroll
        for (int j = 0; j < NI; ++j)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int o = n0 + wn * WTN + j * 8 + 2 * (lane & 3) + c;
            sv[j][c] = o < O ? __ldg(side + ob + (long long)o * OHW) : 0.f;
          }
      }
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int o = n0 + wn * WTN + j * 8 + 2 * (lane & 3) + c;
          if (o >= O) continue;
          const long long idx = ob + (long long)o * OHW;
          // the order and roundings of the plain version: (f32) acc * ws,
          // then + bias, never fused
          float v = __fmul_rn((float)acc[i][j][2 * hr + c], wsv[j][c]);
          if (bias) v = __fadd_rn(v, bv[j][c]);
          v = apply_act(act, v);
          out[idx] = residual ? v + sv[j][c] : apply_pointwise_steps(prog, v, idx);
        }
    }
  }
}

template <int S, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const float* ws, const float* bias, const int* kept,
            float* out, int Nb, int C_in, int H, int W, int C, int O, int kh, int kw,
            int stride, int pad_t, int pad_l, int OH, int OW, int act, const StepProgram& prog,
            cudaStream_t stream) {
  const long long M = (long long)Nb * OH * OW;
  if constexpr (S == SCHEME_W8A8) {
    using Sh = Int8ConvShape<BM, BN, BK>;
    auto kernel = conv2d_igemm_int8_kernel<S, BM, BN, BK>;
    if constexpr (Sh::SMEM > 48 * 1024) {
      if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM) !=
          cudaSuccess)
        return;  // the C entry reports cudaGetLastError()
    }
    const dim3 grid((unsigned)((M + BM - 1) / BM), (O + Sh::BN8 - 1) / Sh::BN8);
    kernel<<<grid, Sh::NT, Sh::SMEM, stream>>>(
        static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), ws, bias, kept, out, Nb,
        C_in, H, W, C, O, kh, kw, stride, pad_t, pad_l, OH, OW, act, prog);
  } else {
    const dim3 grid((unsigned)((M + BM - 1) / BM), (O + BN - 1) / BN);
    conv2d_igemm_kernel<S, BM, BN, BK, TM, TN>
        <<<grid, ConvShape<BM, BN, BK, TM, TN>::NT, 0, stream>>>(
            static_cast<const float*>(x), static_cast<const typename Scheme<S>::WG*>(w), ws,
            bias, kept, out, Nb, C_in, H, W, C, O, kh, kw, stride, pad_t, pad_l, OH, OW, act,
            prog);
  }
}

// The tile (bm, bn, bk) must be one of tiles.cuh's REPRO_CONV_TILES (the
// wrapper picks it: the tuning cache's winner, a pin, or the default by
// scheme and output-channel count); returns false for any other.
template <int S>
bool dispatch(const void* x, const void* w, const float* ws, const float* bias, const int* kept,
              float* out, int Nb, int C_in, int H, int W, int C, int O, int kh, int kw,
              int stride, int pad_t, int pad_l, int OH, int OW, int act, const StepProgram& p,
              int bm, int bn, int bk, cudaStream_t st) {
#define REPRO_TRY_TILE(BM, BN, BK, TM, TN)                                                  \
  if (bm == BM && bn == BN && bk == BK) {                                                   \
    launch<S, BM, BN, BK, TM, TN>(x, w, ws, bias, kept, out, Nb, C_in, H, W, C, O, kh, kw, \
                                  stride, pad_t, pad_l, OH, OW, act, p, st);                \
    return true;                                                                            \
  }
  REPRO_CONV_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return false;
}

}  // namespace

// scheme: SCHEME_F32 (x, w f32; ws null), SCHEME_W8 (x f32, w int8) or
// SCHEME_W8A8 (x, w int8); the INT8 schemes need ws.  The tile (bm, bn,
// bk) must be one of tiles.cuh's (else cudaErrorInvalidValue).
extern "C" int repro_conv2d(const void* x, const void* w, const void* ws, const void* bias,
                            const void* kept, void* out, int Nb, int C_in, int H, int W, int C,
                            int O, int kh, int kw, int stride, int pad_t, int pad_l, int OH,
                            int OW, int act, int scheme, int n_steps, const int* prog,
                            int n_sides, const void* const* sides, int bm, int bn, int bk,
                            void* stream) {
  StepProgram p;
  if (Nb < 0 || C_in < 0 || C < 0 || O < 0 || kh < 1 || kw < 1 || stride < 1 || OH < 0 ||
      OW < 0 || scheme < SCHEME_F32 || scheme > SCHEME_W8A8 ||
      (scheme != SCHEME_F32 && ws == nullptr) ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (Nb == 0 || O == 0 || OH == 0 || OW == 0) return (int)cudaSuccess;
  const long long lim = 1LL << 31;  // the f32 / W8 body's offsets are 32-bit
  if (scheme != SCHEME_W8A8 && ((long long)Nb * C_in * H * W >= lim ||
                                (long long)Nb * O * OH * OW >= lim ||
                                (long long)O * C * kh * kw >= lim ||
                                (long long)C * kh * kw * kh * kw >= (1LL << 32))) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const int* kp = static_cast<const int*>(kept);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool known;
  if (scheme == SCHEME_W8A8) {
    known = dispatch<SCHEME_W8A8>(x, w, wsf, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                  pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  } else if (scheme == SCHEME_W8) {
    known = dispatch<SCHEME_W8>(x, w, wsf, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  } else {
    known = dispatch<SCHEME_F32>(x, w, nullptr, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                 pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  }
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
