// The f32 / W8 GEMM body on the CUDA cores, for Hopper (sm_90a).  One loop
// serves the tiled entries (dense_matmul.cu, quant_matmul.cu: depth 1) and
// the pipelined ones (dense_matmul_pipelined.cu, quant_matmul_pipelined.cu:
// depth 2 / 3), in two operand layouts:
//
//   LAYOUT_ROW   x [M, K], w [K, N], out and side operands [M, N],
//                row-major;
//   LAYOUT_NCHW  x [nb, K, P], w [N, K] (a 1x1 OIHW filter), out and side
//                operands [nb, N, P] with P = OH * OW contiguous pixels,
//                M = nb * P: a 1x1 conv read and written where it lies,
//                with no permute around it.
//
//   out[m, n] = epi(sum_k x[m, k] * w[k, n])
//
// The sum is one f32 fmaf chain over k ascending from +0 (the zero-filled
// tail of the last slab included), then, in the order of the kernels this
// body replaced: * ws[n] (W8's rescale, one rounding), + bias[n] (another),
// the activation, the step program, one store.  No K split, no TF32, so
// every tile, depth and layout gives the same bits.  W8 widens each int8
// weight to f32 as it is staged.
//
// What bounds it: the CNN path's GEMMs (1x1 convs, K and N in 32..192) do
// a few FLOP per byte; at SR's expand shape (M = 4 * 256^2, K = 32, N =
// 192) the 201 MB output alone takes 0.060 ms at 3.35 TB/s and the FMAs
// 0.048 ms at 67 TFLOP/s, so the body has to keep both busy:
//
// * register blocking as in the conv's f32 body (conv2d.cu): a TM x TN
//   micro-tile of 4-pixel x 4-channel groups a thread, read from shared
//   memory as float4 (8 x 8 on the 128 x 64 tile, else 8 x 4: 128 threads
//   a CTA on every tile);
// * x slabs [BK][BM + 4] (k-major) through a ring of DEPTH + 1 slots by
//   cp.async, DEPTH slabs in flight, one barrier a slab; NCHW pixels come
//   by 16-byte copies where P % 4 == 0, row-major x is transposed by
//   4-byte copies; the w slab (L2-resident) goes through registers one
//   slab ahead, widened (W8) and transposed (NCHW) on its way;
// * persistent CTAs (as many as fit on the card at once), each walking its
//   tiles as one stream of slabs, so the next tile's first slabs load
//   while this tile's epilogue runs (one tile a CTA measured slower at K =
//   16..64 on every run);
// * the tiles of one x tile next to each other (the N tiles fastest), so x
//   comes from device memory about once;
// * an epilogue staged through a shared-memory tile (gemm_epi::store_tile):
//   one compact loop stores float4s along the contiguous axis (channels in
//   ROW, pixels in NCHW); inlining the step program at every register of
//   the micro-tile made the code, not the math, the cost.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "epilogue.cuh"
#include "pipelined_gemm.cuh"
#include "tiles.cuh"

enum { LAYOUT_ROW = 0, LAYOUT_NCHW = 1 };

namespace gemm_args {

// Operands and epilogue of one f32 / INT8 GEMM launch (both bodies).
struct Args {
  const void* x;
  const void* w;
  const float* ws;    // per-column rescale (INT8), or null
  const float* bias;  // or null
  float* out;
  int M, N, K, P;     // P: pixels an image (NCHW), else 1
  int act;
  StepProgram prog;
};

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// The output and every side operand aligned to `bytes`.
inline bool outs_aligned(const Args& a, int bytes) {
  if (!aligned(a.out, bytes)) return false;
  for (int i = 0; i < a.prog.n_sides; ++i) {
    if (!aligned(a.prog.sides[i], bytes)) return false;
  }
  return true;
}

// Every operand's offsets fit the bodies' 32-bit arithmetic.
inline bool fits_int32(const Args& a) {
  const long long lim = 1LL << 31;
  return (long long)a.M * a.K < lim && (long long)a.M * a.N < lim &&
         (long long)a.N * a.K < lim;
}

}  // namespace gemm_args

namespace gemm_epi {

// The bodies' output tile in shared memory, raw sums as f32: [BN][BM + 4]
// (NCHW: a channel's pixels contiguous) or [BM][BN + 4] (ROW: a pixel's
// channels contiguous), 16-byte rows.
template <int BM, int BN, int LAYOUT>
struct Tile {
  static constexpr int TP = LAYOUT == LAYOUT_ROW ? BN + 4 : BM + 4;  // row pitch
  static constexpr int FLOATS = (LAYOUT == LAYOUT_ROW ? BM : BN) * TP;
};

// The epilogue's rare paths, out of line: an activation other than relu
// (gelu's and silu's transcendentals), and a step program other than none
// or a lone residual add (read from its copy in shared memory, with the
// side values `sv[slot]` loaded by the caller).  Inlined at each of the
// tile loop's values, they made the loop's code, not its arithmetic, the
// kernels' cost (measured: the f32 body's time grew with the output count,
// not with K or occupancy).
static __device__ __noinline__ float act_rare(int act, float v) { return apply_act(act, v); }
static __device__ __noinline__ float steps_rare(const StepProgram* p, float v, const float* sv) {
  for (int s = 0; s < p->n_steps; ++s) {  // apply_pointwise_steps, on preloaded sides
    const int kind = p->kind[s], arg = p->arg[s];
    if (kind == STEP_ACT) {
      v = apply_act(arg, v);
    } else if (kind == STEP_ADD) {
      v += sv[arg];
    } else if (kind == STEP_MUL) {
      v *= sv[arg];
    }
  }
  return v;
}

// The epilogue of both bodies, from the tile to the output, in the order
// and roundings of the kernels it replaced: * ws[n] (INT8) then + bias[n],
// two roundings never fused (without a rescale or a bias they are 1 and
// -0, exact no-ops); the activation (relu inline); a lone residual add
// (inline) or the step program (out of line); one store.  Each thread
// takes 16-byte chunks along the output's contiguous axis -- 4 channels of
// a pixel (ROW) or 4 pixels of a channel (NCHW) -- so the side reads and
// the output stores are whole 16-byte words where `vec` says the layout and
// the pointers allow it (ROW: N % 4 == 0; NCHW: P % 4 == 0), scalar
// otherwise; a chunk's side values are all loaded before any is used.  The
// common programs (relu or no activation, then nothing or a lone residual
// add) take a loop with no call in it, chosen once a tile (7% and then 2-5%
// faster at SR's expand shape).
// `sprog` is the step program's copy in shared memory.
template <int BM, int BN, int NT, int LAYOUT>
__device__ __forceinline__ void store_tile(const float* __restrict__ tile,
                                           const float* __restrict__ ws,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int M, int N, int P, int m0,
                                           int n0, bool vec, int act, const StepProgram& prog,
                                           const StepProgram* sprog, int tid) {
  constexpr int TP = Tile<BM, BN, LAYOUT>::TP;
  const bool relu = act == ACT_RELU;
  const bool residual = prog.n_steps == 1 && prog.kind[0] == STEP_ADD;
  const int n_read = residual ? 1 : (prog.n_steps == 0 ? 0 : prog.n_sides);  // sides read
  const bool common = (relu || act == ACT_NONE) && (residual || prog.n_steps == 0);
  // one chunk: raw sums v, rescales, biases, output offsets `at` (-1 past
  // the edge; `full`: 4 consecutive, 16-byte aligned)
  auto emit = [&](auto common_path, const float(&v)[4], const float(&wsv)[4],
                  const float(&bv)[4], const int(&at)[4], bool full) {
    float sv[REPRO_MAX_SIDES][4];
#pragma unroll
    for (int i = 0; i < REPRO_MAX_SIDES; ++i) {
      if (i >= n_read) break;
      const float* sp = side_ptr(prog, residual ? prog.arg[0] : i);
      if (full) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(sp + at[0]));
        sv[i][0] = t.x;
        sv[i][1] = t.y;
        sv[i][2] = t.z;
        sv[i][3] = t.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) sv[i][c] = at[c] >= 0 ? __ldg(sp + at[c]) : 0.f;
      }
    }
    float r[4];
    if constexpr (decltype(common_path)::value) {  // no call: relu or none, then a residual add or nothing
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fadd_rn(__fmul_rn(v[c], wsv[c]), bv[c]);
        if (relu) x = x > 0.f ? x : 0.f;  // apply_act's relu
        r[c] = residual ? __fadd_rn(x, sv[0][c]) : x;
      }
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = __fadd_rn(__fmul_rn(v[c], wsv[c]), bv[c]);
        x = relu ? (x > 0.f ? x : 0.f) : act_rare(act, x);
        if (residual) {
          x = __fadd_rn(x, sv[0][c]);
        } else if (n_read > 0 || prog.n_steps > 0) {
          float e[REPRO_MAX_SIDES];
#pragma unroll
          for (int i = 0; i < REPRO_MAX_SIDES; ++i) e[i] = i < n_read ? sv[i][c] : 0.f;
          x = steps_rare(sprog, x, e);
        }
        r[c] = x;
      }
    }
    if (full) {
      *reinterpret_cast<float4*>(out + at[0]) = make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (at[c] >= 0) out[at[c]] = r[c];
    }
  };
  if constexpr (LAYOUT == LAYOUT_ROW) {
    constexpr int CPR = BN / 4;  // chunks of a pixel's row
    static_assert(NT % CPR == 0 && BM % (NT / CPR) == 0, "whole chunks a thread");
    const int c4 = 4 * (tid % CPR), n = n0 + c4;
    if (n >= N) return;
    float wsv[4], bv[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      wsv[c] = (ws && n + c < N) ? __ldg(ws + n + c) : 1.f;
      bv[c] = (bias && n + c < N) ? __ldg(bias + n + c) : -0.f;
    }
    const bool full = vec && n + 3 < N;
    auto rows = [&](auto common_path) {
#pragma unroll 2
      for (int mm = tid / CPR; mm < BM; mm += NT / CPR) {
        const int m = m0 + mm;
        if (m >= M) break;
        const float4 a = *reinterpret_cast<const float4*>(tile + mm * TP + c4);
        const float v[4] = {a.x, a.y, a.z, a.w};
        int at[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) at[c] = n + c < N ? m * N + n + c : -1;
        emit(common_path, v, wsv, bv, at, full);
      }
    };
    if (common) {
      rows(std::true_type{});
    } else {
      rows(std::false_type{});
    }
  } else {
    constexpr int CPR = BM / 4;  // chunks of a channel's row
    static_assert(NT % CPR == 0 && BN % (NT / CPR) == 0, "whole chunks a thread");
    const int m4 = 4 * (tid % CPR), mg = m0 + m4;
    if (mg >= M) return;
    int ob[4];  // each pixel's offset in the output (-1 past M)
#pragma unroll
    for (int ii = 0; ii < 4; ++ii) {
      const int m = mg + ii;
      const int img = m / P;
      ob[ii] = m < M ? img * N * P + (m - img * P) : -1;
    }
    const bool full = vec && ob[3] == ob[0] + 3;  // P % 4 == 0: one image, 16-byte aligned
    auto channels = [&](auto common_path) {
#pragma unroll 2
      for (int nn = tid / CPR; nn < BN; nn += NT / CPR) {
        const int n = n0 + nn;
        if (n >= N) break;
        const float w1 = ws ? __ldg(ws + n) : 1.f, b1 = bias ? __ldg(bias + n) : -0.f;
        const float wsv[4] = {w1, w1, w1, w1}, bv[4] = {b1, b1, b1, b1};
        const float4 a = *reinterpret_cast<const float4*>(tile + nn * TP + m4);
        const float v[4] = {a.x, a.y, a.z, a.w};
        int at[4];
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) at[ii] = ob[ii] >= 0 ? ob[ii] + n * P : -1;
        emit(common_path, v, wsv, bv, at, full);
      }
    };
    if (common) {
      channels(std::true_type{});
    } else {
      channels(std::false_type{});
    }
  }
}

}  // namespace gemm_epi

namespace simt_gemm {

using gemm_args::Args;

// The thread layout of a tile (BM, BN, BK) of tiles.cuh's GEMM lists
// (_build.gemm_shape derives the same): TX threads along pixels, TY along
// channels; thread (tx, ty) owns pixels g * 4 * TX + 4 * tx + {0..3} and
// channels g * 4 * TY + 4 * ty + {0..3}; a warp is LX x LY of them, so its
// float4 reads of a slab row touch 8 and 4 distinct 16-byte words.
template <int BM, int BN, int BK, int DEPTH>
struct Shape {
  static constexpr int TM = 8;
  static constexpr int TN = BM * BN / 64 >= 128 ? 8 : 4;
  static constexpr int TX = BM / TM, TY = BN / TN, NT = TX * TY;
  static constexpr int LY = TY < 4 ? TY : 4, LX = 32 / LY, WX = TX / LX;
  static constexpr int SLOTS = DEPTH + 1;
  static constexpr int AP = BM + 4;  // x slab row (float4-aligned pad)
  static constexpr int BP = BN + 4;  // w slab row
  static constexpr int FPT = BK * BN / NT;  // w elements a thread stages (whole quads)
  static constexpr int UNROLL = TN == 8 ? 2 : 4;
  static constexpr int RING = SLOTS * BK * AP + 2 * BK * BP;  // floats of the slabs
  static constexpr int TILE = gemm_epi::Tile<BM, BN, LAYOUT_ROW>::FLOATS >
                                      gemm_epi::Tile<BM, BN, LAYOUT_NCHW>::FLOATS
                                  ? gemm_epi::Tile<BM, BN, LAYOUT_ROW>::FLOATS
                                  : gemm_epi::Tile<BM, BN, LAYOUT_NCHW>::FLOATS;
  static constexpr int SMEM = (RING + TILE) * (int)sizeof(float);  // dynamic
  static_assert(DEPTH >= 1 && DEPTH <= 3, "ring depth 1..3");
  static_assert(BM % TM == 0 && BN % TN == 0 && TN % 4 == 0, "whole micro-tiles");
  static_assert(TX % LX == 0 && TY % LY == 0 && NT % 32 == 0, "whole warps");
  static_assert((BK * BN) % NT == 0 && FPT % 4 == 0, "whole w quads a thread");
  static_assert(NT % BK == 0 && BM % (NT / BK) == 0, "row-major x: whole pixels a thread");
  static_assert(NT % BM == 0 && BK % (NT / BM) == 0, "NCHW x, 4-byte copies: whole k a thread");
  static_assert(NT % (BM / 4) == 0 && BK % (NT / (BM / 4)) == 0,
                "NCHW x, 16-byte copies: whole k a thread");
  static_assert(SMEM <= 227 * 1024, "shared memory of one block");
};

enum { F_VEC = 1, F_WVEC = 2 };

// Four consecutive weights as one load: a float4 (f32) or a char4 (W8).
template <typename WG>
struct Quad;
template <>
struct Quad<float> {
  using V = float4;
  static constexpr int BYTES = 16;
  static __device__ __forceinline__ V zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Quad<int8_t> {
  using V = char4;
  static constexpr int BYTES = 4;
  static __device__ __forceinline__ V zero() { return make_char4(0, 0, 0, 0); }
};

// WG: the weights' type (float for f32, int8_t for W8).  flags: F_VEC --
// ROW, N % 4 == 0 and 16-byte aligned output / sides (float4 stores);
// NCHW, also P % 4 == 0 and x aligned (16-byte x copies, float4 stores
// along pixels); F_WVEC -- w read 4 elements at a time (its contiguous
// extent a multiple of 4, the pointer aligned).
//
// Persistent: CTA b takes the tiles b, b + gridDim.x, ... (the N tiles of an
// x tile next to each other), and its steps run over (tile, slab) pairs as
// one stream, so the ring's prefetch crosses into the next tile: that
// tile's first slabs load while this one's epilogue runs.
template <typename WG, int BM, int BN, int BK, int DEPTH, int LAYOUT>
__global__ void __launch_bounds__(Shape<BM, BN, BK, DEPTH>::NT, 512 / Shape<BM, BN, BK, DEPTH>::NT)
    simt_gemm_kernel(const float* __restrict__ x, const WG* __restrict__ w,
                     const float* __restrict__ ws, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int N, int K, int P, int flags, int act,
                     StepProgram prog) {
  using Sh = Shape<BM, BN, BK, DEPTH>;
  constexpr int TM = Sh::TM, TN = Sh::TN, TX = Sh::TX, TY = Sh::TY, NT = Sh::NT;
  constexpr int LX = Sh::LX, LY = Sh::LY, WX = Sh::WX, S = Sh::SLOTS;
  constexpr int AP = Sh::AP, BP = Sh::BP, FPT = Sh::FPT;
  // the slab ring, then the output tile of the epilogue
  extern __shared__ __align__(16) float smem[];
  auto As = reinterpret_cast<float(*)[BK][AP]>(smem);
  auto Bs = reinterpret_cast<float(*)[BK][BP]>(smem + S * BK * AP);
  float* tile = smem + Sh::RING;
  __shared__ StepProgram sprog;  // read by the epilogue's rare path (after a barrier)
  if (threadIdx.x == 0) sprog = prog;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = (warp % WX) * LX + lane % LX;
  const int ty = (warp / WX) * LY + lane / LX;
  const int ntn = (N + BN - 1) / BN;
  const int tiles = ((M + BM - 1) / BM) * ntn;
  const int nslab = K > 0 ? (K + BK - 1) / BK : 1;  // K = 0: one zero-filled slab
  const int steps = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * nslab;
  // a position in the stream: the tile's origin (m0, n0) and a slab k0; the
  // next tile is gridDim.x tiles on, stepped without a division
  const int g_m = (int)gridDim.x / ntn * BM, g_n = (int)gridDim.x % ntn * BN;
  struct Cursor {
    int k0, m0, n0;
  };
  auto advance = [&](Cursor& c) {  // true when it enters the next tile
    c.k0 += BK;
    if (c.k0 < nslab * BK) return false;
    c.k0 = 0;
    c.m0 += g_m;
    c.n0 += g_n;
    if (c.n0 >= ntn * BN) {
      c.n0 -= ntn * BN;
      c.m0 += BM;
    }
    return true;
  };
  const Cursor first{0, (int)blockIdx.x / ntn * BM, (int)blockIdx.x % ntn * BN};
  Cursor xc = first, wc = first, cur = first;  // the next x slab, the next w slab, this step
  const bool vec = flags & F_VEC, wvec = flags & F_WVEC;

  // x: the thread's fixed share of every slab.  ROW: k xk, pixels xm + j *
  // (NT / BK); NCHW: pixel (group) xm over every (NT / BM)-th or (NT / (BM
  // / 4))-th k from xk, at xoff in x (-1 past M), found once a tile
  int xk, xm, xoff = -1;
  if constexpr (LAYOUT == LAYOUT_ROW) {
    xk = tid % BK;
    xm = tid / BK;
  } else {
    xm = vec ? 4 * (tid % (BM / 4)) : tid % BM;
    xk = vec ? tid / (BM / 4) : tid / BM;
  }
  auto locate = [&]() {
    if constexpr (LAYOUT == LAYOUT_NCHW) {
      const int m = xc.m0 + xm;
      const int img = m / P;
      xoff = m < M ? img * K * P + (m - img * P) : -1;
    }
  };
  locate();
  auto issue_x = [&](int u) {  // the slab at xc into slot u % S, by cp.async (not committed)
    float(*dst)[AP] = As[u % S];
    if constexpr (LAYOUT == LAYOUT_ROW) {
      constexpr int R = NT / BK;
      const int k = xc.k0 + xk;
#pragma unroll
      for (int j = 0; j < BM / R; ++j) {
        const int mm = xm + j * R, m = xc.m0 + mm;
        const bool ok = k < K && m < M;
        pipelined::cp_async4(&dst[xk][mm], x + (ok ? m * K + k : 0), ok ? 4 : 0);
      }
    } else if (vec) {
      constexpr int R = NT / (BM / 4);
#pragma unroll
      for (int j = 0; j < BK / R; ++j) {
        const int kk = xk + j * R, k = xc.k0 + kk;
        const bool ok = xoff >= 0 && k < K;
        pipelined::cp_async16(&dst[kk][xm], x + (ok ? xoff + k * P : 0), ok ? 16 : 0);
      }
    } else {
      constexpr int R = NT / BM;
#pragma unroll
      for (int j = 0; j < BK / R; ++j) {
        const int kk = xk + j * R, k = xc.k0 + kk;
        const bool ok = xoff >= 0 && k < K;
        pipelined::cp_async4(&dst[kk][xm], x + (ok ? xoff + k * P : 0), ok ? 4 : 0);
      }
    }
    if (advance(xc)) locate();
  };

  // w: FPT elements a thread, one step ahead in registers, 4 consecutive
  // along its contiguous axis where wvec allows (ROW reads w [K, N] along
  // n, NCHW w [N, K] along k: coalesced either way), else one at a time
  using Q = Quad<WG>;
  WG wreg[FPT];
  auto w_at = [&](int e, int& kk, int& nn) {  // element e of the slab (scalar path)
    if constexpr (LAYOUT == LAYOUT_ROW) {
      nn = e % BN;
      kk = e / BN;
    } else {
      kk = e % BK;
      nn = e / BK;
    }
  };
  auto q_at = [&](int q, int& kk, int& nn) {  // quad q of the slab: its first element
    if constexpr (LAYOUT == LAYOUT_ROW) {
      nn = (q % (BN / 4)) * 4;
      kk = q / (BN / 4);
    } else {
      kk = (q % (BK / 4)) * 4;
      nn = q / (BK / 4);
    }
  };
  auto load_w = [&]() {  // the slab at wc
    if (wvec) {
#pragma unroll
      for (int i = 0; i < FPT / 4; ++i) {
        int kk, nn;
        q_at(tid + i * NT, kk, nn);
        const int k = wc.k0 + kk, n = wc.n0 + nn;
        const bool ok = k < K && n < N;  // the quad lies inside with its first element
        const typename Q::V v = ok ? __ldg(reinterpret_cast<const typename Q::V*>(
                                         w + (LAYOUT == LAYOUT_ROW ? k * N + n : n * K + k)))
                                   : Q::zero();
        wreg[4 * i] = v.x;
        wreg[4 * i + 1] = v.y;
        wreg[4 * i + 2] = v.z;
        wreg[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        int kk, nn;
        w_at(tid + i * NT, kk, nn);
        const int k = wc.k0 + kk, n = wc.n0 + nn;
        const int off = LAYOUT == LAYOUT_ROW ? k * N + n : n * K + k;
        wreg[i] = (k < K && n < N) ? __ldg(w + off) : WG(0);
      }
    }
    advance(wc);
  };
  auto store_w = [&](int buf) {
    if (wvec) {
#pragma unroll
      for (int i = 0; i < FPT / 4; ++i) {
        int kk, nn;
        q_at(tid + i * NT, kk, nn);
        if constexpr (LAYOUT == LAYOUT_ROW) {
          *reinterpret_cast<float4*>(&Bs[buf][kk][nn]) =
              make_float4(float(wreg[4 * i]), float(wreg[4 * i + 1]), float(wreg[4 * i + 2]),
                          float(wreg[4 * i + 3]));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) Bs[buf][kk + c][nn] = float(wreg[4 * i + c]);
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < FPT; ++i) {
        int kk, nn;
        w_at(tid + i * NT, kk, nn);
        Bs[buf][kk][nn] = float(wreg[i]);
      }
    }
  };

  // warm-up: DEPTH steps of x in flight (a group each, empty past the
  // last), the first w slab in place
#pragma unroll
  for (int p = 0; p < DEPTH; ++p) {
    if (p < steps) issue_x(p);
    pipelined::cp_async_commit();
  }
  if (steps > 0) {
    load_w();
    store_w(0);
  }
  float acc[TM][TN];
  for (int u = 0; u < steps; ++u) {
    if (cur.k0 == 0) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
    }
    pipelined::cp_async_wait<DEPTH - 1>();  // step u's copies (this thread's) landed
    __syncthreads();  // ... every thread's; step u - 1's readers are done
    if (u + DEPTH < steps) issue_x(u + DEPTH);  // into the slot step u - 1 read
    pipelined::cp_async_commit();
    if (u + 1 < steps) load_w();  // in flight during this step's FMAs
    const float(*a_s)[AP] = As[u % S];
    const float(*b_s)[BP] = Bs[u & 1];
#pragma unroll (Sh::UNROLL)
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&a_s[kk][g * 4 * TX + 4 * tx]);
        a[4 * g] = v.x;
        a[4 * g + 1] = v.y;
        a[4 * g + 2] = v.z;
        a[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(&b_s[kk][g * 4 * TY + 4 * ty]);
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
    if (u + 1 < steps) store_w((u + 1) & 1);  // step u - 1's readers passed the barrier
    const int m0 = cur.m0, n0 = cur.n0;
    if (!advance(cur)) continue;

    // the tile's epilogue, while the next tile's first slabs load: the sums
    // into the output tile (float4 rows; its last readers, the previous
    // tile's, passed this step's barrier), then gemm_epi::store_tile's pass
    constexpr int TP = gemm_epi::Tile<BM, BN, LAYOUT>::TP;
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const int ml = g * 4 * TX + 4 * tx;
      if constexpr (LAYOUT == LAYOUT_ROW) {
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int gn = 0; gn < TN / 4; ++gn)
            *reinterpret_cast<float4*>(&tile[(ml + ii) * TP + gn * 4 * TY + 4 * ty]) =
                make_float4(acc[4 * g + ii][4 * gn], acc[4 * g + ii][4 * gn + 1],
                            acc[4 * g + ii][4 * gn + 2], acc[4 * g + ii][4 * gn + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          const int nl = (j / 4) * 4 * TY + 4 * ty + (j % 4);
          *reinterpret_cast<float4*>(&tile[nl * TP + ml]) = make_float4(
              acc[4 * g][j], acc[4 * g + 1][j], acc[4 * g + 2][j], acc[4 * g + 3][j]);
        }
      }
    }
    __syncthreads();
    gemm_epi::store_tile<BM, BN, NT, LAYOUT>(tile, ws, bias, out, M, N, P, m0, n0, vec, act,
                                             prog, &sprog, tid);
  }
  pipelined::cp_async_wait<0>();  // the tail groups are empty
}

template <typename WG, int BM, int BN, int BK, int DEPTH, int LAYOUT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using Sh = Shape<BM, BN, BK, DEPTH>;
  auto kernel = simt_gemm_kernel<WG, BM, BN, BK, DEPTH, LAYOUT>;
  // the CTAs resident on the card at once (the occupancy calculator's
  // count an SM, times the SMs), found at the first launch
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Sh::SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Sh::NT, Sh::SMEM);
    if (e == cudaSuccess) e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    resident = per_sm * sms;
  }
  // flags: see the kernel; ROW stages x by 4-byte copies whatever its
  // alignment
  const bool vec = LAYOUT == LAYOUT_ROW
                       ? a.N % 4 == 0 && gemm_args::outs_aligned(a, 16)
                       : a.P % 4 == 0 && gemm_args::aligned(a.x, 16) &&
                             gemm_args::outs_aligned(a, 16);
  const bool wvec = (LAYOUT == LAYOUT_ROW ? a.N : a.K) % 4 == 0 &&
                    gemm_args::aligned(a.w, Quad<WG>::BYTES);
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  const int grid = (int)(tiles < resident ? tiles : resident);
  kernel<<<grid, Sh::NT, Sh::SMEM, st>>>(static_cast<const float*>(a.x),
                                          static_cast<const WG*>(a.w), a.ws, a.bias, a.out, a.M,
                                          a.N, a.K, a.P, (vec ? F_VEC : 0) | (wvec ? F_WVEC : 0),
                                          a.act, a.prog);
  return cudaGetLastError();
}

// Launch the tile (bm, bn, bk, depth) of tiles.cuh's tiled list (PIPELINED
// false: depth 1) or pipelined list (depth 2 / 3) in `layout`; any other
// tile gives cudaErrorInvalidValue.
template <typename WG, bool PIPELINED>
cudaError_t run(const Args& a, int layout, int bm, int bn, int bk, int depth, cudaStream_t st) {
  if (!gemm_args::fits_int32(a)) return cudaErrorInvalidValue;
  if constexpr (PIPELINED) {
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                             \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                           \
    return layout == LAYOUT_NCHW ? launch<WG, BM, BN, BK, DEPTH, LAYOUT_NCHW>(a, st)  \
                                 : launch<WG, BM, BN, BK, DEPTH, LAYOUT_ROW>(a, st); \
  }
    REPRO_GEMM_PIPELINED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  } else {
#define REPRO_TRY_TILE(BM, BN, BK)                                                \
  if (bm == BM && bn == BN && bk == BK && depth == 1) {                           \
    return layout == LAYOUT_NCHW ? launch<WG, BM, BN, BK, 1, LAYOUT_NCHW>(a, st)  \
                                 : launch<WG, BM, BN, BK, 1, LAYOUT_ROW>(a, st); \
  }
    REPRO_GEMM_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  }
  return cudaErrorInvalidValue;
}

}  // namespace simt_gemm
