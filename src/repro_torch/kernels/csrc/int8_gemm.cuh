// The W8A8 GEMM body on int8 tensor cores, for Hopper (sm_90a): int8 x
// int8 products summed exactly in int32 by mma.sync m16n8k32 s8, one loop
// for the tiled (quant_matmul.cu: depth 1) and pipelined
// (quant_matmul_pipelined.cu: depth 2 / 3) entries, in simt_gemm.cuh's two
// layouts (ROW: x [M, K], w [K, N]; NCHW: x [nb, K, P], w [N, K]; out and
// sides [M, N] / [nb, N, P]).  Then, in the order of the kernel it
// replaced: int32 -> f32, * ws[n], + bias[n] (two roundings, never fused),
// the activation, the step program, one store (the f32 body's
// gemm_epi::store_tile).  Integer sums are exact in any order, so every
// tile, depth and layout gives the same bits, and those of the plain
// version.
//
// The mma wants both operands k-contiguous in shared memory: a slab is
// As[BM][BK8] and Bs[BN][BK8] bytes (rows padded by 16 bytes so an
// ldmatrix's 8 rows fall on distinct banks).  An operand stored [rows, K]
// (row-major x, an NCHW layer's w [N, K]) is already so: its slabs come by
// 16-byte cp.async through a ring of DEPTH + 1 slots where K % 16 == 0,
// else as 4-byte words packed from byte loads.  An operand stored [K,
// cols] per image (NCHW x [K, P], row-major w [K, N]) is transposed on its
// way: each thread loads 4 k rows x 4 columns as four 32-bit words and
// turns them into four words of 4 k each with eight byte permutes (byte
// loads where the columns are not 4-aligned); these slabs go through
// registers one slab ahead.  One barrier a slab.
//
// Tile, from a tiles.cuh tuple (BM, BN, BK) (_build.gemm_w8a8_shape
// derives the same): BK8 = 4 * BK k a slab (a multiple of the mma's 32),
// warps of 32 x min(BN, 32) outputs (two m16 blocks by NI n8 blocks).
//
// What bounds it: bytes.  The apps' W8A8 1x1 convs (coloring: 4 x 64^2
// pixels, 128 -> 64 channels) read 1 byte a term and write 4 bytes an
// output: 6.3 MB, 0.0019 ms at 3.35 TB/s, against 0.0001 ms of int8 mma.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "imma.cuh"
#include "pipelined_gemm.cuh"
#include "simt_gemm.cuh"
#include "tiles.cuh"

namespace int8_gemm {

using gemm_args::Args;

template <int BM, int BN, int BK, int DEPTH>
struct Shape {
  static constexpr int BK8 = 4 * BK;             // k a slab
  static constexpr int WTN = BN < 32 ? BN : 32;  // a warp's channels
  static constexpr int NI = WTN / 8;             // n8 blocks a warp
  static constexpr int WM = BM / 32, WN = BN / WTN, NT = WM * WN * 32;
  static constexpr int SLOTS = DEPTH + 1;
  static constexpr int AP = BK8 + 16;  // slab row in bytes
  static constexpr int GW = BK8 / 4;   // k quads (4-byte words) of a slab row
  static constexpr int XU = (BM / 4) * GW / NT;  // 4 x 4 transpose units of x a thread (NCHW)
  static constexpr int WU = (BN / 4) * GW / NT;  // ... of w (ROW)
  static constexpr int RING = SLOTS * (BM + BN) * AP;  // bytes of the slabs
  static constexpr int TILE = 4 * (gemm_epi::Tile<BM, BN, LAYOUT_ROW>::FLOATS >
                                           gemm_epi::Tile<BM, BN, LAYOUT_NCHW>::FLOATS
                                       ? gemm_epi::Tile<BM, BN, LAYOUT_ROW>::FLOATS
                                       : gemm_epi::Tile<BM, BN, LAYOUT_NCHW>::FLOATS);
  static constexpr int SMEM = RING > TILE ? RING : TILE;
  static_assert(DEPTH >= 1 && DEPTH <= 3, "ring depth 1..3");
  static_assert(BM % 32 == 0 && BN % WTN == 0 && WTN % 8 == 0, "whole warp tiles");
  static_assert(BK8 % 32 == 0, "whole k32 steps");
  static_assert(NT % GW == 0 && XU * NT == (BM / 4) * GW && WU * NT == (BN / 4) * GW,
                "whole transpose units a thread");
};

// Slab rows of a [rows, K] operand (k contiguous) by 16-byte cp.async:
// rows r0 .. r0 + R of g into s (R rows of AP bytes), zero past the edges.
template <int R, int BK8, int AP, int NT>
__device__ __forceinline__ void copy_rows(int8_t* s, const int8_t* g, int r0, int rows, int K,
                                          int k0, int tid) {
  for (int e = tid; e < R * (BK8 / 16); e += NT) {
    const int r = e / (BK8 / 16), c = (e % (BK8 / 16)) * 16;
    const int gr = r0 + r, k = k0 + c;
    const bool ok = gr < rows && k < K;
    pipelined::cp_async16(s + r * AP + c, ok ? g + gr * K + k : g, ok ? 16 : 0);
  }
}

// The same rows for any K: 4-byte words packed from byte loads and stored
// at once (the unaligned case, off the main path).
template <int R, int GW, int AP, int NT>
__device__ __forceinline__ void copy_row_words(int8_t* s, const int8_t* g, int r0, int rows,
                                               int K, int k0, int tid) {
  for (int e = tid; e < R * GW; e += NT) {
    const int gr = r0 + e / GW, k = k0 + (e % GW) * 4;
    uint32_t word = 0;
    if (gr < rows) {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (k + b < K) word |= (uint32_t)(uint8_t)__ldg(g + gr * K + k + b) << (8 * b);
    }
    *reinterpret_cast<uint32_t*>(s + (e / GW) * AP + (e % GW) * 4) = word;
  }
}

// (4 words of 4 columns, one k each) -> (4 words of 4 k, one column each)
__device__ __forceinline__ void transpose4(uint32_t (&v)[4]) {
  const uint32_t t0 = __byte_perm(v[0], v[1], 0x5140), t1 = __byte_perm(v[2], v[3], 0x5140);
  const uint32_t t2 = __byte_perm(v[0], v[1], 0x7362), t3 = __byte_perm(v[2], v[3], 0x7362);
  v[0] = __byte_perm(t0, t1, 0x5410);
  v[1] = __byte_perm(t0, t1, 0x7632);
  v[2] = __byte_perm(t2, t3, 0x5410);
  v[3] = __byte_perm(t2, t3, 0x7632);
}

// A [K, cols] operand per image (image stride K * P, row stride P; the
// columns c of image c / P at c % P), transposed into k-contiguous slab
// rows.  The thread's units: k quad tid % GW, column quads tid / GW + u *
// (NT / GW); cbase[u] is the quad's offset (-1 past the columns) where the
// quad lies in one image with 4-aligned words (c4), else unused.
template <int U, int GW, int NT>
struct ColStager {
  uint32_t reg[U][4];
  int cbase[U];

  __device__ __forceinline__ void init(int c0, int ncols, int P, int K, bool c4, int tid) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + 4 * (tid / GW + u * (NT / GW));
      cbase[u] = -1;
      if (c4 && c < ncols) {
        const int img = c / P;
        cbase[u] = img * K * P + (c - img * P);
      }
    }
  }
  __device__ __forceinline__ void load(const int8_t* g, int c0, int ncols, int P, int K, int k0,
                                       bool c4, int tid) {
    const int k = k0 + 4 * (tid % GW);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (c4) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          reg[u][r] = cbase[u] >= 0 && k + r < K
                          ? __ldg(reinterpret_cast<const unsigned*>(g + cbase[u] + (k + r) * P))
                          : 0u;
        }
        transpose4(reg[u]);
      } else {
        const int c = c0 + 4 * (tid / GW + u * (NT / GW));
#pragma unroll
        for (int ii = 0; ii < 4; ++ii) {
          uint32_t word = 0;
          if (c + ii < ncols) {
            const int img = (c + ii) / P;
            const int off = img * K * P + (c + ii - img * P);
#pragma unroll
            for (int r = 0; r < 4; ++r)
              if (k + r < K) word |= (uint32_t)(uint8_t)__ldg(g + off + (k + r) * P) << (8 * r);
          }
          reg[u][ii] = word;
        }
      }
    }
  }
  template <int AP>
  __device__ __forceinline__ void store(int8_t* s, int tid) const {
    const int kq = tid % GW;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int cq = tid / GW + u * (NT / GW);
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
        *reinterpret_cast<uint32_t*>(s + (4 * cq + ii) * AP + 4 * kq) = reg[u][ii];
    }
  }
};

// flags: K16 (the [rows, K] operand by 16-byte copies), C4 (the [K, cols]
// operand's columns in 4-aligned words), VEC (gemm_epi::store_tile's
// 16-byte stores).
enum { F_K16 = 1, F_C4 = 2, F_VEC = 4 };

template <int BM, int BN, int BK, int DEPTH, int LAYOUT>
__global__ void __launch_bounds__(Shape<BM, BN, BK, DEPTH>::NT)
    int8_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ ws, const float* __restrict__ bias,
                     float* __restrict__ out, int M, int N, int K, int P, int flags, int act,
                     StepProgram prog) {
  using Sh = Shape<BM, BN, BK, DEPTH>;
  constexpr int BK8 = Sh::BK8, WTN = Sh::WTN, NI = Sh::NI, NT = Sh::NT, S = Sh::SLOTS;
  constexpr int AP = Sh::AP, GW = Sh::GW;
  constexpr bool ROW = LAYOUT == LAYOUT_ROW;
  extern __shared__ __align__(16) unsigned char smem[];
  auto As = reinterpret_cast<int8_t(*)[BM][AP]>(smem);
  auto Bs = reinterpret_cast<int8_t(*)[BN][AP]>(smem + S * BM * AP);
  __shared__ StepProgram sprog;  // read by the epilogue's rare path (after a barrier)
  if (threadIdx.x == 0) sprog = prog;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % Sh::WM, wn = warp / Sh::WM;
  const int ntn = (N + BN - 1) / BN;
  const int m0 = (int)(blockIdx.x / ntn) * BM;  // the N tiles of an x tile are neighbours
  const int n0 = (int)(blockIdx.x % ntn) * BN;
  const int nslab = (K + BK8 - 1) / BK8;
  const bool k16 = flags & F_K16, c4 = flags & F_C4;

  // ROW: x [M, K] by rows, w [K, N] transposed; NCHW: x [K, P] per image
  // transposed, w [N, K] by rows
  const int8_t* rsrc = ROW ? x : w;
  const int r0 = ROW ? m0 : n0, nrows = ROW ? M : N;
  constexpr int RR = ROW ? BM : BN;  // rows of the row operand's slab
  const int8_t* csrc = ROW ? w : x;
  const int c0 = ROW ? n0 : m0, ncols = ROW ? N : M, cP = ROW ? N : P;
  ColStager<ROW ? Sh::WU : Sh::XU, GW, NT> cst;
  cst.init(c0, ncols, cP, K, c4, tid);
  auto rows_slot = [&](int t) { return ROW ? &As[t % S][0][0] : &Bs[t % S][0][0]; };
  auto cols_slot = [&](int t) { return ROW ? &Bs[t % S][0][0] : &As[t % S][0][0]; };

  int acc[2][NI][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  // warm-up: DEPTH slabs of the row operand in flight by cp.async (K16), the
  // first slab of the register-staged operands in place
#pragma unroll
  for (int p = 0; p < DEPTH; ++p) {
    if (k16 && p < nslab)
      copy_rows<RR, BK8, AP, NT>(rows_slot(p), rsrc, r0, nrows, K, p * BK8, tid);
    pipelined::cp_async_commit();
  }
  if (nslab > 0) {
    cst.load(csrc, c0, ncols, cP, K, 0, c4, tid);
    cst.template store<AP>(cols_slot(0), tid);
    if (!k16) copy_row_words<RR, GW, AP, NT>(rows_slot(0), rsrc, r0, nrows, K, 0, tid);
  }
  // per-lane ldmatrix rows: A rows lane % 16, k half lane / 16; B channels
  // lane % 8 + 8 * (lane / 16), k half (lane / 8) % 2
  const int a_row = wm * 32 + (lane & 15), a_k = (lane >> 4) * 16;
  const int b_row = wn * WTN + (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 16;
  for (int t = 0; t < nslab; ++t) {
    pipelined::cp_async_wait<DEPTH - 1>();
    __syncthreads();  // slab t landed; slab t - 1's readers are done
    if (k16 && t + DEPTH < nslab)
      copy_rows<RR, BK8, AP, NT>(rows_slot(t + DEPTH), rsrc, r0, nrows, K, (t + DEPTH) * BK8, tid);
    pipelined::cp_async_commit();
    // the next slab's columns, in flight during this slab's mma
    if (t + 1 < nslab) cst.load(csrc, c0, ncols, cP, K, (t + 1) * BK8, c4, tid);
    const int8_t(*a_s)[AP] = As[t % S];
    const int8_t(*b_s)[AP] = Bs[t % S];
#pragma unroll
    for (int ks = 0; ks < BK8 / 32; ++ks) {
      uint32_t a[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) imma::ldsm_x4(a[i], &a_s[a_row + i * 16][ks * 32 + a_k]);
      if constexpr (NI == 1) {
        uint32_t b[2];
        imma::ldsm_x2(b, &b_s[b_row][ks * 32 + b_k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) imma::mma_s8(acc[i][0], a[i], b[0], b[1]);
      } else {
#pragma unroll
        for (int jj = 0; jj < NI / 2; ++jj) {
          uint32_t b[4];
          imma::ldsm_x4(b, &b_s[b_row + jj * 16][ks * 32 + b_k]);
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            imma::mma_s8(acc[i][2 * jj], a[i], b[0], b[1]);
            imma::mma_s8(acc[i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
    }
    if (t + 1 < nslab) {  // into slot (t + 1) % S: its readers passed the barrier
      cst.template store<AP>(cols_slot(t + 1), tid);
      if (!k16) copy_row_words<RR, GW, AP, NT>(rows_slot(t + 1), rsrc, r0, nrows, K, (t + 1) * BK8,
                                              tid);
    }
  }
  pipelined::cp_async_wait<0>();

  // epilogue: the sums as f32 (one rounding, as before) into the output
  // tile, then gemm_epi::store_tile's pass; accumulator element e of
  // fragment (i, j) is pixel row lane / 4 (+ 8 for e >= 2), channel 2 *
  // (lane % 4) (+ 1 for odd e)
  __syncthreads();  // every warp's last slab reads are done: the tile reuses them
  float* tile = reinterpret_cast<float*>(smem);
  constexpr int TP = gemm_epi::Tile<BM, BN, LAYOUT>::TP;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ml = wm * 32 + i * 16 + (lane >> 2) + (e >> 1) * 8;
        const int nl = wn * WTN + j * 8 + 2 * (lane & 3) + (e & 1);
        tile[ROW ? ml * TP + nl : nl * TP + ml] = (float)acc[i][j][e];
      }
  __syncthreads();
  gemm_epi::store_tile<BM, BN, NT, LAYOUT>(tile, ws, bias, out, M, N, P, m0, n0, flags & F_VEC,
                                           act, prog, &sprog, tid);
}

template <int BM, int BN, int BK, int DEPTH, int LAYOUT>
cudaError_t launch(const Args& a, cudaStream_t st) {
  using Sh = Shape<BM, BN, BK, DEPTH>;
  constexpr bool ROW = LAYOUT == LAYOUT_ROW;
  const void* rows = ROW ? a.x : a.w;  // [rows, K]
  const void* cols = ROW ? a.w : a.x;  // [K, cols] per image
  const int cP = ROW ? a.N : a.P;
  int flags = 0;
  if (a.K % 16 == 0 && gemm_args::aligned(rows, 16)) flags |= F_K16;
  if (cP % 4 == 0 && gemm_args::aligned(cols, 4)) flags |= F_C4;
  if ((ROW ? a.N : a.P) % 4 == 0 && gemm_args::outs_aligned(a, 16)) flags |= F_VEC;
  auto kernel = int8_gemm_kernel<BM, BN, BK, DEPTH, LAYOUT>;
  if constexpr (Sh::SMEM > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sh::SMEM);
    if (e != cudaSuccess) return e;
  }
  const long long tiles = (long long)((a.M + BM - 1) / BM) * ((a.N + BN - 1) / BN);
  kernel<<<(unsigned)tiles, Sh::NT, Sh::SMEM, st>>>(
      static_cast<const int8_t*>(a.x), static_cast<const int8_t*>(a.w), a.ws, a.bias, a.out,
      a.M, a.N, a.K, a.P, flags, a.act, a.prog);
  return cudaGetLastError();
}

// As simt_gemm::run, for W8A8.
template <bool PIPELINED>
cudaError_t run(const Args& a, int layout, int bm, int bn, int bk, int depth, cudaStream_t st) {
  if (!gemm_args::fits_int32(a)) return cudaErrorInvalidValue;
  if constexpr (PIPELINED) {
#define REPRO_TRY_TILE(BM, BN, BK, DEPTH)                                         \
  if (bm == BM && bn == BN && bk == BK && depth == DEPTH) {                       \
    return layout == LAYOUT_NCHW ? launch<BM, BN, BK, DEPTH, LAYOUT_NCHW>(a, st)  \
                                 : launch<BM, BN, BK, DEPTH, LAYOUT_ROW>(a, st); \
  }
    REPRO_GEMM_PIPELINED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  } else {
#define REPRO_TRY_TILE(BM, BN, BK)                                            \
  if (bm == BM && bn == BN && bk == BK && depth == 1) {                       \
    return layout == LAYOUT_NCHW ? launch<BM, BN, BK, 1, LAYOUT_NCHW>(a, st)  \
                                 : launch<BM, BN, BK, 1, LAYOUT_ROW>(a, st); \
  }
    REPRO_GEMM_TILED_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  }
  return cudaErrorInvalidValue;
}

}  // namespace int8_gemm
