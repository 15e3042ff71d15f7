// The bf16 tensor-core GEMM shared by dense_matmul.cu (the tiled entry),
// dense_matmul_pipelined.cu (the pipelined entries) and fused_ffn.cu (gate
// and up, NW = 2):
//
//   out[m, n] = epi(m, n, {sum_k x[m, k] * w0[k, n] [, sum_k x[m, k] * w1[k, n]]})
//
// It replaces the CUDA-core FMA instances of those kernels for bf16 (the
// f32 and INT8 instances are untouched).  Each thread block owns a BM x BN
// output tile over one K range and walks it in BK-deep slabs through a ring
// of STAGES = DEPTH + 2 shared-memory slots, as pipelined_gemm.cuh does:
// the warm-up issues slabs 0 .. STAGES-2, step s issues slab s + STAGES - 1
// into the slot step s - 1 freed and waits (cp.async.wait_group STAGES - 1)
// for slab s.  DEPTH is the tile tuple's fourth field: 1 is the tiled entry
// (3 slots), 2 and 3 the pipelined entries (4 and 5 slots), so every entry
// keeps at least two slabs in flight behind the one it multiplies.
//
//   xs[STAGES][BM][BK + 8]        the x slabs, bf16 as in memory
//   ws[STAGES][NW][BK][BN + 8]    the weight slabs, bf16 as in memory
//
// Copies: an operand whose pointer and row stride are 16-byte aligned (the
// decoder's every GEMM) is staged by stage16() below, 16-byte cp.async
// with the per-thread copy count fixed at compile time; any other takes
// pipelined_gemm.cuh's stage() (8- or 4-byte cp.async, or synchronous
// element loads for rows not 4-byte aligned: odd K or N), which computes
// its copy width at run time and is about three times slower.  Ragged
// edges are zero-filled by the copy.  The row pads (16 bytes) keep every
// ldmatrix row address 16-byte aligned and the eight rows of each 8x8
// matrix on distinct banks.
//
// Arithmetic: warps own 32 x 32 sub-tiles (WM x WN warps); per k16 step a
// warp loads its A fragments with ldmatrix.x4 and its B fragments with
// ldmatrix.x4.trans (w is [K, N] row-major, the mma's "col" operand), and
// issues mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 into f32 accumulators
// (per weight).  A slab wholly inside the K range runs its BK / 16 steps
// without a branch, so the compiler can load the next step's fragments
// during this step's mma; the range's last slab guards each step.  Every
// tile and every DEPTH sums each output over the same k16 steps (absolute
// k = kb + 16 i), in ascending order, with one instruction shape, starting
// from +0: k16 steps wholly past the range are skipped, the ragged last
// one is zero-filled.  So the result is bit-equal across tiles and depths.
//
// K split: the grid's z dimension splits K into ranges of kchunk rows
// (kchunk a multiple of 64, fixed by the shape in _build.gemm_split, never
// by the tile or depth).  With more than one range every block writes its
// f32 partial tile to the workspace ws[nsplit][NW][M][N]; the block that
// finishes an output tile last (an int counter per tile, which it resets
// to 0 for the next launch) sums the partials in split order -- no float
// atomics -- and runs the epilogue, its threads on consecutive columns
// (16-byte loads of the partials where N allows, the ranges' loads
// unrolled).  Epi gets (m, n, acc[NW]) for every element in range and
// does the single rounding store.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "pipelined_gemm.cuh"

namespace mma_gemm {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16 x 16, row) * b (16 x 8, col), f32 accumulate
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage the [R, C] window at (r0, c0) of the row-major bf16 matrix g (ld
// elements a row; rows x cols in all; pointer and ld 16-byte aligned) into
// s (SP elements a row) with 16-byte cp.async, zero outside the matrix.
template <int R, int C, int SP, int NT>
__device__ __forceinline__ void stage16(bf16* __restrict__ s, const bf16* __restrict__ g,
                                        long long ld, int r0, int c0, int rows, int cols,
                                        int tid) {
  constexpr int PER_ROW = C / 8;
  constexpr int TOTAL = R * PER_ROW;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int e = tid + i * NT;
    if (TOTAL % NT == 0 || e < TOTAL) {
      const int r = e / PER_ROW, c = (e % PER_ROW) * 8;
      const int gr = r0 + r, gc = c0 + c;
      const int valid = gr < rows ? max(0, min(8, cols - gc)) : 0;
      const bf16* src = valid > 0 ? g + (long long)gr * ld + gc : g;
      pipelined::cp_async16(s + r * SP + c, src, valid * (int)sizeof(bf16));
    }
  }
}

template <int BM, int BN, int BK, int DEPTH, int NW>
struct Tile {
  static constexpr int STAGES = DEPTH + 2;
  static constexpr int WM = BM / 32;  // warps along m
  static constexpr int WN = BN / 32;  // warps along n
  static constexpr int NT = WM * WN * 32;
  static constexpr int MI = 2;  // m16 fragments a warp (32 rows)
  static constexpr int NI = 4;  // n8 fragments a warp (32 columns)
  static constexpr int XP = BK + 8;
  static constexpr int WP = BN + 8;
  static constexpr int X_SLOT = BM * XP;
  static constexpr int W_SLOT = BK * WP;
  static constexpr size_t BYTES =
      (size_t)STAGES * ((size_t)X_SLOT + (size_t)NW * W_SLOT) * sizeof(bf16);
  static_assert(BM % 32 == 0 && BN % 32 == 0 && BK % 16 == 0, "tile must be whole warp tiles");
  static_assert(DEPTH >= 1 && NW >= 1 && NW <= 2, "depth >= 1, one or two weights");
};

template <int BM, int BN, int BK, int DEPTH, int NW, typename Epi>
__global__ void __launch_bounds__(Tile<BM, BN, BK, DEPTH, NW>::NT)
    mma_gemm_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w0,
                    const bf16* __restrict__ w1, int M, int N, int K, int kchunk, int xvb,
                    int wvb, float* __restrict__ ws, int* __restrict__ counters, Epi epi) {
  using TileT = Tile<BM, BN, BK, DEPTH, NW>;
  constexpr int STAGES = TileT::STAGES, NT = TileT::NT, WN = TileT::WN;
  constexpr int MI = TileT::MI, NI = TileT::NI, XP = TileT::XP, WP = TileT::WP;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* wsm = xs + STAGES * TileT::X_SLOT;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kb = blockIdx.z * kchunk;
  const int ke = min(K, kb + kchunk);
  const int n_slabs = ke > kb ? (ke - kb + BK - 1) / BK : 0;
  const bf16* wp[2] = {w0, w1};

  auto issue = [&](int s) {
    const int slot = s % STAGES;
    const int k0 = kb + s * BK;
    bf16* xd = xs + slot * TileT::X_SLOT;
    if (xvb == 16) {
      stage16<BM, BK, XP, NT>(xd, x, K, m0, k0, M, ke, tid);
    } else {
      pipelined::stage<bf16, BM, BK, XP, NT>(xd, x, K, m0, k0, M, ke, xvb, tid);
    }
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      bf16* wd = wsm + (slot * NW + wi) * TileT::W_SLOT;
      if (wvb == 16) {
        stage16<BK, BN, WP, NT>(wd, wp[wi], N, k0, n0, ke, N, tid);
      } else {
        pipelined::stage<bf16, BK, BN, WP, NT>(wd, wp[wi], N, k0, n0, ke, N, wvb, tid);
      }
    }
  };

#pragma unroll
  for (int p = 0; p < STAGES - 1; ++p) {
    if (p < n_slabs) issue(p);
    pipelined::cp_async_commit();
  }

  float acc[NW][MI][NI][4];
#pragma unroll
  for (int wi = 0; wi < NW; ++wi)
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[wi][i][j][e] = 0.f;

  // per-lane ldmatrix offsets: A rows lane % 16, k half lane / 16; B (trans)
  // k row lane % 8 + 8 * ((lane / 8) % 2), n half lane / 16
  const int a_off = (wm * 32 + (lane & 15)) * XP + (lane >> 4) * 8;
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * WP + wn * 32 + (lane >> 4) * 8;

  for (int s = 0; s < n_slabs; ++s) {
    const int ahead = s + STAGES - 1;
    if (ahead < n_slabs) issue(ahead);
    pipelined::cp_async_commit();
    pipelined::cp_async_wait<STAGES - 1>();
    __syncthreads();
    const int slot = s % STAGES;
    const bf16* xsl = xs + slot * TileT::X_SLOT;
    const bf16* wsl = wsm + slot * NW * TileT::W_SLOT;
    auto k16_step = [&](int kk) {
      uint32_t a[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) ldmatrix_x4(a[i], xsl + a_off + i * 16 * XP + kk * 16);
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) {
#pragma unroll
        for (int jj = 0; jj < NI / 2; ++jj) {
          uint32_t b[4];
          ldmatrix_x4_trans(b, wsl + wi * TileT::W_SLOT + b_off + kk * 16 * WP + jj * 16);
#pragma unroll
          for (int i = 0; i < MI; ++i) {
            mma_m16n8k16(acc[wi][i][2 * jj], a[i], b[0], b[1]);
            mma_m16n8k16(acc[wi][i][2 * jj + 1], a[i], b[2], b[3]);
          }
        }
      }
    };
    const int left = ke - (kb + s * BK);  // K rows of the range left from this slab on
    if (left >= BK) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) k16_step(kk);
    } else {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        if (kk * 16 < left) k16_step(kk);  // the same k16 steps for every BK
      }
    }
    __syncthreads();  // slot s % STAGES may be refilled by the next step's prefetch
  }
  pipelined::cp_async_wait<0>();

  // accumulator element e of fragment (i, j): row lane / 4 (+ 8 for e >= 2),
  // column 2 * (lane % 4) (+ 1 for odd e)
  const int row0 = m0 + wm * 32 + (lane >> 2);
  const int col0 = n0 + wn * 32 + (lane & 3) * 2;
  const int nsplit = gridDim.z;
  if (nsplit == 1) {
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = row0 + i * 16 + (e >> 1) * 8, n = col0 + j * 8 + (e & 1);
          if (m >= M || n >= N) continue;
          float v[NW];
#pragma unroll
          for (int wi = 0; wi < NW; ++wi) v[wi] = acc[wi][i][j][e];
          epi(m, n, v);
        }
    return;
  }

  // publish this range's partial tile; the last block of the tile sums the
  // ranges in order and runs the epilogue
  __shared__ int s_last;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = row0 + i * 16 + (e >> 1) * 8, n = col0 + j * 8 + (e & 1);
        if (m >= M || n >= N) continue;
#pragma unroll
        for (int wi = 0; wi < NW; ++wi)
          ws[(((long long)blockIdx.z * NW + wi) * M + m) * N + n] = acc[wi][i][j][e];
      }
  __threadfence();
  __syncthreads();
  const int t = blockIdx.x * gridDim.y + blockIdx.y;
  if (tid == 0) s_last = atomicAdd(&counters[t], 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // the tile's outputs, four consecutive columns a thread: each sums the
  // ranges in order, its loads unrolled four ranges deep
  const long long stride = (long long)NW * M * N;  // floats between ranges
  const bool vec4 = N % 4 == 0;
  for (int e = tid; e < BM * (BN / 4); e += NT) {
    const int m = m0 + e / (BN / 4), n = n0 + (e % (BN / 4)) * 4;
    if (m >= M || n >= N) continue;
    float v[NW][4];
#pragma unroll
    for (int wi = 0; wi < NW; ++wi) {
      const float* p = ws + ((long long)wi * M + m) * N + n;
      if (vec4) {
        float4 sum = __ldcg(reinterpret_cast<const float4*>(p));
#pragma unroll 4
        for (int sp = 1; sp < nsplit; ++sp) {
          const float4 q = __ldcg(reinterpret_cast<const float4*>(p + sp * stride));
          sum.x += q.x;
          sum.y += q.y;
          sum.z += q.z;
          sum.w += q.w;
        }
        v[wi][0] = sum.x;
        v[wi][1] = sum.y;
        v[wi][2] = sum.z;
        v[wi][3] = sum.w;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (n + c >= N) break;
          float sum = __ldcg(p + c);
#pragma unroll 4
          for (int sp = 1; sp < nsplit; ++sp) sum += __ldcg(p + c + sp * stride);
          v[wi][c] = sum;
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (n + c >= N) break;
      float vc[NW];
#pragma unroll
      for (int wi = 0; wi < NW; ++wi) vc[wi] = v[wi][c];
      epi(m, n + c, vc);
    }
  }
  if (tid == 0) counters[t] = 0;  // ready for the next launch
}

// The widest cp.async (16, 8, 4 bytes) that every pointer and the row
// stride allow, or 0 (element loads).
inline int copy_bytes2(const void* a, const void* b, long long row_bytes) {
  const int va = pipelined::copy_bytes(a, row_bytes);
  const int vb = b ? pipelined::copy_bytes(b, row_bytes) : va;
  return va < vb ? va : vb;
}

// Launch one tile on `stream`.  kchunk: K rows a range (>= 1); with
// ceil(K / kchunk) > 1 ranges, ws and counters (ceil(M / BM) * ceil(N / BN)
// ints, zero) must be given.  The ring lives in dynamic shared memory.
template <int BM, int BN, int BK, int DEPTH, int NW, typename Epi>
cudaError_t launch(const bf16* x, const bf16* w0, const bf16* w1, int M, int N, int K, int kchunk,
                   float* ws, int* counters, const Epi& epi, cudaStream_t stream) {
  using TileT = Tile<BM, BN, BK, DEPTH, NW>;
  if (kchunk < 1) return cudaErrorInvalidValue;
  const int nsplit = K > 0 ? (K + kchunk - 1) / kchunk : 1;
  if (nsplit > 1 && (ws == nullptr || counters == nullptr)) return cudaErrorInvalidValue;
  if (nsplit > 65535) return cudaErrorInvalidValue;
  constexpr size_t smem = TileT::BYTES;
  auto kernel = mma_gemm_kernel<BM, BN, BK, DEPTH, NW, Epi>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int xvb = pipelined::copy_bytes(x, (long long)K * sizeof(bf16));
  const int wvb = copy_bytes2(w0, NW == 2 ? w1 : nullptr, (long long)N * sizeof(bf16));
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, nsplit);
  kernel<<<grid, TileT::NT, smem, stream>>>(x, w0, w1, M, N, K, kchunk, xvb, wvb, ws, counters,
                                            epi);
  return cudaGetLastError();
}

}  // namespace mma_gemm
