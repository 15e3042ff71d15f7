// Block-sparse matmul over PBCSR weights, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bsr_matmul.py:bsr_matmul_kernel
// (wrapper bsr_matmul): out = epilogue(act(x @ W + bias)) for the output
// block-columns of one band, where W survives block pruning and arrives
// packed: values [Nb, S, bm, bn] (the s-th surviving block of output
// block-column j) and block_rows [Nb, S] (its block-row in the dense
// weight, -1 = pad).  Pruned blocks are never read.
//
// Element type T: f32 or bf16 (x, values, bias, the side operands and out
// share it).  The accumulator, bias, activation and the step program
// (epilogue.cuh) run in f32 and the one store rounds to T -- the TPU
// kernel's preferred_element_type=f32, b_ref.astype(f32) and
// astype(o_ref.dtype).  A residual add side in bf16 is read as bf16 and
// added in f32 before that store, which is the dense kernel's contract too.
//
// One launch covers one band: block-columns [col0, col0 + ncols) walked for
// `count` packed steps each (the band's exact trip count; `s_stride` is the
// packed S of the whole weight, so a band reads its slice of values and
// block_rows in place).  It writes the band's columns of one [M, Nb * bn]
// output (row stride Nb * bn), so the ops layer's band loop needs no concat;
// the side operands are [M, Nb * bn] and read at the output's index, the
// bias [Nb * bn] at the output's column.  count == 0 is a valid launch: no
// step, the epilogue of a zero accumulator (bias, activation, steps).
//
// Three bodies, one chosen by the wrapper from the shape before the launch
// (kernels/bsr_matmul.py:plan; the C entry refuses a route the shape does
// not allow):
//
// * ROUTE_TMA, bf16 blocks of bm % 32 == 0 rows and bn % 32 == 0 columns
//   on 16-byte aligned x and values: the Hopper GEMM body of
//   csrc/wgmma_gemm.cuh with its block-sparse K walk (wgmma_gemm::BsrWalk).
//   TMA loads x [M, K] and the packed blocks -- values seen as one
//   [Nb * S * bm, bn] matrix, one tensor map each for the whole launch --
//   into a ring of swizzled slots; a CTA owns a 64-row M tile by BN = 64 or
//   32 columns of one block-column, stages its steps of block_rows in
//   shared memory before the loop and drops the pads there, and runs
//   wgmma m64nBNk16 over each live block as bm / BK slabs whose x columns
//   start at block_rows[j, s] * bm.  Its splits meet in a thread block
//   cluster (below).
// * ROUTE_STREAM, bf16 with M <= 8 (decode): weight streaming, like
//   skinny_bf16.cuh.  8 warps over 16 columns of a block-column; lane l
//   owns 8 adjacent columns (one 16-byte word of a block row, two lanes a
//   32-byte sector) and the rows l / 2 + 16 * warp + 128 i of the CTA's
//   packed rows, up to 8 loads a lane issued before x is staged and before
//   any is used; only MT = M rounded up to 1, 2, 4 or 8 rows of x are
//   staged (f32, shared memory).  Consecutive packed steps of a column are
//   contiguous, so a lane's row address needs no division.  With 16
//   columns a CTA the decoder's q / o projections (32 block-columns of 64)
//   give 128 CTAs that each hold all their rows: no split.
// * ROUTE_FMA, f32 (and any bf16 shape the other two do not take): CUDA
//   cores.  8-row M tiles by a 32 * VEC column chunk of one block-column;
//   each lane owns VEC adjacent columns, the 8 warps take interleaved rows
//   of the block and meet in shared memory in warp order; the x rows of
//   each block are staged in chunks of at most 256.  True f32 (no TF32).
//
// Every body splits a column's `count` steps over gridDim.y CTAs of
// `schunk` steps when the grid is small (the split is a function of the
// shape: kernels/bsr_matmul.py).  ROUTE_TMA's splits of a tile form one
// thread block cluster and sum their partial tiles through distributed
// shared memory, each CTA a share of the rows (wgmma_gemm.cuh's K split).  The other bodies write
// each split's partial tile to the f32 workspace ws [nsplit, M, ncols *
// bn]; the CTA that finishes a tile last (an int counter per tile, which
// it resets to 0 for the next launch, so the wrapper keeps one zeroed
// buffer per stream: _build.split_counters) sums the splits and runs the
// epilogue.  Either way the splits are summed in split order --
// deterministic, no float atomics.  The wrapper masks nothing: ragged M
// and ragged column chunks are masked here.
//
// Pads (block_rows -1) contribute nothing.  That is exact for finite x: the
// TPU kernel clamps a pad to x block 0 and multiplies its product by 0, so
// with a non-finite x it yields NaN where this kernel yields the finite
// sum.  ROUTE_TMA and ROUTE_FMA skip a pad's copies and products;
// ROUTE_STREAM loads its weight rows with the others (the load is issued
// before block_rows is known) and multiplies them by zero x, the weight
// forced to 0.
//
// What bounds it here: the packed weights' bytes -- qwen2.5-3b's q
// projection pruned to half with 64 x 64 blocks is 4 MiB, 1.25 us at
// 3.35 TB/s -- at decode and, with 48 rows of x, at prefill too.  There are
// only Nb = 32 block-columns, so the split is what fills 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"
#include "tiles.cuh"
#include "wgmma_gemm.cuh"

enum { ROUTE_FMA = 0, ROUTE_TMA = 1, ROUTE_STREAM = 2 };

namespace {

using bf16 = __nv_bfloat16;

// Bias, activation, step program, one store; n is the global output column.
template <typename T>
struct BsrEpilogue {
  const T* bias;
  T* out;
  int ldo;
  int act;
  StepProgram prog;
  // the bias of column n (0 without one), loadable ahead of the sum
  __device__ __forceinline__ float bias_at(int n) const { return bias ? to_f32(bias[n]) : 0.f; }
  // v already holds the bias
  __device__ __forceinline__ void finish(int m, int n, float v) const {
    v = apply_act(act, v);
    const long long idx = (long long)m * ldo + n;
    out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, v, idx));
  }
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    finish(m, n, v + bias_at(n));
  }
  // a one-step add program's side value at (m, n), loadable ahead of the
  // sum, and the store that adds it (as the step program would)
  __device__ __forceinline__ float side_at(int m, int n) const {
    return to_f32(reinterpret_cast<const T*>(side_ptr(prog, prog.arg[0]))[(long long)m * ldo + n]);
  }
  __device__ __forceinline__ void finish_add(int m, int n, float v, float side) const {
    out[(long long)m * ldo + n] = from_f32<T>(apply_act(act, v) + side);
  }
  // four columns n .. n + 3 of row m: the bias read as one word, and with
  // no step program or with the residual add alone, the side read and the
  // output written as one word each, where the addresses are aligned to a
  // word of four elements (else element by element, as operator())
  __device__ __forceinline__ float4 bias4(int n) const {
    float b[4] = {0.f, 0.f, 0.f, 0.f};
    if (bias && aligned4(bias + n)) {
      load_vec<T, 4>(bias + n, b);
    } else if (bias) {
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = to_f32(bias[n + c]);
    }
    return make_float4(b[0], b[1], b[2], b[3]);
  }
  __device__ __forceinline__ void finish4(int m, int n, float4 v) const {
    const long long idx = (long long)m * ldo + n;
    float r[4] = {apply_act(act, v.x), apply_act(act, v.y), apply_act(act, v.z),
                  apply_act(act, v.w)};
    const T* side = reinterpret_cast<const T*>(side_ptr(prog, prog.arg[0]));
    const bool residual = prog.n_steps == 1 && prog.kind[0] == STEP_ADD;
    if ((prog.n_steps == 0 || (residual && aligned4(side + idx))) && aligned4(out + idx)) {
      if (residual) {
        float sv[4];
        load_vec<T, 4>(side + idx, sv);
#pragma unroll
        for (int c = 0; c < 4; ++c) r[c] += sv[c];
      }
      store4(out + idx, r);
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      out[idx + c] = from_f32<T>(apply_pointwise_steps<T>(prog, r[c], idx + c));
    }
  }
  static __device__ __forceinline__ bool aligned4(const T* p) {
    return reinterpret_cast<uintptr_t>(p) % (4 * sizeof(T)) == 0;
  }
  static __device__ __forceinline__ void store4(float* p, const float (&r)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  }
  static __device__ __forceinline__ void store4(bf16* p, const float (&r)[4]) {
    uint2 w;
    w.x = pack2(r[0], r[1]);
    w.y = pack2(r[2], r[3]);
    *reinterpret_cast<uint2*>(p) = w;
  }
  static __device__ __forceinline__ uint32_t pack2(float lo, float hi) {
    return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
           ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
  }
};

// The split tail shared by the three bodies, run by every thread of a CTA
// after it wrote its partial tile (rows [m0, m0 + rows_t) x block columns
// [c0, c0 + cols_t) of block-column jl) to ws: the CTA that finishes the
// tile last sums every split in order, four columns a group (bn % 8 == 0,
// c0 and cols_t multiples of 4), runs the epilogue, and resets the counter.
// A thread takes U groups at a time and issues all their loads (the splits'
// partials and the bias) before it stores any, so the tail costs one round
// trip to L2 per U groups, not one per group.
template <typename T, int NT>
__device__ __forceinline__ void split_reduce(const float* __restrict__ ws,
                                             int* __restrict__ counters, int t, int nsplit,
                                             int M, int m0, int rows_t, int jl, int j, int c0,
                                             int cols_t, int bn, long long wn,
                                             const BsrEpilogue<T>& epi, int* s_last) {
  constexpr int U = 4;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *s_last = atomicAdd(&counters[t], 1) == nsplit - 1;
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  const long long stride = (long long)M * wn;  // floats between splits
  const int cg = cols_t / 4, groups = rows_t * cg;
  for (int base = threadIdx.x; base < groups; base += NT * U) {
    float4 sum[U], bv[U];
    int mu[U], cu[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = base + u * NT;
      mu[u] = m0 + e / cg;
      cu[u] = c0 + (e % cg) * 4;
      if (e >= groups || mu[u] >= M || cu[u] >= bn) {
        mu[u] = -1;
        continue;
      }
      const float* p = ws + (long long)mu[u] * wn + (long long)jl * bn + cu[u];
      sum[u] = __ldcg(reinterpret_cast<const float4*>(p));
      const int n = j * bn + cu[u];
      bv[u] = epi.bias4(n);
#pragma unroll 4
      for (int sp = 1; sp < nsplit; ++sp) {
        const float4 q = __ldcg(reinterpret_cast<const float4*>(p + sp * stride));
        sum[u].x += q.x;
        sum[u].y += q.y;
        sum[u].z += q.z;
        sum[u].w += q.w;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (mu[u] < 0) continue;
      const int n = j * bn + cu[u];
      epi.finish4(mu[u], n, make_float4(sum[u].x + bv[u].x, sum[u].y + bv[u].y,
                                        sum[u].z + bv[u].z, sum[u].w + bv[u].w));
    }
  }
  if (threadIdx.x == 0) counters[t] = 0;  // ready for the next launch
}

// ---------------------------------------------------------------------------
// ROUTE_FMA: CUDA cores, f32 (and bf16 shapes the other routes refuse)
// ---------------------------------------------------------------------------

#define BSR_MT 8
#define BSR_WARPS 8
#define BSR_KC 256

template <typename T, int VEC>
__global__ void __launch_bounds__(BSR_WARPS * 32)
    bsr_matmul_kernel(const T* __restrict__ x, const T* __restrict__ values,
                      const int* __restrict__ rows, int M, int K, int bm, int bn,
                      int s_stride, int count, int col0, int schunk, float* __restrict__ ws,
                      int* __restrict__ counters, BsrEpilogue<T> epi) {
  constexpr int CW = 32 * VEC;
  __shared__ float xs[BSR_MT][BSR_KC];
  __shared__ float tile[BSR_MT][CW];
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nct = (bn + CW - 1) / CW;
  const int jl = blockIdx.x / nct;         // block-column within the band
  const int c0 = (blockIdx.x % nct) * CW;  // first column of the chunk in the block
  const int j = col0 + jl;                 // block-column of the packed weight
  const int m0 = blockIdx.z * BSR_MT;
  const int sb = blockIdx.y * schunk;
  const int se = min(count, sb + schunk);
  const int nc = c0 + lane * VEC;
  const bool live = nc < bn;  // bn % VEC == 0 (wrapper)

  float acc[BSR_MT][VEC];
#pragma unroll
  for (int m = 0; m < BSR_MT; ++m)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[m][v] = 0.f;

  const long long blk = (long long)bm * bn;
  for (int s = sb; s < se; ++s) {
    const int r = rows[(long long)j * s_stride + s];  // the same for the whole CTA
    if (r < 0) continue;                              // pad: skipped (see above)
    const T* vb = values + ((long long)j * s_stride + s) * blk;
    for (int k0 = 0; k0 < bm; k0 += BSR_KC) {
      const int kn = min(BSR_KC, bm - k0);
      __syncthreads();  // the previous chunk's readers are done
      for (int e = tid; e < BSR_MT * kn; e += blockDim.x) {
        const int mm = e / kn, kk = e % kn;
        const int m = m0 + mm;
        xs[mm][kk] = m < M ? to_f32(x[(long long)m * K + (long long)r * bm + k0 + kk]) : 0.f;
      }
      __syncthreads();
      if (live) {
#pragma unroll 4
        for (int kk = warp; kk < kn; kk += BSR_WARPS) {
          float wv[VEC];
          load_vec<T, VEC>(vb + (long long)(k0 + kk) * bn + nc, wv);
#pragma unroll
          for (int m = 0; m < BSR_MT; ++m) {
            const float xv = xs[m][kk];
#pragma unroll
            for (int v = 0; v < VEC; ++v) acc[m][v] = fmaf(xv, wv[v], acc[m][v]);
          }
        }
      }
    }
  }

  // the warps' partial sums, added in warp order
  for (int w = 0; w < BSR_WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int m = 0; m < BSR_MT; ++m)
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          float& t = tile[m][lane * VEC + v];
          t = (w == 0) ? acc[m][v] : t + acc[m][v];
        }
    }
    __syncthreads();
  }

  const int nsplit = gridDim.y;
  if (nsplit == 1) {
    for (int e = tid; e < BSR_MT * CW; e += blockDim.x) {
      const int mm = e / CW, cc = e % CW;
      const int m = m0 + mm, n = c0 + cc;
      if (m < M && n < bn) epi(m, j * bn + n, tile[mm][cc]);
    }
    return;
  }

  // publish this split's partial tile; the last CTA of the tile sums every
  // split in order and runs the epilogue
  const long long wn = (long long)(gridDim.x / nct) * bn;  // the band's columns
  for (int e = tid; e < BSR_MT * CW; e += blockDim.x) {
    const int mm = e / CW, cc = e % CW;
    const int m = m0 + mm, n = c0 + cc;
    if (m < M && n < bn) {
      ws[((long long)blockIdx.y * M + m) * wn + (long long)jl * bn + n] = tile[mm][cc];
    }
  }
  split_reduce<T, BSR_WARPS * 32>(ws, counters, blockIdx.z * gridDim.x + blockIdx.x, nsplit, M,
                                  m0, BSR_MT, jl, j, c0, CW, bn, wn, epi, &s_last);
}

template <typename T, int VEC>
int launch_fma(const void* x, const void* values, const int* rows, int M, int K, int s_stride,
               int bm, int bn, int ncols, int count, int schunk, int nsplit, void* ws,
               void* counters, const BsrEpilogue<T>& epi, int col0, cudaStream_t stream) {
  constexpr int CW = 32 * VEC;
  if (bn % VEC) return (int)cudaErrorInvalidValue;
  const int nct = (bn + CW - 1) / CW;
  dim3 grid(nct * ncols, nsplit, (M + BSR_MT - 1) / BSR_MT);
  bsr_matmul_kernel<T, VEC><<<grid, BSR_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), rows, M, K, bm, bn, s_stride,
      count, col0, schunk, static_cast<float*>(ws), static_cast<int*>(counters), epi);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ROUTE_TMA: bf16 on the TMA + wgmma body (csrc/wgmma_gemm.cuh)
// ---------------------------------------------------------------------------

// One band on the Hopper GEMM body with wgmma_gemm::BsrWalk: x [M, K] and
// values viewed as one [Nb * S * bm, bn] matrix each read through one tensor
// map (boxes of BK rows: BK = the largest of 128 / 64 / 32 dividing bm, so a
// packed block is bm / BK slabs), BN = `width` columns of a block-column an
// N tile, the CTA's steps of block_rows staged in shared memory and its
// pads dropped there, the splits of a column's steps one thread block
// cluster summed in split order, RowEpilogue on the band's output columns
// (rows ldo = Nb * bn apart).
template <int BN, int BK>
int launch_tma(const bf16* x, const bf16* values, const int* rows, int M, int K, int nb_total,
               int s_stride, int bm, int bn, int ncols, int count, int schunk, int nsplit,
               const RowEpilogue<bf16>& epi, int col0, cudaStream_t stream) {
  using T = wgmma_gemm::Tile<64, BN, BK, 1, 1>;
  CUtensorMap xmap, wmap;
  cudaError_t e = wgmma_gemm::encode(&xmap, x, K, M, T::XBOX, 64);
  if (e != cudaSuccess) return (int)e;
  e = wgmma_gemm::encode(&wmap, values, bn, nb_total * s_stride * bm, BN, BK);
  if (e != cudaSuccess) return (int)e;
  const wgmma_gemm::BsrWalk walk{rows, s_stride, col0, bm, bn, count, schunk};
  const dim3 grid((M + 63) / 64, (bn / BN) * ncols, nsplit);
  return (int)wgmma_gemm::run<64, BN, BK, 1, 1>(xmap, wmap, wmap, M, grid, walk, epi, stream);
}

int run_tma(const bf16* x, const bf16* values, const int* rows, int M, int K, int nb_total,
            int s_stride, int bm, int bn, int ncols, int count, int schunk, int nsplit,
            int width, const RowEpilogue<bf16>& epi, int col0, cudaStream_t st) {
  const int bk = bm % 128 == 0 ? 128 : bm % 64 == 0 ? 64 : 32;
#define REPRO_TRY_BSR_TMA(BN, BK)                                                          \
  if (width == BN && bk == BK) {                                                          \
    return launch_tma<BN, BK>(x, values, rows, M, K, nb_total, s_stride, bm, bn, ncols,  \
                              count, schunk, nsplit, epi, col0, st);                      \
  }
  REPRO_BSR_TMA_TILES(REPRO_TRY_BSR_TMA)
#undef REPRO_TRY_BSR_TMA
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// ROUTE_STREAM: bf16 weight streaming, M <= 8
// ---------------------------------------------------------------------------

namespace bsr_stream {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int CW = 16;           // columns a CTA covers: 2 lanes x 8 bf16
constexpr int LPR = CW / 8;      // lanes a packed row
constexpr int RPW = 32 / LPR;    // packed rows a warp covers per pass
constexpr int ROWS = WARPS * RPW;  // packed rows the CTA covers per pass
constexpr int KC = 1024;         // most packed rows a CTA stages (schunk * bm)
constexpr int UNROLL = 8;        // 16-byte loads in flight a lane
constexpr int RG = 4;            // row groups a warp keeps after its shuffles

template <int MT>
struct Smem {
  static constexpr int XS = MT * KC;                  // x rows of the CTA's steps, f32
  static constexpr int RED = WARPS * RG * MT * CW;    // the row groups' partial sums
  static constexpr int FLOATS = XS > RED ? XS : RED;  // one buffer, used in turn
};

}  // namespace bsr_stream

// Lane l owns 8 columns (c0 + 8 (l % 2) ..) of the packed rows
// l / 2 + 16 * warp + 128 i of the CTA's steps: the two lanes of a row read
// one 32-byte sector, a warp 16 rows.  A CTA covers all the packed rows of
// its 16 columns when they fit the x stage (KC), so at the decoder's shapes
// the grid needs no split and the sum never leaves the CTA.  Without a
// split, the output's bias and a residual add's side value are read at the
// start, beside the weights.
template <int MT>
__global__ void __launch_bounds__(bsr_stream::THREADS)
    bsr_matmul_stream_kernel(const bf16* __restrict__ x, const bf16* __restrict__ values,
                             const int* __restrict__ rows, int M, int K, int bm, int bn,
                             int s_stride, int count, int col0, int schunk,
                             float* __restrict__ ws, int* __restrict__ counters,
                             BsrEpilogue<bf16> epi) {
  using namespace bsr_stream;
  __shared__ __align__(16) float buf[Smem<MT>::FLOATS];
  __shared__ int s_rows[KC / 8];
  __shared__ int s_last;
  float* xs = buf;   // [MT][KC] during the loop
  float* red = buf;  // [WARPS][RG][MT][CW] after it

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane % LPR;  // column group
  const int rg = lane / LPR;  // row within the warp's RPW
  const int nct = (bn + CW - 1) / CW;
  const int jl = blockIdx.x / nct;
  const int c0 = (blockIdx.x % nct) * CW;
  const int j = col0 + jl;
  const int sb = blockIdx.y * schunk;
  const int ns = max(min(count, sb + schunk) - sb, 0);
  const int kn = ns * bm;  // packed rows of the CTA's steps, contiguous in values
  const int nc = c0 + cg * 8;
  const bool live = nc < bn;
  const int nsplit = gridDim.y;
  // packed row f of the CTA (step sb + f / bm, row f % bm of its block)
  const bf16* vrow = values + ((long long)j * s_stride + sb) * bm * bn + nc;
  // the output this thread finishes without a split, and its bias, early
  const int om = tid / CW, oc = c0 + tid % CW;
  const bool owner = tid < MT * CW && om < M && oc < bn;
  const float obias = (owner && nsplit == 1) ? epi.bias_at(j * bn + oc) : 0.f;
  const bool residual = nsplit == 1 && epi.prog.n_steps == 1 && epi.prog.kind[0] == STEP_ADD;
  const float oside = (owner && residual) ? epi.side_at(om, j * bn + oc) : 0.f;
  // ceil(2^32 / bm): f / bm by multiply-high, exact for f < 2^32 / bm
  const unsigned inv_bm = 0xffffffffu / (unsigned)bm + 1u;

  float acc[MT][8];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[m][c] = 0.f;

  int f = warp * RPW + rg;
  for (int pass = 0; f < kn || pass == 0; ++pass) {
    // this pass's weight words first: they do not wait for x
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int fu = f + u * ROWS;
      raw[u] = (live && fu < kn)
                   ? __ldg(reinterpret_cast<const uint4*>(vrow + (long long)fu * bn))
                   : make_uint4(0u, 0u, 0u, 0u);
    }
    if (pass == 0) {
      // the x rows of every step of the CTA (zero at pads and past M), a
      // 16-byte word (8 of a block row) a copy: word q is (m, step i, part)
      const int* rj = rows + (long long)j * s_stride + sb;
      for (int i = tid; i < ns; i += THREADS) s_rows[i] = __ldg(rj + i);
      const int parts = bm / 8;
      for (int q = tid; q < MT * ns * parts; q += THREADS) {
        const int mi = q / parts, part = q - mi * parts;
        const int mm = mi / ns, i = mi - mm * ns;
        const int r = __ldg(rj + i);
        uint4 raw_x = make_uint4(0u, 0u, 0u, 0u);
        if (mm < M && r >= 0) {
          raw_x = __ldg(reinterpret_cast<const uint4*>(x + (long long)mm * K +
                                                       (long long)r * bm + part * 8));
        }
        float v[8];
        Elem<bf16>::unpack(raw_x.x, v + 0);
        Elem<bf16>::unpack(raw_x.y, v + 2);
        Elem<bf16>::unpack(raw_x.z, v + 4);
        Elem<bf16>::unpack(raw_x.w, v + 6);
        float4* d = reinterpret_cast<float4*>(xs + mm * KC + i * bm + part * 8);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int fu = f + u * ROWS;
      if (!live || fu >= kn) continue;
      float wv[8];
      Elem<bf16>::unpack(raw[u].x, wv + 0);
      Elem<bf16>::unpack(raw[u].y, wv + 2);
      Elem<bf16>::unpack(raw[u].z, wv + 4);
      Elem<bf16>::unpack(raw[u].w, wv + 6);
      const bool pad = s_rows[__umulhi((unsigned)fu, inv_bm)] < 0;  // fu / bm
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float xv = xs[m * KC + fu];
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[m][c] = fmaf(xv, pad ? 0.f : wv[c], acc[m][c]);
      }
    }
    f += UNROLL * ROWS;
  }

  // fold the warp's 16 rows to RG = 4 (lanes l, l ^ 8, l ^ 16, l ^ 24)
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float v = acc[m][c];
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      acc[m][c] = v;
    }
  __syncthreads();  // every warp is done with xs: red reuses the buffer
  if (lane < RG * LPR) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int c = 0; c < 8; ++c) red[((warp * RG + rg) * MT + m) * CW + cg * 8 + c] = acc[m][c];
  }
  __syncthreads();

  // thread e < MT * CW owns output (m, c) = (e / CW, c0 + e % CW): the CTA's
  // sum over its warps' row groups, in order
  const long long wn = (long long)(gridDim.x / nct) * bn;
  if (owner) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < WARPS * RG; ++g) v += red[g * MT * CW + tid];
    if (nsplit == 1 && residual) {
      epi.finish_add(om, j * bn + oc, v + obias, oside);
    } else if (nsplit == 1) {
      epi.finish(om, j * bn + oc, v + obias);
    } else {
      ws[((long long)blockIdx.y * M + om) * wn + (long long)jl * bn + oc] = v;
    }
  }
  if (nsplit == 1) return;
  split_reduce<bf16, THREADS>(ws, counters, blockIdx.x, nsplit, M, 0, MT, jl, j, c0, CW, bn, wn,
                              epi, &s_last);
}

template <int MT>
int launch_stream_mt(const bf16* x, const bf16* values, const int* rows, int M, int K,
                     int s_stride, int bm, int bn, int ncols, int count, int schunk, int nsplit,
                     float* ws, int* counters, const BsrEpilogue<bf16>& epi, int col0,
                     cudaStream_t stream) {
  const int nct = (bn + bsr_stream::CW - 1) / bsr_stream::CW;
  dim3 grid(nct * ncols, nsplit);
  bsr_matmul_stream_kernel<MT><<<grid, bsr_stream::THREADS, 0, stream>>>(
      x, values, rows, M, K, bm, bn, s_stride, count, col0, schunk, ws, counters, epi);
  return (int)cudaGetLastError();
}

int launch_stream(const bf16* x, const bf16* values, const int* rows, int M, int K, int s_stride,
                  int bm, int bn, int ncols, int count, int schunk, int nsplit, float* ws,
                  int* counters, const BsrEpilogue<bf16>& epi, int col0, cudaStream_t st) {
  if (M <= 1)
    return launch_stream_mt<1>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                               nsplit, ws, counters, epi, col0, st);
  if (M <= 2)
    return launch_stream_mt<2>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                               nsplit, ws, counters, epi, col0, st);
  if (M <= 4)
    return launch_stream_mt<4>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                               nsplit, ws, counters, epi, col0, st);
  return launch_stream_mt<8>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                             nsplit, ws, counters, epi, col0, st);
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// One band of a block-sparse matmul.  x [M, K]; values [nb_total, s_stride,
// bm, bn]; rows [nb_total, s_stride] int32; bias [nb_total * bn] or null;
// out and the sides [M, nb_total * bn].  The band is block-columns
// [col0, col0 + ncols) with `count` packed steps each.  dtype: 0 = f32,
// 1 = bf16.  route: ROUTE_FMA with `width` = VEC (1, 2 or 4 columns a lane,
// dividing bn, the values pointer aligned to VEC elements); ROUTE_TMA (bf16,
// bm % 32 == 0, x and values 16-byte aligned, at most 8 splits of at most
// 256 steps) with `width` = BN (64 or 32 columns a CTA, dividing bn); ROUTE_STREAM
// (bf16, M <= 8, schunk * bm <= 1024, x and values 16-byte aligned),
// `width` ignored.  nsplit > 1 splits the steps across CTAs (ceil(count /
// nsplit) a CTA, every split non-empty); ROUTE_FMA and ROUTE_STREAM then
// need the f32 workspace ws [nsplit, M, ncols * bn] and zeroed counters,
// one per tile of the route's grid, which the launch leaves zeroed.
extern "C" int repro_bsr_matmul(const void* x, const void* values, const int* rows,
                                const void* bias, void* out, int M, int K, int nb_total,
                                int s_stride, int bm, int bn, int col0, int ncols, int count,
                                int act, int n_steps, const int* prog, int n_sides,
                                const void* const* sides, int dtype, int route, int width,
                                int nsplit, void* ws, void* counters, void* stream) {
  StepProgram p;
  if (M < 0 || bm <= 0 || bn <= 0 || bm % 8 || bn % 8 || K % bm || col0 < 0 || ncols < 0 ||
      col0 + ncols > nb_total || count < 0 || count > s_stride || nsplit < 1 ||
      nsplit > 65535 || (count == 0 && nsplit != 1) || dtype < 0 || dtype > 1 ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  const int schunk = count > 0 ? (count + nsplit - 1) / nsplit : 1;
  if (count > 0 && (count + schunk - 1) / schunk != nsplit) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && route != ROUTE_TMA && (ws == nullptr || counters == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || ncols == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  const int ldo = nb_total * bn;
  if (route == ROUTE_TMA || route == ROUTE_STREAM) {
    if (dtype != 1 || !aligned16(values) || !aligned16(x)) return (int)cudaErrorInvalidValue;
    const bf16* xb = static_cast<const bf16*>(x);
    const bf16* vb = static_cast<const bf16*>(values);
    if (route == ROUTE_STREAM) {
      BsrEpilogue<bf16> epi{static_cast<const bf16*>(bias), static_cast<bf16*>(out), ldo, act, p};
      if (M > 8 || schunk * bm > bsr_stream::KC) return (int)cudaErrorInvalidValue;
      return launch_stream(xb, vb, rows, M, K, s_stride, bm, bn, ncols, count, schunk, nsplit,
                           wsf, cnt, epi, col0, st);
    }
    if (bm % 32 || (width != 64 && width != 32) || bn % width || nsplit > wgmma_gemm::MAX_CLUSTER ||
        schunk > wgmma_gemm::BsrWalk::TABLE) {
      return (int)cudaErrorInvalidValue;
    }
    const RowEpilogue<bf16> epi{static_cast<const bf16*>(bias), static_cast<bf16*>(out), ldo, act,
                                p};
    return run_tma(xb, vb, rows, M, K, nb_total, s_stride, bm, bn, ncols, count, schunk, nsplit,
                   width, epi, col0, st);
  }
  if (route != ROUTE_FMA) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    BsrEpilogue<float> epi{static_cast<const float*>(bias), static_cast<float*>(out), ldo, act, p};
    switch (width) {
      case 1:
        return launch_fma<float, 1>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                    nsplit, ws, counters, epi, col0, st);
      case 2:
        return launch_fma<float, 2>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                    nsplit, ws, counters, epi, col0, st);
      case 4:
        return launch_fma<float, 4>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                    nsplit, ws, counters, epi, col0, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  BsrEpilogue<bf16> epi{static_cast<const bf16*>(bias), static_cast<bf16*>(out), ldo, act, p};
  switch (width) {
    case 1:
      return launch_fma<bf16, 1>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                 nsplit, ws, counters, epi, col0, st);
    case 2:
      return launch_fma<bf16, 2>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                 nsplit, ws, counters, epi, col0, st);
    case 4:
      return launch_fma<bf16, 4>(x, values, rows, M, K, s_stride, bm, bn, ncols, count, schunk,
                                 nsplit, ws, counters, epi, col0, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
