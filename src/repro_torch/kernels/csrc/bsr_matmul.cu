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
// share it).  Operands are widened to f32 as they are loaded; the
// accumulator, bias, activation and the step program (epilogue.cuh) run in
// f32 and the one store rounds to T -- the TPU kernel's
// preferred_element_type=f32, b_ref.astype(f32) and astype(o_ref.dtype).
// A residual add side in bf16 is read as bf16 and added in f32 before that
// store, which is the dense kernel's contract too.
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
// Grid (ceil(bn / CW) * ncols, nsplit, ceil(M / 8)), 8 warps, CW = 32 * VEC
// columns: output-stationary, one CTA per (8-row M tile, column chunk of
// one block-column), walking that column's packed blocks in order.  Each
// lane owns VEC adjacent columns and loads them as one wide word per weight
// row; the 8 warps take interleaved rows of the block and meet in shared
// memory in warp order.  For every block the CTA stages its x rows of that
// block-row (x[m, r * bm : (r + 1) * bm], in chunks of at most 256) in
// shared memory.  The wrapper masks nothing: ragged M and a ragged last
// column chunk are masked here.
//
// Pads (block_rows -1) are skipped.  That is exact for finite x: the TPU
// kernel clamps a pad to x block 0 and multiplies its product by 0, so with
// a non-finite x it yields NaN where this kernel yields the finite sum.
//
// What bounds it here: at decode (M = batch <= 4) the packed weights'
// bytes -- qwen2.5-3b's q projection pruned to half with 64 x 64 blocks is
// 4 MiB, 1.25 us at 3.35 TB/s -- but there are only Nb = 32 block-columns,
// so one CTA per column would leave 100 of 132 SMs idle.  The design
// splits each column's S packed steps across CTAs (nsplit) until the grid
// has about two CTAs per SM; each split writes its partial tile to an f32
// workspace and the CTA that finishes a tile last (an atomic counter per
// tile, zeroed by the wrapper) sums the splits in split order --
// deterministic, no float atomics -- and runs the epilogue, as
// skinny_gemm.cuh does.  At prefill the 8-row tiles re-read each weight
// block once per tile (from L2: 4 MiB fits its 50 MB).  CUDA cores, no
// tensor cores, TMA or multistage pipeline yet.

#include <cuda_runtime.h>

#include "epilogue.cuh"

#define BSR_MT 8
#define BSR_WARPS 8
#define BSR_KC 256

namespace {

// Bias, activation, step program, one store; n is the global output column.
template <typename T>
struct BsrEpilogue {
  const T* bias;
  T* out;
  int ldo;
  int act;
  StepProgram prog;
  __device__ __forceinline__ void operator()(int m, int n, float v) const {
    if (bias) v += to_f32(bias[n]);
    v = apply_act(act, v);
    const long long idx = (long long)m * ldo + n;
    out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, v, idx));
  }
};

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
  const int jl = blockIdx.x / nct;       // block-column within the band
  const int c0 = (blockIdx.x % nct) * CW;  // first column of the chunk in the block
  const int j = col0 + jl;               // block-column of the packed weight
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
    if (m < M && n < bn) ws[((long long)blockIdx.y * M + m) * wn + (long long)jl * bn + n] = tile[mm][cc];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int t = blockIdx.z * gridDim.x + blockIdx.x;
    s_last = atomicAdd(&counters[t], 1) == nsplit - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int e = tid; e < BSR_MT * CW; e += blockDim.x) {
    const int mm = e / CW, cc = e % CW;
    const int m = m0 + mm, n = c0 + cc;
    if (m >= M || n >= bn) continue;
    float sum = 0.f;
    for (int sp = 0; sp < nsplit; ++sp)
      sum += __ldcg(&ws[((long long)sp * M + m) * wn + (long long)jl * bn + n]);
    epi(m, j * bn + n, sum);
  }
}

template <typename T, int VEC>
int launch(const void* x, const void* values, const int* rows, const void* bias, void* out,
           int M, int K, int nb_total, int s_stride, int bm, int bn, int col0, int ncols,
           int count, int act, const StepProgram& prog, int nsplit, void* ws, void* counters,
           cudaStream_t stream) {
  constexpr int CW = 32 * VEC;
  if (bn % VEC) return (int)cudaErrorInvalidValue;
  const int nct = (bn + CW - 1) / CW;
  const int schunk = count > 0 ? (count + nsplit - 1) / nsplit : 1;
  if (count > 0 && (count + schunk - 1) / schunk != nsplit) return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && (ws == nullptr || counters == nullptr)) return (int)cudaErrorInvalidValue;
  BsrEpilogue<T> epi{static_cast<const T*>(bias), static_cast<T*>(out), nb_total * bn, act,
                     prog};
  dim3 grid(nct * ncols, nsplit, (M + BSR_MT - 1) / BSR_MT);
  bsr_matmul_kernel<T, VEC><<<grid, BSR_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(values), rows, M, K, bm, bn, s_stride,
      count, col0, schunk, static_cast<float*>(ws), static_cast<int*>(counters), epi);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_vec(int vec, const void* x, const void* values, const int* rows, const void* bias,
               void* out, int M, int K, int nb_total, int s_stride, int bm, int bn, int col0,
               int ncols, int count, int act, const StepProgram& prog, int nsplit, void* ws,
               void* counters, cudaStream_t st) {
  switch (vec) {
    case 1:
      return launch<T, 1>(x, values, rows, bias, out, M, K, nb_total, s_stride, bm, bn, col0,
                          ncols, count, act, prog, nsplit, ws, counters, st);
    case 2:
      return launch<T, 2>(x, values, rows, bias, out, M, K, nb_total, s_stride, bm, bn, col0,
                          ncols, count, act, prog, nsplit, ws, counters, st);
    case 4:
      return launch<T, 4>(x, values, rows, bias, out, M, K, nb_total, s_stride, bm, bn, col0,
                          ncols, count, act, prog, nsplit, ws, counters, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// One band of a block-sparse matmul.  x [M, K]; values [nb_total, s_stride,
// bm, bn]; rows [nb_total, s_stride] int32; bias [nb_total * bn] or null;
// out and the sides [M, nb_total * bn].  The band is block-columns
// [col0, col0 + ncols) with `count` packed steps each.  dtype: 0 = f32,
// 1 = bf16.  vec (1, 2 or 4) columns per lane, dividing bn (the values
// pointer aligned to vec elements).  nsplit > 1 splits the steps across
// CTAs and needs the f32 workspace ws [nsplit, M, ncols * bn] and zeroed
// counters [ceil(bn / (32 * vec)) * ncols * ceil(M / 8)].
extern "C" int repro_bsr_matmul(const void* x, const void* values, const int* rows,
                                const void* bias, void* out, int M, int K, int nb_total,
                                int s_stride, int bm, int bn, int col0, int ncols, int count,
                                int act, int n_steps, const int* prog, int n_sides,
                                const void* const* sides, int dtype, int vec, int nsplit,
                                void* ws, void* counters, void* stream) {
  StepProgram p;
  if (M < 0 || bm <= 0 || bn <= 0 || bm % 8 || bn % 8 || K % bm || col0 < 0 || ncols < 0 ||
      col0 + ncols > nb_total || count < 0 || count > s_stride || nsplit < 1 ||
      (count == 0 && nsplit != 1) || dtype < 0 || dtype > 1 ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || ncols == 0) return (int)cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_vec<float>(vec, x, values, rows, bias, out, M, K, nb_total, s_stride, bm, bn,
                             col0, ncols, count, act, p, nsplit, ws, counters, st);
  }
  return launch_vec<__nv_bfloat16>(vec, x, values, rows, bias, out, M, K, nb_total, s_stride,
                                   bm, bn, col0, ncols, count, act, p, nsplit, ws, counters, st);
}
