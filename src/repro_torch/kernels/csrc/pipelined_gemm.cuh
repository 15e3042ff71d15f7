// The K-slab ring GEMM shared by dense_matmul_pipelined.cu and
// quant_matmul_pipelined.cu: out[m, n] = epi(m, n, sum_k x[m, k] * w[k, n]).
//
// It carries the TPU's hand-pipelined kernels
// (repro/kernels/dense_matmul.py:dense_matmul_pipelined_kernel and
// quant_matmul.py:quant_matmul_pipelined_kernel) over to Hopper: each
// thread block owns a BM x BN output tile and contracts K by a loop over
// BK-deep slabs that stream from device memory into a DEPTH-deep ring of
// shared-memory slots,
//
//   xs[DEPTH][BM][BK + pad]   the x slabs, in x's own element type
//   ws[DEPTH][BK][BN + pad]   the w slabs, in w's own element type
//
// (the row pads keep every row 16-byte aligned and spread the reads over
// the banks).  The ring is filled with cp.async, the TPU's async copy: the
// warm-up issues slabs 0 .. DEPTH-2, one cp.async.commit_group each; step s
// issues slab s + DEPTH - 1 into the slot step s - 1 read, then waits for
// slab s and computes on it -- the JAX kernel's order (start the copy
// ahead, then wait), so DEPTH - 1 slabs are in flight during every step's
// multiply-adds.  Because the prefetch's group is committed before the
// wait, slab s is complete once at most DEPTH - 1 groups are pending
// (cp.async.wait_group DEPTH - 1); a barrier then makes every thread's
// copies visible, and a second one at the end of the step frees the slot
// for the next prefetch.
//
// Copies are 16 bytes a thread where the operand's pointer and row stride
// allow it, else 8 or 4 (the wrapper passes the widths, xvb / wvb).  Ragged
// M / N / K edges are zero-filled by the copy itself (src-size below the
// copy size, 0 past the edge).  An operand of elements narrower than 4
// bytes whose rows are not 4-byte aligned (bf16 with odd K, int8 with
// K % 4 != 0) has width 0: this kernel then stores its slabs into the same
// slots with plain loads, synchronously -- never another kernel or the
// plain version.
//
// Arithmetic: the slabs stay in their element types (an async copy cannot
// widen) and every term is widened at the multiply-add: f32 takes one fmaf
// per term into an f32 accumulator, W8 widens the int8 weight to f32, W8A8
// sums int8 x int8 products in an exact int32 accumulator.  (bf16 runs the
// tensor-core kernel of mma_gemm.cuh, which stages its slabs with stage()
// below.)  Each
// output sums k in ascending order from zero, with the zero-filled tail of
// the last slab, exactly as the tiled kernels do (dense_matmul.cu,
// quant_matmul.cu), so the result is bit-equal to theirs for every tile.
// Threads own 4 x 4 micro-tiles laid out as in the tiled kernels.  The
// epilogue functor gets (m, n, accumulator) for every element in range.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "epilogue.cuh"

namespace pipelined {

// -- cp.async (sm_80+) ------------------------------------------------------ //
// src_bytes < the copy size zero-fills the rest of the destination.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename E>
__device__ __forceinline__ E zero() {
  return E(0);
}
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// One multiply-add term, widened as the tiled kernels widen it.
__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ float mac(float acc, float a, int8_t b) {
  return fmaf(a, (float)b, acc);
}
__device__ __forceinline__ int mac(int acc, int8_t a, int8_t b) { return acc + (int)a * (int)b; }

// Stage the [R, C] window at (r0, c0) of the row-major matrix g (ld
// elements a row, rows x cols in all) into s (SP elements a row), zero
// outside the matrix.  vb: bytes a copy (16, 8, 4), or 0 for synchronous
// element loads.  C * sizeof(E) is a multiple of 16, so copies never
// straddle a row of the window.
template <typename E, int R, int C, int SP, int NT>
__device__ __forceinline__ void stage(E* __restrict__ s, const E* __restrict__ g, long long ld,
                                      int r0, int c0, int rows, int cols, int vb, int tid) {
  if (vb == 0) {
    for (int e = tid; e < R * C; e += NT) {
      const int r = e / C, c = e % C;
      const int gr = r0 + r, gc = c0 + c;
      s[r * SP + c] = (gr < rows && gc < cols) ? g[(long long)gr * ld + gc] : zero<E>();
    }
    return;
  }
  const int ve = vb / (int)sizeof(E);  // elements a copy
  const int per_row = C / ve;
  for (int e = tid; e < R * per_row; e += NT) {
    const int r = e / per_row, c = (e % per_row) * ve;
    const int gr = r0 + r, gc = c0 + c;
    const int valid = gr < rows ? max(0, min(ve, cols - gc)) : 0;
    const E* src = valid > 0 ? g + (long long)gr * ld + gc : g;
    E* dst = s + r * SP + c;
    const int nbytes = valid * (int)sizeof(E);
    if (vb == 16) {
      cp_async16(dst, src, nbytes);
    } else if (vb == 8) {
      cp_async8(dst, src, nbytes);
    } else {
      cp_async4(dst, src, nbytes);
    }
  }
}

template <typename XE, typename WE, int BM, int BN, int BK, int DEPTH>
struct Ring {
  static constexpr int XP = BK + 16 / (int)sizeof(XE);  // padded row of an x slab
  static constexpr int WP = BN + 16 / (int)sizeof(WE);  // padded row of a w slab
  static constexpr int X_SLOT = BM * XP;
  static constexpr int W_SLOT = BK * WP;
  static constexpr size_t BYTES =
      (size_t)DEPTH * ((size_t)X_SLOT * sizeof(XE) + (size_t)W_SLOT * sizeof(WE));
  static_assert(BK * sizeof(XE) % 16 == 0 && BN * sizeof(WE) % 16 == 0,
                "slab rows must be whole 16-byte copies");
  static_assert(DEPTH >= 2, "depth 1 is the tiled kernel");
};

template <typename XE, typename WE, typename Acc, int BM, int BN, int BK, int DEPTH, int TM,
          int TN, typename Epi>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    pipelined_gemm_kernel(const XE* __restrict__ x, const WE* __restrict__ w, int M, int N,
                          int K, int xvb, int wvb, Epi epi) {
  using RingT = Ring<XE, WE, BM, BN, BK, DEPTH>;
  constexpr int TY = BN / TN;  // threads along n (fastest: coalesced stores)
  constexpr int TX = BM / TM;  // threads along m
  constexpr int NT = TX * TY;
  constexpr int XP = RingT::XP, WP = RingT::WP;
  extern __shared__ __align__(16) unsigned char smem[];
  XE* xs = reinterpret_cast<XE*>(smem);
  WE* ws = reinterpret_cast<WE*>(smem + (size_t)DEPTH * RingT::X_SLOT * sizeof(XE));

  const int tid = threadIdx.x;
  const int ty = tid % TY;
  const int tx = tid / TY;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int n_steps = (K + BK - 1) / BK;

  auto issue = [&](int step) {
    const int slot = step % DEPTH;
    stage<XE, BM, BK, XP, NT>(xs + slot * RingT::X_SLOT, x, K, m0, step * BK, M, K, xvb, tid);
    stage<WE, BK, BN, WP, NT>(ws + slot * RingT::W_SLOT, w, N, step * BK, n0, K, N, wvb, tid);
  };

  // warm-up: fill DEPTH - 1 slots (an empty group where K is shorter)
#pragma unroll
  for (int p = 0; p < DEPTH - 1; ++p) {
    if (p < n_steps) issue(p);
    cp_async_commit();
  }

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int s = 0; s < n_steps; ++s) {
    const int ahead = s + DEPTH - 1;
    if (ahead < n_steps) issue(ahead);  // the slot step s - 1 read: freed below
    cp_async_commit();
    cp_async_wait<DEPTH - 1>();  // slab s has landed (this thread's copies)
    __syncthreads();             // ... every thread's, element loads included
    const XE* xsl = xs + (s % DEPTH) * RingT::X_SLOT;
    const WE* wsl = ws + (s % DEPTH) * RingT::W_SLOT;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      XE a[TM];
      WE b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xsl[(tx + i * TX) * XP + kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = wsl[kk * WP + ty + j * TY];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // slot s % DEPTH may be refilled by the next step's prefetch
  }
  cp_async_wait<0>();  // nothing is left in flight (the tail groups are empty)

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tx + i * TX;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + ty + j * TY;
      if (n < N) epi(m, n, acc[i][j]);
    }
  }
}

// Launch one tile configuration on `stream`; the ring lives in dynamic
// shared memory, opted in past 48 KB.
template <typename XE, typename WE, typename Acc, int BM, int BN, int BK, int DEPTH,
          typename Epi>
cudaError_t launch(const XE* x, const WE* w, int M, int N, int K, int xvb, int wvb,
                   const Epi& epi, cudaStream_t stream) {
  constexpr int TM = 4, TN = 4;
  constexpr size_t smem = Ring<XE, WE, BM, BN, BK, DEPTH>::BYTES;
  auto kernel = pipelined_gemm_kernel<XE, WE, Acc, BM, BN, BK, DEPTH, TM, TN, Epi>;
  if constexpr (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, (BM / TM) * (BN / TN), smem, stream>>>(x, w, M, N, K, xvb, wvb, epi);
  return cudaGetLastError();
}

// The widest copy (16, 8 or 4 bytes) that the pointer and the row stride
// allow, or 0 (element loads) when not even 4 bytes do.
inline int copy_bytes(const void* p, long long row_bytes) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  for (int vb = 16; vb >= 4; vb /= 2) {
    if (a % vb == 0 && row_bytes % vb == 0) return vb;
  }
  return 0;
}

}  // namespace pipelined
