// Asynchronous-copy building blocks (cp.async, sm_80+) shared by the
// port's kernels: 16 / 8 / 4-byte copies that zero-fill past a source
// size, commit and wait on copy groups, and stage() -- one [R, C] window
// of a row-major matrix into shared memory, zero outside the matrix --
// with which csrc/mma_gemm.cuh fills its K-slab ring.  (The CUDA-core
// GEMMs' ring is csrc/simt_gemm.cuh's.)
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
