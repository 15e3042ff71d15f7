// Shared by the GEMM-shaped kernels: the arithmetic scheme of a contraction.
//
//   SCHEME_F32   f32 activations x f32 weights, f32 accumulator
//   SCHEME_W8    f32 activations x int8 weights; each weight tile is
//                converted to f32 as it is staged in shared memory (its
//                per-channel scale is applied once, in the rescale after
//                the contraction), f32 accumulator
//   SCHEME_W8A8  int8 activations x int8 weights, both staged as int8,
//                exact int32 accumulator (integer multiply-add on the CUDA
//                cores)
//
// The codes match the Python wrappers (kernels/conv2d.py, quant_matmul.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

enum { SCHEME_F32 = 0, SCHEME_W8 = 1, SCHEME_W8A8 = 2 };

// X: activation type in device memory and in shared memory; WG: weight type
// in device memory; SW: weight type in shared memory; Acc: accumulator.
template <int S>
struct Scheme;
template <>
struct Scheme<SCHEME_F32> {
  using X = float;
  using WG = float;
  using SW = float;
  using Acc = float;
};
template <>
struct Scheme<SCHEME_W8> {
  using X = float;
  using WG = int8_t;
  using SW = float;
  using Acc = float;
};
template <>
struct Scheme<SCHEME_W8A8> {
  using X = int8_t;
  using WG = int8_t;
  using SW = int8_t;
  using Acc = int;
};

__device__ __forceinline__ float mac(float acc, float a, float b) { return fmaf(a, b, acc); }
__device__ __forceinline__ int mac(int acc, int8_t a, int8_t b) {
  return acc + (int)a * (int)b;
}
