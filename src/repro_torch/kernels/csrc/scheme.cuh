// The arithmetic scheme of the conv kernel (conv2d.cu):
//
//   SCHEME_F32   f32 activations x f32 weights, f32 accumulator
//   SCHEME_W8    f32 activations x int8 weights; each weight is widened to
//                f32 as it is staged in shared memory (its per-channel
//                scale is applied once, in the rescale after the
//                contraction), f32 accumulator
//   SCHEME_W8A8  int8 activations x int8 weights on int8 tensor cores,
//                exact int32 accumulator
//
// The codes match the Python wrappers (kernels/conv2d.py, _build.py).  The
// GEMMs pick the scheme from their operands' types (quant_matmul.cu).
#pragma once

#include <stdint.h>

enum { SCHEME_F32 = 0, SCHEME_W8 = 1, SCHEME_W8A8 = 2 };

// WG: the weights' type in device memory.
template <int S>
struct Scheme;
template <>
struct Scheme<SCHEME_F32> {
  using WG = float;
};
template <>
struct Scheme<SCHEME_W8> {
  using WG = int8_t;
};
template <>
struct Scheme<SCHEME_W8A8> {
  using WG = int8_t;
};
