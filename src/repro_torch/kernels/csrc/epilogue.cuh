// Shared by every kernel of the port: activations and the step program.
//
// A step program is the kernel-local form of a graph node's epilogue (or of
// a fused_elementwise node's steps), translated by the Python wrapper:
//   (STEP_ACT, act)   apply activation `act` (ACT_* below)
//   (STEP_ADD, slot)  add side operand `slot`, read at the output's index
//   (STEP_MUL, slot)  multiply by side operand `slot`
//   (STEP_NORM, slot) layer norm over the row with scale/bias pair `slot`
//                     (fused_elementwise only; eps in `eps[step]`)
// It travels to the kernel by value, with fixed maxima; the wrappers check
// the program against these before they launch.  Side operands are stored
// as float pointers; a kernel whose sides hold another element type (bf16)
// reads them through apply_pointwise_steps<S>, which converts to f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Element types of the port's float kernels: f32 and bf16, computed in f32.
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);  // round to nearest even, as astype / .to do
}

// How many elements of T one 32-bit word holds, and how to widen them.
template <typename T>
struct Elem;
template <>
struct Elem<float> {
  static constexpr int PER_WORD = 1;
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) { o[0] = __uint_as_float(w); }
};
template <>
struct Elem<__nv_bfloat16> {
  static constexpr int PER_WORD = 2;
  // little-endian: element 0 is the low half; bf16 -> f32 is exact
  static __device__ __forceinline__ void unpack(uint32_t w, float* o) {
    o[0] = __uint_as_float(w << 16);
    o[1] = __uint_as_float(w & 0xffff0000u);
  }
};

// Load VEC consecutive elements of T at p as f32, in 16-, 8- or 4-byte
// words (p must be aligned to the load's width; the wrappers check it).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  constexpr int BYTES = VEC * (int)sizeof(T);
  constexpr int PW = Elem<T>::PER_WORD;
  if constexpr (BYTES % 16 == 0) {
#pragma unroll
    for (int i = 0; i < BYTES / 16; ++i) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(p) + i);
      Elem<T>::unpack(r.x, out + (4 * i + 0) * PW);
      Elem<T>::unpack(r.y, out + (4 * i + 1) * PW);
      Elem<T>::unpack(r.z, out + (4 * i + 2) * PW);
      Elem<T>::unpack(r.w, out + (4 * i + 3) * PW);
    }
  } else if constexpr (BYTES == 8) {
    const uint2 r = __ldg(reinterpret_cast<const uint2*>(p));
    Elem<T>::unpack(r.x, out);
    Elem<T>::unpack(r.y, out + PW);
  } else if constexpr (BYTES == 4) {
    Elem<T>::unpack(__ldg(reinterpret_cast<const unsigned int*>(p)), out);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f32(p[i]);
  }
}

#define REPRO_MAX_STEPS 8
#define REPRO_MAX_SIDES 4
#define REPRO_MAX_NORMS 4

// Order matches kernels/ref.py:ACTIVATIONS (None, relu, gelu, silu, tanh).
enum { ACT_NONE = 0, ACT_RELU = 1, ACT_GELU = 2, ACT_SILU = 3, ACT_TANH = 4 };
enum { STEP_ACT = 0, STEP_ADD = 1, STEP_MUL = 2, STEP_NORM = 3 };

struct StepProgram {
  int n_steps;
  int n_sides;
  int kind[REPRO_MAX_STEPS];
  int arg[REPRO_MAX_STEPS];
  float eps[REPRO_MAX_STEPS];
  const float* sides[REPRO_MAX_SIDES];
  const float* norm_scale[REPRO_MAX_NORMS];
  const float* norm_bias[REPRO_MAX_NORMS];
};

__device__ __forceinline__ float apply_act(int act, float v) {
  switch (act) {
    case ACT_RELU:
      return v > 0.f ? v : 0.f;
    case ACT_GELU: {
      // jax.nn.gelu's default: the tanh approximation
      const float c = 0.7978845608028654f;  // sqrt(2 / pi)
      return v * (0.5f * (1.f + tanhf(c * (v + 0.044715f * (v * v * v)))));
    }
    case ACT_SILU:
      return v / (1.f + expf(-v));
    case ACT_TANH:
      return tanhf(v);
    default:
      return v;
  }
}

// Side operand `i` with a compile-time index into the parameter struct (a
// run-time index would copy the struct to local memory).
__device__ __forceinline__ const float* side_ptr(const StepProgram& p, int i) {
  switch (i) {
    case 0: return p.sides[0];
    case 1: return p.sides[1];
    case 2: return p.sides[2];
    default: return p.sides[3];
  }
}

// Bias-free tail of a GEMM/conv output element at flat index `idx`: the
// add/mul/activation steps (no norm: a GEMM tile never holds whole rows).
// S is the side operands' element type (read as S, summed in f32).
// Kept rolled: unrolling it into every output of every GEMM/conv tile
// shape multiplies the build time (about 10x, measured) for no gain, the
// epilogue being a small share of a tile's work.
template <typename S = float>
__device__ __forceinline__ float apply_pointwise_steps(const StepProgram& p, float v,
                                                       long long idx) {
#pragma unroll 1
  for (int s = 0; s < p.n_steps; ++s) {
    const int kind = p.kind[s], arg = p.arg[s];
    if (kind == STEP_ACT) {
      v = apply_act(arg, v);
    } else if (kind == STEP_ADD) {
      v += to_f32(reinterpret_cast<const S*>(side_ptr(p, arg))[idx]);
    } else if (kind == STEP_MUL) {
      v *= to_f32(reinterpret_cast<const S*>(side_ptr(p, arg))[idx]);
    }
  }
  return v;
}

// The GEMM bodies' epilogue on a row-major output whose rows are ldo
// elements apart (dense_matmul*.cu: ldo = N; bsr_matmul.cu's wgmma route:
// the whole [M, Nb * bn] output a band writes into): bias, activation,
// step program, one rounding store, one column a call.
template <typename T>
struct RowEpilogue {
  const T* bias;
  T* out;
  int ldo;
  int act;
  StepProgram prog;
  __device__ __forceinline__ void operator()(int m, int n, const float* v) const {
    float y = v[0];
    if (bias) y += to_f32(bias[n]);
    y = apply_act(act, y);
    const long long idx = (long long)m * ldo + n;
    out[idx] = from_f32<T>(apply_pointwise_steps<T>(prog, y, idx));
  }
};

// Host side: fill a StepProgram from the flat arrays the ctypes binding
// passes.  `prog` holds (kind, arg) pairs; `eps` may be null; `sides` and
// `norms` (scale0, bias0, scale1, bias1, ...) are host arrays of device
// pointers.  Returns false when the program exceeds the fixed maxima or
// names a slot that does not exist.
static inline bool make_program(StepProgram* out, int n_steps, const int* prog,
                                const float* eps, int n_sides, const void* const* sides,
                                int n_norms, const void* const* norms) {
  if (n_steps < 0 || n_steps > REPRO_MAX_STEPS || n_sides < 0 ||
      n_sides > REPRO_MAX_SIDES || n_norms < 0 || n_norms > REPRO_MAX_NORMS) {
    return false;
  }
  *out = StepProgram{};
  out->n_steps = n_steps;
  out->n_sides = n_sides;
  for (int s = 0; s < n_steps; ++s) {
    const int kind = prog[2 * s], arg = prog[2 * s + 1];
    if (kind == STEP_ACT && (arg < ACT_NONE || arg > ACT_TANH)) return false;
    if ((kind == STEP_ADD || kind == STEP_MUL) && (arg < 0 || arg >= n_sides)) return false;
    if (kind == STEP_NORM && (arg < 0 || arg >= n_norms)) return false;
    if (kind < STEP_ACT || kind > STEP_NORM) return false;
    out->kind[s] = kind;
    out->arg[s] = arg;
    out->eps[s] = eps ? eps[s] : 0.f;
  }
  for (int i = 0; i < n_sides; ++i) out->sides[i] = static_cast<const float*>(sides[i]);
  for (int i = 0; i < n_norms; ++i) {
    out->norm_scale[i] = static_cast<const float*>(norms[2 * i]);
    out->norm_bias[i] = static_cast<const float*>(norms[2 * i + 1]);
  }
  return true;
}
