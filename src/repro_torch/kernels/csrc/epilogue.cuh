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
// the program against these before they launch.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

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
// Kept rolled: unrolling it into every output of every GEMM/conv tile
// shape multiplies the build time (about 10x, measured) for no gain, the
// epilogue being a small share of a tile's work.
__device__ __forceinline__ float apply_pointwise_steps(const StepProgram& p, float v,
                                                       long long idx) {
#pragma unroll 1
  for (int s = 0; s < p.n_steps; ++s) {
    const int kind = p.kind[s], arg = p.arg[s];
    if (kind == STEP_ACT) {
      v = apply_act(arg, v);
    } else if (kind == STEP_ADD) {
      v += side_ptr(p, arg)[idx];
    } else if (kind == STEP_MUL) {
      v *= side_ptr(p, arg)[idx];
    }
  }
  return v;
}

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
