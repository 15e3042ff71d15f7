// Fused elementwise step program over [M, D] rows, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// repro/kernels/fused_elementwise.py:fused_elementwise_kernel (wrapper
// fused_elementwise): one pass over x running a step program of activations,
// add/mul of same-shaped side operands and layer norms over the last dim.
//
// What bounds it here: a handful of FLOPs per element, so device memory
// bounds it; the design reads x and each side once and writes the output
// once, whatever the number of steps.  Two launch shapes:
//   * no norm step: a flat grid-stride loop over the M * D elements (four
//     at a time with 16-byte loads when every operand is aligned), every
//     value kept in a register through the whole program;
//   * with a norm step: one warp per row, the row staged in shared memory;
//     the norm takes the mean, then the mean of squared deviations, over
//     exactly D columns in f32 (warp-shuffle reductions), so the wrapper
//     pads no lanes.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

constexpr int kRowsPerBlock = 4;  // one warp per row

__global__ void fused_ew_flat_kernel(const float* __restrict__ x, float* __restrict__ out,
                                     long long n, StepProgram prog) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    out[i] = apply_pointwise_steps(prog, x[i], i);
  }
}

// Side operand group `j` of the preloaded registers, by compile-time index.
__device__ __forceinline__ float4 pick4(const float4 (&sv)[REPRO_MAX_SIDES], int j) {
  switch (j) {
    case 0: return sv[0];
    case 1: return sv[1];
    case 2: return sv[2];
    default: return sv[3];
  }
}

// The same over float4 groups (n4 = n / 4), for 16-byte aligned operands.
// Every side operand's group is loaded before the program runs, so the
// loads are in flight together instead of one after another.
__global__ void fused_ew_flat4_kernel(const float4* __restrict__ x, float4* __restrict__ out,
                                      long long n4, StepProgram prog) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += stride) {
    float4 v = x[i];
    float4 sv[REPRO_MAX_SIDES];
#pragma unroll
    for (int j = 0; j < REPRO_MAX_SIDES; ++j) {
      if (j < prog.n_sides) sv[j] = reinterpret_cast<const float4*>(prog.sides[j])[i];
    }
#pragma unroll 1
    for (int s = 0; s < prog.n_steps; ++s) {
      const int kind = prog.kind[s], arg = prog.arg[s];
      if (kind == STEP_ACT) {
        v.x = apply_act(arg, v.x);
        v.y = apply_act(arg, v.y);
        v.z = apply_act(arg, v.z);
        v.w = apply_act(arg, v.w);
      } else {
        const float4 t = pick4(sv, arg);
        if (kind == STEP_ADD) {
          v.x += t.x; v.y += t.y; v.z += t.z; v.w += t.w;
        } else {
          v.x *= t.x; v.y *= t.y; v.z *= t.z; v.w *= t.w;
        }
      }
    }
    out[i] = v;
  }
}

bool aligned16(const void* ptr) { return (reinterpret_cast<size_t>(ptr) & 15) == 0; }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void fused_ew_rows_kernel(const float* __restrict__ x, float* __restrict__ out,
                                     long long M, int D, StepProgram prog) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + warp;
  if (row >= M) return;  // whole warp leaves together: no block-wide sync below
  float* y = rows + (long long)warp * D;
  const long long base = row * D;
  for (int d = lane; d < D; d += 32) y[d] = x[base + d];
  for (int s = 0; s < prog.n_steps; ++s) {
    const int kind = prog.kind[s], arg = prog.arg[s];
    if (kind == STEP_NORM) {
      float sum = 0.f;
      for (int d = lane; d < D; d += 32) sum += y[d];
      const float mu = warp_sum(sum) / (float)D;
      float sq = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float dy = y[d] - mu;
        sq += dy * dy;
      }
      const float var = warp_sum(sq) / (float)D;
      const float denom = sqrtf(var + prog.eps[s]);
      const float* scale = prog.norm_scale[arg];
      const float* bias = prog.norm_bias[arg];
      for (int d = lane; d < D; d += 32) y[d] = (y[d] - mu) / denom * scale[d] + bias[d];
    } else {
      // each lane owns the same columns in every step: no cross-lane hazard
      for (int d = lane; d < D; d += 32) {
        float v = y[d];
        if (kind == STEP_ACT) {
          v = apply_act(arg, v);
        } else if (kind == STEP_ADD) {
          v += side_ptr(prog, arg)[base + d];
        } else {
          v *= side_ptr(prog, arg)[base + d];
        }
        y[d] = v;
      }
    }
  }
  for (int d = lane; d < D; d += 32) out[base + d] = y[d];
}

}  // namespace

// Largest D the row kernel stages (kRowsPerBlock rows in 227 KB of shared
// memory); the wrapper checks it before calling.
extern "C" int repro_fused_elementwise_max_d() {
  return (227 * 1024) / (kRowsPerBlock * (int)sizeof(float));
}

extern "C" int repro_fused_elementwise(const void* x, void* out, long long M, int D,
                                       int n_steps, const int* prog, const float* eps,
                                       int n_sides, const void* const* sides, int n_norms,
                                       const void* const* norms, void* stream) {
  StepProgram p;
  if (M < 0 || D < 0 ||
      !make_program(&p, n_steps, prog, eps, n_sides, sides, n_norms, norms)) {
    return (int)cudaErrorInvalidValue;
  }
  if (M == 0 || D == 0) return (int)cudaSuccess;
  bool has_norm = false;
  for (int s = 0; s < n_steps; ++s) has_norm = has_norm || p.kind[s] == STEP_NORM;
  const float* xf = static_cast<const float*>(x);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!has_norm) {
    const long long n = M * (long long)D;
    bool vec = n % 4 == 0 && aligned16(x) && aligned16(out);
    for (int i = 0; i < n_sides; ++i) vec = vec && aligned16(sides[i]);
    const long long items = vec ? n / 4 : n;
    const int threads = 256;
    long long blocks = (items + threads - 1) / threads;
    if (blocks > 132LL * 32) blocks = 132LL * 32;  // grid-stride beyond ~32 blocks per SM
    if (vec) {
      fused_ew_flat4_kernel<<<(unsigned)blocks, threads, 0, st>>>(
          reinterpret_cast<const float4*>(xf), reinterpret_cast<float4*>(of), items, p);
    } else {
      fused_ew_flat_kernel<<<(unsigned)blocks, threads, 0, st>>>(xf, of, n, p);
    }
    return (int)cudaGetLastError();
  }
  if (D > repro_fused_elementwise_max_d()) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)kRowsPerBlock * D * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(fused_ew_rows_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const long long blocks = (M + kRowsPerBlock - 1) / kRowsPerBlock;
  fused_ew_rows_kernel<<<(unsigned)blocks, kRowsPerBlock * 32, smem, st>>>(xf, of, M, D, p);
  return (int)cudaGetLastError();
}
