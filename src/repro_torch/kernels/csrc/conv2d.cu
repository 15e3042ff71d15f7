// Implicit-GEMM conv2d with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/conv2d.py:conv2d_gemm_kernel
// (wrapper conv2d_gemm), f32 and channel-pruned ("channelcompact") schemes:
//   out = epilogue(act(conv(x[:, kept], w) + bias))
//
// GEMM view: M = N * OH * OW output pixels, N_gemm = O output channels,
// K = C * kh * kw with C the live (kept) input channels; K is ordered like
// the OIHW filter, k = (c * kh + ki) * kw + kj, so a filter row is a
// contiguous slice of w.
//
// Unlike the TPU kernel, which takes a zero-padded NHWC copy made in device
// memory, this one reads the NCHW input where it lies: each thread block
// owns a BM-pixel x BN-channel output tile; per K slab it gathers the patch
// elements x[n, kept[c], oh*s - pad_t + ki, ow*s - pad_l + kj] into shared
// memory (the zero border is a bounds check, the channel gather an index
// load), never materialising the im2col matrix anywhere.  Neighbouring
// threads take neighbouring output pixels, so patch loads and NCHW output
// stores are coalesced along the image row.  Ragged pixel / channel edges
// are masked.  Bias, activation and the epilogue steps (add/mul with NCHW
// side operands) run on the f32 accumulator before the one store.
//
// What bounds it here: the 3x3 / 7x7 layers of the demo apps carry
// K = 147..1728 per output, so FMA throughput on the CUDA cores (true f32,
// no TF32) bounds them, not memory; the tile shape is picked per layer by
// its output-channel count so narrow heads (O = 2..12) do not waste most of
// a 64-wide tile.  Tensor cores (wgmma in TF32 or lower) are later work.

#include <cuda_runtime.h>

#include "epilogue.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv2d_igemm_kernel(const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ bias, const int* __restrict__ kept,
                        float* __restrict__ out, int Nb, int C_in, int H, int W, int C, int O,
                        int kh, int kw, int stride, int pad_t, int pad_l, int OH, int OW,
                        int act, StepProgram prog) {
  constexpr int TX = BM / TM;  // threads along pixels (fastest: coalesced)
  constexpr int TY = BN / TN;  // threads along output channels
  constexpr int NT = TX * TY;
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN + 1];
  __shared__ long long s_xbase[BM];  // n * C_in * H * W, or -1 past M
  __shared__ long long s_obase[BM];  // n * O * OH * OW + oh * OW + ow
  __shared__ int s_ih0[BM];
  __shared__ int s_iw0[BM];
  __shared__ long long s_coff[BK];  // kept[c] * H * W, or -1 past K
  __shared__ int s_ki[BK];
  __shared__ int s_kj[BK];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const long long M = (long long)Nb * OH * OW;
  const int K = C * kh * kw;
  const int khw = kh * kw;
  const long long HW = (long long)H * W;
  const long long OHW = (long long)OH * OW;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  for (int mm = tid; mm < BM; mm += NT) {
    const long long m = m0 + mm;
    if (m < M) {
      const int n = (int)(m / OHW);
      const int p = (int)(m - (long long)n * OHW);
      const int oh = p / OW, ow = p - (p / OW) * OW;
      s_xbase[mm] = (long long)n * C_in * HW;
      s_obase[mm] = (long long)n * O * OHW + p;
      s_ih0[mm] = oh * stride - pad_t;
      s_iw0[mm] = ow * stride - pad_l;
    } else {
      s_xbase[mm] = -1;
      s_obase[mm] = -1;
      s_ih0[mm] = 0;
      s_iw0[mm] = 0;
    }
  }
  __syncthreads();  // K may be 0 (every channel pruned): the epilogue reads these

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int kk = tid; kk < BK; kk += NT) {
      const int k = k0 + kk;
      if (k < K) {
        const int c = k / khw;
        const int r = k - c * khw;
        const int ch = kept ? kept[c] : c;
        s_coff[kk] = (long long)ch * HW;
        s_ki[kk] = r / kw;
        s_kj[kk] = r - (r / kw) * kw;
      } else {
        s_coff[kk] = -1;
        s_ki[kk] = 0;
        s_kj[kk] = 0;
      }
    }
    __syncthreads();
    // patch slab [BK, BM]: neighbouring threads gather neighbouring pixels
    for (int e = tid; e < BM * BK; e += NT) {
      const int mm = e % BM, kk = e / BM;
      float v = 0.f;
      const long long xb = s_xbase[mm], co = s_coff[kk];
      if (xb >= 0 && co >= 0) {
        const int ih = s_ih0[mm] + s_ki[kk];
        const int iw = s_iw0[mm] + s_kj[kk];
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) v = x[xb + co + (long long)ih * W + iw];
      }
      As[kk][mm] = v;
    }
    // filter slab [BK, BN]: w is [O, K] row-major, neighbouring threads read
    // neighbouring k
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e % BK, nn = e / BK;
      const int k = k0 + kk, o = n0 + nn;
      Bs[kk][nn] = (k < K && o < O) ? w[(long long)o * K + k] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + i * TX];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][ty + j * TY];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int mm = tx + i * TX;
    const long long ob = s_obase[mm];
    if (ob < 0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int o = n0 + ty + j * TY;
      if (o >= O) continue;
      const long long idx = ob + (long long)o * OHW;
      float v = acc[i][j];
      if (bias) v += bias[o];
      v = apply_act(act, v);
      out[idx] = apply_pointwise_steps(prog, v, idx);
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
void launch(const float* x, const float* w, const float* bias, const int* kept, float* out,
            int Nb, int C_in, int H, int W, int C, int O, int kh, int kw, int stride,
            int pad_t, int pad_l, int OH, int OW, int act, const StepProgram& prog,
            cudaStream_t stream) {
  const long long M = (long long)Nb * OH * OW;
  dim3 grid((unsigned)((M + BM - 1) / BM), (O + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  conv2d_igemm_kernel<BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      x, w, bias, kept, out, Nb, C_in, H, W, C, O, kh, kw, stride, pad_t, pad_l, OH, OW, act,
      prog);
}

}  // namespace

extern "C" int repro_conv2d(const void* x, const void* w, const void* bias, const void* kept,
                            void* out, int Nb, int C_in, int H, int W, int C, int O, int kh,
                            int kw, int stride, int pad_t, int pad_l, int OH, int OW, int act,
                            int n_steps, const int* prog, int n_sides,
                            const void* const* sides, void* stream) {
  StepProgram p;
  if (Nb < 0 || C_in < 0 || C < 0 || O < 0 || kh < 1 || kw < 1 || stride < 1 || OH < 0 ||
      OW < 0 || !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (Nb == 0 || O == 0 || OH == 0 || OW == 0) return (int)cudaSuccess;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  const int* kp = static_cast<const int*>(kept);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_CONV_LAUNCH(BM, BN, BK, TM, TN)                                                 \
  launch<BM, BN, BK, TM, TN>(xf, wf, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride, pad_t, \
                             pad_l, OH, OW, act, p, st)
  if (O <= 4) {
    REPRO_CONV_LAUNCH(256, 4, 16, 4, 1);
  } else if (O <= 16) {
    REPRO_CONV_LAUNCH(256, 16, 16, 4, 4);
  } else if (O <= 32) {
    REPRO_CONV_LAUNCH(128, 32, 16, 4, 4);
  } else {
    REPRO_CONV_LAUNCH(64, 64, 16, 4, 4);
  }
#undef REPRO_CONV_LAUNCH
  return (int)cudaGetLastError();
}
