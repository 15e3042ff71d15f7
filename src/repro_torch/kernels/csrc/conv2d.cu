// Implicit-GEMM conv2d with the fused epilogue program, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/conv2d.py:conv2d_gemm_kernel
// (wrapper conv2d_gemm), every scheme: f32, channel-pruned
// ("channelcompact"), and the INT8 schemes W8 and W8A8 (scheme.cuh):
//   out = epilogue(act(conv(x[:, kept], w) * ws + bias))
// with ws the per-output-channel rescale of the INT8 schemes (absent for
// f32): w_scale for W8, w_scale * x_scale for W8A8, folded by the wrapper.
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
// are masked.  The rescale, bias, activation and the epilogue steps (add/mul
// with NCHW side operands) run on the accumulator before the one store.
//
// INT8 schemes, one kernel body templated on the scheme: W8 stages f32
// patches and converts each int8 filter element to f32 as it is staged
// (f32 accumulator); W8A8 stages int8 patches and int8 filters (a quarter
// of the f32 shared memory) and accumulates exact int32 sums.  The wrapper
// quantizes W8A8 activations before the launch, as the TPU wrapper does
// (round half to even, clip to +-127), so the kernel reads int8 NCHW.
//
// What bounds it here: the demo apps' 3x3 / 7x7 layers carry K = 147..1728
// per output, so multiply-add throughput on the CUDA cores (f32 FMA, or
// integer multiply-add for W8A8) bounds them, not memory.  Every scheme is
// built for the six tiles of tiles.cuh and the wrapper picks one: the
// tuning cache's winner, a pin, or the default -- for f32 by output-channel
// count, so narrow heads (O = 2..12) do not waste most of a 64-wide tile;
// for the INT8 schemes the O <= 32 / wider pair, the apps' quantized convs
// being 32..128 channels wide.  Tensor cores (wgmma in TF32 or lower, s8
// for W8A8) are later work.

#include <cuda_runtime.h>

#include "epilogue.cuh"
#include "scheme.cuh"
#include "tiles.cuh"

namespace {

template <int S, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    conv2d_igemm_kernel(const typename Scheme<S>::X* __restrict__ x,
                        const typename Scheme<S>::WG* __restrict__ w,
                        const float* __restrict__ ws, const float* __restrict__ bias,
                        const int* __restrict__ kept, float* __restrict__ out, int Nb, int C_in,
                        int H, int W, int C, int O, int kh, int kw, int stride, int pad_t,
                        int pad_l, int OH, int OW, int act, StepProgram prog) {
  using X = typename Scheme<S>::X;
  using SW = typename Scheme<S>::SW;
  using Acc = typename Scheme<S>::Acc;
  constexpr int TX = BM / TM;  // threads along pixels (fastest: coalesced)
  constexpr int TY = BN / TN;  // threads along output channels
  constexpr int NT = TX * TY;
  __shared__ X As[BK][BM];
  __shared__ SW Bs[BK][BN + 1];
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

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

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
      X v = X(0);
      const long long xb = s_xbase[mm], co = s_coff[kk];
      if (xb >= 0 && co >= 0) {
        const int ih = s_ih0[mm] + s_ki[kk];
        const int iw = s_iw0[mm] + s_kj[kk];
        if (ih >= 0 && ih < H && iw >= 0 && iw < W) v = x[xb + co + (long long)ih * W + iw];
      }
      As[kk][mm] = v;
    }
    // filter slab [BK, BN]: w is [O, K] row-major, neighbouring threads read
    // neighbouring k; W8 converts each int8 filter element to f32 here
    for (int e = tid; e < BK * BN; e += NT) {
      const int kk = e % BK, nn = e / BK;
      const int k = k0 + kk, o = n0 + nn;
      Bs[kk][nn] = (k < K && o < O) ? SW(w[(long long)o * K + k]) : SW(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      X a[TM];
      SW b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tx + i * TX];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][ty + j * TY];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = mac(acc[i][j], a[i], b[j]);
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
      float v = (float)acc[i][j];
      if (ws) v *= ws[o];
      if (bias) v += bias[o];
      v = apply_act(act, v);
      out[idx] = apply_pointwise_steps(prog, v, idx);
    }
  }
}

template <int S, int BM, int BN, int BK, int TM, int TN>
void launch(const void* x, const void* w, const float* ws, const float* bias, const int* kept,
            float* out, int Nb, int C_in, int H, int W, int C, int O, int kh, int kw,
            int stride, int pad_t, int pad_l, int OH, int OW, int act, const StepProgram& prog,
            cudaStream_t stream) {
  const long long M = (long long)Nb * OH * OW;
  dim3 grid((unsigned)((M + BM - 1) / BM), (O + BN - 1) / BN);
  dim3 block((BM / TM) * (BN / TN));
  conv2d_igemm_kernel<S, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(
      static_cast<const typename Scheme<S>::X*>(x), static_cast<const typename Scheme<S>::WG*>(w),
      ws, bias, kept, out, Nb, C_in, H, W, C, O, kh, kw, stride, pad_t, pad_l, OH, OW, act, prog);
}

// The tile (bm, bn, bk) must be one of tiles.cuh's REPRO_CONV_TILES (the
// wrapper picks it: the tuning cache's winner, a pin, or the default by
// scheme and output-channel count); returns false for any other.
template <int S>
bool dispatch(const void* x, const void* w, const float* ws, const float* bias, const int* kept,
              float* out, int Nb, int C_in, int H, int W, int C, int O, int kh, int kw,
              int stride, int pad_t, int pad_l, int OH, int OW, int act, const StepProgram& p,
              int bm, int bn, int bk, cudaStream_t st) {
#define REPRO_TRY_TILE(BM, BN, BK, TM, TN)                                                  \
  if (bm == BM && bn == BN && bk == BK) {                                                   \
    launch<S, BM, BN, BK, TM, TN>(x, w, ws, bias, kept, out, Nb, C_in, H, W, C, O, kh, kw, \
                                  stride, pad_t, pad_l, OH, OW, act, p, st);                \
    return true;                                                                            \
  }
  REPRO_CONV_TILES(REPRO_TRY_TILE)
#undef REPRO_TRY_TILE
  return false;
}

}  // namespace

// scheme: SCHEME_F32 (x, w f32; ws null), SCHEME_W8 (x f32, w int8) or
// SCHEME_W8A8 (x, w int8); the INT8 schemes need ws.  The tile (bm, bn,
// bk) must be one of tiles.cuh's (else cudaErrorInvalidValue).
extern "C" int repro_conv2d(const void* x, const void* w, const void* ws, const void* bias,
                            const void* kept, void* out, int Nb, int C_in, int H, int W, int C,
                            int O, int kh, int kw, int stride, int pad_t, int pad_l, int OH,
                            int OW, int act, int scheme, int n_steps, const int* prog,
                            int n_sides, const void* const* sides, int bm, int bn, int bk,
                            void* stream) {
  StepProgram p;
  if (Nb < 0 || C_in < 0 || C < 0 || O < 0 || kh < 1 || kw < 1 || stride < 1 || OH < 0 ||
      OW < 0 || scheme < SCHEME_F32 || scheme > SCHEME_W8A8 ||
      (scheme != SCHEME_F32 && ws == nullptr) ||
      !make_program(&p, n_steps, prog, nullptr, n_sides, sides, 0, nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int s = 0; s < n_steps; ++s) {
    if (p.kind[s] == STEP_NORM) return (int)cudaErrorInvalidValue;
  }
  if (Nb == 0 || O == 0 || OH == 0 || OW == 0) return (int)cudaSuccess;
  const float* wsf = static_cast<const float*>(ws);
  const float* bf = static_cast<const float*>(bias);
  const int* kp = static_cast<const int*>(kept);
  float* of = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bool known;
  if (scheme == SCHEME_W8A8) {
    known = dispatch<SCHEME_W8A8>(x, w, wsf, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                  pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  } else if (scheme == SCHEME_W8) {
    known = dispatch<SCHEME_W8>(x, w, wsf, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  } else {
    known = dispatch<SCHEME_F32>(x, w, nullptr, bf, kp, of, Nb, C_in, H, W, C, O, kh, kw, stride,
                                 pad_t, pad_l, OH, OW, act, p, bm, bn, bk, st);
  }
  if (!known) return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
