// Timing harness for the port's bf16 GEMM kernels, without PyTorch: the
// tensor-core kernel (src/repro_torch/kernels/csrc/mma_gemm.cuh) at the
// decoder's M = 48 prefill shapes over several K splits and tiles, and the
// decode step's skinny kernel (csrc/skinny_bf16.cuh) beside the split-K
// kernel it replaced for bf16 (csrc/skinny_gemm.cuh, which still serves the
// f32 gate/up route), at qwen2.5-3b's M = 3 shapes.  Built and run by
// tools/gemm_bench.sh on a machine with an H100.
//
// Times are CUDA events around back-to-back launches (launch gaps
// included), the mean of `reps` calls after 5 warm-up calls, on
// zero-filled operands (the kernels' time does not depend on the values).
#include <cuda_runtime.h>

#include <cstdio>
#include <cstdlib>

#include "mma_gemm.cuh"
#include "skinny_bf16.cuh"
#include "skinny_gemm.cuh"

using bf16 = __nv_bfloat16;

struct Store1 {
  bf16* out;
  int N;
  __device__ void operator()(int m, int n, const float* v) const {
    out[(long long)m * N + n] = __float2bfloat16_rn(v[0]);
  }
};
struct Store2 {
  bf16* out;
  int N;
  __device__ void operator()(int m, int n, const float* v) const {
    out[(long long)m * N + n] = __float2bfloat16_rn(v[0] * v[1]);
  }
};

static int g_reps = 50;

template <typename F>
float time_ms(F f) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  for (int i = 0; i < 5; ++i) f();
  cudaDeviceSynchronize();
  cudaEventRecord(a);
  for (int i = 0; i < g_reps; ++i) f();
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, a, b);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    std::printf("CUDA error %s\n", cudaGetErrorString(e));
    std::exit(1);
  }
  return ms / g_reps;
}

int main(int argc, char** argv) {
  if (argc > 1) g_reps = std::atoi(argv[1]);
  const long long big = 11008LL * 2048;
  bf16 *x, *w, *w2, *out;
  float* ws;
  int *cnt, *cnt_old;
  cudaMalloc(&x, 64LL * 11008 * 2);
  cudaMalloc(&w, big * 2);
  cudaMalloc(&w2, big * 2);
  cudaMalloc(&out, 64LL * 11008 * 2);
  cudaMalloc(&ws, 64LL * 64 * 11008 * 4);
  cudaMalloc(&cnt, 8192 * 4);
  cudaMalloc(&cnt_old, 8192 * 4);
  cudaMemset(x, 0, 64LL * 11008 * 2);
  cudaMemset(w, 0, big * 2);
  cudaMemset(w2, 0, big * 2);
  cudaMemset(cnt, 0, 8192 * 4);  // the new kernels leave their counters zeroed
  const int M = 48;

  std::printf("tensor-core kernel, M = 48 (depth-1 tiles; kchunk = K rows a split range)\n");
  auto q = [&](int chunk) {
    return time_ms([&] {
      mma_gemm::launch<64, 64, 64, 1, 1>(x, w, nullptr, M, 2048, 2048, chunk, ws, cnt,
                                         Store1{out, 2048}, 0);
    });
  };
  auto q128 = [&](int chunk) {
    return time_ms([&] {
      mma_gemm::launch<64, 64, 128, 1, 1>(x, w, nullptr, M, 2048, 2048, chunk, ws, cnt,
                                          Store1{out, 2048}, 0);
    });
  };
  for (int c : {2048, 448, 256, 128})
    std::printf("  q 2048->2048 kchunk %5d: 64x64x64 %.4f ms, 64x64x128 %.4f ms\n", c, q(c),
                q128(c));
  for (int c : {2048, 256, 128, 64})
    std::printf("  k/v 2048->256 kchunk %5d: 64x32x64 %.4f ms\n", c, time_ms([&] {
                  mma_gemm::launch<64, 32, 64, 1, 1>(x, w, nullptr, M, 256, 2048, c, ws, cnt,
                                                     Store1{out, 256}, 0);
                }));
  for (int c : {2240, 1408, 1024, 704})
    std::printf("  down 11008->2048 kchunk %5d: 64x64x64 %.4f ms\n", c, time_ms([&] {
                  mma_gemm::launch<64, 64, 64, 1, 1>(x, w, nullptr, M, 2048, 11008, c, ws, cnt,
                                                     Store1{out, 2048}, 0);
                }));
  for (int c : {2048, 1024})
    std::printf("  gate/up 2048->11008 kchunk %5d: 64x64x64 %.4f ms\n", c, time_ms([&] {
                  mma_gemm::launch<64, 64, 64, 1, 2>(x, w, w2, M, 11008, 2048, c, ws, cnt,
                                                     Store2{out, 11008}, 0);
                }));

  std::printf("skinny kernels, M = 3 (old: skinny_gemm.cuh's split-K kernel instantiated for "
              "bf16 as the port ran it before, its counters zeroed by a memset per call as its "
              "wrapper did; new: skinny_bf16.cuh)\n");
  struct Case {
    const char* name;
    int N, K, old_chunk, new_chunk, nw;
  } cases[] = {{"q 2048->2048", 2048, 2048, 64, 256, 1},
               {"down 11008->2048", 2048, 11008, 1001, 1024, 1},
               {"gate/up 2048->11008", 11008, 2048, 512, 1024, 2}};
  for (const Case& c : cases) {
    float t_old, t_new;
    if (c.nw == 1) {
      t_old = time_ms([&] {
        cudaMemsetAsync(cnt_old, 0, 8192 * 4);
        launch_skinny<bf16, 1, 8>(x, w, nullptr, 3, c.N, c.K, c.old_chunk, ws, cnt_old,
                                  Store1{out, c.N}, 0);
      });
      t_new = time_ms([&] {
        skinny_bf16::launch<1>(x, w, nullptr, 3, c.N, c.K, c.new_chunk, 8, ws, cnt,
                               Store1{out, c.N}, 0);
      });
    } else {
      t_old = time_ms([&] {
        cudaMemsetAsync(cnt_old, 0, 8192 * 4);
        launch_skinny<bf16, 2, 4>(x, w, w2, 3, c.N, c.K, c.old_chunk, ws, cnt_old,
                                  Store2{out, c.N}, 0);
      });
      t_new = time_ms([&] {
        skinny_bf16::launch<2>(x, w, w2, 3, c.N, c.K, c.new_chunk, 8, ws, cnt,
                               Store2{out, c.N}, 0);
      });
    }
    std::printf("  %-22s old %.4f ms, new %.4f ms\n", c.name, t_old, t_new);
  }
  return 0;
}
