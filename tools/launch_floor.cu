// Empty kernels launched the way csrc/wgmma_gemm.cuh launches its body
// (a grid of CTAs, a thread block cluster along z, dynamic shared memory),
// for tools/wgmma_bench.py --floor: the time a launch of that shape takes
// on the card before any copy or product, with and without the body's two
// cluster barriers.  Built by the tool with nvcc into a shared library
// with a plain C interface.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

__global__ void floor_empty_kernel() {}

// the body's two cluster barriers (before and after the split sum), nothing else
__global__ void floor_cluster_kernel() {
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  cluster.sync();
}

// grid (gx, gy, gz) of `threads` threads, `smem` bytes of dynamic shared
// memory, clusters of (1, 1, cz) CTAs (cz 0: no cluster attribute);
// `syncs` 1 runs the two cluster barriers.  Returns the launch's error.
extern "C" int floor_launch(int gx, int gy, int gz, int cz, int threads, int smem, int syncs,
                            void* stream) {
  void (*kernel)() = syncs ? floor_cluster_kernel : floor_empty_kernel;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(gx, gy, gz);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cz;
  cfg.attrs = attr;
  cfg.numAttrs = cz > 0 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
