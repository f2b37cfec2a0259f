// Yardsticks for chip_smoke.py only, built by it with nvcc (sm_90a) into a
// library of its own, apart from the port's kernels:
//  * empty_kernel: does nothing; launched on `grid` CTAs of 512 threads in
//    thread-block clusters of `cluster` CTAs, the shape of an update
//    kernel's launch, its device time is the floor of any launch of that
//    shape;
//  * empty_grid_kernel: does nothing, on a 2-D grid of CTAs of any size
//    with dynamic shared memory: the floor of the DTW and median launches;
//  * chain_kernel: one thread runs `steps` dependent steps of a DTW cell's
//    arithmetic (three double compares, a select, an add): at N + M - 1
//    steps, the least time of the recursion's dependency chain.
#include <cuda_runtime.h>

__global__ void __launch_bounds__(512) empty_kernel(int) {}

extern "C" int wtt_empty_kernel(int grid, int cluster, cudaStream_t stream) {
  cudaFuncSetAttribute(empty_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(512);
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // the one argument keeps cudaLaunchKernelEx's argument array from being empty
  return (int)cudaLaunchKernelEx(&cfg, empty_kernel, 0);
}

__global__ void __launch_bounds__(1024) empty_grid_kernel(int) {}

extern "C" int wtt_empty_grid(int grid_x, int grid_y, int threads, int smem_bytes,
                              cudaStream_t stream) {
  cudaError_t rc = cudaFuncSetAttribute(empty_grid_kernel,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (rc != cudaSuccess) return (int)rc;
  empty_grid_kernel<<<dim3(grid_x, grid_y), threads, smem_bytes, stream>>>(0);
  return (int)cudaGetLastError();
}

__global__ void chain_kernel(double inc, int steps, double* out) {
  // inc is a kernel argument: nothing in the chain can be folded
  double diag = inc, up = 2.0 * inc, left = 3.0 * inc;
  for (int s = 0; s < steps; ++s) {
    double best;
    if (diag < up && diag < left) {
      best = diag;
    } else if (up < diag && up < left) {
      best = up;
    } else {
      best = left;
    }
    diag = up;
    up = left;
    left = best + inc;
  }
  out[0] = diag + up + left;
}

extern "C" int wtt_chain(double inc, int steps, double* out, cudaStream_t stream) {
  chain_kernel<<<1, 1, 0, stream>>>(inc, steps, out);
  return (int)cudaGetLastError();
}
