// A kernel that does nothing, for chip_smoke.py only: launched on `grid`
// CTAs of 512 threads in thread-block clusters of `cluster` CTAs, the shape
// of an update kernel's launch, its device time is the floor of any launch
// of that shape. Built by chip_smoke.py with nvcc (sm_90a) into a library
// of its own, apart from the port's kernels.
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
