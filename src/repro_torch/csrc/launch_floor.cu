// An empty kernel: the fixed cost of one launch, the floor under every
// kernel's time.  chip_smoke.py times it as it times the kernels and
// prints it beside each kernel's row; it replaces no TPU kernel.
#include <cuda_runtime.h>

namespace {

__global__ void empty_kernel() {}

}  // namespace

// An empty grid of (blocks_x, blocks_y) blocks of `threads` threads, in
// clusters of `cluster` blocks along x (1: no clusters).
extern "C" int repro_empty_launch(int blocks_x, int blocks_y, int threads,
                                  int cluster, void* stream) {
  if (blocks_x < 1 || blocks_y < 1 || threads < 1 || cluster < 1 ||
      blocks_x % cluster != 0)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned int)blocks_x, (unsigned int)blocks_y);
  cfg.blockDim = dim3((unsigned int)threads);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned int)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}
