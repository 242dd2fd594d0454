// A launch counter on the device, one for each kernel source.
//
// REPRO_LAUNCH_COUNTER(reader) defines, in the including file, a counter in
// device memory, the device function count_launch() that a kernel calls
// first, and the C function
//
//   int reader(unsigned int* count, int reset)
//
// which copies the count to the host and, with reset, sets it to 0 (returns
// a cudaError_t).  The first thread of a kernel's first block adds one each
// time the kernel runs: launched from the host, or replayed inside a
// captured CUDA graph, where no host code runs.  So the count is what ran on
// the card, not what the host asked for.  The reader synchronises with the
// legacy default stream; it is called between runs, never while a stream is
// being captured.
#pragma once

#include <cuda_runtime.h>

#define REPRO_LAUNCH_COUNTER(reader)                                         \
  namespace {                                                                \
  __device__ unsigned int g_launches = 0;                                    \
  __device__ __forceinline__ void count_launch() {                           \
    if ((blockIdx.x | blockIdx.y | blockIdx.z | threadIdx.x | threadIdx.y |  \
         threadIdx.z) == 0)                                                  \
      atomicAdd(&g_launches, 1u);                                            \
  }                                                                          \
  }                                                                          \
  extern "C" int reader(unsigned int* count, int reset) {                    \
    cudaError_t err =                                                        \
        cudaMemcpyFromSymbol(count, g_launches, sizeof(unsigned int));       \
    if (err == cudaSuccess && reset) {                                       \
      const unsigned int zero = 0;                                           \
      err = cudaMemcpyToSymbol(g_launches, &zero, sizeof(unsigned int));     \
    }                                                                        \
    return (int)err;                                                         \
  }
