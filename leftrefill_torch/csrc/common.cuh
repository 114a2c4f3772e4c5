// Shared helpers for the hand-written Hopper kernels (built for sm_90a).
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, integer shapes and the CUDA stream, launches on that stream, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Nothing here allocates device memory: the wrapper does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lr {

using bf16 = __nv_bfloat16;

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lr
