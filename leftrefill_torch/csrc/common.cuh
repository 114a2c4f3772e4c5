// Shared helpers for the hand-written Hopper kernels (built for sm_90a).
//
// Every kernel is exported through a plain C function that takes raw device
// pointers, integer shapes and the CUDA stream, launches on that stream, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.  Nothing here allocates device memory: the wrapper does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace lr {

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

// bf16 x bf16 -> fp32 tensor-core tiles (mma.sync under WMMA)
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBRow = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBCol = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 16-byte global -> shared copy through the async-copy unit.  With
// pred == false nothing is read and the 16 bytes are zero-filled (KI2's
// ragged tiles).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Dynamic shared memory above 48 KB must be granted per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace lr
