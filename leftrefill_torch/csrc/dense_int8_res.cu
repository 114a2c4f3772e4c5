// KI2: int8 GEMM with the per-row x per-column dequant, bias and residual,
// [R, K] int8 x [N, K] int8 -> [R, N] bf16.
//
// Replaces leftrefill_tpu/ops/quant.py:_dense_int8_res_mom_kernel (K9, the
// SpatialTransformer proj_out with its `+ x_in`).  out[r, n] =
// bf16(((float(acc) * sx[r]) * sw[n] + b[n]) + float(res[r, n])), acc the
// int32 sum of xq[r, :] * wq[n, :], in the TPU kernel's order with every
// multiply and add rounded on its own.  The TPU kernel's [B, 4, N] output
// moments are not computed: nothing reads them.
//
// Design: the int8 tensor-core tile GEMM of int8_gemm.cuh (128 x 128 tiles,
// 64-byte K steps, 3-stage cp.async ring); the weight is read in torch's
// Linear layout [N, K], K contiguous, as the B operand wants it.  The 16x32
// and 8x16 sites (R = 1024 and 256, N = 1280) give 20-80 tiles, so K is
// split over gridDim.z there and a second kernel adds the int32 partials
// (exact) before the epilogue.
#include "int8_gemm.cuh"

namespace lr {
namespace {

using namespace i8;

__device__ __forceinline__ float dense_epilogue(int acc, float sx, float sw, float b, bf16 res) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b),
                   __bfloat162float(res));
}

__global__ void __launch_bounds__(NTHREADS)
    dense_int8_res_kernel(const int8_t* __restrict__ x, const float* __restrict__ sx,
                          const int8_t* __restrict__ w, const float* __restrict__ sw,
                          const float* __restrict__ bias, const bf16* __restrict__ res,
                          bf16* __restrict__ out, int* __restrict__ partial, int r_total, int k,
                          int n_total) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cc = (tid & 3) * 16;

  auto load = [&](int step, int8_t* A, int8_t* B) {
    const int c0 = step * BK;
    const bool cok = c0 + cc < k;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const bool aok = cok && m0 + r < r_total;
      cp_async16(A + r * LDS + cc, aok ? x + size_t(m0 + r) * k + c0 + cc : x, aok);
      const bool bok = cok && n0 + r < n_total;
      cp_async16(B + r * LDS + cc, bok ? w + size_t(n0 + r) * k + c0 + cc : w, bok);
    }
  };

  const int nsteps = (k + BK - 1) / BK;
  const int splits = gridDim.z, z = blockIdx.z;
  Acc acc;
  gemm_mainloop(acc, load, nsteps * z / splits, nsteps * (z + 1) / splits, smem);

  if (splits > 1) {
    int* pz = partial + size_t(z) * r_total * n_total;
    for_each_acc(acc, [&](int r, int c, int v) {
      const int m = m0 + r, n = n0 + c;
      if (m < r_total && n < n_total) pz[size_t(m) * n_total + n] = v;
    });
    return;
  }
  for_each_acc(acc, [&](int r, int c, int v) {
    const int m = m0 + r, n = n0 + c;
    if (m < r_total && n < n_total) {
      const size_t o = size_t(m) * n_total + n;
      out[o] = __float2bfloat16_rn(dense_epilogue(v, sx[m], sw[n], bias[n], res[o]));
    }
  });
}

__global__ void dense_int8_res_finish_kernel(const int* __restrict__ partial, int splits,
                                             const float* __restrict__ sx,
                                             const float* __restrict__ sw,
                                             const float* __restrict__ bias,
                                             const bf16* __restrict__ res, bf16* __restrict__ out,
                                             size_t n_out, int n_total) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_out;
       i += size_t(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += partial[s * n_out + i];
    const int n = int(i % n_total);
    out[i] = __float2bfloat16_rn(dense_epilogue(acc, sx[i / n_total], sw[n], bias[n], res[i]));
  }
}

}  // namespace
}  // namespace lr

// The split count of K for this shape (int8_gemm.cuh: k_splits), or a negated CUDA error.
extern "C" int lr_dense_int8_res_splits(int r, int k, int n) {
  return lr::i8::k_splits(r, n, (k + lr::i8::BK - 1) / lr::i8::BK);
}

// x: [r, k] int8; sx: [r] fp32; w: [n, k] int8; sw, bias: [n] fp32; res, out: [r, n] bf16;
// all contiguous, k a multiple of 16.  splits > 1 splits K and needs partial: [splits, r, n]
// int32 scratch.
extern "C" int lr_dense_int8_res(const void* x, const void* sx, const void* w, const void* sw,
                                 const void* bias, const void* res, void* out, void* partial, int r,
                                 int k, int n, int splits, void* stream) {
  if (k % 16 || r <= 0 || n <= 0 || splits < 1 || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = lr::allow_smem(lr::dense_int8_res_kernel, lr::i8::GEMM_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((r + lr::i8::BM - 1) / lr::i8::BM, (n + lr::i8::BN - 1) / lr::i8::BN, splits);
  const auto* res_p = static_cast<const lr::bf16*>(res);
  lr::dense_int8_res_kernel<<<grid, lr::i8::NTHREADS, lr::i8::GEMM_SMEM, s>>>(
      static_cast<const int8_t*>(x), static_cast<const float*>(sx), static_cast<const int8_t*>(w),
      static_cast<const float*>(sw), static_cast<const float*>(bias), res_p,
      static_cast<lr::bf16*>(out), static_cast<int*>(partial), r, k, n);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  lr::dense_int8_res_finish_kernel<<<1024, 256, 0, s>>>(
      static_cast<const int*>(partial), splits, static_cast<const float*>(sx),
      static_cast<const float*>(sw), static_cast<const float*>(bias), res_p,
      static_cast<lr::bf16*>(out), size_t(r) * n, n);
  return static_cast<int>(cudaGetLastError());
}
