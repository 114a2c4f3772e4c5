// KI1: W8A8 3x3, stride 1, pad 1 convolution, NHWC int8 x OHWI int8 -> NHWC bf16
// (or fp32, for a model that computes in fp32).
//
// Replaces leftrefill_tpu/ops/quant.py:_conv_int8_kernel (K5, three
// column-shifted copies) and :_conv_int8_single_kernel (K6, one padded slab):
// the two compute the same function and differ only in TPU VMEM blocking.
// out[p, co] = float(acc) * scale[co] + bias[co], cast once to the output type, with
// acc = sum_{tap, ci} xq[p + tap, ci] * w[co, tap, ci] in int32 and
// scale = s_x * s_w[co] (the caller's fp32 product), as the TPU epilogue.
// The multiply and the add are separately rounded (no FMA contraction), so
// the result equals the plain version's element for element.
//
// Design: an implicit GEMM, M = B*H*W pixels, N = Co, K = 9*Ci, on the int8
// tensor cores (int8_gemm.cuh).  A K step is one tap and 64 input channels;
// each A row is gathered straight from the NHWC input at the tap's shifted
// pixel, and the async copy zero-fills the border pixels and the Ci tail, so
// no padded or shifted copy exists in device memory.  Where the tiles alone
// give fewer blocks than SMs (the 16x32 and 8x16 levels, M = 256..1024 with
// K up to 23040), K is split over gridDim.z: each split writes its int32
// partial sum and a second kernel adds them (integer sums: exact and
// order-free) before the same epilogue.
#include "int8_gemm.cuh"

namespace lr {
namespace {

using namespace i8;

struct ConvArgs {
  const int8_t* x;
  const int8_t* w;
  int nb, h, wd, ci, co, m_total, nci;
};

__device__ __forceinline__ float conv_epilogue(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

template <class Out>
__global__ void __launch_bounds__(NTHREADS)
    conv3x3_int8_kernel(ConvArgs a, const float* __restrict__ scale,
                        const float* __restrict__ bias, Out* __restrict__ out,
                        int* __restrict__ partial) {
  extern __shared__ __align__(128) int8_t smem[];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int cc = (tid & 3) * 16;

  // the two pixels (A rows) this thread gathers
  int pb[2], py[2], px[2];
  bool pok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + (tid >> 2) + 64 * i;
    pok[i] = m < a.m_total;
    const int mm = pok[i] ? m : 0;
    pb[i] = mm / (a.h * a.wd);
    const int rem = mm - pb[i] * a.h * a.wd;
    py[i] = rem / a.wd;
    px[i] = rem - py[i] * a.wd;
  }

  auto load = [&](int step, int8_t* A, int8_t* B) {
    const int tap = step / a.nci;
    const int c0 = (step - tap * a.nci) * BK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const bool cok = c0 + cc < a.ci;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + 64 * i;
      const int yy = py[i] + dy, xx = px[i] + dx;
      const bool ok = pok[i] && cok && yy >= 0 && yy < a.h && xx >= 0 && xx < a.wd;
      const int8_t* src =
          ok ? a.x + ((size_t(pb[i]) * a.h + yy) * a.wd + xx) * a.ci + c0 + cc : a.x;
      cp_async16(A + r * LDS + cc, src, ok);
      const int n = n0 + r;
      const bool wok = cok && n < a.co;
      cp_async16(B + r * LDS + cc, wok ? a.w + (size_t(n) * 9 + tap) * a.ci + c0 + cc : a.w, wok);
    }
  };

  const int nsteps = 9 * a.nci;
  const int splits = gridDim.z, z = blockIdx.z;
  const int s_begin = int((long long)nsteps * z / splits);
  const int s_end = int((long long)nsteps * (z + 1) / splits);
  Acc acc;
  gemm_mainloop(acc, load, s_begin, s_end, smem);

  if (splits > 1) {
    int* pz = partial + size_t(z) * a.m_total * a.co;
    for_each_acc(acc, [&](int r, int c, int v) {
      const int m = m0 + r, n = n0 + c;
      if (m < a.m_total && n < a.co) pz[size_t(m) * a.co + n] = v;
    });
    return;
  }
  for_each_acc(acc, [&](int r, int c, int v) {
    const int m = m0 + r, n = n0 + c;
    if (m < a.m_total && n < a.co)
      store(out + size_t(m) * a.co + n, conv_epilogue(v, scale[n], bias[n]));
  });
}

// Split-K finish: out = epilogue(sum of the int32 partials).
template <class Out>
__global__ void conv3x3_int8_finish_kernel(const int* __restrict__ partial, int splits,
                                           const float* __restrict__ scale,
                                           const float* __restrict__ bias, Out* __restrict__ out,
                                           size_t n_out, int co) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_out;
       i += size_t(gridDim.x) * blockDim.x) {
    int acc = 0;
    for (int s = 0; s < splits; ++s) acc += partial[s * n_out + i];
    const int n = int(i % co);
    store(out + i, conv_epilogue(acc, scale[n], bias[n]));
  }
}

template <class Out>
cudaError_t launch(const ConvArgs& a, const float* scale, const float* bias, Out* out, int* partial,
                   int splits, cudaStream_t s) {
  cudaError_t e = allow_smem(conv3x3_int8_kernel<Out>, GEMM_SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid((a.m_total + BM - 1) / BM, (a.co + BN - 1) / BN, splits);
  conv3x3_int8_kernel<Out><<<grid, NTHREADS, GEMM_SMEM, s>>>(a, scale, bias, out, partial);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  conv3x3_int8_finish_kernel<Out><<<1024, 256, 0, s>>>(partial, splits, scale, bias, out,
                                                       size_t(a.m_total) * a.co, a.co);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lr

// The split count of K for this shape (int8_gemm.cuh: k_splits), or a negated CUDA error.
extern "C" int lr_conv3x3_int8_splits(int b, int h, int wd, int ci, int co) {
  return lr::i8::k_splits(b * h * wd, co, 9 * ((ci + lr::i8::BK - 1) / lr::i8::BK));
}

// x: [b, h, w, ci] int8; w: [co, 3, 3, ci] int8; scale, bias: [co] fp32; out: [b, h, w, co]
// bf16, or fp32 where out_f32; all contiguous, ci a multiple of 16, co even.  splits > 1
// splits K and needs partial: [splits, b*h*w, co] int32 scratch.
extern "C" int lr_conv3x3_int8(const void* x, const void* w, const void* scale, const void* bias,
                               void* out, void* partial, int b, int h, int wd, int ci, int co,
                               int splits, int out_f32, void* stream) {
  if (ci % 16 || co % 2 || b <= 0 || h <= 0 || wd <= 0 || splits < 1 ||
      (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const lr::ConvArgs a{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), b, h, wd, ci,
                       co, b * h * wd, (ci + lr::i8::BK - 1) / lr::i8::BK};
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  auto* part = static_cast<int*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(out_f32 ? lr::launch(a, sc, bi, static_cast<float*>(out), part, splits, s)
                                  : lr::launch(a, sc, bi, static_cast<lr::bf16*>(out), part, splits, s));
}
