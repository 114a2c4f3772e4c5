// K2: 3x3, stride 1, pad 1 convolution, NHWC bf16 x OHWI bf16 -> NHWC bf16.
//
// Replaces leftrefill_tpu/ops/conv.py:_conv_kernel (sum9 taps, launched by
// _conv3x3_pallas).  out[p, co] = bias[co] + sum_{tap, ci} x[p + tap, ci] * w[co, tap, ci],
// accumulated in fp32, bias added in fp32, one cast to bf16 at the end.
//
// Design: an implicit GEMM with M = B*H*W output pixels, N = Co, K = 9*Ci.
// A block owns a 128-pixel x 64-channel output tile and walks K as
// (tap, 32-channel slice) steps.  The A tile is gathered straight from the
// NHWC input at the tap's shifted position; the async copy zero-fills
// out-of-image pixels, so the 1-pixel border is never materialized and any
// Ci that is a multiple of 8 (960, 1920 included) needs no padding.  The
// weight is read as [Co][3][3][Ci] (a torch OIHW weight held in channels-last
// memory), so each output channel's K column is contiguous.  Two
// shared-memory stages let the next step's copies overlap this step's
// tensor-core work.  Bound on the H100: the UNet shapes have K = 2880..23040,
// well above the ~295 flop/byte ridge, so the tensor cores bound it; this
// simple version (WMMA, 4 warps, 2 stages) reaches only a fraction of that.
#include "common.cuh"

namespace lr {
namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BKC = 32;  // input channels per K step
constexpr int NTHREADS = 128;
constexpr int LDA = BKC + 8;  // bf16
constexpr int LDB = BKC + 8;  // bf16, B tile stored [co][ci]
constexpr int LDC = BN + 4;   // fp32
constexpr size_t A_BYTES = size_t(BM) * LDA * 2;
constexpr size_t B_BYTES = size_t(BN) * LDB * 2;
constexpr size_t C_BYTES = size_t(BM) * LDC * 4;
constexpr size_t SMEM_BYTES = 2 * (A_BYTES + B_BYTES) + C_BYTES;

__global__ void __launch_bounds__(NTHREADS)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out, int nb, int h,
                   int wd, int ci, int co) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As[2] = {reinterpret_cast<bf16*>(smem), reinterpret_cast<bf16*>(smem + A_BYTES)};
  bf16* Bs[2] = {reinterpret_cast<bf16*>(smem + 2 * A_BYTES),
                 reinterpret_cast<bf16*>(smem + 2 * A_BYTES + B_BYTES)};
  float* Cs = reinterpret_cast<float*>(smem + 2 * (A_BYTES + B_BYTES));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // 64-row half of the tile
  const int wn = warp & 1;   // 32-column half of the tile
  const int m_total = nb * h * wd;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;

  // each thread gathers four A rows (pixels) at one 8-channel column chunk
  const int a_cc = (tid & 3) * 8;
  int a_b[4], a_y[4], a_x[4];
  bool a_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + (tid >> 2) + 32 * i;
    a_ok[i] = m < m_total;
    const int mm = a_ok[i] ? m : 0;
    a_b[i] = mm / (h * wd);
    const int rem = mm - a_b[i] * h * wd;
    a_y[i] = rem / wd;
    a_x[i] = rem - a_y[i] * wd;
  }

  const int nci = (ci + BKC - 1) / BKC;
  const int nsteps = 9 * nci;

  auto issue = [&](int step, int stage) {
    const int tap = step / nci;
    const int c0 = (step - tap * nci) * BKC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    bf16* A = As[stage];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int yy = a_y[i] + dy, xx = a_x[i] + dx;
      const bool ok = a_ok[i] && yy >= 0 && yy < h && xx >= 0 && xx < wd && c0 + a_cc < ci;
      const bf16* src = ok ? x + ((size_t(a_b[i]) * h + yy) * wd + xx) * ci + c0 + a_cc : x;
      cp_async16(A + ((tid >> 2) + 32 * i) * LDA + a_cc, src, ok);
    }
    bf16* B = Bs[stage];
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 64 output channels x 32 input channels
      const int c = tid + NTHREADS * i;
      const int n = c >> 2, cc = (c & 3) * 8;
      const bool ok = n0 + n < co && c0 + cc < ci;
      const bf16* src = ok ? w + (size_t(n0 + n) * 9 + tap) * ci + c0 + cc : w;
      cp_async16(B + n * LDB + cc, src, ok);
    }
  };

  FragC acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  issue(0, 0);
  cp_async_commit();
  for (int s = 0; s < nsteps; ++s) {
    if (s + 1 < nsteps) issue(s + 1, (s + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* A = As[s & 1];
    const bf16* B = Bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < BKC / 16; ++kk) {
      FragA af[4];
      FragBCol bfr[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], A + (wm * 64 + i * 16) * LDA + kk * 16, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], B + (wn * 32 + j * 16) * LDB + kk * 16, LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();  // this stage is refilled two steps later
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
    const int r = idx / BN, c = idx - r * BN;
    const int m = m0 + r, n = n0 + c;
    if (m < m_total && n < co)
      out[size_t(m) * co + n] = __float2bfloat16(Cs[r * LDC + c] + bias[n]);
  }
}

}  // namespace
}  // namespace lr

// x: [b, h, w, ci] bf16, w: [co, 3, 3, ci] bf16, bias: [co] fp32, out: [b, h, w, co] bf16,
// all contiguous; ci and co multiples of 8.
extern "C" int lr_conv3x3(const void* x, const void* w, const void* bias, void* out, int b,
                          int h, int wd, int ci, int co, void* stream) {
  if (ci % 8 || co % 8 || b <= 0 || h <= 0 || wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = lr::allow_smem(lr::conv3x3_kernel, lr::SMEM_BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long m = static_cast<long long>(b) * h * wd;
  dim3 grid(static_cast<unsigned>((m + lr::BM - 1) / lr::BM), (co + lr::BN - 1) / lr::BN);
  lr::conv3x3_kernel<<<grid, lr::NTHREADS, lr::SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const lr::bf16*>(x), static_cast<const lr::bf16*>(w),
      static_cast<const float*>(bias), static_cast<lr::bf16*>(out), b, h, wd, ci, co);
  return static_cast<int>(cudaGetLastError());
}
