// K4, K7, K8: the fused int8 prologues of the int8 UNet (the JAX package's
// default int8 configuration), bf16 in, int8 out.
//
// K4 replaces leftrefill_tpu/ops/quant.py:_affine_silu_quant_kernel
// (affine_silu_quant): q = clip(rint(silu(x * a + bb) * inv_scale), -127, 127)
// with the per-(batch, channel) GroupNorm affine (a, bb) and the per-tensor
// 1 / scale computed outside, in plain PyTorch, as JAX computes them in XLA.
// K7 replaces _ln_quant_kernel (ln_quant_rowwise): an fp32 LayerNorm of each
// row (mean, then the two-pass variance), y = (x - m) * rsqrt(v + eps) * g + b,
// then the row's int8 quantization: scale = max(max|y|, 1e-8) / 127,
// q = clip(rint(y / scale)), and optionally y in bf16.
// K8 replaces _gn_affine_quant_kernel (gn_quant_rowwise): y = x * a + bb with
// the GroupNorm folded into (a, bb) outside, then the same per-pixel
// quantization as K7.
//
// Every multiply, add and divide is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn: no contraction into an FMA) in JAX's order, sigmoid is spelled
// 1 / (1 + expf(-y)) and the rounding is rintf (half to even), so the plain
// versions in ops/quant.py repeat the same fp32 operations.  K4 and K8 then
// agree with them bit for bit; K7's row sums add in another order than
// PyTorch's reductions.
//
// Bound on the H100: all three read each bf16 element once and write one int8
// (plus a bf16 y where asked), a few fp32 operations per element: device
// memory bounds them.  K4 gives each thread 8 channels of a pixel (one 16-byte
// load, one 8-byte store); K7 and K8 give each row (token or pixel, C <= 2048)
// to one warp, which keeps the row in registers between its passes and
// reduces with shuffles.
#include "common.cuh"

namespace lr {
namespace {

constexpr int ROW_CHUNKS = 8;  // 8-channel chunks per lane: rows up to 32 * 8 * 8 = 2048

__device__ __forceinline__ signed char quant_step(float v) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

__device__ __forceinline__ void load8(const bf16* p, float* f) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8f(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

__device__ __forceinline__ void store8_int8(signed char* p, const signed char* q) {
  uint2 u;
  signed char* c = reinterpret_cast<signed char*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = q[i];
  *reinterpret_cast<uint2*>(p) = u;
}

__device__ __forceinline__ void store8_bf16(bf16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// K4: one thread per 8 channels of a pixel, a grid-stride loop over all chunks
__global__ void __launch_bounds__(256)
    affine_silu_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                             const float* __restrict__ bb, const float* __restrict__ inv_scale,
                             signed char* __restrict__ out, long long hw, int c, long long chunks) {
  const float inv = *inv_scale;
  const int per_pixel = c / 8;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < chunks;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long pixel = i / per_pixel;
    const int c0 = static_cast<int>(i - pixel * per_pixel) * 8;
    const size_t ab = static_cast<size_t>(pixel / hw) * c + c0;
    float v[8], av[8], bv[8];
    load8(x + i * 8, v);
    load8f(a + ab, av);
    load8f(bb + ab, bv);
    signed char q[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float y = __fadd_rn(__fmul_rn(v[k], av[k]), bv[k]);
      const float sig = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-y)));
      q[k] = quant_step(__fmul_rn(__fmul_rn(y, sig), inv));
    }
    store8_int8(out + i * 8, q);
  }
}

// K7 (LN = true) and K8 (LN = false): one warp per row of c channels.  K7's
// p0/p1 are gamma/beta [c]; K8's are a/bb [batch, c], the batch of a row being
// row / hw.  xn may be null (no bf16 output).
template <bool LN>
__global__ void __launch_bounds__(128)
    row_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ p0,
                     const float* __restrict__ p1, bf16* __restrict__ xn,
                     signed char* __restrict__ xq, float* __restrict__ scale, int rows,
                     int hw, int c, float eps) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // the whole warp leaves together
  const int nch = c / 8;
  const size_t base = static_cast<size_t>(row) * c;
  const float* g = LN ? p0 : p0 + static_cast<size_t>(row / hw) * c;
  const float* b = LN ? p1 : p1 + static_cast<size_t>(row / hw) * c;

  float v[ROW_CHUNKS][8];
#pragma unroll
  for (int j = 0; j < ROW_CHUNKS; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) load8(x + base + ch * 8, v[j]);
  }
  float m = 0.0f, rstd = 0.0f;
  if (LN) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < ROW_CHUNKS; ++j)
      if (lane + 32 * j < nch)
#pragma unroll
        for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[j][k]);
    m = __fdiv_rn(warp_sum(s), static_cast<float>(c));
    float s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < ROW_CHUNKS; ++j)
      if (lane + 32 * j < nch)
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float d = __fsub_rn(v[j][k], m);
          s2 = __fadd_rn(s2, __fmul_rn(d, d));
        }
    rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(s2), static_cast<float>(c)), eps));
  }
  float amax = 0.0f;
#pragma unroll
  for (int j = 0; j < ROW_CHUNKS; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) {
      float gv[8], bv[8];
      load8f(g + ch * 8, gv);
      load8f(b + ch * 8, bv);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float y = LN ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][k], m), rstd), gv[k]), bv[k])
                           : __fadd_rn(__fmul_rn(v[j][k], gv[k]), bv[k]);
        v[j][k] = y;
        amax = fmaxf(amax, fabsf(y));
      }
    }
  }
  const float sc = __fdiv_rn(fmaxf(warp_max(amax), 1e-8f), 127.0f);
#pragma unroll
  for (int j = 0; j < ROW_CHUNKS; ++j) {
    const int ch = lane + 32 * j;
    if (ch < nch) {
      signed char q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = quant_step(__fdiv_rn(v[j][k], sc));
      store8_int8(xq + base + ch * 8, q);
      if (xn != nullptr) store8_bf16(xn + base + ch * 8, v[j]);
    }
  }
  if (lane == 0) scale[row] = sc;
}

int row_blocks(int rows) { return (rows + 3) / 4; }  // 4 warps (rows) per block

}  // namespace
}  // namespace lr

// x: [batch, hw, c] bf16, a/bb: [batch, c] fp32, inv_scale: one fp32 on the
// device, out: [batch, hw, c] int8.  c % 8 == 0.
extern "C" int lr_affine_silu_quant(const void* x, const void* a, const void* bb, const void* inv_scale,
                                    void* out, int batch, int hw, int c, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % 8) return static_cast<int>(cudaErrorInvalidValue);
  const long long chunks = static_cast<long long>(batch) * hw * (c / 8);
  const long long want = (chunks + 255) / 256;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  lr::affine_silu_quant_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<const float*>(inv_scale), static_cast<signed char*>(out), hw, c, chunks);
  return static_cast<int>(cudaGetLastError());
}

// x: [rows, c] bf16, gamma/beta: [c] fp32; xn: [rows, c] bf16 or null, xq:
// [rows, c] int8, scale: [rows] fp32.  c % 8 == 0, c <= 2048.
extern "C" int lr_ln_quant(const void* x, const void* gamma, const void* beta, void* xn, void* xq,
                           void* scale, int rows, int c, float eps, void* stream) {
  if (rows <= 0 || c <= 0 || c % 8 || c > 32 * 8 * lr::ROW_CHUNKS)
    return static_cast<int>(cudaErrorInvalidValue);
  lr::row_quant_kernel<true><<<lr::row_blocks(rows), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<lr::bf16*>(xn), static_cast<signed char*>(xq), static_cast<float*>(scale), rows, 1, c, eps);
  return static_cast<int>(cudaGetLastError());
}

// x: [batch, hw, c] bf16, a/bb: [batch, c] fp32; xn: [batch, hw, c] bf16 or
// null, xq: [batch, hw, c] int8, scale: [batch, hw] fp32.  c % 8 == 0, c <= 2048.
extern "C" int lr_gn_quant(const void* x, const void* a, const void* bb, void* xn, void* xq,
                           void* scale, int batch, int hw, int c, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % 8 || c > 32 * 8 * lr::ROW_CHUNKS ||
      static_cast<long long>(batch) * hw > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = batch * hw;
  lr::row_quant_kernel<false><<<lr::row_blocks(rows), 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<lr::bf16*>(xn), static_cast<signed char*>(xq), static_cast<float*>(scale), rows, hw, c, 0.0f);
  return static_cast<int>(cudaGetLastError());
}
