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
// 1 / (1 + expf(-y)) and the rounding is half to even (rintf; K7 and K8 get
// it from the fp32 adder, quant_div), so the plain versions in ops/quant.py
// repeat the same fp32 operations.  K4 and K8 then
// agree with them bit for bit; K7's row sums add in another order than
// PyTorch's reductions.
//
// Bound on the H100: all three read each bf16 element once and write one int8
// (plus a bf16 y where asked), a few fp32 operations per element: device
// memory bounds them on paper, but a pass that rounds with rintf and converts
// with a float-to-int instruction issues those at a quarter of the fp32 rate
// and takes ~3x its bytes' time at the UNet's sizes.  K4 gives each thread 8 channels of a pixel (one 16-byte
// load, one 8-byte store); K7 and K8 give each row (token or pixel, C <= 2048)
// to a group of lanes sized to it, which keeps the row in registers between
// its passes and reduces with shuffles (row_quant below).
#include "common.cuh"

namespace lr {
namespace {

__device__ __forceinline__ signed char quant_step(float v) {
  return static_cast<signed char>(fminf(fmaxf(rintf(v), -127.0f), 127.0f));
}

// K7's and K8's clip(rint(h / sh), -127, 127) as int8, with the division's
// rounding and no conversion instruction (rintf, truncf and the float-to-int
// conversion issue at a quarter of the fp32 rate, which bounded these
// passes): y = h * inv, inv = 1 / sh, is within 2 ulps of h / sh and
// |y| <= 127, so adding 1.5 * 2^23 rounds it to an integer (to nearest, ties
// to even, as rintf) held in the low bits of the sum; the two round alike
// unless y lies within 2^-14 of a half-integer, where the IEEE division
// decides.
__device__ __forceinline__ signed char quant_div(float h, float sh, float inv) {
  const float y = __fmul_rn(h, inv);
  const float big = __fadd_rn(y, 12582912.0f);
  int q = __float_as_int(big) - 0x4B400000;
  if (fabsf(fabsf(__fsub_rn(y, __fsub_rn(big, 12582912.0f))) - 0.5f) <= 6.1035e-5f)
    q = __float2int_rn(__fdiv_rn(h, sh));
  return static_cast<signed char>(min(max(q, -127), 127));
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

// K7 (LN = true) and K8 (LN = false).  A row of c channels (c / 8 16-byte
// chunks) goes to a group of L lanes (8, 16 or 32: the fewest that hold it
// in at most 5 chunks a lane, else 32), N chunks a lane (ceil(c / 8 / L),
// the register arrays sized to it), so a warp takes 32 / L rows at once and
// each lane keeps N independent 16-byte loads in flight (10 chunks a lane,
// tried, ran 1.1-2x slower at 256-4096 rows).  K7's gamma and beta ([c],
// the same for every row) are staged once per block in shared memory, their
// loads issued together behind the first row's, and read there in the row's
// second pass; K8's a and bb ([batch, c]) are read from global memory beside
// the row.  Persistent: the grid is what the card holds at once (at most one
// block per 4 x 32 / L rows), each warp walking row groups; whole warps stay
// in the loop, so the group shuffles (xor offsets below L) always have every
// lane.
constexpr int RQ_THREADS = 128;
// blocks an SM the compiler fits N chunks a lane into: 8 (64 registers a
// thread) up to 5 chunks, so 16384 rows of 320 (1024 blocks) run in one round
template <int N>
constexpr int rq_blocks() { return N <= 5 ? 8 : 4; }

template <int L>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <int L>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// p0/p1: K7's gamma/beta [c], staged into gb (2 c floats of shared memory);
// K8's a/bb [batch, c], the batch of a row being row / hw (gb unused).  xn
// may be null (no bf16 output).
template <bool LN, int L, int N>
__device__ __forceinline__ void row_quant(const bf16* __restrict__ x, const float* __restrict__ p0,
                                          const float* __restrict__ p1, float* gb, bf16* __restrict__ xn,
                                          signed char* __restrict__ xq, float* __restrict__ scale, int rows,
                                          int hw, int c, float eps) {
  constexpr int R = 32 / L;  // rows a warp takes at once
  const int lane = threadIdx.x % L, sub = threadIdx.x % 32 / L;
  const int stride = gridDim.x * (RQ_THREADS / 32) * R;
  const int nch = c / 8;
  int base = (blockIdx.x * (RQ_THREADS / 32) + threadIdx.x / 32) * R;
  float v[N][8];
  auto load_row = [&](int b0) {
    const int row = b0 + sub;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (row < rows && lane + L * j < nch) load8(x + static_cast<size_t>(row) * c + (lane + L * j) * 8, v[j]);
  };
  load_row(base);
  if constexpr (LN) {  // gamma and beta (c <= 2048: 4 float4 a thread at most), behind the first row's loads
    float4 g4[4], b4[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (threadIdx.x + k * RQ_THREADS < c / 4) {
        g4[k] = reinterpret_cast<const float4*>(p0)[threadIdx.x + k * RQ_THREADS];
        b4[k] = reinterpret_cast<const float4*>(p1)[threadIdx.x + k * RQ_THREADS];
      }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (threadIdx.x + k * RQ_THREADS < c / 4) {
        reinterpret_cast<float4*>(gb)[threadIdx.x + k * RQ_THREADS] = g4[k];
        reinterpret_cast<float4*>(gb + c)[threadIdx.x + k * RQ_THREADS] = b4[k];
      }
    __syncthreads();
    p0 = gb;
    p1 = gb + c;
  }
  for (; base < rows; base += stride) {
    if (base != (blockIdx.x * (RQ_THREADS / 32) + threadIdx.x / 32) * R) load_row(base);
    const int row = base + sub;
    const bool in = row < rows;
    const size_t off = static_cast<size_t>(in ? row : 0) * c;
    const size_t ab = LN ? 0 : static_cast<size_t>(in ? row / hw : 0) * c;
    float m = 0.0f, rstd = 0.0f;
    if (LN) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (in && lane + L * j < nch)
#pragma unroll
          for (int k = 0; k < 8; ++k) s = __fadd_rn(s, v[j][k]);
      m = __fdiv_rn(group_sum<L>(s), static_cast<float>(c));
      float s2 = 0.0f;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (in && lane + L * j < nch)
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            const float d = __fsub_rn(v[j][k], m);
            s2 = __fadd_rn(s2, __fmul_rn(d, d));
          }
      rstd = rsqrtf(__fadd_rn(__fdiv_rn(group_sum<L>(s2), static_cast<float>(c)), eps));
    }
    float amax = 0.0f;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (in && lane + L * j < nch) {
        float g[8], bt[8];
        load8f(p0 + ab + (lane + L * j) * 8, g);
        load8f(p1 + ab + (lane + L * j) * 8, bt);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float y = LN ? __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][k], m), rstd), g[k]), bt[k])
                             : __fadd_rn(__fmul_rn(v[j][k], g[k]), bt[k]);
          v[j][k] = y;
          amax = fmaxf(amax, fabsf(y));
        }
      }
    const float sc = __fdiv_rn(fmaxf(group_max<L>(amax), 1e-8f), 127.0f), inv = __fdiv_rn(1.0f, sc);
    if (!in) continue;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int ch = lane + L * j;
      if (ch < nch) {
        signed char q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = quant_div(v[j][k], sc, inv);
        store8_int8(xq + off + ch * 8, q);
        if (xn != nullptr) store8_bf16(xn + off + ch * 8, v[j]);
      }
    }
    if (lane == 0) scale[row] = sc;
  }
}

template <int L, int N>
__global__ void __launch_bounds__(RQ_THREADS, rq_blocks<N>())
    ln_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                    bf16* __restrict__ xn, signed char* __restrict__ xq, float* __restrict__ scale, int rows, int c,
                    float eps) {
  extern __shared__ float gb[];  // gamma, then beta
  row_quant<true, L, N>(x, gamma, beta, gb, xn, xq, scale, rows, 1, c, eps);
}

template <int L, int N>
__global__ void __launch_bounds__(RQ_THREADS, rq_blocks<N>())
    gn_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ a, const float* __restrict__ bb,
                    bf16* __restrict__ xn, signed char* __restrict__ xq, float* __restrict__ scale, int rows, int hw,
                    int c) {
  row_quant<false, L, N>(x, a, bb, nullptr, xn, xq, scale, rows, hw, c, 0.0f);
}

// A persistent launch over `rows` rows in groups of L lanes: as many blocks
// as the card holds at once (asked once per kernel and device), at most one
// a 4 x 32 / L rows.
template <bool LN, int L, int N>
cudaError_t launch_rows(const bf16* x, const float* p0, const float* p1, bf16* xn, signed char* xq, float* scale,
                        int rows, int hw, int c, float eps, cudaStream_t stream) {
  static int fit[8] = {}, sms[8] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (fit[dev % 8] == 0) {
    e = cudaDeviceGetAttribute(&sms[dev % 8], cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) {
      if constexpr (LN)  // the largest gamma and beta, c = 2048
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev % 8], ln_quant_kernel<L, N>, RQ_THREADS,
                                                          2 * 2048 * sizeof(float));
      else
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit[dev % 8], gn_quant_kernel<L, N>, RQ_THREADS, 0);
    }
    if (e != cudaSuccess) return e;
  }
  const long long want = (rows + RQ_THREADS / L - 1) / (RQ_THREADS / L);
  const long long most = static_cast<long long>(fit[dev % 8]) * sms[dev % 8];
  const int blocks = static_cast<int>(want < most ? want : most);
  if constexpr (LN)
    ln_quant_kernel<L, N><<<blocks, RQ_THREADS, 2 * c * sizeof(float), stream>>>(x, p0, p1, xn, xq, scale, rows, c,
                                                                                 eps);
  else
    gn_quant_kernel<L, N><<<blocks, RQ_THREADS, 0, stream>>>(x, p0, p1, xn, xq, scale, rows, hw, c);
  return cudaGetLastError();
}

// The lanes a row (see above) and the chunks a lane, then the launch.
template <bool LN>
cudaError_t row_quant_launch(const bf16* x, const float* p0, const float* p1, bf16* xn, signed char* xq,
                             float* scale, int rows, int hw, int c, float eps, cudaStream_t s) {
  const int nch = c / 8;
  const int lanes = nch <= 8 * 5 ? 8 : nch <= 16 * 5 ? 16 : 32;
  const int n = (nch + lanes - 1) / lanes;
#define LR_ROWS(L, N) \
  case N: return launch_rows<LN, L, N>(x, p0, p1, xn, xq, scale, rows, hw, c, eps, s)
  if (lanes == 8) {
    switch (n) { LR_ROWS(8, 1); LR_ROWS(8, 2); LR_ROWS(8, 3); LR_ROWS(8, 4); LR_ROWS(8, 5); }
  } else if (lanes == 16) {
    switch (n) { LR_ROWS(16, 3); LR_ROWS(16, 4); LR_ROWS(16, 5); }
  } else {
    switch (n) { LR_ROWS(32, 3); LR_ROWS(32, 4); LR_ROWS(32, 5); LR_ROWS(32, 6); LR_ROWS(32, 7); LR_ROWS(32, 8); }
  }
#undef LR_ROWS
  return cudaErrorInvalidValue;
}

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
  if (rows <= 0 || c <= 0 || c % 8 || c > 2048) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lr::row_quant_launch<true>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<lr::bf16*>(xn), static_cast<signed char*>(xq), static_cast<float*>(scale), rows, 1, c, eps,
      static_cast<cudaStream_t>(stream)));
}

// x: [batch, hw, c] bf16, a/bb: [batch, c] fp32; xn: [batch, hw, c] bf16 or
// null, xq: [batch, hw, c] int8, scale: [batch, hw] fp32.  c % 8 == 0, c <= 2048.
extern "C" int lr_gn_quant(const void* x, const void* a, const void* bb, void* xn, void* xq,
                           void* scale, int batch, int hw, int c, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % 8 || c > 2048 ||
      static_cast<long long>(batch) * hw > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lr::row_quant_launch<false>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<lr::bf16*>(xn), static_cast<signed char*>(xq), static_cast<float*>(scale), batch * hw, hw, c,
      0.0f, static_cast<cudaStream_t>(stream)));
}
