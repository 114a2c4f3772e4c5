// K4, K7, K8: the fused int8 prologues of the int8 UNet (the JAX package's
// default int8 configuration), bf16 in, int8 out.
//
// K4 replaces leftrefill_tpu/ops/quant.py:_affine_silu_quant_kernel
// (affine_silu_quant) together with the per-tensor scale that
// gn_silu_conv3x3_int8 computes in front of it as one fused XLA reduce
// (quant.py:921-926): with y = x * a + bb, the per-(batch, channel)
// GroupNorm affine (a, bb) folded outside, scale = max(max|silu(y)|, 1e-8)
// / 127 and q = clip(rint(silu(y) * (1 / scale)), -127, 127), both in one
// launch (the Pallas kernel takes 1 / scale as an input: it cannot reduce
// across its grid and read the result back in one call).
// K7 replaces _ln_quant_kernel (ln_quant_rowwise): an fp32 LayerNorm of each
// row (mean, then the two-pass variance), y = (x - m) * rsqrt(v + eps) * g + b,
// then the row's int8 quantization: scale = max(max|y|, 1e-8) / 127,
// q = clip(rint(y / scale)), and optionally y in bf16.
// K8 replaces _gn_affine_quant_kernel (gn_quant_rowwise): y = x * a + bb with
// the GroupNorm folded into (a, bb) outside, then the same per-pixel
// quantization as K7.
//
// Every multiply, add and divide is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn, __frcp_rn: no contraction into an FMA) in JAX's order, sigmoid
// is spelled 1 / (1 + expf(-y)) and the rounding is half to even (from the
// fp32 adder: quant_rne, quant_div), so the plain versions in ops/quant.py
// repeat the same fp32 operations.  K4 and K8 then agree with them bit for
// bit, K4's scale included (a maximum is exact in any order); K7's row sums
// add in another order than PyTorch's reductions.
//
// Bound on the H100: all three read each bf16 element once and write one int8
// (plus a bf16 y where asked), a few fp32 operations per element: device
// memory bounds them on paper, as long as no per-element work issues on the
// quarter-rate pipe (rintf, truncf, the float-to-int conversion and an IEEE
// division's slow path do: they bounded the first K7/K8 at ~3x their bytes'
// time).  K4 cannot leave that pipe: silu's exp and reciprocal are one
// MUFU operation each, both needed for the plain version's bits.
// K4 (affine_silu_quant_kernel) is one persistent cooperative launch: pass
// 1 reads x (16 bytes, 8 channels a thread) and reduces max|silu(y)| to one
// slot a block, a grid barrier, every block reduces the slots (from L2) to
// the scale, pass 2 writes int8 in 8-byte stores.  Where a thread's pixels
// number at most 4 (sites up to ~4 M elements), their silu values stay in
// registers between the passes; a larger site streams: pass 2 reads x again
// (from L2) and recomputes silu, and pass 1 computes silu only where an
// element's bound could raise the warp's running maximum.  At the small
// sites the fixed chain (launch, a DRAM read, the barrier, the slots' read)
// sets the pace.  The glue it replaces (the scale in eager PyTorch: ~16
// launches and ~78 bytes an element of fp32 temporaries) cost far more.
// K7 and K8 give each row (token or pixel, C <= 2048) to a group of lanes
// sized to it, which keeps the row in registers between its passes and
// reduces with shuffles (row_quant below).
#include <cooperative_groups.h>

#include "common.cuh"

namespace lr {
namespace {

// clip(rint(v), -127, 127) as int8 for |v| <= 2^22, without rintf or a
// conversion instruction: adding 1.5 * 2^23 rounds v to an integer (to
// nearest, ties to even, as rintf) held in the low bits of the sum.
__device__ __forceinline__ signed char quant_rne(float v) {
  const int q = __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
  return static_cast<signed char>(min(max(q, -127), 127));
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

// 8 bf16 values of a 16-byte chunk as fp32.
__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void load8(const bf16* p, float* f) { unpack8(*reinterpret_cast<const uint4*>(p), f); }

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

// ---- K4 ---------------------------------------------------------------------

constexpr int SQ_THREADS = 256;
constexpr int SQ_MAX_CACHED = 4;  // chunks a thread keeps in registers between the passes, at most
constexpr int SQ_UNROLL = 4;      // chunks a thread loads at once when it streams
// above max |silu(y)| over y < 0 (0.2784645 at y = -1.2785), with the
// computed value's few roundings (relative 5 * 2^-24) included
constexpr float SILU_NEG_MAX = 0.27847f;

// y = x * a + b and silu(y) in K4's fp32 operations (1 / (1 + e) as
// __frcp_rn: the same correctly rounded value as __fdiv_rn(1, 1 + e),
// without the division)
__device__ __forceinline__ float affine(float x, float a, float b) { return __fadd_rn(__fmul_rn(x, a), b); }

__device__ __forceinline__ float silu_of(float y) { return __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-y)))); }

// An upper bound of |silu_of(y)| from y alone: silu_of(y) <= y for y >= 0
// (the reciprocal of 1 + e >= 1 is at most 1, and rounding is monotone);
// for y < 0, |silu_of(y)| <= |y| and <= SILU_NEG_MAX.
__device__ __forceinline__ float silu_bound(float y) { return y >= 0.0f ? y : fminf(-y, SILU_NEG_MAX); }

// The block's maximum of v, in every thread (red: a float a warp).
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  v = red[0];
#pragma unroll
  for (int w = 1; w < SQ_THREADS / 32; ++w) v = fmaxf(v, red[w]);
  __syncthreads();  // red may be written again
  return v;
}

// K4: one persistent cooperative launch (see the top).  The grid's threads
// split evenly over the batch; in its batch, thread t takes chunk g (8
// channels: one 16-byte load) of pixels p0, p0 + ps, p0 + 2 ps, ... (ps the
// pixels of one sweep of the batch's threads; the last threads of a batch
// that make no whole sweep sit out), so its a and bb stay in registers.
// NC > 0: a thread's pixels number at most NC (the grid is sized so) and
// their silu values stay in registers from pass 1 to pass 2.  NC == 0: the
// pixels are streamed in rounds of SQ_UNROLL (their loads in flight
// together), pass 2 reads x again and recomputes silu, and pass 1 computes
// silu only in the rounds where some element's bound passes the warp's
// running maximum (the maximum stays exact: a skipped element cannot raise
// it).  slots: one float a block, each written before the grid barrier and
// read after it.
template <int NC>
__global__ void __launch_bounds__(SQ_THREADS)
    affine_silu_quant_kernel(const bf16* __restrict__ x, const float* __restrict__ a,
                             const float* __restrict__ bb, signed char* __restrict__ xq,
                             float* __restrict__ scale, float* __restrict__ slots, int batch, int hw, int c) {
  __shared__ float red[SQ_THREADS / 32];
  const int per_pixel = c / 8, t = blockIdx.x * SQ_THREADS + threadIdx.x;
  const int ps = gridDim.x * SQ_THREADS / (batch * per_pixel), tb = ps * per_pixel;
  const int b = t / tb, g = t % tb % per_pixel, p0 = t % tb / per_pixel;
  const bool on = b < batch;
  const size_t base = (static_cast<size_t>(on ? b : 0) * hw + p0) * c + 8 * g;  // pixel p0's chunk
  const size_t step = static_cast<size_t>(ps) * c;                              // one pixel stride
  float av[8], bv[8];
  if (on) {
    load8f(a + static_cast<size_t>(b) * c + 8 * g, av);
    load8f(bb + static_cast<size_t>(b) * c + 8 * g, bv);
  }
  float m = 0.0f;
  float sv[NC > 0 ? NC : 1][8];
  if constexpr (NC > 0) {
    uint4 raw[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (on && p0 + j * ps < hw) raw[j] = __ldg(reinterpret_cast<const uint4*>(x + base + j * step));
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (on && p0 + j * ps < hw) {
        float v[8];
        unpack8(raw[j], v);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          sv[j][k] = silu_of(affine(v[k], av[k], bv[k]));
          m = fmaxf(m, fabsf(sv[j][k]));
        }
      }
  } else {
    // warp-uniform rounds, as many as the warp's first pixel needs: every
    // lane takes part in each shuffle, with or without pixels of its own
    const int pmin = __reduce_min_sync(0xffffffffu, on ? p0 : hw);
    const int rounds = (hw - pmin + SQ_UNROLL * ps - 1) / (SQ_UNROLL * ps);
    float mw = 0.0f;  // the warp's largest |silu| so far: a lower bound of the tensor's
    for (int k = 0; k < rounds; ++k) {
      uint4 raw[SQ_UNROLL];
#pragma unroll
      for (int u = 0; u < SQ_UNROLL; ++u)
        if (on && p0 + (k * SQ_UNROLL + u) * ps < hw)
          raw[u] = __ldg(reinterpret_cast<const uint4*>(x + base + (k * SQ_UNROLL + u) * step));
      // silu of each lane's element of the largest bound first, then of the
      // elements whose bound passes the warp's maximum (few: a skipped
      // element's |silu| is at most its bound, so the maximum stays exact)
      float best = -1.0f, ybest = 0.0f;
#pragma unroll
      for (int u = 0; u < SQ_UNROLL; ++u)
        if (on && p0 + (k * SQ_UNROLL + u) * ps < hw) {
          float v[8];
          unpack8(raw[u], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float y = affine(v[e], av[e], bv[e]), bnd = silu_bound(y);
            if (bnd > best) {
              best = bnd;
              ybest = y;
            }
          }
        }
      if (best >= 0.0f) m = fmaxf(m, fabsf(silu_of(ybest)));
      mw = m;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mw = fmaxf(mw, __shfl_xor_sync(0xffffffffu, mw, o));
#pragma unroll
      for (int u = 0; u < SQ_UNROLL; ++u)
        if (on && p0 + (k * SQ_UNROLL + u) * ps < hw) {
          float v[8];
          unpack8(raw[u], v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float y = affine(v[e], av[e], bv[e]);
            if (silu_bound(y) > mw) m = fmaxf(m, fabsf(silu_of(y)));
          }
        }
    }
  }
  m = block_max(m, red);
  if (threadIdx.x == 0) slots[blockIdx.x] = m;
  cooperative_groups::this_grid().sync();
  float amax = 0.0f;
  for (int i = threadIdx.x; i < gridDim.x; i += SQ_THREADS) amax = fmaxf(amax, __ldcg(slots + i));
  amax = block_max(amax, red);
  // JAX's max(amax, 1e-8) / 127 and its reciprocal, IEEE divisions once a block
  const float sc = __fdiv_rn(fmaxf(amax, 1e-8f), 127.0f), inv = __fdiv_rn(1.0f, sc);
  if (blockIdx.x == 0 && threadIdx.x == 0) *scale = sc;
  if constexpr (NC > 0) {
#pragma unroll
    for (int j = 0; j < NC; ++j)
      if (on && p0 + j * ps < hw) {
        signed char q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) q[k] = quant_rne(__fmul_rn(sv[j][k], inv));
        store8_int8(xq + base + j * step, q);
      }
  } else {
    for (int p = p0, k = 0; on && p < hw; p += SQ_UNROLL * ps, ++k) {
      uint4 raw[SQ_UNROLL];
#pragma unroll
      for (int u = 0; u < SQ_UNROLL; ++u)
        if (p + u * ps < hw) raw[u] = __ldg(reinterpret_cast<const uint4*>(x + base + (k * SQ_UNROLL + u) * step));
#pragma unroll
      for (int u = 0; u < SQ_UNROLL; ++u)
        if (p + u * ps < hw) {
          float v[8];
          unpack8(raw[u], v);
          signed char q[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) q[e] = quant_rne(__fmul_rn(silu_of(affine(v[e], av[e], bv[e])), inv));
          store8_int8(xq + base + (k * SQ_UNROLL + u) * step, q);
        }
    }
  }
}

template <int NC>
cudaError_t silu_quant_fit(int dev, int& fit) {
  static int cached[8] = {};
  if (cached[dev % 8] == 0) {
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&cached[dev % 8], affine_silu_quant_kernel<NC>, SQ_THREADS, 0);
    if (e != cudaSuccess) return e;
  }
  fit = cached[dev % 8];
  return cudaSuccess;
}

// The launch: the fewest pixels a thread (1, 2 or 4, kept in registers) that
// the card holds at once (a cooperative launch is refused past it, instead
// of hanging at the grid barrier), within n_slots blocks, or else streamed
// on as many blocks as it holds.
cudaError_t silu_quant_launch(const bf16* x, const float* a, const float* bb, signed char* xq, float* scale,
                              float* slots, int n_slots, int batch, int hw, int c, cudaStream_t stream) {
  static int sms[8] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && sms[dev % 8] == 0) e = cudaDeviceGetAttribute(&sms[dev % 8], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long per_pixel = c / 8;
  void (*kernel)(const bf16*, const float*, const float*, signed char*, float*, float*, int, int, int) = nullptr;
  long long blocks = 0;
  int fit = 0;
  for (int nc = 1; nc <= SQ_MAX_CACHED && kernel == nullptr; nc *= 2) {
    e = nc == 1 ? silu_quant_fit<1>(dev, fit) : nc == 2 ? silu_quant_fit<2>(dev, fit) : silu_quant_fit<4>(dev, fit);
    if (e != cudaSuccess) return e;
    // each batch's pixels within nc a thread: ps = blocks * SQ_THREADS / (batch * per_pixel) >= ceil(hw / nc)
    const long long want = (batch * per_pixel * ((hw + nc - 1) / nc) + SQ_THREADS - 1) / SQ_THREADS;
    if (want <= static_cast<long long>(fit) * sms[dev % 8] && want <= n_slots) {
      blocks = want;
      kernel = nc == 1 ? &affine_silu_quant_kernel<1> : nc == 2 ? &affine_silu_quant_kernel<2>
                       : &affine_silu_quant_kernel<4>;
    }
  }
  if (kernel == nullptr) {
    if ((e = silu_quant_fit<0>(dev, fit)) != cudaSuccess) return e;
    blocks = static_cast<long long>(fit) * sms[dev % 8];
    blocks = blocks < n_slots ? blocks : n_slots;
    kernel = &affine_silu_quant_kernel<0>;
  }
  if (blocks * SQ_THREADS < batch * per_pixel) return cudaErrorInvalidValue;  // a sweep of each batch's chunks
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(SQ_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute coop[1];
  coop[0].id = cudaLaunchAttributeCooperative;
  coop[0].val.cooperative = 1;
  cfg.attrs = coop;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kernel, x, a, bb, xq, scale, slots, batch, hw, c);
  return e == cudaSuccess ? cudaGetLastError() : e;
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

// x: [batch, hw, c] bf16, a/bb: [batch, c] fp32; xq: [batch, hw, c] int8;
// scale: one fp32 on the device; slots: n_slots fp32 of scratch (nothing
// needs zeroing).  All contiguous, x and xq 16-byte aligned, c % 8 == 0,
// batch * hw * c < 2^31.
extern "C" int lr_silu_quant(const void* x, const void* a, const void* bb, void* xq, void* scale, void* slots,
                             int n_slots, int batch, int hw, int c, void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % 8 || n_slots <= 0 ||
      static_cast<long long>(batch) * hw * c > (1LL << 31) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(lr::silu_quant_launch(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(a), static_cast<const float*>(bb),
      static_cast<signed char*>(xq), static_cast<float*>(scale), static_cast<float*>(slots), n_slots, batch, hw,
      c, static_cast<cudaStream_t>(stream)));
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
