// KI3: W8A8 GEGLU feed-forward, int8 x / W1 / W2, bf16 out.
//
// Replaces leftrefill_tpu/ops/mlp.py:_geglu_int8_kernel (K10, its default
// int8 second product).  With the weights in torch's Linear layout (W1 [2I, din]
// rows packed [value | gate], W2 [dout, I]), for each inner chunk c of width cw:
//   v = float(xq . W1[c]^T) * (sx * s1[c]) + b1[c]
//   g = float(xq . W1[I + c]^T) * (sx * s1[I + c]) + b1[I + c]
//   h = v * ((g * 0.5) * (1 + erf(g * 0.70710678)))
//                                        (exact erf through CUDA's erff; the
//                                         TPU kernel used the A&S 7.1.26 polynomial)
//   sh = max(max_j |h[r, j]|, 1e-8) / 127 per row over the chunk
//   p_c = float(round(h / sh) . W2[:, c]^T) * (sh * s2)
// and out = bf16(((0 + p_0) + p_1) + ... + b2), the chunks added in order.
// The chunk width is part of the function (the requant scale spans one
// chunk); the caller passes the TPU plan's.
//
// Design: one block per (32 rows, chunk).  It loads its x rows once, forms h
// for the chunk 128 inner columns at a time (the value and gate products on
// the int8 tensor cores, warp w owning inner columns 16w..16w+15 of both so
// each thread holds v and g of the same elements), keeps the chunk's fp32 h
// in shared memory while the row maxima are reduced (quad shuffles, then a
// shared-memory atomicMax on the non-negative bits), requantizes it to int8
// in shared memory, and runs the second product against W2's chunk columns.
// h never reaches device memory.  The fp32 chunk contributions p_c go to a
// [chunks, R, dout] scratch and a second kernel adds them in chunk order, so
// the sum is the TPU kernel's, and the grid has R/32 x chunks blocks, enough
// to fill the SMs at every UNet shape (R = 256 gives 8 x 8).
#include "int8_gemm.cuh"

namespace lr {
namespace {

using namespace i8;

constexpr int RB = 32;    // rows per block
constexpr int SUB = 128;  // inner columns per GEMM-1 pass
constexpr int NS = 128;   // output columns per GEMM-2 pass
constexpr size_t W_STAGE = size_t(2 * SUB) * LDS;  // 256 W1 rows (value | gate); W2 uses 128

__host__ __device__ constexpr int ldx(int din) { return din + 16; }
__host__ __device__ constexpr int ldh(int cw) { return cw + 4; }  // fp32 h
__host__ __device__ constexpr int ldq(int cw) { return cw + 16; }  // int8 h
__host__ __device__ constexpr size_t smem_bytes(int din, int cw) {
  return size_t(RB) * ldh(cw) * 4 + 2 * W_STAGE + size_t(RB) * ldx(din) + size_t(RB) * ldq(cw) +
         RB * 8;
}

__global__ void __launch_bounds__(NTHREADS)
    geglu_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                      const int8_t* __restrict__ w1, const float* __restrict__ s1,
                      const float* __restrict__ b1, const int8_t* __restrict__ w2,
                      const float* __restrict__ s2, float* __restrict__ partial, int r_total,
                      int din, int inner, int dout, int cw) {
  extern __shared__ __align__(128) int8_t smem[];
  float* Hf = reinterpret_cast<float*>(smem);                        // [RB][ldh]
  int8_t* Ws = smem + size_t(RB) * ldh(cw) * 4;                      // 2 stages
  int8_t* Xs = Ws + 2 * W_STAGE;                                     // [RB][ldx]
  int8_t* Hq = Xs + size_t(RB) * ldx(din);                           // [RB][ldq]
  unsigned* rowmax = reinterpret_cast<unsigned*>(Hq + size_t(RB) * ldq(cw));
  float* sh = reinterpret_cast<float*>(rowmax + RB);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * RB;
  const int chunk = blockIdx.y, c0 = chunk * cw;
  const int LX = ldx(din), LH = ldh(cw), LQ = ldq(cw);

  if (tid < RB) rowmax[tid] = 0u;
  for (int i = tid; i < RB * din / 16; i += NTHREADS) {  // the block's x rows, once
    const int r = i / (din / 16), c = (i - r * (din / 16)) * 16;
    cp_async16(Xs + r * LX + c, xq + size_t(r0 + r) * din + c, true);
  }
  cp_async_commit();

  // ---- GEMM-1 and h, SUB inner columns at a time ---------------------------
  float lmax[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [m16 tile][row g | g+8]
  const int nk1 = din / BK;
  for (int sc = 0; sc < cw; sc += SUB) {
    const int ib = c0 + sc;  // first inner column of this pass
    auto load_w1 = [&](int ks, int stage) {
      int8_t* W = Ws + stage * W_STAGE;
      for (int i = tid; i < 2 * SUB * 4; i += NTHREADS) {
        const int row = i >> 2, c = (i & 3) * 16;
        const int src_row = row < SUB ? ib + row : inner + ib + row - SUB;
        cp_async16(W + row * LDS + c, w1 + size_t(src_row) * din + ks * BK + c, true);
      }
    };
    int av[2][2][4] = {}, ag[2][2][4] = {};  // [m16][n8][frag], value and gate
    load_w1(0, 0);
    cp_async_commit();
    for (int ks = 0; ks < nk1; ++ks) {
      if (ks + 1 < nk1) load_w1(ks + 1, (ks + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int8_t* W = Ws + (ks & 1) * W_STAGE;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        unsigned af[2][4], bv[2][2], bg[2][2];
#pragma unroll
        for (int m = 0; m < 2; ++m) load_a(af[m], Xs + m * 16 * LX, LX, ks * BK + kk);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          load_b(bv[j], W + (warp * 16 + j * 8) * LDS, LDS, kk);
          load_b(bg[j], W + (SUB + warp * 16 + j * 8) * LDS, LDS, kk);
        }
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma(av[m][j], af[m], bv[j]);
            mma(ag[m][j], af[m], bg[j]);
          }
      }
      __syncthreads();  // this stage is refilled two steps later
    }
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = m * 16 + g + (e >> 1) * 8;
          const int col = warp * 16 + j * 8 + 2 * t + (e & 1);  // within this pass
          const int jv = ib + col, jg = inner + ib + col;
          const float sxr = sx[r0 + row];
          const float v =
              __fadd_rn(__fmul_rn(__int2float_rn(av[m][j][e]), __fmul_rn(sxr, s1[jv])), b1[jv]);
          const float gt =
              __fadd_rn(__fmul_rn(__int2float_rn(ag[m][j][e]), __fmul_rn(sxr, s1[jg])), b1[jg]);
          const float gelu = __fmul_rn(__fmul_rn(gt, 0.5f),
                                       __fadd_rn(1.0f, erff(__fmul_rn(gt, 0.70710678118654752f))));
          const float h = __fmul_rn(v, gelu);
          Hf[row * LH + sc + col] = h;
          lmax[m][e >> 1] = fmaxf(lmax[m][e >> 1], fabsf(h));
        }
  }

  // ---- per-row scale over the chunk, requantization -------------------------
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      float v = lmax[m][hi];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t == 0) atomicMax(rowmax + m * 16 + g + hi * 8, __float_as_uint(v));
    }
  __syncthreads();
  if (tid < RB) sh[tid] = fmaxf(__uint_as_float(rowmax[tid]), 1e-8f) / 127.0f;
  __syncthreads();
  for (int i = tid; i < RB * cw; i += NTHREADS) {
    const int r = i / cw, j = i - r * cw;
    const float q = fminf(fmaxf(rintf(Hf[r * LH + j] / sh[r]), -127.0f), 127.0f);
    Hq[r * LQ + j] = static_cast<int8_t>(q);
  }
  __syncthreads();

  // ---- GEMM-2: p_c = float(hq . W2[:, c]^T) * (sh * s2) ------------------
  const int wm = warp >> 2, wn = warp & 3;  // 16 rows x 32 columns per warp
  const int nk2 = cw / BK;
  float* pc = partial + size_t(chunk) * r_total * dout;
  for (int n0 = 0; n0 < dout; n0 += NS) {
    auto load_w2 = [&](int ks, int stage) {
      int8_t* W = Ws + stage * W_STAGE;
      for (int i = tid; i < NS * 4; i += NTHREADS) {
        const int row = i >> 2, c = (i & 3) * 16;
        const bool ok = n0 + row < dout;
        cp_async16(W + row * LDS + c, ok ? w2 + size_t(n0 + row) * inner + c0 + ks * BK + c : w2,
                   ok);
      }
    };
    int acc[4][4] = {};
    load_w2(0, 0);
    cp_async_commit();
    for (int ks = 0; ks < nk2; ++ks) {
      if (ks + 1 < nk2) load_w2(ks + 1, (ks + 1) & 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      const int8_t* W = Ws + (ks & 1) * W_STAGE + wn * 32 * LDS;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 32) {
        unsigned af[4], bfr[4][2];
        load_a(af, Hq + wm * 16 * LQ, LQ, ks * BK + kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) load_b(bfr[j], W + j * 8 * LDS, LDS, kk);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[j], af, bfr[j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = wm * 16 + g + (e >> 1) * 8;
        const int n = n0 + wn * 32 + j * 8 + 2 * t + (e & 1);
        if (n < dout)
          pc[size_t(r0 + row) * dout + n] =
              __fmul_rn(__int2float_rn(acc[j][e]), __fmul_rn(sh[row], s2[n]));
      }
  }
}

// out = bf16(((0 + p_0) + p_1) + ... + b2): the chunks in order, as the TPU kernel.
__global__ void geglu_int8_finish_kernel(const float* __restrict__ partial, int chunks,
                                         const float* __restrict__ b2, bf16* __restrict__ out,
                                         size_t n_out, int dout) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_out;
       i += size_t(gridDim.x) * blockDim.x) {
    float a = 0.0f;
    for (int c = 0; c < chunks; ++c) a = __fadd_rn(a, partial[c * n_out + i]);
    out[i] = __float2bfloat16_rn(__fadd_rn(a, b2[i % dout]));
  }
}

}  // namespace
}  // namespace lr

// xq: [r, din] int8; sx: [r] fp32; w1: [2*inner, din] int8 rows [value | gate]; s1, b1:
// [2*inner] fp32; w2: [dout, inner] int8; s2, b2: [dout] fp32; out: [r, dout] bf16;
// partial: [inner / cw, r, dout] fp32 scratch.  All contiguous; r % 32 == 0, din % 64 == 0,
// cw % 128 == 0, inner % cw == 0, dout even, shared memory for (din, cw) within the limit.
extern "C" int lr_geglu_int8(const void* xq, const void* sx, const void* w1, const void* s1,
                             const void* b1, const void* w2, const void* s2, const void* b2,
                             void* out, void* partial, int r, int din, int inner, int dout, int cw,
                             void* stream) {
  if (r <= 0 || r % lr::RB || din % lr::i8::BK || cw <= 0 || cw % lr::SUB || inner % cw ||
      dout <= 0 || dout % 2 || partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lr::smem_bytes(din, cw);
  cudaError_t e = lr::allow_smem(lr::geglu_int8_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = inner / cw;
  dim3 grid(r / lr::RB, chunks);
  lr::geglu_int8_kernel<<<grid, lr::i8::NTHREADS, smem, s>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w1), static_cast<const float*>(s1),
      static_cast<const float*>(b1), static_cast<const int8_t*>(w2),
      static_cast<const float*>(s2), static_cast<float*>(partial), r, din, inner, dout, cw);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t n_out = size_t(r) * dout;
  lr::geglu_int8_finish_kernel<<<1024, 256, 0, s>>>(static_cast<const float*>(partial), chunks,
                                                    static_cast<const float*>(b2),
                                                    static_cast<lr::bf16*>(out), n_out, dout);
  return static_cast<int>(cudaGetLastError());
}
