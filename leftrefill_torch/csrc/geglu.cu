// K3: fused GEGLU feed-forward, bf16 in/out, fp32 accumulation.
//
// Replaces leftrefill_tpu/ops/mlp.py:_geglu_kernel (launched by _geglu_pallas).
// With the weights in torch's Linear layout (W1 [2I, din], W2 [dout, I]), for
// each inner chunk c:  v = x.W1[c, :]^T + b1[c],  g = x.W1[I + c, :]^T + b1[I + c],
// h = v * gelu(g) in fp32 (exact erf via erff, not the TPU kernel's A&S
// polynomial), acc += bf16(h).W2[:, c]^T;  out = bf16(acc + b2).
//
// Design: one block owns 32 rows and keeps their [32, dout] fp32 accumulator
// in shared memory (160 KB at dout = 1280).  It walks its share of the inner
// dimension in chunks of 64: the v and g tiles come from two tensor-core
// products over staged x and W1 tiles, h is formed in shared memory, and the
// second product adds h.W2[chunk] into the accumulator.  h never reaches
// device memory.  Where the rows alone give too few blocks to fill the SMs
// (R = 256, 1024 and 4096 at the lower-resolution levels), the inner dimension is
// split over gridDim.y blocks: each writes its fp32 partial sum, and a second
// kernel adds the partials in a fixed order (deterministic), adds b2 and casts.
// Bound on the H100: compute (2*R*din*2I + 2*R*I*dout flops against reading
// W1 and W2 once per 32 rows from L2).
#include "common.cuh"

namespace lr {
namespace {

constexpr int RB = 32;  // rows per block
constexpr int KC = 64;  // din slice per GEMM-1 step
constexpr int IC = 64;  // inner chunk
constexpr int NC = 64;  // dout slice per GEMM-2 step
constexpr int NTHREADS = 256;
constexpr int LDX = KC + 8;  // bf16
constexpr int LDW = 64 + 8;  // bf16 (W1 and W2 tiles)
constexpr int LDVG = IC + 4; // fp32
constexpr int LDH = IC + 8;  // bf16
constexpr size_t X_BYTES = size_t(RB) * LDX * 2;
constexpr size_t W1_BYTES = 2 * size_t(IC) * LDW * 2;
constexpr size_t VG_BYTES = 2 * size_t(RB) * LDVG * 4;
constexpr size_t H_BYTES = size_t(RB) * LDH * 2;
constexpr size_t W2_BYTES = size_t(NC) * LDW * 2;

__host__ __device__ constexpr size_t acc_bytes(int dout) { return size_t(RB) * (dout + 4) * 4; }
__host__ __device__ constexpr size_t smem_bytes(int dout) {
  return acc_bytes(dout) + X_BYTES + W1_BYTES + VG_BYTES + H_BYTES + W2_BYTES;
}

__global__ void __launch_bounds__(NTHREADS)
    geglu_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                 const float* __restrict__ b1, const bf16* __restrict__ w2,
                 const float* __restrict__ b2, bf16* __restrict__ out,
                 float* __restrict__ partial, int r_total, int din, int inner, int dout,
                 int inner_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldacc = dout + 4;
  float* acc = reinterpret_cast<float*>(smem);
  unsigned char* p = smem + acc_bytes(dout);
  bf16* Xs = reinterpret_cast<bf16*>(p);
  bf16* W1s = reinterpret_cast<bf16*>(p + X_BYTES);  // [2][IC][LDW]: value, gate rows
  float* VG = reinterpret_cast<float*>(p + X_BYTES + W1_BYTES);  // [2][RB][LDVG]
  bf16* Hs = reinterpret_cast<bf16*>(p + X_BYTES + W1_BYTES + VG_BYTES);
  bf16* W2s = reinterpret_cast<bf16*>(p + X_BYTES + W1_BYTES + VG_BYTES + H_BYTES);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int r0 = blockIdx.x * RB;
  const bf16* xg = x + size_t(r0) * din;

  for (int i = tid; i < RB * ldacc; i += NTHREADS) acc[i] = 0.0f;

  // GEMM-1 ownership: warp -> (value|gate, 16-row tile, two 16-col tiles)
  const int half = warp >> 2;
  const int g_rt = (warp >> 1) & 1;
  const int g_ct = (warp & 1) * 2;
  // GEMM-2 ownership: warp -> (16-row tile, one 16-col tile of the slice)
  const int a_rt = warp >> 2;
  const int a_ct = warp & 3;

  const int c_begin = blockIdx.y * inner_split;
  for (int c0 = c_begin; c0 < c_begin + inner_split; c0 += IC) {
    FragC vg[2];
    wmma::fill_fragment(vg[0], 0.0f);
    wmma::fill_fragment(vg[1], 0.0f);
    for (int k0 = 0; k0 < din; k0 += KC) {
      __syncthreads();
      {  // x tile: 32 x 64 = 256 chunks, one per thread
        const int r = tid >> 3, cc = (tid & 7) * 8;
        cp_async16(Xs + r * LDX + cc, xg + size_t(r) * din + k0 + cc, true);
      }
      for (int c = tid; c < 2 * IC * 8; c += NTHREADS) {  // value and gate W1 rows
        const int hf = c / (IC * 8);
        const int rem = c - hf * IC * 8;
        const int n = rem >> 3, cc = (rem & 7) * 8;
        const bf16* src = w1 + size_t(hf * inner + c0 + n) * din + k0 + cc;
        cp_async16(W1s + (hf * IC + n) * LDW + cc, src, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        FragA af;
        wmma::load_matrix_sync(af, Xs + g_rt * 16 * LDX + kk * 16, LDX);
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          FragBCol bfr;
          wmma::load_matrix_sync(bfr, W1s + (half * IC + (g_ct + t) * 16) * LDW + kk * 16, LDW);
          wmma::mma_sync(vg[t], af, bfr, vg[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
      wmma::store_matrix_sync(VG + (half * RB + g_rt * 16) * LDVG + (g_ct + t) * 16, vg[t], LDVG,
                              wmma::mem_row_major);
    __syncthreads();

    for (int i = tid; i < RB * IC; i += NTHREADS) {
      const int r = i / IC, j = i - r * IC;
      const float v = VG[r * LDVG + j] + b1[c0 + j];
      const float g = VG[(RB + r) * LDVG + j] + b1[inner + c0 + j];
      const float gelu = 0.5f * g * (1.0f + erff(g * 0.70710678118654752f));
      Hs[r * LDH + j] = __float2bfloat16(v * gelu);
    }

    for (int n0 = 0; n0 < dout; n0 += NC) {
      __syncthreads();  // Hs complete / previous W2 slice consumed
      for (int c = tid; c < NC * 8; c += NTHREADS) {  // W2 rows n0.., columns c0..
        const int n = c >> 3, cc = (c & 7) * 8;
        cp_async16(W2s + n * LDW + cc, w2 + size_t(n0 + n) * inner + c0 + cc, true);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      FragC af;
      float* accp = acc + a_rt * 16 * ldacc + n0 + a_ct * 16;
      wmma::load_matrix_sync(af, accp, ldacc, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < IC / 16; ++kk) {
        FragA hf;
        FragBCol wf;
        wmma::load_matrix_sync(hf, Hs + a_rt * 16 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(wf, W2s + a_ct * 16 * LDW + kk * 16, LDW);
        wmma::mma_sync(af, hf, wf, af);
      }
      wmma::store_matrix_sync(accp, af, ldacc, wmma::mem_row_major);
    }
  }

  __syncthreads();
  if (partial != nullptr) {  // split inner dimension: fp32 partial, no bias
    float* pg = partial + (size_t(blockIdx.y) * r_total + r0) * dout;
    for (int i = tid; i < RB * dout; i += NTHREADS) {
      const int r = i / dout, n = i - r * dout;
      pg[size_t(r) * dout + n] = acc[r * ldacc + n];
    }
    return;
  }
  bf16* og = out + size_t(r0) * dout;
  for (int i = tid; i < RB * dout; i += NTHREADS) {
    const int r = i / dout, n = i - r * dout;
    og[size_t(r) * dout + n] = __float2bfloat16(acc[r * ldacc + n] + b2[n]);
  }
}

// out = bf16(sum_s partial[s] + b2), the partials added in split order.
__global__ void geglu_reduce_kernel(const float* __restrict__ partial, const float* __restrict__ b2,
                                    bf16* __restrict__ out, int splits, size_t n_out, int dout) {
  for (size_t i = blockIdx.x * size_t(blockDim.x) + threadIdx.x; i < n_out;
       i += size_t(gridDim.x) * blockDim.x) {
    float a = 0.0f;
    for (int s = 0; s < splits; ++s) a += partial[s * n_out + i];
    out[i] = __float2bfloat16(a + b2[i % dout]);
  }
}

}  // namespace
}  // namespace lr

// x: [r, din] bf16; w1: [2*inner, din] bf16, rows packed [value | gate]; b1: [2*inner]
// fp32; w2: [dout, inner] bf16; b2: [dout] fp32; out: [r, dout] bf16.  All contiguous;
// r % 32 == 0, din, inner and dout multiples of 64, shared memory for dout must fit.
// splits > 1 divides the inner dimension (inner / splits a multiple of 64) and
// needs partial: [splits, r, dout] fp32 scratch.
extern "C" int lr_geglu(const void* x, const void* w1, const void* b1, const void* w2,
                        const void* b2, void* out, void* partial, int r, int din, int inner,
                        int dout, int splits, void* stream) {
  if (r % lr::RB || din % lr::KC || inner % lr::IC || dout % lr::NC || r <= 0 || splits < 1 ||
      inner % splits || (inner / splits) % lr::IC || (splits > 1 && partial == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = lr::smem_bytes(dout);
  cudaError_t e = lr::allow_smem(lr::geglu_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = splits > 1 ? static_cast<float*>(partial) : nullptr;
  dim3 grid(r / lr::RB, splits);
  lr::geglu_kernel<<<grid, lr::NTHREADS, smem, s>>>(
      static_cast<const lr::bf16*>(x), static_cast<const lr::bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const lr::bf16*>(w2),
      static_cast<const float*>(b2), static_cast<lr::bf16*>(out), part, r, din, inner, dout,
      inner / splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return static_cast<int>(e);
  const size_t n_out = size_t(r) * dout;
  lr::geglu_reduce_kernel<<<1024, 256, 0, s>>>(part, static_cast<const float*>(b2),
                                                static_cast<lr::bf16*>(out), splits, n_out, dout);
  return static_cast<int>(cudaGetLastError());
}
