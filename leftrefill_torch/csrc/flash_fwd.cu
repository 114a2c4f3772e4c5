// K1: attention forward with the clamp softmax, bf16 in, bf16 o + fp32 lse out.
//
// Replaces leftrefill_tpu/ops/flash_attention.py:_flash_kernel (launched by
// _flash_forward).  Per row: s = scale * q.k, p = exp(min(s, 75)),
// l = max(sum p, FLT_MIN), o = (bf16(p) . v) / l, lse = log l.
//
// Design: one block owns 64 query rows of one (batch, head) and walks K/V in
// tiles of 64 keys, the next tile's async copy overlapping this tile's work.
// Because the clamp makes every partial exp final (no row max, no online
// rescale), l and o simply add up in fp32 across tiles.  Four warps each own
// 16 query rows; Q stays in registers as WMMA fragments, S is staged through
// shared memory so the exp/row-sum pass can address rows.  q, k, v and o are
// read and written in the packed [B, N, H*D] projection layout.
// Bound on the H100: at D = 64 the two products are 4*Nq*Nk*D flops against
// one exp per score, so the exp/convert pass through shared memory, not the
// tensor cores, limits this simple version.
#include "common.cuh"

#include <float.h>

namespace lr {
namespace {

constexpr int BQ = 64;  // query rows per block (4 warps x 16)
constexpr int BK = 64;  // keys per K/V tile
constexpr int NWARPS = 4;
constexpr float CLAMP = 75.0f;

template <int D>
struct FlashSmem {
  static constexpr int LDQ = D + 8;                  // bf16 row stride of Q/K/V tiles
  static constexpr int LDS = (D > BK ? D : BK) + 4;  // fp32 stride of S (and O staging)
  static constexpr int LDP = BK + 8;                 // bf16 stride of P
  static constexpr size_t Q = size_t(BQ) * LDQ * 2;
  static constexpr size_t KV = size_t(BK) * LDQ * 2;
  static constexpr size_t S = size_t(NWARPS) * 16 * LDS * 4;
  static constexpr size_t P = size_t(NWARPS) * 16 * LDP * 2;
  static constexpr size_t bytes = Q + 4 * KV + S + P;  // K and V double-buffered
};

template <int D>
__global__ void __launch_bounds__(NWARPS * 32)
    flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  using L = FlashSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks[2] = {reinterpret_cast<bf16*>(smem + L::Q), reinterpret_cast<bf16*>(smem + L::Q + L::KV)};
  bf16* Vs[2] = {reinterpret_cast<bf16*>(smem + L::Q + 2 * L::KV),
                 reinterpret_cast<bf16*>(smem + L::Q + 3 * L::KV)};
  float* Ss = reinterpret_cast<float*>(smem + L::Q + 4 * L::KV);
  bf16* Ps = reinterpret_cast<bf16*>(smem + L::Q + 4 * L::KV + L::S);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  // packed [B, N, heads*D] rows: token n of head h starts at (b*N + n)*ld + h*D
  const size_t ld = size_t(heads) * D;
  const bf16* qg = q + (size_t(b) * nq + q0) * ld + h * D;
  const bf16* kg = k + size_t(b) * nk * ld + h * D;
  const bf16* vg = v + size_t(b) * nk * ld + h * D;
  constexpr int CPR = D / 8;  // 16-byte chunks per row

  auto load_kv = [&](int tile, int stage) {
    for (int c = tid; c < BK * CPR; c += NWARPS * 32) {
      const int r = c / CPR, cc = (c % CPR) * 8;
      cp_async16(Ks[stage] + r * L::LDQ + cc, kg + (tile * BK + r) * ld + cc, true);
      cp_async16(Vs[stage] + r * L::LDQ + cc, vg + (tile * BK + r) * ld + cc, true);
    }
  };

  for (int c = tid; c < BQ * CPR; c += NWARPS * 32) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    cp_async16(Qs + r * L::LDQ + cc, qg + r * ld + cc, true);
  }
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  FragA qf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
  FragC of[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(of[j], 0.0f);

  float* Sw = Ss + warp * 16 * L::LDS;
  bf16* Pw = Ps + warp * 16 * L::LDP;
  // two lanes per query row, interleaved over the tile's 64 columns
  const int prow = lane & 15;
  const int half = lane >> 4;
  float l = 0.0f;

  const int ntiles = nk / BK;
  for (int t = 0; t < ntiles; ++t) {
    // prefetch the next K/V tile into the other stage while this one computes
    if (t + 1 < ntiles) load_kv(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks[t & 1];
    const bf16* Vt = Vs[t & 1];

    // S = Q K^T for this warp's 16 rows x 64 keys
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) {
      FragC sf;
      wmma::fill_fragment(sf, 0.0f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        FragBCol kf;
        wmma::load_matrix_sync(kf, Kt + n * 16 * L::LDQ + kk * 16, L::LDQ);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(Sw + n * 16, sf, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // p = exp(min(s, 75)); the row sum takes p in fp32, the PV product bf16(p)
    float part = 0.0f;
#pragma unroll 8
    for (int j = 0; j < BK / 2; ++j) {
      const int col = half + 2 * j;
      const float p = __expf(fminf(Sw[prow * L::LDS + col] * scale, CLAMP));
      part += p;
      Pw[prow * L::LDP + col] = __float2bfloat16(p);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 16);
    l += part;
    __syncwarp();

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      FragA pf;
      wmma::load_matrix_sync(pf, Pw + kk * 16, L::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBRow vf;
        wmma::load_matrix_sync(vf, Vt + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(of[j], pf, vf, of[j]);
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration's prefetch
  }

  // epilogue: o = acc / max(l, FLT_MIN), lse = log of that floor
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(Sw + j * 16, of[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  l = fmaxf(l, FLT_MIN);
  const int row = q0 + warp * 16 + prow;
  bf16* og = o + (size_t(b) * nq + row) * ld + h * D;
  const int c0 = half * (D / 2);
  for (int j = c0; j < c0 + D / 2; ++j) og[j] = __float2bfloat16(Sw[prow * L::LDS + j] / l);
  if (half == 0) lse[size_t(bh) * nq + row] = logf(l);
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads,
           int nq, int nk, float scale, cudaStream_t stream) {
  const size_t smem = FlashSmem<D>::bytes;
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(nq / BQ, batch * heads);
  flash_fwd_kernel<D><<<grid, NWARPS * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), static_cast<float*>(lse), heads, nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace lr

// q, o: [batch, nq, heads*d], k, v: [batch, nk, heads*d], bf16 contiguous (the
// packed projection layout: no head transpose is materialized); lse: [batch*heads, nq]
// fp32.  nq and nk must be multiples of 64, d is 64 or 128.
extern "C" int lr_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int heads, int nq, int nk, int d, float scale,
                            void* stream) {
  if (nq % lr::BQ || nk % lr::BK || batch <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return lr::launch<64>(q, k, v, o, lse, batch, heads, nq, nk, scale, s);
  if (d == 128) return lr::launch<128>(q, k, v, o, lse, batch, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
