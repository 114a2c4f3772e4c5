// K12 + K14 (dq) and K13 (dk, dv): the backward of the clamp-softmax
// attention, bf16 in and out, fp32 accumulation.
//
// Replaces leftrefill_tpu/ops/flash_attention.py:_flash_bwd_dq_kernel (K12,
// K/V resident), _flash_bwd_dq_chunk_kernel (K14, K/V streamed beyond 8192
// keys) and _flash_bwd_dkv_kernel (K13), launched by _flash_backward.  With
// lse from the forward (K1) and D = rowsum(dO * O) computed outside (as JAX
// does), per score:
//   s = scale * q.k,  p = exp(min(s, 75) - lse),  dP = dO.v,
//   dS = p * (dP - D), zeroed where s > 75 (the forward is flat in s there),
//   dq = scale * sum_k bf16(dS) k,  dv = sum_q bf16(p) dO,
//   dk = scale * sum_q bf16(dS) q.
// K12 and K14 exist only because of TPU VMEM; they compute the same function,
// so one dq kernel here streams K/V in 64-key tiles for any Nk.  dk takes the
// scale after the product (TPU: bf16(scale * q) before it): at D = 64 the
// scale is 1/8 and the two are the same bits; at D = 128 they differ by one
// bf16 rounding of q.
//
// Design: as the forward (flash_fwd.cu), a block of four warps owns 64 rows
// of one (batch, head) and streams the other side's 64-row tiles through a
// two-stage async-copy pipeline; each warp owns 16 rows, keeps its A operands
// in registers as WMMA fragments and stages the two 16 x 64 fp32 score tiles
// (s and dP) through shared memory for the elementwise pass.
// - dq: the block owns 64 queries and walks the keys; dq accumulates in fp32
//   fragments and is scaled and rounded once at the end.
// - dk/dv: the block owns 64 keys and walks the queries with their lse and D;
//   dk and dv accumulate in fp32 fragments.  No block writes another's rows,
//   so there are no atomics and the results are deterministic.
// All tensors are read in the packed [B, N, H*D] projection layout (no head
// transposes are materialized).
// Bound on the H100: dq does three products of 2*Nq*Nk*D flops and dk/dv four,
// against one exp per score; at D = 64 the exp/convert pass through shared
// memory, not the tensor cores, limits this simple version (wgmma, TMA and a
// fused one-kernel backward are later work).
#include "common.cuh"

namespace lr {
namespace {

constexpr int BR = 64;  // rows per block and per streamed tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float CLAMP = 75.0f;

template <int D>
struct BwdSmem {
  static constexpr int LDQ = D + 8;                  // bf16 stride of the 64 x D operand tiles
  static constexpr int LDS = (D > BR ? D : BR) + 4;  // fp32 stride of the score tiles (and output staging)
  static constexpr int LDP = BR + 8;                 // bf16 stride of the P / dS tiles
  static constexpr size_t TILE = size_t(BR) * LDQ * 2;
  static constexpr size_t F32 = size_t(BR) * LDS * 4;
  static constexpr size_t B16 = size_t(BR) * LDP * 2;
  static constexpr size_t ROW = size_t(BR) * 4;  // 64 fp32 row statistics
  // dq: Q, dO, K and V double-buffered, s, dP, dS
  static constexpr size_t dq_bytes = 6 * TILE + 2 * F32 + B16;
  // dk/dv: K, V, Q and dO double-buffered, lse and D double-buffered, s, dP, P, dS
  static constexpr size_t dkv_bytes = 6 * TILE + 4 * ROW + 2 * F32 + 2 * B16;
};

// Copy a 64 x D bf16 tile whose rows are ``ld`` elements apart into shared
// memory (row stride LDQ), 16 bytes per copy.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, size_t ld, int tid) {
  constexpr int CPR = D / 8;
  for (int c = tid; c < BR * CPR; c += NTHREADS) {
    const int r = c / CPR, cc = (c % CPR) * 8;
    cp_async16(dst + r * BwdSmem<D>::LDQ + cc, src + r * ld + cc, true);
  }
}

// The two score tiles of one warp's 16 rows against a 64-row tile:
// s = A1 . B1^T and dP = A2 . B2^T, both stored fp32 into Sw and Pw.
template <int D>
__device__ __forceinline__ void score_tiles(const FragA (&a1)[D / 16], const FragA (&a2)[D / 16],
                                            const bf16* b1, const bf16* b2, float* Sw, float* Pw) {
  using L = BwdSmem<D>;
#pragma unroll
  for (int n = 0; n < BR / 16; ++n) {
    FragC sf, pf;
    wmma::fill_fragment(sf, 0.0f);
    wmma::fill_fragment(pf, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBCol bf;
      wmma::load_matrix_sync(bf, b1 + n * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(sf, a1[kk], bf, sf);
      wmma::load_matrix_sync(bf, b2 + n * 16 * L::LDQ + kk * 16, L::LDQ);
      wmma::mma_sync(pf, a2[kk], bf, pf);
    }
    wmma::store_matrix_sync(Sw + n * 16, sf, L::LDS, wmma::mem_row_major);
    wmma::store_matrix_sync(Pw + n * 16, pf, L::LDS, wmma::mem_row_major);
  }
}

// Write one warp's 16 x D fp32 accumulator, times ``mul``, as bf16 rows of
// the packed layout (``dst`` points at the warp's first row; staged through Sw).
template <int D>
__device__ __forceinline__ void store_rows(FragC (&acc)[D / 16], float* Sw, bf16* dst, size_t ld,
                                           float mul, int lane) {
  using L = BwdSmem<D>;
  __syncwarp();
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::store_matrix_sync(Sw + j * 16, acc[j], L::LDS, wmma::mem_row_major);
  __syncwarp();
  const int prow = lane & 15, c0 = (lane >> 4) * (D / 2);
  bf16* out = dst + prow * ld;
  for (int j = c0; j < c0 + D / 2; ++j) out[j] = __float2bfloat16(Sw[prow * L::LDS + j] * mul);
  __syncwarp();
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dq, int heads, int nq, int nk, float scale) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = reinterpret_cast<bf16*>(smem + L::TILE);
  bf16* Ks[2] = {reinterpret_cast<bf16*>(smem + 2 * L::TILE), reinterpret_cast<bf16*>(smem + 3 * L::TILE)};
  bf16* Vs[2] = {reinterpret_cast<bf16*>(smem + 4 * L::TILE), reinterpret_cast<bf16*>(smem + 5 * L::TILE)};
  float* Ss = reinterpret_cast<float*>(smem + 6 * L::TILE);
  float* Ps = reinterpret_cast<float*>(smem + 6 * L::TILE + L::F32);
  bf16* dSs = reinterpret_cast<bf16*>(smem + 6 * L::TILE + 2 * L::F32);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * BR;
  // packed [B, N, heads*D] rows: token n of head h starts at (b*N + n)*ld + h*D
  const size_t ld = size_t(heads) * D;
  const bf16* kg = k + size_t(b) * nk * ld + h * D;
  const bf16* vg = v + size_t(b) * nk * ld + h * D;

  load_tile<D>(Qs, q + (size_t(b) * nq + q0) * ld + h * D, ld, tid);
  load_tile<D>(Os, dout + (size_t(b) * nq + q0) * ld + h * D, ld, tid);
  load_tile<D>(Ks[0], kg, ld, tid);
  load_tile<D>(Vs[0], vg, ld, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  FragA qf[D / 16], of[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], Qs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
    wmma::load_matrix_sync(of[kk], Os + warp * 16 * L::LDQ + kk * 16, L::LDQ);
  }
  FragC acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);

  float* Sw = Ss + warp * 16 * L::LDS;
  float* Pw = Ps + warp * 16 * L::LDS;
  bf16* dSw = dSs + warp * 16 * L::LDP;
  // two lanes per query row, interleaved over the tile's 64 keys
  const int prow = lane & 15, half = lane >> 4;
  const int row = q0 + warp * 16 + prow;
  const float lse_r = lse[size_t(bh) * nq + row];
  const float d_r = delta[size_t(bh) * nq + row];

  const int ntiles = nk / BR;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile<D>(Ks[(t + 1) & 1], kg + size_t(t + 1) * BR * ld, ld, tid);
      load_tile<D>(Vs[(t + 1) & 1], vg + size_t(t + 1) * BR * ld, ld, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks[t & 1];

    score_tiles<D>(qf, of, Kt, Vs[t & 1], Sw, Pw);  // s/scale = Q K^T, dP = dO V^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < BR / 2; ++j) {
      const int col = half + 2 * j;
      const float s = Sw[prow * L::LDS + col] * scale;
      const float p = __expf(fminf(s, CLAMP) - lse_r);
      const float ds = s <= CLAMP ? p * (Pw[prow * L::LDS + col] - d_r) : 0.0f;
      dSw[prow * L::LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dq += dS K
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      FragA a;
      wmma::load_matrix_sync(a, dSw + kk * 16, L::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBRow kb;
        wmma::load_matrix_sync(kb, Kt + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(acc[j], a, kb, acc[j]);
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration's prefetch
  }
  store_rows<D>(acc, Sw, dq + (size_t(b) * nq + q0 + warp * 16) * ld + h * D, ld, scale, lane);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
    flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dout,
                         const float* __restrict__ lse, const float* __restrict__ delta,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int nq, int nk,
                         float scale) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L::TILE);
  bf16* Qs[2] = {reinterpret_cast<bf16*>(smem + 2 * L::TILE), reinterpret_cast<bf16*>(smem + 3 * L::TILE)};
  bf16* Os[2] = {reinterpret_cast<bf16*>(smem + 4 * L::TILE), reinterpret_cast<bf16*>(smem + 5 * L::TILE)};
  unsigned char* rows = smem + 6 * L::TILE;
  float* Ls[2] = {reinterpret_cast<float*>(rows), reinterpret_cast<float*>(rows + L::ROW)};
  float* Ds[2] = {reinterpret_cast<float*>(rows + 2 * L::ROW), reinterpret_cast<float*>(rows + 3 * L::ROW)};
  float* Ss = reinterpret_cast<float*>(rows + 4 * L::ROW);
  float* dPs = reinterpret_cast<float*>(rows + 4 * L::ROW + L::F32);
  bf16* Pb = reinterpret_cast<bf16*>(rows + 4 * L::ROW + 2 * L::F32);
  bf16* dSb = reinterpret_cast<bf16*>(rows + 4 * L::ROW + 2 * L::F32 + L::B16);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * BR;
  const size_t ld = size_t(heads) * D;
  const bf16* qg = q + size_t(b) * nq * ld + h * D;
  const bf16* og = dout + size_t(b) * nq * ld + h * D;
  const float* lg = lse + size_t(bh) * nq;
  const float* dg = delta + size_t(bh) * nq;

  // one 64-query tile: Q and dO rows, their lse and D (16 copies of 16 bytes each)
  auto load_q = [&](int tile, int stage) {
    load_tile<D>(Qs[stage], qg + size_t(tile) * BR * ld, ld, tid);
    load_tile<D>(Os[stage], og + size_t(tile) * BR * ld, ld, tid);
    if (tid < 16) cp_async16(Ls[stage] + tid * 4, lg + tile * BR + tid * 4, true);
    else if (tid < 32) cp_async16(Ds[stage] + (tid - 16) * 4, dg + tile * BR + (tid - 16) * 4, true);
  };

  load_tile<D>(Ks, k + (size_t(b) * nk + k0) * ld + h * D, ld, tid);
  load_tile<D>(Vs, v + (size_t(b) * nk + k0) * ld + h * D, ld, tid);
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  FragA kf[D / 16], vf[D / 16];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(kf[kk], Ks + warp * 16 * L::LDQ + kk * 16, L::LDQ);
    wmma::load_matrix_sync(vf[kk], Vs + warp * 16 * L::LDQ + kk * 16, L::LDQ);
  }
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.0f);
    wmma::fill_fragment(dv_acc[j], 0.0f);
  }

  float* Sw = Ss + warp * 16 * L::LDS;
  float* dPw = dPs + warp * 16 * L::LDS;
  bf16* Pw = Pb + warp * 16 * L::LDP;
  bf16* dSw = dSb + warp * 16 * L::LDP;
  // two lanes per key row, interleaved over the tile's 64 queries
  const int prow = lane & 15, half = lane >> 4;

  const int ntiles = nq / BR;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_q(t + 1, (t + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Qt = Qs[t & 1];
    const bf16* Ot = Os[t & 1];
    const float* Lt = Ls[t & 1];
    const float* Dt = Ds[t & 1];

    score_tiles<D>(kf, vf, Qt, Ot, Sw, dPw);  // s^T/scale = K Q^T, dP^T = V dO^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < BR / 2; ++j) {
      const int col = half + 2 * j;
      const float s = Sw[prow * L::LDS + col] * scale;
      const float p = __expf(fminf(s, CLAMP) - Lt[col]);
      const float ds = s <= CLAMP ? p * (dPw[prow * L::LDS + col] - Dt[col]) : 0.0f;
      Pw[prow * L::LDP + col] = __float2bfloat16(p);
      dSw[prow * L::LDP + col] = __float2bfloat16(ds);
    }
    __syncwarp();

    // dv += P^T dO, dk += dS^T Q
#pragma unroll
    for (int kk = 0; kk < BR / 16; ++kk) {
      FragA pa, sa;
      wmma::load_matrix_sync(pa, Pw + kk * 16, L::LDP);
      wmma::load_matrix_sync(sa, dSw + kk * 16, L::LDP);
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        FragBRow bf;
        wmma::load_matrix_sync(bf, Ot + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(dv_acc[j], pa, bf, dv_acc[j]);
        wmma::load_matrix_sync(bf, Qt + kk * 16 * L::LDQ + j * 16, L::LDQ);
        wmma::mma_sync(dk_acc[j], sa, bf, dk_acc[j]);
      }
    }
    __syncthreads();  // this stage is refilled at the next iteration's prefetch
  }
  const size_t first = (size_t(b) * nk + k0 + warp * 16) * ld + h * D;
  store_rows<D>(dk_acc, Sw, dk + first, ld, scale, lane);
  store_rows<D>(dv_acc, Sw, dv + first, ld, 1.0f, lane);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int batch, int heads, int nq, int nk, float scale,
              cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dq_bytes;
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(nq / BR, batch * heads);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), heads, nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int batch, int heads, int nq, int nk, float scale,
               cudaStream_t stream) {
  const size_t smem = BwdSmem<D>::dkv_bytes;
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(nk / BR, batch * heads);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), heads, nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int heads, int nq, int nk) {
  return nq % BR || nk % BR || nq <= 0 || nk <= 0 || batch <= 0 || heads <= 0 || batch * heads > 65535;
}

}  // namespace
}  // namespace lr

// q, dout, dq: [batch, nq, heads*d]; k, v: [batch, nk, heads*d], bf16 contiguous
// (the packed projection layout); lse, delta: [batch*heads, nq] fp32 (the
// forward's logsumexp and rowsum(dO * O)).  nq and nk must be multiples of 64,
// d is 64 or 128.
extern "C" int lr_flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                               const void* lse, const void* delta, void* dq, int batch, int heads,
                               int nq, int nk, int d, float scale, void* stream) {
  if (lr::bad_shape(batch, heads, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return lr::launch_dq<64>(q, k, v, dout, lse, delta, dq, batch, heads, nq, nk, scale, s);
  if (d == 128) return lr::launch_dq<128>(q, k, v, dout, lse, delta, dq, batch, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// As lr_flash_bwd_dq, writing dk and dv: [batch, nk, heads*d] bf16.
extern "C" int lr_flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dk, void* dv, int batch,
                                int heads, int nq, int nk, int d, float scale, void* stream) {
  if (lr::bad_shape(batch, heads, nq, nk)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return lr::launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nk, scale, s);
  if (d == 128) return lr::launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, batch, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
