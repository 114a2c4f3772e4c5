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
// so one dq kernel here streams K/V for any Nk.  dk takes the scale after the
// product (TPU: bf16(scale * q) before it): at D = 64 the scale is 1/8 and
// the two are the same bits; at D = 128 they differ by one bf16 rounding of q.
//
// What bounds them on the H100: dq does three products of 2 Nq Nk D flops
// (S, dP, dS K) and dk/dv four (S, dP, P^T dO, dS^T Q) against one exp and a
// handful of fp32 operations per score.  At D = 64 the SM's 16 exps a clock
// take 2/3 (dq) or 1/2 (dk/dv) of the products' time at the tensor cores'
// peak, and the other elementwise operations about as much again, so the
// elementwise pass has to run under the products, and the registers that
// hold S, dP and the gradient accumulators decide the tile shapes.
//
// Design (wgmma + TMA, warp-specialised, as K1).  A block has two consumer
// warpgroups of 64 rows and a producer warpgroup, which hands its registers
// to the consumers (setmaxnreg: 24 a thread for it, 240 for them) and in
// which one thread loads the block's own tiles once and streams the other
// side's tiles through a 4-stage ring of full/empty mbarriers, with TMA on
// 4-D tensor maps over the packed [B, N, H*D] layout (D, H, N, B),
// 128-byte swizzled.
// - dq: a block owns 128 query rows; Q and dO are loaded once, K and V stream
//   in tiles of 128 keys (64 at D = 128); each thread keeps lse and D of its
//   two rows in registers.  Per tile, S = Q K^T and dP = dO V^T are wgmma
//   products from shared memory; exp, the clamp mask and dS run in
//   registers; bf16(dS) is packed pairwise into the register A operand of
//   dq += dS K (K read MN-major, the role V plays in the forward's P V).  A
//   last tile past Nk (zero-filled by TMA) has its dS masked.
// - dk/dv: a block owns 128 keys; K and V are loaded once, Q and dO stream in
//   64-query tiles with that tile's lse and D (a bulk copy into the same
//   stage).  Per tile, S^T = K Q^T and dP^T = V dO^T are computed directly,
//   so P^T and dS^T sit in the accumulator layout that packs into the A
//   operand of dv += P^T dO and dk += dS^T Q (dO and Q read MN-major: the
//   same swizzled tiles that were the K-major B operands of dP^T and S^T);
//   lse and D are indexed by the accumulator's column.
// The two warpgroups take turns to issue their products (named barriers), so
// one's elementwise pass runs under the other's products, and within a
// warpgroup the S/dP products of tile t are issued before the gradient
// products of tile t - 1 are waited on.  dq, dk and dv stay in fp32
// accumulators across the whole loop and leave through shared memory by a TMA
// store, which clips a ragged last tile (a 64-row tail past a 128-row tile
// is read as TMA's zero fill: its rows compute values that are never
// stored).  No block writes another's rows: no atomics, deterministic.
#include "common.cuh"
#include "sm90.cuh"

namespace lr {
namespace {

using namespace sm90;

constexpr int BR = 128;         // rows a block owns (queries for dq, keys for dk/dv)
constexpr int CONSUMERS = 256;  // two warpgroups of 64 rows
constexpr int NTHREADS = CONSUMERS + 128;  // and a producer warpgroup
// the producer warpgroup hands its registers to the consumers: 128 x 24 +
// 256 x 240 of the SM's 65536 (at launch each thread has 168)
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int STAGES = 4;
constexpr float CLAMP = 75.0f;

template <int D>
struct Bwd {
  static constexpr int CH = D / 64;             // 128-byte column boxes per row
  static constexpr int OWN_BYTES = BR * D * 2;  // one of the block's own tiles (Q or dO; K or V)
  // rows of a streamed tile: dq streams 128 keys at D = 64 (S and dP then
  // take 64 registers each, dS's fragments 32, dq 32), 64 at D = 128; dk/dv
  // streams 64 queries (dk and dv take D registers together)
  static constexpr int BT_DQ = D == 64 ? 128 : 64;
  static constexpr int BT_DKV = 64;
  static constexpr int ROWS_BYTES = BT_DKV * 4;  // one streamed fp32 row vector (lse or D)
  // dq: per stage K then V; dk/dv: per stage Q, dO, then lse and D (padded
  // so that every stage's tiles start on a 1024-byte boundary)
  static constexpr int DQ_STAGE = 2 * BT_DQ * D * 2;
  static constexpr int DKV_STAGE = 2 * BT_DKV * D * 2 + 1024;
  static constexpr int DQ_SMEM = 1024 + 2 * OWN_BYTES + STAGES * DQ_STAGE + (2 * STAGES + 1) * 8;
  static constexpr int DKV_SMEM = 1024 + 2 * OWN_BYTES + STAGES * DKV_STAGE + (2 * STAGES + 1) * 8;
};

// exp(x) on the SFU as 2^(x log2 e), a result below FLT_MIN flushed to 0.
// With __expf's ex2, which does not flush, the elementwise pass and not
// the products set the dq kernel's time.
__device__ __forceinline__ float exp_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// acc = A_w B^T for one streamed tile: A the warpgroup's 64 rows of an own
// tile [BR rows], B a streamed tile [BT rows], both K-major over D; D / 16
// steps of 16 head-dim values (a 128-byte column box holds 4).
template <int D, int BT>
__device__ __forceinline__ void issue_rows(float (&acc)[BT / 2], const unsigned char* Aw, const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BT>::ss(acc, desc_sw128(Aw + (kk / 4) * BR * 128 + (kk % 4) * 32, 16, 1024),
                  desc_sw128(B + (kk / 4) * BT * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// acc += F B for one streamed tile: F the bf16 A fragments of 16 streamed
// rows each, B the streamed tile [BT rows][D] read MN-major, BT / 16 steps
// of 16 rows (2048 bytes each); a second 64-column box (D = 128) lies
// BT * 128 bytes on.
template <int D, int BT>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2], const uint32_t (&f)[BT / 16][4],
                                           const unsigned char* B) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) Wgmma<D>::rs(acc, f[kk], desc_sw128(B + kk * 2048, BT * 128, 1024));
}

// dq's elementwise pass: s (scores / scale) becomes dS in place; dp is dP.
// Rows g and g + 8 of this thread have lse l0, l1 and D d0, d1.  Masked: dS
// is 0 for keys at or past `valid` (the last tile's tail, zero-filled by
// TMA, where exp(0 - lse) could overflow).
template <int BT, bool Masked>
__device__ __forceinline__ void ds_tile(float (&s)[BT / 2], const float (&dp)[BT / 2], float scale, float l0,
                                        float l1, float d0, float d1, int valid) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) {
    const bool hi = (i / 2) % 2;
    const float sv = s[i] * scale;
    const float p = exp_ftz(fminf(sv, CLAMP) - (hi ? l1 : l0));
    s[i] = sv <= CLAMP ? p * (dp[i] - (hi ? d1 : d0)) : 0.0f;
    if (Masked && 8 * (i / 4) + 2 * (lane % 4) + (i % 2) >= valid) s[i] = 0.0f;
  }
}

// dS of a tile with `valid` keys inside Nk: only a last tile that reaches
// past Nk pays for the mask.
template <int BT>
__device__ __forceinline__ void ds_by_row(float (&s)[BT / 2], const float (&dp)[BT / 2], float scale, float l0,
                                          float l1, float d0, float d1, int valid) {
  if (valid < BT)
    ds_tile<BT, true>(s, dp, scale, l0, l1, d0, d1, valid);
  else
    ds_tile<BT, false>(s, dp, scale, l0, l1, d0, d1, BT);
}

// dk/dv's elementwise pass on the transposed tile: s (scores^T / scale)
// becomes p^T and dp (dP^T) becomes dS^T in place; the accumulator's column
// is the query, whose lse and D come from the stage's row vectors.
template <int BT>
__device__ __forceinline__ void pds_by_col(float (&s)[BT / 2], float (&dp)[BT / 2], float scale, const float* lse,
                                           const float* dd) {
  const int c0 = 2 * (threadIdx.x % 4);
#pragma unroll
  for (int g = 0; g < BT / 8; ++g) {
    const float2 l = *reinterpret_cast<const float2*>(lse + 8 * g + c0);
    const float2 d = *reinterpret_cast<const float2*>(dd + 8 * g + c0);
#pragma unroll
    for (int i = 4 * g; i < 4 * g + 4; ++i) {
      const float sv = s[i] * scale;
      const float p = exp_ftz(fminf(sv, CLAMP) - (i % 2 ? l.y : l.x));
      dp[i] = sv <= CLAMP ? p * (dp[i] - (i % 2 ? d.y : d.x)) : 0.0f;
      s[i] = p;
    }
  }
}

// One warpgroup's 64 x D fp32 accumulator, times ``mul``, as bf16 into its
// 64 rows of an own tile (the same swizzled layout TMA reads), then out by a
// TMA store of its CH column boxes at rows row0.. of (h, b).
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2], float mul, unsigned char* Tw,
                                           const CUtensorMap* map, int h, int row0, int b, int wg) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = (warp % 4) * 16 + lane / 4;  // row g of the warpgroup's 64; g + 8 is r0 + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      *reinterpret_cast<uint32_t*>(Tw + (n / 8) * BR * 128 + r * 128 + (((n % 8) ^ (r % 8)) * 16) + (lane % 4) * 4) =
          pack_bf16(acc[4 * n + 2 * half] * mul, acc[4 * n + 2 * half + 1] * mul);
    }
  fence_proxy_async();
  bar_sync(3 + wg, 128);
  if (warp % 4 == 0 && lane == 0) {
    for (int c = 0; c < D / 64; ++c) tma_store_4d(map, Tw + c * BR * 128, 64 * c, h, row0, b);
    tma_store_wait();
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                        const __grid_constant__ CUtensorMap dqmap, const float* __restrict__ lse,
                        const float* __restrict__ delta, int heads, int nq, int nk, float scale) {
  using F = Bwd<D>;
  constexpr int BT = F::BT_DQ, TB = BT * D * 2;  // streamed rows; bytes of a streamed tile
  constexpr int CH = F::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);  // CH boxes of [BR rows][64]
  unsigned char* Os = Qs + F::OWN_BYTES;    // dO, the same
  unsigned char* ring = Os + F::OWN_BYTES;  // per stage: CH K boxes, then CH V boxes, [BT rows][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * F::DQ_STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * BR;
  const int ntiles = (nk + BT - 1) / BT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init(own, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues the copies
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(own, 2 * F::OWN_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Qs + c * BR * 128, &qmap, own, 64 * c, h, q0, b);
        tma_load_4d(Os + c * BR * 128, &omap, own, 64 * c, h, q0, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * F::DQ_STAGE;
        mbar_expect_tx(&full[s], F::DQ_STAGE);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(st + c * BT * 128, &kmap, &full[s], 64 * c, h, t * BT, b);
          tma_load_4d(st + TB + c * BT * 128, &vmap, &full[s], 64 * c, h, t * BT, b);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const unsigned char* Qw = Qs + wg * 64 * 128;
  const unsigned char* Ow = Os + wg * 64 * 128;
  const int row = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;  // rows g and g + 8 of this thread
  // rows past nq (a ragged last tile) read as zeros: their q and dO are TMA's zero fill
  const float l0 = row < nq ? lse[size_t(bh) * nq + row] : 0.0f;
  const float l1 = row + 8 < nq ? lse[size_t(bh) * nq + row + 8] : 0.0f;
  const float d0 = row < nq ? delta[size_t(bh) * nq + row] : 0.0f;
  const float d1 = row + 8 < nq ? delta[size_t(bh) * nq + row + 8] : 0.0f;
  float s[BT / 2], dp[BT / 2];  // S (then dS) and dP of one tile
  uint32_t f[BT / 16][4];       // bf16(dS) as the A fragments of dq += dS K
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

  auto stage = [&](int t) { return ring + (t % STAGES) * F::DQ_STAGE; };
  // the turn protocol of flash_fwd.cu: warpgroup w issues its products after
  // bar_sync(1 + w) and hands the turn over with bar_arrive(2 - w)
  const int my_turn = 1 + wg, next_turn = 2 - wg;
  if (wg == 1) bar_arrive(1, CONSUMERS);

  mbar_wait(own, 0);
  mbar_wait(&full[0], 0);
  bar_sync(my_turn, CONSUMERS);
  wgmma_fence();
  issue_rows<D, BT>(s, Qw, stage(0));
  issue_rows<D, BT>(dp, Ow, stage(0) + TB);
  wgmma_commit();
  if (wg == 0 || ntiles > 1) bar_arrive(next_turn, CONSUMERS);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  ds_by_row<BT>(s, dp, scale, l0, l1, d0, d1, nk);
  pack_frags<BT>(f, s);

  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    bar_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_rows<D, BT>(s, Qw, stage(t));
    issue_rows<D, BT>(dp, Ow, stage(t) + TB);
    wgmma_commit();
    issue_grad<D, BT>(dq, f, stage(t - 1));
    wgmma_commit();
    if (wg == 0 || t < ntiles - 1) bar_arrive(next_turn, CONSUMERS);
    wgmma_wait<1>();  // S and dP of tile t are in; dq of tile t - 1 runs on
    fence_regs(s);
    fence_regs(dp);
    ds_by_row<BT>(s, dp, scale, l0, l1, d0, d1, nk - t * BT);
    wgmma_wait<0>();
    fence_regs(dq);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) fence_regs(f[kk]);  // the product has read them
    if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    pack_frags<BT>(f, s);
  }
  wgmma_fence();
  issue_grad<D, BT>(dq, f, stage(ntiles - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dq);

  // dq * scale through this warpgroup's rows of the Q tile (its products are
  // done with them), clipped to nq by the store
  store_rows<D>(dq, scale, Qs + wg * 64 * 128, &dqmap, h, q0 + wg * 64, b, wg);
}

template <int D>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                         const __grid_constant__ CUtensorMap dkmap, const __grid_constant__ CUtensorMap dvmap,
                         const float* __restrict__ lse, const float* __restrict__ delta, int heads, int nq, int nk,
                         float scale) {
  using F = Bwd<D>;
  constexpr int BT = F::BT_DKV, TB = BT * D * 2;  // streamed rows; bytes of a streamed tile
  constexpr int CH = F::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);  // CH boxes of [BR rows][64]
  unsigned char* Vs = Ks + F::OWN_BYTES;    // V, the same
  unsigned char* ring = Vs + F::OWN_BYTES;  // per stage: CH Q boxes, CH dO boxes [BT rows][64], lse, D
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * F::DKV_STAGE);
  uint64_t* empty = full + STAGES;
  uint64_t* own = empty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int k0 = blockIdx.x * BR;
  const int ntiles = nq / BT;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(own, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues the copies
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(own, 2 * F::OWN_BYTES);
      for (int c = 0; c < CH; ++c) {
        tma_load_4d(Ks + c * BR * 128, &kmap, own, 64 * c, h, k0, b);
        tma_load_4d(Vs + c * BR * 128, &vmap, own, 64 * c, h, k0, b);
      }
      const float* lrow = lse + size_t(bh) * nq;
      const float* drow = delta + size_t(bh) * nq;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * F::DKV_STAGE;
        mbar_expect_tx(&full[s], 2 * TB + 2 * F::ROWS_BYTES);
        for (int c = 0; c < CH; ++c) {
          tma_load_4d(st + c * BT * 128, &qmap, &full[s], 64 * c, h, t * BT, b);
          tma_load_4d(st + TB + c * BT * 128, &omap, &full[s], 64 * c, h, t * BT, b);
        }
        bulk_load(st + 2 * TB, lrow + t * BT, F::ROWS_BYTES, &full[s]);
        bulk_load(st + 2 * TB + F::ROWS_BYTES, drow + t * BT, F::ROWS_BYTES, &full[s]);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63 -----------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const unsigned char* Kw = Ks + wg * 64 * 128;
  const unsigned char* Vw = Vs + wg * 64 * 128;
  float s[BT / 2], dp[BT / 2];       // S^T then P^T, dP^T then dS^T, of one tile
  uint32_t fp[BT / 16][4], fs[BT / 16][4];  // bf16(P^T), bf16(dS^T) as A fragments
  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.0f;

  // per stage: Q, dO, then the fp32 lse and D of its queries
  auto stage = [&](int t) { return ring + (t % STAGES) * F::DKV_STAGE; };
  auto rows = [&](int t) { return reinterpret_cast<const float*>(stage(t) + 2 * TB); };
  const int my_turn = 1 + wg, next_turn = 2 - wg;
  if (wg == 1) bar_arrive(1, CONSUMERS);

  mbar_wait(own, 0);
  mbar_wait(&full[0], 0);
  bar_sync(my_turn, CONSUMERS);
  wgmma_fence();
  issue_rows<D, BT>(s, Kw, stage(0));                   // S^T = K Q^T
  issue_rows<D, BT>(dp, Vw, stage(0) + TB);  // dP^T = V dO^T
  wgmma_commit();
  if (wg == 0 || ntiles > 1) bar_arrive(next_turn, CONSUMERS);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  pds_by_col<BT>(s, dp, scale, rows(0), rows(0) + BT);
  pack_frags<BT>(fp, s);
  pack_frags<BT>(fs, dp);

  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    bar_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_rows<D, BT>(s, Kw, stage(t));
    issue_rows<D, BT>(dp, Vw, stage(t) + TB);
    wgmma_commit();
    issue_grad<D, BT>(dv, fp, stage(t - 1) + TB);  // dv += P^T dO
    issue_grad<D, BT>(dk, fs, stage(t - 1));                  // dk += dS^T Q
    wgmma_commit();
    if (wg == 0 || t < ntiles - 1) bar_arrive(next_turn, CONSUMERS);
    wgmma_wait<1>();  // S^T and dP^T of tile t are in; dk, dv of tile t - 1 run on
    fence_regs(s);
    fence_regs(dp);
    pds_by_col<BT>(s, dp, scale, rows(t), rows(t) + BT);
    wgmma_wait<0>();
    fence_regs(dk);
    fence_regs(dv);
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      fence_regs(fp[kk]);
      fence_regs(fs[kk]);
    }
    if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    pack_frags<BT>(fp, s);
    pack_frags<BT>(fs, dp);
  }
  wgmma_fence();
  issue_grad<D, BT>(dv, fp, stage(ntiles - 1) + TB);
  issue_grad<D, BT>(dk, fs, stage(ntiles - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);

  // dk * scale and dv through this warpgroup's rows of the K and V tiles,
  // clipped to nk by the stores
  store_rows<D>(dk, scale, Ks + wg * 64 * 128, &dkmap, h, k0 + wg * 64, b, wg);
  store_rows<D>(dv, 1.0f, Vs + wg * 64 * 128, &dvmap, h, k0 + wg * 64, b, wg);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              void* dq, int batch, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om, dqm;
  cudaError_t e = packed_map(&qm, q, D, batch, heads, nq, BR);
  if (e == cudaSuccess) e = packed_map(&om, dout, D, batch, heads, nq, BR);
  if (e == cudaSuccess) e = packed_map(&km, k, D, batch, heads, nk, Bwd<D>::BT_DQ);
  if (e == cudaSuccess) e = packed_map(&vm, v, D, batch, heads, nk, Bwd<D>::BT_DQ);
  if (e == cudaSuccess) e = packed_map(&dqm, dq, D, batch, heads, nq, 64);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dq_kernel<D>, Bwd<D>::DQ_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((nq + BR - 1) / BR, batch * heads);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, Bwd<D>::DQ_SMEM, stream>>>(
      qm, km, vm, om, dqm, static_cast<const float*>(lse), static_cast<const float*>(delta), heads, nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int batch, int heads, int nq, int nk, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm, om, dkm, dvm;
  cudaError_t e = packed_map(&qm, q, D, batch, heads, nq, Bwd<D>::BT_DKV);
  if (e == cudaSuccess) e = packed_map(&om, dout, D, batch, heads, nq, Bwd<D>::BT_DKV);
  if (e == cudaSuccess) e = packed_map(&km, k, D, batch, heads, nk, BR);
  if (e == cudaSuccess) e = packed_map(&vm, v, D, batch, heads, nk, BR);
  if (e == cudaSuccess) e = packed_map(&dkm, dk, D, batch, heads, nk, 64);
  if (e == cudaSuccess) e = packed_map(&dvm, dv, D, batch, heads, nk, 64);
  if (e == cudaSuccess) e = allow_smem(flash_bwd_dkv_kernel<D>, Bwd<D>::DKV_SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((nk + BR - 1) / BR, batch * heads);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, Bwd<D>::DKV_SMEM, stream>>>(
      qm, km, vm, om, dkm, dvm, static_cast<const float*>(lse), static_cast<const float*>(delta), heads, nq, nk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int batch, int heads, int nq, int nk) {
  return nq % 64 || nk % 64 || nq <= 0 || nk <= 0 || batch <= 0 || heads <= 0 || batch * heads > 65535;
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

// The dynamic shared memory of one block at head dim d (64 or 128), bytes; -1 otherwise.
extern "C" int lr_flash_bwd_dq_smem(int d) {
  return d == 64 ? lr::Bwd<64>::DQ_SMEM : d == 128 ? lr::Bwd<128>::DQ_SMEM : -1;
}

extern "C" int lr_flash_bwd_dkv_smem(int d) {
  return d == 64 ? lr::Bwd<64>::DKV_SMEM : d == 128 ? lr::Bwd<128>::DKV_SMEM : -1;
}
