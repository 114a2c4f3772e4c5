// K1 / K11: attention forward with the clamp softmax, bf16 in, bf16 o + fp32 lse out.
//
// Replaces leftrefill_tpu/ops/flash_attention.py:_flash_kernel (K1, launched by
// _flash_forward) and _flash_kvchunk_kernel (K11, K/V streamed in chunks,
// _flash_forward_kvchunk): the same function, blocked two ways for VMEM.
// Per row: s = scale * q.k, p = exp(min(s, 75)), l = max(sum p, FLT_MIN),
// o = (bf16(p) . v) / l, lse = log l.
//
// What bounds it on the H100: the two products are 4 Nq Nk D flops against
// one exp per score; at D = 64 a score costs 256 tensor-core flops and one
// SFU exp, and the SM does ~8 times more of the former per clock (1024 bf16
// FMA against 16 exp), so the exps take about as long as the products and
// only overlapping the two reaches the tensor-core bound.
//
// Design (wgmma + TMA, warp-specialised).  A block owns 128 query rows of one
// (batch, head): two consumer warpgroups of 64 rows and one producer warp.
// The producer loads the Q tile once and streams K and V tiles of BK keys
// through a 3-stage ring with TMA on 4-D tensor maps over the packed
// [B, N, H*D] layout (D, H, N, B), 128-byte swizzled, with a full/empty
// mbarrier pair per stage.  Each consumer computes S = Q K^T with
// wgmma (both operands in shared memory), takes p = exp(min(s * scale, 75))
// and its row sums in registers, and feeds bf16(p) straight from registers as
// the A operand of O += P V (V read transposed from shared memory): S and P
// never touch shared memory.  The clamp makes every p final, so nothing is
// rescaled between tiles.  The two warpgroups take turns to issue their
// products (named barriers), so one warpgroup's exps run under the other's
// products, and within a warpgroup the exps of tile t run under the P V
// product of tile t - 1.  A last tile that reaches past Nk is zero-filled by
// TMA and its p set to 0 there; o is staged in shared memory and written by
// a TMA store, which clips a ragged last query tile.
//
// Variants (timing probes, off the main path).  flash_fwd_kernel is a
// template on a Variant: the exp (fp32 __expf as built, bf16x2 on the SFU, or
// the identity), the clamp at 75, the lse store, and the query rows a block
// (128 as built, or 256: four consumer warpgroups that take turns in two
// pairs).  They replace the K1 variants of scripts/tpu_r3_attnprobe2.py
// (make_kernel: no lse, clamp optional, exp on bf16(s) with an fp32 row sum),
// scripts/tpu_r5_headpack.py (_kernel: use_exp=False makes p = min(s, 75), wrong
// math on purpose, to time the exp's share) and scripts/tpu_r5_attn_ab.py
// (_kernel, _kernel_nolse).  lr_flash_fwd runs AsBuilt, K1 itself;
// lr_flash_fwd_variant runs the few combinations those scripts time and
// refuses any other.  The scripts' 512-row
// block has no counterpart: eight 64-row consumer warpgroups and a producer
// would be 1056 threads, past the block limit of 1024.
#include "common.cuh"
#include "sm90.cuh"

#include <float.h>

namespace lr {
namespace {

using namespace sm90;

constexpr int STAGES = 3;
constexpr float CLAMP = 75.0f;
constexpr float LOG2E = 1.4426950408889634f;

// how a variant takes p from a score x = min(s * scale, 75)
enum ExpMode : int { EXP_F32 = 0, EXP_BF16 = 1, EXP_IDENTITY = 2 };

template <int Exp, bool Clamp, bool Lse, int Rows>
struct Variant {
  static constexpr int exp = Exp;
  static constexpr bool clamp = Clamp;
  static constexpr bool lse = Lse;
  static constexpr int rows = Rows;                   // query rows per block: 128 or 256
  static constexpr int warpgroups = Rows / 64;        // consumer warpgroups of 64 rows
  static constexpr int consumers = 128 * warpgroups;  // their threads
  static constexpr int threads = consumers + 32;      // and the producer warp
};
using AsBuilt = Variant<EXP_F32, true, true, 128>;

// one number for a variant's fields (the probes' entry points switch on it)
constexpr int variant_key(int exp, bool clamp, bool lse, int rows) {
  return exp < 0 || exp > 2 ? -1 : exp | (clamp ? 4 : 0) | (lse ? 8 : 0) | rows << 4;
}

template <int D, int BQ = 128>
struct Flash {
  static constexpr int BK = D == 64 ? 128 : 64;  // keys per K/V tile
  static constexpr int CH = D / 64;              // 128-byte column boxes per row
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // K (or V) of one tile
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;
};

// S = Q K^T for one tile: Q [64 rows of this warpgroup] and K [BK keys], both
// K-major, D / 16 steps of 16 head-dim values (a 128-byte column box holds 4).
template <int D, int BK, int BQ>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], const unsigned char* Qw, const unsigned char* K) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<BK>::ss(s, desc_sw128(Qw + (kk / 4) * BQ * 128 + (kk % 4) * 32, 16, 1024),
                  desc_sw128(K + (kk / 4) * BK * 128 + (kk % 4) * 32, 16, 1024), kk > 0);
}

// O += P V for one tile: P from registers, V [BK keys][D] read transposed,
// BK / 16 steps of 16 keys (2048 bytes of V each); a second 64-column box of
// V (D = 128) lies BK * 128 bytes on.
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4], const unsigned char* V) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) Wgmma<D>::rs(o, p[kk], desc_sw128(V + kk * 2048, BK * 128, 1024));
}

// 2^x for two bf16 values in one SFU operation, flushed to zero below FLT_MIN.
__device__ __forceinline__ uint32_t ex2_bf16x2(uint32_t x) {
  uint32_t y;
  asm("ex2.approx.ftz.bf16x2 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

// p = exp(min(s * scale, 75)) in place (Masked: 0 for keys at or past
// `valid`, the last tile's tail); the row sums of rows g (l0) and g + 8 (l1)
// take p in fp32.  The variants: no clamp; the identity, p = min(s * scale,
// 75); or bf16: each pair of neighbouring scores, 2^(x log2 e) rounded to
// bf16 and exponentiated by one ex2.bf16x2, the word kept in s[i] of the
// pair's first (the P V fragment as it is) and the sums taking float(p).
template <class V, int BK, bool Masked>
__device__ __forceinline__ void exp_tile(float (&s)[BK / 2], float scale, int valid, float& l0, float& l1) {
  const int lane = threadIdx.x % 32;
  if constexpr (V::exp == EXP_BF16) {
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2) {
      const int col = 8 * (i / 4) + 2 * (lane % 4);
      float x0 = s[i] * scale, x1 = s[i + 1] * scale;
      if constexpr (V::clamp) {
        x0 = fminf(x0, CLAMP);
        x1 = fminf(x1, CLAMP);
      }
      uint32_t p = ex2_bf16x2(pack_bf16(x0 * LOG2E, x1 * LOG2E));
      if (Masked) p &= (col < valid ? 0x0000ffffu : 0u) | (col + 1 < valid ? 0xffff0000u : 0u);
      const float sum = __uint_as_float(p << 16) + __uint_as_float(p & 0xffff0000u);
      if ((i / 2) % 2)
        l1 += sum;
      else
        l0 += sum;
      s[i] = __uint_as_float(p);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int col = 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
      if constexpr (V::exp == EXP_F32 && V::clamp)
        s[i] = __expf(fminf(s[i] * scale, CLAMP));
      else if constexpr (V::exp == EXP_F32)
        s[i] = __expf(s[i] * scale);
      else if constexpr (V::clamp)
        s[i] = fminf(s[i] * scale, CLAMP);
      else
        s[i] = s[i] * scale;
      if (Masked && col >= valid) s[i] = 0.0f;
      if ((i / 2) % 2)
        l1 += s[i];
      else
        l0 += s[i];
    }
  }
}

// p of a tile with `valid` keys inside Nk: only a last tile that reaches
// past Nk pays for the mask.
template <class V, int BK>
__device__ __forceinline__ void exp_p(float (&s)[BK / 2], float scale, int valid, float& l0, float& l1) {
  if (valid < BK)
    exp_tile<V, BK, true>(s, scale, valid, l0, l1);
  else
    exp_tile<V, BK, false>(s, scale, BK, l0, l1);
}

// bf16(p) as the A fragments of the P V product (the bf16 variant's words are
// packed already).
template <class V, int BK>
__device__ __forceinline__ void pack_p(uint32_t (&f)[BK / 16][4], const float (&s)[BK / 2]) {
  if constexpr (V::exp == EXP_BF16) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) f[kk][j] = __float_as_uint(s[8 * kk + 2 * j]);
  } else {
    pack_frags<BK>(f, s);
  }
}

// The turn protocol's named barriers (see the consumers): warpgroups 2p and
// 2p + 1 form pair p and take turns on barriers 1 + 2p (the first's turn,
// which the second opens) and 2 + 2p; the epilogue's barrier of warpgroup w
// is 1 + warpgroups + w.
struct Turns {
  int mine, next, open;
  bool first, second;
};

template <class V>
__device__ __forceinline__ Turns turns(int wg) {
  if constexpr (V::warpgroups == 2) {
    return {1 + wg, 2 - wg, 1, wg == 0, wg == 1};
  } else {
    const int pair = wg / 2, second = wg % 2;
    return {1 + 2 * pair + second, 2 + 2 * pair - second, 1 + 2 * pair, second == 0, second == 1};
  }
}

template <int D, class V>
__global__ void __launch_bounds__(V::threads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                     float* __restrict__ lse, int heads, int nq, int nk, float scale) {
  constexpr int BQ = V::rows, CONSUMERS = V::consumers;
  using F = Flash<D, BQ>;
  constexpr int BK = F::BK, CH = F::CH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);  // CH boxes of [BQ rows][64]
  unsigned char* ring = Qs + F::Q_BYTES;    // per stage: CH K boxes, then CH V boxes, [BK rows][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * F::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, b = bh / heads, h = bh - b * heads;
  const int q0 = blockIdx.x * BQ;
  const int ntiles = (nk + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, F::Q_BYTES);
      for (int c = 0; c < CH; ++c) tma_load_4d(Qs + c * BQ * 128, &qmap, qbar, 64 * c, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * F::STAGE_BYTES;
        mbar_expect_tx(&full[s], F::STAGE_BYTES);
        for (int c = 0; c < CH; ++c) tma_load_4d(st + c * BK * 128, &kmap, &full[s], 64 * c, h, t * BK, b);
        for (int c = 0; c < CH; ++c)
          tma_load_4d(st + F::KV_BYTES + c * BK * 128, &vmap, &full[s], 64 * c, h, t * BK, b);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----------
  const int wg = warp / 4;
  const Turns turn = turns<V>(wg);
  const int my_turn = turn.mine, next_turn = turn.next;
  const unsigned char* Qw = Qs + wg * 64 * 128;
  float s[BK / 2];       // scores, then p, of one tile
  uint32_t p[BK / 16][4];  // bf16(p) as the A fragments of the P V product
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of the row sums (rows g and g + 8)

  auto stage = [&](int t) { return ring + (t % STAGES) * F::STAGE_BYTES; };
  // the turn protocol: in each pair of warpgroups (the only pair at 128 rows)
  // the first issues its products after bar_sync(my_turn) and hands the turn
  // over with bar_arrive(next_turn), and so does the second; the second
  // opens, and skips its last hand-over, so both barriers end complete
  if (turn.second) bar_arrive(turn.open, 256);

  mbar_wait(qbar, 0);
  mbar_wait(&full[0], 0);
  bar_sync(my_turn, 256);
  wgmma_fence();
  issue_s<D, BK, BQ>(s, Qw, stage(0));
  wgmma_commit();
  if (turn.first || ntiles > 1) bar_arrive(next_turn, 256);
  wgmma_wait<0>();
  fence_regs(s);
  exp_p<V, BK>(s, scale, nk, l0, l1);
  pack_p<V, BK>(p, s);

  for (int t = 1; t < ntiles; ++t) {
    mbar_wait(&full[t % STAGES], (t / STAGES) & 1);
    bar_sync(my_turn, 256);
    wgmma_fence();
    issue_s<D, BK, BQ>(s, Qw, stage(t));
    wgmma_commit();
    issue_pv<D, BK>(o, p, stage(t - 1) + F::KV_BYTES);
    wgmma_commit();
    if (turn.first || t < ntiles - 1) bar_arrive(next_turn, 256);
    wgmma_wait<1>();  // S of tile t is in; P V of tile t - 1 runs on
    fence_regs(s);
    exp_p<V, BK>(s, scale, nk - t * BK, l0, l1);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(p[kk]);  // the product has read them
    if (lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    pack_p<V, BK>(p, s);
  }
  wgmma_fence();
  issue_pv<D, BK>(o, p, stage(ntiles - 1) + F::KV_BYTES);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // ---- epilogue: o = acc / max(l, FLT_MIN), lse = log of that -------------
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, FLT_MIN);
  l1 = fmaxf(l1, FLT_MIN);
  // o goes through this warpgroup's rows of the Q tile (its products are
  // done with them) in the same swizzled layout, then out by TMA
  unsigned char* Ow = Qs + wg * 64 * 128;
  const int r0 = (warp % 4) * 16 + lane / 4;  // row g of the warpgroup's 64; g + 8 is r0 + 8
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = r0 + 8 * half;
      const float l = half ? l1 : l0;
      *reinterpret_cast<uint32_t*>(Ow + (n / 8) * BQ * 128 + r * 128 + (((n % 8) ^ (r % 8)) * 16) +
                                   (lane % 4) * 4) = pack_bf16(o[4 * n + 2 * half] / l, o[4 * n + 2 * half + 1] / l);
    }
  }
  fence_proxy_async();
  bar_sync(1 + V::warpgroups + wg, 128);
  if (warp % 4 == 0 && lane == 0) {
    for (int c = 0; c < CH; ++c) tma_store_4d(&omap, Ow + c * BQ * 128, 64 * c, h, q0 + wg * 64, b);
    tma_store_wait();
  }
  if (V::lse && lane % 4 == 0) {
    const int row = q0 + wg * 64 + r0;
    if (row < nq) lse[size_t(bh) * nq + row] = logf(l0);
    if (row + 8 < nq) lse[size_t(bh) * nq + row + 8] = logf(l1);
  }
}

template <int D, class V = AsBuilt>
int launch(const void* q, const void* k, const void* v, void* o, void* lse, int batch, int heads, int nq, int nk,
           float scale, cudaStream_t stream) {
  using F = Flash<D, V::rows>;
  CUtensorMap qm, km, vm, om;
  cudaError_t e = packed_map(&qm, q, D, batch, heads, nq, V::rows);
  if (e == cudaSuccess) e = packed_map(&km, k, D, batch, heads, nk, F::BK);
  if (e == cudaSuccess) e = packed_map(&vm, v, D, batch, heads, nk, F::BK);
  if (e == cudaSuccess) e = packed_map(&om, o, D, batch, heads, nq, 64);
  if (e == cudaSuccess) e = allow_smem(flash_fwd_kernel<D, V>, F::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((nq + V::rows - 1) / V::rows, batch * heads);
  flash_fwd_kernel<D, V><<<grid, V::threads, F::SMEM, stream>>>(qm, km, vm, om, static_cast<float*>(lse), heads,
                                                                  nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace lr

// q, o: [batch, nq, heads*d], k, v: [batch, nk, heads*d], bf16 contiguous (the
// packed projection layout: no head transpose is materialized); lse: [batch*heads, nq]
// fp32.  nq and nk must be positive multiples of 64, d is 64 or 128.
extern "C" int lr_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int batch, int heads, int nq, int nk, int d, float scale,
                            void* stream) {
  if (nq <= 0 || nk <= 0 || nq % 64 || nk % 64 || batch <= 0 || heads <= 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return lr::launch<64>(q, k, v, o, lse, batch, heads, nq, nk, scale, s);
  if (d == 128) return lr::launch<128>(q, k, v, o, lse, batch, heads, nq, nk, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The variants built for the timing probes (exp, clamp, lse store, query
// rows a block), the one list of them: lr_flash_fwd_variant launches these
// and lr_flash_fwd_variant_built reports them.
#define LR_VARIANTS(X)                                                           \
  X(EXP_F32, true, true, 128)   /* as built: tpu_r5_attn_ab.py's probe at 128 */ \
  X(EXP_F32, true, true, 256)   /* attn_ab's probe, tpu_r5_headpack.py's full */ \
  X(EXP_F32, true, false, 128)  /* tpu_r3_attnprobe2.py's baseline; no-lse */    \
  X(EXP_F32, true, false, 256)  /* attn_ab's probe-nolse; attnprobe2's blk256 */ \
  X(EXP_F32, false, false, 128) /* attnprobe2's no-clamp */                      \
  X(EXP_BF16, true, false, 128) /* attnprobe2's bf16 exp */                      \
  X(EXP_BF16, true, false, 256) /* attnprobe2's bf16 exp at blk256 */            \
  X(EXP_IDENTITY, true, true, 256) /* headpack's noexp */

// A variant of the kernel (timing probes), on the arguments of lr_flash_fwd at
// d = 64: exp 0 fp32, 1 bf16, 2 identity; clamp and lse_store 0 or 1 (lse may
// be null without the store); rows, query rows a block, 128 or 256.  Only
// LR_VARIANTS are built; any other combination returns cudaErrorNotSupported.
extern "C" int lr_flash_fwd_variant(const void* q, const void* k, const void* v, void* o, void* lse,
                                    int batch, int heads, int nq, int nk, int d, float scale, int exp,
                                    int clamp, int lse_store, int rows, void* stream) {
  using namespace lr;
  if (nq <= 0 || nk <= 0 || nq % 64 || nk % 64 || batch <= 0 || heads <= 0 || batch * heads > 65535 || d != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (variant_key(exp, clamp != 0, lse_store != 0, rows)) {
#define LR_CASE(e, c, l, r)     \
  case variant_key(e, c, l, r): \
    return launch<64, Variant<e, c, l, r>>(q, k, v, o, lse, batch, heads, nq, nk, scale, s);
    LR_VARIANTS(LR_CASE)
#undef LR_CASE
    default:
      return static_cast<int>(cudaErrorNotSupported);
  }
}

// 1 if lr_flash_fwd_variant is built for (exp, clamp, lse_store, rows), else 0.
extern "C" int lr_flash_fwd_variant_built(int exp, int clamp, int lse_store, int rows) {
  using namespace lr;
  switch (variant_key(exp, clamp != 0, lse_store != 0, rows)) {
#define LR_CASE(e, c, l, r) case variant_key(e, c, l, r):
    LR_VARIANTS(LR_CASE)
#undef LR_CASE
    return 1;
    default:
      return 0;
  }
}

// The dynamic shared memory of one block at head dim d (64 or 128), bytes; -1 otherwise.
extern "C" int lr_flash_fwd_smem(int d) {
  return d == 64 ? int(lr::Flash<64>::SMEM) : d == 128 ? int(lr::Flash<128>::SMEM) : -1;
}

// The dynamic shared memory of one variant block of `rows` query rows (128
// or 256) at d = 64, bytes; -1 otherwise.
extern "C" int lr_flash_fwd_variant_smem(int rows) {
  return rows == 128 ? int(lr::Flash<64, 128>::SMEM) : rows == 256 ? int(lr::Flash<64, 256>::SMEM) : -1;
}

extern "C" const char* lr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
