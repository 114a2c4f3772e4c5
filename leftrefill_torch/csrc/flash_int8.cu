// P1: attention forward with an int8 Q K^T (a timing probe, off the main path).
//
// Replaces scripts/tpu_r3_attnprobe.py:_flash_i8_kernel (launched by its
// flash_int8).  Per (batch * head) row block, from int8 rows qi, ki with
// per-row fp32 scales sq, sk (quantized outside the kernel, as the script
// did in XLA):
//   s = f32(qi . ki) * (sq * sk) * scale,  p = exp(min(s, 75)),
//   l = max(sum p, FLT_MIN);
// pv_int8 = 0: o = (bf16(p) . v) / l, v bf16;
// pv_int8 = 1: pq = clip(rint(p / l * 127), 0, 127) as int8 and
//   o = bf16(f32(pq . vq) * (1 / 127)), vq int8 (the caller multiplies by the
//   per-tensor v scale).
//
// What bounds it on the H100: the int8 Q K^T runs at twice the bf16 rate,
// so the products are 3 Nq Nk D bf16-equivalent flops (2 with pv_int8 at
// the int8 rate, but two passes over K, below), against one exp per score
// and, with pv_int8, one IEEE division and a rounding: at D = 64 the SM's
// elementwise work, not the tensor cores, sets its pace.
//
// Design (K1's, csrc/flash_fwd.cu: wgmma + TMA, warp-specialised).  A block
// owns 128 query rows of one (batch, head): two consumer warpgroups of 64
// rows, one producer warp streaming K tiles of 128 keys with their sk and
// the V tiles through a 4-stage TMA ring.  Int8 rows of D = 64 are 64 bytes,
// so Q and K are 64-byte swizzled (desc_sw64).  S = Qi Ki^T runs as
// wgmma m64n128k32 s32.s8.s8 from shared memory; the epilogue takes
// f32(s32) * (sq[row] * sk[col]) * scale in that order.
// pv_int8 = 0: bf16(p) feeds O += P V from registers as in K1.
// pv_int8 = 1: p / l needs the whole row's l first, which the TPU kernel had
// from its resident key row; a streaming kernel makes two passes over K:
// pass 1 sums the rows' p (no V is read), pass 2 recomputes S, quantizes
// p / l (IEEE division, then * 127, as the script) and runs O += Pq Vq as
// wgmma m64n64k32 s32.s8.s8 with Pq from registers.  An 8-bit product takes
// B K-major only, so the wrapper writes Vq^T [B*H, 64, Nk] (128-byte rows,
// 128-byte swizzle).  An int8 A register holds 4 consecutive k, where the S
// accumulator gives a thread 2 consecutive columns of each 8: instead of
// permuting bytes across lanes, the wrapper writes each 32-key chunk of Vq^T
// in the order the accumulator's bytes fall into the A fragment (position
// 16h + 4t + m holds key 16h + 2t + m for m < 2, 16h + 8 + 2t + m - 2
// otherwise: ops/probes.py vq_key_order), so each thread packs its own bytes.
// The two warpgroups take turns to issue their products as in K1; in pass 2
// (and with bf16 P V) the exps of tile t run under the P V of tile t - 1.
// Nq and Nk must be multiples of 128: no tile is ragged.
#include "common.cuh"
#include "sm90.cuh"

#include <float.h>

#include <type_traits>

namespace lr {
namespace {

using namespace sm90;

constexpr int D = 64;             // head dim
constexpr int BQ = 128;           // query rows per block
constexpr int BK = 128;           // keys per tile
constexpr int CONSUMERS = 256;    // two warpgroups of 64 rows
constexpr int NTHREADS = CONSUMERS + 32;
constexpr int STAGES = 4;
constexpr float CLAMP = 75.0f;

constexpr int Q_BYTES = BQ * D;      // int8 [BQ][64], 64-byte swizzle
constexpr int K_BYTES = BK * D;      // int8 [BK][64], 64-byte swizzle
constexpr int V_BYTES = BK * D * 2;  // bf16 V [BK][64], or int8 Vq^T [64][BK] (half of it), 128-byte swizzle
constexpr int SK_BYTES = BK * 4;     // fp32 sk of the tile's keys
constexpr int V_OFF = K_BYTES, SK_OFF = K_BYTES + V_BYTES;
constexpr int STAGE_BYTES = K_BYTES + V_BYTES + 1024;  // sk padded: each stage starts 1024-aligned
constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + (2 * STAGES + 1) * 8;

// S = Qi Ki^T for one tile: two k32 steps of 32 bytes within the 64-byte rows.
__device__ __forceinline__ void issue_s(int32_t (&s)[BK / 2], const unsigned char* Qw, const unsigned char* K) {
#pragma unroll
  for (int kk = 0; kk < D / 32; ++kk)
    WgmmaS8<BK>::ss(s, desc_sw64(Qw + kk * 32, 16, 512), desc_sw64(K + kk * 32, 16, 512), kk > 0);
}

// O += bf16(P) V: V [BK keys][64] read transposed, BK / 16 steps (K1's at D = 64).
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p)[BK / 16][4], const unsigned char* V) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) Wgmma<D>::rs(o, p[kk], desc_sw128(V + kk * 2048, BK * 128, 1024));
}

// O += Pq Vq: Vq^T [64][BK keys] K-major, BK / 32 steps of 32 bytes.
__device__ __forceinline__ void issue_pv(int32_t (&o)[D / 2], const uint32_t (&p)[BK / 32][4], const unsigned char* Vt) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) WgmmaS8<D>::rs(o, p[kk], desc_sw128(Vt + kk * 32, 16, 1024));
}

// p = exp(min(f32(s32) * (sq * sk) * scale, 75)) in place for rows g (sq0)
// and g + 8 (sq1), sk from the stage; Sum adds p to the row sums l0, l1.
template <bool Sum>
__device__ __forceinline__ void exp_tile(const int32_t (&si)[BK / 2], float (&p)[BK / 2], const float* sk, float sq0,
                                         float sq1, float scale, float& l0, float& l1) {
  const int lane = threadIdx.x % 32;
  const float2* sk2 = reinterpret_cast<const float2*>(sk);
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    const float2 k = sk2[4 * j + lane % 4];  // columns 8 j + 2 (lane % 4) and + 1
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      const float sq = e < 2 ? sq0 : sq1;
      const float x = __fmul_rn(__fmul_rn(static_cast<float>(si[i]), __fmul_rn(sq, e % 2 ? k.y : k.x)), scale);
      p[i] = __expf(fminf(x, CLAMP));
      if (Sum) {
        if (e < 2)
          l0 += p[i];
        else
          l1 += p[i];
      }
    }
  }
}

// clip(rint(p / l * 127), 0, 127) as one byte.
__device__ __forceinline__ uint32_t quant_p(float p, float l) {
  return static_cast<uint32_t>(min(max(__float2int_rn(__fmul_rn(__fdiv_rn(p, l), 127.0f)), 0), 127));
}

__device__ __forceinline__ uint32_t bytes4(float a, float b, float c, float d, float l) {
  return quant_p(a, l) | quant_p(b, l) << 8 | quant_p(c, l) << 16 | quant_p(d, l) << 24;
}

// Pq as the int8 A fragments of the P V product: chunk c (keys 32 c .. + 31)
// takes the accumulator's columns of its four 8-column groups, two a row in
// each, in the order Vq^T's keys were written (see the top).
__device__ __forceinline__ void pack_pq(uint32_t (&f)[BK / 32][4], const float (&p)[BK / 2], float l0, float l1) {
#pragma unroll
  for (int c = 0; c < BK / 32; ++c) {
    const float* q = p + 16 * c;
    f[c][0] = bytes4(q[0], q[1], q[4], q[5], l0);
    f[c][1] = bytes4(q[2], q[3], q[6], q[7], l1);
    f[c][2] = bytes4(q[8], q[9], q[12], q[13], l0);
    f[c][3] = bytes4(q[10], q[11], q[14], q[15], l1);
  }
}

__device__ __forceinline__ void row_sums(float& l0, float& l1) {
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, FLT_MIN);
  l1 = fmaxf(l1, FLT_MIN);
}

template <bool PV8>
__global__ void __launch_bounds__(NTHREADS, 1)
    flash_int8_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const float* __restrict__ sq,
                      const float* __restrict__ sk, bf16* __restrict__ out, int nq, int nk, float scale) {
  using Frag = std::conditional_t<PV8, uint32_t[BK / 32][4], uint32_t[BK / 16][4]>;
  using Acc = std::conditional_t<PV8, int32_t[D / 2], float[D / 2]>;
  constexpr int V_TILE = PV8 ? D * BK : V_BYTES;  // bytes of the V tile a pass-2 stage loads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);
  unsigned char* ring = Qs + Q_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int ntiles = nk / BK;
  const int total = PV8 ? 2 * ntiles : ntiles;  // ring iterations: pass 1 then pass 2 with pv_int8

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    mbar_init(qbar, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      mbar_expect_tx(qbar, Q_BYTES);
      tma_load_2d(Qs, &qmap, qbar, 0, bh * nq + q0);
      for (int it = 0; it < total; ++it) {
        const int s = it % STAGES, t = it % ntiles;
        const bool with_v = !PV8 || it >= ntiles;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], K_BYTES + SK_BYTES + (with_v ? V_TILE : 0));
        tma_load_2d(st, &kmap, &full[s], 0, bh * nk + t * BK);
        bulk_load(st + SK_OFF, sk + size_t(bh) * nk + t * BK, SK_BYTES, &full[s]);
        if (with_v) {
          if (PV8)
            tma_load_2d(st + V_OFF, &vmap, &full[s], t * BK, bh * D);
          else
            tma_load_2d(st + V_OFF, &vmap, &full[s], 0, bh * nk + t * BK);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63 ----------
  const int wg = warp / 4;
  const unsigned char* Qw = Qs + wg * 64 * D;
  const int r0 = (warp % 4) * 16 + lane / 4;  // row g of the warpgroup's 64; g + 8 is r0 + 8
  const size_t row = size_t(bh) * nq + q0 + wg * 64 + r0;
  const float sq0 = sq[row], sq1 = sq[row + 8];
  int32_t si[BK / 2];  // S of one tile
  float p[BK / 2];     // its p
  Frag f;              // P as the A fragments of the P V product
  Acc o;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0;
  float l0 = 0.0f, l1 = 0.0f;  // this thread's share of the row sums (rows g and g + 8)

  auto stage = [&](int it) { return ring + (it % STAGES) * STAGE_BYTES; };
  auto release = [&](int it) {
    if (lane == 0) mbar_arrive(&empty[it % STAGES]);
  };
  // the turn protocol of K1: warpgroup w issues its products after
  // bar_sync(1 + w) and hands the turn over with bar_arrive(2 - w) at each of
  // the `total` ring iterations; warpgroup 1 opens, and skips its last
  // hand-over, so both barriers end complete
  const int my_turn = 1 + wg, next_turn = 2 - wg;
  auto hand_over = [&](int it) {
    if (wg == 0 || it < total - 1) bar_arrive(next_turn, CONSUMERS);
  };
  if (wg == 1) bar_arrive(1, CONSUMERS);
  mbar_wait(qbar, 0);

  int it = 0;
  if constexpr (PV8) {  // pass 1: the row sums alone
    for (; it < ntiles; ++it) {
      mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
      bar_sync(my_turn, CONSUMERS);
      wgmma_fence();
      issue_s(si, Qw, stage(it));
      wgmma_commit();
      hand_over(it);
      wgmma_wait<0>();
      fence_regs(si);
      exp_tile<true>(si, p, reinterpret_cast<const float*>(stage(it) + SK_OFF), sq0, sq1, scale, l0, l1);
      release(it);
    }
    row_sums(l0, l1);
  }

  // the pass with P V: tile t's S and exps, under tile t - 1's product
  auto epilogue = [&](int i) {
    exp_tile<!PV8>(si, p, reinterpret_cast<const float*>(stage(i) + SK_OFF), sq0, sq1, scale, l0, l1);
  };
  auto pack = [&] {
    if constexpr (PV8)
      pack_pq(f, p, l0, l1);
    else
      pack_frags<BK>(f, p);
  };
  mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
  bar_sync(my_turn, CONSUMERS);
  wgmma_fence();
  issue_s(si, Qw, stage(it));
  wgmma_commit();
  hand_over(it);
  wgmma_wait<0>();
  fence_regs(si);
  epilogue(it);
  pack();
  for (++it; it < total; ++it) {
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    bar_sync(my_turn, CONSUMERS);
    wgmma_fence();
    issue_s(si, Qw, stage(it));
    wgmma_commit();
    issue_pv(o, f, stage(it - 1) + V_OFF);
    wgmma_commit();
    hand_over(it);
    wgmma_wait<1>();  // S of tile it is in; P V of tile it - 1 runs on
    fence_regs(si);
    epilogue(it);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < int(sizeof(Frag) / 16); ++kk) fence_regs(f[kk]);  // the product has read them
    release(it - 1);
    pack();
  }
  wgmma_fence();
  issue_pv(o, f, stage(total - 1) + V_OFF);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // ---- epilogue: o to bf16, straight to global memory ----------------------
  if constexpr (!PV8) row_sums(l0, l1);
  bf16* dst = out + row * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float a = static_cast<float>(o[4 * n + 2 * half]), b = static_cast<float>(o[4 * n + 2 * half + 1]);
      if constexpr (PV8) {
        a = __fmul_rn(a, 1.0f / 127.0f);
        b = __fmul_rn(b, 1.0f / 127.0f);
      } else {
        const float l = half ? l1 : l0;
        a /= l;
        b /= l;
      }
      *reinterpret_cast<uint32_t*>(dst + half * 8 * D + 8 * n + 2 * (lane % 4)) = pack_bf16(a, b);
    }
  }
}

template <bool PV8>
int launch(const void* q, const void* sq, const void* k, const void* sk, const void* v, void* o, int bh, int nq,
           int nk, float scale, cudaStream_t stream) {
  constexpr auto u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap qm, km, vm;
  cudaError_t e = matrix_map(&qm, q, bh * nq, D, 1, D, BQ, u8, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess) e = matrix_map(&km, k, bh * nk, D, 1, D, BK, u8, CU_TENSOR_MAP_SWIZZLE_64B);
  if (e == cudaSuccess)
    e = PV8 ? matrix_map(&vm, v, bh * D, nk, 1, BK, D, u8) : matrix_map(&vm, v, bh * nk, D, 2, D, BK);
  if (e == cudaSuccess) e = allow_smem(flash_int8_kernel<PV8>, SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(nq / BQ, bh);
  flash_int8_kernel<PV8><<<grid, NTHREADS, SMEM, stream>>>(qm, km, vm, static_cast<const float*>(sq),
                                                            static_cast<const float*>(sk), static_cast<bf16*>(o), nq,
                                                            nk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace lr

// q: int8 [bh, nq, 64], sq: fp32 [bh, nq], k: int8 [bh, nk, 64], sk: fp32
// [bh, nk]; v: bf16 [bh, nk, 64] (pv_int8 = 0) or int8 Vq^T [bh, 64, nk] with
// each 32-key chunk in the kernel's key order (pv_int8 = 1); o: bf16
// [bh, nq, 64].  nq and nk positive multiples of 128.
extern "C" int lr_flash_int8(const void* q, const void* sq, const void* k, const void* sk, const void* v, void* o,
                             int bh, int nq, int nk, float scale, int pv_int8, void* stream) {
  if (nq <= 0 || nk <= 0 || nq % 128 || nk % 128 || bh <= 0 || bh > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return pv_int8 ? lr::launch<true>(q, sq, k, sk, v, o, bh, nq, nk, scale, s)
                 : lr::launch<false>(q, sq, k, sk, v, o, bh, nq, nk, scale, s);
}

// The dynamic shared memory of one block (either mode), bytes.
extern "C" int lr_flash_int8_smem(int pv_int8) { return pv_int8 >= 0 ? int(lr::SMEM) : -1; }
