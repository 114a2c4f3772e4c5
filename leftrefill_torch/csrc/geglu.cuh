// The GEGLU kernels' shared frame (csrc/geglu.cu: K3 in bf16; csrc/geglu_int8.cu:
// KI3 in W8A8): a feed-forward out = (v * gelu(g)) . W2^T + b2 runs as two
// warp-specialised wgmma + TMA kernels,
// - "up": a block owns 128 rows x 128 inner columns and forms h (bf16, or
//   requantized int8 with its per-row scales) from the value and gate
//   products over din, then writes it to device memory by a TMA store;
// - "down": a block owns 128 rows x BN output columns and walks the whole
//   inner dimension over h and W2 in fp32 registers, in a fixed order, no
//   atomics (two launches give the same bits).
// Both have two consumer warpgroups of 64 rows and a producer warpgroup that
// hands its registers to them (setmaxnreg) and in which one thread streams
// the operand tiles through a 4-stage ring of full/empty mbarriers (the int8
// up kernel, persistent over thread clusters, has its own loop in
// csrc/geglu_int8.cu).  Every
// operand is K-major as torch lays it out (x [R, din], W1 [2I, din], h [R, I],
// W2 [dout, I]), so each tile is one TMA box of 128 rows (or BN) x 128 bytes,
// 128-byte swizzled (csrc/sm90.cuh).
#pragma once

#include "common.cuh"
#include "sm90.cuh"

namespace lr {
namespace geglu {

using namespace sm90;

constexpr int BM = 128;                    // rows a block owns
constexpr int BI = 128;                    // inner columns an up block owns
constexpr int CONSUMERS = 256;             // two warpgroups of 64 rows
constexpr int NTHREADS = CONSUMERS + 128;  // and a producer warpgroup
// 128 x 40 + 256 x 232 of the SM's 65536 registers (168 a thread at launch)
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int STAGES = 4;
constexpr int TILE = BM * 128;  // bytes of a [128 rows][128 bytes] operand tile
// up: per stage the x tile, then the value and the gate rows of W1
constexpr int UP_STAGE = 3 * TILE;
constexpr int BARRIERS = 2 * STAGES * 8;
constexpr int UP_SMEM = 1024 + STAGES * UP_STAGE + BARRIERS;

// down: per stage the h tile [128 rows], then W2's [BN rows]; the bf16 output
// tile is staged in the ring (then idle) with rows of BN + 8 values
template <int BN>
struct Down {
  static constexpr int STAGE = TILE + BN * 128;
  static constexpr int SMEM = 1024 + STAGES * STAGE + BARRIERS;
  static constexpr int LDC = BN + 8;
  static_assert(STAGE % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(BM * LDC * 2 <= STAGES * STAGE, "the output tile fits the ring");
};

// The output columns of a down block at this shape: among 160 and 128 (each
// where it divides dout) and 64 (masked at the edge), the one whose waves
// over the SMs times its width is least, the widest on a tie (K2's rule:
// narrower tiles where the rows alone give too few blocks).
inline int down_tile(int r, int dout, int sms) {
  const long long row_tiles = (r + BM - 1) / BM;
  int bn = 64;
  long long best = -1;
  for (int cand : {160, 128, 64}) {
    if (dout % cand && cand != 64) continue;
    const long long blocks = row_tiles * ((dout + cand - 1) / cand);
    const long long cost = (blocks + sms - 1) / sms * cand;
    if (best < 0 || cost < best) {
      best = cost;
      bn = cand;
    }
  }
  return bn;
}

inline int down_smem(int bn) {
  switch (bn) {
    case 160: return Down<160>::SMEM;
    case 128: return Down<128>::SMEM;
    case 64: return Down<64>::SMEM;
    default: return -1;
  }
}

// The SMs of the current device, or a negated CUDA error.
inline int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? sms : -static_cast<int>(e);
}

// allow_smem once per kernel and device (the wrappers' host time counts: a
// request launches ~1660 kernels a forward).
template <typename K>
cudaError_t grant_smem(K kernel, int bytes, unsigned long long& granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && (granted >> dev) & 1)) return e;
  e = allow_smem(kernel, bytes);
  if (e == cudaSuccess && dev < 64) granted |= 1ull << dev;
  return e;
}

__device__ __forceinline__ void init_ring(uint64_t* full, uint64_t* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();
}

// Row of this thread's accumulator entries d[i] within its warpgroup's 64
// (the second of its two rows is 8 further on: entries with (i / 2) % 2).
__device__ __forceinline__ int acc_row() { return (threadIdx.x / 32 % 4) * 16 + threadIdx.x % 32 / 4; }

// Column of accumulator entry i within the tile.
__device__ __forceinline__ int acc_col(int i) { return 8 * (i / 4) + 2 * (threadIdx.x % 4) + i % 2; }

// The down block's epilogue: out = bf16(acc + b2) (one fp32 add, rounded to
// nearest), staged in the ring with rows of BN + 8 values and written with
// 16-byte stores, columns past dout left out.
template <int BN>
__device__ __forceinline__ void store_out(const float (&acc)[BN / 2], const float* __restrict__ b2,
                                          bf16* __restrict__ out, unsigned char* ring, int r0, int n0, int r,
                                          int dout) {
  const int wg = threadIdx.x / 128;
  bar_sync(1, CONSUMERS);  // both warpgroups are done reading the ring
  bf16* Cs = reinterpret_cast<bf16*>(ring);
  const int row = wg * 64 + acc_row();
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = 8 * n + 2 * (threadIdx.x % 4);
    const bool in = n0 + col < dout;  // dout % 8 == 0: a pair is in or out together
    const float2 b = in ? *reinterpret_cast<const float2*>(b2 + n0 + col) : make_float2(0.0f, 0.0f);
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(Cs + (row + 8 * half) * Down<BN>::LDC + col) = __floats2bfloat162_rn(
          __fadd_rn(acc[4 * n + 2 * half], b.x), __fadd_rn(acc[4 * n + 2 * half + 1], b.y));
  }
  bar_sync(1, CONSUMERS);
  constexpr int CPR = BN / 8;  // 16-byte chunks a row
  for (int idx = threadIdx.x; idx < BM * CPR; idx += CONSUMERS) {
    const int px = idx / CPR, g = idx - px * CPR;
    if (r0 + px < r && n0 + 8 * g < dout)
      *reinterpret_cast<uint4*>(out + size_t(r0 + px) * dout + n0 + 8 * g) =
          *reinterpret_cast<const uint4*>(Cs + px * Down<BN>::LDC + 8 * g);
  }
}

// The producer of a down block: per K step the h tile (rows r0..) and W2's
// BN rows n0.., both 128 bytes of K wide.
template <int BN>
__device__ __forceinline__ void produce_down(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                             const CUtensorMap* hmap, const CUtensorMap* w2map, int r0, int n0,
                                             int nk, int k_elems) {
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
    unsigned char* st = ring + s * Down<BN>::STAGE;
    mbar_expect_tx(&full[s], Down<BN>::STAGE);
    tma_load_2d(st, hmap, &full[s], ks * k_elems, r0);
    tma_load_2d(st + TILE, w2map, &full[s], ks * k_elems, n0);
  }
}

// The producer of an up block: per K step the x tile (rows r0..) and W1's
// value rows c0.. and gate rows inner + c0...
__device__ __forceinline__ void produce_up(unsigned char* ring, uint64_t* full, uint64_t* empty,
                                           const CUtensorMap* xmap, const CUtensorMap* w1map, int r0, int c0,
                                           int inner, int nk, int k_elems) {
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
    unsigned char* st = ring + s * UP_STAGE;
    mbar_expect_tx(&full[s], UP_STAGE);
    tma_load_2d(st, xmap, &full[s], ks * k_elems, r0);
    tma_load_2d(st + TILE, w1map, &full[s], ks * k_elems, c0);
    tma_load_2d(st + 2 * TILE, w1map, &full[s], ks * k_elems, inner + c0);
  }
}

}  // namespace geglu
}  // namespace lr
