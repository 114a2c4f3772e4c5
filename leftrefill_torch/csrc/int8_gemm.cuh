// Shared int8 tensor-core machinery of KI1 (csrc/conv3x3_int8.cu) and KI2
// (csrc/dense_int8_res.cu).
//
// The products run on mma.sync.m16n8k32 with int8 operands and int32
// accumulators, so every sum is exact (the UNet's reach 9 * 2560 * 127^2,
// far beyond the 2^24 an fp32 sum keeps exact).  Operand tiles sit in shared
// memory with the K dimension contiguous ("row" A, "col" B): a fragment
// register is then one aligned 32-bit load of four consecutive int8 values.
// Rows are padded to 80 bytes (64 + 16), which keeps the 16-byte cp.async
// destinations aligned and the fragment loads free of bank conflicts.
//
// Fragment layouts of m16n8k32 (.s8), with g = lane / 4 and t = lane % 4:
//   A (16 x 32): a0 = row g,   k 4t..4t+3     a1 = row g+8, k 4t..4t+3
//                a2 = row g,   k 16+4t..      a3 = row g+8, k 16+4t..
//   B (32 x 8):  b0 = col g,   k 4t..4t+3     b1 = col g,   k 16+4t..
//   C (16 x 8):  c0, c1 = row g,   cols 2t, 2t+1
//                c2, c3 = row g+8, cols 2t, 2t+1
#pragma once

#include "common.cuh"

namespace lr {
namespace i8 {

constexpr int BK = 64;        // K bytes per pipeline step
constexpr int LDS = BK + 16;  // bytes per shared-memory row of a K-step tile

__device__ __forceinline__ unsigned ld32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

__device__ __forceinline__ void mma(int (&c)[4], const unsigned (&a)[4], const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16 rows starting at `rows` (row stride ld bytes), K offset k.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const int8_t* rows, int ld, int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = rows + g * ld + k + 4 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 16);
  a[3] = ld32(p + 8 * ld + 16);
}

// B fragment of the 8 columns (stored as rows, K contiguous) starting at `cols`.
__device__ __forceinline__ void load_b(unsigned (&b)[2], const int8_t* cols, int ld, int k) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int8_t* p = cols + g * ld + k + 4 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 16);
}

// ---------------------------------------------------------------------------
// The GEMM main loop of KI1 and KI2: a 128 x 128 output tile per block of 8
// warps (2 x 4, each warp 64 rows x 32 columns), K walked in 64-byte steps
// through a 3-stage cp.async ring.  The caller's loader fills one step's A
// rows and B columns; steps [s_begin, s_end) are this block's share of K
// (all of it, or one split of a split-K launch).

constexpr int BM = 128, BN = 128, STAGES = 3, NTHREADS = 256;
constexpr size_t TILE_BYTES = size_t(BM) * LDS;  // A and B tiles are the same size
constexpr size_t GEMM_SMEM = STAGES * 2 * TILE_BYTES;

using Acc = int[4][4][4];  // [m16 tile][n8 tile][fragment]

// How many ways an M x N GEMM of k_steps K steps splits K on the current
// device: doubled while the tiles times the splits stay under one wave over
// the SMs and each split keeps at least 4 K steps.  The wrappers ask for it
// (lr_*_splits) to size the int32 partials; a failed query returns the
// negated CUDA error.
inline int k_splits(int m, int n, int k_steps) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
  int s = 1;
  while (tiles * s < sms && k_steps >= 4 * 2 * s) s *= 2;
  return s;
}

// Loader: void operator()(int step, int8_t* A, int8_t* B) issuing the
// cp.async copies of one step (each thread: A rows tid/4 and tid/4 + 64,
// B rows the same, at byte column 16 * (tid % 4)).
template <class Loader>
__device__ __forceinline__ void gemm_mainloop(Acc& acc, const Loader& load, int s_begin, int s_end,
                                              int8_t* smem) {
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  auto A = [&](int stage) { return smem + stage * 2 * TILE_BYTES; };
  auto B = [&](int stage) { return smem + stage * 2 * TILE_BYTES + TILE_BYTES; };
  const int n = s_end - s_begin;
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load(s_begin + i, A(i), B(i));
    cp_async_commit();
  }
  for (int i = 0; i < n; ++i) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step i landed; every warp is done with step i - 1's stage
    const int nxt = i + STAGES - 1;
    if (nxt < n) load(s_begin + nxt, A(nxt % STAGES), B(nxt % STAGES));
    cp_async_commit();
    const int8_t* As = A(i % STAGES) + wm * 64 * LDS;
    const int8_t* Bs = B(i % STAGES) + wn * 32 * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int m = 0; m < 4; ++m) load_a(af[m], As + m * 16 * LDS, LDS, kk);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_b(bfr[j], Bs + j * 8 * LDS, LDS, kk);
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma(acc[m][j], af[m], bfr[j]);
    }
  }
  cp_async_wait<0>();
}

// Visit the accumulator with its output coordinates: f(row, col, value) for
// each element, row/col relative to the block's tile origin.
template <class F>
__device__ __forceinline__ void for_each_acc(const Acc& acc, F f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp >> 2, wn = warp & 3, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(wm * 64 + m * 16 + g + (e >> 1) * 8, wn * 32 + j * 8 + 2 * t + (e & 1), acc[m][j][e]);
}

}  // namespace i8
}  // namespace lr
