// K3: fused GEGLU feed-forward, bf16 in/out, fp32 accumulation.
//
// Replaces leftrefill_tpu/ops/mlp.py:_geglu_kernel (launched by _geglu_pallas).
// With the weights in torch's Linear layout (W1 [2I, din], W2 [dout, I]):
//   v = x.W1[c]^T + b1[c],  g = x.W1[I + c]^T + b1[I + c]   (fp32 sums of bf16 products)
//   h = bf16(v * gelu(g))   (exact erf via erff, not the TPU kernel's A&S polynomial)
//   out = bf16(sum_c h[c] W2[:, c]^T + b2)   (one fp32 sum over the whole inner dimension)
//
// What bounds it on the H100: 2 R din 2I + 2 R I dout flops against a few
// bytes a row: at the UNet's widths (din = dout = 320..1280, I = 4 din) the
// tensor cores, far above the ~295 flop/byte ridge.
//
// Design (csrc/geglu.cuh: wgmma + TMA, warp-specialised, two kernels).  The
// TPU kernel keeps a [rows, dout] fp32 accumulator in VMEM across the inner
// chunks; on the H100 a 128-row tile of it at dout 1280 (640 KB) fits
// neither shared memory nor registers, and fewer rows fall under wgmma's 64.
// So h goes through device memory once, in bf16 (2 R I bytes written and
// read: ~0.74 GB a 1-reference forward, mostly from L2):
// - up (geglu_up_kernel): a block owns 128 rows x 128 inner columns; per 64-
//   wide K step of din, two m64n128k16 products per warpgroup, v and g, so a
//   thread holds v and g of the same (row, column) in registers; the bias,
//   GELU and product run there, pack to bf16 into a swizzled tile, and leave
//   by a TMA store to h [R, I];
// - down (geglu_down_kernel<BN>): a block owns 128 rows x BN (160, 128 or 64)
//   output columns and sums h.W2^T over all of I in fp32 registers, in order;
//   + b2, one cast.  Where the rows give fewer than a wave of blocks (the
//   1024- and 256-row levels) the plan takes narrower column tiles.
#include "geglu.cuh"

namespace lr {
namespace {

using namespace geglu;

__global__ void __launch_bounds__(NTHREADS, 1)
    geglu_up_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                    const __grid_constant__ CUtensorMap hmap, const float* __restrict__ b1, int din, int inner) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: x [128][64], W1 value [128][64], W1 gate [128][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * UP_STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int c0 = blockIdx.x * BI, r0 = blockIdx.y * BM;
  const int nk = din / 64;
  init_ring(full, empty);

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues the copies
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) produce_up(ring, full, empty, &xmap, &w1map, r0, c0, inner, nk, 64);
    return;
  }

  // ---- consumers: warpgroup wg owns rows r0 + 64 wg .. + 63 -----------------
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  float v[BI / 2], g[BI / 2];
#pragma unroll
  for (int i = 0; i < BI / 2; ++i) v[i] = g[i] = 0.0f;
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const unsigned char* st = ring + s * UP_STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t a = desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024);
      Wgmma<BI>::ss(v, a, desc_sw128(st + TILE + kk * 32, 16, 1024), 1);
      Wgmma<BI>::ss(g, a, desc_sw128(st + 2 * TILE + kk * 32, 16, 1024), 1);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(v);
  fence_regs(g);

  // ---- epilogue: h = bf16(v * gelu(g)) into two swizzled [128][64] boxes ----
  bar_sync(1, CONSUMERS);  // both warpgroups are done reading the ring
  const int row = wg * 64 + acc_row();
#pragma unroll
  for (int n = 0; n < BI / 8; ++n) {
    const int col = acc_col(4 * n);
    const float2 bv = *reinterpret_cast<const float2*>(b1 + c0 + col);
    const float2 bg = *reinterpret_cast<const float2*>(b1 + inner + c0 + col);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = 4 * n + 2 * half, r = row + 8 * half;
      float h[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float gate = g[i + j] + (j ? bg.y : bg.x);
        h[j] = (v[i + j] + (j ? bv.y : bv.x)) * (0.5f * gate * (1.0f + erff(gate * 0.70710678118654752f)));
      }
      *reinterpret_cast<uint32_t*>(ring + (n / 8) * TILE + r * 128 + (((n % 8) ^ (r % 8)) * 16) + (lane % 4) * 4) =
          pack_bf16(h[0], h[1]);
    }
  }
  fence_proxy_async();
  bar_sync(2 + wg, 128);
  if (warp % 4 == 0 && lane == 0) {
    for (int b = 0; b < BI / 64; ++b) tma_store_2d(&hmap, ring + b * TILE + wg * 64 * 128, c0 + 64 * b, r0 + wg * 64);
    tma_store_wait();
  }
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    geglu_down_kernel(const __grid_constant__ CUtensorMap hmap, const __grid_constant__ CUtensorMap w2map,
                      const float* __restrict__ b2, bf16* __restrict__ out, int r, int inner, int dout) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: h [128][64], W2 [BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Down<BN>::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int nk = inner / 64;
  init_ring(full, empty);

  if (warp >= CONSUMERS / 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) produce_down<BN>(ring, full, empty, &hmap, &w2map, r0, n0, nk, 64);
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const unsigned char* st = ring + s * Down<BN>::STAGE;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                    desc_sw128(st + TILE + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  store_out<BN>(acc, b2, out, ring, r0, n0, r, dout);
}

unsigned long long up_granted = 0;

template <int BN>
cudaError_t launch_down(const CUtensorMap& hm, const void* w2, const float* b2, bf16* out, int r, int inner, int dout,
                        cudaStream_t stream) {
  static unsigned long long granted = 0;
  CUtensorMap wm;
  cudaError_t e = matrix_map(&wm, w2, dout, inner, 2, 64, BN);
  if (e == cudaSuccess) e = grant_smem(geglu_down_kernel<BN>, Down<BN>::SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout + BN - 1) / BN, r / BM);
  geglu_down_kernel<BN><<<grid, NTHREADS, Down<BN>::SMEM, stream>>>(hm, wm, b2, out, r, inner, dout);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lr

// The output columns of a down block at this shape, or a negated CUDA error.
extern "C" int lr_geglu_tile(int r, int dout) {
  const int sms = lr::geglu::sm_count();
  return sms < 0 ? sms : lr::geglu::down_tile(r, dout, sms);
}

// The dynamic shared memory of one block, bytes: kernel 0 the up kernel
// (bn ignored), 1 the down kernel of `bn` output columns; -1 otherwise.
extern "C" int lr_geglu_smem(int kernel, int bn) {
  return kernel == 0 ? lr::geglu::UP_SMEM : kernel == 1 ? lr::geglu::down_smem(bn) : -1;
}

// x: [r, din] bf16; w1: [2*inner, din] bf16, rows packed [value | gate]; b1: [2*inner]
// fp32; w2: [dout, inner] bf16; b2: [dout] fp32; h: [r, inner] bf16 scratch; out:
// [r, dout] bf16.  All contiguous and 16-byte aligned; r % 128 == 0, din % 64 == 0,
// inner % 128 == 0, dout % 8 == 0.  Two launches on `stream`: up (x -> h), down (h -> out).
extern "C" int lr_geglu(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* h,
                        void* out, int r, int din, int inner, int dout, void* stream) {
  using namespace lr::geglu;
  if (r <= 0 || r % BM || din <= 0 || din % 64 || inner <= 0 || inner % BI || dout <= 0 || dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  CUtensorMap xm, w1m, hstore, hload;
  cudaError_t e = matrix_map(&xm, x, r, din, 2, 64, BM);
  if (e == cudaSuccess) e = matrix_map(&w1m, w1, 2 * inner, din, 2, 64, BI);
  if (e == cudaSuccess) e = matrix_map(&hstore, h, r, inner, 2, 64, 64);
  if (e == cudaSuccess) e = matrix_map(&hload, h, r, inner, 2, 64, BM);
  if (e == cudaSuccess) e = grant_smem(lr::geglu_up_kernel, UP_SMEM, lr::up_granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lr::geglu_up_kernel<<<dim3(inner / BI, r / BM), NTHREADS, UP_SMEM, s>>>(xm, w1m, hstore,
                                                                           static_cast<const float*>(b1), din, inner);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* bb = static_cast<const float*>(b2);
  lr::bf16* o = static_cast<lr::bf16*>(out);
  switch (down_tile(r, dout, sms)) {
    case 160: e = lr::launch_down<160>(hload, w2, bb, o, r, inner, dout, s); break;
    case 128: e = lr::launch_down<128>(hload, w2, bb, o, r, inner, dout, s); break;
    default: e = lr::launch_down<64>(hload, w2, bb, o, r, inner, dout, s); break;
  }
  return static_cast<int>(e);
}
