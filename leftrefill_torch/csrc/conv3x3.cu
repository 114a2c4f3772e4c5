// K2: 3x3, stride 1, pad 1 convolution, NHWC bf16 x OHWI bf16 -> NHWC bf16.
//
// Replaces leftrefill_tpu/ops/conv.py:_conv_kernel (sum9 taps, launched by
// _conv3x3_pallas).  out[p, co] = bias[co] + sum_{tap, ci} x[p + tap, ci] * w[co, tap, ci],
// accumulated in fp32, bias added in fp32, one cast to bf16 at the end.
//
// What bounds it on the H100: an implicit GEMM with M = B*H*W output pixels,
// N = Co and K = 9*Ci = 2880..23040 at the UNet's shapes, far above the ~295
// flop/byte ridge, so the tensor cores bound it; at the 16x32 level the whole
// GEMM is only 8 tiles of 128 pixels, so filling the 132 SMs is the other limit.
//
// Design (wgmma + TMA, warp-specialised).  A block owns a patch of 128 output
// pixels of one image (rows x cols = 1x128, 2x64, 4x32 or 8x16, following the
// width) by BN output channels, with two consumer warpgroups of 64 pixels
// and one producer warp.  K is walked as (tap, 64-channel slice) steps
// through a 4-stage ring.  The producer loads each step's A tile with one
// TMA box over x as a 4-D tensor (Ci, W, H, B) at the tap's shifted origin:
// TMA zero-fills whatever lies outside the image, negative coordinates and
// the channel tail included, so the pad-1 border and a Ci such as 960 or
// 1920 cost nothing.  B comes from a 3-D map over w as [Co][9][Ci], so a
// slice's channel tail is zero-filled rather than read from the next tap.
// Both are 128-byte swizzled and feed wgmma straight from shared memory; the
// fp32 accumulators stay in registers, the bias is added there, and the bf16
// tile is staged in the (then idle) ring and written with 16-byte stores.
// BN is 160, 128, 80 or 64 (wgmma's N), chosen per shape by the host so that
// the blocks fill the card with the fewest waves of the widest tile: at the
// 16x32 level 80-channel tiles give 128 blocks where 160 would give 64.
#include "common.cuh"
#include "sm90.cuh"

namespace lr {
namespace {

using namespace sm90;

constexpr int BM = 128;          // output pixels per block
constexpr int CONSUMERS = 256;   // two warpgroups of 64 pixels
constexpr int NTHREADS = CONSUMERS + 32;
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * 128;  // 128 pixels x 64 channels

template <int BN>
struct Conv {
  static constexpr int B_BYTES = BN * 128;  // BN output channels x 64 channels
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int LDC = BN + 8;  // bf16 row stride of the output staging tile
  static constexpr size_t SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(BM * LDC * 2 <= STAGES * STAGE_BYTES, "the output tile fits the ring");
};

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ bias, bf16* __restrict__ out, int h, int wd, int ci, int co,
                   int rows, int cols, int tiles_x, int tiles_y) {
  using C = Conv<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: A [128 pixels][64], then B [BN][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int x0 = tx * cols, y0 = ty * rows, n0 = blockIdx.y * BN;
  const int nci = (ci + 63) / 64, nsteps = 9 * nci;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      for (int ks = 0; ks < nsteps; ++ks) {
        const int s = ks % STAGES, tap = ks / nci, c0 = (ks - tap * nci) * 64;
        mbar_wait(&empty[s], ((ks / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(st, &xmap, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
        tma_load_3d(st + A_BYTES, &wmap, &full[s], c0, tap, n0);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of the patch -
  const int wg = warp / 4;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
  for (int ks = 0; ks < nsteps; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const unsigned char* st = ring + s * C::STAGE_BYTES;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                    desc_sw128(st + A_BYTES + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done with their stage
    if (ks > 0 && lane == 0) mbar_arrive(&empty[(ks - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // ---- epilogue: + bias in fp32, one cast, staged in the ring --------------
  bar_sync(1, CONSUMERS);  // both warpgroups are done reading the ring
  bf16* Cs = reinterpret_cast<bf16*>(ring);
  const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const float b0 = n0 + col < co ? bias[n0 + col] : 0.0f;
    const float b1 = n0 + col + 1 < co ? bias[n0 + col + 1] : 0.0f;
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<__nv_bfloat162*>(Cs + (r0 + 8 * half) * C::LDC + col) =
          __floats2bfloat162_rn(acc[4 * n + 2 * half] + b0, acc[4 * n + 2 * half + 1] + b1);
  }
  bar_sync(1, CONSUMERS);
  constexpr int CPR = BN / 8;  // 16-byte chunks per pixel
  for (int idx = tid; idx < BM * CPR; idx += CONSUMERS) {
    const int px = idx / CPR, g = idx - px * CPR;
    const int y = y0 + px / cols, x = x0 + px % cols;
    if (y < h && x < wd && n0 + 8 * g < co)
      *reinterpret_cast<uint4*>(out + ((size_t(b) * h + y) * wd + x) * co + n0 + 8 * g) =
          *reinterpret_cast<const uint4*>(Cs + px * C::LDC + 8 * g);
  }
}

// The launch plan: the pixel patch follows the width (cols = the power of two
// at or above W, at most 128), and the channel tile is the one among 160,
// 128, 80 (each where it divides Co) and 64 (masked at the edge) whose
// waves over the SMs times its width is least, the widest on a tie.
struct Plan {
  int bn, rows, cols, tiles_x, tiles_y;
};

Plan plan(int b, int h, int wd, int co, int sms) {
  Plan p{64, 0, 1, 0, 0};
  while (p.cols < wd && p.cols < BM) p.cols *= 2;
  p.rows = BM / p.cols;
  p.tiles_x = (wd + p.cols - 1) / p.cols;
  p.tiles_y = (h + p.rows - 1) / p.rows;
  const long long m_tiles = static_cast<long long>(b) * p.tiles_x * p.tiles_y;
  long long best = -1;
  for (int bn : {160, 128, 80, 64}) {
    if (co % bn && bn != 64) continue;
    const long long blocks = m_tiles * ((co + bn - 1) / bn);
    const long long cost = (blocks + sms - 1) / sms * bn;
    if (best < 0 || cost < best) {
      best = cost;
      p.bn = bn;
    }
  }
  return p;
}

// The SMs of the current device, or a negated CUDA error.
int sm_count() {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? sms : -static_cast<int>(e);
}

template <int BN>
cudaError_t launch(const CUtensorMap& xm, const void* w, const float* bias, bf16* out, int b, int h, int wd,
                   int ci, int co, const Plan& p, cudaStream_t stream) {
  const uint64_t dims[3] = {uint64_t(ci), 9, uint64_t(co)}, strides[2] = {uint64_t(ci) * 2, uint64_t(ci) * 18};
  const uint32_t box[3] = {64, 1, BN};
  CUtensorMap wm;
  cudaError_t e = encode_map(&wm, w, 3, dims, strides, box);
  if (e == cudaSuccess) e = allow_smem(conv3x3_kernel<BN>, Conv<BN>::SMEM);
  if (e != cudaSuccess) return e;
  dim3 grid(static_cast<unsigned>(static_cast<long long>(b) * p.tiles_x * p.tiles_y), (co + BN - 1) / BN);
  conv3x3_kernel<BN><<<grid, NTHREADS, Conv<BN>::SMEM, stream>>>(xm, wm, bias, out, h, wd, ci, co, p.rows, p.cols,
                                                                  p.tiles_x, p.tiles_y);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lr

// The output channels per block that lr_conv3x3 takes at this shape, or a
// negated CUDA error.
extern "C" int lr_conv3x3_tile(int b, int h, int wd, int co) {
  const int sms = lr::sm_count();
  return sms < 0 ? sms : lr::plan(b, h, wd, co, sms).bn;
}

// The dynamic shared memory of one block of `bn` output channels, bytes; -1
// for a width the kernel does not take.
extern "C" int lr_conv3x3_smem(int bn) {
  switch (bn) {
    case 160: return int(lr::Conv<160>::SMEM);
    case 128: return int(lr::Conv<128>::SMEM);
    case 80: return int(lr::Conv<80>::SMEM);
    case 64: return int(lr::Conv<64>::SMEM);
    default: return -1;
  }
}

// x: [b, h, w, ci] bf16, w: [co, 3, 3, ci] bf16, bias: [co] fp32, out: [b, h, w, co] bf16,
// all contiguous; ci and co multiples of 8.
extern "C" int lr_conv3x3(const void* x, const void* w, const void* bias, void* out, int b,
                          int h, int wd, int ci, int co, void* stream) {
  if (ci % 8 || co % 8 || ci <= 0 || co <= 0 || b <= 0 || h <= 0 || wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = lr::sm_count();
  if (sms < 0) return -sms;
  const lr::Plan p = lr::plan(b, h, wd, co, sms);
  const uint64_t dims[4] = {uint64_t(ci), uint64_t(wd), uint64_t(h), uint64_t(b)};
  const uint64_t strides[3] = {uint64_t(ci) * 2, uint64_t(ci) * wd * 2, uint64_t(ci) * wd * h * 2};
  const uint32_t box[4] = {64, static_cast<uint32_t>(p.cols), static_cast<uint32_t>(p.rows), 1};
  CUtensorMap xm;
  cudaError_t e = lr::sm90::encode_map(&xm, x, 4, dims, strides, box);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float* bi = static_cast<const float*>(bias);
  lr::bf16* o = static_cast<lr::bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 160: e = lr::launch<160>(xm, w, bi, o, b, h, wd, ci, co, p, s); break;
    case 128: e = lr::launch<128>(xm, w, bi, o, b, h, wd, ci, co, p, s); break;
    case 80: e = lr::launch<80>(xm, w, bi, o, b, h, wd, ci, co, p, s); break;
    default: e = lr::launch<64>(xm, w, bi, o, b, h, wd, ci, co, p, s); break;
  }
  return static_cast<int>(e);
}
