// KI1: W8A8 3x3, stride 1, pad 1 convolution, NHWC int8 x OHWI int8 -> NHWC bf16
// (or fp32, for a model that computes in fp32).
//
// Replaces leftrefill_tpu/ops/quant.py:_conv_int8_kernel (K5, three
// column-shifted copies) and :_conv_int8_single_kernel (K6, one padded slab):
// the two compute the same function and differ only in TPU VMEM blocking.
// out[p, co] = float(acc) * scale[co] + bias[co], cast once to the output type, with
// acc = sum_{tap, ci} xq[p + tap, ci] * w[co, tap, ci] in int32 and
// scale = s_x * s_w[co] (the caller's fp32 product), as the TPU epilogue.
// The multiply and the add are separately rounded (no FMA contraction), so
// the result equals the plain version's element for element.
//
// What bounds it on the H100: an implicit GEMM with M = B*H*W output pixels,
// N = Co and K = 9*Ci = 2880..23040, far above the int8 ridge (~590
// operations a byte), so the int8 tensor cores bound it; at the 16x32 and
// 8x16 levels (M = 1024, 256) the output tiles alone give 16-64 blocks for
// 132 SMs, and the 8x16 level is bound by its weight bytes (14.7 MB a
// 1280 -> 1280 launch).
//
// Design (wgmma + TMA, warp-specialised: K2's, csrc/conv3x3.cu, in int8).
// A block owns a patch of 128 output pixels of one image (rows x cols =
// 1x128, 2x64, 4x32 or 8x16, following the width) by BN output channels,
// with two consumer warpgroups of 64 pixels and one producer warp.  K is
// walked as (tap, 128-channel slice) steps through a 4-stage ring of
// full/empty mbarriers.  The producer loads each step's A tile with one TMA
// box over xq as a 4-D tensor (Ci, W, H, B) at the tap's shifted origin: TMA
// zero-fills whatever lies outside the image, negative coordinates and the
// channel tail included, so the pad-1 border costs nothing and a partial
// last slice (Ci = 320, 960) adds zeros to an exact integer sum.  B comes
// from a 3-D map over w as [Co][9][Ci].  Both are 128-byte swizzled (a K
// step is one 128-byte row) and feed m64nBNk32 s8 x s8 -> s32 wgmma
// straight from shared memory.  All four k32 steps of a slice are issued,
// the channel tail's on zeros: skipping them puts the products in a
// divergent path, and ptxas then serializes every wgmma.  The int32
// accumulators stay in registers.
// Where the output tiles give too few blocks (16x32, 8x16), K is split over
// a thread-block cluster of 2 or 4 blocks along grid z: each block sums its
// share of the steps, all stage their int32 tiles in their (then idle)
// rings, and after one cluster barrier each block adds its slice of the
// tile's pixels over the cluster's blocks through distributed shared memory
// (integer sums: exact in any order) and runs the epilogue on it, so there
// is no scratch in device memory and no second launch.  The epilogue
// (+ scale, bias in fp32, one cast) writes 16-byte stores.
// The plan (lr_conv3x3_int8_plan; ops/quant.py:conv3x3_int8_plan mirrors
// it): for each BN among 160, 128 (each where it divides Co) and 64, the K
// split doubles from 1 while the split grid stays within one wave over the
// SMs, up to 4 and at least 4 K steps a split; the BN with the least
// (waves over the SMs) x BN / split wins, the widest on a tie.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace lr {
namespace {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int BM = 128;                   // output pixels per block
constexpr int CONSUMERS = 256;            // two warpgroups of 64 pixels
constexpr int NTHREADS = CONSUMERS + 32;  // and the producer warp
constexpr int STAGES = 4;  // 6 measured 1.06x slower, 3 and 5 in conv_int8_variants
constexpr int A_BYTES = BM * 128;  // 128 pixels x 128 input channels
constexpr int MAX_SPLITS = 4;      // blocks of a cluster (8 are slower to place: 2x the time at 8x16)
constexpr int MIN_SPLIT_STEPS = 4;

template <int BN>
struct Conv {
  static constexpr int B_BYTES = BN * 128;  // BN output channels x 128 input channels
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int LDA = BN + 8;  // int32 row stride of the staged accumulator tile
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
  static_assert(STAGE_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(BM * LDA * 4 <= STAGES * STAGE_BYTES, "the accumulator tile fits the ring");
};

// Every thread of the cluster arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

__device__ __forceinline__ float epilogue(int acc, float scale, float bias) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), scale), bias);
}

// 8 output channels of one pixel: bf16 (one 16-byte store) or fp32 (two).
__device__ __forceinline__ void store8(bf16* p, const float (&v)[8]) {
  uint4 u;
  u.x = pack_bf16(v[0], v[1]);
  u.y = pack_bf16(v[2], v[3]);
  u.z = pack_bf16(v[4], v[5]);
  u.w = pack_bf16(v[6], v[7]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Grid: (patches, Co / BN, splits), a cluster of `splits` blocks along z.
template <int BN, class Out>
__global__ void __launch_bounds__(NTHREADS, 1)
    conv3x3_int8_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                        const float* __restrict__ scale, const float* __restrict__ bias, Out* __restrict__ out,
                        int h, int wd, int ci, int co, int rows, int cols, int tiles_x, int tiles_y) {
  using C = Conv<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: A [128 pixels][128], then B [BN][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * C::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = blockIdx.x % tiles_x, ty = (blockIdx.x / tiles_x) % tiles_y;
  const int b = blockIdx.x / (tiles_x * tiles_y);
  const int x0 = tx * cols, y0 = ty * rows, n0 = blockIdx.y * BN;
  const int nci = (ci + 127) / 128, nsteps = 9 * nci;
  // this block's share of the K steps
  const int s_begin = nsteps * rank / splits, n = nsteps * (rank + 1) / splits - s_begin;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warp / 4;
  int32_t acc[BN / 2];
  if (warp == CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int ks = s_begin + i, s = i % STAGES, tap = ks / nci, c0 = (ks - tap * nci) * 128;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * C::STAGE_BYTES;
        mbar_expect_tx(&full[s], C::STAGE_BYTES);
        tma_load_4d(st, &xmap, &full[s], c0, x0 + tap % 3 - 1, y0 + tap / 3 - 1, b);
        tma_load_3d(st + A_BYTES, &wmap, &full[s], c0, tap, n0);
      }
    }
  } else {  // consumers: warpgroup wg owns pixels 64 wg .. 64 wg + 63 of the patch
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = ring + s * C::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaS8<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        desc_sw128(st + A_BYTES + kk * 32, 16, 1024), 1);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's products are done with their stage
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- the int32 tile, staged in the ring (every load has landed and every
  // product has read its stage once all consumers are here) -----------------
  __syncthreads();
  int32_t* tile = reinterpret_cast<int32_t*>(ring);  // [128 pixels][LDA]
  if (warp < CONSUMERS / 32) {
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(tile + (r0 + 8 * half) * C::LDA + col) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  cluster_barrier();  // every block's tile is staged (a plain block barrier where splits == 1)

  // ---- block `rank` of the cluster: pixels [rank, rank + 1) x 128 / splits,
  // summed over the cluster's tiles in rank order, the epilogue, 16-byte stores
  constexpr int CPR = BN / 8;  // 8-channel groups a pixel
  const int px0 = BM / splits * rank, items = BM / splits * CPR;
  for (int idx = tid; idx < items; idx += NTHREADS) {
    const int px = px0 + idx / CPR, g = idx % CPR;
    const int y = y0 + px / cols, x = x0 + px % cols, c = n0 + 8 * g;
    if (y >= h || x >= wd || c >= co) continue;
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int q = 0; q < splits; ++q) {
      const int4* src = reinterpret_cast<const int4*>(cluster.map_shared_rank(tile, q) + px * C::LDA + 8 * g);
      const int4 lo = src[0], hi = src[1];
      sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
      sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
    }
    const float4 s0 = *reinterpret_cast<const float4*>(scale + c), s1 = *reinterpret_cast<const float4*>(scale + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(bias + c), b1 = *reinterpret_cast<const float4*>(bias + c + 4);
    const float v[8] = {epilogue(sum[0], s0.x, b0.x), epilogue(sum[1], s0.y, b0.y), epilogue(sum[2], s0.z, b0.z),
                        epilogue(sum[3], s0.w, b0.w), epilogue(sum[4], s1.x, b1.x), epilogue(sum[5], s1.y, b1.y),
                        epilogue(sum[6], s1.z, b1.z), epilogue(sum[7], s1.w, b1.w)};
    store8(out + ((size_t(b) * h + y) * wd + x) * co + c, v);
  }
  cluster_barrier();  // no block leaves while another reads its tile
}

// The launch plan (see the top).
struct Plan {
  int bn, splits, rows, cols, tiles_x, tiles_y;
};

Plan plan(int b, int h, int wd, int ci, int co, int sms) {
  Plan p{64, 1, 0, 1, 0, 0};
  while (p.cols < wd && p.cols < BM) p.cols *= 2;
  p.rows = BM / p.cols;
  p.tiles_x = (wd + p.cols - 1) / p.cols;
  p.tiles_y = (h + p.rows - 1) / p.rows;
  const long long m_tiles = static_cast<long long>(b) * p.tiles_x * p.tiles_y;
  const int nsteps = 9 * ((ci + 127) / 128);
  long long best = -1;
  for (int bn : {160, 128, 64}) {
    if (co % bn && bn != 64) continue;
    const long long blocks = m_tiles * ((co + bn - 1) / bn);
    int s = 1;
    while (2 * s <= MAX_SPLITS && blocks * 2 * s <= sms && nsteps >= MIN_SPLIT_STEPS * 2 * s) s *= 2;
    const long long cost = (blocks * s + sms - 1) / sms * bn * (MAX_SPLITS / s);
    if (best < 0 || cost < best) {
      best = cost;
      p.bn = bn;
      p.splits = s;
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

template <int BN, class Out>
cudaError_t launch(const CUtensorMap& xm, const void* w, const float* scale, const float* bias, Out* out, int b,
                   int h, int wd, int ci, int co, const Plan& p, cudaStream_t stream) {
  static unsigned long long granted = 0;  // the shared-memory grant, once per device
  const uint64_t dims[3] = {uint64_t(ci), 9, uint64_t(co)}, strides[2] = {uint64_t(ci), uint64_t(ci) * 9};
  const uint32_t box[3] = {128, 1, BN};
  CUtensorMap wm;
  cudaError_t e = encode_map(&wm, w, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 64 && (granted >> dev) & 1)) {
    e = allow_smem(conv3x3_int8_kernel<BN, Out>, Conv<BN>::SMEM);
    if (e == cudaSuccess && dev < 64) granted |= 1ull << dev;
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(static_cast<long long>(b) * p.tiles_x * p.tiles_y),
                     (co + BN - 1) / BN, p.splits);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = Conv<BN>::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = p.splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, conv3x3_int8_kernel<BN, Out>, xm, wm, scale, bias, out, h, wd, ci, co, p.rows,
                         p.cols, p.tiles_x, p.tiles_y);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

template <class Out>
cudaError_t launch_bn(const CUtensorMap& xm, const void* w, const float* scale, const float* bias, Out* out, int b,
                      int h, int wd, int ci, int co, const Plan& p, cudaStream_t s) {
  switch (p.bn) {
    case 160: return launch<160>(xm, w, scale, bias, out, b, h, wd, ci, co, p, s);
    case 128: return launch<128>(xm, w, scale, bias, out, b, h, wd, ci, co, p, s);
    default: return launch<64>(xm, w, scale, bias, out, b, h, wd, ci, co, p, s);
  }
}

int smem_of(int bn) {
  switch (bn) {
    case 160: return Conv<160>::SMEM;
    case 128: return Conv<128>::SMEM;
    case 64: return Conv<64>::SMEM;
    default: return -1;
  }
}

}  // namespace
}  // namespace lr

// The launch plan at this shape into plan[0..5]: output channels per block,
// the K split (blocks of a cluster), the patch's rows and columns, and the
// block's dynamic shared memory in bytes.  Returns a CUDA error (0 on success).
extern "C" int lr_conv3x3_int8_plan(int b, int h, int wd, int ci, int co, void* plan) {
  const int sms = lr::sm_count();
  if (sms < 0) return -sms;
  const lr::Plan p = lr::plan(b, h, wd, ci, co, sms);
  int* out = static_cast<int*>(plan);
  out[0] = p.bn;
  out[1] = p.splits;
  out[2] = p.rows;
  out[3] = p.cols;
  out[4] = lr::smem_of(p.bn);
  return 0;
}

// x: [b, h, w, ci] int8; w: [co, 3, 3, ci] int8; scale, bias: [co] fp32; out: [b, h, w, co]
// bf16, or fp32 where out_f32; all contiguous and 16-byte aligned, ci % 16 == 0, co % 8 == 0.
extern "C" int lr_conv3x3_int8(const void* x, const void* w, const void* scale, const void* bias, void* out, int b,
                               int h, int wd, int ci, int co, int out_f32, void* stream) {
  if (ci % 16 || co % 8 || ci <= 0 || co <= 0 || b <= 0 || h <= 0 || wd <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = lr::sm_count();
  if (sms < 0) return -sms;
  const lr::Plan p = lr::plan(b, h, wd, ci, co, sms);
  const uint64_t dims[4] = {uint64_t(ci), uint64_t(wd), uint64_t(h), uint64_t(b)};
  const uint64_t strides[3] = {uint64_t(ci), uint64_t(ci) * wd, uint64_t(ci) * wd * h};
  const uint32_t box[4] = {128, static_cast<uint32_t>(p.cols), static_cast<uint32_t>(p.rows), 1};
  CUtensorMap xm;
  cudaError_t e = lr::sm90::encode_map(&xm, x, 4, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* sc = static_cast<const float*>(scale);
  const auto* bi = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  e = out_f32 ? lr::launch_bn(xm, w, sc, bi, static_cast<float*>(out), b, h, wd, ci, co, p, s)
              : lr::launch_bn(xm, w, sc, bi, static_cast<lr::bf16*>(out), b, h, wd, ci, co, p, s);
  return static_cast<int>(e);
}
