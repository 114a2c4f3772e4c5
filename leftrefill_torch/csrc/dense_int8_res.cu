// KI2: int8 GEMM with the per-row x per-column dequant, bias and residual,
// [R, K] int8 x [N, K] int8 -> [R, N] bf16.
//
// Replaces leftrefill_tpu/ops/quant.py:_dense_int8_res_mom_kernel (K9, the
// SpatialTransformer proj_out with its `+ x_in`).  out[r, n] =
// bf16(((float(acc) * sx[r]) * sw[n] + b[n]) + float(res[r, n])), acc the
// int32 sum of xq[r, :] * wq[n, :], in the TPU kernel's order with every
// multiply and add rounded on its own.  The TPU kernel's [B, 4, N] output
// moments are not computed: nothing reads them.
//
// What bounds it on the H100: bytes.  The UNet's sites (4096 x 640 x 640,
// 1024 and 256 x 1280 x 1280) do 3.4 and 1.7 GOP of int8 products, under a
// microsecond at the int8 peak, against 3-13 MB a launch, most of it the
// bf16 residual read and output write (4 R N bytes): an epilogue kernel.
//
// Design (wgmma + TMA, warp-specialised: KI1's, csrc/conv3x3_int8.cu, on a
// plain GEMM).  A block owns BM = 128 (two consumer warpgroups) or 64 (one)
// rows by BN = 160, 128 or 64 output columns, with one producer warp.  K is
// walked in 128-byte steps through a 4-stage ring of full/empty mbarriers:
// the producer loads each step's A tile (xq [R, K]) and B tile (wq in
// torch's Linear layout [N, K]) by TMA, both K-major with 128-byte
// swizzling as 8-bit wgmma wants them, zero-filled past R, N and K (a K
// tail adds zeros to an exact sum; all four k32 products of a step are
// issued, so no wgmma sits in a divergent branch), and the consumers run
// m64nBNk32 s8 x s8 -> s32 wgmma on them.  Where the output tiles give too
// few blocks, K is split over a thread-block cluster of 2 blocks along grid
// z (4 took 2.1x the time at 256 rows on an H100): every block stages its
// int32 tile in its (then idle) ring, and after one cluster barrier block
// `rank` sums its slice of the tile's rows over the cluster's tiles through
// distributed shared memory (exact in any order), so there is no partial in
// device memory and no second launch.
// The epilogue is the fast part: each consumer thread keeps one 8-column
// chunk of the tile's rows, so its columns' sw and bias sit in registers
// (read from shared memory each chunk, at a stride of 8 floats across the
// lanes, they took 8-way bank conflicts, and the epilogue ~5 of 12.5 us at
// 4096 rows on an H100; ~2 now); it loads its residual chunks (16 bytes
// each) into registers before the main loop, so their latency hides behind
// the products; sx is staged in shared memory once a block; the bf16 output
// goes out in 16-byte stores, and the cluster's tiles are read with loads
// the compiler may overlap with them.
// The plan (lr_dense_int8_res_plan; ops/quant.py:dense_int8_res_plan mirrors
// it): for each BM among 128, 64 and each BN among 160, 128 (each where it
// divides N) and 64, the K split doubles from 1 while the split grid stays
// within one wave over the SMs, up to 2 and at least 2 K steps a split; the
// tile with the least (waves over the SMs) x BM x BN / split wins, on a tie
// the one with fewer splits, then the first (widest).  At the UNet's sites
// that takes no split (64-row tiles at 1024 and 256 rows: a 2-block split
// of 128-row tiles measured 7 % slower at 1024 rows on an H100); a site
// with fewer tiles still, or a longer K, takes one.
#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90.cuh"

namespace lr {
namespace {

using namespace sm90;
namespace cg = cooperative_groups;

constexpr int STAGES = 4;
constexpr int MAX_SPLITS = 2;
constexpr int MIN_SPLIT_STEPS = 2;

template <int BM, int BN>
struct Dense {
  static constexpr int CONSUMERS = BM / 64 * 128;  // a warpgroup per 64 rows
  static constexpr int NTHREADS = CONSUMERS + 32;  // and the producer warp
  static constexpr int A_BYTES = BM * 128, STAGE_BYTES = (BM + BN) * 128;
  static constexpr int LDA = BN + 8;          // int32 row stride of the staged accumulator tile
  static constexpr int CPR = BN / 8;          // 8-column chunks a row
  // the epilogue: consumer thread t takes chunk t % CPR of rows t / CPR,
  // t / CPR + RPI, ... (RPI rows at once; the last CONSUMERS % CPR threads
  // sit out), so its 8 columns' sw and bias stay in registers
  static constexpr int RPI = CONSUMERS / CPR;
  static constexpr int ITERS = (BM + RPI - 1) / RPI;  // chunks a thread, at most
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + 4 * BM;
  static_assert(STAGE_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(BM * LDA * 4 <= STAGES * STAGE_BYTES, "the accumulator tile fits the ring");
};

// Every thread of the cluster arrives (release) and waits (acquire).
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The shared::cluster address of p (this block's shared memory) in block
// `rank` of the cluster, and a 16-byte load from one.  The address is taken
// by a volatile asm, which stays after the cluster barrier that precedes it;
// the load is not volatile and has no memory clobber (the tiles do not change
// between the two cluster barriers), so the compiler may overlap the loads
// with the global stores around them, and cannot hoist one above the
// barrier, as it depends on its address.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(a) : "r"(smem_u32(p)), "r"(rank));
  return a;
}

__device__ __forceinline__ int4 ld_cluster(uint32_t a) {
  int4 v;
  asm("ld.shared::cluster.v4.s32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

__device__ __forceinline__ float epilogue(int acc, float sx, float sw, float b, float res) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b), res);
}

// Grid: (row tiles, column tiles, splits), a cluster of `splits` blocks along z.
template <int BM, int BN>
__global__ void __launch_bounds__(Dense<BM, BN>::NTHREADS, 1)
    dense_int8_res_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                          const float* __restrict__ sx, const float* __restrict__ sw,
                          const float* __restrict__ bias, const bf16* __restrict__ res, bf16* __restrict__ out,
                          int r_total, int k, int n_total) {
  using D = Dense<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: A [BM rows][128], then B [BN rows][128]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * D::STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  float* s_sx = reinterpret_cast<float*>(empty + STAGES);  // [BM]
  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks()), rank = static_cast<int>(cluster.block_rank());

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nsteps = (k + 127) / 128;
  // this block's share of the K steps, and its slice of the tile's rows in the epilogue
  const int s_begin = nsteps * rank / splits, n = nsteps * (rank + 1) / splits - s_begin;
  const int px0 = BM / splits * rank, rows = BM / splits;
  const int g = tid % D::CPR, r_in = tid / D::CPR;  // the epilogue's column chunk and first row (above)

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], D::CONSUMERS / 32);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = warp / 4;
  int32_t acc[BN / 2];
  uint4 rv[D::ITERS];  // the residual of this thread's chunks of the block's slice
  if (warp == D::CONSUMERS / 32) {  // the producer warp
    if (lane == 0) {
      for (int i = 0; i < n; ++i) {
        const int ks = s_begin + i, s = i % STAGES;
        mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        unsigned char* st = ring + s * D::STAGE_BYTES;
        mbar_expect_tx(&full[s], D::STAGE_BYTES);
        tma_load_2d(st, &xmap, &full[s], ks * 128, m0);
        tma_load_2d(st + D::A_BYTES, &wmap, &full[s], ks * 128, n0);
      }
    }
  } else {  // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of the tile
#pragma unroll
    for (int i = 0; i < D::ITERS; ++i) {
      const int r = r_in + i * D::RPI, m = m0 + px0 + r, c = n0 + 8 * g;
      if (r_in < D::RPI && r < rows && m < r_total && c < n_total)
        rv[i] = __ldg(reinterpret_cast<const uint4*>(res + static_cast<size_t>(m) * n_total + c));
    }
    for (int i = tid; i < BM; i += D::CONSUMERS) s_sx[i] = m0 + i < r_total ? sx[m0 + i] : 0.0f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    for (int i = 0; i < n; ++i) {
      const int s = i % STAGES;
      mbar_wait(&full[s], (i / STAGES) & 1);
      const unsigned char* st = ring + s * D::STAGE_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        WgmmaS8<BN>::ss(acc, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                        desc_sw128(st + D::A_BYTES + kk * 32, 16, 1024), 1);
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
  int32_t* tile = reinterpret_cast<int32_t*>(ring);  // [BM rows][LDA]
  if (warp < D::CONSUMERS / 32) {
    const int r0 = wg * 64 + (warp % 4) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half)
        *reinterpret_cast<int2*>(tile + (r0 + 8 * half) * D::LDA + col) =
            make_int2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
    }
  }
  cluster_barrier();  // every block's tile is staged (a plain block barrier where splits == 1)

  // ---- block `rank`: rows [px0, px0 + BM / splits) of the tile, summed over
  // the cluster's tiles in rank order, the epilogue, 16-byte stores
  if (warp < D::CONSUMERS / 32) {
    uint32_t src[MAX_SPLITS];  // the cluster's tiles as shared::cluster addresses
#pragma unroll
    for (int q = 0; q < MAX_SPLITS; ++q) src[q] = q < splits ? cluster_addr(tile, q) : 0u;
    float w8[8], b8[8];  // this thread's 8 columns' sw and bias
    const int c = n0 + 8 * g;
    if (c < n_total) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 wv = __ldg(reinterpret_cast<const float4*>(sw + c) + h);
        const float4 bv = __ldg(reinterpret_cast<const float4*>(bias + c) + h);
        w8[4 * h] = wv.x; w8[4 * h + 1] = wv.y; w8[4 * h + 2] = wv.z; w8[4 * h + 3] = wv.w;
        b8[4 * h] = bv.x; b8[4 * h + 1] = bv.y; b8[4 * h + 2] = bv.z; b8[4 * h + 3] = bv.w;
      }
    }
#pragma unroll
    for (int i = 0; i < D::ITERS; ++i) {
      const int r = r_in + i * D::RPI, px = px0 + r, m = m0 + px;
      if (r_in < D::RPI && r < rows && m < r_total && c < n_total) {
        int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
        const uint32_t off = 4u * (px * D::LDA + 8 * g);
#pragma unroll
        for (int q = 0; q < MAX_SPLITS; ++q)
          if (q < splits) {
            const int4 lo = ld_cluster(src[q] + off), hi = ld_cluster(src[q] + off + 16);
            sum[0] += lo.x; sum[1] += lo.y; sum[2] += lo.z; sum[3] += lo.w;
            sum[4] += hi.x; sum[5] += hi.y; sum[6] += hi.z; sum[7] += hi.w;
          }
        const __nv_bfloat162* r2 = reinterpret_cast<const __nv_bfloat162*>(&rv[i]);
        const float sxr = s_sx[px];
        uint4 o;
        uint32_t* o32 = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 rf = __bfloat1622float2(r2[e]);
          o32[e] = pack_bf16(epilogue(sum[2 * e], sxr, w8[2 * e], b8[2 * e], rf.x),
                             epilogue(sum[2 * e + 1], sxr, w8[2 * e + 1], b8[2 * e + 1], rf.y));
        }
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(m) * n_total + c) = o;
      }
    }
  }
  cluster_barrier();  // no block leaves while another reads its tile
}

// The launch plan (see the top).
struct Plan {
  int bm, bn, splits;
};

Plan plan(int r, int k, int n, int sms) {
  const int nsteps = (k + 127) / 128;
  Plan p{128, 64, 1};
  long long best = -1;
  for (int bm : {128, 64}) {
    for (int bn : {160, 128, 64}) {
      if (n % bn && bn != 64) continue;
      const long long blocks = static_cast<long long>((r + bm - 1) / bm) * ((n + bn - 1) / bn);
      int s = 1;
      while (2 * s <= MAX_SPLITS && blocks * 2 * s <= sms && nsteps >= MIN_SPLIT_STEPS * 2 * s) s *= 2;
      const long long cost = (blocks * s + sms - 1) / sms * bm * bn * (MAX_SPLITS / s);
      if (best < 0 || cost < best || (cost == best && s < p.splits)) {
        best = cost;
        p = Plan{bm, bn, s};
      }
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

template <int BM, int BN>
cudaError_t launch(const void* x, const float* sx, const void* w, const float* sw, const float* bias,
                   const bf16* res, bf16* out, int r, int k, int n, int splits, cudaStream_t stream) {
  using D = Dense<BM, BN>;
  static unsigned long long granted = 0;  // the shared-memory grant, once per device
  CUtensorMap xm, wm;
  cudaError_t e = matrix_map(&xm, x, r, k, 1, 128, BM, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = matrix_map(&wm, w, n, k, 1, 128, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  int dev = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 64 && (granted >> dev) & 1)) {
    e = allow_smem(dense_int8_res_kernel<BM, BN>, D::SMEM);
    if (e == cudaSuccess && dev < 64) granted |= 1ull << dev;
  }
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((r + BM - 1) / BM, (n + BN - 1) / BN, splits);
  cfg.blockDim = dim3(D::NTHREADS);
  cfg.dynamicSmemBytes = D::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, dense_int8_res_kernel<BM, BN>, xm, wm, sx, sw, bias, res, out, r, k, n);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

template <int BM>
cudaError_t launch_bn(const void* x, const float* sx, const void* w, const float* sw, const float* bias,
                      const bf16* res, bf16* out, int r, int k, int n, const Plan& p, cudaStream_t s) {
  switch (p.bn) {
    case 160: return launch<BM, 160>(x, sx, w, sw, bias, res, out, r, k, n, p.splits, s);
    case 128: return launch<BM, 128>(x, sx, w, sw, bias, res, out, r, k, n, p.splits, s);
    default: return launch<BM, 64>(x, sx, w, sw, bias, res, out, r, k, n, p.splits, s);
  }
}

template <int BM>
int smem_bn(int bn) {
  switch (bn) {
    case 160: return Dense<BM, 160>::SMEM;
    case 128: return Dense<BM, 128>::SMEM;
    case 64: return Dense<BM, 64>::SMEM;
    default: return -1;
  }
}

}  // namespace
}  // namespace lr

// The launch plan at this shape into plan[0..3]: rows and columns of a
// block's tile, the K split (blocks of a cluster), and the block's dynamic
// shared memory in bytes.  Returns a CUDA error (0 on success).
extern "C" int lr_dense_int8_res_plan(int r, int k, int n, void* plan) {
  const int sms = lr::sm_count();
  if (sms < 0) return -sms;
  const lr::Plan p = lr::plan(r, k, n, sms);
  int* out = static_cast<int*>(plan);
  out[0] = p.bm;
  out[1] = p.bn;
  out[2] = p.splits;
  out[3] = p.bm == 128 ? lr::smem_bn<128>(p.bn) : lr::smem_bn<64>(p.bn);
  return 0;
}

// x: [r, k] int8; sx: [r] fp32; w: [n, k] int8; sw, bias: [n] fp32; res, out: [r, n] bf16;
// all contiguous and 16-byte aligned, k % 16 == 0, n % 8 == 0.
extern "C" int lr_dense_int8_res(const void* x, const void* sx, const void* w, const void* sw, const void* bias,
                                 const void* res, void* out, int r, int k, int n, void* stream) {
  if (k % 16 || n % 8 || r <= 0 || k <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int sms = lr::sm_count();
  if (sms < 0) return -sms;
  const lr::Plan p = lr::plan(r, k, n, sms);
  const auto* sxp = static_cast<const float*>(sx);
  const auto* swp = static_cast<const float*>(sw);
  const auto* bp = static_cast<const float*>(bias);
  const auto* rp = static_cast<const lr::bf16*>(res);
  auto* op = static_cast<lr::bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = p.bm == 128 ? lr::launch_bn<128>(x, sxp, w, swp, bp, rp, op, r, k, n, p, s)
                                    : lr::launch_bn<64>(x, sxp, w, swp, bp, rp, op, r, k, n, p, s);
  return static_cast<int>(e);
}
