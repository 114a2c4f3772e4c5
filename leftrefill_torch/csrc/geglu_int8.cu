// KI3: W8A8 GEGLU feed-forward, int8 x / W1 / W2, bf16 out.
//
// Replaces leftrefill_tpu/ops/mlp.py:_geglu_int8_kernel (K10, its default
// int8 second product).  With the weights in torch's Linear layout (W1 [2I, din]
// rows packed [value | gate], W2 [dout, I]), for each inner chunk c of width cw:
//   v = float(xq . W1[c]^T) * (sx * s1[c]) + b1[c]
//   g = float(xq . W1[I + c]^T) * (sx * s1[I + c]) + b1[I + c]
//   h = v * ((g * 0.5) * (1 + erf(g * 0.70710678)))
//                                        (exact erf through CUDA's erff; the
//                                         TPU kernel used the A&S 7.1.26 polynomial)
//   sh = max(max_j |h[r, j]|, 1e-8) / 127 per row over the chunk
//   p_c = float(rint(h / sh) . W2[:, c]^T) * (sh * s2)
// and out = bf16(((0 + p_0) + p_1) + ... + b2), the chunks added in order.
// Every fp32 operation is the plain version's, in its order, with no
// contracted multiply-add (__fmul_rn / __fadd_rn), so the two agree bit for
// bit.  The chunk width is part of the function (the requant scale spans one
// chunk); the caller passes the TPU plan's.
//
// What bounds it on the H100: the int8 products (2 R din 2I + 2 R I dout
// operations at 1979 TOP/s), far above the memory rate at these widths.
//
// Design (csrc/geglu.cuh: wgmma + TMA, warp-specialised, two kernels), both
// products as m64nNk32 s8 x s8 -> s32 wgmma (exact int32 sums) from
// 128-byte-swizzled shared memory: a K step is a 128-byte row of 128 int8
// values, four k32 steps of 32 bytes, the bf16 geometry in bytes.  din = 320
// is 2.5 such rows: TMA zero-fills the third step's tail, which adds nothing
// to an integer sum.
// - up (geglu_int8_up_kernel): a block owns 128 rows x 128 inner columns,
//   and a thread cluster of cw / 128 blocks along the inner dimension covers
//   one chunk (5 at cw = 640, 2 at 256).  v, g and h stay in registers; each
//   block reduces its rows' max |h| over its 128 columns and stores it into
//   every block of the cluster (distributed shared memory); after one
//   cluster barrier each block takes the max of the cluster's cw / 128
//   values in its own shared memory (a max has no order, so this is exact)
//   and forms sh, requantizes its own h (a multiply by 1 / sh, with the
//   division where the product lies next to a half-integer: the division's
//   integer either way), and TMA-stores the int8 tile to hq [R, I]; the
//   cluster's first block writes sh [R, I / cw].
//   h in fp32 never leaves the SM; hq crosses device memory once (1 byte an
//   element written and read).
// - down (geglu_int8_down_kernel<BN>): a block owns 128 rows x BN output
//   columns and walks I in order; an int32 accumulator runs over a chunk's
//   cw / 128 steps, and at each chunk's end
//   acc = acc + float(acc_i32) * (sh[row, c] * s2[col]) in fp32 registers,
//   the plain version's fixed-order sum; no scratch, no atomics.
#include <cooperative_groups.h>

#include <algorithm>

#include "geglu.cuh"

namespace lr {
namespace {

using namespace geglu;
namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;  // blocks of a cluster (8 portable; the H100 allows 16)
// and the out tile, and the cluster's row maxima of two items
constexpr int UP8_SMEM = UP_SMEM + TILE + 2 * MAX_CLUSTER * BM * 4;

// rint(h / sh) with the division's rounding, mostly without the division:
// h * (1 / sh) is within 2 fp32 ulps of h / sh, |h / sh| <= 127, so the two
// round to the same integer unless the product lies within 2^-14 of a
// half-integer; there the IEEE division decides.
__device__ __forceinline__ float rint_div(float h, float sh, float inv) {
  const float y = __fmul_rn(h, inv);
  return fabsf(fabsf(y - truncf(y)) - 0.5f) > 6.1035e-5f ? rintf(y) : rintf(h / sh);
}

// Every thread of the cluster arrives (release) and waits (acquire); not
// .aligned: the producer warp's loading lane reaches it apart from the others.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Persistent: each cluster walks the (128-row tile, chunk) items
// cluster, cluster + clusters, ...; its block of rank q takes the chunk's
// columns q * 128 ...
__global__ void __launch_bounds__(NTHREADS, 1)
    geglu_int8_up_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                         const __grid_constant__ CUtensorMap hqmap, const float* __restrict__ sx,
                         const float* __restrict__ s1, const float* __restrict__ b1, float* __restrict__ sh,
                         int r, int din, int inner, int cw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: xq, W1 value, W1 gate, each [128 rows][128 bytes]
  unsigned char* stage_hq = ring + STAGES * UP_STAGE;  // the hq tile on its way out, [128 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(stage_hq + TILE);
  uint64_t* empty = full + STAGES;
  // [item parity][cluster rank][128 rows]: each block's max |h| of each row over its columns
  float* rowmax = reinterpret_cast<float*>(empty + STAGES);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned blocks = cluster.num_blocks(), rank = cluster.block_rank();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int clusters = gridDim.x / blocks, first = blockIdx.x / blocks;
  const int nch = inner / cw, items = (r + BM - 1) / BM * nch;
  const int mine = (items - first + clusters - 1) / clusters;  // this cluster's items
  const int nk = (din + 127) / 128;
  // item j of this cluster: rows r0 (chunk-fastest order, so the x rows stay in L2), columns c0
  auto item_rows = [&](int j) { return (first + j * clusters) / nch * BM; };
  auto item_cols = [&](int j) { return (first + j * clusters) % nch * cw + int(rank) * BI; };
  init_ring(full, empty);

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup; all of it joins the cluster barriers
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) {
      // load step t = j nk + ks; before item j's barrier, item j's steps and
      // the first STAGES of item j + 1 (their slots are freed by item j's
      // products, which come before the barrier)
      const int total = mine * nk;
      int t = 0;
      for (int j = 0; j < mine; ++j) {
        for (const int upto = min(total, (j + 1) * nk + min(nk, STAGES)); t < upto; ++t) {
          const int s = t % STAGES, jt = t / nk, ks = t % nk;
          mbar_wait(&empty[s], ((t / STAGES) & 1) ^ 1);
          unsigned char* st = ring + s * UP_STAGE;
          mbar_expect_tx(&full[s], UP_STAGE);
          tma_load_2d(st, &xmap, &full[s], ks * 128, item_rows(jt));
          tma_load_2d(st + TILE, &w1map, &full[s], ks * 128, item_cols(jt));
          tma_load_2d(st + 2 * TILE, &w1map, &full[s], ks * 128, inner + item_cols(jt));
        }
        cluster_barrier();
      }
    } else {
      for (int j = 0; j < mine; ++j) cluster_barrier();
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows r0 + 64 wg .. + 63 of each item ----
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row = wg * 64 + acc_row();  // and row + 8
  for (int j = 0; j < mine; ++j) {
    const int r0 = item_rows(j), c0 = item_cols(j);
    int32_t v[BI / 2], g[BI / 2];
#pragma unroll
    for (int i = 0; i < BI / 2; ++i) v[i] = g[i] = 0;
    for (int ks = 0; ks < nk; ++ks) {
      const int t = j * nk + ks, s = t % STAGES;
      mbar_wait(&full[s], (t / STAGES) & 1);
      const unsigned char* st = ring + s * UP_STAGE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t a = desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024);
        WgmmaS8<BI>::ss(v, a, desc_sw128(st + TILE + kk * 32, 16, 1024), 1);
        WgmmaS8<BI>::ss(g, a, desc_sw128(st + 2 * TILE + kk * 32, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (ks > 0 && lane == 0) mbar_arrive(&empty[(t - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(v);
    fence_regs(g);
    if (lane == 0) mbar_arrive(&empty[(j * nk + nk - 1) % STAGES]);  // the item's last stage

    // ---- h in registers, and each row's max |h| over this block's columns --
    float sxr[2], mx[2] = {0.0f, 0.0f}, h[BI / 2];
#pragma unroll
    for (int half = 0; half < 2; ++half) sxr[half] = r0 + row + 8 * half < r ? sx[r0 + row + 8 * half] : 0.0f;
#pragma unroll
    for (int n = 0; n < BI / 8; ++n) {
      const int jv = c0 + acc_col(4 * n), jg = inner + jv;  // a column pair
      const float2 sv = *reinterpret_cast<const float2*>(s1 + jv), bv = *reinterpret_cast<const float2*>(b1 + jv);
      const float2 sg = *reinterpret_cast<const float2*>(s1 + jg), bg = *reinterpret_cast<const float2*>(b1 + jg);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int i = 4 * n + k, half = k / 2;
        const float vv = __fadd_rn(__fmul_rn(__int2float_rn(v[i]), __fmul_rn(sxr[half], k % 2 ? sv.y : sv.x)),
                                   k % 2 ? bv.y : bv.x);
        const float gt = __fadd_rn(__fmul_rn(__int2float_rn(g[i]), __fmul_rn(sxr[half], k % 2 ? sg.y : sg.x)),
                                   k % 2 ? bg.y : bg.x);
        const float gelu =
            __fmul_rn(__fmul_rn(gt, 0.5f), __fadd_rn(1.0f, erff(__fmul_rn(gt, 0.70710678118654752f))));
        h[i] = __fmul_rn(vv, gelu);
        mx[half] = fmaxf(mx[half], fabsf(h[i]));
      }
    }
    // each row's maxima go to every block of the cluster (distributed shared
    // memory stores into this item's half of the double buffer), so after one
    // cluster barrier each block reads them in its own shared memory; a
    // block writes item j + 2's maxima only after item j + 1's barrier,
    // which every block passes after reading item j's
    float* mine_max = rowmax + (j % 2) * MAX_CLUSTER * BM;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      if (lane % 4 == 0)
        for (unsigned q = 0; q < blocks; ++q)
          cluster.map_shared_rank(mine_max, q)[rank * BM + row + 8 * half] = mx[half];
    }
    cluster_barrier();  // every block's row maxima of item j are in every block

    // ---- sh over the whole chunk -----------------------------------------
    float shr[2], inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float m = 0.0f;
      for (unsigned q = 0; q < blocks; ++q) m = fmaxf(m, mine_max[q * BM + row + 8 * half]);
      shr[half] = fmaxf(m, 1e-8f) / 127.0f;
      inv[half] = 1.0f / shr[half];
    }

    // ---- hq = clamp(rint(h / sh)) into the swizzled out tile ----------------
    if (warp % 4 == 0 && lane == 0) tma_store_wait_read();  // the previous item's store has read it
    bar_sync(2 + wg, 128);
#pragma unroll
    for (int n = 0; n < BI / 8; ++n)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 4 * n + 2 * half, rr = row + 8 * half;
        const int q0 = static_cast<int>(fminf(fmaxf(rint_div(h[i], shr[half], inv[half]), -127.0f), 127.0f));
        const int q1 = static_cast<int>(fminf(fmaxf(rint_div(h[i + 1], shr[half], inv[half]), -127.0f), 127.0f));
        *reinterpret_cast<uint16_t*>(stage_hq + rr * 128 + (((n / 2) ^ (rr % 8)) * 16) + 8 * (n % 2) +
                                     2 * (lane % 4)) = static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
      }
    if (rank == 0 && lane % 4 == 0) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        if (r0 + row + 8 * half < r) sh[size_t(r0 + row + 8 * half) * nch + c0 / cw] = shr[half];
    }
    fence_proxy_async();
    bar_sync(2 + wg, 128);
    if (warp % 4 == 0 && lane == 0) {
      tma_store_2d(&hqmap, stage_hq + wg * 64 * 128, c0, r0 + wg * 64);
      tma_store_commit();
    }
  }
  if (warp % 4 == 0 && lane == 0) tma_store_wait_read();
}

template <int BN>
__global__ void __launch_bounds__(NTHREADS, 1)
    geglu_int8_down_kernel(const __grid_constant__ CUtensorMap hqmap, const __grid_constant__ CUtensorMap w2map,
                           const float* __restrict__ sh, const float* __restrict__ s2, const float* __restrict__ b2,
                           bf16* __restrict__ out, int r, int inner, int dout, int cw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = align1024(smem_raw);  // per stage: hq [128][128 bytes], W2 [BN][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Down<BN>::STAGE);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n0 = blockIdx.x * BN, r0 = blockIdx.y * BM;
  const int nk = inner / 128, steps = cw / 128, nch = inner / cw;
  init_ring(full, empty);

  if (warp >= CONSUMERS / 32) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp == CONSUMERS / 32 && lane == 0) produce_down<BN>(ring, full, empty, &hqmap, &w2map, r0, n0, nk, 128);
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp / 4;
  const int row = r0 + wg * 64 + acc_row();  // and row + 8
  int32_t acc_i[BN / 2];
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    acc_i[i] = 0;
    acc[i] = 0.0f;
  }
  int pending = -1;  // a stage whose products may still run
  for (int ks = 0; ks < nk; ++ks) {
    const int s = ks % STAGES;
    mbar_wait(&full[s], (ks / STAGES) & 1);
    const unsigned char* st = ring + s * Down<BN>::STAGE;
    const int first = ks % steps == 0;  // a chunk starts: the int32 sum starts from 0
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      WgmmaS8<BN>::ss(acc_i, desc_sw128(st + wg * 64 * 128 + kk * 32, 16, 1024),
                      desc_sw128(st + TILE + kk * 32, 16, 1024), !(first && kk == 0));
    wgmma_commit();
    if ((ks + 1) % steps) {
      wgmma_wait<1>();
      if (pending >= 0 && lane == 0) mbar_arrive(&empty[pending]);
      pending = s;
      continue;
    }
    // the chunk's end: p_c folded into the fp32 sum, in chunk order
    wgmma_wait<0>();
    fence_regs(acc_i);
    if (lane == 0) {
      if (pending >= 0) mbar_arrive(&empty[pending]);
      mbar_arrive(&empty[s]);
    }
    pending = -1;
    const int c = ks / steps;
    const float sh0 = row < r ? sh[size_t(row) * nch + c] : 0.0f;
    const float sh1 = row + 8 < r ? sh[size_t(row + 8) * nch + c] : 0.0f;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int col = n0 + acc_col(4 * n);
      const float2 sc = col < dout ? *reinterpret_cast<const float2*>(s2 + col) : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * n + j;
        const float scale = __fmul_rn(j / 2 ? sh1 : sh0, j % 2 ? sc.y : sc.x);
        acc[i] = __fadd_rn(acc[i], __fmul_rn(__int2float_rn(acc_i[i]), scale));
      }
    }
  }
  store_out<BN>(acc, b2, out, ring, r0, n0, r, dout);
}

unsigned long long up_granted = 0;

template <int BN>
cudaError_t launch_down(const CUtensorMap& hm, const void* w2, const float* sh, const float* s2, const float* b2,
                        bf16* out, int r, int inner, int dout, int cw, cudaStream_t stream) {
  static unsigned long long granted = 0;
  CUtensorMap wm;
  cudaError_t e = matrix_map(&wm, w2, dout, inner, 1, 128, BN, CU_TENSOR_MAP_DATA_TYPE_UINT8);
  if (e == cudaSuccess) e = grant_smem(geglu_int8_down_kernel<BN>, Down<BN>::SMEM, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout + BN - 1) / BN, (r + BM - 1) / BM);
  geglu_int8_down_kernel<BN><<<grid, NTHREADS, Down<BN>::SMEM, stream>>>(hm, wm, sh, s2, b2, out, r, inner, dout, cw);
  return cudaGetLastError();
}

}  // namespace
}  // namespace lr

// The output columns of a down block at this shape, or a negated CUDA error.
extern "C" int lr_geglu_int8_tile(int r, int dout) {
  const int sms = lr::geglu::sm_count();
  return sms < 0 ? sms : lr::geglu::down_tile(r, dout, sms);
}

// The dynamic shared memory of one block, bytes: kernel 0 the up kernel
// (bn ignored), 1 the down kernel of `bn` output columns; -1 otherwise.
extern "C" int lr_geglu_int8_smem(int kernel, int bn) {
  return kernel == 0 ? lr::UP8_SMEM : kernel == 1 ? lr::geglu::down_smem(bn) : -1;
}

// xq: [r, din] int8; sx: [r] fp32; w1: [2*inner, din] int8 rows [value | gate]; s1, b1:
// [2*inner] fp32; w2: [dout, inner] int8; s2, b2: [dout] fp32; hq: [r, inner] int8 and
// sh: [r, inner / cw] fp32 scratch; out: [r, dout] bf16.  All contiguous and 16-byte
// aligned; din % 16 == 0, cw % 128 == 0 with cw / 128 <= 16 (the blocks of a cluster),
// inner % cw == 0, dout % 8 == 0.  Two launches on `stream`: up (xq -> hq, sh), down.
extern "C" int lr_geglu_int8(const void* xq, const void* sx, const void* w1, const void* s1, const void* b1,
                             const void* w2, const void* s2, const void* b2, void* hq, void* sh, void* out, int r,
                             int din, int inner, int dout, int cw, void* stream) {
  using namespace lr::geglu;
  if (r <= 0 || din <= 0 || din % 16 || cw <= 0 || cw % BI || cw / BI > lr::MAX_CLUSTER || inner % cw || dout <= 0 ||
      dout % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sms = sm_count();
  if (sms < 0) return -sms;
  const CUtensorMapDataType u8 = CU_TENSOR_MAP_DATA_TYPE_UINT8;
  CUtensorMap xm, w1m, hstore, hload;
  cudaError_t e = matrix_map(&xm, xq, r, din, 1, 128, BM, u8);
  if (e == cudaSuccess) e = matrix_map(&w1m, w1, 2 * inner, din, 1, 128, BI, u8);
  if (e == cudaSuccess) e = matrix_map(&hstore, hq, r, inner, 1, 128, 64, u8);
  if (e == cudaSuccess) e = matrix_map(&hload, hq, r, inner, 1, 128, BM, u8);
  if (e == cudaSuccess && !lr::up_granted) {  // clusters of up to 16 blocks (10 at cw = 1280)
    e = cudaFuncSetAttribute(lr::geglu_int8_up_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (e == cudaSuccess) e = grant_smem(lr::geglu_int8_up_kernel, lr::UP8_SMEM, lr::up_granted);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cw / BI);
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = lr::UP8_SMEM;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = cw / BI;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // persistent: as many clusters as the card holds at once (asked once per
  // device and cluster size), at most one an item
  static int fits[8][lr::MAX_CLUSTER + 1] = {};
  int dev = 0;
  e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int& fit = fits[dev % 8][cw / BI];
  if (fit == 0) e = cudaOccupancyMaxActiveClusters(&fit, lr::geglu_int8_up_kernel, &cfg);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (fit < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cfg.gridDim = dim3(cw / BI * std::min(fit, (r + BM - 1) / BM * (inner / cw)));
  e = cudaLaunchKernelEx(&cfg, lr::geglu_int8_up_kernel, xm, w1m, hstore, static_cast<const float*>(sx),
                         static_cast<const float*>(s1), static_cast<const float*>(b1), static_cast<float*>(sh), r,
                         din, inner, cw);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const float *shp = static_cast<const float*>(sh), *s2p = static_cast<const float*>(s2);
  const float* b2p = static_cast<const float*>(b2);
  lr::bf16* o = static_cast<lr::bf16*>(out);
  switch (down_tile(r, dout, sms)) {
    case 160: e = lr::launch_down<160>(hload, w2, shp, s2p, b2p, o, r, inner, dout, cw, s); break;
    case 128: e = lr::launch_down<128>(hload, w2, shp, s2p, b2p, o, r, inner, dout, cw, s); break;
    default: e = lr::launch_down<64>(hload, w2, shp, s2p, b2p, o, r, inner, dout, cw, s); break;
  }
  return static_cast<int>(e);
}
