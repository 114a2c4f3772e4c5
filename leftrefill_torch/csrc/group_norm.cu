// GroupNorm (+ SiLU) of the bf16 no-grad path, bf16 in, bf16 out, NHWC: the
// port's ops/layers.py group_norm32 with fast_affine (the default), and the
// F.silu that follows it at most sites.  No TPU kernel corresponds: the JAX
// package leaves its GroupNorm to XLA, whose fusions do the same work there.
//
// The function, in group_norm32's operations: fp32 mean and biased variance
// of each (batch, group) over the pixels and the group's channels, rstd =
// rsqrt(var + eps), the per-(batch, channel) affine a = rstd * gamma and bb =
// beta - mean * rstd * gamma in fp32, both rounded to bf16, then
// y = bf16(bf16(x * a) + bb) (a bf16 multiply, then a bf16 add, as PyTorch
// computes x * a + bb on bf16 tensors), and with the SiLU bf16(y / (1 +
// exp(-y))) in fp32, as F.silu computes it.  Each multiply and add of the
// apply pass is rounded on its own (__fmul_rn, __fadd_rn: no contraction
// into an FMA), so it repeats the plain version's bits wherever a and bb are
// the same; the statistics sum in another order than PyTorch's Welford
// reduce, which can move a or bb by one bf16 step at a channel whose fp32
// value lies within a few ulps of a rounding boundary.
//
// Two launches.  Pass 1 (gn_stats_kernel) reads x once: a block takes a
// batch and a run of pixel rows, each thread one 16-byte chunk (8 channels)
// of rows r, r + rpb, ... (rpb rows a sweep, so c / 8 x rpb threads are all
// busy: a group's 10-40 channels are not 16-byte aligned, so the sums are
// per channel), summing x - k and (x - k)^2 in fp32 with the shift k = the
// batch's first pixel (shifted sums: no E[x^2] - E[x]^2 cancellation on raw
// sums where the mean is large against the spread).  The block adds its
// rows' sums in shared memory and writes one partial a channel; the last
// block of each batch to finish (a ticket counter, reset by that block)
// adds the partials in fp64, merges each group's channels (Chan: the mean of
// the channel means, the sum of the channel M2s plus n (mean_c - mean)^2)
// and writes the batch's a and bb in bf16.  Pass 2 (gn_apply_kernel) reads x
// again (from L2 where it fits), keeps its chunk's a and bb in registers and
// writes y with 16-byte stores.  The pixels split over blocks so that the
// grid holds about two blocks an SM: the small sites (~0.1 M elements) are
// bound by the launches, the VAE's full-resolution ones (~500 M) by the
// bytes: 2 bytes an element read in pass 1, 2 read and 2 written in pass 2.
#include "common.cuh"

namespace lr {
namespace {

constexpr int GN_THREADS = 512;  // the most threads a block: c / 8 chunks x rpb rows
constexpr int GN_UNROLL = 4;     // chunks a thread loads at once
constexpr int GN_BLOCKS_PER_SM = 2;

__device__ __forceinline__ void unpack8(const uint4& u, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ float round_bf16(float v) { return __bfloat162float(__float2bfloat16_rn(v)); }

// pass 1 (see the top).  part: [batch, splits, c] float2 (sum of x - k, sum
// of (x - k)^2) of each block; ticket: [batch] counters at 0; ab: [batch, 2, c]
// bf16 (a, then bb).  Shared memory: the rows' sums (2 rpb c floats), then in
// the batch's last block the channels' means and M2s (2 c doubles) and the
// groups' means and rstds (2 groups floats).
__global__ void __launch_bounds__(GN_THREADS)
    gn_stats_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                    float2* __restrict__ part, unsigned* __restrict__ ticket, bf16* __restrict__ ab, int hw, int c,
                    int groups, int rows_per_block, float eps) {
  extern __shared__ double smem[];
  float* sums = reinterpret_cast<float*>(smem);
  __shared__ bool last;
  const int nch = c / 8, rpb = blockDim.x / nch;
  const int g = threadIdx.x % nch, r = threadIdx.x / nch, b = blockIdx.y, splits = gridDim.x;
  const bf16* xb = x + static_cast<size_t>(b) * hw * c + 8 * g;
  float k[8], s1[8], s2[8];
  unpack8(__ldg(reinterpret_cast<const uint4*>(xb)), k);
#pragma unroll
  for (int e = 0; e < 8; ++e) s1[e] = s2[e] = 0.0f;
  const int p_end = min(hw, (blockIdx.x + 1) * rows_per_block);
  for (int p = blockIdx.x * rows_per_block + r; p < p_end; p += GN_UNROLL * rpb) {
    uint4 raw[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (p + u * rpb < p_end) raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + static_cast<size_t>(p + u * rpb) * c));
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (p + u * rpb < p_end) {
        float v[8];
        unpack8(raw[u], v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float d = v[e] - k[e];
          s1[e] += d;
          s2[e] += d * d;
        }
      }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    sums[r * c + 8 * g + e] = s1[e];
    sums[(rpb + r) * c + 8 * g + e] = s2[e];
  }
  __syncthreads();
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float t1 = 0.0f, t2 = 0.0f;
    for (int i = 0; i < rpb; ++i) {
      t1 += sums[i * c + ch];
      t2 += sums[(rpb + i) * c + ch];
    }
    part[(static_cast<size_t>(b) * splits + blockIdx.x) * c + ch] = make_float2(t1, t2);
  }
  __threadfence();  // the partials are visible before the ticket says so
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket + b, 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  // the batch's fold: every partial of every channel, in split order (fp64)
  double* mean_c = smem;
  double* m2_c = smem + c;
  float* mean_g = reinterpret_cast<float*>(smem + 2 * c);
  float* rstd_g = mean_g + groups;
  const double n = static_cast<double>(hw);
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    double t1 = 0.0, t2 = 0.0;
    for (int s = 0; s < splits; ++s) {
      const float2 v = __ldcg(part + (static_cast<size_t>(b) * splits + s) * c + ch);
      t1 += v.x;
      t2 += v.y;
    }
    const double d = t1 / n;
    mean_c[ch] = static_cast<double>(__bfloat162float(x[static_cast<size_t>(b) * hw * c + ch])) + d;
    m2_c[ch] = fmax(t2 - t1 * d, 0.0);
  }
  __syncthreads();
  const int cpg = c / groups;
  for (int grp = threadIdx.x; grp < groups; grp += blockDim.x) {
    double m = 0.0;
    for (int j = 0; j < cpg; ++j) m += mean_c[grp * cpg + j];
    m /= cpg;
    double m2 = 0.0;
    for (int j = 0; j < cpg; ++j) {
      const double dm = mean_c[grp * cpg + j] - m;
      m2 += m2_c[grp * cpg + j] + n * dm * dm;
    }
    // group_norm32's fp32 steps from here: rsqrt(var + eps) (rsqrtf, as
    // torch.rsqrt on a CUDA tensor)
    mean_g[grp] = static_cast<float>(m);
    rstd_g[grp] = rsqrtf(__fadd_rn(static_cast<float>(m2 / (n * cpg)), eps));
  }
  __syncthreads();
  bf16* abb = ab + static_cast<size_t>(b) * 2 * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    const float mu = mean_g[ch / cpg], rs = rstd_g[ch / cpg];
    // a = rstd * gamma; bb = beta - mean * rstd * gamma, left to right
    abb[ch] = __float2bfloat16_rn(__fmul_rn(rs, gamma[ch]));
    abb[c + ch] = __float2bfloat16_rn(__fsub_rn(beta[ch], __fmul_rn(__fmul_rn(mu, rs), gamma[ch])));
  }
  if (threadIdx.x == 0) ticket[b] = 0u;  // ready for the next launch on the stream
}

// pass 2 (see the top): the blocks and threads of pass 1's layout
template <bool SILU>
__global__ void __launch_bounds__(GN_THREADS)
    gn_apply_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ab, bf16* __restrict__ y, int hw, int c,
                    int rows_per_block) {
  const int nch = c / 8, rpb = blockDim.x / nch;
  const int g = threadIdx.x % nch, r = threadIdx.x / nch, b = blockIdx.y;
  const size_t base = static_cast<size_t>(b) * hw * c + 8 * g;
  float a[8], bb[8];
  unpack8(*reinterpret_cast<const uint4*>(ab + static_cast<size_t>(b) * 2 * c + 8 * g), a);
  unpack8(*reinterpret_cast<const uint4*>(ab + static_cast<size_t>(b) * 2 * c + c + 8 * g), bb);
  const int p_end = min(hw, (blockIdx.x + 1) * rows_per_block);
  for (int p = blockIdx.x * rows_per_block + r; p < p_end; p += GN_UNROLL * rpb) {
    uint4 raw[GN_UNROLL];
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (p + u * rpb < p_end) raw[u] = __ldg(reinterpret_cast<const uint4*>(x + base + static_cast<size_t>(p + u * rpb) * c));
#pragma unroll
    for (int u = 0; u < GN_UNROLL; ++u)
      if (p + u * rpb < p_end) {
        float v[8];
        unpack8(raw[u], v);
        uint4 out;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
        for (int e = 0; e < 8; e += 2) {
          float o[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float t = __fadd_rn(round_bf16(__fmul_rn(v[e + j], a[e + j])), bb[e + j]);
            if constexpr (SILU) {
              t = round_bf16(t);
              t = __fdiv_rn(t, __fadd_rn(1.0f, expf(-t)));
            }
            o[j] = t;
          }
          h[e / 2] = __floats2bfloat162_rn(o[0], o[1]);
        }
        *reinterpret_cast<uint4*>(y + base + static_cast<size_t>(p + u * rpb) * c) = out;
      }
  }
}

// The pixel rows a block: the batch's rows over about GN_BLOCKS_PER_SM
// blocks an SM in all, at most max_splits blocks a batch, whole sweeps of rpb
cudaError_t plan(int batch, int hw, int rpb, int max_splits, int& splits, int& rows_per_block) {
  static int sms[8] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && sms[dev % 8] == 0) e = cudaDeviceGetAttribute(&sms[dev % 8], cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long sweeps = (hw + rpb - 1) / rpb;
  long long want = (static_cast<long long>(GN_BLOCKS_PER_SM) * sms[dev % 8] + batch - 1) / batch;
  want = want < sweeps ? want : sweeps;
  want = want < max_splits ? want : max_splits;
  rows_per_block = static_cast<int>((sweeps + want - 1) / want) * rpb;
  splits = (hw + rows_per_block - 1) / rows_per_block;
  return cudaSuccess;
}

}  // namespace
}  // namespace lr

// x, y: [batch, hw, c] bf16; gamma, beta: [c] fp32; part: [batch, max_splits,
// c] float2 of scratch; ticket: [batch] unsigned, 0 before the call and after
// it; ab: [batch, 2, c] bf16 of scratch.  All contiguous, x, y and ab 16-byte
// aligned; c % 8 == 0, c <= 4096, c % groups == 0.
extern "C" int lr_group_norm(const void* x, const void* gamma, const void* beta, void* y, void* part, void* ticket,
                             void* ab, int batch, int hw, int c, int groups, float eps, int silu, int max_splits,
                             void* stream) {
  if (batch <= 0 || hw <= 0 || c <= 0 || c % 8 || c > 4096 || groups <= 0 || c % groups || max_splits <= 0 ||
      batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nch = c / 8, rpb = lr::GN_THREADS / nch, threads = nch * rpb;
  int splits = 0, rows = 0;
  cudaError_t e = lr::plan(batch, hw, rpb, max_splits, splits, rows);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem_sums = 2 * sizeof(float) * rpb * c, smem_fold = 2 * sizeof(double) * c + 2 * sizeof(float) * groups;
  const size_t smem = smem_sums > smem_fold ? smem_sums : smem_fold;
  if (smem > 96 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  static bool granted[8] = {};
  int dev = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if (!granted[dev % 8]) {
    if ((e = lr::allow_smem(lr::gn_stats_kernel, 96 * 1024)) != cudaSuccess) return static_cast<int>(e);
    granted[dev % 8] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(splits, batch);
  lr::gn_stats_kernel<<<grid, threads, smem, s>>>(
      static_cast<const lr::bf16*>(x), static_cast<const float*>(gamma), static_cast<const float*>(beta),
      static_cast<float2*>(part), static_cast<unsigned*>(ticket), static_cast<lr::bf16*>(ab), hw, c, groups, rows, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  if (silu)
    lr::gn_apply_kernel<true><<<grid, threads, 0, s>>>(static_cast<const lr::bf16*>(x),
                                                       static_cast<const lr::bf16*>(ab), static_cast<lr::bf16*>(y),
                                                       hw, c, rows);
  else
    lr::gn_apply_kernel<false><<<grid, threads, 0, s>>>(static_cast<const lr::bf16*>(x),
                                                        static_cast<const lr::bf16*>(ab), static_cast<lr::bf16*>(y),
                                                        hw, c, rows);
  return static_cast<int>(cudaGetLastError());
}
