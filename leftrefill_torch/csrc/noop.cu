// P5: o = x + 1 on a bf16 tile (a timing probe of the launch floor, off the
// main path).
//
// Replaces scripts/tpu_r3_overhead.py:_noop_kernel (launched by its noop):
// one [8, 128] bf16 tile, o = bf16(f32(x) + 1).  What bounds it on the H100:
// nothing of its own (4 KB of traffic, 0.001 us at 3.35 TB/s); its time is
// the launch's, the floor that every kernel of the port pays.  Design: one
// thread per 8 values (a 16-byte load and store), 128 threads a block, so the
// [8, 128] tile is one block.
#include "common.cuh"

namespace lr {
namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS) noop_kernel(const uint4* __restrict__ x, uint4* __restrict__ o, int n8) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n8) return;
  uint4 v = x[i];
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    h[j] = __floats2bfloat162_rn(f.x + 1.0f, f.y + 1.0f);
  }
  o[i] = v;
}

}  // namespace
}  // namespace lr

// x, o: bf16, n values (a positive multiple of 8), 16-byte aligned.
extern "C" int lr_noop(const void* x, void* o, int n, void* stream) {
  if (n <= 0 || n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int n8 = n / 8;
  lr::noop_kernel<<<(n8 + lr::THREADS - 1) / lr::THREADS, lr::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(x), static_cast<uint4*>(o), n8);
  return static_cast<int>(cudaGetLastError());
}
