// The two micro-kernels of the JAX package's scripts, for Hopper (sm_90a),
// written by hand.
//
//   smoke_kernel  <- scripts/microbench.py:smoke_kernel (the Pallas smoke
//                    test): o = 0, then o += 2x four times.  The TPU grid
//                    (rows/8, 4) revisits each 8-row block four times,
//                    zeroing it at k = 0; here the four steps are a loop
//                    in registers, in the same order, so the result is
//                    bit-equal to the plain version (not always 8x: 4x+2x
//                    can round).
//   expand_kernel <- scripts/proto_bfly_kernel.py:_kernel (the butterfly
//                    expand prototype): row y's elements, rows[starts[y],
//                    starts[y+1]) with F payload fields and an ascending,
//                    unique target slot in column F, go to out[y, :,
//                    target]; every other slot holds -1.  The TPU kernel
//                    moves each element to its slot with log2(S) rounds of
//                    conditional lane shifts, because VMEM lanes cannot be
//                    scattered to; a GPU thread can address any slot, so
//                    the rounds are not carried over.
//
// What bounds them on the card: bytes.  smoke reads x once and writes o
// once (one float4 of each per thread).  expand writes the whole
// [nrow][F][S] output and reads F + 1 floats per element; one thread per
// output slot (y, s) finds its element by binary search over the row's
// targets (at most log2(count) + 1 reads, cached: neighbouring threads
// search the same row) and writes its F fields, so the stores of a warp
// are 32 consecutive floats of each field plane, no slot is written twice
// and no fill pass or atomics are needed.

#include <cuda_runtime.h>

#include "micro.h"

namespace {

constexpr int kBlock = 256;

__global__ void __launch_bounds__(kBlock)
smoke_kernel(const float* __restrict__ x, float* __restrict__ o, int n) {
  const int base = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (base + 3 < n) {
    const float4 v = *reinterpret_cast<const float4*>(x + base);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < 4; ++k) {
      acc.x += v.x * 2.f;
      acc.y += v.y * 2.f;
      acc.z += v.z * 2.f;
      acc.w += v.w * 2.f;
    }
    *reinterpret_cast<float4*>(o + base) = acc;
  } else {
    for (int i = base; i < n; ++i) {
      float acc = 0.f;
      for (int k = 0; k < 4; ++k) acc += x[i] * 2.f;
      o[i] = acc;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
expand_kernel(const int* __restrict__ starts, const float* __restrict__ rows,
              int nrow, int f, int s, int width, float* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= nrow * s) return;
  const int y = t / s;
  const int slot = t - y * s;
  // lower bound of slot among the row's ascending targets (column f)
  int lo = __ldg(starts + y), hi = __ldg(starts + y + 1);
  const int end = hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(rows + static_cast<size_t>(mid) * width + f) <
        static_cast<float>(slot)) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const bool hit =
      lo < end &&
      __ldg(rows + static_cast<size_t>(lo) * width + f) ==
          static_cast<float>(slot);
  const float* src = rows + static_cast<size_t>(lo) * width;
  float* dst = out + static_cast<size_t>(y) * f * s + slot;
  for (int c = 0; c < f; ++c) {
    dst[static_cast<size_t>(c) * s] = hit ? __ldg(src + c) : -1.f;
  }
}

}  // namespace

extern "C" int sph_smoke(const float* x, float* out, int n, void* stream) {
  if (n > 0) {
    const int threads = (n + 3) / 4;
    smoke_kernel<<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_expand(const int* starts, const float* rows, int nrow,
                          int fields, int slots, int width, float* out,
                          void* stream) {
  if (nrow > 0 && slots > 0) {
    const int threads = nrow * slots;
    expand_kernel<<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        starts, rows, nrow, fields, slots, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
