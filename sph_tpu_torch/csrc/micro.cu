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
// once, one float4 of each a thread; at 128 MiB each way that reaches 0.88
// of the byte bound on an H100 (PERF.md), and below a few MB the time is
// that of a launch.  expand writes
// the whole [nrow][F][S] output and reads F + 1 floats an element, so its
// store stream is the work; a search per slot would put a chain of
// dependent loads in front of every store.  Here one block of 512 threads
// takes row y's slots [c0, c0 + 2048): each thread loads the targets of
// the row's elements (two loads in flight, independent of each other) and
// writes the index of each element whose target falls in the chunk into
// an inverse table in shared memory (filled with -1 first; targets are
// unique, so no two threads write one entry and no atomics are needed).
// Then each thread owns 4 consecutive slots: it reads their 4 entries as
// one int4, loads each hit's payload as two float4, and writes one float4
// into each of the F planes, a warp's stores 512 contiguous bytes.  A
// plane that does not start on 16 bytes (S % 4 != 0) takes scalar stores.
// Rows must start on 16 bytes (width % 4 == 0); the wrapper refuses others.

#include <cuda_runtime.h>

#include <cstdint>

#include "micro.h"

namespace {

constexpr int kSmokeThreads = 256;

__global__ void __launch_bounds__(kSmokeThreads)
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

constexpr int kFields = 8;                       // F, as the wrapper's
constexpr int kExpandThreads = 512;
constexpr int kExpandChunk = 4 * kExpandThreads;  // slots a block: 4 a thread
constexpr int kExpandLoads = 2;                   // targets in flight a thread

// the targets of elements base + u * kExpandThreads below hi; -1 past it
__device__ __forceinline__ void load_targets(const float* __restrict__ rows,
                                             int width, int base, int hi,
                                             float (&t)[kExpandLoads]) {
#pragma unroll
  for (int u = 0; u < kExpandLoads; ++u) {
    const int k = base + u * kExpandThreads;
    t[u] = k < hi ? __ldg(rows + static_cast<size_t>(k) * width + kFields)
                  : -1.f;
  }
}

// element e's payload, or -1 in every field where e < 0 (a hole)
__device__ __forceinline__ void load_payload(const float* __restrict__ rows,
                                             int width, int e,
                                             float (&v)[kFields]) {
  if (e < 0) {
#pragma unroll
    for (int c = 0; c < kFields; ++c) v[c] = -1.f;
    return;
  }
  const float4* p =
      reinterpret_cast<const float4*>(rows + static_cast<size_t>(e) * width);
  const float4 a = __ldg(p), b = __ldg(p + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(kExpandThreads)
expand_kernel(const int* __restrict__ starts, const float* __restrict__ rows,
              int chunks, int s, int width, float* __restrict__ out) {
  __shared__ __align__(16) int inv[kExpandChunk];
  const int y = blockIdx.x / chunks;
  const int c0 = (blockIdx.x - y * chunks) * kExpandChunk;
  const int tid = threadIdx.x;
  const int hi = __ldg(starts + y + 1);
  int base = __ldg(starts + y) + tid;
  // the first round's targets go out before the table is filled
  float t[kExpandLoads];
  load_targets(rows, width, base, hi, t);
  reinterpret_cast<int4*>(inv)[tid] = make_int4(-1, -1, -1, -1);
  __syncthreads();
  for (;;) {
#pragma unroll
    for (int u = 0; u < kExpandLoads; ++u) {
      const int r = static_cast<int>(t[u]) - c0;
      if (t[u] >= 0.f && static_cast<unsigned>(r) < kExpandChunk) {
        inv[r] = base + u * kExpandThreads;
      }
    }
    base += kExpandLoads * kExpandThreads;
    if (base >= hi) break;
    load_targets(rows, width, base, hi, t);
  }
  __syncthreads();

  const int s0 = c0 + 4 * tid;
  if (s0 >= s) return;
  const int4 e = reinterpret_cast<const int4*>(inv)[tid];
  float v[4][kFields];
  load_payload(rows, width, e.x, v[0]);
  load_payload(rows, width, e.y, v[1]);
  load_payload(rows, width, e.z, v[2]);
  load_payload(rows, width, e.w, v[3]);
  float* dst = out + static_cast<size_t>(y) * kFields * s + s0;
  if ((s & 3) == 0) {   // every plane starts on 16 bytes; s0 + 3 < s
#pragma unroll
    for (int c = 0; c < kFields; ++c) {
      *reinterpret_cast<float4*>(dst + static_cast<size_t>(c) * s) =
          make_float4(v[0][c], v[1][c], v[2][c], v[3][c]);
    }
  } else {
#pragma unroll
    for (int c = 0; c < kFields; ++c) {
      for (int u = 0; u < 4 && s0 + u < s; ++u) {
        dst[static_cast<size_t>(c) * s + u] = v[u][c];
      }
    }
  }
}

}  // namespace

extern "C" int sph_smoke(const float* x, float* out, int n, void* stream) {
  if (n > 0) {
    const int threads = (n + 3) / 4;
    smoke_kernel<<<(threads + kSmokeThreads - 1) / kSmokeThreads,
                   kSmokeThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        x, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_expand(const int* starts, const float* rows, int nrow,
                          int fields, int slots, int width, float* out,
                          void* stream) {
  if (fields != kFields || width % 4 != 0 ||
      reinterpret_cast<uintptr_t>(rows) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nrow > 0 && slots > 0) {
    const int chunks = (slots + kExpandChunk - 1) / kExpandChunk;
    expand_kernel<<<nrow * chunks, kExpandThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        starts, rows, chunks, slots, width, out);
  }
  return static_cast<int>(cudaGetLastError());
}
