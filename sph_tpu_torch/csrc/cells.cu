// The cell table for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernel that builds the JAX package's neighbor
// tables: sph_tpu/neighbors/mxu_permute.py:_expand_kernel (reached from
// planes._expand_tables), which scatters cell-sorted [pos, vel] rows (fluid)
// or [pos] rows (ghosts) into a dense per-cell slot table with sentinel
// holes.  The port's sweeps read the sorted rows themselves, so the table
// here is the sorted rows plus each cell's row range: what #3 computes, not
// how its one-hot matmuls block it.
//
// cell_table_kernel, one launch over max(n, num_cells) threads:
//   - thread t < num_cells finds cell t's bounds by binary search over
//     skey, with torch.searchsorted's semantics: start[t] is the first row
//     with key >= t and end[t] the first row with key > t, so an empty cell
//     has start = end = its insertion point (never 0, which would send the
//     sweeps' x-range walks from row 0);
//   - thread t < n writes sorted row t's pos (and vel) from order[t].
// No atomics, no memset, and the result does not depend on scheduling.
// A scan over row boundaries would leave one thread to fill a gap of up to
// a million empty cells (the grid's head and its empty upper half).
//
// What bounds it on the card: the searches' scattered reads of skey
// (about log2(n) = 21 steps at 1.15M rows; skey is 4.6 MB and stays in L2)
// and the pos/vel gather: 56 bytes a row (order, pos and vel read, spos and
// svel written), 64 MB of HBM traffic at ghost_1m's 1.15M rows.

#include <cuda_runtime.h>

#include "cells.h"

namespace {

constexpr int kBlock = 256;

// First index in skey[0, n) whose key is >= c.
__device__ __forceinline__ int lower_bound(const int* __restrict__ skey,
                                           int n, int c) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(skey + mid) < c) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kBlock)
cell_table_kernel(const int* __restrict__ skey,
                  const long long* __restrict__ order,
                  const float* __restrict__ pos, const float* __restrict__ vel,
                  int n, int num_cells, float* __restrict__ spos,
                  float* __restrict__ svel, int* __restrict__ cell_start,
                  int* __restrict__ cell_end) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < num_cells) {
    cell_start[t] = lower_bound(skey, n, t);
    cell_end[t] = lower_bound(skey, n, t + 1);
  }
  if (t < n) {
    const long long src = order[t];
    spos[3 * t] = pos[3 * src];
    spos[3 * t + 1] = pos[3 * src + 1];
    spos[3 * t + 2] = pos[3 * src + 2];
    if (vel != nullptr) {
      svel[3 * t] = vel[3 * src];
      svel[3 * t + 1] = vel[3 * src + 1];
      svel[3 * t + 2] = vel[3 * src + 2];
    }
  }
}

}  // namespace

extern "C" int sph_cell_table(const int* skey, const long long* order,
                              const float* pos, const float* vel, int n,
                              int num_cells, float* spos, float* svel,
                              int* cell_start, int* cell_end, void* stream) {
  const int threads = n > num_cells ? n : num_cells;
  if (threads > 0) {
    cell_table_kernel<<<(threads + kBlock - 1) / kBlock, kBlock, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        skey, order, pos, vel, n, num_cells, spos, svel, cell_start,
        cell_end);
  }
  return static_cast<int>(cudaGetLastError());
}
