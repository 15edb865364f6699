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
// cell_table_kernel, one launch, two kinds of blocks:
//   - a bounds block finds bounds[c], the first row with key >= c, for 1,024
//     consecutive cells c, with torch.searchsorted's semantics: cell c's
//     rows are [bounds[c], bounds[c + 1]), so an empty cell has start = end
//     = its insertion point (never 0, which would send the sweeps' x-range
//     walks from row 0).  One array backs cell_start and cell_end: the end
//     of a cell IS the start of the next.
//   - a row block writes 256 sorted rows: every column of the state moves
//     through order[t] as raw 32-bit words (float32 and int32 alike), all
//     loads of a row first and then its stores.
// No atomics, no memset, and the result does not depend on scheduling.
//
// The bounds.  The first kernel ran two full binary searches a cell, each
// about log2(n) = 21 dependent reads of skey at ghost_1m's 1.15M rows, every
// lane from [0, n), and half of them found what the neighbor thread found.
// Here the ranges come from the row side.  Two warps of a block find the
// block's own rows [lo, hi) with a 32-way search each (a lane probes the
// end of one thirty-second of the interval, one ballot picks the segment: 5
// rounds where a binary search takes 21).  The block reads those rows once,
// four keys a thread in one 16-byte load, and a row whose key differs from
// the row before it marks its cell's start in shared memory.  An empty cell
// takes the start of the next occupied cell, or hi: a suffix minimum over
// the block's marks, scanned in registers, across the warp and across the
// warps, never by one thread walking a gap (the grid's head and its empty
// upper half are a million empty cells at ghost_1m).  The rows outside the
// table, a crowd of 148k in the last cell at ghost_1m, are not read: that
// cell needs only its first row, which is the last block's hi.
//
// The rows.  Reads through order[t] are nearly in order from the second
// substep on (the state stays sorted); the [n][3] outputs go through shared
// memory so that a warp stores its 384 bytes as 24 16-byte stores and not as
// 96 4-byte ones.  The two kinds of blocks alternate in the grid, so that
// the bounds blocks' waits hide under the row blocks' streaming.
//
// What bounds it on the card (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md
// section 6): bytes.  At ghost_1m the bounds alone take 0.0095 ms and the
// rows of pos and vel alone 0.025 ms, 64 MB at 2.5 TB/s; with the state's
// ten other columns the launch moves 189 MB (10 MB of them the bounds) in
// 0.071 ms.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "cells.h"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kCellsPerThread = 4;         // a multiple of 4
constexpr int kCells = kBlock * kCellsPerThread;   // cells a bounds block
constexpr unsigned kFullWarp = 0xffffffffu;

// First index in skey[0, n) whose key is >= c, found by the whole warp: all
// lanes call it with the same c and get the same result.
__device__ __forceinline__ int warp_lower_bound(const int* __restrict__ skey,
                                                int n, int c, int lane) {
  int lo = 0, hi = n;                      // the answer lies in [lo, hi]
  while (lo < hi) {
    // lane l probes the last row of the l-th of 32 segments of [lo, hi)
    const int stride = (hi - lo + 31) >> 5;
    const int probe = min(lo + (lane + 1) * stride, hi) - 1;
    const int below =
        __popc(__ballot_sync(kFullWarp, __ldg(skey + probe) < c));
    if (below == 32) {
      lo = hi;
    } else {
      hi = min(lo + (below + 1) * stride, hi) - 1;
      lo += below * stride;
    }
  }
  return lo;
}

// bounds[c] for the block's kCells consecutive cells.
__device__ __forceinline__ void bounds_block(const int* __restrict__ skey,
                                             int n, int num_cells, int block,
                                             int* __restrict__ bounds) {
  __shared__ __align__(16) int mark[kCells];
  __shared__ int edge[2], warp_min[kWarps];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int first = block * kCells;        // the block's first cell
  // The block's rows are [edge[0], edge[1]): two warps find an end each.
  // Cell num_cells (every row outside the table, a crowd) needs only its
  // first row, which is the last block's second edge.
  if (warp < 2) {
    const int c = min(first + warp * kCells, num_cells);
    const int e = warp_lower_bound(skey, n, c, lane);
    if (lane == 0) edge[warp] = e;
  }
  for (int c = tid; c < kCells; c += kBlock) mark[c] = INT_MAX;
  __syncthreads();
  const int lo = edge[0], hi = edge[1];
  // A row whose key differs from the row before it is its cell's first.
  // Four rows a thread, from one aligned 16-byte load of skey.
  for (int r = (lo & ~3) + 4 * tid; r < hi; r += 4 * kBlock) {
    int k[5];
    k[0] = r > 0 ? __ldg(skey + r - 1) : -1;
    if (r + 3 < n) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(skey + r));
      k[1] = v.x, k[2] = v.y, k[3] = v.z, k[4] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        k[q + 1] = r + q < n ? __ldg(skey + r + q) : INT_MAX;
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int row = r + q;
      if (row >= lo && row < hi && (row == lo || k[q] != k[q + 1])) {
        mark[k[q + 1] - first] = row;
      }
    }
  }
  __syncthreads();
  // An empty cell's bound is the first row of the next occupied cell, or
  // the block's last edge: a suffix minimum, since the marks ascend.  Each
  // thread takes kCellsPerThread consecutive cells, then the threads' minima
  // are scanned across the warp and the warps' across the block.
  int v[kCellsPerThread];
  const int4* mine =
      reinterpret_cast<const int4*>(mark + kCellsPerThread * tid);
#pragma unroll
  for (int q = 0; q < kCellsPerThread / 4; ++q) {
    const int4 m = mine[q];
    v[4 * q] = m.x, v[4 * q + 1] = m.y, v[4 * q + 2] = m.z, v[4 * q + 3] = m.w;
  }
  int run = INT_MAX;
#pragma unroll
  for (int s = kCellsPerThread - 1; s >= 0; --s) v[s] = run = min(run, v[s]);
  int agg = run;                           // minimum over lanes lane .. 31
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int other = __shfl_down_sync(kFullWarp, agg, d);
    if (lane + d < 32) agg = min(agg, other);
  }
  if (lane == 0) warp_min[warp] = agg;
  int after = __shfl_down_sync(kFullWarp, agg, 1);   // lanes lane + 1 .. 31
  if (lane == 31) after = hi;
  __syncthreads();
  for (int w = warp + 1; w < kWarps; ++w) after = min(after, warp_min[w]);
  after = min(after, hi);
  const int c = first + kCellsPerThread * tid;
  if (c + kCellsPerThread - 1 <= num_cells) {
    int4* out = reinterpret_cast<int4*>(bounds + c);
#pragma unroll
    for (int q = 0; q < kCellsPerThread / 4; ++q) {
      out[q] = make_int4(min(v[4 * q], after), min(v[4 * q + 1], after),
                         min(v[4 * q + 2], after), min(v[4 * q + 3], after));
    }
  } else {
#pragma unroll
    for (int s = 0; s < kCellsPerThread; ++s) {
      if (c + s <= num_cells) bounds[c + s] = min(v[s], after);
    }
  }
}

// Sorted rows [256 block, 256 block + 256) of every column.
__device__ __forceinline__ void row_block(const long long* __restrict__ order,
                                          int n, int block,
                                          const SphCellColumns& cols) {
  __shared__ __align__(16) uint32_t stage[kWarps][96];
  const int t = block * kBlock + threadIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // no thread leaves before the last __syncwarp
  const bool in = t < n;
  const int src = in ? static_cast<int>(order[t]) : 0;
  uint32_t wide[SPH_CELL_MAX_WIDE][3], narrow[SPH_CELL_MAX_NARROW];
#pragma unroll
  for (int c = 0; c < SPH_CELL_MAX_WIDE; ++c) {
    if (c < cols.n_wide && in) {
      const uint32_t* from = static_cast<const uint32_t*>(cols.wide_in[c]) +
                             static_cast<size_t>(src) * cols.wide_stride[c];
      wide[c][0] = __ldg(from);
      wide[c][1] = __ldg(from + 1);
      wide[c][2] = __ldg(from + 2);
    }
  }
#pragma unroll
  for (int c = 0; c < SPH_CELL_MAX_NARROW; ++c) {
    if (c < cols.n_narrow && in) {
      narrow[c] = __ldg(static_cast<const uint32_t*>(cols.narrow_in[c]) +
                        static_cast<size_t>(src) * cols.narrow_stride[c]);
    }
  }
  // A warp's 32 rows of a [n][3] column are 96 consecutive words, 16-byte
  // aligned: staged in shared memory and stored four words a lane.
  const int first = block * kBlock + 32 * warp;
  const int words = 3 * min(32, n - first);
#pragma unroll
  for (int c = 0; c < SPH_CELL_MAX_WIDE; ++c) {
    if (c < cols.n_wide) {
      if (in) {
        stage[warp][3 * lane] = wide[c][0];
        stage[warp][3 * lane + 1] = wide[c][1];
        stage[warp][3 * lane + 2] = wide[c][2];
      }
      __syncwarp();
      uint32_t* out = static_cast<uint32_t*>(cols.wide_out[c]) +
                      3 * static_cast<size_t>(first);
      if (4 * lane + 3 < words) {
        *reinterpret_cast<uint4*>(out + 4 * lane) =
            *reinterpret_cast<const uint4*>(&stage[warp][4 * lane]);
      } else {
        for (int w = 4 * lane; w < words && w < 4 * lane + 4; ++w) {
          out[w] = stage[warp][w];
        }
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int c = 0; c < SPH_CELL_MAX_NARROW; ++c) {
    if (c < cols.n_narrow && in) {
      static_cast<uint32_t*>(cols.narrow_out[c])[t] = narrow[c];
    }
  }
}

// bounds_blocks of the grid's blocks find the cells' bounds, the others move
// rows.
__global__ void __launch_bounds__(kBlock)
cell_table_kernel(const int* __restrict__ skey,
                  const long long* __restrict__ order, int n, int num_cells,
                  int bounds_blocks, SphCellColumns cols,
                  int* __restrict__ bounds) {
  // the two kinds alternate while both last, so that the bounds blocks'
  // waits hide under the row blocks' streaming
  const int block = blockIdx.x;
  const int row_blocks = gridDim.x - bounds_blocks;
  const int both = 2 * min(bounds_blocks, row_blocks);
  bool is_bounds;
  int index;
  if (block < both) {
    is_bounds = (block & 1) == 0;
    index = block >> 1;
  } else {
    is_bounds = bounds_blocks > row_blocks;
    index = block - both / 2;
  }
  if (is_bounds) {
    bounds_block(skey, n, num_cells, index, bounds);
  } else {
    row_block(order, n, index, cols);
  }
}

}  // namespace

extern "C" int sph_cell_table(const int* skey, const long long* order, int n,
                              int num_cells, const SphCellColumns* columns,
                              int* bounds, void* stream) {
  const int bounds_blocks = num_cells / kCells + 1;
  const int row_blocks = (n + kBlock - 1) / kBlock;
  cell_table_kernel<<<bounds_blocks + row_blocks, kBlock, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      skey, order, n, num_cells, bounds_blocks, *columns, bounds);
  return static_cast<int>(cudaGetLastError());
}
