// C interface of the cell-table kernel (cells.cu).
//
// Every pointer is device memory laid out as the port's tensors are:
// skey [n] int32 ascending (rows outside the table carry num_cells),
// order [n] int64 (the permutation torch.sort returned with skey), and the
// columns that move with the rows, each an array of 4-byte words (float32
// or int32, moved as raw words): wide columns [*][3] (pos first, then vel,
// acc, ...) and narrow columns [*] in unsorted order, each with its row
// stride in words (3 and 1 when contiguous; a column may be a strided view
// of a wider buffer), and their sorted copies [n][3] and [n], contiguous and
// 16-byte aligned.  skey is 16-byte aligned too.
// bounds [num_cells + 1] int32 receives, for every c in [0, num_cells], the
// first row whose key is >= c: cell c's rows are [bounds[c], bounds[c + 1]).
// The launch goes on `stream` (a cudaStream_t); the function neither
// synchronises nor allocates, and returns cudaGetLastError() after its
// launch: 0 means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

#define SPH_CELL_MAX_WIDE 4
#define SPH_CELL_MAX_NARROW 12

// The columns of one launch, passed to the kernel by value.
typedef struct {
  const void* wide_in[SPH_CELL_MAX_WIDE];
  void* wide_out[SPH_CELL_MAX_WIDE];
  const void* narrow_in[SPH_CELL_MAX_NARROW];
  void* narrow_out[SPH_CELL_MAX_NARROW];
  int wide_stride[SPH_CELL_MAX_WIDE];
  int narrow_stride[SPH_CELL_MAX_NARROW];
  int n_wide, n_narrow;
} SphCellColumns;

int sph_cell_table(const int* skey, const long long* order, int n,
                   int num_cells, const SphCellColumns* columns, int* bounds,
                   void* stream);

#ifdef __cplusplus
}
#endif
