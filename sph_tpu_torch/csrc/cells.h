// C interface of the cell-table kernel (cells.cu).
//
// Every pointer is device memory laid out as the port's tensors are:
// skey [n] int32 ascending (rows outside the table carry num_cells),
// order [n] int64 (the permutation torch.sort returned with skey),
// pos / vel [*][3] float32 in unsorted order, spos / svel [n][3] float32,
// cell_start / cell_end [num_cells] int32.  vel and svel may both be null
// (the ghost structure holds positions only).  The launch goes on `stream`
// (a cudaStream_t); the function neither synchronises nor allocates, and
// returns cudaGetLastError() after its launch: 0 means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

int sph_cell_table(const int* skey, const long long* order, const float* pos,
                   const float* vel, int n, int num_cells, float* spos,
                   float* svel, int* cell_start, int* cell_end, void* stream);

#ifdef __cplusplus
}
#endif
