// C interface of the micro-kernels (micro.cu).
//
// Every pointer is device memory laid out as the port's tensors are.  The
// launch goes on `stream` (a cudaStream_t); neither function synchronises
// or allocates, and each returns cudaGetLastError() after its launch: 0
// means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// out[i] = 0 + 2 x[i] + 2 x[i] + 2 x[i] + 2 x[i], left to right, for n
// float32 values (x and out 16-byte aligned).
int sph_smoke(const float* x, float* out, int n, void* stream);

// starts [nrow + 1] int32 (ascending, starts[0] = 0); rows [*][width]
// float32, element j's payload in columns 0:fields and its target slot in
// column `fields` (ascending and unique within each row, in [0, slots));
// out [nrow][fields][slots] float32: out[y][c][target_j] = rows[j][c] for
// the elements j of row y, -1 in every other slot.  fields must be 8, the
// width a multiple of 4, and rows and out 16-byte aligned; otherwise
// nothing is launched and cudaErrorInvalidValue is returned.
int sph_expand(const int* starts, const float* rows, int nrow, int fields,
               int slots, int width, float* out, void* stream);

#ifdef __cplusplus
}
#endif
