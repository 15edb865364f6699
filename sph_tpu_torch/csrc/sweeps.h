// C interface of the cell-engine sweep kernels (sweeps.cu).
//
// Every pointer is device memory laid out as the port's tensors are:
// key [n] int32 (ascending cell keys, num_cells for non-fluid rows),
// pos / vel / npos / nvel / acc [n][3] float32, rho / pres [n] float32,
// cell_start / cell_end [num_cells] int32.  The ghost structure:
// ghost_pos [g][3] float32 (contributing ghosts sorted by the same key),
// ghost_start / ghost_end [num_cells] int32; with has_ghosts 0 the
// pointers are not read and may be null.  The density sweep takes
// ghost_near [num_cells] uint8 in place of the flag: whether any cell of the
// cell's 3x3x3 block holds a ghost (it walks the ghost ranges only there);
// a null ghost_near means no ghosts.
//
// The source records, src [2][src_rows][4] float32, 16-byte aligned, are
// what the force sweep reads of a source: src[0][j] = (x, y, z, rho) and
// src[1][j] = (vx, vy, vz, mass / max(rho, 1e-12)).  Rows [0, n) are the
// sorted rows; rows [n, n + g) are the ghost structure's rows in its order
// (rho0, v = 0), so src_rows >= n + g.  sph_density writes rows [0, n) when
// given vel and src (both may be null: then it writes none);
// the force sweeps read all of them.
//
// The sweep constants, params, are device memory too: 15 float32 words in
// the order of SphSweepParams (sweeps.make_pvec writes them on the device),
// which the kernels load at their start; the grid dims go by value.  So a
// launch captured into a CUDA graph reads the block's values when the graph
// replays, not when it was captured.
//
// The launch goes on `stream` (a cudaStream_t) and no function synchronises
// or allocates.  Each returns cudaGetLastError() after its launch: 0 means
// launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// Counterpart of the JAX package's pvec (pallas_sweeps.py:104-115): the
// layout of the device block `params`.
typedef struct {
  float h, h2, mass;
  float spiky;      // -45 / (pi h^6)
  float visc_lap;   //  45 / (pi h^6)
  float poly6;      // 315 / (64 pi h^9)
  float mu, st;     // viscosity, surface tension
  float gx, gy, gz;
  float dt, rho0, gas_k;
  float rho_floor;  // 0.5 rho0
} SphSweepParams;

// The grid dims (nx, ny, nz), passed to the kernels by value.
typedef struct {
  int nx, ny, nz;
} SphGrid;

int sph_density(const int* key, const float* pos, const float* vel,
                const int* cell_start, const int* cell_end, int n,
                const float* ghost_pos, const int* ghost_start,
                const int* ghost_end, const unsigned char* ghost_near,
                const SphSweepParams* params, int nx, int ny, int nz,
                float* rho, float* pres, float* src, int src_rows,
                void* stream);

int sph_force_xsph(const int* key, const float* src, int src_rows,
                   const int* cell_start, const int* cell_end, int n,
                   const int* ghost_start, const int* ghost_end,
                   int has_ghosts, const SphSweepParams* params, int nx,
                   int ny, int nz, float* npos, float* nvel, float* acc,
                   void* stream, int* tile_warps);

// tile_warps: null (the main path), or an int in device memory to which
// each warp of 32 rows that takes the kernel's tile path (all 32 rows fluid
// and in one cell, or in two cells side by side in x) adds 1, with one
// atomicAdd.

// The same sweep, its outputs packed with rho into per [n][16] float32:
// cols 0:3 npos, 3:6 nvel, 6:9 acc, 9 rho (the input), 10:16 zero.
int sph_force_xsph_emit(const int* key, const float* src, int src_rows,
                        const int* cell_start, const int* cell_end, int n,
                        const int* ghost_start, const int* ghost_end,
                        int has_ghosts, const SphSweepParams* params,
                        int nx, int ny, int nz, float* per, void* stream,
                        int* tile_warps);

#ifdef __cplusplus
}
#endif
