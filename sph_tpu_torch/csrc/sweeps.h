// C interface of the cell-engine sweep kernels (sweeps.cu).
//
// Every pointer is device memory laid out as the port's tensors are:
// key [n] int32 (ascending cell keys, num_cells for non-fluid rows),
// pos / vel / npos / nvel / acc [n][3] float32, rho / pres [n] float32,
// cell_start / cell_end [num_cells] int32.  The ghost structure:
// ghost_pos [g][3] float32 (contributing ghosts sorted by the same key),
// ghost_start / ghost_end [num_cells] int32; with has_ghosts 0 the three
// pointers are not read and may be null.  The launch goes on `stream`
// (a cudaStream_t) and neither function synchronises or allocates.
// Each returns cudaGetLastError() after its launch: 0 means launched.
#pragma once

#ifdef __cplusplus
extern "C" {
#endif

// Counterpart of the JAX package's pvec (pallas_sweeps.py:104-115) plus
// the grid dims; passed to the kernels by value.
typedef struct {
  float h, h2, mass;
  float spiky;      // -45 / (pi h^6)
  float visc_lap;   //  45 / (pi h^6)
  float poly6;      // 315 / (64 pi h^9)
  float mu, st;     // viscosity, surface tension
  float gx, gy, gz;
  float dt, rho0, gas_k;
  float rho_floor;  // 0.5 rho0
  int nx, ny, nz;
} SphSweepParams;

int sph_density(const int* key, const float* pos, const int* cell_start,
                const int* cell_end, int n, const float* ghost_pos,
                const int* ghost_start, const int* ghost_end, int has_ghosts,
                const SphSweepParams* params, float* rho, float* pres,
                void* stream);

int sph_force_xsph(const int* key, const float* pos, const float* vel,
                   const float* rho, const int* cell_start,
                   const int* cell_end, int n, const float* ghost_pos,
                   const int* ghost_start, const int* ghost_end,
                   int has_ghosts, const SphSweepParams* params, float* npos,
                   float* nvel, float* acc, void* stream);

// The same sweep, its outputs packed with rho into per [n][16] float32:
// cols 0:3 npos, 3:6 nvel, 6:9 acc, 9 rho (the input), 10:16 zero.
int sph_force_xsph_emit(const int* key, const float* pos, const float* vel,
                        const float* rho, const int* cell_start,
                        const int* cell_end, int n, const float* ghost_pos,
                        const int* ghost_start, const int* ghost_end,
                        int has_ghosts, const SphSweepParams* params,
                        float* per, void* stream);

#ifdef __cplusplus
}
#endif
