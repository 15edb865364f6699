// C interface of the all-pairs kernels (brute.cu).
//
// Every pointer is device memory laid out as the port's tensors are, rows
// in particle order (this engine never sorts): pos / vel / npos / nvel /
// acc [n][3] float32; contrib / rho / pres / rho_raw [n] float32, where
// contrib is 1 for a neighbor source and 0 otherwise.  The params are the
// cell engine's SphSweepParams (sweeps.h), in device memory as there; the
// all-pairs kernels read h, h2, mass, spiky, visc_lap, poly6, mu, st, gx,
// gy, gz and dt, and ignore the rest (rho0, gas_k, rho_floor).  The launch
// goes on `stream` (a cudaStream_t) and neither function synchronises or
// allocates.  Each returns cudaGetLastError() after its launch: 0 means
// launched.
#pragma once

#include "sweeps.h"

#ifdef __cplusplus
extern "C" {
#endif

// rho_raw[i] = mass * poly6 * sum_j contrib_j (h^2 - r_ij^2)^3 over
// r_ij^2 < h^2, self included, no floor.
int sph_brute_density(const float* pos, const float* contrib, int n,
                      const SphSweepParams* params, float* rho_raw,
                      void* stream);

// Force + integrate + XSPH + XSPH apply + CFL cap over all pairs j != i
// whose source is live (rho_j > 0 and contrib_j > 0).
int sph_brute_force(const float* pos, const float* vel, const float* rho,
                    const float* pres, const float* contrib, int n,
                    const SphSweepParams* params, float* npos, float* nvel,
                    float* acc, void* stream);

#ifdef __cplusplus
}
#endif
