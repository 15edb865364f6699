// Cell-engine sweep kernels for Hopper (sm_90a), written by hand.
//
// Replaces the Pallas TPU kernels of the JAX package's cell engine:
//   density_kernel    <- sph_tpu/neighbors/pallas_sweeps.py:_density_kernel
//   force_xsph_kernel <- sph_tpu/neighbors/pallas_sweeps.py:_force_xsph_kernel
//   force_xsph_kernel<true> (force_xsph_emit_kernel)
//                     <- the same, with pallas_sweeps.py:_emit_tail
// They compute the same thing; the TPU blocking (pair-packed y rows,
// 128-lane chunks, rank classes, occupancy words, 3x3 block halos) exists
// only for Mosaic and is not carried over.
//
// The emit variant.  On the TPU the force kernel's outputs live in the
// slot table, and _emit_tail streams them, with rho, to rows in sorted-
// particle order (one-hot matmuls into window-padded 64-row tiles, then
// DMAs), so that the substep need not gather them back.  Here the rows
// are already in sorted-particle order, so what is left of it is the
// packing: each row's final npos, nvel, acc and its input rho go to one
// [n][16] float32 row of `per` (cols 0:10 npx npy npz vx vy vz ax ay az
// rho, 10:16 zero, the TPU's emitted columns), as four 16-byte stores of
// one 64-byte row.  No windows, no padding, no one-hot product: those
// exist only for the TPU's layout.  It costs 28 more bytes per row
// written than the three [n][3] outputs; the pair walk is the same.
//
// What bounds them on the card: neighbor-row loads.  Each particle reads
// the position (and, in the force sweep, velocity and density) of about
// 30-60 candidate rows, almost all of which are read again by the
// neighboring threads, so the traffic runs through L1/L2 rather than HBM,
// and the arithmetic per candidate is a few dozen flops.
//
// What the design does about it: the rows are sorted by a y-major cell key
// with x fastest, so the three cells x-1..x+1 at one (y, z) are one
// contiguous row range.  One thread per sorted row walks 9 contiguous
// ranges [cell_start(x0,z,y), cell_end(x1,z,y)) instead of 27 cells, and
// neighboring threads (same or adjacent cell) walk nearly the same rows,
// so the loads hit cache.  No per-cell capacity, so no overflow path.
// Simple first: no shared-memory staging, TMA or wgmma yet.
//
// Semantics are those of sph_tpu/physics/common.py: density includes the
// self pair; the force sweep skips it and reads only live sources
// (rho_j > 0); the XSPH sweep takes the fresh self pos/vel against the
// input (stale) neighbor pos/vel, so npos/nvel/acc go to buffers separate
// from pos/vel.  Rows whose key is num_cells (ghosts, padding) pass
// through: rho = pres = 0, npos = pos, nvel = vel, acc = 0.
//
// Ghost boundary sources (pallas_sweeps.py's ghost classes, :557-621 and
// :697-701): when has_ghosts is set, each fluid row walks the same 9 ranges
// a second time in the ghost structure (contributing ghosts only, sorted by
// the same key, gpos / gcs / gce).  A ghost source has rho0, P = 0 and
// v = 0 (brute_force.py / common.finish_density), is never the row itself,
// and takes the same r < h and r > 0 guards as a fluid source.  Without
// ghosts the second walk is skipped, so a ghost-free state does no extra
// work.

#include <cuda_runtime.h>

#include "sweeps.h"

namespace {

constexpr int kBlock = 128;
constexpr float kXsphCoeff = 0.12f;        // SPHFluid.comp:179
constexpr float kDamping = 0.995f;         // SPHFluid.comp:170
constexpr float kCflFraction = 0.4f;       // SPHFluid3D.cpp:414-416
constexpr float kSurfaceThreshold = 1e-6f; // SPHFluid.comp:159

struct Walk {
  int x0, x1, y0, y1, z0, z1;
};

// The clamped 3x3x3 cell block around cell key k.
__device__ __forceinline__ Walk walk_of(int k, const SphSweepParams& p) {
  const int x = k % p.nx;
  const int t = k / p.nx;
  const int z = t % p.nz;
  const int y = t / p.nz;
  Walk w;
  w.x0 = max(x - 1, 0);
  w.x1 = min(x + 1, p.nx - 1);
  w.y0 = max(y - 1, 0);
  w.y1 = min(y + 1, p.ny - 1);
  w.z0 = max(z - 1, 0);
  w.z1 = min(z + 1, p.nz - 1);
  return w;
}

// Calls f(j) for every row j of the block's 9 contiguous x-ranges.
template <class F>
__device__ __forceinline__ void for_each_candidate(
    const Walk& w, const SphSweepParams& p, const int* __restrict__ cs,
    const int* __restrict__ ce, F f) {
  for (int y = w.y0; y <= w.y1; ++y) {
    for (int z = w.z0; z <= w.z1; ++z) {
      const int row = p.nx * (z + p.nz * y);
      const int end = __ldg(ce + row + w.x1);
      for (int j = __ldg(cs + row + w.x0); j < end; ++j) f(j);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
density_kernel(const int* __restrict__ key, const float* __restrict__ pos,
               const int* __restrict__ cs, const int* __restrict__ ce, int n,
               const float* __restrict__ gpos, const int* __restrict__ gcs,
               const int* __restrict__ gce, int has_ghosts, SphSweepParams p,
               float* __restrict__ rho, float* __restrict__ pres) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  if (k >= p.nx * p.ny * p.nz) {
    rho[i] = 0.f;
    pres[i] = 0.f;
    return;
  }
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const Walk w = walk_of(k, p);
  float sum = 0.f;
  auto add = [&](const float* src, int j) {
    const float dx = xi - __ldg(src + 3 * j);
    const float dy = yi - __ldg(src + 3 * j + 1);
    const float dz = zi - __ldg(src + 3 * j + 2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (r2 < p.h2) {
      const float d = p.h2 - r2;
      sum += d * d * d;
    }
  };
  for_each_candidate(w, p, cs, ce, [&](int j) { add(pos, j); });
  if (has_ghosts) {
    for_each_candidate(w, p, gcs, gce, [&](int j) { add(gpos, j); });
  }
  // mass * poly6 scale and the density floor (SPHFluid.comp:105), EOS,
  // after both walks (common.finish_density)
  const float r = fmaxf(p.mass * p.poly6 * sum, p.rho_floor);
  rho[i] = r;
  pres[i] = fmaxf(p.gas_k * (r - p.rho0), 0.f);
}

// Row i's outputs: npos, nvel, acc into their [n][3] buffers, or, for the
// emit variant, with rho into the 64-byte row per[i] (four float4 stores;
// torch allocations are at least 16-byte aligned, so every row is too).
template <bool kEmit>
__device__ __forceinline__ void store_row(int i, float px, float py, float pz,
                                          float vx, float vy, float vz,
                                          float ax, float ay, float az,
                                          float r, float* __restrict__ npos,
                                          float* __restrict__ nvel,
                                          float* __restrict__ acc,
                                          float* __restrict__ per) {
  if constexpr (kEmit) {
    float4* row = reinterpret_cast<float4*>(per + 16 * static_cast<size_t>(i));
    row[0] = make_float4(px, py, pz, vx);
    row[1] = make_float4(vy, vz, ax, ay);
    row[2] = make_float4(az, r, 0.f, 0.f);
    row[3] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    npos[3 * i] = px;
    npos[3 * i + 1] = py;
    npos[3 * i + 2] = pz;
    nvel[3 * i] = vx;
    nvel[3 * i + 1] = vy;
    nvel[3 * i + 2] = vz;
    acc[3 * i] = ax;
    acc[3 * i + 1] = ay;
    acc[3 * i + 2] = az;
  }
}

template <bool kEmit>
__global__ void __launch_bounds__(kBlock)
force_xsph_kernel(const int* __restrict__ key, const float* __restrict__ pos,
                  const float* __restrict__ vel, const float* __restrict__ rho,
                  const int* __restrict__ cs, const int* __restrict__ ce,
                  int n, const float* __restrict__ gpos,
                  const int* __restrict__ gcs, const int* __restrict__ gce,
                  int has_ghosts, SphSweepParams p, float* __restrict__ npos,
                  float* __restrict__ nvel, float* __restrict__ acc,
                  float* __restrict__ per) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  const float vxi = vel[3 * i], vyi = vel[3 * i + 1], vzi = vel[3 * i + 2];
  const float rhoi = rho[i];
  if (k >= p.nx * p.ny * p.nz) {
    store_row<kEmit>(i, xi, yi, zi, vxi, vyi, vzi, 0.f, 0.f, 0.f, rhoi, npos,
                     nvel, acc, per);
    return;
  }
  const Walk w = walk_of(k, p);
  const float presi = fmaxf(p.gas_k * (rhoi - p.rho0), 0.f);

  // --- pass 1: pressure, viscosity, color field (SPHFluid.comp:129-151)
  float fpx = 0.f, fpy = 0.f, fpz = 0.f;
  float fvx = 0.f, fvy = 0.f, fvz = 0.f;
  float gcx = 0.f, gcy = 0.f, gcz = 0.f, lc = 0.f;
  // one source: offset r, distance, its density, pressure and velocity
  auto pair = [&](float rx, float ry, float rz, float r, float rhoj,
                  float presj, float vxj, float vyj, float vzj) {
    const float m_over_rho = p.mass / fmaxf(rhoj, 1e-12f);
    const float dcl = p.h - r;
    const float gmag = r > 0.f ? p.spiky * dcl * dcl / fmaxf(r, 1e-12f) : 0.f;
    const float lapw = p.visc_lap * dcl;
    const float ps = gmag * (-(presi + presj) * 0.5f * m_over_rho);
    fpx += rx * ps;
    fpy += ry * ps;
    fpz += rz * ps;
    const float vs = m_over_rho * lapw;
    fvx += (vxj - vxi) * vs;
    fvy += (vyj - vyi) * vs;
    fvz += (vzj - vzi) * vs;
    const float gs = gmag * m_over_rho;
    gcx += rx * gs;
    gcy += ry * gs;
    gcz += rz * gs;
    lc += vs;
  };
  for_each_candidate(w, p, cs, ce, [&](int j) {
    if (j == i) return;
    const float rhoj = __ldg(rho + j);
    const float rx = xi - __ldg(pos + 3 * j);
    const float ry = yi - __ldg(pos + 3 * j + 1);
    const float rz = zi - __ldg(pos + 3 * j + 2);
    const float r = sqrtf(rx * rx + ry * ry + rz * rz);
    if (!(r < p.h) || !(rhoj > 0.f)) return;
    pair(rx, ry, rz, r, rhoj, fmaxf(p.gas_k * (rhoj - p.rho0), 0.f),
         __ldg(vel + 3 * j), __ldg(vel + 3 * j + 1), __ldg(vel + 3 * j + 2));
  });
  if (has_ghosts) {
    for_each_candidate(w, p, gcs, gce, [&](int j) {
      const float rx = xi - __ldg(gpos + 3 * j);
      const float ry = yi - __ldg(gpos + 3 * j + 1);
      const float rz = zi - __ldg(gpos + 3 * j + 2);
      const float r = sqrtf(rx * rx + ry * ry + rz * rz);
      if (!(r < p.h)) return;
      pair(rx, ry, rz, r, p.rho0, 0.f, 0.f, 0.f, 0.f);
    });
  }

  // --- surface tension, gravity, integrate (SPHFluid.comp:156-171)
  const float glen = sqrtf(gcx * gcx + gcy * gcy + gcz * gcz);
  float stx = 0.f, sty = 0.f, stz = 0.f;
  if (glen > kSurfaceThreshold) {
    const float g = fmaxf(glen, 1e-30f);
    const float c = -p.st * lc;
    stx = c * (gcx / g);
    sty = c * (gcy / g);
    stz = c * (gcz / g);
  }
  const float rs = fmaxf(rhoi, 1e-12f);
  const float ax = (fpx + p.mu * fvx + p.gx * rhoi + stx) / rs;
  const float ay = (fpy + p.mu * fvy + p.gy * rhoi + sty) / rs;
  const float az = (fpz + p.mu * fvz + p.gz * rhoi + stz) / rs;
  const float nvx = (vxi + ax * p.dt) * kDamping;
  const float nvy = (vyi + ay * p.dt) * kDamping;
  const float nvz = (vzi + az * p.dt) * kDamping;
  const float npx = xi + nvx * p.dt;
  const float npy = yi + nvy * p.dt;
  const float npz = zi + nvz * p.dt;

  // --- pass 2: XSPH, fresh self vs stale neighbors (SPHFluid.comp:177-201)
  float xsx = 0.f, xsy = 0.f, xsz = 0.f, xn = 0.f;
  // one source within h: squared distance, its density and velocity
  auto smooth = [&](float r2, float rhoj, float vxj, float vyj, float vzj) {
    const float d = p.h2 - r2;
    const float wgt = p.poly6 * d * d * d;
    const float mw = wgt * p.mass / fmaxf(rhoj, 1e-12f);
    xsx += (vxj - nvx) * mw;
    xsy += (vyj - nvy) * mw;
    xsz += (vzj - nvz) * mw;
    xn += wgt;
  };
  for_each_candidate(w, p, cs, ce, [&](int j) {
    if (j == i) return;
    const float rhoj = __ldg(rho + j);
    const float dx = npx - __ldg(pos + 3 * j);
    const float dy = npy - __ldg(pos + 3 * j + 1);
    const float dz = npz - __ldg(pos + 3 * j + 2);
    const float r2 = dx * dx + dy * dy + dz * dz;
    if (!(r2 < p.h2) || !(rhoj > 0.f)) return;
    smooth(r2, rhoj, __ldg(vel + 3 * j), __ldg(vel + 3 * j + 1),
           __ldg(vel + 3 * j + 2));
  });
  if (has_ghosts) {
    for_each_candidate(w, p, gcs, gce, [&](int j) {
      const float dx = npx - __ldg(gpos + 3 * j);
      const float dy = npy - __ldg(gpos + 3 * j + 1);
      const float dz = npz - __ldg(gpos + 3 * j + 2);
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < p.h2)) return;
      smooth(r2, p.rho0, 0.f, 0.f, 0.f);
    });
  }

  // --- XSPH apply (SPHFluid.comp:200-201) and CFL cap (:203-207)
  float vx = nvx, vy = nvy, vz = nvz;
  if (xn > 0.f) {
    const float norm = fmaxf(xn, 1e-30f);
    vx += kXsphCoeff * (xsx / norm);
    vy += kXsphCoeff * (xsy / norm);
    vz += kXsphCoeff * (xsz / norm);
  }
  const float max_speed = kCflFraction * p.h / fmaxf(p.dt, 1e-6f);
  const float sp = sqrtf(vx * vx + vy * vy + vz * vz);
  const float scale = sp > max_speed ? max_speed / fmaxf(sp, 1e-30f) : 1.f;

  store_row<kEmit>(i, npx, npy, npz, vx * scale, vy * scale, vz * scale, ax,
                   ay, az, rhoi, npos, nvel, acc, per);
}

int grid_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" int sph_density(const int* key, const float* pos,
                           const int* cell_start, const int* cell_end, int n,
                           const float* ghost_pos, const int* ghost_start,
                           const int* ghost_end, int has_ghosts,
                           const SphSweepParams* params, float* rho,
                           float* pres, void* stream) {
  if (n > 0) {
    density_kernel<<<grid_for(n), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        key, pos, cell_start, cell_end, n, ghost_pos, ghost_start, ghost_end,
        has_ghosts, *params, rho, pres);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_force_xsph(const int* key, const float* pos,
                              const float* vel, const float* rho,
                              const int* cell_start, const int* cell_end,
                              int n, const float* ghost_pos,
                              const int* ghost_start, const int* ghost_end,
                              int has_ghosts, const SphSweepParams* params,
                              float* npos, float* nvel, float* acc,
                              void* stream) {
  if (n > 0) {
    force_xsph_kernel<false><<<grid_for(n), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        key, pos, vel, rho, cell_start, cell_end, n, ghost_pos, ghost_start,
        ghost_end, has_ghosts, *params, npos, nvel, acc, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_force_xsph_emit(const int* key, const float* pos,
                                   const float* vel, const float* rho,
                                   const int* cell_start, const int* cell_end,
                                   int n, const float* ghost_pos,
                                   const int* ghost_start,
                                   const int* ghost_end, int has_ghosts,
                                   const SphSweepParams* params, float* per,
                                   void* stream) {
  if (n > 0) {
    force_xsph_kernel<true><<<grid_for(n), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        key, pos, vel, rho, cell_start, cell_end, n, ghost_pos, ghost_start,
        ghost_end, has_ghosts, *params, nullptr, nullptr, nullptr, per);
  }
  return static_cast<int>(cudaGetLastError());
}
