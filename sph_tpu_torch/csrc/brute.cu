// All-pairs kernels for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas TPU kernels of the JAX package's all-pairs
// engine (BASELINE config 1, dam_break_8k):
//   brute_density_kernel <- sph_tpu/physics/brute_pallas.py:_density_kernel
//   brute_force_kernel   <- sph_tpu/physics/brute_pallas.py:_force_kernel
// They compute the same thing; the TPU layout ([Np, 128] lane-padded i
// rows, the [9, Np] transposed j side resident in VMEM, 512-wide j chunks)
// is not carried over: the kernels read the port's [n][3] and [n] tensors.
//
// What bounds them on the card: arithmetic.  Every pass tests all n^2
// pairs (about nine float32 operations each for the distance, 67.1M pairs
// per pass at 8,192 rows), while the inputs are a few hundred kilobytes
// that stay in L1/L2.  Only the few dozen pairs per row within h do the
// full pair math, behind a branch.
//
// What the design does about it: the classic n-body shape, with the j
// loop split across warps so that 8,192 rows still fill the card.  A block
// holds 32 i rows (one per lane) and 8 warps; warp w walks the j tiles
// w, w + 8, w + 16, ... of 32 rows each, staging each tile in shared
// memory (one j row loaded per lane) and reading it back as a broadcast.
// The 8 partial sums of a row are added in shared memory, in a fixed
// order.  The force kernel makes two passes over j (force, then XSPH) and
// writes to buffers separate from its inputs, because XSPH reads the
// stale neighbor pos/vel against the fresh self pos/vel; between the two
// passes every warp adds the 8 pass-1 partials itself, so each holds the
// row's fresh pos/vel without another round trip.  Simple first: no TMA,
// no wgmma (there is no matrix product); the only tuning is unrolling the
// pair loops by 8.
//
// Semantics are those of brute_pallas.py: rows keep their order, so the
// self pair is excluded by row index (j != i); density includes the self
// pair, weights by contrib_j only and applies no floor (finish_density
// does, afterwards, over every row); the force and XSPH passes take a
// source only when rho_j > 0 and contrib_j > 0; r = r2 * rsqrt(max(r2,
// 1e-24)) as in the TPU kernel, with gmag = 0 at r2 = 0; mu is folded in
// per pair.  The constants and pair math follow sweeps.cu.

#include <cuda_runtime.h>

#include "brute.h"

namespace {

constexpr int kRows = 32;    // i rows per block, one per lane
constexpr int kSlices = 8;   // warps per block, each over its own j tiles
constexpr int kBlock = kRows * kSlices;
constexpr float kXsphCoeff = 0.12f;        // SPHFluid.comp:179
constexpr float kDamping = 0.995f;         // SPHFluid.comp:170
constexpr float kCflFraction = 0.4f;       // SPHFluid3D.cpp:414-416
constexpr float kSurfaceThreshold = 1e-6f; // SPHFluid.comp:159
// r2 prefilter of the r < h test: r2 * rsqrt(r2) < h implies r2 below
// this (rsqrt is within a few ulp), so the exact test sees every pair.
constexpr float kPrefilter = 1.0001f;

__global__ void __launch_bounds__(kBlock)
brute_density_kernel(const float* __restrict__ pos,
                     const float* __restrict__ contrib, int n,
                     SphSweepParams p, float* __restrict__ rho_raw) {
  __shared__ float4 tile[kSlices][kRows];   // x, y, z, contrib
  __shared__ float part[kSlices][kRows];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRows + lane;
  const bool row = i < n;
  const float xi = row ? pos[3 * i] : 0.f;
  const float yi = row ? pos[3 * i + 1] : 0.f;
  const float zi = row ? pos[3 * i + 2] : 0.f;

  float sum = 0.f;
  const int tiles = (n + kRows - 1) / kRows;
  for (int t = warp; t < tiles; t += kSlices) {
    const int j = t * kRows + lane;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < n) {
      s = make_float4(__ldg(pos + 3 * j), __ldg(pos + 3 * j + 1),
                      __ldg(pos + 3 * j + 2), __ldg(contrib + j));
    }
    tile[warp][lane] = s;
    __syncwarp();
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const float4 q = tile[warp][k];
      const float dx = xi - q.x;
      const float dy = yi - q.y;
      const float dz = zi - q.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (r2 < p.h2) {
        const float d = p.h2 - r2;
        sum += d * d * d * q.w;
      }
    }
    __syncwarp();
  }
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && row) {
    float total = 0.f;
    for (int w = 0; w < kSlices; ++w) total += part[w][lane];
    rho_raw[i] = p.mass * p.poly6 * total;
  }
}

// One j tile of the force kernel in shared memory, per warp.
struct ForceTile {
  float4 pos[kSlices][kRows];   // x, y, z, live (1 or 0)
  float4 vel[kSlices][kRows];   // vx, vy, vz, mass / max(rho, 1e-12)
  float2 src[kSlices][kRows];   // pres, max(rho, 1e-12)
};

__device__ __forceinline__ void load_tile(
    ForceTile& tl, int warp, int lane, int t, int n,
    const float* __restrict__ pos, const float* __restrict__ vel,
    const float* __restrict__ rho, const float* __restrict__ pres,
    const float* __restrict__ contrib, float mass) {
  const int j = t * kRows + lane;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
  float2 c = make_float2(0.f, 1.f);
  if (j < n) {
    const float rj = __ldg(rho + j);
    const bool live = rj > 0.f && __ldg(contrib + j) > 0.f;
    const float rs = fmaxf(rj, 1e-12f);
    a = make_float4(__ldg(pos + 3 * j), __ldg(pos + 3 * j + 1),
                    __ldg(pos + 3 * j + 2), live ? 1.f : 0.f);
    b = make_float4(__ldg(vel + 3 * j), __ldg(vel + 3 * j + 1),
                    __ldg(vel + 3 * j + 2), mass / rs);
    c = make_float2(__ldg(pres + j), rs);
  }
  tl.pos[warp][lane] = a;
  tl.vel[warp][lane] = b;
  tl.src[warp][lane] = c;
  __syncwarp();
}

__global__ void __launch_bounds__(kBlock)
brute_force_kernel(const float* __restrict__ pos,
                   const float* __restrict__ vel,
                   const float* __restrict__ rho,
                   const float* __restrict__ pres,
                   const float* __restrict__ contrib, int n,
                   SphSweepParams p, float* __restrict__ npos,
                   float* __restrict__ nvel, float* __restrict__ acc) {
  __shared__ ForceTile tl;
  __shared__ float part1[7][kSlices][kRows];   // fp xyz, gc xyz, lc
  __shared__ float part2[4][kSlices][kRows];   // xsph sum xyz, norm
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int i = blockIdx.x * kRows + lane;
  const bool row = i < n;
  const float xi = row ? pos[3 * i] : 0.f;
  const float yi = row ? pos[3 * i + 1] : 0.f;
  const float zi = row ? pos[3 * i + 2] : 0.f;
  const float vxi = row ? vel[3 * i] : 0.f;
  const float vyi = row ? vel[3 * i + 1] : 0.f;
  const float vzi = row ? vel[3 * i + 2] : 0.f;
  const float rhoi = row ? rho[i] : 0.f;
  const float presi = row ? pres[i] : 0.f;
  const int tiles = (n + kRows - 1) / kRows;
  const float r2_pre = p.h2 * kPrefilter;

  // --- pass 1: pressure, viscosity, color field (brute_pallas.py:107-150)
  float fpx = 0.f, fpy = 0.f, fpz = 0.f;
  float gcx = 0.f, gcy = 0.f, gcz = 0.f, lc = 0.f;
  for (int t = warp; t < tiles; t += kSlices) {
    load_tile(tl, warp, lane, t, n, pos, vel, rho, pres, contrib, p.mass);
    const int self = i - t * kRows;   // the row's own k in this tile, if any
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const float4 a = tl.pos[warp][k];
      const float dx = xi - a.x;
      const float dy = yi - a.y;
      const float dz = zi - a.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      if (!(r2 < r2_pre) || a.w == 0.f || k == self) continue;
      const float rinv = rsqrtf(fmaxf(r2, 1e-24f));
      const float r = r2 * rinv;
      if (!(r < p.h)) continue;
      const float4 b = tl.vel[warp][k];
      const float presj = tl.src[warp][k].x;
      const float m_over_rho = b.w;
      const float dcl = fmaxf(p.h - r, 0.f);
      const float gmag = r2 > 0.f ? p.spiky * dcl * dcl * rinv : 0.f;
      const float lapw = p.visc_lap * dcl;
      const float pscale = -(presi + presj) * 0.5f * m_over_rho * gmag;
      const float vscale = m_over_rho * lapw * p.mu;
      fpx += pscale * dx + vscale * (b.x - vxi);
      fpy += pscale * dy + vscale * (b.y - vyi);
      fpz += pscale * dz + vscale * (b.z - vzi);
      const float gscale = m_over_rho * gmag;
      gcx += gscale * dx;
      gcy += gscale * dy;
      gcz += gscale * dz;
      lc += m_over_rho * lapw;
    }
    __syncwarp();
  }
  part1[0][warp][lane] = fpx;
  part1[1][warp][lane] = fpy;
  part1[2][warp][lane] = fpz;
  part1[3][warp][lane] = gcx;
  part1[4][warp][lane] = gcy;
  part1[5][warp][lane] = gcz;
  part1[6][warp][lane] = lc;
  __syncthreads();
  // every warp adds the partials in the same order, so all hold the same
  // fresh pos/vel of row i
  fpx = fpy = fpz = gcx = gcy = gcz = lc = 0.f;
  for (int w = 0; w < kSlices; ++w) {
    fpx += part1[0][w][lane];
    fpy += part1[1][w][lane];
    fpz += part1[2][w][lane];
    gcx += part1[3][w][lane];
    gcy += part1[4][w][lane];
    gcz += part1[5][w][lane];
    lc += part1[6][w][lane];
  }

  // --- assemble_acc + integrate (brute_pallas.py:152-166)
  const float glen = sqrtf(gcx * gcx + gcy * gcy + gcz * gcz);
  const float stm =
      glen > kSurfaceThreshold ? -p.st * lc / fmaxf(glen, 1e-30f) : 0.f;
  const float rho_safe = fmaxf(rhoi, 1e-12f);
  const float ax = (fpx + stm * gcx + p.gx * rhoi) / rho_safe;
  const float ay = (fpy + stm * gcy + p.gy * rhoi) / rho_safe;
  const float az = (fpz + stm * gcz + p.gz * rhoi) / rho_safe;
  const float nvx = (vxi + ax * p.dt) * kDamping;
  const float nvy = (vyi + ay * p.dt) * kDamping;
  const float nvz = (vzi + az * p.dt) * kDamping;
  const float npx = xi + nvx * p.dt;
  const float npy = yi + nvy * p.dt;
  const float npz = zi + nvz * p.dt;

  // --- pass 2: XSPH, fresh self vs stale neighbors (brute_pallas.py:168-191)
  float sx = 0.f, sy = 0.f, sz = 0.f, norm = 0.f;
  for (int t = warp; t < tiles; t += kSlices) {
    load_tile(tl, warp, lane, t, n, pos, vel, rho, pres, contrib, p.mass);
    const int self = i - t * kRows;
#pragma unroll 8
    for (int k = 0; k < kRows; ++k) {
      const float4 a = tl.pos[warp][k];
      const float dx = npx - a.x;
      const float dy = npy - a.y;
      const float dz = npz - a.z;
      const float rr2 = dx * dx + dy * dy + dz * dz;
      if (!(rr2 < p.h2) || a.w == 0.f || k == self) continue;
      const float4 b = tl.vel[warp][k];
      const float dd = fmaxf(p.h2 - rr2, 0.f);
      const float w = p.poly6 * dd * dd * dd;
      const float mw = w * p.mass / tl.src[warp][k].y;
      sx += mw * (b.x - nvx);
      sy += mw * (b.y - nvy);
      sz += mw * (b.z - nvz);
      norm += w;
    }
    __syncwarp();
  }
  part2[0][warp][lane] = sx;
  part2[1][warp][lane] = sy;
  part2[2][warp][lane] = sz;
  part2[3][warp][lane] = norm;
  __syncthreads();
  if (warp != 0 || !row) return;
  sx = sy = sz = norm = 0.f;
  for (int w = 0; w < kSlices; ++w) {
    sx += part2[0][w][lane];
    sy += part2[1][w][lane];
    sz += part2[2][w][lane];
    norm += part2[3][w][lane];
  }

  // --- XSPH apply and CFL cap (brute_pallas.py:192-201)
  const float inv = norm > 0.f ? kXsphCoeff / fmaxf(norm, 1e-30f) : 0.f;
  const float vx = nvx + inv * sx;
  const float vy = nvy + inv * sy;
  const float vz = nvz + inv * sz;
  const float max_speed = kCflFraction * p.h / fmaxf(p.dt, 1e-6f);
  const float spd = sqrtf(vx * vx + vy * vy + vz * vz);
  const float scale = spd > max_speed ? max_speed / fmaxf(spd, 1e-30f) : 1.f;

  npos[3 * i] = npx;
  npos[3 * i + 1] = npy;
  npos[3 * i + 2] = npz;
  nvel[3 * i] = vx * scale;
  nvel[3 * i + 1] = vy * scale;
  nvel[3 * i + 2] = vz * scale;
  acc[3 * i] = ax;
  acc[3 * i + 1] = ay;
  acc[3 * i + 2] = az;
}

int grid_for(int n) { return (n + kRows - 1) / kRows; }

}  // namespace

extern "C" int sph_brute_density(const float* pos, const float* contrib,
                                 int n, const SphSweepParams* params,
                                 float* rho_raw, void* stream) {
  if (n > 0) {
    brute_density_kernel<<<grid_for(n), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pos, contrib, n, *params, rho_raw);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_brute_force(const float* pos, const float* vel,
                               const float* rho, const float* pres,
                               const float* contrib, int n,
                               const SphSweepParams* params, float* npos,
                               float* nvel, float* acc, void* stream) {
  if (n > 0) {
    brute_force_kernel<<<grid_for(n), kBlock, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        pos, vel, rho, pres, contrib, n, *params, npos, nvel, acc);
  }
  return static_cast<int>(cudaGetLastError());
}
