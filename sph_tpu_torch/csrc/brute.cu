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
// What bounds them on the card: the instruction rate.  Every pass tests all
// n^2 pairs (about nine float32 operations each for the distance, 67.1M
// pairs per pass at 8,192 rows), while the inputs are a few hundred
// kilobytes that stay in L1/L2.  Only the few dozen pairs per row within h
// do the full pair math.  The first force kernel put that pair math behind
// a branch inside the pair loop: the compiler kept the branch (its SASS
// has a BSSY/BRA/BSYNC region around every pair), so no two pairs'
// shared-memory loads and arithmetic overlapped, and it took 2.2x per pass
// what the density kernel takes for the same distance test.
//
// What the design does about it: the classic n-body shape, with the j
// loop split across warps so that 8,192 rows still fill the card.
// brute_density_kernel: a block holds 32 i rows (one per lane) and 8
// warps; warp w walks the j tiles w, w + 8, ... of 32 rows each, staging
// each tile in shared memory (one j row loaded per lane) and reading it
// back as a broadcast; the 8 partial sums of a row are added in shared
// memory, in a fixed order.
// brute_force_kernel: a block holds 64 i rows (two per lane, so one
// broadcast 16-byte load serves two tests) and 32 warps, one block to an
// SM.  A warp stages a j tile as two 16-byte records a source, prepared
// once: (x, y, z, pres) and (vx, vy, vz, mass / max(rho, 1e-12)); a dead
// source (rho <= 0 or contrib <= 0) gets a far position instead of a flag,
// so the test is the distance alone.  The next tile's rows are loaded
// into registers before the current tile is tested.  The 32 tests of a
// tile are branch-free and only set bits of a per-row mask, so they
// overlap; the row's own bit is cleared once, in the one tile that holds
// it; the pair math then runs over the set bits only.  Both passes (force,
// then XSPH) are in one launch and write to buffers separate from the
// inputs, because XSPH reads the stale neighbor pos/vel against the fresh
// self pos/vel; the partial sums of the 32 warps are added in a fixed
// order by one thread per sum, and every warp reads the same totals, so
// each holds the row's fresh pos/vel.  No atomics: two launches on the
// same inputs are bit-equal.  No TMA and no wgmma: there is no matrix
// product and the inputs stay in cache.
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

// brute_density_kernel's shape
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

// ---------------------------------------------------------------------------
// brute_force_kernel
// ---------------------------------------------------------------------------

constexpr int kTile = 32;         // j rows per tile, one per lane
constexpr int kForceRows = 2;     // i rows per lane
constexpr int kForceSlices = 32;  // warps per block, each over its own j tiles
// A dead source (rho_j <= 0 or contrib_j <= 0) and the padding past row n
// get this coordinate, so that they fail every distance test without a
// flag: (x_i - 1e18)^2 is finite and far above h^2.
constexpr float kFar = 1e18f;

// The raw inputs of one j row, loaded a tile ahead of their use.
struct RawRow {
  float x, y, z, vx, vy, vz, rho, pres, contrib;
};

__device__ __forceinline__ RawRow load_raw(
    int j, int n, const float* __restrict__ pos,
    const float* __restrict__ vel, const float* __restrict__ rho,
    const float* __restrict__ pres, const float* __restrict__ contrib) {
  RawRow r = {kFar, kFar, kFar, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (j < n) {
    r.x = __ldg(pos + 3 * j);
    r.y = __ldg(pos + 3 * j + 1);
    r.z = __ldg(pos + 3 * j + 2);
    r.vx = __ldg(vel + 3 * j);
    r.vy = __ldg(vel + 3 * j + 1);
    r.vz = __ldg(vel + 3 * j + 2);
    r.rho = __ldg(rho + j);
    r.pres = __ldg(pres + j);
    r.contrib = __ldg(contrib + j);
  }
  return r;
}

// The two 16-byte records of a source, as the pair loops read them:
// (x, y, z, pres) and (vx, vy, vz, mass / max(rho, 1e-12)).
__device__ __forceinline__ void store_records(const RawRow& r, float mass,
                                              float4* a, float4* b) {
  const bool live = r.rho > 0.f && r.contrib > 0.f;
  *a = live ? make_float4(r.x, r.y, r.z, r.pres)
            : make_float4(kFar, kFar, kFar, 0.f);
  *b = make_float4(r.vx, r.vy, r.vz, mass / fmaxf(r.rho, 1e-12f));
}

// Per lane and i row, the mask of the tile's sources with r2 < limit: 32
// branch-free distance tests, so the loads and the arithmetic of
// different sources overlap.
template <int kR>
__device__ __forceinline__ void test_tile(const float4* __restrict__ ta,
                                          const float (&x)[kR],
                                          const float (&y)[kR],
                                          const float (&z)[kR], float limit,
                                          unsigned (&hits)[kR]) {
#pragma unroll
  for (int r = 0; r < kR; ++r) hits[r] = 0u;
#pragma unroll
  for (int k = 0; k < kTile; ++k) {
    const float4 a = ta[k];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const float dx = x[r] - a.x;
      const float dy = y[r] - a.y;
      const float dz = z[r] - a.z;
      const float r2 = dx * dx + dy * dy + dz * dz;
      hits[r] |= r2 < limit ? (1u << k) : 0u;
    }
  }
}

// Sum the kS per-warp partials of each (value, row) in warp order and
// leave the totals in tot[value][row]: one thread per sum.
template <int kV, int kS, int kRowsPerBlock>
__device__ __forceinline__ void sum_partials(const float* __restrict__ part,
                                             float* __restrict__ tot) {
  __syncthreads();
  for (int s = threadIdx.x; s < kV * kRowsPerBlock; s += 32 * kS) {
    const int v = s / kRowsPerBlock;
    const int row = s - v * kRowsPerBlock;
    float total = 0.f;
#pragma unroll 8
    for (int w = 0; w < kS; ++w) {
      total += part[(v * kS + w) * kRowsPerBlock + row];
    }
    tot[s] = total;
  }
  __syncthreads();
}

struct ForceShape {
  static constexpr int kRowsPerBlock = 32 * kForceRows;
  static constexpr int kThreads = 32 * kForceSlices;
  // tiles (two records a source), pass-1 partials (7 values), totals
  static constexpr size_t kSmemBytes =
      sizeof(float4) * 2 * kForceSlices * kTile +
      sizeof(float) * 7 * (kForceSlices + 1) * kRowsPerBlock;
};

__global__ void __launch_bounds__(32 * kForceSlices)
brute_force_kernel(const float* __restrict__ pos,
                   const float* __restrict__ vel,
                   const float* __restrict__ rho,
                   const float* __restrict__ pres,
                   const float* __restrict__ contrib, int n,
                   SphSweepParams p, float* __restrict__ npos,
                   float* __restrict__ nvel, float* __restrict__ acc) {
  constexpr int kR = kForceRows, kS = kForceSlices;
  constexpr int kRowsPerBlock = ForceShape::kRowsPerBlock;
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float4* ta = smem + warp * kTile;               // this warp's tile
  float4* tb = smem + (kS + warp) * kTile;
  float* part = reinterpret_cast<float*>(smem + 2 * kS * kTile);
  float* tot = part + 7 * kS * kRowsPerBlock;     // [7][rows]
  auto part_at = [&](int v, int r) -> float& {
    return part[(v * kS + warp) * kRowsPerBlock + r * 32 + lane];
  };

  // lane's rows: block row r * 32 + lane, so a warp's stores are coalesced
  int i[kR];
  float xi[kR], yi[kR], zi[kR], vxi[kR], vyi[kR], vzi[kR], rhoi[kR], presi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    i[r] = blockIdx.x * kRowsPerBlock + r * 32 + lane;
    const bool row = i[r] < n;
    xi[r] = row ? pos[3 * i[r]] : 0.f;
    yi[r] = row ? pos[3 * i[r] + 1] : 0.f;
    zi[r] = row ? pos[3 * i[r] + 2] : 0.f;
    vxi[r] = row ? vel[3 * i[r]] : 0.f;
    vyi[r] = row ? vel[3 * i[r] + 1] : 0.f;
    vzi[r] = row ? vel[3 * i[r] + 2] : 0.f;
    rhoi[r] = row ? rho[i[r]] : 0.f;
    presi[r] = row ? pres[i[r]] : 0.f;
  }
  const int tiles = (n + kTile - 1) / kTile;
  const float r2_pre = p.h2 * kPrefilter;

  // Walks this warp's j tiles: stages each as records (the next tile's raw
  // rows are already in flight), tests it branch-free, clears the row's own
  // bit (the self pair is excluded by row index, in the one tile that holds
  // it) and hands every hit (row r, source k of the tile) to near().
  auto walk = [&](const float (&cx)[kR], const float (&cy)[kR],
                  const float (&cz)[kR], float limit, auto near) {
    RawRow raw = load_raw(warp * kTile + lane, n, pos, vel, rho, pres,
                          contrib);
    for (int t = warp; t < tiles; t += kS) {
      store_records(raw, p.mass, ta + lane, tb + lane);
      __syncwarp();
      if (t + kS < tiles) {
        raw = load_raw((t + kS) * kTile + lane, n, pos, vel, rho, pres,
                       contrib);
      }
      unsigned hits[kR];
      test_tile<kR>(ta, cx, cy, cz, limit, hits);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const unsigned self = static_cast<unsigned>(i[r] - t * kTile);
        unsigned m = self < static_cast<unsigned>(kTile)
                         ? hits[r] & ~(1u << self)
                         : hits[r];
        while (m != 0u) {
          const int k = __ffs(m) - 1;
          m &= m - 1u;
          near(r, ta[k], tb[k]);
        }
      }
      __syncwarp();
    }
  };

  // --- pass 1: pressure, viscosity, color field (brute_pallas.py:107-150)
  float fpx[kR], fpy[kR], fpz[kR], gcx[kR], gcy[kR], gcz[kR], lc[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    fpx[r] = fpy[r] = fpz[r] = gcx[r] = gcy[r] = gcz[r] = lc[r] = 0.f;
  }
  walk(xi, yi, zi, r2_pre, [&](int r, float4 a, float4 b) {
    const float dx = xi[r] - a.x;
    const float dy = yi[r] - a.y;
    const float dz = zi[r] - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const float rinv = rsqrtf(fmaxf(r2, 1e-24f));
    const float rr = r2 * rinv;
    if (!(rr < p.h)) return;
    const float m_over_rho = b.w;
    const float dcl = fmaxf(p.h - rr, 0.f);
    const float gmag = r2 > 0.f ? p.spiky * dcl * dcl * rinv : 0.f;
    const float lapw = p.visc_lap * dcl;
    const float pscale = -(presi[r] + a.w) * 0.5f * m_over_rho * gmag;
    const float vscale = m_over_rho * lapw * p.mu;
    fpx[r] += pscale * dx + vscale * (b.x - vxi[r]);
    fpy[r] += pscale * dy + vscale * (b.y - vyi[r]);
    fpz[r] += pscale * dz + vscale * (b.z - vzi[r]);
    const float gscale = m_over_rho * gmag;
    gcx[r] += gscale * dx;
    gcy[r] += gscale * dy;
    gcz[r] += gscale * dz;
    lc[r] += m_over_rho * lapw;
  });
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    part_at(0, r) = fpx[r];
    part_at(1, r) = fpy[r];
    part_at(2, r) = fpz[r];
    part_at(3, r) = gcx[r];
    part_at(4, r) = gcy[r];
    part_at(5, r) = gcz[r];
    part_at(6, r) = lc[r];
  }
  sum_partials<7, kS, kRowsPerBlock>(part, tot);

  // --- assemble_acc + integrate (brute_pallas.py:152-166); every warp
  // reads the same totals, so all hold the same fresh pos/vel of a row
  float ax[kR], ay[kR], az[kR], nvx[kR], nvy[kR], nvz[kR];
  float npx[kR], npy[kR], npz[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int row = r * 32 + lane;
    const float fx = tot[0 * kRowsPerBlock + row];
    const float fy = tot[1 * kRowsPerBlock + row];
    const float fz = tot[2 * kRowsPerBlock + row];
    const float gx = tot[3 * kRowsPerBlock + row];
    const float gy = tot[4 * kRowsPerBlock + row];
    const float gz = tot[5 * kRowsPerBlock + row];
    const float l = tot[6 * kRowsPerBlock + row];
    const float glen = sqrtf(gx * gx + gy * gy + gz * gz);
    const float stm =
        glen > kSurfaceThreshold ? -p.st * l / fmaxf(glen, 1e-30f) : 0.f;
    const float rho_safe = fmaxf(rhoi[r], 1e-12f);
    ax[r] = (fx + stm * gx + p.gx * rhoi[r]) / rho_safe;
    ay[r] = (fy + stm * gy + p.gy * rhoi[r]) / rho_safe;
    az[r] = (fz + stm * gz + p.gz * rhoi[r]) / rho_safe;
    nvx[r] = (vxi[r] + ax[r] * p.dt) * kDamping;
    nvy[r] = (vyi[r] + ay[r] * p.dt) * kDamping;
    nvz[r] = (vzi[r] + az[r] * p.dt) * kDamping;
    npx[r] = xi[r] + nvx[r] * p.dt;
    npy[r] = yi[r] + nvy[r] * p.dt;
    npz[r] = zi[r] + nvz[r] * p.dt;
  }

  // --- pass 2: XSPH, fresh self vs stale neighbors (brute_pallas.py:168-191)
  float sx[kR], sy[kR], sz[kR], norm[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) sx[r] = sy[r] = sz[r] = norm[r] = 0.f;
  walk(npx, npy, npz, p.h2, [&](int r, float4 a, float4 b) {
    const float dx = npx[r] - a.x;
    const float dy = npy[r] - a.y;
    const float dz = npz[r] - a.z;
    const float rr2 = dx * dx + dy * dy + dz * dz;
    const float dd = fmaxf(p.h2 - rr2, 0.f);
    const float w = p.poly6 * dd * dd * dd;
    const float mw = w * b.w;
    sx[r] += mw * (b.x - nvx[r]);
    sy[r] += mw * (b.y - nvy[r]);
    sz[r] += mw * (b.z - nvz[r]);
    norm[r] += w;
  });
  // the totals of pass 1 were read before pass 2 began, so both buffers
  // are free again
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    part_at(0, r) = sx[r];
    part_at(1, r) = sy[r];
    part_at(2, r) = sz[r];
    part_at(3, r) = norm[r];
  }
  sum_partials<4, kS, kRowsPerBlock>(part, tot);
  if (warp != 0) return;

  // --- XSPH apply and CFL cap (brute_pallas.py:192-201)
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    if (i[r] >= n) continue;
    const int row = r * 32 + lane;
    const float tx = tot[0 * kRowsPerBlock + row];
    const float ty = tot[1 * kRowsPerBlock + row];
    const float tz = tot[2 * kRowsPerBlock + row];
    const float tn = tot[3 * kRowsPerBlock + row];
    const float inv = tn > 0.f ? kXsphCoeff / fmaxf(tn, 1e-30f) : 0.f;
    const float vx = nvx[r] + inv * tx;
    const float vy = nvy[r] + inv * ty;
    const float vz = nvz[r] + inv * tz;
    const float max_speed = kCflFraction * p.h / fmaxf(p.dt, 1e-6f);
    const float spd = sqrtf(vx * vx + vy * vy + vz * vz);
    const float scale =
        spd > max_speed ? max_speed / fmaxf(spd, 1e-30f) : 1.f;
    const int o = 3 * i[r];
    npos[o] = npx[r];
    npos[o + 1] = npy[r];
    npos[o + 2] = npz[r];
    nvel[o] = vx * scale;
    nvel[o + 1] = vy * scale;
    nvel[o + 2] = vz * scale;
    acc[o] = ax[r];
    acc[o + 1] = ay[r];
    acc[o + 2] = az[r];
  }
}

int launch_force(const float* pos, const float* vel, const float* rho,
                 const float* pres, const float* contrib, int n,
                 const SphSweepParams& p, float* npos, float* nvel,
                 float* acc, cudaStream_t stream) {
  // more than 48 KB of shared memory a block has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      brute_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ForceShape::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int kRowsPerBlock = ForceShape::kRowsPerBlock;
  brute_force_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                       ForceShape::kThreads, ForceShape::kSmemBytes,
                       stream>>>(pos, vel, rho, pres, contrib, n, p, npos,
                                 nvel, acc);
  return static_cast<int>(cudaGetLastError());
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
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  return launch_force(
      pos, vel, rho, pres, contrib, n, *params, npos, nvel, acc,
      static_cast<cudaStream_t>(stream));
}
