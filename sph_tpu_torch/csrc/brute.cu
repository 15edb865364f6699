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
// n^2 pairs (67.1M pairs per pass at 8,192 rows), while the inputs are a
// few hundred kilobytes that stay in L1/L2.  Only the few pairs per row
// within h (0.07% of them at dam_break_8k) do the pair math.  So what
// counts is the issue slots a tested pair costs, and how many of them the
// card can fill.
//
// brute_density_kernel (redesigned; the first port took 0.0344 ms at
// dam_break_8k on an H100 at 700 W, chip_smoke.py).  Its SASS showed the
// pair math predicated, not branched, but 12.9 issue slots a pair: the
// distance in 6, the test, (h^2 - r^2)^3 and the sum in 5 more, and a
// broadcast 16-byte shared load for every pair of a lane, 32 rows to a
// block.  The design:
//   - The expanded test, |p_j|^2 - 2 p_i.p_j < limit_i, is 3 FFMA a pair on
//     a source record (-2x, -2y, -2z, |p|^2); limit_i = h^2 - |p_i|^2 plus
//     a slack that bounds the float32 rounding (kSlack), so every pair
//     within h passes, and a sliver beyond.
//   - The sign bit of (test - limit) is shifted into a per-row mask: one
//     FADD and one SHF a pair, no branch.  The exact test and term,
//     contrib_j (h^2 - r^2)^3 where r^2 < h^2 from the differences, as
//     before, run over the set bits only, skipped by the whole warp when no
//     lane has one.
//   - Four rows a lane, so one broadcast load serves four tests: 5.3 issue
//     slots a pair in the SASS (3 FFMA, FADD, SHF, a quarter of an LDS).
//   - A cluster of two blocks holds 128 rows; each block of 32 warps takes
//     half the j tiles, warp w the tiles 32 b + w, + 64, ...  So 8,192 rows
//     fill 128 SMs, one block each; block 1 adds its totals into block 0's
//     shared memory (after a cluster barrier, armed at entry, shows that
//     block 0 has started), and block 0 adds them after its own.
// It takes 0.0188 ms after one substep and 0.0194 on the main path's final
// state (more pairs within h): 37% and 36% of its bound, which counts the 7
// operations a tested pair that the test does (3 FFMA, the FADD).  At the
// card's full issue rate (4 warp instructions a clock on 128 SMs at 1.98
// GHz) its 5.3 slots a pair would take 11 us; the launch, the loads and the
// sums around the loop and the loop's own stalls make up the rest.
// Sources in lanes, the other shape measured (rows broadcast from shared
// memory, one ballot a row; not kept), took 0.0304 and 0.0358 ms: its
// broadcast load serves one test.  The sum of a row has a fixed order (its
// tiles in order, its warps in order, then block 0 before block 1): two
// launches are bit-equal.  A source weighs by contrib_j alone (a row with
// rho = 0 is still a source, unlike the force kernel); contrib_j = 0 and
// the padding get the far position; the self pair and a coincident twin
// count; the test is strict.
//
// brute_force_kernel: a block holds 64 i rows (two per lane, so one
// broadcast 16-byte load serves two tests) and 32 warps, one block to an
// SM.  A warp stages a j tile as two 16-byte records a source, prepared
// once: (x, y, z, pres) and (vx, vy, vz, mass / max(rho, 1e-12)); a dead
// source (rho <= 0 or contrib <= 0) gets a far position instead of a flag,
// so the test is the distance alone.  The next tile's rows are loaded
// into registers before the current tile is tested.  The 32 tests of a
// tile are branch-free and only set bits of a per-row mask, so they
// overlap (the first port had a branch around every pair's math, which the
// compiler kept); the row's own bit is cleared once, in the one tile that
// holds it; the pair math then runs over the set bits only.  Both passes
// (force, then XSPH) are in one launch and write to buffers separate from
// the inputs, because XSPH reads the stale neighbor pos/vel against the
// fresh self pos/vel; the partial sums of the 32 warps are added in a
// fixed order by one thread per sum, and every warp reads the same
// totals, so each holds the row's fresh pos/vel.  No atomics: two launches
// on the same inputs are bit-equal.  No TMA and no wgmma: there is no
// matrix product and the inputs stay in cache.
//
// Semantics are those of brute_pallas.py: rows keep their order, so the
// self pair is excluded by row index (j != i); density includes the self
// pair, weights by contrib_j only and applies no floor (finish_density
// does, afterwards, over every row); the force and XSPH passes take a
// source only when rho_j > 0 and contrib_j > 0; r = r2 * rsqrt(max(r2,
// 1e-24)) as in the TPU kernel, with gmag = 0 at r2 = 0; mu is folded in
// per pair.  The constants and pair math follow sweeps.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "brute.h"

namespace {

namespace cg = cooperative_groups;

constexpr float kXsphCoeff = 0.12f;        // SPHFluid.comp:179
constexpr float kDamping = 0.995f;         // SPHFluid.comp:170
constexpr float kCflFraction = 0.4f;       // SPHFluid3D.cpp:414-416
constexpr float kSurfaceThreshold = 1e-6f; // SPHFluid.comp:159
// r2 prefilter of the r < h test: r2 * rsqrt(r2) < h implies r2 below
// this (rsqrt is within a few ulp), so the exact test sees every pair.
constexpr float kPrefilter = 1.0001f;
constexpr int kTile = 32;         // j rows per tile, one per lane
// A source that takes no part (a dead source of the force kernel, a source
// with contrib 0 of the density kernel) and the padding past row n get
// this coordinate, so that they fail every distance test without a flag:
// (x_i - 1e18)^2 and 3e36 are finite and far above h^2.
constexpr float kFar = 1e18f;

// ---------------------------------------------------------------------------
// brute_density_kernel
// ---------------------------------------------------------------------------

constexpr int kDensityRows = 4;     // i rows per lane
constexpr int kDensityWarps = 32;   // warps per block
constexpr int kDensityBlocks = 2;   // blocks per cluster, each half the j tiles
constexpr int kDensityGroup = 32 * kDensityRows;   // i rows per cluster
// Slack of the expanded test's limit, 64 ulp: for a pair within h its
// rounding stays below 30 ulp of |p_i|^2 + h^2, and the limit adds
// kSlack (2 |p_i|^2 + 3 h^2) >= 64 ulp ((|p_i| + h)^2 + h^2).
constexpr float kSlack = 3.8e-6f;

// The expanded test value of a pair, |p_j|^2 - 2 p_i.p_j, on the source's
// test record (-2 x_j, -2 y_j, -2 z_j, |p_j|^2): 3 FFMA.
__device__ __forceinline__ float expanded(float x, float y, float z,
                                          float4 a) {
  return fmaf(z, a.z, fmaf(y, a.y, fmaf(x, a.x, a.w)));
}

// Row i's limit: every pair within h has expanded(...) < limit.
__device__ __forceinline__ float row_limit(float x, float y, float z,
                                           const SphSweepParams& p) {
  const float s = x * x + y * y + z * z;
  return (p.h2 - s) + kSlack * (2.f * s + 3.f * p.h2);
}

__device__ __forceinline__ float4 test_record(float x, float y, float z,
                                              bool live) {
  if (!live) x = y = z = kFar;
  return make_float4(-2.f * x, -2.f * y, -2.f * z, x * x + y * y + z * z);
}

// The exact pair term on the source's (x, y, z, contrib):
// contrib_j (h^2 - r^2)^3 where r^2 < h^2, else 0.
__device__ __forceinline__ float density_term(float x, float y, float z,
                                              float4 b, float h2) {
  const float dx = x - b.x;
  const float dy = y - b.y;
  const float dz = z - b.z;
  const float r2 = dx * dx + dy * dy + dz * dz;
  const float d = r2 < h2 ? h2 - r2 : 0.f;
  return d * d * d * b.w;
}

__global__ void __cluster_dims__(kDensityBlocks, 1, 1)
__launch_bounds__(32 * kDensityWarps)
brute_density_kernel(const float* __restrict__ pos,
                     const float* __restrict__ contrib, int n,
                     const SphSweepParams* __restrict__ prm,
                     float* __restrict__ rho_raw) {
  const SphSweepParams p = *prm;
  constexpr int kR = kDensityRows, kS = kDensityWarps, kC = kDensityBlocks;
  constexpr int kRows = kDensityGroup;
  constexpr int kStride = kC * kS;
  __shared__ float4 stage[2][kS][kTile];   // test records, (x, y, z, contrib)
  __shared__ float tot[kC][kRows];         // block c's totals, in block 0
  float* part = reinterpret_cast<float*>(stage);   // [kS][kRows] at the end
  static_assert(sizeof(float) * kS * kRows <= sizeof(stage), "part fits");
  cg::cluster_group cluster = cg::this_cluster();
  const int block = static_cast<int>(cluster.block_rank());
  const int group = blockIdx.x / kC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // block 1 writes into block 0's shared memory at the end, which it may
  // do only once every block of the cluster has started: arrive now, wait
  // just before that write
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  const int tiles = (n + kTile - 1) / kTile;
  const int first = block * kS + warp;
  float4 raw = make_float4(0.f, 0.f, 0.f, 0.f);
  auto load = [&](int t) {
    const int j = t * kTile + lane;
    raw = j < n ? make_float4(__ldg(pos + 3 * j), __ldg(pos + 3 * j + 1),
                              __ldg(pos + 3 * j + 2), __ldg(contrib + j))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  if (first < tiles) load(first);

  // all rows' loads first; a lane past row n reads row n - 1 and takes
  // the limit -inf, which no source passes
  float xi[kR], yi[kR], zi[kR], lim[kR], sum[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = min(group * kRows + r * 32 + lane, n - 1);
    xi[r] = pos[3 * i];
    yi[r] = pos[3 * i + 1];
    zi[r] = pos[3 * i + 2];
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    lim[r] = group * kRows + r * 32 + lane < n
                 ? row_limit(xi[r], yi[r], zi[r], p)
                 : -__int_as_float(0x7f800000);
    sum[r] = 0.f;
  }

  for (int t = first; t < tiles; t += kStride) {
    stage[0][warp][lane] = test_record(
        raw.x, raw.y, raw.z, t * kTile + lane < n && raw.w != 0.f);
    stage[1][warp][lane] = raw;
    __syncwarp();
    if (t + kStride < tiles) load(t + kStride);
    // bit 31 - k of hits[r]: source k of the tile passed row r's test, the
    // sign bit of (test - limit) shifted in, branch-free
    unsigned hits[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) hits[r] = 0u;
#pragma unroll
    for (int k = 0; k < kTile; ++k) {
      const float4 a = stage[0][warp][k];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float v = expanded(xi[r], yi[r], zi[r], a) - lim[r];
        hits[r] = (hits[r] << 1) + (__float_as_uint(v) >> 31);
      }
    }
    unsigned any = 0u;
#pragma unroll
    for (int r = 0; r < kR; ++r) any |= hits[r];
    if (__any_sync(0xffffffffu, any != 0u)) {
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        for (unsigned m = hits[r]; m != 0u;) {
          const int k = __clz(m);
          m ^= 0x80000000u >> k;
          sum[r] += density_term(xi[r], yi[r], zi[r], stage[1][warp][k],
                                 p.h2);
        }
      }
    }
    __syncwarp();
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kR; ++r) part[warp * kRows + r * 32 + lane] = sum[r];
  __syncthreads();
  {
    // kT consecutive threads a row: each adds kQ warps' partials in warp
    // order, then a fixed shuffle tree adds theirs; the block's totals go
    // to block 0's tot[block]
    constexpr int kT = 32 * kS / kRows, kQ = kS / kT;
    const int row = threadIdx.x / kT, q = threadIdx.x % kT;
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kQ; ++w) total += part[(q * kQ + w) * kRows + row];
#pragma unroll
    for (int o = kT / 2; o > 0; o >>= 1) {
      total += __shfl_xor_sync(0xffffffffu, total, o);
    }
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (q == 0) cluster.map_shared_rank(&tot[block][row], 0)[0] = total;
  }
  cluster.sync();   // the totals in block 0 are complete and visible
  if (block == 0 && threadIdx.x < kRows) {
    const int row = group * kRows + threadIdx.x;
    float total = tot[0][threadIdx.x];
#pragma unroll
    for (int c = 1; c < kC; ++c) total += tot[c][threadIdx.x];
    if (row < n) rho_raw[row] = p.mass * p.poly6 * total;
  }
}

// ---------------------------------------------------------------------------
// brute_force_kernel
// ---------------------------------------------------------------------------

constexpr int kForceRows = 2;     // i rows per lane
constexpr int kForceSlices = 32;  // warps per block, each over its own j tiles
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
                   const SphSweepParams* __restrict__ prm,
                   float* __restrict__ npos, float* __restrict__ nvel,
                   float* __restrict__ acc) {
  const SphSweepParams p = *prm;
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
                 const SphSweepParams* params, float* npos, float* nvel,
                 float* acc, cudaStream_t stream) {
  // more than 48 KB of shared memory a block has to be asked for, once
  static const cudaError_t attr = cudaFuncSetAttribute(
      brute_force_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(ForceShape::kSmemBytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  constexpr int kRowsPerBlock = ForceShape::kRowsPerBlock;
  brute_force_kernel<<<(n + kRowsPerBlock - 1) / kRowsPerBlock,
                       ForceShape::kThreads, ForceShape::kSmemBytes,
                       stream>>>(pos, vel, rho, pres, contrib, n, params,
                                 npos, nvel, acc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sph_brute_density(const float* pos, const float* contrib,
                                 int n, const SphSweepParams* params,
                                 float* rho_raw, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int groups = (n + kDensityGroup - 1) / kDensityGroup;
    brute_density_kernel<<<kDensityBlocks * groups, 32 * kDensityWarps, 0,
                           s>>>(pos, contrib, n, params, rho_raw);
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
      pos, vel, rho, pres, contrib, n, params, npos, nvel, acc,
      static_cast<cudaStream_t>(stream));
}
