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
// The neighbor structure: the rows are sorted by a y-major cell key with x
// fastest, so the three cells x-1..x+1 at one (y, z) are one contiguous row
// range.  One thread per sorted row walks 9 contiguous ranges
// [cell_start(x0,z,y), cell_end(x1,z,y)) instead of 27 cells, and
// neighboring threads (same or adjacent cell) walk nearly the same rows, so
// the loads hit cache.  No per-cell capacity, so no overflow path.
//
// What bounds the force kernel on the card (NVIDIA H100 80GB HBM3,
// 700.00 W; PERF.md section 6 has every time and every shape tried):
// the instruction rate and load latency, not bytes and not arithmetic.  A row
// tests about 44 candidates and 12% of them are within h.  The 32 lanes of
// a warp are about 20 cells, each lane with its own nine ranges, so a walk
// step runs as long as the fullest lane's range, and pair math run inside
// the walk runs with about 4 lanes of 32 busy.  The first kernel walked
// twice (force, then XSPH from the fresh position), took four scalar loads
// a candidate and did the pair math in place, behind a branch: 0.39 ms at
// ghost_1m.  Staging the sources in shared memory, in three shapes, was
// slower than that: the buffers left an SM half its warps.
//
// What the design does about it (0.16 ms at ghost_1m):
//   * One walk serves both passes.  The fresh position is pos + v dt damp
//     + a dt^2 damp, and the first two terms are known before the forces.
//     So the walk tests each candidate against both centers (r < h about
//     pos; r < h + margin about the predicted position, 3 more FMAs from
//     the same offsets) and queues the record index of whatever passes
//     either.  Pass 2 reads the queue when the forces moved the warp's rows
//     less than 0.9 margin from the prediction: it then holds every source
//     within h of the fresh position; else the warp walks again.  margin is
//     0.05 h (an acceleration of 13 g at the configurations' h and dt).
//   * The pair math runs over the queue, after the walk, where most lanes
//     have work, and branch-free: a record that fails the exact test adds
//     zeros, so nothing stands between one record's loads and the next's
//     and the loop keeps two records in flight.  The queue is 32 entries a
//     thread in shared memory (16 KB a block, 8 blocks of 128 threads an
//     SM, so an SM keeps 32 warps; 40 and 48 entries were slower, they
//     take the room from L1).  When a lane's queue fills (compressed
//     columns, a crowded cell) the warp runs the math over all its queues,
//     empties them and walks on, so no candidate is ever dropped, at any
//     occupancy; such a warp has lost pass 2's queue and walks a second
//     time, around the fresh position.
//   * 16-byte source records, (x, y, z, rho) and (vx, vy, vz, m / rho),
//     written by density_kernel for the sorted rows and once per run for
//     the ghosts, which follow the rows in the same array: one 128-bit
//     load a candidate, two a queued pair, no ghost branch in the math (a
//     ghost's record has rho0, so P = 0, and v = 0).
//   * The walk step is branch-free too (a predicated queue store through a
//     running shared address), two candidates a step, the next range's
//     bounds loaded while the current one is walked; r comes from one
//     rsqrt.approx of r2 (as csrc/brute.cu), the queue's r2 prefilter sits
//     a relative 1e-4 above h2 and the exact test decides.
// Sums run in the queue's order, which is the walk's, and no atomics are
// used, so two launches on the same inputs are bit-equal, and the emit
// variant is bit-equal to the plain one.  No TMA or wgmma: the ranges are
// short, ragged and per lane, and there is no matrix product.
//
// What bounds the density kernel (same card; PERF.md section 6 has every
// shape tried): the rate at which the SMs issue the walk, as in the force
// kernel, with about half of a warp's lanes busy (each range's loop runs as
// long as its fullest lane's).  At ghost_1m, 0.073 ms with the records (the
// C entry point alone, on outputs allocated beforehand; 0.080 ms as
// chip_smoke.py times the wrapper, which also allocates them and copies the
// ghosts' records behind the fluid's): a launch that loads all 18 range
// bounds a row and walks no candidate takes
// 0.038 ms (key, pos and vel in, rho, pres and the two records out, 90 MB;
// 0.022 without the records), and with every candidate load folded onto a
// 12 KB window that stays in L1 the whole kernel still takes 0.069 ms, so
// the candidates' traffic is not what binds it.  16-byte candidate rows,
// four candidates a step, one flat loop over a lane's ranges, several rows a
// thread with shared candidate loads, larger or smaller blocks and 12 or 16
// blocks an SM all cost as much or more.  What did pay: every bound of a
// structure's 9 ranges loaded before the first is walked, two candidates a
// step, and no ghost walk where the cell's 3x3x3 block holds no ghost.  Not
// tried, for the reasons above: shared-memory staging of a block's sources
// (three shapes lost in the force kernel), TMA, wgmma.
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
// the same key: gpos / gcs / gce in the density sweep, the records after
// the n rows in the force sweep).  A ghost source has rho0, P = 0 and
// v = 0 (brute_force.py / common.finish_density), is never the row itself,
// and takes the same r < h and r > 0 guards as a fluid source.  Without
// ghosts the second walk is skipped, so a ghost-free state does no extra
// work; the density sweep also skips it for a row whose cell has no ghost
// in its 3x3x3 block (gnear, built once per run with the ghost structure).

#include <cuda_runtime.h>

#include <type_traits>

#include "sweeps.h"

namespace {

constexpr int kBlock = 128;
constexpr float kXsphCoeff = 0.12f;        // SPHFluid.comp:179
constexpr float kDamping = 0.995f;         // SPHFluid.comp:170
constexpr float kCflFraction = 0.4f;       // SPHFluid3D.cpp:414-416
constexpr float kSurfaceThreshold = 1e-6f; // SPHFluid.comp:159

// The density sweep: one thread a row.  It loads the bounds of all 9 of the
// block's contiguous x-ranges up front, 18 loads in flight at once where a
// loop over the ranges pays one load latency a range, then walks them two
// candidates a step, branch-free: a candidate beyond h adds
// max(h2 - r2, 0)^3 = 0.  The 9 ghost ranges are walked the same way, but
// only where gnear says that the cell's 3x3x3 block holds a ghost at all
// (1.6% of ghost_1m's fluid rows at the start, 16% once the columns have
// compressed).  The sum runs in the walk's order, so two launches are
// bit-equal, and so are the sums with and without the source records.
//
// With vel and sa / sb it also writes row i's source records for the force
// sweep: sa[i] = (x, y, z, rho), sb[i] = (vx, vy, vz, mass / max(rho, 1e-12)).
__global__ void __launch_bounds__(kBlock)
density_kernel(const int* __restrict__ key, const float* __restrict__ pos,
               const float* __restrict__ vel, const int* __restrict__ cs,
               const int* __restrict__ ce, int n,
               const float* __restrict__ gpos, const int* __restrict__ gcs,
               const int* __restrict__ gce,
               const unsigned char* __restrict__ gnear, SphGrid grid,
               const SphSweepParams* __restrict__ prm,
               float* __restrict__ rho, float* __restrict__ pres,
               float4* __restrict__ sa, float4* __restrict__ sb) {
  const SphSweepParams p = *prm;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int k = key[i];
  const float xi = pos[3 * i], yi = pos[3 * i + 1], zi = pos[3 * i + 2];
  float r = 0.f, pr = 0.f;
  if (k < grid.nx * grid.ny * grid.nz) {
    const int x = k % grid.nx;
    const int z = (k / grid.nx) % grid.nz;
    const int y = k / (grid.nx * grid.nz);
    const int x0 = max(x - 1, 0), x1 = min(x + 1, grid.nx - 1);
    float sum = 0.f;
    // the 9 ranges of one structure: sources src, ranges st / en
    auto walk = [&](const float* __restrict__ src, const int* __restrict__ st,
                    const int* __restrict__ en) {
      auto add = [&](int j) {
        const float dx = xi - __ldg(src + 3 * j);
        const float dy = yi - __ldg(src + 3 * j + 1);
        const float dz = zi - __ldg(src + 3 * j + 2);
        const float d = fmaxf(p.h2 - (dx * dx + dy * dy + dz * dz), 0.f);
        sum += d * d * d;
      };
      int first[9], end[9];
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        const int yy = y + q / 3 - 1, zz = z + q % 3 - 1;
        const bool in_grid =
            static_cast<unsigned>(yy) < static_cast<unsigned>(grid.ny) &&
            static_cast<unsigned>(zz) < static_cast<unsigned>(grid.nz);
        const int row = grid.nx * (zz + grid.nz * yy);
        first[q] = in_grid ? __ldg(st + row + x0) : 0;
        end[q] = in_grid ? __ldg(en + row + x1) : 0;
      }
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        int j = first[q];
        for (; j + 1 < end[q]; j += 2) add(j), add(j + 1);
        if (j < end[q]) add(j);
      }
    };
    walk(pos, cs, ce);
    if (gnear != nullptr && gnear[k]) walk(gpos, gcs, gce);
    // mass * poly6 scale and the density floor (SPHFluid.comp:105), EOS,
    // after both walks (common.finish_density)
    r = fmaxf(p.mass * p.poly6 * sum, p.rho_floor);
    pr = fmaxf(p.gas_k * (r - p.rho0), 0.f);
  }
  rho[i] = r;
  pres[i] = pr;
  if (sa != nullptr) {
    sa[i] = make_float4(xi, yi, zi, r);
    sb[i] = make_float4(vel[3 * i], vel[3 * i + 1], vel[3 * i + 2],
                        p.mass / fmaxf(r, 1e-12f));
  }
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

constexpr int kQueue = 32;             // queued pairs a row
constexpr int kForceBlocks = 8;        // blocks an SM (64 registers a thread)
constexpr float kMarginFrac = 0.05f;   // the queue's margin, in h
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sa, sb: the source records (sweeps.h), the ghosts' after the n rows.
template <bool kEmit>
__global__ void __launch_bounds__(kBlock, kForceBlocks)
force_xsph_kernel(const int* __restrict__ key, const float4* __restrict__ sa,
                  const float4* __restrict__ sb, const int* __restrict__ cs,
                  const int* __restrict__ ce, int n,
                  const int* __restrict__ gcs, const int* __restrict__ gce,
                  int has_ghosts, SphGrid grid,
                  const SphSweepParams* __restrict__ prm,
                  float* __restrict__ npos,
                  float* __restrict__ nvel, float* __restrict__ acc,
                  float* __restrict__ per) {
  const SphSweepParams p = *prm;
  // the queue: record indices, entry q of thread t at queue[q][t]
  __shared__ int queue[kQueue][kBlock];
  const int tid = threadIdx.x;
  const unsigned qbase =
      static_cast<unsigned>(__cvta_generic_to_shared(&queue[0][tid]));
  const unsigned qend = qbase + kQueue * kBlock * 4;
  const int i = blockIdx.x * blockDim.x + tid;
  const int nc = grid.nx * grid.ny * grid.nz;
  // no thread leaves before the last warp vote: a row out of range or
  // without a cell walks nothing
  const bool in = i < n;
  const int k = in ? key[i] : nc;
  const bool fluid = k < nc;
  float4 self_a = make_float4(0.f, 0.f, 0.f, 0.f), self_b = self_a;
  if (in) self_a = sa[i], self_b = sb[i];
  const float xi = self_a.x, yi = self_a.y, zi = self_a.z, rhoi = self_a.w;
  const float vxi = self_b.x, vyi = self_b.y, vzi = self_b.z;
  const int x = k % grid.nx;
  const int z = (k / grid.nx) % grid.nz;
  const int y = k / (grid.nx * grid.nz);
  const int x0 = max(x - 1, 0), x1 = min(x + 1, grid.nx - 1);
  const int stride_y = grid.nx * grid.nz;
  const float presi = fmaxf(p.gas_k * (rhoi - p.rho0), 0.f);
  // twice the step the row takes if no force acts, s = v dt damping; the
  // queue takes what is within h of pos or within h + margin of pos + s
  const float sx2 = 2.f * vxi * p.dt * kDamping;
  const float sy2 = 2.f * vyi * p.dt * kDamping;
  const float sz2 = 2.f * vzi * p.dt * kDamping;
  const float margin = kMarginFrac * p.h;
  const float near1 = p.h2 * 1.0001f;
  // (not const: a warp that had to empty its queues has no use for the
  // second center any more and stops asking for it)
  float near2 = (p.h + margin) * (p.h + margin) -
                0.25f * (sx2 * sx2 + sy2 * sy2 + sz2 * sz2);

  // a lane whose queue is shorter than the warp's longest reads its own
  // row, which adds zeros
  const int idle = min(i, n - 1);
  unsigned qaddr = qbase;
  // Every lane of the warp runs fn over its queued records, as many rounds
  // as the fullest lane has.
  auto drain = [&](auto fn) {
    const int queued = static_cast<int>((qaddr - qbase) / (kBlock * 4));
    const int most = __reduce_max_sync(kFullWarp, queued);
#pragma unroll 2
    for (int q = 0; q < most; ++q) fn(q < queued ? queue[q][tid] : idle);
  };
  // Queues the record index of every candidate within `limit` (squared)
  // of c, or, with kTwo, also within near2 of c + s: the 9 fluid ranges,
  // then the 9 ghost ranges, in row order.  A lane whose queue fills stops;
  // the warp then drains every lane's queue through fn, empties it and
  // goes on, so a queue never drops a candidate.  Returns whether that
  // happened (the same for the whole warp); what is queued at the end is
  // left for the caller to drain.
  auto walk = [&](auto two, float cx, float cy, float cz, float limit,
                  auto fn) {
    constexpr bool kTwo = decltype(two)::value;
    bool spilled = false;
    const int groups = has_ghosts ? 2 : 1;
    for (int g = 0; g < groups; ++g) {
      const float4* __restrict__ src = g ? sa + n : sa;
      const int* __restrict__ st = g ? gcs : cs;
      const int* __restrict__ en = g ? gce : ce;
      const int first = g ? n : 0;
      int dy = -1, dz = -1;
      int row = k - x - stride_y - grid.nx;
      auto bounds = [&](int* j, int* e) {
        *j = 0, *e = 0;
        if (fluid &&
            static_cast<unsigned>(y + dy) < static_cast<unsigned>(grid.ny) &&
            static_cast<unsigned>(z + dz) < static_cast<unsigned>(grid.nz)) {
          *j = __ldg(st + row + x0);
          *e = __ldg(en + row + x1);
        }
      };
      int j, e;
      bounds(&j, &e);
#pragma unroll 3
      for (int q = 0; q < 9; ++q) {
        // the next range's bounds load while this range is walked
        ++dz, row += grid.nx;
        if (dz > 1) dz = -1, ++dy, row += stride_y - 3 * grid.nx;
        int next_j = 0, next_e = 0;
        if (q < 8) bounds(&next_j, &next_e);
        for (;;) {
          // two candidates a step, while two queue slots are free
#pragma unroll 1
          for (; j < e && qaddr < qend - kBlock * 4; j += 2) {
            const int j1 = min(j + 1, e - 1);
            const float4 a0 = __ldg(src + j);
            const float4 a1 = __ldg(src + j1);
            auto near = [&](const float4& a) {
              const float dx = cx - a.x;
              const float dy_ = cy - a.y;
              const float dz_ = cz - a.z;
              const float d2 = dx * dx + dy_ * dy_ + dz_ * dz_;
              bool in_reach = d2 < limit;
              if (kTwo) {
                // |c + s - a|^2 - |s|^2, from the same offsets
                const float t =
                    fmaf(dx, sx2, fmaf(dy_, sy2, fmaf(dz_, sz2, d2)));
                in_reach = in_reach | (t < near2);
              }
              return in_reach;
            };
            auto push = [&](int e_) {
              asm volatile("st.shared.b32 [%0], %1;" ::"r"(qaddr), "r"(e_)
                           : "memory");
              qaddr += kBlock * 4;
            };
            if (near(a0)) push(first + j);
            if (near(a1) & (j + 1 < e)) push(first + j + 1);
          }
          if (!__any_sync(kFullWarp, j < e)) break;
          drain(fn);
          qaddr = qbase;
          spilled = true;
          near2 = -3.4e38f;
        }
        j = next_j, e = next_e;
      }
    }
    return spilled;
  };
  const std::true_type both_centers;
  const std::false_type one_center;

  // --- pass 1: pressure, viscosity, color field (SPHFluid.comp:129-151)
  float fpx = 0.f, fpy = 0.f, fpz = 0.f;
  float fvx = 0.f, fvy = 0.f, fvz = 0.f;
  float gcx = 0.f, gcy = 0.f, gcz = 0.f, lc = 0.f;
  // One queued record, branch-free so that the drain loop can keep several
  // records' loads in flight: one that fails the exact r < h test, is dead
  // (rho <= 0) or is the row itself adds zeros.
  auto pair = [&](int e) {
    const float4 a = __ldg(sa + e);
    const float4 b = __ldg(sb + e);
    const float rx = xi - a.x;
    const float ry = yi - a.y;
    const float rz = zi - a.z;
    const float r2 = rx * rx + ry * ry + rz * rz;
    const float rinv = rsqrt_approx(fmaxf(r2, 1e-24f));
    const float r = r2 * rinv;
    const bool ok = (r < p.h) & (a.w > 0.f) & (e != i);
    const float presj = fmaxf(p.gas_k * (a.w - p.rho0), 0.f);
    const float m_over_rho = b.w;
    const float dcl = p.h - r;
    const float gmag = ok & (r2 > 0.f) ? p.spiky * dcl * dcl * rinv : 0.f;
    const float lapw = ok ? p.visc_lap * dcl : 0.f;
    const float ps = gmag * (-(presi + presj) * 0.5f * m_over_rho);
    fpx += rx * ps;
    fpy += ry * ps;
    fpz += rz * ps;
    const float vs = m_over_rho * lapw;
    fvx += (b.x - vxi) * vs;
    fvy += (b.y - vyi) * vs;
    fvz += (b.z - vzi) * vs;
    const float gs = gmag * m_over_rho;
    gcx += rx * gs;
    gcy += ry * gs;
    gcz += rz * gs;
    lc += vs;
  };
  // the one walk: whatever is near either center waits in the queue
  const bool spilled = walk(both_centers, xi, yi, zi, near1, pair);
  drain(pair);

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
  // one queued record, branch-free as above: the exact r2 < h2 test
  auto smooth = [&](int e) {
    const float4 a = __ldg(sa + e);
    const float4 b = __ldg(sb + e);
    const float dx = npx - a.x;
    const float dy = npy - a.y;
    const float dz = npz - a.z;
    const float r2 = dx * dx + dy * dy + dz * dz;
    const bool ok = (r2 < p.h2) & (a.w > 0.f) & (e != i);
    const float d = p.h2 - r2;
    const float wgt = ok ? p.poly6 * d * d * d : 0.f;
    const float mw = wgt * b.w;
    xsx += (b.x - nvx) * mw;
    xsy += (b.y - nvy) * mw;
    xsz += (b.z - nvz) * mw;
    xn += wgt;
  };
  // The queue still holds every source within h + margin of pos + s,
  // unless the walk had to empty it on the way.  A row whose fresh
  // position is within 0.9 margin of pos + s has every source within h of
  // the fresh position among them (the 0.1 margin left over is far above
  // float32 rounding).  If that holds for the whole warp it reads the
  // queue again; else it walks again, around the fresh position.
  const float mx = npx - (xi + 0.5f * sx2);
  const float my = npy - (yi + 0.5f * sy2);
  const float mz = npz - (zi + 0.5f * sz2);
  const bool far =
      fluid & !(mx * mx + my * my + mz * mz <= 0.81f * margin * margin);
  if (spilled || __any_sync(kFullWarp, far)) {
    qaddr = qbase;
    walk(one_center, npx, npy, npz, p.h2, smooth);
  }
  drain(smooth);

  if (!in) return;
  if (!fluid) {
    store_row<kEmit>(i, xi, yi, zi, vxi, vyi, vzi, 0.f, 0.f, 0.f, rhoi, npos,
                     nvel, acc, per);
    return;
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
                           const float* vel, const int* cell_start,
                           const int* cell_end, int n, const float* ghost_pos,
                           const int* ghost_start, const int* ghost_end,
                           const unsigned char* ghost_near,
                           const SphSweepParams* params, int nx, int ny,
                           int nz, float* rho, float* pres, float* src,
                           int src_rows, void* stream) {
  if (n > 0) {
    const bool pack = vel != nullptr && src != nullptr;
    float4* sa = pack ? reinterpret_cast<float4*>(src) : nullptr;
    density_kernel<<<grid_for(n), kBlock, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        key, pos, vel, cell_start, cell_end, n, ghost_pos, ghost_start,
        ghost_end, ghost_near, SphGrid{nx, ny, nz}, params, rho, pres, sa,
        pack ? sa + src_rows : nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_force_xsph(const int* key, const float* src, int src_rows,
                              const int* cell_start, const int* cell_end,
                              int n, const int* ghost_start,
                              const int* ghost_end, int has_ghosts,
                              const SphSweepParams* params, int nx,
                              int ny, int nz, float* npos, float* nvel,
                              float* acc, void* stream) {
  if (n > 0) {
    const float4* sa = reinterpret_cast<const float4*>(src);
    force_xsph_kernel<false><<<grid_for(n), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        key, sa, sa + src_rows, cell_start, cell_end, n, ghost_start,
        ghost_end, has_ghosts, SphGrid{nx, ny, nz}, params, npos, nvel, acc,
        nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_force_xsph_emit(const int* key, const float* src,
                                   int src_rows, const int* cell_start,
                                   const int* cell_end, int n,
                                   const int* ghost_start,
                                   const int* ghost_end, int has_ghosts,
                                   const SphSweepParams* params, int nx,
                                   int ny, int nz, float* per,
                                   void* stream) {
  if (n > 0) {
    const float4* sa = reinterpret_cast<const float4*>(src);
    force_xsph_kernel<true><<<grid_for(n), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        key, sa, sa + src_rows, cell_start, cell_end, n, ghost_start,
        ghost_end, has_ghosts, SphGrid{nx, ny, nz}, params, nullptr, nullptr,
        nullptr, per);
  }
  return static_cast<int>(cudaGetLastError());
}
