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
//     thread in shared memory (16 KB a block, 7 blocks of 128 threads an
//     SM since the tile path below, so an SM keeps 28 warps; 40 and 48
//     entries were slower at 8 blocks, they
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
//
// What bounds it in a crowded state (rotated_512k's piled-up corner: 40 to
// 170 rows a cell, 2,000 to 4,300 candidates and 200 to 800 sources within
// h a row): the queue fills about 30 times a walk, so every warp walks
// twice, and the 32 lanes issue 32 separate loads for what, inside one
// cell, are the very same records.  But the rows are sorted by cell, so a
// crowded cell holds whole aligned warps, whose 32 rows share the same 9
// ranges exactly.  Such a warp takes the tile path instead, as
// csrc/brute.cu's force kernel does: for each range of the warp's cells, in
// tiles of 32 records, each lane stages one record in the warp's 4 KB of
// the queue's memory (so the shared memory stays as it is), tests its row
// against all 32 without a branch into a hit mask (the expanded test, 3
// FFMA a candidate, about the first row of the run, with a slack that lets
// every source within h through), keeps the bits of its own range (the
// warp's cells span more in x than the row's own three, the queue path's
// candidates, whatever the cells' width) and runs the same pair math over
// the hits, lowest first.  Nothing is queued, so nothing spills; pass 2
// sweeps the ranges again about the fresh position.  A warp takes it (one
// vote at entry) when its 32 rows are fluid and lie in one x-run of cells
// or in two, and either each run's rows span at most kTileSpan = 2 cells,
// or some row's own three cells of its run hold kTileCrowd = 64 rows or
// more (two bounds a row).  A warp of two runs sweeps once for each, about
// the run's own y and z, and a row keeps the hits of its own run only, so
// its sources come in the same order.  Every other warp (sparse cells
// three or more apart, three runs, the last partial warp, ghost or padding
// rows) walks and queues as above.  The two paths are two inlined copies
// of the rest of the kernel, so that neither keeps the other's state live.
//
// Why that rule (H100 at 700 W, rotated_512k after 20, 60 and 100 frames,
// default_131k and ghost_1m after 5; PERF.md section 6): the kernel's time
// in the pile-up is the time of its longest warps, which run from its
// start.  With one or two cells a warp, those were warps across the end of
// an x-run whose rows ended one run in sparse cells and began the next in
// the corner's crowded cells: on the queue path the few lanes of crowded
// cells walked and spilled for up to 6 ms of a 7.9 ms kernel while the
// others idled.  Taking them (the crowd clause) makes the kernel 1.65x,
// 1.98x and 1.87x faster there (2.0x after 160 and 240 frames),
// bit-equal, and leaves the others at 0.985x-1.00x (the vote's two loads);
// what bounds it then is the tile warps of the crowded cells, up to
// 3.3-3.6 ms each.  Wider runs of sparse cells lose on the
// tile path: 3, 4 and 6 cells a run cost ghost_1m 5-9% and gained nothing
// in the pile-up, and every two-run warp whatever its cells cost
// default_131k and ghost_1m 40-53%.  What bounds the tile path is the
// issue rate again, now of the 3 FFMA a candidate and of the pair math,
// which runs as long as the lane with the most hits in a tile; and
// registers: with it the kernel needs more than 64 a thread, so it runs 7
// blocks an SM at 72.  Against the kernel without a tile path: 2.32x on
// rotated_512k after 60 frames with one or two cells a warp, 1.07x on
// default_131k and 0.98x on ghost_1m after 5; at 64 registers it spilled
// more, and as two launches, a tile kernel and a queue kernel, it lost
// everywhere.
//
// Sums run in the queue's order, which is the walk's; the tile path adds a
// row's sources in the same order (a source that fails the exact test adds
// zeros on the queue path, which leaves a float sum as it is), and no
// atomics are used (but on the optional tile_warps counter), so two
// launches on the same inputs are bit-equal, the emit variant is bit-equal
// to the plain one, and a row's results do not depend on the path its warp
// took.  No TMA or wgmma: the ranges are short and ragged, and there is no
// matrix product.
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
constexpr int kTileSpan = 2;           // the tile path's widest run, cells
constexpr int kTileCrowd = 64;         // its crowded row's three cells, rows
constexpr int kForceBlocks = 7;        // blocks an SM (72 registers a thread)
constexpr int kWarps = kBlock / 32;
constexpr float kMarginFrac = 0.05f;   // the queue's margin, in h
// the tile test's slack: a relative 1e-4 of h^2 (the rsqrt.approx of the
// exact test), and 1e-5 of the squared distances from the run's first row
// that the expanded form rounds (its rounding is below 1e-6 of them)
constexpr float kTileSlack = 1e-4f;
constexpr float kTileRound = 1e-5f;
constexpr int kTestGroup = 8;          // tile tests unrolled a step
constexpr unsigned kFullWarp = 0xffffffffu;

__device__ __forceinline__ float rsqrt_approx(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sa, sb: the source records (sweeps.h), the ghosts' after the n rows.
// tile_warps: null, or a counter to which every warp that takes the tile
// path adds 1.
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
                  float* __restrict__ per, int* __restrict__ tile_warps) {
  const SphSweepParams p = *prm;
  // the queue: record indices, entry q of lane l of warp w at queue[w][q][l];
  // a warp on the tile path stages its tiles in its own 4 KB of it instead
  __shared__ __align__(16) int queue[kWarps][kQueue][32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  constexpr unsigned kEntry = 32 * 4;   // one entry of every lane, in bytes
  const unsigned qbase = static_cast<unsigned>(
      __cvta_generic_to_shared(&queue[tid >> 5][0][lane]));
  const unsigned qend = qbase + kQueue * kEntry;
  const int i = blockIdx.x * blockDim.x + tid;
  const int nc = grid.nx * grid.ny * grid.nz;
  // no thread leaves before the last warp vote: a row out of range or
  // without a cell walks nothing
  const bool in = i < n;
  const int k = in ? key[i] : nc;
  const bool fluid = k < nc;
  const int x = k % grid.nx;
  const int z = (k / grid.nx) % grid.nz;
  const int y = k / (grid.nx * grid.nz);
  const int x0 = max(x - 1, 0), x1 = min(x + 1, grid.nx - 1);
  // the tile path: the warp's 32 rows are all fluid and lie in one x-run of
  // cells (one y and z) or in two (the rows are sorted: lane 0 holds the
  // first run's lowest key, lane 31 the last run's highest), and either the
  // rows of each run span at most kTileSpan cells, empty ones between them
  // included, or some row's own three cells of its run hold kTileCrowd rows
  // or more
  const int k0 = __shfl_sync(kFullWarp, k, 0);
  const int k31 = __shfl_sync(kFullWarp, k, 31);
  const bool run0 = k / grid.nx == k0 / grid.nx;
  const int end0 = __reduce_max_sync(kFullWarp, run0 ? k : k0);
  const int start1 = __reduce_min_sync(kFullWarp, run0 ? k31 : k);
  const int crowd = fluid ? __ldg(ce + k - x + x1) - __ldg(cs + k - x + x0) : 0;
  const bool tile =
      __all_sync(kFullWarp, fluid & (run0 | (k / grid.nx == k31 / grid.nx))) &
      (((end0 - k0 < kTileSpan) & (k31 - start1 < kTileSpan)) |
       __any_sync(kFullWarp, crowd >= kTileCrowd));
  float4 self_a = make_float4(0.f, 0.f, 0.f, 0.f), self_b = self_a;
  if (in) self_a = sa[i], self_b = sb[i];
  const float xi = self_a.x, yi = self_a.y, zi = self_a.z, rhoi = self_a.w;
  const float vxi = self_b.x, vyi = self_b.y, vzi = self_b.z;
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
    const int queued = static_cast<int>((qaddr - qbase) / kEntry);
    const int most = __reduce_max_sync(kFullWarp, queued);
#pragma unroll 2
    for (int q = 0; q < most; ++q)
      fn(q < queued ? queue[tid >> 5][q][lane] : idle);
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
          for (; j < e && qaddr < qend - kEntry; j += 2) {
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
              qaddr += kEntry;
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

  // The tile path's sweep about c (the row's pos, then its fresh position),
  // once for each x-run of the warp's rows (one or two): the run's 9 fluid
  // ranges, then its 9 ghost ranges, from its rows' lowest x less one to
  // their highest plus one, in tiles of 32 records; a row of the run takes
  // the part of a tile in its own range (x - 1 to x + 1), a row of the
  // other run nothing.  Each lane stages one record of a tile (a coalesced
  // load) in the warp's slice of the queue's memory; each lane then tests
  // its row against all 32 without a branch and runs fn over the hits,
  // lowest first, so a row meets its sources in the queue path's order
  // (ranges in order, j ascending, fluid before ghosts) and its sums are
  // the same.  The test is the expanded one of csrc/brute.cu,
  // |s'|^2 - 2 c'.s' < h^2 - |c'|^2, in coordinates about the run's first
  // row o (c' = c - o, s' = s - o), 3 FFMA a candidate.  Its slack lets
  // every source within h through, and the exact test decides, whatever
  // the offsets, so at any width of the run: the terms of the test round to
  // 2^-24 of |s'|^2, 2|c'||s'| and |c'|^2, each at most |c'|^2 + |s'|^2,
  // and c' and s' to 2^-24 of themselves, which moves |c - s|^2 (about h^2
  // at the edge) by at most 2^-24 (h^2 + 2 (|c'|^2 + |s'|^2)): in all less
  // than 1e-6 (|c'|^2 + widest |s'|^2) + 2e-7 h^2, against a slack of 1e-5
  // of the first and 1e-4 h^2 (that of the rsqrt.approx of the exact
  // test).  A wider run only lets more sources beyond h through.
  float4* const stage_a = reinterpret_cast<float4*>(&queue[tid >> 5][0][0]);
  float4* const stage_b = stage_a + 32;
  float4* const stage_t = stage_a + 64;
  auto sweep = [&](float cx, float cy, float cz, auto fn) {
    const int runs = __shfl_sync(kFullWarp, k, 0) / grid.nx ==
                             __shfl_sync(kFullWarp, k, 31) / grid.nx
                         ? 1 : 2;
    for (int part = 0; part < runs; ++part) {
      for (int q = 0; q < (has_ghosts ? 18 : 9); ++q) {
        // the range's bounds, from the keys (nothing of it is kept live): the
        // run's y and z, the lowest and highest x of its rows, and the row's
        // own range if the row is in the run (else none)
        const int g = q >= 9;
        const int rk = __shfl_sync(kFullWarp, k, part ? 31 : 0);
        const bool mine = k / grid.nx == rk / grid.nx;
        const int kx = k % grid.nx;
        const int wx0 = __reduce_min_sync(kFullWarp, mine ? kx : grid.nx);
        const int wx1 = __reduce_max_sync(kFullWarp, mine ? kx : 0);
        const int yy = rk / (grid.nx * grid.nz) + (q - 9 * g) / 3 - 1;
        const int zz = (rk / grid.nx) % grid.nz + (q - 9 * g) % 3 - 1;
        int j = 0, e = 0, lo = 0, hi = 0;
        if (static_cast<unsigned>(yy) < static_cast<unsigned>(grid.ny) &&
            static_cast<unsigned>(zz) < static_cast<unsigned>(grid.nz)) {
          const int row = grid.nx * (zz + grid.nz * yy);
          const int* st = g ? gcs : cs;
          const int* en = g ? gce : ce;
          j = __ldg(st + row + max(wx0 - 1, 0));
          e = __ldg(en + row + min(wx1 + 1, grid.nx - 1));
          if (mine) {
            lo = __ldg(st + row + max(kx - 1, 0));
            hi = __ldg(en + row + min(kx + 1, grid.nx - 1));
          }
        }
        auto below = [](int t) {
          return t <= 0 ? 0u : t >= 32 ? ~0u : (1u << t) - 1u;
        };
        const int first = g ? n : 0;
        for (; j < e; j += 32) {
          // o, the run's first row, and the row's terms of the test, made
          // again a tile (not kept live)
          const int o = __ffs(__ballot_sync(kFullWarp, mine)) - 1;
          const float ox = __shfl_sync(kFullWarp, xi, o);
          const float oy = __shfl_sync(kFullWarp, yi, o);
          const float oz = __shfl_sync(kFullWarp, zi, o);
          float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a, t = a;
          if (j + lane < e) {
            a = __ldg(sa + first + j + lane);
            b = __ldg(sb + first + j + lane);
            t.x = a.x - ox, t.y = a.y - oy, t.z = a.z - oz;
            t.w = t.x * t.x + t.y * t.y + t.z * t.z;
          }
          // the tile's widest |s'|^2 sizes its slack (a NaN or inf position
          // lets the whole tile through, to the exact test)
          const float widest = fminf(
              __uint_as_float(
                  __reduce_max_sync(kFullWarp, __float_as_uint(t.w))),
              3e38f);
          const float qx = cx - ox, qy = cy - oy, qz = cz - oz;
          const float cq = qx * qx + qy * qy + qz * qz;
          const float limit =
              p.h2 * (1.f + kTileSlack) - cq + kTileRound * (cq + widest);
          const float ux = -2.f * qx, uy = -2.f * qy, uz = -2.f * qz;
          __syncwarp();   // the last tile's hits are read
          stage_a[lane] = a, stage_b[lane] = b, stage_t[lane] = t;
          __syncwarp();
          // kTestGroup tests a step (4 and 16 measured the same)
          unsigned hits = 0u;
#pragma unroll 1
          for (int s0 = 0; s0 < 32; s0 += kTestGroup) {
            unsigned group = 0u;
#pragma unroll
            for (int s = 0; s < kTestGroup; ++s) {
              const float4 r = stage_t[s0 + s];
              const float d = fmaf(ux, r.x, fmaf(uy, r.y, fmaf(uz, r.z, r.w)));
              group |= (d < limit ? 1u : 0u) << s;
            }
            hits |= group << s0;
          }
          hits &= below(hi - j) & ~below(lo - j);   // the row's own range
          while (hits != 0u) {
            const int s = __ffs(hits) - 1;
            hits &= hits - 1u;
            fn(stage_a[s], stage_b[s], first + j + s);
          }
        }
      }
    }
  };

  // The rest of the kernel, once for each path: a warp takes one or the
  // other as a whole, and what only the other path needs is not kept live.
  auto rows = [&](auto tile_path) {
    constexpr bool kTile = decltype(tile_path)::value;
    // --- pass 1: pressure, viscosity, color field (SPHFluid.comp:129-151)
    float fpx = 0.f, fpy = 0.f, fpz = 0.f;
    float fvx = 0.f, fvy = 0.f, fvz = 0.f;
    float gcx = 0.f, gcy = 0.f, gcz = 0.f, lc = 0.f;
    // One source's records a, b (record index e), branch-free so that the
    // drain loop can keep several records' loads in flight: one that fails
    // the exact r < h test, is dead (rho <= 0) or is the row itself adds
    // zeros.
    auto pair_with = [&](const float4& a, const float4& b, int e) {
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
    // one queued record
    auto pair = [&](int e) { pair_with(__ldg(sa + e), __ldg(sb + e), e); };
    bool spilled = false;
    if constexpr (kTile) {
      if (tile_warps != nullptr && lane == 0) atomicAdd(tile_warps, 1);
      sweep(xi, yi, zi, pair_with);
    } else {
      // the one walk: whatever is near either center waits in the queue
      spilled = walk(both_centers, xi, yi, zi, near1, pair);
      drain(pair);
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
    // one source's records, branch-free as above: the exact r2 < h2 test
    auto smooth_with = [&](const float4& a, const float4& b, int e) {
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
    auto smooth = [&](int e) {
      smooth_with(__ldg(sa + e), __ldg(sb + e), e);
    };
    if constexpr (kTile) {
      sweep(npx, npy, npz, smooth_with);
    } else {
      // The queue still holds every source within h + margin of pos + s,
      // unless the walk had to empty it on the way.  A row whose fresh
      // position is within 0.9 margin of pos + s has every source within h
      // of the fresh position among them (the 0.1 margin left over is far
      // above float32 rounding).  If that holds for the whole warp it reads
      // the queue again; else it walks again, around the fresh position.
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
    }

    if (!in) return;
    if (!fluid) {
      store_row<kEmit>(i, xi, yi, zi, vxi, vyi, vzi, 0.f, 0.f, 0.f, rhoi,
                       npos, nvel, acc, per);
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
  };
  if (tile) {
    rows(std::true_type{});
  } else {
    rows(std::false_type{});
  }
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
                              float* acc, void* stream, int* tile_warps) {
  if (n > 0) {
    const float4* sa = reinterpret_cast<const float4*>(src);
    force_xsph_kernel<false><<<grid_for(n), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
        key, sa, sa + src_rows, cell_start, cell_end, n, ghost_start,
        ghost_end, has_ghosts, SphGrid{nx, ny, nz}, params, npos, nvel, acc,
        nullptr, tile_warps);
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
                                   void* stream, int* tile_warps) {
  if (n > 0) {
    const float4* sa = reinterpret_cast<const float4*>(src);
    force_xsph_kernel<true><<<grid_for(n), kBlock, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        key, sa, sa + src_rows, cell_start, cell_end, n, ghost_start,
        ghost_end, has_ghosts, SphGrid{nx, ny, nz}, params, nullptr, nullptr,
        nullptr, per, tile_warps);
  }
  return static_cast<int>(cudaGetLastError());
}
