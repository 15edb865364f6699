// The frame export's splat composition on the card (sm_90a), written by
// hand.  It replaces no TPU kernel: the JAX package composes its frames on
// the host (sph_tpu/viz/splat.py, native/splat_raster.cpp), and so did the
// port until this file.  Its plain version is viz/splat.compose_plain.
//
// The host path sorts the drawn rows far to near (a stable sort) and
// overwrites each row's disc footprint in turn, offsets dy-outer, dx-inner;
// a pixel shows its last writer.  Here no sort is made.  Each covered
// pixel takes the largest 64-bit key of the writes that land on it:
//
//   bits 63-32  0x7fffffff - bits(w), w > 0 the row's view depth: nearer
//               rows are larger, equal depths tie
//   bits 31-s   the row's index: the stable sort's tie-break
//   bits s-1-0  the footprint offset's index (dy + F)(2F + 1) + dx + F:
//               int(cx + dx) truncates toward zero, so near x = 0 or y = 0
//               two offsets of one disc land on one pixel, and the host
//               keeps the later one
//
// so the largest key names the host's last writer.  splat_keys_kernel
// projects each row as the host does (its BLAS product is an FMA chain over
// k in order; every other operation rounds alone, never contracted) and
// atomicMax-es its offsets' keys; splat_owners_kernel gathers each
// pixel's owner row (and its view-space position, computed again) for the
// colours (palettes, torch ops on the owners alone, P rows and not n);
// splat_shade_kernel shades each pixel from its owner with the host's
// float32 operations, or fills the background, and writes the 8-bit image
// and the depth buffer.  The
// specular power diff^24 is taken in double by squaring and rounded once
// (the host's powf is within one ulp of it; an ulp of it moves no 8-bit
// level in practice).
//
// What bounds it on the card: bytes.  A row reads its position, valid and
// ghost words (20 bytes, 21 with a mask) and, where it is drawn, writes
// one key a covered pixel, most into the L2-resident key buffer (8 bytes a
// pixel); a pixel reads its key, owner and colour and writes 3 bytes.  At
// the export's sizes (4M rows, 960x540, discs of one pixel) the rows'
// reads are the work; a pixel's key is read before its atomic so that
// rows hidden behind a nearer one cost no atomic.

#include <cuda_runtime.h>

#include <cstdint>

#include "splat.h"

namespace {

constexpr int kBlock = 256;

// a[0:3] . m[0:3] + m[3] as the host computes it: numpy's BLAS product
// (an FMA chain over k in order), then the translation's add
__device__ __forceinline__ float affine(float a0, float a1, float a2,
                                        const float* m) {
  return __fadd_rn(fmaf(a2, m[2], fmaf(a1, m[1], __fmul_rn(a0, m[0]))),
                   m[3]);
}

__device__ __forceinline__ void view_pos(const float* __restrict__ pos,
                                         long long i,
                                         const SphSplatCamera& c,
                                         float v[3]) {
  const float p0 = pos[3 * i], p1 = pos[3 * i + 1], p2 = pos[3 * i + 2];
#pragma unroll
  for (int j = 0; j < 3; ++j) v[j] = affine(p0, p1, p2, c.view[j]);
}

// the disc's radius in pixels at view depth w (particleImpostor.vert:38-40)
__device__ __forceinline__ float radius_px(float w, const SphSplatCamera& c) {
  const float size = __fmul_rn(
      __fmul_rn(__fdiv_rn(c.size, fmaxf(w, 1e-6f)), float(c.height)), 0.5f);
  return fminf(fmaxf(__fmul_rn(size, 0.5f), 0.5f), float(c.footprint));
}

// x^24 in double by squaring, rounded once to float32
__device__ __forceinline__ float pow24(float x) {
  const double x2 = __dmul_rn(double(x), double(x));
  const double x4 = __dmul_rn(x2, x2);
  const double x8 = __dmul_rn(x4, x4);
  const double x16 = __dmul_rn(x8, x8);
  return __double2float_rn(__dmul_rn(x16, x8));
}

__device__ __forceinline__ unsigned char to_byte(float v) {
  v = fminf(fmaxf(v, 0.0f), 1.0f);
  return static_cast<unsigned char>(static_cast<int>(__fmul_rn(v, 255.0f)));
}

__global__ void __launch_bounds__(kBlock)
splat_keys_kernel(const float* __restrict__ pos, const int* __restrict__ valid,
                  const int* __restrict__ ghost,
                  const unsigned char* __restrict__ mask, int n,
                  SphSplatCamera c, unsigned long long* keys) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  if (valid[i] <= 0 || ghost[i] > 0 || (mask != nullptr && mask[i] == 0)) {
    return;
  }
  float v[3];
  view_pos(pos, i, c, v);
  const float w = -v[2];
  if (!(w > 1e-6f)) return;
  const float c0 = affine(v[0], v[1], v[2], c.proj[0]);
  const float c1 = affine(v[0], v[1], v[2], c.proj[1]);
  const float sw = fmaxf(w, 1e-6f);
  const float px = __fmul_rn(
      __fadd_rn(__fmul_rn(__fdiv_rn(c0, sw), 0.5f), 0.5f), float(c.width));
  const float py = __fmul_rn(
      __fsub_rn(1.0f, __fadd_rn(__fmul_rn(__fdiv_rn(c1, sw), 0.5f), 0.5f)),
      float(c.height));
  if (!(px > -8.0f && px < float(c.width + 8) && py > -8.0f &&
        py < float(c.height + 8))) {
    return;
  }
  const float rad = radius_px(w, c);
  const unsigned long long base =
      (static_cast<unsigned long long>(0x7fffffffu - __float_as_uint(w))
       << 32) |
      (static_cast<unsigned long long>(i) << c.row_shift);
  const int fp = c.footprint, side = 2 * fp + 1;
  const int reach = min(fp, static_cast<int>(rad));
  for (int dy = -reach; dy <= reach; ++dy) {
    for (int dx = -reach; dx <= reach; ++dx) {
      const float d = __fsqrt_rn(float(dx * dx + dy * dy));
      if (d > rad) continue;
      const int x = static_cast<int>(__fadd_rn(px, float(dx)));
      const int y = static_cast<int>(__fadd_rn(py, float(dy)));
      if (x < 0 || x >= c.width || y < 0 || y >= c.height) continue;
      const unsigned long long key =
          base | static_cast<unsigned>((dy + fp) * side + dx + fp);
      unsigned long long* slot = keys + static_cast<size_t>(y) * c.width + x;
      if (__ldcg(slot) < key) atomicMax(slot, key);
    }
  }
}

__global__ void __launch_bounds__(kBlock)
splat_owners_kernel(const float* __restrict__ pos,
                    const unsigned long long* __restrict__ keys, int pixels,
                    SphSplatCamera c, SphSplatOwners cols) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const unsigned long long key = keys[p];
  const long long row =
      key != 0
          ? static_cast<long long>(static_cast<unsigned>(key) >> c.row_shift)
          : 0;
  float v[3] = {0.0f, 0.0f, 0.0f};
  if (key != 0) view_pos(pos, row, c, v);
  float* o = cols.owners;
  const long long P = pixels;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[3 * p + k] = pos[3 * row + k];
    o[3 * P + 3 * p + k] = v[k];
    o[6 * P + 3 * p + k] = cols.vel[3 * row + k];
  }
  o[9 * P + p] = cols.pressure[row];
  o[10 * P + p] = cols.density[row];
  reinterpret_cast<int*>(o)[11 * P + p] = cols.color_group[row];
}

__global__ void __launch_bounds__(kBlock)
splat_shade_kernel(const unsigned long long* __restrict__ keys,
                   const float* __restrict__ owner_vpos,
                   const float* __restrict__ colors,
                   const unsigned char* __restrict__ background, int pixels,
                   SphSplatCamera c, unsigned char* __restrict__ image,
                   float* __restrict__ depth) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= pixels) return;
  const unsigned long long key = keys[p];
  float rgb[3], z = 0.0f;
  if (key == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rgb[k] = background != nullptr
                   ? __fdiv_rn(float(background[3 * p + k]), 255.0f)
                   : c.background[k];
    }
  } else {
    z = -owner_vpos[3 * p + 2];
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] = colors[3 * p + k];
    if (c.lit) {
      // the fake-sphere disc shading of native/splat_raster.cpp, op by op
      const int side = 2 * c.footprint + 1;
      const int f = static_cast<int>(static_cast<unsigned>(key) &
                                     ((1u << c.row_shift) - 1u));
      const int dx = f % side - c.footprint, dy = f / side - c.footprint;
      const float d = __fsqrt_rn(float(dx * dx + dy * dy));
      const float r = radius_px(z, c);
      const float rc = r < 0.5f ? 0.5f : r;
      float nr = __fdiv_rn(d, rc);
      if (nr > 0.97f) nr = 0.97f;
      const float nz = __fsqrt_rn(__fsub_rn(1.0f, __fmul_rn(nr, nr)));
      const float dd = d < 1e-6f ? 1e-6f : d;
      const float nx = __fmul_rn(__fdiv_rn(float(dx), dd), nr);
      const float ny = __fmul_rn(__fdiv_rn(float(-dy), dd), nr);
      float diff = __fadd_rn(
          __fadd_rn(__fmul_rn(nx, c.light[0]), __fmul_rn(ny, c.light[1])),
          __fmul_rn(nz, c.light[2]));
      if (diff < 0.0f) diff = 0.0f;
      const float shade = __fadd_rn(0.35f, __fmul_rn(0.65f, diff));
      const float spec = __fmul_rn(pow24(diff), 0.4f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        float v = __fadd_rn(__fmul_rn(rgb[k], shade),
                            __fmul_rn(c.sun[k], spec));
        if (v > 1.0f) v = 1.0f;
        if (v < 0.0f) v = 0.0f;
        rgb[k] = v;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) image[3 * p + k] = to_byte(rgb[k]);
  if (depth != nullptr) depth[p] = z;
}

int blocks(long long count) {
  return static_cast<int>((count + kBlock - 1) / kBlock);
}

}  // namespace

extern "C" int sph_splat_keys(const float* pos, const int* valid,
                              const int* ghost, const unsigned char* mask,
                              int n, const SphSplatCamera* cam,
                              const SphSplatOwners* cols,
                              unsigned long long* keys, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = cam->width * cam->height;
  // the background's pixels gather row 0, so there is one
  if (pixels <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = cudaMemsetAsync(
      keys, 0, sizeof(unsigned long long) * static_cast<size_t>(pixels), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  splat_keys_kernel<<<blocks(n), kBlock, 0, s>>>(pos, valid, ghost, mask, n,
                                                 *cam, keys);
  splat_owners_kernel<<<blocks(pixels), kBlock, 0, s>>>(pos, keys, pixels,
                                                        *cam, *cols);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sph_splat_shade(const unsigned long long* keys,
                               const float* owners, const float* colors,
                               const unsigned char* background,
                               const SphSplatCamera* cam,
                               unsigned char* image, float* depth,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int pixels = cam->width * cam->height;
  if (pixels <= 0) return static_cast<int>(cudaErrorInvalidValue);
  splat_shade_kernel<<<blocks(pixels), kBlock, 0, s>>>(
      keys, owners + 3 * static_cast<size_t>(pixels), colors, background,
      pixels, *cam, image, depth);
  return static_cast<int>(cudaGetLastError());
}
