// The container-and-foam pass for Hopper (sm_90a), written by hand.
//
// What the substep does after its two sweeps, row by row, in one launch:
//   reassembly  (neighbors/sweeps.reassemble_plain): the foam of the fluid
//               rows (physics/common.foam_update) and, for a state with
//               ghosts, the ghost rows' values (a contributing ghost gets
//               rho0, P = 0, v = 0, acc = 0; a ghost on an inactive face
//               keeps its old values);
//   container   (physics/constraints.apply_container_plain): the row moved
//               into the container's frame, R^T (p - c), projected onto the
//               surface of its shape where it lies outside, moved back, and
//               its velocity reflected, -e v_n + (1 - mu) v_t.
// As plain torch ops these are a chain of about 75 small launches and three
// cuBLAS sgemm of [N,3] @ [3,3] a substep (K = 3 and N = 3 on tiles of
// 128 x 128), each reading and writing whole columns.  Here each row is
// read once and written once: the pass is bound by bytes.
//
// Two template flags pick what a launch does: kReassemble, kContain, or
// both (the cell engine's substep: the sweeps' outputs go in, the finished
// state comes out).  Reassembly writes foam, and with ghosts vel, acc,
// density and pressure; the container writes pos and vel.  What a launch
// does not write the wrapper passes through.  The shape is a template argument too, so the box's
// pass carries no register of the trefoil's walk or the superellipsoid's
// powers.  The rotation R = Rz Ry Rx is built from box_euler_deg once a
// block, in shared memory, with the cosf and sinf that torch.cos and
// torch.sin call; the params are read through their tensors' pointers, so a
// captured launch follows a change of them.
//
// Rounding.  Every product, sum and quotient that torch rounds on its own is
// rounded on its own here (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn, which
// nvcc never contracts into an FMA), every clamp, minimum and maximum lets a
// NaN through as torch's do, and a sum over a row's three columns adds in
// torch's order on the card (sum3).  So where R is the identity (zero Euler
// angles) the pass is bit-identical to the torch chain on the card; the
// rotation itself (three FMAs a term, as the sgemm) may round differently
// from torch's products of 3x3 matrices by an ulp.

#include <cuda_runtime.h>

#include "container.h"

namespace {

constexpr int kBlock = 256;
constexpr float kEps = 1e-6f;           // constraints._EPS
constexpr float kTiny = 1e-12f;
constexpr float kFoamDecay = 0.995f;    // common.FOAM_DECAY
// the float32 factor of torch's euler_deg * (math.pi / 180.0)
constexpr float kDegToRad = static_cast<float>(3.14159265358979323846 / 180.0);
constexpr int kTrefoilSamples = 48;

// shape ids (core/params.py)
enum {
  kBox, kSphere, kCylinder, kTorus, kCapsule, kHourglass, kEgg, kStar,
  kSuperellipsoid, kTrefoil, kShapes
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 add(V3 a, V3 b) {
  return {__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 sub(V3 a, V3 b) {
  return {__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y), __fsub_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 mul(V3 a, V3 b) {
  return {__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z)};
}
__device__ __forceinline__ V3 scale(V3 a, float s) {
  return {__fmul_rn(a.x, s), __fmul_rn(a.y, s), __fmul_rn(a.z, s)};
}
__device__ __forceinline__ V3 div(V3 a, float s) {
  return {__fdiv_rn(a.x, s), __fdiv_rn(a.y, s), __fdiv_rn(a.z, s)};
}
__device__ __forceinline__ V3 divv(V3 a, V3 b) {
  return {__fdiv_rn(a.x, b.x), __fdiv_rn(a.y, b.y), __fdiv_rn(a.z, b.z)};
}

// torch.maximum / torch.minimum: a NaN on either side wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp and torch.clamp_min with number bounds: a NaN passes through
__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// constraints._clip: minimum(maximum(x, lo), hi) of tensors
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return tmin(tmax(x, lo), hi);
}
// torch.sign: 0 for 0 and NaN
__device__ __forceinline__ float sgn(float v) {
  return static_cast<float>((0.f < v) - (v < 0.f));
}

// torch.sum over the last dim of a contiguous [..., 3] on the card: two
// lanes share a row (ATen's Reduce.cuh takes last_pow2(3) = 2 for the
// block's width), the first adds columns 0 and 2, then the second's column 1
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, c), b);
}
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return sum3(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y), __fmul_rn(a.z, b.z));
}
__device__ __forceinline__ float norm(V3 v) { return __fsqrt_rn(dot(v, v)); }
__device__ __forceinline__ float norm_xz(V3 v) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.z, v.z)));
}
// constraints._safe_unit
__device__ __forceinline__ V3 safe_unit(V3 v) {
  return div(v, clamp_min(norm(v), kTiny));
}

__device__ __forceinline__ V3 load3(const float* a, int stride, int i) {
  const float* r = a + static_cast<long long>(i) * stride;
  return {r[0], r[1], r[2]};
}
__device__ __forceinline__ void store3(float* a, int i, V3 v) {
  float* r = a + 3 * static_cast<long long>(i);
  r[0] = v.x;
  r[1] = v.y;
  r[2] = v.z;
}
__device__ __forceinline__ float load1(const float* a, int stride, int i) {
  return a[static_cast<long long>(i) * stride];
}

// --- the projectors: p in the container's frame -> (q, n, hit) -----------

struct Hit {
  V3 q, n;
  bool hit;
};

// constraints._xz_scale: the xz radius scaled down to r_max, y to y_c
__device__ __forceinline__ Hit xz_scale(V3 p, float y_c, float r_max) {
  const float lxz = norm_xz(p);
  const float s = lxz > r_max ? __fdiv_rn(r_max, clamp_min(lxz, kEps)) : 1.f;
  const V3 q = {__fmul_rn(p.x, s), y_c, __fmul_rn(p.z, s)};
  const V3 d = sub(p, q);
  const float dl = norm(d);
  return {q, div(d, clamp_min(dl, kTiny)), dl > kEps};
}

// the tube of radius r around the point b
__device__ __forceinline__ Hit tube(V3 p, V3 b, float r) {
  const V3 d = sub(p, b);
  const float dl = norm(d);
  const V3 n = div(d, clamp_min(dl, kEps));
  return {add(b, scale(n, r)), n, dl > r};
}

template <int kShape>
__device__ __forceinline__ Hit project(V3 p, V3 half, V3 aux,
                                       const float* trefoil) {
  if constexpr (kShape == kBox) {
    const V3 q = {clip(p.x, -half.x, half.x), clip(p.y, -half.y, half.y),
                  clip(p.z, -half.z, half.z)};
    const V3 d = sub(p, q);
    const float ax = fabsf(d.x), ay = fabsf(d.y), az = fabsf(d.z);
    // the most violated axis, the first maximum (a NaN counts as one), as
    // torch.argmax
    int axis = 0;
    float top = ax;
    if (ay > top || (ay != ay && top == top)) {
      axis = 1;
      top = ay;
    }
    if (az > top || (az != az && top == top)) axis = 2;
    const float s = sgn(axis == 0 ? d.x : axis == 1 ? d.y : d.z);
    const V3 n = {axis == 0 ? s : 0.f, axis == 1 ? s : 0.f,
                  axis == 2 ? s : 0.f};
    return {q, n, ax > 0.f || ay > 0.f || az > 0.f};
  } else if constexpr (kShape == kSphere) {
    const float r = half.x;
    const float d = norm(p);
    const V3 n = d > kEps ? div(p, clamp_min(d, kTiny)) : V3{0.f, 1.f, 0.f};
    return {scale(n, r), n, d > r};
  } else if constexpr (kShape == kCylinder) {
    return xz_scale(p, clip(p.y, -half.y, half.y), half.x);
  } else if constexpr (kShape == kTorus) {
    const float lxz = norm_xz(p);
    float rx = 1.f, rz = 0.f;
    if (lxz > kEps) {
      const float den = clamp_min(lxz, kTiny);
      rx = __fdiv_rn(p.x, den);
      rz = __fdiv_rn(p.z, den);
    }
    return tube(p, V3{__fmul_rn(rx, half.x), 0.f, __fmul_rn(rz, half.x)},
                half.y);
  } else if constexpr (kShape == kCapsule) {
    return tube(p, V3{0.f, clip(p.y, -half.y, half.y), 0.f}, half.x);
  } else if constexpr (kShape == kHourglass) {
    const float base_r = half.x, hh = clamp_min(half.y, 1e-6f);
    const float neck_r = tmin(half.z, base_r);
    const float y_c = clip(p.y, -hh, hh);
    const float r_max = __fadd_rn(
        neck_r,
        __fdiv_rn(__fmul_rn(__fsub_rn(base_r, neck_r), fabsf(y_c)), hh));
    return xz_scale(p, y_c, r_max);
  } else if constexpr (kShape == kEgg) {
    const float a = clamp_min(half.x, 1e-6f), b = clamp_min(half.y, 1e-6f);
    const V3 e = {a, b, a};
    const V3 u = divv(p, e);
    const float d = norm(u);
    const V3 q = mul(div(u, clamp_min(d, kTiny)), e);
    return {q, safe_unit(divv(q, mul(e, e))), d > 1.f};
  } else if constexpr (kShape == kStar) {
    const float R = half.x, hh = half.y;
    const float pts = clamp_min(aux.x, 3.f);
    const float depth = clampf(aux.y, 0.f, 0.9f);
    const float y_c = clip(p.y, -hh, hh);
    const float c = cosf(__fmul_rn(pts, atan2f(p.z, p.x)));
    const float r_max = __fmul_rn(
        R, __fsub_rn(1.f, __fmul_rn(depth, __fadd_rn(0.5f,
                                                       __fmul_rn(0.5f, c)))));
    return xz_scale(p, y_c, r_max);
  } else if constexpr (kShape == kSuperellipsoid) {
    const float a = clamp_min(half.x, 1e-6f), b = clamp_min(half.y, 1e-6f);
    const float ne = clampf(aux.z, 0.6f, 8.f);
    const V3 e = {a, b, a};
    const V3 u = divv(V3{fabsf(p.x), fabsf(p.y), fabsf(p.z)}, e);
    const float F = sum3(powf(clamp_min(u.x, kTiny), ne),
                         powf(clamp_min(u.y, kTiny), ne),
                         powf(clamp_min(u.z, kTiny), ne));
    // torch's -1.0 / n_exp is reciprocal(n_exp) * -1.0
    const float k = powf(clamp_min(F, kTiny), -__frcp_rn(ne));
    const V3 q = scale(p, k);
    const float em1 = __fsub_rn(ne, 1.f);
    const V3 g = {
        __fdiv_rn(__fmul_rn(sgn(p.x), powf(clamp_min(__fdiv_rn(fabsf(q.x), a),
                                                     1e-6f), em1)), a),
        __fdiv_rn(__fmul_rn(sgn(p.y), powf(clamp_min(__fdiv_rn(fabsf(q.y), b),
                                                     1e-6f), em1)), b),
        __fdiv_rn(__fmul_rn(sgn(p.z), powf(clamp_min(__fdiv_rn(fabsf(q.z), a),
                                                     1e-6f), em1)), a)};
    return {q, safe_unit(g), F > 1.f};
  } else {
    static_assert(kShape == kTrefoil, "ten shapes");
    // the nearest of the knot's samples, the first minimum (a NaN counts as
    // one), as torch.argmin; then the tube around it
    const float S = half.x;
    V3 best = {0.f, 0.f, 0.f};
    float best_d2 = 0.f;
    for (int j = 0; j < kTrefoilSamples; ++j) {
      const V3 c = scale(V3{trefoil[3 * j], trefoil[3 * j + 1],
                            trefoil[3 * j + 2]}, S);
      const V3 d = sub(p, c);
      const float d2 = dot(d, d);
      if (j == 0 || d2 < best_d2 || (d2 != d2 && best_d2 == best_d2)) {
        best = c;
        best_d2 = d2;
      }
    }
    return tube(p, best, half.y);
  }
}

// R = Rz Ry Rx of the XYZ Euler angles (core/params.rotation_matrix), row
// major; each product term by term as an sgemm adds, with FMAs
__device__ void rotation(const float* euler_deg, float* rot) {
  float c[3], s[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float rad = __fmul_rn(euler_deg[k], kDegToRad);
    c[k] = cosf(rad);
    s[k] = sinf(rad);
  }
  const float rx[9] = {1.f, 0.f, 0.f, 0.f, c[0], -s[0], 0.f, s[0], c[0]};
  const float ry[9] = {c[1], 0.f, s[1], 0.f, 1.f, 0.f, -s[1], 0.f, c[1]};
  const float rz[9] = {c[2], -s[2], 0.f, s[2], c[2], 0.f, 0.f, 0.f, 1.f};
  float m[9];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      m[3 * i + j] = __fmaf_rn(rz[3 * i + 2], ry[6 + j],
                               __fmaf_rn(rz[3 * i + 1], ry[3 + j],
                                         __fmul_rn(rz[3 * i], ry[j])));
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      rot[3 * i + j] = __fmaf_rn(m[3 * i + 2], rx[6 + j],
                                 __fmaf_rn(m[3 * i + 1], rx[3 + j],
                                           __fmul_rn(m[3 * i], rx[j])));
    }
  }
}

// v @ R (rows: R^T v), and v @ R^T (rows: R v)
__device__ __forceinline__ V3 times_rot(V3 v, const float* r) {
  return {__fmaf_rn(v.z, r[6], __fmaf_rn(v.y, r[3], __fmul_rn(v.x, r[0]))),
          __fmaf_rn(v.z, r[7], __fmaf_rn(v.y, r[4], __fmul_rn(v.x, r[1]))),
          __fmaf_rn(v.z, r[8], __fmaf_rn(v.y, r[5], __fmul_rn(v.x, r[2])))};
}
__device__ __forceinline__ V3 times_rot_t(V3 v, const float* r) {
  return {__fmaf_rn(v.z, r[2], __fmaf_rn(v.y, r[1], __fmul_rn(v.x, r[0]))),
          __fmaf_rn(v.z, r[5], __fmaf_rn(v.y, r[4], __fmul_rn(v.x, r[3]))),
          __fmaf_rn(v.z, r[8], __fmaf_rn(v.y, r[7], __fmul_rn(v.x, r[6])))};
}

// common.foam_update
__device__ __forceinline__ float foam_update(float foam, V3 vel, float rho,
                                             float rho0, float gen,
                                             float vel_ref) {
  const float aer = __fmul_rn(
      clampf(__fdiv_rn(__fsub_rn(rho0, rho), rho0), 0.f, 1.f),
      clampf(__fdiv_rn(norm(vel), clamp_min(vel_ref, 1e-3f)), 0.f, 1.f));
  return tmax(__fmul_rn(aer, gen), __fmul_rn(foam, kFoamDecay));
}

template <int kShape, bool kReassemble, bool kContain>
__global__ void __launch_bounds__(kBlock)
    container_kernel(SphContainerRows r, SphContainerParams p, int n,
                     int has_ghosts) {
  __shared__ float rot[9];
  if constexpr (kContain) {
    if (threadIdx.x == 0) rotation(p.euler_deg, rot);
    __syncthreads();
  }
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const int ghost = r.ghost[i], valid = r.valid[i];
  V3 pos, vel;
  if constexpr (kReassemble) {
    if constexpr (kContain) pos = load3(r.npos, r.npos_stride, i);
    vel = load3(r.nvel, r.nvel_stride, i);
    const float rho = load1(r.rho, r.rho_stride, i);
    const float foam = load1(r.foam, r.foam_stride, i);
    const float rho0 = *p.rest_density;
    r.out_foam[i] = valid > 0 && ghost == 0
                        ? foam_update(foam, vel, rho, rho0, *p.foam_gen,
                                      *p.foam_vel_ref)
                        : foam;
    if (has_ghosts) {
      V3 acc = load3(r.nacc, r.nacc_stride, i);
      float dens = rho, pres = load1(r.pres, r.pres_stride, i);
      if (ghost > 0) {
        const int face = min(max(r.face[i], 0), 5);
        if (valid > 0 && p.face_active[face] > 0) {
          dens = rho0;
          pres = 0.f;
          vel = acc = V3{0.f, 0.f, 0.f};
        } else {
          dens = load1(r.density, r.density_stride, i);
          pres = load1(r.pressure, r.pressure_stride, i);
          vel = load3(r.vel, r.vel_stride, i);
          acc = load3(r.acc, r.acc_stride, i);
        }
      }
      store3(r.out_acc, i, acc);
      r.out_density[i] = dens;
      r.out_pressure[i] = pres;
    }
  } else {
    pos = load3(r.pos, r.pos_stride, i);
    vel = load3(r.vel, r.vel_stride, i);
  }
  if constexpr (kContain) {
    if (ghost == 0 && valid > 0) {
      const V3 c = {p.center[0], p.center[1], p.center[2]};
      const V3 half = {p.half[0], p.half[1], p.half[2]};
      const V3 aux = {p.aux[0], p.aux[1], p.aux[2]};
      const Hit h = project<kShape>(times_rot(sub(pos, c), rot), half, aux,
                                    p.trefoil);
      if (h.hit) {
        const V3 nw = safe_unit(times_rot_t(h.n, rot));
        const V3 vn = scale(nw, dot(vel, nw));
        const V3 vt = sub(vel, vn);
        pos = add(c, times_rot_t(h.q, rot));
        vel = add(scale(vn, -*p.restitution),
                  scale(vt, __fsub_rn(1.f, *p.friction)));
      }
    }
    store3(r.out_pos, i, pos);
    store3(r.out_vel, i, vel);
  } else if (has_ghosts) {
    store3(r.out_vel, i, vel);
  }
}

template <int kShape, bool kReassemble>
void launch(const SphContainerRows& rows, const SphContainerParams& params,
            int n, int has_ghosts, cudaStream_t stream) {
  container_kernel<kShape, kReassemble, true>
      <<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(rows, params, n,
                                                         has_ghosts);
}

template <bool kReassemble>
void launch_shape(int shape, const SphContainerRows& rows,
                  const SphContainerParams& params, int n, int has_ghosts,
                  cudaStream_t s) {
  switch (shape) {
    case kBox:
      return launch<kBox, kReassemble>(rows, params, n, has_ghosts, s);
    case kSphere:
      return launch<kSphere, kReassemble>(rows, params, n, has_ghosts, s);
    case kCylinder:
      return launch<kCylinder, kReassemble>(rows, params, n, has_ghosts, s);
    case kTorus:
      return launch<kTorus, kReassemble>(rows, params, n, has_ghosts, s);
    case kCapsule:
      return launch<kCapsule, kReassemble>(rows, params, n, has_ghosts, s);
    case kHourglass:
      return launch<kHourglass, kReassemble>(rows, params, n, has_ghosts, s);
    case kEgg:
      return launch<kEgg, kReassemble>(rows, params, n, has_ghosts, s);
    case kStar:
      return launch<kStar, kReassemble>(rows, params, n, has_ghosts, s);
    case kSuperellipsoid:
      return launch<kSuperellipsoid, kReassemble>(rows, params, n,
                                                  has_ghosts, s);
    default:
      return launch<kTrefoil, kReassemble>(rows, params, n, has_ghosts, s);
  }
}

}  // namespace

extern "C" int sph_container(const SphContainerRows* rows,
                             const SphContainerParams* params, int n,
                             int shape_type, int reassemble, int contain,
                             int has_ghosts, void* stream) {
  if (!reassemble && !contain) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int shape = shape_type < 0 ? 0
                      : shape_type >= kShapes ? kShapes - 1 : shape_type;
    if (!contain) {
      container_kernel<kBox, true, false>
          <<<(n + kBlock - 1) / kBlock, kBlock, 0, s>>>(*rows, *params, n,
                                                        has_ghosts);
    } else if (reassemble) {
      launch_shape<true>(shape, *rows, *params, n, has_ghosts, s);
    } else {
      launch_shape<false>(shape, *rows, *params, n, has_ghosts, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
