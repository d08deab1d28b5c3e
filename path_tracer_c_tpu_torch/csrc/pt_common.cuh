// Device functions shared by all the kernels (the reference tier's
// render_fwd.cu and render_fused.cu, and through pt_phys.cuh the physical
// tier's): constants, the PCG stream, the camera, closest hit, the
// distance-only scene query, the material fetch and one bounce of the
// reference tier's shading.
//
// They replace the device helpers of path_tracer_c_tpu/ops/pallas_kernels.py
// (`make_geometry`, `_pcg`, `_uniform`, `_unit_sphere`) and ops/rng.py
// `sincos_2pi`. There is one definition of each, so the fused kernel's
// primal is the forward kernel's by construction.
//
// Numerics: the PCG stream (uint32), the uint32 -> float32 conversion
// (rounded once, then scaled by float32(1/(2^32-1)) == 2^-32) and the
// polynomial sincos_2pi (explicitly rounded operations) are bit-exact
// with the JAX package. The library is built with -fmad=false (see
// ops/build.py), and every expression below evaluates in the same order
// as the plain PyTorch twins in ops/render_kernel.py, with the same sqrtf,
// division and rsqrtf as PyTorch's CUDA kernels: on the card the kernels
// and their twins agree bit for bit. Against XLA on the CPU (whose rsqrt
// rounds differently) they agree to float32 rounding, and are compared
// statistically.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptc {

// Constants as the exact float32 values the JAX package uses.
constexpr float kInvU32Max = 0x1p-32f;          // float32(1 / 4294967295)
constexpr float kTwoPi = 0x1.921fb6p+2f;        // float32(2 pi)
constexpr float kHalfPi = 0x1.921fb6p+0f;       // float32(pi / 2)
constexpr float kCosC1 = -0x1.ffffc8p-2f;
constexpr float kCosC2 = 0x1.554260p-5f;
constexpr float kCosC3 = -0x1.64eed6p-10f;
constexpr float kSinC1 = -0x1.555544p-3f;
constexpr float kSinC2 = 0x1.1106ecp-7f;
constexpr float kSinC3 = -0x1.993bd2p-13f;
constexpr float kTriEps = 0x1.0c6f7ap-20f;      // float32(1e-6)
constexpr float kRatioFloor = 0x1.0c6f7ap-20f;  // float32(1e-6)
constexpr float kEpsOffset = 0x1.a36e2ep-14f;   // float32(1e-4)
constexpr float kEpsScale = 0x1.0c6f7ap-18f;    // float32(4e-6)
constexpr float kKFloor = 0x1.197998p-40f;      // float32(1e-12)
constexpr float kNFloor = 0x1.79ca10p-67f;      // float32(1e-20)

// Table row widths; the wrapper (ops/render_kernel.py) packs these.
constexpr int kSphStride = 5;   // cx, cy, cz, r, active
constexpr int kTriStride = 13;  // v0, v1, v2, unit face normal, active
constexpr int kMatStride = 9;   // albedo rgb, emission rgb (x strength), rough, transp, ior

struct Params {
  float tan2, aspect;
  float sky_r, sky_g, sky_b;
  float ox, oy, oz;  // camera origin
  float rx, ry, rz;  // right
  float ux, uy, uz;  // up
  float fx, fy, fz;  // forward
};
constexpr int kNumParams = 17;

// A pixel of a row block: a launch covers `rows` rows of the image from its
// global row `row_start` (the unit of image sharding, parallel/render.py).
// The pixel's global row keys its PCG stream (`pix`) and its camera ray
// (`frow`); its row in the block indexes the outputs (`local`), so a block's
// image, planes and counters are the same rows of the whole launch's.
struct RowBlock {
  uint32_t pix;  // global row-major pixel index
  size_t local;  // row-major pixel index in the block
  float frow;    // global row
  __device__ __forceinline__ RowBlock(int row, int col, int row_start, int width)
      : pix(static_cast<uint32_t>((row_start + row) * width + col)),
        local(static_cast<size_t>(row) * static_cast<size_t>(width) + col),
        frow(static_cast<float>(row_start + row)) {}
};
static_assert(sizeof(Params) == kNumParams * sizeof(float), "Params layout");

// The scene tables, as device pointers. No kernel writes them. They are
// read with plain loads: explicit __ldg loads made the forward kernel 3%
// slower on an H100 (PERF.md).
struct Tables {
  const float* sph;
  const int* sph_m;
  int n_sph;
  const float* tri;
  const int* tri_m;
  int n_tri;
  const float* mat;
  int n_mat;
};

// One path: ray, throughput, radiance so far, PCG state.
struct Path {
  float ox, oy, oz;
  float dx, dy, dz;
  float tr, tg, tb;
  float ar, ag, ab;
  uint32_t st;
};

// Closest hit: distance (+inf on a miss), geometric normal, material index,
// and whether a sphere won (read by the physical tier only).
struct Hit {
  float t;
  float nx, ny, nz;
  int m;
  bool sphere;
};

struct Material {
  float alb_r, alb_g, alb_b;
  float em_r, em_g, em_b;  // emission colour x strength
  float rgh, trn, ior;
};

// What shade() decided, as bits.
constexpr int kRefracted = 1;  // the refracted branch was chosen
constexpr int kDied = 2;       // ... and met total internal reflection

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t pcg_step(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float uniform(uint32_t& state) {
  return __uint2float_rn(pcg_step(state)) * kInvU32Max;
}

// PCG state of (global pixel, global sample, seed): a splitmix-style mix,
// then two PCG rounds.
__device__ __forceinline__ uint32_t seed_state(uint32_t pix, uint32_t sample,
                                               uint32_t seed) {
  uint32_t st = pix * 0x9E3779B9u ^ sample * 0x85EBCA6Bu ^ seed * 0xC2B2AE35u;
  pcg_step(st);
  pcg_step(st);
  return st;
}

// The shared trig spec, operation by operation in round-to-nearest float32
// (no FMA), so it is bit-exact with ops/rng.sincos_2pi.
__device__ __forceinline__ void sincos_2pi(float u, float& c, float& s) {
  float k = floorf(__fadd_rn(__fmul_rn(u, 4.0f), 0.5f));
  float r = __fsub_rn(__fmul_rn(u, kTwoPi), __fmul_rn(k, kHalfPi));
  float t2 = __fmul_rn(r, r);
  float cosr = __fadd_rn(1.0f, __fmul_rn(t2, __fadd_rn(kCosC1,
      __fmul_rn(t2, __fadd_rn(kCosC2, __fmul_rn(t2, kCosC3))))));
  float sinr = __fmul_rn(r, __fadd_rn(1.0f, __fmul_rn(t2, __fadd_rn(kSinC1,
      __fmul_rn(t2, __fadd_rn(kSinC2, __fmul_rn(t2, kSinC3)))))));
  float k4 = __fsub_rn(k, __fmul_rn(4.0f, floorf(__fmul_rn(k, 0.25f))));
  bool swap = (k4 == 1.0f) | (k4 == 3.0f);
  float a = swap ? sinr : cosr;
  float b = swap ? cosr : sinr;
  c = ((k4 == 1.0f) | (k4 == 2.0f)) ? -a : a;
  s = ((k4 == 2.0f) | (k4 == 3.0f)) ? -b : b;
}

// Unit camera direction through image point (px, py), in pixel units.
__device__ __forceinline__ void camera_dir(const Params& p, float px, float py,
                                           float fw, float fh, float& dx,
                                           float& dy, float& dz) {
  float x = px / fw * 2.0f - 1.0f;
  float y = -(py / fh * 2.0f - 1.0f);
  float cx = x * p.tan2;
  float cy = y * p.tan2 / p.aspect;
  dx = cx * p.rx + cy * p.ux + p.fx;
  dy = cx * p.ry + cy * p.uy + p.fy;
  dz = cx * p.rz + cy * p.uz + p.fz;
  float n = rsqrtf(dx * dx + dy * dy + dz * dz);
  dx *= n;
  dy *= n;
  dz *= n;
}

// Start sample `s` of pixel (col, row): seed its stream, aim its primary
// ray (through the pixel centre, direction (pdx, pdy, pdz), or jittered
// with the stream's first two draws), unit throughput, no radiance.
__device__ __forceinline__ Path start_path(const Params& p, uint32_t pix,
                                           float fcol, float frow, float fw,
                                           float fh, float pdx, float pdy,
                                           float pdz, uint32_t sample,
                                           uint32_t seed, int jitter) {
  Path q;
  q.st = seed_state(pix, sample, seed);
  q.ox = p.ox;
  q.oy = p.oy;
  q.oz = p.oz;
  q.dx = pdx;
  q.dy = pdy;
  q.dz = pdz;
  if (jitter) {
    const float jx = uniform(q.st);
    const float jy = uniform(q.st);
    camera_dir(p, fcol + jx, frow + jy, fw, fh, q.dx, q.dy, q.dz);
  }
  q.tr = q.tg = q.tb = 1.0f;
  q.ar = q.ag = q.ab = 0.0f;
  return q;
}

// Distance along the ray to sphere row `sp`, +inf where it misses: the
// half-b quadratic. `dd` is d.d and `invdd` its reciprocal. One definition
// for the closest-hit scan and the distance-only scan.
__device__ __forceinline__ float sphere_t(const float* sp, float ox, float oy,
                                          float oz, float dx, float dy, float dz,
                                          float dd, float invdd) {
  const float inf = pos_inf();
  const float r = sp[3];
  const float ocx = ox - sp[0], ocy = oy - sp[1], ocz = oz - sp[2];
  const float h = ocx * dx + ocy * dy + ocz * dz;
  const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  const float det = h * h - dd * cq;
  const float sq = sqrtf(fmaxf(det, 0.0f));
  const float t1 = (-h - sq) * invdd;
  const float t2 = (-h + sq) * invdd;
  float t = t1 >= 0.0f ? t1 : (t2 >= 0.0f ? t2 : inf);
  if (!(det >= 0.0f && sp[4] > 0.0f)) t = inf;
  return t;
}

// Distance along the ray to triangle row `tp`, +inf where it misses:
// Moller-Trumbore.
__device__ __forceinline__ float triangle_t(const float* tp, float ox, float oy,
                                            float oz, float dx, float dy,
                                            float dz) {
  const float v0x = tp[0], v0y = tp[1], v0z = tp[2];
  const float e1x = tp[3] - v0x, e1y = tp[4] - v0y, e1z = tp[5] - v0z;
  const float e2x = tp[6] - v0x, e2y = tp[7] - v0y, e2z = tp[8] - v0z;
  const float rcx = dy * e2z - dz * e2y;
  const float rcy = dz * e2x - dx * e2z;
  const float rcz = dx * e2y - dy * e2x;
  const float det = e1x * rcx + e1y * rcy + e1z * rcz;
  const bool nonpar = fabsf(det) >= kTriEps;
  const float inv = 1.0f / (nonpar ? det : 1.0f);
  const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
  const float u = inv * (sx * rcx + sy * rcy + sz * rcz);
  const float scx = sy * e1z - sz * e1y;
  const float scy = sz * e1x - sx * e1z;
  const float scz = sx * e1y - sy * e1x;
  const float v = inv * (dx * scx + dy * scy + dz * scz);
  const float t = inv * (e2x * scx + e2y * scy + e2z * scz);
  const bool ok = nonpar && u >= kTriEps && u <= 1.0f && v >= kTriEps &&
                  u + v <= 1.0f && t >= kTriEps && tp[12] > 0.0f;
  return ok ? t : pos_inf();
}

// Closest hit: spheres, then triangles; strict < keeps the first.
__device__ __forceinline__ Hit closest_hit(const Tables& sc, const Path& q) {
  const float inf = pos_inf();
  const float ox = q.ox, oy = q.oy, oz = q.oz;
  const float dx = q.dx, dy = q.dy, dz = q.dz;
  const float dd = dx * dx + dy * dy + dz * dz;
  const float invdd = 1.0f / dd;
  float best = inf;
  float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
  int m = 0;
  for (int i = 0; i < sc.n_sph; ++i) {
    const float* sp = sc.sph + i * kSphStride;
    const float t = sphere_t(sp, ox, oy, oz, dx, dy, dz, dd, invdd);
    if (t < best) {
      best = t;
      bcx = sp[0];
      bcy = sp[1];
      bcz = sp[2];
      m = sc.sph_m[i];
    }
  }
  const bool sphere = best < inf;
  // Sphere normal once, from the winning centre (select, then normalize).
  const float ts = sphere ? best : 0.0f;
  float nx = ox + ts * dx - bcx;
  float ny = oy + ts * dy - bcy;
  float nz = oz + ts * dz - bcz;
  const float hn = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kNFloor));
  nx *= hn;
  ny *= hn;
  nz *= hn;

  Hit h;
  h.sphere = sphere;
  for (int i = 0; i < sc.n_tri; ++i) {
    const float* tp = sc.tri + i * kTriStride;
    const float t = triangle_t(tp, ox, oy, oz, dx, dy, dz);
    if (t < best) {
      best = t;
      const float fnx = tp[9], fny = tp[10], fnz = tp[11];
      // Face normal flipped to oppose the ray.
      const float sgn = fnx * dx + fny * dy + fnz * dz < 0.0f ? 1.0f : -1.0f;
      nx = sgn * fnx;
      ny = sgn * fny;
      nz = sgn * fnz;
      m = sc.tri_m[i];
      h.sphere = false;
    }
  }
  h.t = best;
  h.nx = nx;
  h.ny = ny;
  h.nz = nz;
  h.m = m;
  return h;
}

// Distance to the closest object along a ray, +inf on a miss: the shadow
// query, with the per-object tests of closest_hit and no normals.
__device__ __forceinline__ float closest_t(const Tables& sc, float ox, float oy,
                                           float oz, float dx, float dy,
                                           float dz) {
  const float dd = dx * dx + dy * dy + dz * dz;
  const float invdd = 1.0f / dd;
  float best = pos_inf();
  for (int i = 0; i < sc.n_sph; ++i)
    best = fminf(best, sphere_t(sc.sph + i * kSphStride, ox, oy, oz, dx, dy, dz,
                                dd, invdd));
  for (int i = 0; i < sc.n_tri; ++i)
    best = fminf(best, triangle_t(sc.tri + i * kTriStride, ox, oy, oz, dx, dy, dz));
  return best;
}

// Material row `m`; an index outside the table reads as black, ior 1.
__device__ __forceinline__ Material fetch_material(const Tables& sc, int m) {
  Material mt;
  mt.alb_r = mt.alb_g = mt.alb_b = 0.0f;
  mt.em_r = mt.em_g = mt.em_b = 0.0f;
  mt.rgh = 0.0f;
  mt.trn = 0.0f;
  mt.ior = 1.0f;
  if (m >= 0 && m < sc.n_mat) {
    const float* mp = sc.mat + m * kMatStride;
    mt.alb_r = mp[0];
    mt.alb_g = mp[1];
    mt.alb_b = mp[2];
    mt.em_r = mp[3];
    mt.em_g = mp[4];
    mt.em_b = mp[5];
    mt.rgh = mp[6];
    mt.trn = mp[7];
    mt.ior = mp[8];
  }
  return mt;
}

// A miss: the sky, and the path ends (its throughput becomes zero).
__device__ __forceinline__ void shade_miss(const Params& p, Path& q) {
  q.ar += q.tr * p.sky_r;
  q.ag += q.tg * p.sky_g;
  q.ab += q.tb * p.sky_b;
  q.tr = q.tg = q.tb = 0.0f;
}

// Bounce budget exhausted: the sky (adds exact zeros for dead paths).
__device__ __forceinline__ void shade_end(const Params& p, Path& q) {
  q.ar += q.tr * p.sky_r;
  q.ag += q.tg * p.sky_g;
  q.ab += q.tb * p.sky_b;
}

// One bounce at hit `h` (h.t finite) on material `mt`: emission, albedo,
// the 3 draws, the perturbed normal, reflect or refract, the next ray.
// Returns kRefracted / kDied bits. A path that dies (total internal
// reflection on the refracted branch) gets zero throughput and keeps its
// direction.
__device__ __forceinline__ int shade(const Hit& h, const Material& mt, Path& q) {
  const float dx = q.dx, dy = q.dy, dz = q.dz;
  const float nx = h.nx, ny = h.ny, nz = h.nz;
  const float px = q.ox + h.t * dx;
  const float py = q.oy + h.t * dy;
  const float pz = q.oz + h.t * dz;
  // Emission, then albedo.
  q.ar += q.tr * mt.em_r;
  q.ag += q.tg * mt.em_g;
  q.ab += q.tb * mt.em_b;
  q.tr *= mt.alb_r;
  q.tg *= mt.alb_g;
  q.tb *= mt.alb_b;

  // 3 draws per bounce: unit sphere (2), then the branch uniform (1).
  const float u1 = uniform(q.st);
  const float u2 = uniform(q.st);
  const float u_branch = uniform(q.st);
  const float zs = 1.0f - 2.0f * u1;
  float cs, sn;
  sincos_2pi(u2, cs, sn);
  const float rs = sqrtf(fmaxf(1.0f - zs * zs, 0.0f));

  // Roughness-perturbed shading normal.
  float wnx = nx + mt.rgh * (rs * cs);
  float wny = ny + mt.rgh * (rs * sn);
  float wnz = nz + mt.rgh * zs;
  const float wn = rsqrtf(fmaxf(wnx * wnx + wny * wny + wnz * wnz, kNFloor));
  wnx *= wn;
  wny *= wn;
  wnz *= wn;

  const float ndot = dx * wnx + dy * wny + dz * wnz;
  const float rfx = dx - 2.0f * ndot * wnx;
  const float rfy = dy - 2.0f * ndot * wny;
  const float rfz = dz - 2.0f * ndot * wnz;
  // Refraction with the entering/exiting flip of eta and the normal.
  const bool entering = ndot < 0.0f;
  const float eta = entering ? 1.0f / mt.ior : mt.ior;
  const float rnx = entering ? wnx : -wnx;
  const float rny = entering ? wny : -wny;
  const float rnz = entering ? wnz : -wnz;
  const float ni = rnx * dx + rny * dy + rnz * dz;
  const float k = 1.0f - eta * eta * (1.0f - ni * ni);
  const bool tir = k < 0.0f;
  const float coef = eta * ni + sqrtf(tir ? 1.0f : fmaxf(k, kKFloor));

  int event = 0;
  float ndx, ndy, ndz;
  if (u_branch < mt.trn) {
    event = kRefracted;
    if (tir) {
      event |= kDied;
      q.tr = q.tg = q.tb = 0.0f;
      ndx = dx;
      ndy = dy;
      ndz = dz;
    } else {
      ndx = eta * dx - coef * rnx;
      ndy = eta * dy - coef * rny;
      ndz = eta * dz - coef * rnz;
    }
  } else {
    ndx = rfx;
    ndy = rfy;
    ndz = rfz;
  }

  // Step off the surface along the geometric normal, towards the side
  // the new ray leaves on, by an amount that grows with |p|.
  const float offs = kEpsOffset + kEpsScale * sqrtf(px * px + py * py + pz * pz);
  const float side = ndx * nx + ndy * ny + ndz * nz >= 0.0f ? 1.0f : -1.0f;
  q.ox = px + offs * side * nx;
  q.oy = py + offs * side * ny;
  q.oz = pz + offs * side * nz;
  q.dx = ndx;
  q.dy = ndy;
  q.dz = ndz;
  return event;
}

// The thread's lane in its warp, as the hardware numbers it: whatever the
// launch shape (pt_sched.cuh Tile), the lane that __ballot_sync, __shfl_sync
// and __match_any_sync mean.
__device__ __forceinline__ int lane_id() {
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  return static_cast<int>(lane);
}

// Sum `value` over the block (launched at tile Tl, pt_sched.cuh) and add it
// to *counter: a warp reduction, then one atomicAdd a block. Every thread of
// the block must call it. Only the counting instantiations of the kernels
// call it.
template <class Tl>
__device__ __forceinline__ void block_add(int value, unsigned long long* counter) {
  static_assert(Tl::kWarps <= 32, "a block of at most 1024 threads");
  __shared__ int warp_sums[32];
  const int tid = Tl::tid();
  const int sum = __reduce_add_sync(0xffffffffu, value);
  if ((tid & 31) == 0) warp_sums[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    unsigned long long total = 0;
    for (int i = 0; i < Tl::kWarps; ++i) total += static_cast<unsigned long long>(warp_sums[i]);
    atomicAdd(counter, total);
  }
  __syncthreads();  // warp_sums is free again: a kernel may add several counts
}

}  // namespace ptc
