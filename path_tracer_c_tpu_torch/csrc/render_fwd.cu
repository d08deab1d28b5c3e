// Forward render megakernel for Hopper (sm_90a): reference-tier path tracing.
//
// Replaces the Pallas TPU kernel `_kernel` of
// path_tracer_c_tpu/ops/pallas_kernels.py (with its device helpers
// `make_geometry`, `_pcg`, `_uniform`, `_unit_sphere` and
// ops/rng.py `sincos_2pi`). It computes the same function: for every pixel,
// spp samples of (max_bounces + 1) rounds of closest hit -> emission ->
// albedo -> roughness-perturbed normal -> reflect or refract, the sky on a
// miss and when the budget runs out, and the mean over samples.
//
// What bounds it on an H100: FP32 and SFU issue (every bounce scans the
// whole scene table, with a sqrt per sphere and a divide per triangle) and
// branch divergence (neighbouring pixels leave the scene at different
// bounces), not bytes: the only traffic to device memory is the scene
// tables, which stay in L1/L2, and 12 bytes of radiance per pixel.
//
// What the design does about that:
//  * one thread per pixel, 2-D blocks of 32 x 8, every per-ray quantity in
//    registers; no divisibility rule, the ragged edge is masked;
//  * the scene is read through const __restrict__ pointers (read-only
//    cache); moving it to shared or constant memory is later work;
//  * termination is zero throughput, as in the TPU kernel. A thread stops
//    its bounce loop once its throughput is exactly zero: every round it
//    skips would add only exact zeros. This per-thread exit takes the
//    place of the TPU kernel's whole-tile sky gate and bounce-0 hoist,
//    which are TPU scheduling choices;
//  * the half-b sphere quadratic, select-then-normalize sphere normals and
//    face normals precomputed by the wrapper, as in the TPU kernel.
//
// Numerics: the PCG stream (uint32), the uint32 -> float32 conversion
// (rounded once, then scaled by float32(1/(2^32-1)) == 2^-32) and the
// polynomial sincos_2pi (explicitly rounded operations) are bit-exact
// with the JAX package. The library is built with -fmad=false (see
// ops/build.py), and every expression below evaluates in the same order
// as the plain PyTorch twin in ops/render_kernel.py, with the same sqrtf,
// division and rsqrtf as PyTorch's CUDA kernels: on the card the kernel
// and the twin agree bit for bit. Against XLA on the CPU (whose rsqrt
// rounds differently) they agree to float32 rounding, and are compared
// statistically.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

__device__ __forceinline__ uint32_t pcg_step(uint32_t& state) {
  state = state * 747796405u + 2891336453u;
  uint32_t word = ((state >> ((state >> 28) + 4u)) ^ state) * 277803737u;
  return (word >> 22) ^ word;
}

__device__ __forceinline__ float uniform(uint32_t& state) {
  return __uint2float_rn(pcg_step(state)) * kInvU32Max;
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

__global__ void __launch_bounds__(256)
render_fwd_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                  int n_sph, const float* __restrict__ tri,
                  const int* __restrict__ tri_m, int n_tri,
                  const float* __restrict__ mat, int n_mat,
                  const float* __restrict__ par, float* __restrict__ out,
                  int height, int width, int spp, int max_bounces,
                  uint32_t seed, int sample_offset, int jitter, float inv_spp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  if (col >= width || row >= height) return;
  const Params p = *reinterpret_cast<const Params*>(par);

  const uint32_t pix = static_cast<uint32_t>(row * width + col);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = static_cast<float>(row);
  const float inf = __int_as_float(0x7f800000);

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const uint32_t sample = static_cast<uint32_t>(s + sample_offset);
    uint32_t st = pix * 0x9E3779B9u ^ sample * 0x85EBCA6Bu ^ seed * 0xC2B2AE35u;
    pcg_step(st);
    pcg_step(st);

    float ox = p.ox, oy = p.oy, oz = p.oz;
    float dx = pdx, dy = pdy, dz = pdz;
    if (jitter) {
      const float jx = uniform(st);
      const float jy = uniform(st);
      camera_dir(p, fcol + jx, frow + jy, fw, fh, dx, dy, dz);
    }
    float tr = 1.0f, tg = 1.0f, tb = 1.0f;
    float ar = 0.0f, ag = 0.0f, ab = 0.0f;

    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      // -- closest hit: spheres, then triangles; strict < keeps the first --
      const float dd = dx * dx + dy * dy + dz * dz;
      const float invdd = 1.0f / dd;
      float best = inf;
      float bcx = 0.0f, bcy = 0.0f, bcz = 0.0f;
      int m = 0;
      for (int i = 0; i < n_sph; ++i) {
        const float* sp = sph + i * kSphStride;
        const float cx = sp[0], cy = sp[1], cz = sp[2], r = sp[3];
        const float ocx = ox - cx, ocy = oy - cy, ocz = oz - cz;
        const float h = ocx * dx + ocy * dy + ocz * dz;
        const float cq = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
        const float det = h * h - dd * cq;
        const float sq = sqrtf(fmaxf(det, 0.0f));
        const float t1 = (-h - sq) * invdd;
        const float t2 = (-h + sq) * invdd;
        float t = t1 >= 0.0f ? t1 : (t2 >= 0.0f ? t2 : inf);
        if (!(det >= 0.0f && sp[4] > 0.0f)) t = inf;
        if (t < best) {
          best = t;
          bcx = cx;
          bcy = cy;
          bcz = cz;
          m = sph_m[i];
        }
      }
      // Sphere normal once, from the winning centre (select, then normalize).
      const float ts = best < inf ? best : 0.0f;
      float nx = ox + ts * dx - bcx;
      float ny = oy + ts * dy - bcy;
      float nz = oz + ts * dz - bcz;
      const float hn = rsqrtf(fmaxf(nx * nx + ny * ny + nz * nz, kNFloor));
      nx *= hn;
      ny *= hn;
      nz *= hn;

      for (int i = 0; i < n_tri; ++i) {
        const float* tp = tri + i * kTriStride;
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
        if (ok && t < best) {
          best = t;
          const float fnx = tp[9], fny = tp[10], fnz = tp[11];
          // Face normal flipped to oppose the ray.
          const float sgn = fnx * dx + fny * dy + fnz * dz < 0.0f ? 1.0f : -1.0f;
          nx = sgn * fnx;
          ny = sgn * fny;
          nz = sgn * fnz;
          m = tri_m[i];
        }
      }

      if (!(best < inf)) {
        // Miss: the sky, and the path ends (its throughput becomes zero).
        ar += tr * p.sky_r;
        ag += tg * p.sky_g;
        ab += tb * p.sky_b;
        tr = tg = tb = 0.0f;
        break;
      }

      // -- shade --
      const float px = ox + best * dx;
      const float py = oy + best * dy;
      const float pz = oz + best * dz;
      // A material index outside the table reads as black, ior 1.
      float alb_r = 0.0f, alb_g = 0.0f, alb_b = 0.0f;
      float em_r = 0.0f, em_g = 0.0f, em_b = 0.0f;
      float rgh = 0.0f, trn = 0.0f, ior = 1.0f;
      if (m >= 0 && m < n_mat) {
        const float* mp = mat + m * kMatStride;
        alb_r = mp[0];
        alb_g = mp[1];
        alb_b = mp[2];
        em_r = mp[3];
        em_g = mp[4];
        em_b = mp[5];
        rgh = mp[6];
        trn = mp[7];
        ior = mp[8];
      }
      // Emission, then albedo.
      ar += tr * em_r;
      ag += tg * em_g;
      ab += tb * em_b;
      tr *= alb_r;
      tg *= alb_g;
      tb *= alb_b;

      // 3 draws per bounce: unit sphere (2), then the branch uniform (1).
      const float u1 = uniform(st);
      const float u2 = uniform(st);
      const float u_branch = uniform(st);
      const float zs = 1.0f - 2.0f * u1;
      float cs, sn;
      sincos_2pi(u2, cs, sn);
      const float rs = sqrtf(fmaxf(1.0f - zs * zs, 0.0f));

      // Roughness-perturbed shading normal.
      float wnx = nx + rgh * (rs * cs);
      float wny = ny + rgh * (rs * sn);
      float wnz = nz + rgh * zs;
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
      const float eta = entering ? 1.0f / ior : ior;
      const float rnx = entering ? wnx : -wnx;
      const float rny = entering ? wny : -wny;
      const float rnz = entering ? wnz : -wnz;
      const float ni = rnx * dx + rny * dy + rnz * dz;
      const float k = 1.0f - eta * eta * (1.0f - ni * ni);
      const bool tir = k < 0.0f;
      const float coef = eta * ni + sqrtf(tir ? 1.0f : fmaxf(k, kKFloor));

      float ndx, ndy, ndz;
      if (u_branch < trn) {
        if (tir) {
          // Total internal reflection on the refracted branch: the path
          // dies and keeps its old direction.
          tr = tg = tb = 0.0f;
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
      ox = px + offs * side * nx;
      oy = py + offs * side * ny;
      oz = pz + offs * side * nz;
      dx = ndx;
      dy = ndy;
      dz = ndz;

      // Exact early exit: with zero throughput every later round adds 0.
      if (tr == 0.0f && tg == 0.0f && tb == 0.0f) break;
    }
    // Bounce budget exhausted: the sky (adds exact zeros for dead paths).
    ar += tr * p.sky_r;
    ag += tg * p.sky_g;
    ab += tb * p.sky_b;
    acc_r += ar;
    acc_g += ag;
    acc_b += ab;
  }
  float* o = out + 3 * static_cast<size_t>(pix);
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of contiguous
// float32/int32 tables and the kNumParams camera/sky floats, packed by
// ops/render_kernel.py; `out` is (height, width, 3) float32. Launches on
// `stream` of device `device` and returns cudaGetLastError().
extern "C" int render_fwd(const float* sph, const int* sph_m, int n_sph,
                          const float* tri, const int* tri_m, int n_tri,
                          const float* mat, int n_mat, const float* par,
                          float* out, int height, int width, int spp,
                          int max_bounces, unsigned int seed, int sample_offset,
                          int jitter, int device, void* stream) {
  static_assert(sizeof(Params) == kNumParams * sizeof(float), "Params layout");
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float32(1.0 / spp), rounded from double as the JAX package does.
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  render_fwd_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, height, width,
      spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
