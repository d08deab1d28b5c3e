// Physical-tier forward megakernel for Hopper (sm_90a): importance-sampled
// BRDF and next-event estimation.
//
// Replaces the Pallas TPU kernel `_phys_kernel` of
// path_tracer_c_tpu/ops/pallas_physical.py (its body is
// `make_physical_shading` and `_camera_setup` there). It computes the same
// function: for every pixel, spp samples of (max_bounces + 1) rounds of
// closest hit -> Le (single-counted) -> 7 draws -> refract, mirror or
// cosine-weighted diffuse -> at a diffuse vertex one emitter sample (a
// sphere by its cone of directions; with tri_nee also a triangle by area)
// and one distance-only shadow query -> albedo; the sky on a miss and when
// the budget runs out; the mean over samples. The estimator's eager spec
// is models/physical.py, the plain twin ops/render_physical.py.
//
// What bounds it on an H100: FP32 and SFU issue and divergence, as for the
// reference tier's kernel (render_fwd.cu), with up to two scans of the
// scene table a round in place of one. Bytes do not: the scene and emitter
// tables stay in L1/L2 and a pixel writes 12 bytes.
//
// What the design does about that:
//  * one thread per pixel, 32 x 8 blocks, every per-ray quantity in
//    registers, the ragged edge masked; closest hit, the PCG stream and
//    sincos_2pi are the reference tier's (pt_common.cuh);
//  * a thread runs the light sample only where it can count: at a diffuse
//    vertex with a non-empty pool, and the shadow scan only where the
//    sample faces the surface and the emitter. The TPU kernel computes
//    every lane and masks; the values are the same;
//  * the emitter pick is one indexed read of a list the wrapper builds
//    (entry k: row of the k-th emitter), where the TPU kernel counts over
//    the whole table every bounce;
//  * a thread stops at a miss and at exactly zero throughput: every round
//    it skips would add exact zeros. The TPU kernel's whole-tile sky gate
//    and early-exit menu are TPU scheduling choices and have no
//    counterpart;
//  * tri_nee is a template parameter, so the default kernel carries no
//    triangle-emitter code; next-event estimation on or off is a uniform
//    run-time branch.
//
// Numerics: see pt_common.cuh. The distance to the sampled emitter is the
// full-b quadratic of ops/intersect.ray_sphere_t, not the scans' half-b
// form: the visibility test compares it with the scan's distance and sits
// on a knife edge for rays at the cone's rim.

#include "pt_common.cuh"

namespace {

using namespace ptc;

constexpr float kInvPi = 0x1.45f306p-2f;      // float32(1 / pi)
constexpr float kSin2Cap = 0x1.fffffcp-1f;    // float32(1 - 1e-7)
constexpr float kVisScale = 0x1.ff7ceep-1f;   // float32(1 - 1e-3)
constexpr float kVisSlack = 0x1.a36e2ep-14f;  // float32(1e-4)
constexpr float kD2Floor = 0x1.197998p-40f;   // float32(1e-12)
constexpr float kPdfFloor = 0x1.5798eep-27f;  // float32(1e-8)
constexpr float kDetFloor = 0x1.4484c0p-100f; // float32(1e-30)
constexpr float kCosLMin = 0x1.0c6f7ap-20f;   // float32(1e-6)

// The emitter tables, packed by ops/render_physical.py.
struct Emitters {
  const int* em_list;     // (n_sph) row of the k-th emissive sphere
  const float* le_sph;    // (n_sph, 3) premultiplied radiance per sphere
  const int* tri_list;    // (n_tri) row of the k-th emissive triangle
  const float* le_tri;    // (n_tri, 3)
  const float* tri_area;  // (n_tri)
  const float* mat_est;   // (n_mat) raw emission strength
  int n_em, n_em_t;       // live emitters: spheres, triangles
};

// What the counting instantiation counts per thread, in this order (the
// layout of the wrapper's counter tensor): bounce rounds run, diffuse
// vertices among them, light samples computed, shadow scans run.
constexpr int kEvRounds = 0, kEvDiffuse = 1, kEvLight = 2, kEvShadow = 3;
constexpr int kNumEvents = 4;

// Branchless orthonormal basis around unit n (Duff et al. 2017).
__device__ __forceinline__ void onb(float nx, float ny, float nz, float& tx,
                                    float& ty, float& tz, float& bx, float& by,
                                    float& bz) {
  const float sign = nz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + nz);
  const float b = nx * ny * a;
  tx = 1.0f + sign * nx * nx * a;
  ty = sign * b;
  tz = -sign * nx;
  bx = b;
  by = sign + ny * ny * a;
  bz = -ny;
}

// One light sample from surface point `so` (already offset along the
// normal n): adds thr * albedo/pi * Le * w to the path's radiance where the
// sample is valid and unoccluded. Called at diffuse vertices only, with
// the throughput before the albedo.
template <bool kCount, bool kTriNee>
__device__ __forceinline__ void light_sample(const Tables& sc, const Emitters& em,
                                             const Material& mt, float nx,
                                             float ny, float nz, float sox,
                                             float soy, float soz, float u_pick,
                                             float v1, float v2, Path& q, int* ev) {
  const int pool = kTriNee ? em.n_em + em.n_em_t : em.n_em;
  if (pool <= 0) return;
  if (kCount) ++ev[kEvLight];
  const float pool_f = static_cast<float>(pool);
  const int kf = static_cast<int>(floorf(u_pick * pool_f));
  const int kk = min(max(kf, 0), pool - 1);

  float omx, omy, omz, cos_surf, t_e, w, ler, leg, leb;
  bool branch_ok;
  if (kTriNee && kk >= em.n_em && em.n_em_t > 0) {
    // A triangle, uniformly by area from the same two draws; the area pdf
    // becomes a solid-angle pdf, emission is two-sided.
    const int kt = min(max(kk - em.n_em, 0), em.n_em_t - 1);
    const int ti = em.tri_list[kt];
    const float* tp = sc.tri + ti * kTriStride;
    const float su = sqrtf(v1);
    const float b1 = su * (1.0f - v2);
    const float b2 = su * v2;
    const float b0 = 1.0f - su;
    const float dqx = b0 * tp[0] + b1 * tp[3] + b2 * tp[6] - sox;
    const float dqy = b0 * tp[1] + b1 * tp[4] + b2 * tp[7] - soy;
    const float dqz = b0 * tp[2] + b1 * tp[5] + b2 * tp[8] - soz;
    const float d2t = dqx * dqx + dqy * dqy + dqz * dqz;
    const float dist_t = sqrtf(fmaxf(d2t, kD2Floor));
    omx = dqx / dist_t;
    omy = dqy / dist_t;
    omz = dqz / dist_t;
    const float cos_l = fabsf(tp[9] * omx + tp[10] * omy + tp[11] * omz);
    const float w_geom = em.tri_area[ti] * cos_l / fmaxf(d2t, kD2Floor);
    cos_surf = nx * omx + ny * omy + nz * omz;
    t_e = dist_t;
    ler = em.le_tri[3 * ti];
    leg = em.le_tri[3 * ti + 1];
    leb = em.le_tri[3 * ti + 2];
    branch_ok = cos_l > kCosLMin;
    w = cos_surf * w_geom;
  } else {
    // A sphere, by the cone of directions it subtends.
    const int ei = kk < sc.n_sph ? em.em_list[kk] : sc.n_sph - 1;
    const float* sp = sc.sph + ei * kSphStride;
    const float cex = sp[0], cey = sp[1], cez = sp[2], rer = sp[3];
    const float dcx = cex - sox, dcy = cey - soy, dcz = cez - soz;
    const float d2 = dcx * dcx + dcy * dcy + dcz * dcz;
    const float dist = sqrtf(fmaxf(d2, kD2Floor));
    const float wzx = dcx / dist, wzy = dcy / dist, wzz = dcz / dist;
    const float sin2max = fminf(fmaxf(rer * rer / fmaxf(d2, kD2Floor), 0.0f), kSin2Cap);
    const float cosmax = sqrtf(1.0f - sin2max);
    branch_ok = d2 > rer * rer;  // outside the emitter
    const float cth = 1.0f - v1 * (1.0f - cosmax);
    const float sth = sqrtf(fmaxf(1.0f - cth * cth, kD2Floor));
    float cp, sn;
    sincos_2pi(v2, cp, sn);
    float tax, tay, taz, bax, bay, baz;
    onb(wzx, wzy, wzz, tax, tay, taz, bax, bay, baz);
    const float cphi = sth * cp;
    const float sphi = sth * sn;
    omx = cphi * tax + sphi * bax + cth * wzx;
    omy = cphi * tay + sphi * bay + cth * wzy;
    omz = cphi * taz + sphi * baz + cth * wzz;
    const float pdf_omega = 1.0f / fmaxf(kTwoPi * (1.0f - cosmax), kPdfFloor);
    cos_surf = nx * omx + ny * omy + nz * omz;
    // Distance to the sampled sphere: the full-b quadratic.
    const float odd = omx * omx + omy * omy + omz * omz;
    const float ocx = sox - cex, ocy = soy - cey, ocz = soz - cez;
    const float be = 2.0f * (ocx * omx + ocy * omy + ocz * omz);
    const float cqe = ocx * ocx + ocy * ocy + ocz * ocz - rer * rer;
    const float dete = be * be - 4.0f * odd * cqe;
    const bool vale = dete >= 0.0f;
    const float sqe = sqrtf(vale ? fmaxf(dete, kDetFloor) : 1.0f);
    const float oinv2 = 0.5f / odd;
    const float te1 = (-be - sqe) * oinv2;
    const float te2 = (-be + sqe) * oinv2;
    t_e = te1 >= 0.0f ? te1 : (te2 >= 0.0f ? te2 : pos_inf());
    if (!vale) t_e = pos_inf();
    ler = em.le_sph[3 * ei];
    leg = em.le_sph[3 * ei + 1];
    leb = em.le_sph[3 * ei + 2];
    w = cos_surf / pdf_omega;
  }
  if (!(branch_ok && cos_surf > 0.0f && t_e < pos_inf())) return;
  // Unoccluded: the closest thing along the shadow ray is the emitter.
  if (kCount) ++ev[kEvShadow];
  const float s_bt = closest_t(sc, sox, soy, soz, omx, omy, omz);
  if (!(s_bt < pos_inf() && s_bt >= t_e * kVisScale - kVisSlack)) return;
  w = w * pool_f;
  q.ar += q.tr * mt.alb_r * kInvPi * ler * w;
  q.ag += q.tg * mt.alb_g * kInvPi * leg * w;
  q.ab += q.tb * mt.alb_b * kInvPi * leb * w;
}

// One bounce at hit `h` (h.t finite) on material `mt` with raw emission
// strength `est`. `prevd` says whether the path arrived by a diffuse
// sample; it is updated for paths that go on. A path that dies (total
// internal reflection on the refracted branch) gets zero throughput and
// keeps its direction.
template <bool kCount, bool kTriNee>
__device__ __forceinline__ void shade_phys(const Tables& sc, const Emitters& em,
                                           const Hit& h, const Material& mt,
                                           float est, bool nee, Path& q,
                                           bool& prevd, int* ev) {
  const float dx = q.dx, dy = q.dy, dz = q.dz;
  const float nx = h.nx, ny = h.ny, nz = h.nz;

  // Le, skipped where a diffuse-sampled ray arrives at an emitter that the
  // previous vertex could have light-sampled (single counting).
  bool counted = false;
  if (nee) {
    counted = prevd && h.sphere && est > 0.0f && em.n_em > 0;
    if (kTriNee) counted = counted || (prevd && !h.sphere && est > 0.0f && em.n_em_t > 0);
  }
  if (!counted) {
    q.ar += q.tr * mt.em_r;
    q.ag += q.tg * mt.em_g;
    q.ab += q.tb * mt.em_b;
  }

  // 7 draws per bounce, by every path.
  const float u_transp = uniform(q.st);
  const float u_lobe = uniform(q.st);
  const float u1 = uniform(q.st);
  const float u2 = uniform(q.st);
  const float u_pick = uniform(q.st);
  const float v1 = uniform(q.st);
  const float v2 = uniform(q.st);

  const bool choose_refr = u_transp < mt.trn;
  const bool choose_diff = !choose_refr && u_lobe < mt.rgh;
  if (kCount && choose_diff) ++ev[kEvDiffuse];

  const float ndot = dx * nx + dy * ny + dz * nz;
  bool died = false;
  float ndx, ndy, ndz;
  if (choose_refr) {
    // Refraction with the entering/exiting flip of eta and the normal.
    const bool entering = ndot < 0.0f;
    const float eta = entering ? 1.0f / mt.ior : mt.ior;
    const float rnx = entering ? nx : -nx;
    const float rny = entering ? ny : -ny;
    const float rnz = entering ? nz : -nz;
    const float ni = rnx * dx + rny * dy + rnz * dz;
    const float k = 1.0f - eta * eta * (1.0f - ni * ni);
    if (k < 0.0f) {
      died = true;
      q.tr = q.tg = q.tb = 0.0f;
      ndx = dx;
      ndy = dy;
      ndz = dz;
    } else {
      const float coef = eta * ni + sqrtf(fmaxf(k, kKFloor));
      ndx = eta * dx - coef * rnx;
      ndy = eta * dy - coef * rny;
      ndz = eta * dz - coef * rnz;
    }
  } else if (choose_diff) {
    // Cosine-weighted about the geometric normal.
    const float rdiff = sqrtf(u1);
    float cs, sn;
    sincos_2pi(u2, cs, sn);
    const float lx = rdiff * cs;
    const float ly = rdiff * sn;
    const float lz = sqrtf(fmaxf(1.0f - u1, 0.0f));
    float tx, ty, tz, bx, by, bz;
    onb(nx, ny, nz, tx, ty, tz, bx, by, bz);
    ndx = lx * tx + ly * bx + lz * nx;
    ndy = lx * ty + ly * by + lz * ny;
    ndz = lx * tz + ly * bz + lz * nz;
  } else {
    // Mirror.
    ndx = dx - 2.0f * ndot * nx;
    ndy = dy - 2.0f * ndot * ny;
    ndz = dz - 2.0f * ndot * nz;
  }

  const float px = q.ox + h.t * dx;
  const float py = q.oy + h.t * dy;
  const float pz = q.oz + h.t * dz;
  const float offs = kEpsOffset + kEpsScale * sqrtf(px * px + py * py + pz * pz);

  if (nee && choose_diff)
    light_sample<kCount, kTriNee>(sc, em, mt, nx, ny, nz, px + offs * nx,
                                  py + offs * ny, pz + offs * nz, u_pick, v1, v2,
                                  q, ev);

  // cos / pdf cancels for the diffuse lobe; the others tint by albedo.
  q.tr *= mt.alb_r;
  q.tg *= mt.alb_g;
  q.tb *= mt.alb_b;

  const float side = ndx * nx + ndy * ny + ndz * nz >= 0.0f ? 1.0f : -1.0f;
  q.ox = px + offs * side * nx;
  q.oy = py + offs * side * ny;
  q.oz = pz + offs * side * nz;
  q.dx = ndx;
  q.dy = ndy;
  q.dz = ndz;
  if (!died) prevd = choose_diff;
}

// One pixel's radiance into `out`; with kCount its events into `ev`.
template <bool kCount, bool kTriNee>
__device__ __forceinline__ void render_pixel(const Tables& sc, const Emitters& em,
                                            const Params& p, float* __restrict__ out,
                                            int row, int col, int height, int width,
                                            int spp, int max_bounces, uint32_t seed,
                                            int sample_offset, int jitter, bool nee,
                                            float inv_spp, int* ev) {
  const uint32_t pix = static_cast<uint32_t>(row * width + col);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = static_cast<float>(row);
  const float inf = pos_inf();

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    bool prevd = false;
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      if (kCount) ++ev[kEvRounds];
      const Hit h = closest_hit(sc, q);
      if (!(h.t < inf)) {
        shade_miss(p, q);
        break;
      }
      const Material mt = fetch_material(sc, h.m);
      const float est = (h.m >= 0 && h.m < sc.n_mat) ? em.mat_est[h.m] : 0.0f;
      shade_phys<kCount, kTriNee>(sc, em, h, mt, est, nee, q, prevd, ev);
      // Exact early exit: with zero throughput every later round adds 0.
      if (q.tr == 0.0f && q.tg == 0.0f && q.tb == 0.0f) break;
    }
    shade_end(p, q);
    acc_r += q.ar;
    acc_g += q.ag;
    acc_b += q.ab;
  }
  float* o = out + 3 * static_cast<size_t>(pix);
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
}

template <bool kCount, bool kTriNee>
__global__ void __launch_bounds__(256)
render_phys_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                   int n_sph, const float* __restrict__ tri,
                   const int* __restrict__ tri_m, int n_tri,
                   const float* __restrict__ mat, int n_mat,
                   const int* __restrict__ em_list, const float* __restrict__ le_sph,
                   const int* __restrict__ tri_list, const float* __restrict__ le_tri,
                   const float* __restrict__ tri_area, const float* __restrict__ mat_est,
                   const int* __restrict__ counts, const float* __restrict__ par,
                   float* __restrict__ out, unsigned long long* counter, int nee,
                   int height, int width, int spp, int max_bounces, uint32_t seed,
                   int sample_offset, int jitter, float inv_spp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  int ev[kNumEvents] = {0, 0, 0, 0};
  if (col < width && row < height) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est,
                         counts[0], counts[1]};
    render_pixel<kCount, kTriNee>(sc, em, p, out, row, col, height, width, spp,
                                  max_bounces, seed, sample_offset, jitter,
                                  nee != 0, inv_spp, ev);
  }
  if (kCount) {
#pragma unroll
    for (int i = 0; i < kNumEvents; ++i) block_add(ev[i], counter + i);
  }
}

}  // namespace

// C entry, bound with ctypes. The scene tables and `par` are those of
// render_fwd; the emitter tables and `counts` = (n_em, n_em_t), two int32
// on the device, are packed by ops/render_physical.py. `out` is (height,
// width, 3) float32. `counter` is null, or four zeroed int64 that receive
// the executed thread-rounds, the diffuse vertices among them, the light
// samples computed and the shadow scans run. `nee` switches next-event estimation,
// `tri_nee` adds emissive triangles to the pool. Launches on `stream` of
// device `device` and returns cudaGetLastError().
extern "C" int render_phys(const float* sph, const int* sph_m, int n_sph,
                           const float* tri, const int* tri_m, int n_tri,
                           const float* mat, int n_mat, const int* em_list,
                           const float* le_sph, const int* tri_list,
                           const float* le_tri, const float* tri_area,
                           const float* mat_est, const int* counts,
                           const float* par, float* out,
                           unsigned long long* counter, int nee, int tri_nee,
                           int height, int width, int spp, int max_bounces,
                           unsigned int seed, int sample_offset, int jitter,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float32(1.0 / spp), rounded from double as the JAX package does.
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  auto kernel = counter
      ? (tri_nee ? render_phys_kernel<true, true> : render_phys_kernel<true, false>)
      : (tri_nee ? render_phys_kernel<false, true> : render_phys_kernel<false, false>);
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
      le_tri, tri_area, mat_est, counts, par, out, counter, nee, height, width,
      spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
