// Device functions of the physical tier, shared by its three kernels
// (render_phys.cu, render_phys_fused.cu, render_phys_bwd.cu): constants, the
// emitter tables, the orthonormal basis, one light sample, one bounce of the
// physical shading, and the hand-derived adjoints of the two light-sample
// weight chains.
//
// They replace `make_physical_shading`, `_onb`, `_cone_w_chain` and
// `_tri_w_chain` of path_tracer_c_tpu/ops/pallas_physical.py, and the
// `jax.vjp` the TPU kernels take through the two chains. There is one
// definition of each, so the fused kernel's and the two-pass kernel's primal
// rounds are the forward kernel's by construction, and the two gradient
// kernels cannot drift in their geometry adjoints.
//
// Numerics: see pt_common.cuh. Every expression evaluates in the order of the
// plain PyTorch twins (ops/render_physical.py, ops/render_physical_grad.py).

#pragma once

#include "pt_common.cuh"

namespace ptc {

constexpr float kInvPi = 0x1.45f306p-2f;      // float32(1 / pi)
constexpr float kSin2Cap = 0x1.fffffcp-1f;    // float32(1 - 1e-7)
constexpr float kVisScale = 0x1.ff7ceep-1f;   // float32(1 - 1e-3)
constexpr float kVisSlack = 0x1.a36e2ep-14f;  // float32(1e-4)
constexpr float kD2Floor = 0x1.197998p-40f;   // float32(1e-12)
constexpr float kPdfFloor = 0x1.5798eep-27f;  // float32(1e-8)
constexpr float kDetFloor = 0x1.4484c0p-100f; // float32(1e-30)
constexpr float kCosLMin = 0x1.0c6f7ap-20f;   // float32(1e-6)
constexpr float kAreaFloor = 0x1.79ca10p-67f; // float32(1e-20)

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

// What the counting instantiation of the forward kernel counts per thread,
// in this order (the layout of the wrapper's counter tensor): bounce rounds
// run, diffuse vertices among them, light samples computed, shadow scans run.
constexpr int kEvRounds = 0, kEvDiffuse = 1, kEvLight = 2, kEvShadow = 3;
constexpr int kNumEvents = 4;

// What one round decided, as bits, beside kRefracted and kDied of
// pt_common.cuh: a miss (set by the kernels, never by shade_phys); the hit's
// own emission was added (not skipped by single counting); the diffuse lobe
// was chosen; the light sample counted.
constexpr int kEvMiss = 4;
constexpr int kEvAddLe = 8;
constexpr int kEvDiffuseLobe = 16;
constexpr int kEvValid = 32;

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

// One light sample, as its caller needs it. `valid`: it counts (the pool is
// not empty, the sample faces the surface and the emitter, nothing occludes
// it). `row`: the sampled emitter's table row, a sphere's as it is, a
// triangle's as ~row (negative). `ord`: its ordinal among the emitters of its
// kind. `w`: the geometry weight cos_surf / pdf * pool. `pool_f`, `cp`, `sn`
// (the cone's azimuth): what the weight chains' adjoints take besides the
// draws. Everything but `valid` is defined only where `valid` holds.
struct LightSample {
  bool valid;
  int row, ord;
  float w;
  float ler, leg, leb;
  float pool_f, cp, sn;
};

// One light sample from surface point `so` (already offset along the normal
// n). Called at diffuse vertices only. The forward kernel reads `valid`, `w`
// and the radiance; the rest is dead code there.
template <bool kCount, bool kTriNee>
__device__ __forceinline__ LightSample light_sample(const Tables& sc,
                                                    const Emitters& em, float nx,
                                                    float ny, float nz, float sox,
                                                    float soy, float soz,
                                                    float u_pick, float v1,
                                                    float v2, int* ev) {
  LightSample ls;
  ls.valid = false;
  ls.row = 0;
  ls.ord = 0;
  ls.w = 0.0f;
  ls.ler = ls.leg = ls.leb = 0.0f;
  ls.pool_f = 0.0f;
  ls.cp = 1.0f;
  ls.sn = 0.0f;
  const int pool = kTriNee ? em.n_em + em.n_em_t : em.n_em;
  if (pool <= 0) return ls;
  if (kCount) ++ev[kEvLight];
  const float pool_f = static_cast<float>(pool);
  const int kf = static_cast<int>(floorf(u_pick * pool_f));
  const int kk = min(max(kf, 0), pool - 1);
  ls.pool_f = pool_f;

  float omx, omy, omz, cos_surf, t_e, w;
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
    ls.ler = em.le_tri[3 * ti];
    ls.leg = em.le_tri[3 * ti + 1];
    ls.leb = em.le_tri[3 * ti + 2];
    ls.row = ~ti;
    ls.ord = kt;
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
    ls.ler = em.le_sph[3 * ei];
    ls.leg = em.le_sph[3 * ei + 1];
    ls.leb = em.le_sph[3 * ei + 2];
    ls.row = ei;
    ls.ord = kk;
    ls.cp = cp;
    ls.sn = sn;
    w = cos_surf / pdf_omega;
  }
  if (!(branch_ok && cos_surf > 0.0f && t_e < pos_inf())) return ls;
  // Unoccluded: the closest thing along the shadow ray is the emitter.
  if (kCount) ++ev[kEvShadow];
  const float s_bt = closest_t(sc, sox, soy, soz, omx, omy, omz);
  if (!(s_bt < pos_inf() && s_bt >= t_e * kVisScale - kVisSlack)) return ls;
  ls.w = w * pool_f;
  ls.valid = true;
  return ls;
}

// What shade_phys did in one round: the event bits above, the light sample,
// the shadow ray's origin and the two emitter draws (the inputs of the weight
// chains). The forward kernel drops all of it.
struct BounceRecord {
  int event;
  LightSample ls;
  float sox, soy, soz;
  float v1, v2;
};

// One bounce at hit `h` (h.t finite) on material `mt` with raw emission
// strength `est`. `prevd` says whether the path arrived by a diffuse
// sample; it is updated for paths that go on. A path that dies (total
// internal reflection on the refracted branch) gets zero throughput and
// keeps its direction. A valid light sample adds thr * albedo/pi * Le * w
// to the path's radiance, with the throughput before the albedo.
template <bool kCount, bool kTriNee>
__device__ __forceinline__ BounceRecord shade_phys(const Tables& sc,
                                                   const Emitters& em, const Hit& h,
                                                   const Material& mt, float est,
                                                   bool nee, Path& q, bool& prevd,
                                                   int* ev) {
  const float dx = q.dx, dy = q.dy, dz = q.dz;
  const float nx = h.nx, ny = h.ny, nz = h.nz;
  BounceRecord rec;
  rec.event = 0;
  rec.ls.valid = false;

  // Le, skipped where a diffuse-sampled ray arrives at an emitter that the
  // previous vertex could have light-sampled (single counting).
  bool counted = false;
  if (nee) {
    counted = prevd && h.sphere && est > 0.0f && em.n_em > 0;
    if (kTriNee) counted = counted || (prevd && !h.sphere && est > 0.0f && em.n_em_t > 0);
  }
  if (!counted) {
    rec.event |= kEvAddLe;
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
  rec.v1 = v1;
  rec.v2 = v2;

  const bool choose_refr = u_transp < mt.trn;
  const bool choose_diff = !choose_refr && u_lobe < mt.rgh;
  if (kCount && choose_diff) ++ev[kEvDiffuse];
  if (choose_refr) rec.event |= kRefracted;
  if (choose_diff) rec.event |= kEvDiffuseLobe;

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
      rec.event |= kDied;
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
  rec.sox = px + offs * nx;
  rec.soy = py + offs * ny;
  rec.soz = pz + offs * nz;

  if (nee && choose_diff) {
    rec.ls = light_sample<kCount, kTriNee>(sc, em, nx, ny, nz, rec.sox, rec.soy,
                                           rec.soz, u_pick, v1, v2, ev);
    if (rec.ls.valid) {
      rec.event |= kEvValid;
      q.ar += q.tr * mt.alb_r * kInvPi * rec.ls.ler * rec.ls.w;
      q.ag += q.tg * mt.alb_g * kInvPi * rec.ls.leg * rec.ls.w;
      q.ab += q.tb * mt.alb_b * kInvPi * rec.ls.leb * rec.ls.w;
    }
  }

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
  return rec;
}

// Raw emission strength of material `m`; zero for an index outside the table.
__device__ __forceinline__ float fetch_est(const Tables& sc, const Emitters& em, int m) {
  return (m >= 0 && m < sc.n_mat) ? em.mat_est[m] : 0.0f;
}

// The sampled emitter of a stored round, from its `row` (LightSample::row):
// its premultiplied radiance and its material index.
__device__ __forceinline__ void emitter_of_row(const Tables& sc, const Emitters& em,
                                               int row, float& ler, float& leg,
                                               float& leb, int& emat) {
  if (row >= 0) {
    ler = em.le_sph[3 * row];
    leg = em.le_sph[3 * row + 1];
    leb = em.le_sph[3 * row + 2];
    emat = sc.sph_m[row];
  } else {
    const int ti = ~row;
    ler = em.le_tri[3 * ti];
    leg = em.le_tri[3 * ti + 1];
    leb = em.le_tri[3 * ti + 2];
    emat = sc.tri_m[ti];
  }
}

// d(ratio)/d(transparency) over the ratio, of the branch a round took: 1/t
// where it refracted, -1/(1 - t) where it did not.
__device__ __forceinline__ float ratio_dr(const Material& mt, int event) {
  return (event & kRefracted) ? 1.0f / fmaxf(mt.trn, kRatioFloor)
                              : -1.0f / fmaxf(1.0f - mt.trn, kRatioFloor);
}

// The score function of the lobe choice, d(log p)/d(roughness): 1/rough
// where the diffuse lobe was drawn, -1/(1 - rough) for the mirror, 0 on the
// refracted branch (the lobe draw is not used there).
__device__ __forceinline__ float lobe_drg(const Material& mt, int event) {
  if (event & kRefracted) return 0.0f;
  return (event & kEvDiffuseLobe) ? 1.0f / fmaxf(mt.rgh, kRatioFloor)
                                  : -1.0f / fmaxf(1.0f - mt.rgh, kRatioFloor);
}

// Adjoint of the cone weight chain
//
//   w(c, r) = cos_surf * max(2 pi (1 - cosmax), 1e-8) * pool
//
// of a sphere emitter with centre c = sp[0..2] and radius r = sp[3], sampled
// from shadow origin `so` with surface normal `n`, cone draw `v1` and azimuth
// (cp, sn): dw[0..2] = dw/dc, dw[3] = dw/dr. Derived by hand from
// `_cone_w_chain`; every guard differentiates as in reverse-mode AD of that
// chain: a floor that wins and a clip that binds pass nothing, the sign in
// the basis is a constant. The twin is `cone_w_adjoint` of
// ops/render_physical_grad.py, in this expression order.
__device__ __forceinline__ void cone_w_adjoint(const float* sp, float sox, float soy,
                                               float soz, float nxp, float nyp,
                                               float nzp, float v1, float cp, float sn,
                                               float pool_f, float* dw) {
  // -- the chain, forward --
  const float rr = sp[3];
  const float dcx = sp[0] - sox, dcy = sp[1] - soy, dcz = sp[2] - soz;
  const float d2 = dcx * dcx + dcy * dcy + dcz * dcz;
  const float d2s = fmaxf(d2, kD2Floor);
  const float dist = sqrtf(d2s);
  const float wzx = dcx / dist, wzy = dcy / dist, wzz = dcz / dist;
  const float qq = rr * rr / d2s;
  const float sin2max = fminf(fmaxf(qq, 0.0f), kSin2Cap);
  const float cosmax = sqrtf(1.0f - sin2max);
  const float cth = 1.0f - v1 * (1.0f - cosmax);
  const float s2 = 1.0f - cth * cth;
  const float sth = sqrtf(fmaxf(s2, kD2Floor));
  const float sign = wzz >= 0.0f ? 1.0f : -1.0f;
  const float a = -1.0f / (sign + wzz);
  const float b = wzx * wzy * a;
  const float tax = 1.0f + sign * wzx * wzx * a, tay = sign * b, taz = -sign * wzx;
  const float bax = b, bay = sign + wzy * wzy * a, baz = -wzy;
  const float omx = sth * cp * tax + sth * sn * bax + cth * wzx;
  const float omy = sth * cp * tay + sth * sn * bay + cth * wzy;
  const float omz = sth * cp * taz + sth * sn * baz + cth * wzz;
  const float cos_surf = nxp * omx + nyp * omy + nzp * omz;
  const float cone = kTwoPi * (1.0f - cosmax);
  const float pdfinv = fmaxf(cone, kPdfFloor);
  // -- and back, from dw = 1 --
  const float g_cs = pool_f * pdfinv;
  const float g_pdfinv = pool_f * cos_surf;
  float g_cosmax = cone > kPdfFloor ? -(kTwoPi * g_pdfinv) : 0.0f;
  const float g_omx = g_cs * nxp, g_omy = g_cs * nyp, g_omz = g_cs * nzp;
  float g_cth = g_omx * wzx + g_omy * wzy + g_omz * wzz;
  const float g_sth = g_omx * (cp * tax + sn * bax) + g_omy * (cp * tay + sn * bay) +
                      g_omz * (cp * taz + sn * baz);
  float g_wzx = cth * g_omx, g_wzy = cth * g_omy, g_wzz = cth * g_omz;
  const float kt = sth * cp, kb = sth * sn;
  const float g_tax = kt * g_omx, g_tay = kt * g_omy, g_taz = kt * g_omz;
  const float g_bax = kb * g_omx, g_bay = kb * g_omy, g_baz = kb * g_omz;
  // the basis
  const float g_b = sign * g_tay + g_bax;
  const float g_a = sign * wzx * wzx * g_tax + wzy * wzy * g_bay + wzx * wzy * g_b;
  g_wzx = g_wzx + (2.0f * sign * wzx * a * g_tax - sign * g_taz + wzy * a * g_b);
  g_wzy = g_wzy + (2.0f * wzy * a * g_bay - g_baz + wzx * a * g_b);
  g_wzz = g_wzz + a * a * g_a;
  // sth, cth, cosmax
  const float g_s2 = s2 > kD2Floor ? 0.5f * g_sth / sth : 0.0f;
  g_cth = g_cth - 2.0f * cth * g_s2;
  g_cosmax = g_cosmax + v1 * g_cth;
  const float g_sin2 = -(0.5f * g_cosmax / cosmax);
  const float g_qq = (qq > 0.0f && qq < kSin2Cap) ? g_sin2 : 0.0f;
  dw[3] = 2.0f * rr * g_qq / d2s;
  float g_d2s = -(rr * rr * g_qq / (d2s * d2s));
  // the unit vector to the centre
  float g_dcx = g_wzx / dist, g_dcy = g_wzy / dist, g_dcz = g_wzz / dist;
  const float g_dist = -((g_wzx * dcx + g_wzy * dcy + g_wzz * dcz) / (dist * dist));
  g_d2s = g_d2s + 0.5f * g_dist / dist;
  const float g_d2 = d2 > kD2Floor ? g_d2s : 0.0f;
  dw[0] = g_dcx + 2.0f * dcx * g_d2;
  dw[1] = g_dcy + 2.0f * dcy * g_d2;
  dw[2] = g_dcz + 2.0f * dcz * g_d2;
}

// Adjoint of the triangle weight chain
//
//   w(v0, v1, v2) = cos_surf * area * |cos_l| / max(d^2, 1e-12) * pool
//
// of a triangle emitter with vertices tp[0..8], sampled from shadow origin
// `so` with surface normal `n` and the draws (v1, v2): dw[0..8] = dw/d(v0 xyz,
// v1 xyz, v2 xyz). Derived by hand from `_tri_w_chain`, guards as above; abs
// differentiates to the sign. The twin is `tri_w_adjoint` of
// ops/render_physical_grad.py.
__device__ __forceinline__ void tri_w_adjoint(const float* tp, float sox, float soy,
                                              float soz, float nxp, float nyp,
                                              float nzp, float v1, float v2,
                                              float pool_f, float* dw) {
  // -- the chain, forward --
  const float su = sqrtf(v1);
  const float b1 = su * (1.0f - v2);
  const float b2 = su * v2;
  const float b0 = 1.0f - su;
  const float dqx = b0 * tp[0] + b1 * tp[3] + b2 * tp[6] - sox;
  const float dqy = b0 * tp[1] + b1 * tp[4] + b2 * tp[7] - soy;
  const float dqz = b0 * tp[2] + b1 * tp[5] + b2 * tp[8] - soz;
  const float d2t = dqx * dqx + dqy * dqy + dqz * dqz;
  const float d2s = fmaxf(d2t, kD2Floor);
  const float dist = sqrtf(d2s);
  const float otx = dqx / dist, oty = dqy / dist, otz = dqz / dist;
  const float e1x = tp[3] - tp[0], e1y = tp[4] - tp[1], e1z = tp[5] - tp[2];
  const float e2x = tp[6] - tp[0], e2y = tp[7] - tp[1], e2z = tp[8] - tp[2];
  const float crx = e1y * e2z - e1z * e2y;
  const float cry = e1z * e2x - e1x * e2z;
  const float crz = e1x * e2y - e1y * e2x;
  const float cr2 = crx * crx + cry * cry + crz * crz;
  const float two_area = sqrtf(fmaxf(cr2, kAreaFloor));
  const float tnx = crx / two_area, tny = cry / two_area, tnz = crz / two_area;
  const float area = 0.5f * two_area;
  const float dotl = tnx * otx + tny * oty + tnz * otz;
  const float cos_l = fabsf(dotl);
  const float w_geom = area * cos_l / d2s;
  const float cos_surf = nxp * otx + nyp * oty + nzp * otz;
  // -- and back, from dw = 1 --
  const float g_cs = pool_f * w_geom;
  const float g_wg = pool_f * cos_surf;
  const float g_area = g_wg * cos_l / d2s;
  const float g_cosl = g_wg * area / d2s;
  float g_d2s = -(g_wg * area * cos_l / (d2s * d2s));
  const float sgn = dotl > 0.0f ? 1.0f : (dotl < 0.0f ? -1.0f : 0.0f);
  const float g_dotl = sgn * g_cosl;
  const float g_tnx = g_dotl * otx, g_tny = g_dotl * oty, g_tnz = g_dotl * otz;
  const float g_otx = g_dotl * tnx + g_cs * nxp;
  const float g_oty = g_dotl * tny + g_cs * nyp;
  const float g_otz = g_dotl * tnz + g_cs * nzp;
  // the normal and the area
  const float g_two = 0.5f * g_area -
                      (g_tnx * crx + g_tny * cry + g_tnz * crz) / (two_area * two_area);
  const float g_cr2 = cr2 > kAreaFloor ? 0.5f * g_two / two_area : 0.0f;
  const float g_crx = g_tnx / two_area + 2.0f * crx * g_cr2;
  const float g_cry = g_tny / two_area + 2.0f * cry * g_cr2;
  const float g_crz = g_tnz / two_area + 2.0f * crz * g_cr2;
  const float g_e1x = e2y * g_crz - e2z * g_cry;
  const float g_e1y = e2z * g_crx - e2x * g_crz;
  const float g_e1z = e2x * g_cry - e2y * g_crx;
  const float g_e2x = g_cry * e1z - g_crz * e1y;
  const float g_e2y = g_crz * e1x - g_crx * e1z;
  const float g_e2z = g_crx * e1y - g_cry * e1x;
  // the unit vector to the sampled point
  const float g_dist = -((g_otx * dqx + g_oty * dqy + g_otz * dqz) / (dist * dist));
  g_d2s = g_d2s + 0.5f * g_dist / dist;
  const float g_d2t = d2t > kD2Floor ? g_d2s : 0.0f;
  const float g_qx = g_otx / dist + 2.0f * dqx * g_d2t;
  const float g_qy = g_oty / dist + 2.0f * dqy * g_d2t;
  const float g_qz = g_otz / dist + 2.0f * dqz * g_d2t;
  dw[0] = b0 * g_qx - g_e1x - g_e2x;
  dw[1] = b0 * g_qy - g_e1y - g_e2y;
  dw[2] = b0 * g_qz - g_e1z - g_e2z;
  dw[3] = b1 * g_qx + g_e1x;
  dw[4] = b1 * g_qy + g_e1y;
  dw[5] = b1 * g_qz + g_e1z;
  dw[6] = b2 * g_qx + g_e2x;
  dw[7] = b2 * g_qy + g_e2y;
  dw[8] = b2 * g_qz + g_e2z;
}

// The forward rounds' per-bounce stores of the two gradient kernels: the
// throughput before the round, the hit material, the event bits, and of a
// valid light sample its weight and emitter row. Thread-private arrays of a
// compile-time size (the compiler places them in local memory, as in
// render_fused.cu): max_bounces + 1 <= kMaxRounds, and the wrappers raise
// above it.
constexpr int kMaxRounds = 32;

struct RoundStores {
  float pr[kMaxRounds], pg[kMaxRounds], pb[kMaxRounds];
  float w[kMaxRounds];
  int mat[kMaxRounds];
  int row[kMaxRounds];
  unsigned char ev[kMaxRounds];
};

// What a swept hit round contributes per unit of throughput, read back from
// the stores and the tables: the material, the light sample's radiance term
// nee_c = valid * le_c * w / pi, the sampled emitter's material and the
// weight emw_c = valid * P_c * albedo_c * w / pi of its emission.
struct SweptHit {
  Material mt;
  float nee_r, nee_g, nee_b;
  float emw_r, emw_g, emw_b;
  float ler, leg, leb, w;
  int emat;
  bool valid;
};

__device__ __forceinline__ SweptHit swept_hit(const Tables& sc, const Emitters& em,
                                              const RoundStores& st, int b) {
  SweptHit s;
  s.mt = fetch_material(sc, st.mat[b]);
  s.valid = (st.ev[b] & kEvValid) != 0;
  s.nee_r = s.nee_g = s.nee_b = 0.0f;
  s.emw_r = s.emw_g = s.emw_b = 0.0f;
  s.ler = s.leg = s.leb = 0.0f;
  s.w = 0.0f;
  s.emat = -1;
  if (s.valid) {
    s.w = st.w[b];
    emitter_of_row(sc, em, st.row[b], s.ler, s.leg, s.leb, s.emat);
    s.nee_r = s.ler * s.w * kInvPi;
    s.nee_g = s.leg * s.w * kInvPi;
    s.nee_b = s.leb * s.w * kInvPi;
    s.emw_r = st.pr[b] * s.mt.alb_r * s.w * kInvPi;
    s.emw_g = st.pg[b] * s.mt.alb_g * s.w * kInvPi;
    s.emw_b = st.pb[b] * s.mt.alb_b * s.w * kInvPi;
  }
  return s;
}

}  // namespace ptc
