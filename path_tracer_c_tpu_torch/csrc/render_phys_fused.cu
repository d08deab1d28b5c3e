// Fused primal + Jacobian kernel of the physical tier for Hopper (sm_90a):
// the forward pass of the physical tier's gradient.
//
// Replaces the Pallas TPU kernel `_phys_fused_kernel` of
// path_tracer_c_tpu/ops/pallas_physical.py. One launch emits the radiance
// image, equal bit for bit to render_phys.cu's, and three families of
// per-pixel Jacobian planes from which the backward pass is a contraction
// with the image cotangent (ops/render_physical_grad.py
// `contract_physical_jacobian`). Per sample the radiance is
//
//   sum_b P_b E_b addle_b + sum_b P_b albedo_b/pi le_b w_b valid_b + P_end sky
//
// with P_b the throughput before bounce b, E_b the hit's emission (added
// unless single counting skips it), and (le_b, w_b, valid_b) the light sample
// of a diffuse vertex: the sampled emitter's radiance, the geometry weight
// cos / pdf * pool, and whether it counted.
//
// Material and sky planes, (mp * n_mat + 3, H, W), mp = 9, or 12 with
// rough_grad; per material m and colour c, summed over samples and bounces:
//
//   A[m, c]  += P (S_h + nee)              at a hit on m (albedo)
//   S'[m, c] += addle P                    at a hit on m (emission), and
//            += valid P albedo w / pi      into the planes of the *sampled
//                                          emitter's* material
//   R[m, c]  += P (S_h + nee) dr           (transparency)
//   G[m, c]  += P (S_h + nee) drg          (roughness, the score function of
//                                          the lobe choice; rough_grad only)
//   K[c]     += P at a miss, and P_end     (sky)
//
// S is the radiance collected after the bounce per unit of throughput, built
// by a sweep from the path's last round down: the sky at the end of the
// budget and at a miss, S_h = 0 after a death by total internal reflection,
// and S_{b-1} = addle E + albedo (S_h + nee) at a hit; nee_c = valid le_c w /
// pi.
//
// Emitter-geometry planes: for the first n_em_cap sphere-emitter ordinals 12
// planes each, layout [k, comp (cx, cy, cz, r), colour], and with tri_nee for
// the first tri_em_cap triangle-emitter ordinals 27 each, layout [k, comp (v0
// xyz, v1 xyz, v2 xyz), colour]:
//
//   G[k, comp, c] += F_c dw/dcomp,  F_c = valid P_c albedo_c le_c / pi
//
// Both factors are prefix quantities, so these planes accumulate in the
// forward rounds, not in the sweep. dw/dcomp is the hand-derived adjoint of
// the weight chain (pt_phys.cuh), where the TPU kernel takes a jax.vjp. The
// pool factor inside w is the whole pool's size under tri_nee, for sphere
// picks too.
//
// What bounds it on an H100: the forward kernel's FP32/SFU issue and
// divergence, the adjoint's 180 (sphere) or 183 (triangle) operations per
// valid light sample when geometry planes are asked for, and the
// read-modify-writes of the planes, which the caches absorb (a thread owns its
// pixel; counted once each way the planes are (mp n_mat + 3 + 12 K + 27 Kt) *
// H * W * 4 bytes).
//
// What the design does about that, after render_fused.cu:
//  * one thread per pixel, 32 x 8 blocks, the ragged edge masked; planes in
//    device memory, plane-major, zero-filled by the wrapper; no atomics; the
//    sky planes in registers;
//  * per bounce a thread stores the throughput before it, the material, one
//    byte of events and, of the light sample, its weight and the emitter's
//    row: 25 bytes (pt_phys.cuh `RoundStores`), where the TPU kernel stores 22
//    planes. Albedo, emission, the emitter's radiance and material, dr and drg
//    are read or recomputed from the tables in the sweep;
//  * a thread adds into the planes of the material it hit and of the emitter
//    it sampled, and into the geometry planes of the one ordinal it sampled,
//    where the TPU kernel loops over every material and ordinal under masks.
//    A triangle pick touches no sphere plane and a sphere pick no triangle
//    plane;
//  * the bounce loop ends on a miss or total internal reflection only, never
//    on zero throughput (a path that a black albedo killed still owes its
//    later rounds' albedo gradient). Those extra rounds add exact zeros to the
//    radiance, the light sample included (0 * w with w finite), so the image
//    stays render_phys.cu's;
//  * tri_nee, rough_grad and counting are template parameters; next-event
//    estimation and the two caps are run-time values;
//  * the kernel is built for four blocks of 256 threads a multiprocessor
//    (__launch_bounds__(256, 4): 64 registers a thread). Left to itself ptxas
//    takes 105 to 120 registers and no spills, which fits two blocks; at 64
//    it spills 164 bytes and the kernel is 19% faster without geometry
//    planes and 13% faster with them (PERF.md): what holds the kernel is
//    latency that more resident warps hide, not the spills' traffic.

#include "pt_phys.cuh"

namespace {

using namespace ptc;

// The plane pointers and sizes of one launch.
struct Planes {
  float* jac;   // (mp * n_mat + 3, H, W)
  float* jgeo;  // (12 * n_em_cap, H, W), or null
  float* jtri;  // (27 * tri_em_cap, H, W), or null
  size_t hw;    // plane stride
  int n_em_cap, tri_em_cap;
};

// One pixel's radiance into `img` and Jacobian planes into `pl`; returns the
// bounce rounds it ran and adds to `n_valid` the light samples that counted.
template <bool kCount, bool kTriNee, bool kRough>
__device__ __forceinline__ int render_pixel(const Tables& sc, const Emitters& em,
                                            const Params& p, float* __restrict__ img,
                                            const Planes& pl, int row, int col,
                                            int height, int width, int spp,
                                            int max_bounces, uint32_t seed,
                                            int sample_offset, int jitter, bool nee,
                                            float inv_spp, int& n_valid) {
  constexpr int kMatPlanes = kRough ? 12 : 9;
  const uint32_t pix = static_cast<uint32_t>(row * width + col);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = static_cast<float>(row);
  const float inf = pos_inf();
  const size_t hw = pl.hw;

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  RoundStores st;
  int rounds = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky planes
  float* const jpix = pl.jac + pix;
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    bool prevd = false;
    // -- forward rounds, storing what the sweep needs --
    int n_rounds = 0;
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      if (kCount) ++rounds;
      n_rounds = bounce + 1;
      const Hit h = closest_hit(sc, q);
      const float pr = q.tr, pg = q.tg, pb = q.tb;
      st.pr[bounce] = pr;
      st.pg[bounce] = pg;
      st.pb[bounce] = pb;
      st.mat[bounce] = h.m;
      if (!(h.t < inf)) {
        st.ev[bounce] = kEvMiss;
        shade_miss(p, q);
        break;
      }
      const Material mt = fetch_material(sc, h.m);
      const BounceRecord rec = shade_phys<false, kTriNee>(
          sc, em, h, mt, fetch_est(sc, em, h.m), nee, q, prevd, nullptr);
      st.ev[bounce] = static_cast<unsigned char>(rec.event);
      st.w[bounce] = rec.ls.w;
      st.row[bounce] = rec.ls.row;
      if (rec.event & kEvValid) {
        if (kCount) ++n_valid;
        // Emitter-geometry planes of the sampled ordinal, if it is tracked.
        const LightSample& ls = rec.ls;
        const float f_r = pr * mt.alb_r * ls.ler * kInvPi;
        const float f_g = pg * mt.alb_g * ls.leg * kInvPi;
        const float f_b = pb * mt.alb_b * ls.leb * kInvPi;
        if (ls.row >= 0) {
          if (ls.ord < pl.n_em_cap) {
            float dw[4];
            cone_w_adjoint(sc.sph + ls.row * kSphStride, rec.sox, rec.soy, rec.soz,
                           h.nx, h.ny, h.nz, rec.v1, ls.cp, ls.sn, ls.pool_f, dw);
            float* j = pl.jgeo + static_cast<size_t>(12 * ls.ord) * hw + pix;
#pragma unroll
            for (int comp = 0; comp < 4; ++comp) {
              j[(3 * comp) * hw] += f_r * dw[comp];
              j[(3 * comp + 1) * hw] += f_g * dw[comp];
              j[(3 * comp + 2) * hw] += f_b * dw[comp];
            }
          }
        } else if (kTriNee && ls.ord < pl.tri_em_cap) {
          float dw[9];
          tri_w_adjoint(sc.tri + (~ls.row) * kTriStride, rec.sox, rec.soy, rec.soz,
                        h.nx, h.ny, h.nz, rec.v1, rec.v2, ls.pool_f, dw);
          float* j = pl.jtri + static_cast<size_t>(27 * ls.ord) * hw + pix;
#pragma unroll
          for (int comp = 0; comp < 9; ++comp) {
            j[(3 * comp) * hw] += f_r * dw[comp];
            j[(3 * comp + 1) * hw] += f_g * dw[comp];
            j[(3 * comp + 2) * hw] += f_b * dw[comp];
          }
        }
      }
      // Structural death only; zero throughput goes on (see above).
      if (rec.event & kDied) break;
    }
    // The sky at the end of the budget, summed into the sample's radiance
    // before the accumulator, as the forward kernel does.
    shade_end(p, q);
    acc_r += q.ar;
    acc_g += q.ag;
    acc_b += q.ab;
    k_r += q.tr;
    k_g += q.tg;
    k_b += q.tb;

    // -- sweep: last round down to 0, carrying S --
    float s_r = p.sky_r, s_g = p.sky_g, s_b = p.sky_b;
    for (int b = n_rounds - 1; b >= 0; --b) {
      const float pr = st.pr[b], pg = st.pg[b], pb = st.pb[b];
      const int event = st.ev[b];
      if (event & kEvMiss) {
        k_r += pr;
        k_g += pg;
        k_b += pb;
        s_r = p.sky_r;
        s_g = p.sky_g;
        s_b = p.sky_b;
        continue;
      }
      const int m = st.mat[b];
      const SweptHit sh = swept_hit(sc, em, st, b);
      const Material& mt = sh.mt;
      // A path that died here collects nothing downstream.
      const float sh_r = ((event & kDied) ? 0.0f : s_r) + sh.nee_r;
      const float sh_g = ((event & kDied) ? 0.0f : s_g) + sh.nee_g;
      const float sh_b = ((event & kDied) ? 0.0f : s_b) + sh.nee_b;
      const float ca_r = pr * sh_r, ca_g = pg * sh_g, ca_b = pb * sh_b;
      const bool addle = (event & kEvAddLe) != 0;
      if (m >= 0 && m < sc.n_mat) {
        float* j = jpix + static_cast<size_t>(kMatPlanes * m) * hw;
        j[0] += ca_r;
        j[hw] += ca_g;
        j[2 * hw] += ca_b;
        if (addle) {
          j[3 * hw] += pr;
          j[4 * hw] += pg;
          j[5 * hw] += pb;
        }
        const float dr = ratio_dr(mt, event);
        j[6 * hw] += ca_r * dr;
        j[7 * hw] += ca_g * dr;
        j[8 * hw] += ca_b * dr;
        if (kRough) {
          const float drg = lobe_drg(mt, event);
          j[9 * hw] += ca_r * drg;
          j[10 * hw] += ca_g * drg;
          j[11 * hw] += ca_b * drg;
        }
      }
      if (sh.valid && sh.emat >= 0 && sh.emat < sc.n_mat) {
        // The sampled emitter's emission, into its own material's planes.
        float* j = jpix + static_cast<size_t>(kMatPlanes * sh.emat + 3) * hw;
        j[0] += sh.emw_r;
        j[hw] += sh.emw_g;
        j[2 * hw] += sh.emw_b;
      }
      s_r = (addle ? mt.em_r : 0.0f) + mt.alb_r * sh_r;
      s_g = (addle ? mt.em_g : 0.0f) + mt.alb_g * sh_g;
      s_b = (addle ? mt.em_b : 0.0f) + mt.alb_b * sh_b;
    }
  }
  float* o = img + 3 * static_cast<size_t>(pix);
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
  float* k = jpix + static_cast<size_t>(kMatPlanes * sc.n_mat) * hw;
  k[0] = k_r;
  k[hw] = k_g;
  k[2 * hw] = k_b;
  return rounds;
}

template <bool kCount, bool kTriNee, bool kRough>
__global__ void __launch_bounds__(256, 4)
render_phys_fused_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                         int n_sph, const float* __restrict__ tri,
                         const int* __restrict__ tri_m, int n_tri,
                         const float* __restrict__ mat, int n_mat,
                         const int* __restrict__ em_list,
                         const float* __restrict__ le_sph,
                         const int* __restrict__ tri_list,
                         const float* __restrict__ le_tri,
                         const float* __restrict__ tri_area,
                         const float* __restrict__ mat_est,
                         const int* __restrict__ counts, const float* __restrict__ par,
                         float* __restrict__ img, float* __restrict__ jac,
                         float* __restrict__ jgeo, float* __restrict__ jtri,
                         unsigned long long* counter, int nee, int n_em_cap,
                         int tri_em_cap, int height, int width, int spp,
                         int max_bounces, uint32_t seed, int sample_offset, int jitter,
                         float inv_spp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  int rounds = 0, n_valid = 0;
  if (col < width && row < height) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est,
                         counts[0], counts[1]};
    const Planes pl = {jac, jgeo, jtri,
                       static_cast<size_t>(height) * static_cast<size_t>(width),
                       n_em_cap, tri_em_cap};
    rounds = render_pixel<kCount, kTriNee, kRough>(
        sc, em, p, img, pl, row, col, height, width, spp, max_bounces, seed,
        sample_offset, jitter, nee != 0, inv_spp, n_valid);
  }
  if (kCount) {
    block_add(rounds, counter);
    block_add(n_valid, counter + 1);
  }
}

template <bool kCount, bool kTriNee>
auto pick_rough(int rough_grad) {
  return rough_grad ? render_phys_fused_kernel<kCount, kTriNee, true>
                    : render_phys_fused_kernel<kCount, kTriNee, false>;
}

}  // namespace

// The most bounces the physical gradient kernels take (render_phys_fused and
// render_phys_bwd); the wrappers ask and raise above it.
extern "C" int render_phys_grad_max_bounces() { return kMaxRounds - 1; }

// C entry, bound with ctypes. Tables, emitter tables, `counts` and `par` as
// for render_phys; `img` is (height, width, 3) float32; `jac` is (mp * n_mat +
// 3, height, width) float32 with mp = 12 if `rough_grad` else 9; `jgeo` is
// (12 * n_em_cap, height, width) or null when n_em_cap is 0; `jtri` is (27 *
// tri_em_cap, height, width) or null when tri_em_cap is 0 (it must be 0
// without `tri_nee`). The planes must arrive zero-filled. `counter` is null,
// or two zeroed int64 that receive the executed thread-rounds and the light
// samples that counted. Launches on
// `stream` of device `device` and returns cudaGetLastError(), or
// cudaErrorInvalidValue if max_bounces is above the cap or a cap has no planes.
extern "C" int render_phys_fused(const float* sph, const int* sph_m, int n_sph,
                                 const float* tri, const int* tri_m, int n_tri,
                                 const float* mat, int n_mat, const int* em_list,
                                 const float* le_sph, const int* tri_list,
                                 const float* le_tri, const float* tri_area,
                                 const float* mat_est, const int* counts,
                                 const float* par, float* img, float* jac,
                                 float* jgeo, float* jtri,
                                 unsigned long long* counter, int nee, int tri_nee,
                                 int rough_grad, int n_em_cap, int tri_em_cap,
                                 int height, int width, int spp, int max_bounces,
                                 unsigned int seed, int sample_offset, int jitter,
                                 int device, void* stream) {
  if (max_bounces + 1 > kMaxRounds || n_em_cap < 0 || tri_em_cap < 0 ||
      (n_em_cap > 0 && !jgeo) || (tri_em_cap > 0 && (!jtri || !tri_nee)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  auto kernel = counter
      ? (tri_nee ? pick_rough<true, true>(rough_grad) : pick_rough<true, false>(rough_grad))
      : (tri_nee ? pick_rough<false, true>(rough_grad) : pick_rough<false, false>(rough_grad));
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
      le_tri, tri_area, mat_est, counts, par, img, jac, jgeo, jtri, counter, nee,
      n_em_cap, tri_em_cap, height, width, spp, max_bounces, seed, sample_offset,
      jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
