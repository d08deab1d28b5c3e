// Two-pass backward kernel of the physical tier for Hopper (sm_90a): the
// parity oracle of the fused kernel (render_phys_fused.cu).
//
// Replaces the Pallas TPU kernel `_phys_bwd_kernel` of
// path_tracer_c_tpu/ops/pallas_physical.py. Given the cotangent g of the
// radiance image it replays the forward rounds, sweeps them from the last
// round down and reduces, over all pixels, samples and bounces, the
// cotangents themselves:
//
//   out (n_mat + 1, 8): per material albedo[3], emission colour[3], emission
//       strength, transparency; row n_mat holds the sky's three;
//   geo (max(n_em_cap, 1), 4): per sphere-emitter ordinal below n_em_cap the
//       centre's three and the radius', through the cone weight only.
//
// Its contract is narrower than the fused kernel's: no triangle vertices
// and no roughness. With gP = g / spp * P at a hit on material m, S_h the
// suffix radiance (0 after total internal reflection), nee and the sampled
// emitter (le, w, valid, its material e) as in render_phys_fused.cu:
//
//   albedo[m, c]       += gP_c (S_h_c + nee_c)
//   emission col[m, c] += addle gP_c est[m]
//   emission str[m]    += addle sum_c gP_c eco[m, c]
//   transparency[m]    += sum_c albedo[m, c] gP_c (S_h_c + nee_c) dr
//   emission col[e, c] += valid gP_c albedo[m, c] w / pi est[e]
//   emission str[e]    += valid sum_c gP_c albedo[m, c] w / pi eco[e, c]
//   sky[c]             += g_c / spp P_c at a miss, and g_c / spp P_end
//   geo[k, comp]       += valid (sum_c gP_c albedo[m, c] le_c / pi) dw/dcomp
//
// The geometry term needs prefix quantities and g only, so it is added in the
// forward round (the TPU kernel adds it in the sweep; the sum is the same).
//
// What bounds it on an H100: the forward kernel's FP32/SFU issue and
// divergence, then the reduction. On the TPU the grid runs in order and
// program (0, 0) zeroes the output; on the card the blocks run at once.
//
// What the design does about that:
//  * one thread per pixel, 32 x 8 blocks, forward rounds and stores shared
//    with the fused kernel (pt_phys.cuh);
//  * the reduction has two levels, both in this kernel: a block accumulates
//    into shared memory with float atomics (one (n_mat + 1) x 8 + K x 4 table a
//    block), then adds its table to the output in device memory with float
//    atomics. The wrapper zero-fills the output. The order of the additions
//    therefore changes from run to run and the result is reproducible to
//    float32 rounding, not bit for bit; the two levels keep any one
//    accumulator's chain short (about 5e4 terms a block at 64 spp, then one
//    term a block). The wrapper's tests hold it to rtol 2e-4, atol 1e-6
//    against the plain twin;
//  * built, as the fused kernel, for four blocks a multiprocessor
//    (__launch_bounds__(256, 4)): 64 registers and 200 bytes of spill where
//    ptxas alone takes 108 registers, and 19% faster (PERF.md);
//  * the NaN guard of the TPU kernel's sweep (stores of rounds that never
//    ran) has no counterpart: a thread sweeps only the rounds it ran.

#include "pt_phys.cuh"

namespace {

using namespace ptc;

// One pixel's cotangents into the block's shared table `acc`: rows of 8 per
// material, the sky's row, then rows of 4 per tracked emitter ordinal. `row`
// is the pixel's row in the block of rows from `row_start` (RowBlock,
// pt_common.cuh); `g` holds the block's rows.
template <bool kTriNee>
__device__ __forceinline__ void backward_pixel(
    const Tables& sc, const Emitters& em, const float* __restrict__ mat_eco,
    const Params& p, const float* __restrict__ g, float* acc, int n_em_cap, int row,
    int col, int row_start, int height, int width, int spp, int max_bounces, uint32_t seed,
    int sample_offset, int jitter, bool nee, float inv_spp) {
  const RowBlock rb(row, col, row_start, width);
  const uint32_t pix = rb.pix;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = rb.frow;
  const float inf = pos_inf();
  float* const geo = acc + 8 * (sc.n_mat + 1);

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);
  const float* gp = g + 3 * rb.local;
  const float g_r = gp[0] * inv_spp, g_g = gp[1] * inv_spp, g_b = gp[2] * inv_spp;

  RoundStores st;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky's cotangent
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    bool prevd = false;
    int n_rounds = 0;
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
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
      const LightSample& ls = rec.ls;
      if ((rec.event & kEvValid) && ls.row >= 0 && ls.ord < n_em_cap) {
        // The sampled sphere emitter's centre and radius, through w.
        float dw[4];
        cone_w_adjoint(sc.sph + ls.row * kSphStride, rec.sox, rec.soy, rec.soz, h.nx,
                       h.ny, h.nz, rec.v1, ls.cp, ls.sn, ls.pool_f, dw);
        const float cot_w = (g_r * pr * mt.alb_r * ls.ler + g_g * pg * mt.alb_g * ls.leg +
                             g_b * pb * mt.alb_b * ls.leb) * kInvPi;
#pragma unroll
        for (int comp = 0; comp < 4; ++comp) atomicAdd(geo + 4 * ls.ord + comp, cot_w * dw[comp]);
      }
      if (rec.event & kDied) break;
    }
    // The end of the budget: total += P_end * sky.
    k_r += g_r * q.tr;
    k_g += g_g * q.tg;
    k_b += g_b * q.tb;

    // -- sweep: last round down to 0, carrying S --
    float s_r = p.sky_r, s_g = p.sky_g, s_b = p.sky_b;
    for (int b = n_rounds - 1; b >= 0; --b) {
      const float gpr = g_r * st.pr[b], gpg = g_g * st.pg[b], gpb = g_b * st.pb[b];
      const int event = st.ev[b];
      if (event & kEvMiss) {
        k_r += gpr;
        k_g += gpg;
        k_b += gpb;
        s_r = p.sky_r;
        s_g = p.sky_g;
        s_b = p.sky_b;
        continue;
      }
      const int m = st.mat[b];
      const SweptHit sh = swept_hit(sc, em, st, b);
      const Material& mt = sh.mt;
      const float sh_r = ((event & kDied) ? 0.0f : s_r) + sh.nee_r;
      const float sh_g = ((event & kDied) ? 0.0f : s_g) + sh.nee_g;
      const float sh_b = ((event & kDied) ? 0.0f : s_b) + sh.nee_b;
      const float da_r = gpr * sh_r, da_g = gpg * sh_g, da_b = gpb * sh_b;
      const bool addle = (event & kEvAddLe) != 0;
      if (m >= 0 && m < sc.n_mat) {
        float* a = acc + 8 * m;
        atomicAdd(a + 0, da_r);
        atomicAdd(a + 1, da_g);
        atomicAdd(a + 2, da_b);
        if (addle) {
          const float es = em.mat_est[m];
          const float* eco = mat_eco + 3 * m;
          atomicAdd(a + 3, gpr * es);
          atomicAdd(a + 4, gpg * es);
          atomicAdd(a + 5, gpb * es);
          atomicAdd(a + 6, gpr * eco[0] + gpg * eco[1] + gpb * eco[2]);
        }
        const float cot_ratio = mt.alb_r * da_r + mt.alb_g * da_g + mt.alb_b * da_b;
        atomicAdd(a + 7, cot_ratio * ratio_dr(mt, event));
      }
      if (sh.valid && sh.emat >= 0 && sh.emat < sc.n_mat) {
        // The sampled emitter's radiance le = eco * est of its material.
        const float dle_r = gpr * mt.alb_r * kInvPi * sh.w;
        const float dle_g = gpg * mt.alb_g * kInvPi * sh.w;
        const float dle_b = gpb * mt.alb_b * kInvPi * sh.w;
        const float es = em.mat_est[sh.emat];
        const float* eco = mat_eco + 3 * sh.emat;
        float* a = acc + 8 * sh.emat;
        atomicAdd(a + 3, dle_r * es);
        atomicAdd(a + 4, dle_g * es);
        atomicAdd(a + 5, dle_b * es);
        atomicAdd(a + 6, dle_r * eco[0] + dle_g * eco[1] + dle_b * eco[2]);
      }
      s_r = (addle ? mt.em_r : 0.0f) + mt.alb_r * sh_r;
      s_g = (addle ? mt.em_g : 0.0f) + mt.alb_g * sh_g;
      s_b = (addle ? mt.em_b : 0.0f) + mt.alb_b * sh_b;
    }
  }
  float* sky = acc + 8 * sc.n_mat;
  atomicAdd(sky + 0, k_r);
  atomicAdd(sky + 1, k_g);
  atomicAdd(sky + 2, k_b);
}

template <bool kTriNee>
__global__ void __launch_bounds__(256, 4)
render_phys_bwd_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                       int n_sph, const float* __restrict__ tri,
                       const int* __restrict__ tri_m, int n_tri,
                       const float* __restrict__ mat, int n_mat,
                       const int* __restrict__ em_list, const float* __restrict__ le_sph,
                       const int* __restrict__ tri_list, const float* __restrict__ le_tri,
                       const float* __restrict__ tri_area,
                       const float* __restrict__ mat_est,
                       const float* __restrict__ mat_eco,
                       const int* __restrict__ counts, const float* __restrict__ par,
                       const float* __restrict__ g, float* out, float* geo_out, int nee,
                       int n_em_cap, int height, int width, int row_start, int rows,
                       int spp, int max_bounces, uint32_t seed, int sample_offset,
                       int jitter, float inv_spp) {
  extern __shared__ float acc[];
  const int n_out = 8 * (n_mat + 1);
  const int n_acc = n_out + 4 * max(n_em_cap, 1);
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < n_acc; i += n_threads) acc[i] = 0.0f;
  __syncthreads();
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;  // in the block of rows
  if (col < width && row < rows) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est,
                         counts[0], counts[1]};
    backward_pixel<kTriNee>(sc, em, mat_eco, p, g, acc, n_em_cap, row, col, row_start,
                            height, width, spp, max_bounces, seed, sample_offset, jitter,
                            nee != 0, inv_spp);
  }
  __syncthreads();
  // The block's table into the output: one atomic per entry that is not zero.
  for (int i = tid; i < n_acc; i += n_threads) {
    const float v = acc[i];
    if (v != 0.0f) atomicAdd(i < n_out ? out + i : geo_out + (i - n_out), v);
  }
}

}  // namespace

// C entry, bound with ctypes. Tables, emitter tables, `counts` and `par` as
// for render_phys; `mat_eco` is (n_mat, 3) float32, the raw emission colours;
// `g` is (rows, width, 3) float32, the cotangent of the block of `rows` rows
// from `row_start` of the height x width image, whose pixels the kernel
// replays; `out` is (n_mat +
// 1, 8) float32 and `geo_out` (max(n_em_cap, 1), 4) float32, both zero-filled
// by the caller. Launches on `stream` of device `device` and returns
// cudaGetLastError(), or cudaErrorInvalidValue if max_bounces is above the
// cap.
extern "C" int render_phys_bwd(const float* sph, const int* sph_m, int n_sph,
                               const float* tri, const int* tri_m, int n_tri,
                               const float* mat, int n_mat, const int* em_list,
                               const float* le_sph, const int* tri_list,
                               const float* le_tri, const float* tri_area,
                               const float* mat_est, const float* mat_eco,
                               const int* counts, const float* par, const float* g,
                               float* out, float* geo_out, int nee, int tri_nee,
                               int n_em_cap, int height, int width, int row_start,
                               int rows, int spp, int max_bounces, unsigned int seed,
                               int sample_offset, int jitter, int device, void* stream) {
  if (max_bounces + 1 > kMaxRounds || n_em_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (rows + block.y - 1) / block.y);
  const size_t shared = sizeof(float) * (8 * (n_mat + 1) + 4 * (n_em_cap > 0 ? n_em_cap : 1));
  auto kernel = tri_nee ? render_phys_bwd_kernel<true> : render_phys_bwd_kernel<false>;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, block, shared, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
      le_tri, tri_area, mat_est, mat_eco, counts, par, g, out, geo_out, nee, n_em_cap,
      height, width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
