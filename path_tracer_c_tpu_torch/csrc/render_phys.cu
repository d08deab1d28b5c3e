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
// The device functions (the light sample, one bounce) live in pt_phys.cuh,
// where the physical tier's gradient kernels share them.
//
// Numerics: see pt_common.cuh. The distance to the sampled emitter is the
// full-b quadratic of ops/intersect.ray_sphere_t, not the scans' half-b
// form: the visibility test compares it with the scan's distance and sits
// on a knife edge for rays at the cone's rim.

#include "pt_phys.cuh"

namespace {

using namespace ptc;

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
      shade_phys<kCount, kTriNee>(sc, em, h, mt, fetch_est(sc, em, h.m), nee, q, prevd, ev);
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
