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
//  * one thread per pixel, blocks of 8 x 32 pixels (the launch shape a
//    policy, pt_sched.cuh Tile), every per-ray quantity in
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
//    run-time branch;
//  * render_pixel takes its schedule (a warp waits for its longest lane at
//    the end of each sample, or path regeneration) and the place of the
//    scene and emitter tables (device memory, or staged into shared memory
//    by the block) as policies (pt_sched.cuh), as render_fwd.cu does. The
//    timed kernel is one combination; render_phys_variant launches the
//    others, which no user path runs: they price the kernel's schedule and
//    table reads against itself (PERF.md).
//
// The device functions (the light sample, one bounce) live in pt_phys.cuh,
// where the physical tier's gradient kernels share them.
//
// Numerics: see pt_common.cuh. The distance to the sampled emitter is the
// full-b quadratic of ops/intersect.ray_sphere_t, not the scans' half-b
// form: the visibility test compares it with the scan's distance and sits
// on a knife edge for rays at the cone's rim.

#include "pt_phys.cuh"
#include "pt_sched.cuh"

namespace {

using namespace ptc;

// The timed kernel's combination of policies.
using KernelPolicy = FwdPolicy<Regen, SharedTables>;

// What the counting instantiation adds to its counter, in this order: the
// thread-rounds, the diffuse vertices, light samples and shadow scans among
// them (kEvDiffuse.. of pt_phys.cuh), and the warp lane-rounds, those in which
// some lane computed a light sample, and ran a shadow scan (RoundCounts).
constexpr int kNumCounters = 7;

// Point `em` at copies of its tables in shared memory from `dst` on
// (pt_sched.cuh stage); row counts as the wrapper packs them.
template <class Tl>
__device__ __forceinline__ void stage_emitters(Emitters& em, const Tables& sc,
                                               uint32_t*& dst) {
  em.em_list = stage<Tl>(em.em_list, sc.n_sph, dst);
  em.le_sph = stage<Tl>(em.le_sph, 3 * sc.n_sph, dst);
  em.tri_list = stage<Tl>(em.tri_list, sc.n_tri, dst);
  em.le_tri = stage<Tl>(em.le_tri, 3 * sc.n_tri, dst);
  em.tri_area = stage<Tl>(em.tri_area, sc.n_tri, dst);
  em.mat_est = stage<Tl>(em.mat_est, sc.n_mat, dst);
}

// One pixel's radiance into `out` (lanes in the image only); with kCount its
// events into `ev` and its rounds into `counts`. Every lane of the warp calls
// it. `row` is the pixel's row in the block of rows from `row_start`
// (RowBlock, pt_common.cuh).
template <bool kCount, bool kTriNee, class Pol>
__device__ __forceinline__ void render_pixel(const Tables& sc, const Emitters& em,
                                            const Params& p, float* __restrict__ out,
                                            bool in_range, int row, int col, int row_start,
                                            int height, int width, int spp, int max_bounces,
                                            uint32_t seed, int sample_offset, int jitter,
                                            bool nee, float inv_spp, unsigned lanes,
                                            int* ev, RoundCounts& counts) {
  const RowBlock rb(row, col, row_start, width);
  const uint32_t pix = rb.pix;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = rb.frow;
  const float inf = pos_inf();

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  Path q;
  bool prevd = false;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  run_samples<typename Pol::Sched, kCount>(
      in_range, lanes, spp, max_bounces,
      [&](int s) {
        q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                       static_cast<uint32_t>(s + sample_offset), seed, jitter);
        prevd = false;
      },
      [&]() -> int {
        const int light0 = ev[kEvLight], shadow0 = ev[kEvShadow];
        const Hit h = closest_hit(sc, q);
        if (!(h.t < inf)) {
          shade_miss(p, q);
          return kRoundEnded;
        }
        const Material mt = fetch_material(sc, h.m);
        shade_phys<kCount, kTriNee>(sc, em, h, mt, fetch_est(sc, em, h.m), nee, q, prevd, ev);
        // Exact early exit: with zero throughput every later round adds 0.
        int bits = (q.tr == 0.0f && q.tg == 0.0f && q.tb == 0.0f) ? kRoundEnded : 0;
        if (kCount) {
          if (ev[kEvLight] != light0) bits |= kRoundLight;
          if (ev[kEvShadow] != shadow0) bits |= kRoundShadow;
        }
        return bits;
      },
      [&]() {
        shade_end(p, q);
        acc_r += q.ar;
        acc_g += q.ag;
        acc_b += q.ab;
      },
      counts);
  if (in_range) {
    float* o = out + 3 * rb.local;
    o[0] = acc_r * inv_spp;
    o[1] = acc_g * inv_spp;
    o[2] = acc_b * inv_spp;
  }
}

// Registers: as many threads a multiprocessor at every tile (min_blocks).
template <class Pol>
constexpr int kFwdBlocks = min_blocks<typename Pol::Shape, kFwdMinBlocks>();

template <bool kCount, bool kTriNee, class Pol>
__global__ void __launch_bounds__(Pol::Shape::kThreads, kFwdBlocks<Pol>)
render_phys_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                   int n_sph, const float* __restrict__ tri,
                   const int* __restrict__ tri_m, int n_tri,
                   const float* __restrict__ mat, int n_mat,
                   const int* __restrict__ em_list, const float* __restrict__ le_sph,
                   const int* __restrict__ tri_list, const float* __restrict__ le_tri,
                   const float* __restrict__ tri_area, const float* __restrict__ mat_est,
                   const int* __restrict__ counts, const float* __restrict__ par,
                   float* __restrict__ out, unsigned long long* counter, int nee,
                   int height, int width, int row_start, int rows, int spp,
                   int max_bounces, uint32_t seed, int sample_offset, int jitter,
                   float inv_spp) {
  using Tl = typename Pol::Shape;
  extern __shared__ uint4 smem[];
  int row, col;  // row: in the block of rows
  Tl::pixel(row, col);
  const bool in_range = col < width && row < rows;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes = kCount ? __ballot_sync(kFullWarp, in_range) : 0u;
  Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
  Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est, counts[0], counts[1]};
  if constexpr (Pol::Tab::kShared) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    stage_tables<Tl>(sc, dst);
    stage_emitters<Tl>(em, sc, dst);
    __syncthreads();
  }
  const Params p = *reinterpret_cast<const Params*>(par);
  int ev[kNumEvents] = {0, 0, 0, 0};
  RoundCounts rc;
  render_pixel<kCount, kTriNee, Pol>(sc, em, p, out, in_range, row, col, row_start, height,
                                     width, spp, max_bounces, seed, sample_offset, jitter,
                                     nee != 0, inv_spp, lanes, ev, rc);
  if (kCount) {
    block_add<Tl>(rc.thread, counter);
#pragma unroll
    for (int i = kEvDiffuse; i < kNumEvents; ++i) block_add<Tl>(ev[i], counter + i);
    block_add<Tl>(rc.warp, counter + kNumEvents);
    block_add<Tl>(rc.warp_light, counter + kNumEvents + 1);
    block_add<Tl>(rc.warp_shadow, counter + kNumEvents + 2);
  }
}

// Launch render_phys_kernel<kCount, kTriNee, Pol>; returns
// cudaGetLastError(), or cudaErrorInvalidValue where Pol stages tables above
// kSharedTableBudget.
template <bool kCount, bool kTriNee, class Pol>
int launch(const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
           int n_tri, const float* mat, int n_mat, const int* em_list, const float* le_sph,
           const int* tri_list, const float* le_tri, const float* tri_area,
           const float* mat_est, const int* counts, const float* par, float* out,
           unsigned long long* counter, int nee, int height, int width, int row_start,
           int rows, int spp, int max_bounces, unsigned int seed, int sample_offset, int jitter,
           int device, void* stream) {
  const size_t smem =
      Pol::Tab::kShared ? 4 * static_cast<size_t>(table_words(n_sph, n_tri, n_mat, true)) : 0;
  if (smem > kSharedTableBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float32(1.0 / spp), rounded from double as the JAX package does.
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  using Tl = typename Pol::Shape;
  render_phys_kernel<kCount, kTriNee, Pol><<<Tl::grid(rows, width), Tl::block(), smem,
                                             static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list, le_tri,
      tri_area, mat_est, counts, par, out, counter, nee, height, width, row_start, rows, spp,
      max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}

using Launch = decltype(&launch<false, false, KernelPolicy>);

template <class Pol>
Launch with_flags(bool count, bool tri_nee) {
  return count ? (tri_nee ? launch<true, true, Pol> : launch<true, false, Pol>)
               : (tri_nee ? launch<false, true, Pol> : launch<false, false, Pol>);
}

// The launch of policy Pol; nullptr where Pol stages tables above the budget.
template <class Pol>
Launch pick(bool count, bool tri_nee, int n_sph, int n_tri, int n_mat) {
  if (Pol::Tab::kShared && 4 * table_words(n_sph, n_tri, n_mat, true) > kSharedTableBudget)
    return nullptr;
  return with_flags<Pol>(count, tri_nee);
}

}  // namespace

#ifndef PT_TILE_POINT
// C entry, bound with ctypes. The scene tables and `par` are those of
// render_fwd; the emitter tables and `counts` = (n_em, n_em_t), two int32
// on the device, are packed by ops/render_physical.py. `out` is (rows,
// width, 3) float32, the block of `rows` rows from `row_start` as for
// render_fwd. `counter` is null, or kNumCounters zeroed int64 that
// receive the executed thread-rounds, the diffuse vertices among them, the
// light samples computed, the shadow scans run, and the warp lane-rounds,
// those with a light sample and those with a shadow scan (the counting
// instantiation runs then). `nee` switches next-event estimation, `tri_nee`
// adds emissive triangles to the pool. Launches on `stream` of device
// `device` and returns cudaGetLastError().
extern "C" int render_phys(const float* sph, const int* sph_m, int n_sph,
                           const float* tri, const int* tri_m, int n_tri,
                           const float* mat, int n_mat, const int* em_list,
                           const float* le_sph, const int* tri_list,
                           const float* le_tri, const float* tri_area,
                           const float* mat_est, const int* counts,
                           const float* par, float* out,
                           unsigned long long* counter, int nee, int tri_nee,
                           int height, int width, int row_start, int rows, int spp,
                           int max_bounces, unsigned int seed, int sample_offset,
                           int jitter, int device, void* stream) {
  // Above the budget, the kernel with its tables in device memory.
  const bool count = counter != nullptr, tn = tri_nee != 0;
  Launch go = pick<KernelPolicy>(count, tn, n_sph, n_tri, n_mat);
  if (!go) go = pick<GlobalTablesOf<KernelPolicy>>(count, tn, n_sph, n_tri, n_mat);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, out, counter, nee, height, width,
            row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device, stream);
}

// A measurement instantiation of render_phys (pt_sched.cuh `FwdVariant`),
// with render_phys's arguments; `counter` as there, the warp lane-rounds of
// the variant's schedule. Returns cudaErrorInvalidValue for an unknown
// variant, or one that stages tables above the budget.
extern "C" int render_phys_variant(int variant, const float* sph, const int* sph_m, int n_sph,
                                   const float* tri, const int* tri_m, int n_tri,
                                   const float* mat, int n_mat, const int* em_list,
                                   const float* le_sph, const int* tri_list,
                                   const float* le_tri, const float* tri_area,
                                   const float* mat_est, const int* counts, const float* par,
                                   float* out, unsigned long long* counter, int nee,
                                   int tri_nee, int height, int width, int row_start,
                                   int rows, int spp, int max_bounces, unsigned int seed,
                                   int sample_offset, int jitter, int device,
                                   void* stream) {
  const bool count = counter != nullptr, tn = tri_nee != 0;
  Launch go = nullptr;
  switch (variant) {
    case kVarPerSample:
      go = pick<PerSampleOf<KernelPolicy>>(count, tn, n_sph, n_tri, n_mat);
      break;
    case kVarGlobalTables:
      go = pick<GlobalTablesOf<KernelPolicy>>(count, tn, n_sph, n_tri, n_mat);
      break;
  }
  if (!go) return static_cast<int>(cudaErrorInvalidValue);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, out, counter, nee, height, width,
            row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device, stream);
}

#else
// The sweep library's entry at point PT_TILE_POINT (pt_sched.cuh TileAt):
// render_phys's arguments and fallback at that launch shape.
extern "C" int PT_TILED(render_phys)(const float* sph, const int* sph_m, int n_sph,
                                     const float* tri, const int* tri_m, int n_tri,
                                     const float* mat, int n_mat, const int* em_list,
                                     const float* le_sph, const int* tri_list,
                                     const float* le_tri, const float* tri_area,
                                     const float* mat_est, const int* counts, const float* par,
                                     float* out, unsigned long long* counter, int nee,
                                     int tri_nee, int height, int width, int row_start,
                                     int rows, int spp, int max_bounces, unsigned int seed,
                                     int sample_offset, int jitter, int device, void* stream) {
  using Pol = TiledOf<KernelPolicy, TileAt<PT_TILE_POINT>>;
  const bool count = counter != nullptr, tn = tri_nee != 0;
  Launch go = pick<Pol>(count, tn, n_sph, n_tri, n_mat);
  if (!go) go = pick<GlobalTablesOf<Pol>>(count, tn, n_sph, n_tri, n_mat);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, out, counter, nee, height, width,
            row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device, stream);
}
#endif
