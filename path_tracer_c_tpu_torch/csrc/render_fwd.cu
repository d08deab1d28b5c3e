// Forward render megakernel for Hopper (sm_90a): reference-tier path tracing.
//
// Replaces the Pallas TPU kernel `_kernel` of
// path_tracer_c_tpu/ops/pallas_kernels.py. It computes the same function:
// for every pixel, spp samples of (max_bounces + 1) rounds of closest hit
// -> emission -> albedo -> roughness-perturbed normal -> reflect or
// refract, the sky on a miss and when the budget runs out, and the mean
// over samples. The per-round device functions are in pt_common.cuh, which
// the fused primal + Jacobian kernel (render_fused.cu) shares.
//
// What bounds it on an H100: FP32 and SFU issue (every bounce scans the
// whole scene table, with a sqrt per sphere and a divide per triangle) and
// branch divergence (neighbouring pixels leave the scene at different
// bounces), not bytes: the only traffic to device memory is the scene
// tables, which stay in L1/L2, and 12 bytes of radiance per pixel.
//
// What the design does about that:
//  * one thread per pixel, every per-ray quantity in registers; blocks of
//    8 x 16 pixels whose warps are 4 x 8 (FwdTile), the launch shape a
//    policy (pt_sched.cuh Tile) that the sweep library instantiates at its
//    other points; no divisibility rule, the ragged edge is masked;
//  * termination is zero throughput, as in the TPU kernel. A thread stops
//    a sample's rounds once its throughput is exactly zero: every round it
//    skips would add only exact zeros. This per-thread exit takes the
//    place of the TPU kernel's whole-tile sky gate and bounce-0 hoist,
//    which are TPU scheduling choices;
//  * the half-b sphere quadratic, select-then-normalize sphere normals and
//    face normals precomputed by the wrapper, as in the TPU kernel;
//  * render_pixel takes its schedule (a warp waits for its longest lane at
//    the end of each sample, or path regeneration) and the tables' place
//    (device memory, or staged into shared memory by the block) as
//    policies (pt_sched.cuh). The timed kernel is one combination;
//    render_fwd_variant launches the others, which no user path runs: they
//    price the kernel's schedule and table reads against itself (PERF.md).
//
// kCount is the TPU kernel's `count_rounds`, as a second instantiation of
// each combination so that the timed kernel carries no counter: it adds the
// bounce rounds every thread ran (thread-rounds) to counter[0], and to
// counter[1] the rounds every warp ran times its lanes in the image (warp
// lane-rounds) under the combination's schedule, the warp's counterpart of
// the TPU's tile rounds: the warp votes on every round, so the count does
// not depend on scheduling. Numerics: see pt_common.cuh.

#include "pt_sched.cuh"

namespace {

using namespace ptc;

// The timed kernel's combination of policies, at B1's default point.
using KernelPolicy = FwdPolicy<Regen, SharedTables, FwdTile>;

// One pixel's radiance into `out` (lanes in the image only), its rounds into
// `counts` (kCount). Every lane of the warp calls it. `row` is the pixel's row
// in the block of rows from `row_start` (RowBlock, pt_common.cuh).
template <bool kCount, class Pol>
__device__ __forceinline__ void render_pixel(const Tables& sc, const Params& p,
                                            float* __restrict__ out, bool in_range,
                                            int row, int col, int row_start, int height,
                                            int width, int spp, int max_bounces,
                                            uint32_t seed, int sample_offset, int jitter,
                                            float inv_spp, unsigned lanes,
                                            RoundCounts& counts) {
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
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  run_samples<typename Pol::Sched, kCount>(
      in_range, lanes, spp, max_bounces,
      [&](int s) {
        q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                       static_cast<uint32_t>(s + sample_offset), seed, jitter);
      },
      [&]() -> int {
        const Hit h = closest_hit(sc, q);
        if (!(h.t < inf)) {
          shade_miss(p, q);
          return kRoundEnded;
        }
        const Material mt = fetch_material(sc, h.m);
        shade(h, mt, q);
        // Exact early exit: with zero throughput every later round adds 0.
        return (q.tr == 0.0f && q.tg == 0.0f && q.tb == 0.0f) ? kRoundEnded : 0;
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

template <bool kCount, class Pol>
__global__ void __launch_bounds__(Pol::Shape::kThreads, kFwdBlocks<Pol>)
render_fwd_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                  int n_sph, const float* __restrict__ tri,
                  const int* __restrict__ tri_m, int n_tri,
                  const float* __restrict__ mat, int n_mat,
                  const float* __restrict__ par, float* __restrict__ out,
                  unsigned long long* counter, int height, int width, int row_start,
                  int rows, int spp, int max_bounces, uint32_t seed, int sample_offset,
                  int jitter, float inv_spp) {
  using Tl = typename Pol::Shape;
  extern __shared__ uint4 smem[];
  int row, col;  // row: in the block of rows
  Tl::pixel(row, col);
  const bool in_range = col < width && row < rows;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes = kCount ? __ballot_sync(kFullWarp, in_range) : 0u;
  Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
  if constexpr (Pol::Tab::kShared) {
    uint32_t* dst = reinterpret_cast<uint32_t*>(smem);
    stage_tables<Tl>(sc, dst);
    __syncthreads();
  }
  const Params p = *reinterpret_cast<const Params*>(par);
  RoundCounts counts;
  render_pixel<kCount, Pol>(sc, p, out, in_range, row, col, row_start, height, width, spp,
                            max_bounces, seed, sample_offset, jitter, inv_spp, lanes,
                            counts);
  if (kCount) {
    block_add<Tl>(counts.thread, counter);
    block_add<Tl>(counts.warp, counter + 1);
  }
}

// Launch render_fwd_kernel<kCount, Pol>; returns cudaGetLastError(), or
// cudaErrorInvalidValue where Pol stages tables above kSharedTableBudget.
template <bool kCount, class Pol>
int launch(const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
           int n_tri, const float* mat, int n_mat, const float* par, float* out,
           unsigned long long* counter, int height, int width, int row_start, int rows, int spp,
           int max_bounces, unsigned int seed, int sample_offset, int jitter, int device,
           void* stream) {
  const size_t smem =
      Pol::Tab::kShared ? 4 * static_cast<size_t>(table_words(n_sph, n_tri, n_mat, false)) : 0;
  if (smem > kSharedTableBudget) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float32(1.0 / spp), rounded from double as the JAX package does.
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  using Tl = typename Pol::Shape;
  render_fwd_kernel<kCount, Pol><<<Tl::grid(rows, width), Tl::block(), smem,
                                   static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, counter, height, width,
      row_start, rows, spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}

using Launch = decltype(&launch<false, KernelPolicy>);

// The launch of policy Pol, with or without its counter; nullptr where Pol
// stages tables above the budget.
template <class Pol>
Launch pick(bool count, int n_sph, int n_tri, int n_mat) {
  if (Pol::Tab::kShared && 4 * table_words(n_sph, n_tri, n_mat, false) > kSharedTableBudget)
    return nullptr;
  return count ? launch<true, Pol> : launch<false, Pol>;
}

}  // namespace

#ifndef PT_TILE_POINT
// Bytes of the tables a block stages in shared memory (pt_sched.cuh
// table_words; `physical`: with the emitter tables), and the most it
// stages; the wrappers ask, to agree with ops/render_kernel.py.
extern "C" int render_table_bytes(int n_sph, int n_tri, int n_mat, int physical) {
  return 4 * table_words(n_sph, n_tri, n_mat, physical != 0);
}
extern "C" int render_table_budget() { return kSharedTableBudget; }

// C entry, bound with ctypes. Pointers are device pointers of contiguous
// float32/int32 tables and the kNumParams camera/sky floats, packed by
// ops/render_kernel.py; `out` is (rows, width, 3) float32, the block of
// `rows` rows from `row_start` of the height x width image. `counter` is
// null, or two zeroed int64 that receive the executed thread-rounds and warp
// lane-rounds (the counting instantiation runs then). Launches on `stream` of device
// `device` and returns cudaGetLastError().
extern "C" int render_fwd(const float* sph, const int* sph_m, int n_sph,
                          const float* tri, const int* tri_m, int n_tri,
                          const float* mat, int n_mat, const float* par,
                          float* out, unsigned long long* counter, int height,
                          int width, int row_start, int rows, int spp, int max_bounces,
                          unsigned int seed, int sample_offset, int jitter,
                          int device, void* stream) {
  // Above the budget, the kernel with its tables in device memory.
  Launch go = pick<KernelPolicy>(counter != nullptr, n_sph, n_tri, n_mat);
  if (!go) go = pick<GlobalTablesOf<KernelPolicy>>(counter != nullptr, n_sph, n_tri, n_mat);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, counter, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}

// A measurement instantiation of render_fwd (pt_sched.cuh `FwdVariant`), with
// render_fwd's arguments; `counter` as there, the warp lane-rounds of the
// variant's schedule. Returns cudaErrorInvalidValue for an unknown variant,
// or one that stages tables above the budget.
extern "C" int render_fwd_variant(int variant, const float* sph, const int* sph_m, int n_sph,
                                  const float* tri, const int* tri_m, int n_tri,
                                  const float* mat, int n_mat, const float* par, float* out,
                                  unsigned long long* counter, int height, int width,
                                  int row_start, int rows, int spp, int max_bounces,
                                  unsigned int seed, int sample_offset, int jitter,
                                  int device, void* stream) {
  const bool count = counter != nullptr;
  Launch go = nullptr;
  switch (variant) {
    case kVarPerSample:
      go = pick<PerSampleOf<KernelPolicy>>(count, n_sph, n_tri, n_mat);
      break;
    case kVarGlobalTables:
      go = pick<GlobalTablesOf<KernelPolicy>>(count, n_sph, n_tri, n_mat);
      break;
  }
  if (!go) return static_cast<int>(cudaErrorInvalidValue);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, counter, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}

#else
// The sweep library's entry at point PT_TILE_POINT (pt_sched.cuh TileAt):
// render_fwd's arguments and fallback at that launch shape.
extern "C" int PT_TILED(render_fwd)(const float* sph, const int* sph_m, int n_sph,
                                    const float* tri, const int* tri_m, int n_tri,
                                    const float* mat, int n_mat, const float* par, float* out,
                                    unsigned long long* counter, int height, int width,
                                    int row_start, int rows, int spp, int max_bounces,
                                    unsigned int seed, int sample_offset, int jitter,
                                    int device, void* stream) {
  using Pol = TiledOf<KernelPolicy, TileAt<PT_TILE_POINT>>;
  Launch go = pick<Pol>(counter != nullptr, n_sph, n_tri, n_mat);
  if (!go) go = pick<GlobalTablesOf<Pol>>(counter != nullptr, n_sph, n_tri, n_mat);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, counter, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}
#endif
