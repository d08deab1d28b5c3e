// Fused primal + Jacobian kernel for Hopper (sm_90a): the forward pass of
// the reference tier's gradient.
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// path_tracer_c_tpu/ops/pallas_grad.py. One launch emits the radiance
// image, equal bit for bit to render_fwd.cu's, and a per-pixel Jacobian of
// 9 * n_mat + 3 planes from which the backward pass is a contraction with
// the image cotangent (ops/render_grad.py `contract_jacobian`). Per sample,
// radiance is sum_b P_b * E_b + P_end * sky, with P_b the throughput before
// bounce b and E_b the emission there (the sky on a miss). The planes are,
// per material m and colour c, summed over samples and bounces that hit m:
//
//   A[m, c] += P_b[c] * T_b[c]          (albedo)
//   S[m, c] += P_b[c]                   (emission)
//   R[m, c] += P_b[c] * T_b[c] * dr_b   (transparency: dr = 1/t where the
//                                        path refracted, -1/(1-t) where it
//                                        reflected)
//   K[c]    += P_b[c] on a miss, and P_end[c]   (sky)
//
// T_b is the radiance collected after bounce b per unit of throughput. It
// is built by a sweep from the path's last round down to 0: it starts as
// the sky, is zeroed where the path died of total internal reflection,
// becomes the sky at a miss, and T_{b-1} = Le_b + albedo_b * T_b at a hit.
//
// What bounds it on an H100: the forward kernel's FP32/SFU issue and
// divergence, plus the read-modify-writes of the Jacobian planes: 9 floats
// per swept hit, to planes far too many for registers (138 at 15
// materials, 300 at 33). Counted once each way the planes are only
// (9 n_mat + 3) * H * W * 4 bytes; the repeated traffic is what the caches
// have to absorb.
//
// What the design does about that:
//  * one thread per pixel, as the forward kernel. The TPU kernel updates
//    every material's planes under a mask, since a vector lane cannot
//    index; a thread adds into the 9 planes of the one material it hit;
//  * the planes live in device memory, plane-major (n_j, H, W): a warp's
//    32 pixels are 32 neighbouring floats of a plane, and a thread owns
//    its pixel, so the adds need no atomics. The wrapper zero-fills the
//    planes (torch.zeros); the kernel only adds. The 3 sky planes are kept
//    in registers and stored once;
//  * the forward rounds store, per bounce, the throughput before it, the
//    material index (int16) and one byte of events: 15 bytes, in dynamic
//    shared memory sized by max_bounces + 1 at launch (35 KB a block at 8
//    bounces, 123 KB at the cap), a field an array with the block's threads
//    side by side, so that a warp's accesses fall in distinct banks: the
//    kernel ran 3.4% under its parent with them in local memory at 1024^2,
//    64 spp, 8 bounces, and 1.2% under it at 256^2, 8 spp, 3 bounces
//    (PERF.md). Albedo, emission and transparency are read again from the
//    material table in the sweep rather than stored. The wrapper raises
//    above kMaxRounds rounds and 32767 materials;
//  * the bounce loop ends only on a structural death, a miss or total
//    internal reflection, never on zero throughput: a path that an
//    exactly black albedo killed still owes d_albedo = g * P_b * T_b, built
//    from the rounds after it. Those extra rounds add exact zeros to the
//    radiance. The sweep visits only the rounds the thread ran.
//
// kCount is the TPU kernel's `count_rounds`, as a second instantiation so
// that the timed kernel carries no counter: it adds the bounce rounds every
// thread ran (thread-rounds) to counter[0], and to counter[1] the warp
// lane-rounds, as render_fwd.cu counts them: after each sample's forward
// rounds a warp's in-range lanes take the longest lane's rounds
// (__reduce_max_sync), times their number. Every lane of a warp waits at
// the end of a sample for its longest path; PERF.md has the share of lane
// slots that idles so.
//
// The kernel is built for four blocks of 256 threads a multiprocessor
// (__launch_bounds__(256, 4)): 64 registers a thread, as ptxas chose unasked,
// with fewer spills (PERF.md); at another tile for as many threads
// (pt_sched.cuh min_blocks).
//
// render_pixel takes its records, its plane adds and its loops as a policy
// (pt_fused.cuh): render_fused_variant launches the measurement
// instantiations, each one policy away from the kernel (the plane adds into
// one register, the records in registers, the records in local memory). No
// user path runs them; they price parts of the kernel's time (PERF.md).
// Numerics: see pt_common.cuh.

#include "pt_fused.cuh"

namespace {

using namespace ptc;

// Most bounce rounds a thread can store: max_bounces + 1 <= kMaxRounds.
constexpr int kMaxRounds = 32;
// Most materials: the records in shared memory hold a material as int16.
constexpr int kMaxMaterials = 32767;

constexpr unsigned char kEvMiss = 4;  // beside kRefracted and kDied

// The per-bounce records of a sample: the throughput before the round, the
// material it hit and its events. The kernel keeps them in dynamic shared
// memory, sized by max_bounces + 1 at launch (SharedRecords); its
// measurement instantiations in thread-private arrays of kN rounds
// (LocalRecords: local memory, or registers where every index is a
// constant).
template <int kN>
struct LocalRecords {
  static constexpr bool kShared = false;
  float pr[kN], pg[kN], pb[kN];
  int mat[kN];
  unsigned char ev[kN];
  __device__ __forceinline__ void place(unsigned char*, int) {}
};

// In a block of tile Tl (pt_sched.cuh): (max_bounces + 1) * Tl::kThreads *
// kRoundBytes bytes.
template <class Tl>
struct SharedRecords {
  static constexpr bool kShared = true;
  static constexpr int kRoundBytes = 3 * 4 + 2 + 1;
  SmemField<float, Tl> pr, pg, pb;
  SmemField<short, Tl> mat;
  SmemField<unsigned char, Tl> ev;
  // The fields of `rounds` rounds, one after another from `base`.
  __device__ __forceinline__ void place(unsigned char* base, int rounds) {
    pr = smem_field<float, Tl>(base, rounds);
    pg = smem_field<float, Tl>(base, rounds);
    pb = smem_field<float, Tl>(base, rounds);
    mat = smem_field<short, Tl>(base, rounds);
    ev = smem_field<unsigned char, Tl>(base, rounds);
  }
};

// The timed kernel at launch shape Tl (the sweep library's instantiations),
// the timed kernel, and its measurement instantiations (pt_fused.cuh).
template <class Tl>
using KernelPolicyAt = Policy<SharedRecords<Tl>, PlaneAdds, 0, 4, LaneLoops, kSlotsDevice, Tl>;
using KernelPolicy = KernelPolicyAt<DefaultTile>;
using SinkPolicy = Policy<SharedRecords<DefaultTile>, PlaneSink, 0, 4>;
using RegistersPolicy = Policy<LocalRecords<kRegisterRounds>, PlaneAdds, kRegisterRounds, 1>;
using MovedPolicy = Policy<LocalRecords<kMaxRounds>, PlaneAdds, 0, 4>;

// One pixel's radiance into `img` and Jacobian into the planes of `jac`
// (plane stride `hw`, the pixels of the block); returns the bounce rounds it
// ran. `row` is the pixel's row in the block of rows from `row_start`
// (RowBlock, pt_common.cuh). `smem` is the block's dynamic shared memory.
template <bool kCount, class Pol>
__device__ __forceinline__ int render_pixel(const Tables& sc, const Params& p,
                                            float* __restrict__ img,
                                            float* __restrict__ jac, size_t hw,
                                            int row, int col, int row_start, int height,
                                            int width, int spp, int max_bounces,
                                            uint32_t seed, int sample_offset,
                                            int jitter, float inv_spp, unsigned lanes,
                                            int& warp_rounds, unsigned char* smem) {
  const RowBlock rb(row, col, row_start, width);
  const uint32_t pix = rb.pix;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = rb.frow;
  const float inf = pos_inf();

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  // Per-bounce stores of the current sample.
  typename Pol::Records st;
  st.place(smem, max_bounces + 1);
  typename Pol::Adds adds;

  int rounds = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky planes
  float* const jpix = jac + rb.local;
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    // -- forward rounds, storing what the sweep needs --
    const int n_rounds = forward_rounds<Pol::kUnroll>(max_bounces, [&](int bounce) {
      const Hit h = closest_hit(sc, q);
      st.pr[bounce] = q.tr;
      st.pg[bounce] = q.tg;
      st.pb[bounce] = q.tb;
      st.mat[bounce] = h.m;
      if (!(h.t < inf)) {
        st.ev[bounce] = kEvMiss;
        shade_miss(p, q);
        return true;
      }
      const Material mt = fetch_material(sc, h.m);
      const int event = shade(h, mt, q);
      st.ev[bounce] = static_cast<unsigned char>(event);
      // Structural death only; zero throughput goes on (see above).
      return (event & kDied) != 0;
    });
    if (kCount) {
      rounds += n_rounds;
      count_warp_rounds(lanes, n_rounds, warp_rounds);
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

    // -- sweep: last round down to 0, carrying T --
    float t_r = p.sky_r, t_g = p.sky_g, t_b = p.sky_b;
    sweep_rounds<Pol::kUnroll>(n_rounds, [&](int b) {
      const float pr = st.pr[b], pg = st.pg[b], pb = st.pb[b];
      const int event = st.ev[b];
      if (event & kEvMiss) {
        k_r += pr;
        k_g += pg;
        k_b += pb;
        t_r = p.sky_r;
        t_g = p.sky_g;
        t_b = p.sky_b;
        return;
      }
      const int m = st.mat[b];
      const Material mt = fetch_material(sc, m);
      // A path that died here collects nothing downstream.
      const float th_r = (event & kDied) ? 0.0f : t_r;
      const float th_g = (event & kDied) ? 0.0f : t_g;
      const float th_b = (event & kDied) ? 0.0f : t_b;
      const float ca_r = pr * th_r, ca_g = pg * th_g, ca_b = pb * th_b;
      const float dr = (event & kRefracted)
                           ? 1.0f / fmaxf(mt.trn, kRatioFloor)
                           : -1.0f / fmaxf(1.0f - mt.trn, kRatioFloor);
      if (m >= 0 && m < sc.n_mat) {
        float* j = jpix + static_cast<size_t>(9 * m) * hw;
        adds.add(j, ca_r);
        adds.add(j + hw, ca_g);
        adds.add(j + 2 * hw, ca_b);
        adds.add(j + 3 * hw, pr);
        adds.add(j + 4 * hw, pg);
        adds.add(j + 5 * hw, pb);
        adds.add(j + 6 * hw, ca_r * dr);
        adds.add(j + 7 * hw, ca_g * dr);
        adds.add(j + 8 * hw, ca_b * dr);
      }
      t_r = mt.em_r + mt.alb_r * th_r;
      t_g = mt.em_g + mt.alb_g * th_g;
      t_b = mt.em_b + mt.alb_b * th_b;
    });
  }
  float* o = img + 3 * rb.local;
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
  float* k = jpix + static_cast<size_t>(9 * sc.n_mat) * hw;
  k[0] = k_r;
  k[hw] = k_g;
  k[2 * hw] = k_b;
  adds.flush(jpix);
  return rounds;
}

template <bool kCount, class Pol>
__global__ void __launch_bounds__(Pol::Shape::kThreads, Pol::kMinBlocks)
render_fused_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                    int n_sph, const float* __restrict__ tri,
                    const int* __restrict__ tri_m, int n_tri,
                    const float* __restrict__ mat, int n_mat,
                    const float* __restrict__ par, float* __restrict__ img,
                    float* __restrict__ jac, unsigned long long* counter,
                    int height, int width, int row_start, int rows, int spp,
                    int max_bounces, uint32_t seed, int sample_offset, int jitter,
                    float inv_spp) {
  using Tl = typename Pol::Shape;
  int row, col;  // row: in the block of rows
  Tl::pixel(row, col);
  const bool in_range = col < width && row < rows;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes = kCount ? __ballot_sync(0xffffffffu, in_range) : 0u;
  extern __shared__ float4 smem[];
  int rounds = 0, warp_rounds = 0;
  if (in_range) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const size_t hw = static_cast<size_t>(rows) * static_cast<size_t>(width);
    rounds = render_pixel<kCount, Pol>(sc, p, img, jac, hw, row, col, row_start, height,
                                       width, spp, max_bounces, seed, sample_offset, jitter,
                                       inv_spp, lanes, warp_rounds,
                                       reinterpret_cast<unsigned char*>(smem));
  }
  if (kCount) {
    block_add<Tl>(rounds, counter);
    block_add<Tl>(warp_rounds, counter + 1);
  }
}

// Launch render_fused_kernel<kCount, Pol>; returns cudaGetLastError(), or
// cudaErrorInvalidValue where max_bounces + 1 exceeds the records or n_mat
// the int16 of shared-memory records.
template <bool kCount, class Pol>
int launch(const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
           int n_tri, const float* mat, int n_mat, const float* par, float* img, float* jac,
           unsigned long long* counter, int height, int width, int row_start, int rows, int spp,
           int max_bounces, unsigned int seed, int sample_offset, int jitter, int device,
           void* stream) {
  constexpr int kRounds = Pol::kUnroll ? Pol::kUnroll : kMaxRounds;
  if (max_bounces + 1 > kRounds || (Pol::Records::kShared && n_mat > kMaxMaterials))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  using Tl = typename Pol::Shape;
  size_t smem = 0;
  if constexpr (Pol::Records::kShared) {
    err = records_smem<Tl>(render_fused_kernel<kCount, Pol>, max_bounces,
                           Pol::Records::kRoundBytes, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  render_fused_kernel<kCount, Pol><<<Tl::grid(rows, width), Tl::block(), smem,
                                     static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, img, jac, counter,
      height, width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifndef PT_TILE_POINT
// The most bounces render_fused takes; the wrapper asks and raises above it.
extern "C" int render_fused_max_bounces() { return kMaxRounds - 1; }

// C entry, bound with ctypes. Tables, `par` and the block of `rows` rows
// from `row_start` as for render_fwd; `img` is (rows, width, 3) float32;
// `jac` is (9 * n_mat + 3, rows, width) float32 and must arrive zero-filled; `counter` is null, or two zeroed
// int64 that receive the executed thread-rounds and the warp lane-rounds
// (the counting instantiation runs then). Launches on `stream` of device
// `device` and returns cudaGetLastError(), or cudaErrorInvalidValue if
// max_bounces is above the cap or n_mat above 32767.
extern "C" int render_fused(const float* sph, const int* sph_m, int n_sph,
                            const float* tri, const int* tri_m, int n_tri,
                            const float* mat, int n_mat, const float* par,
                            float* img, float* jac, unsigned long long* counter,
                            int height, int width, int row_start, int rows, int spp,
                            int max_bounces, unsigned int seed, int sample_offset,
                            int jitter, int device, void* stream) {
  auto go = counter ? launch<true, KernelPolicy> : launch<false, KernelPolicy>;
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, img, jac, counter, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}

// A measurement instantiation of render_fused (pt_fused.cuh `Variant`), with
// its arguments but no counter. Returns cudaErrorInvalidValue for an unknown
// variant, or where max_bounces + 1 exceeds the variant's records.
extern "C" int render_fused_variant(int variant, const float* sph, const int* sph_m,
                                    int n_sph, const float* tri, const int* tri_m, int n_tri,
                                    const float* mat, int n_mat, const float* par, float* img,
                                    float* jac, int height, int width, int row_start,
                                    int rows, int spp, int max_bounces, unsigned int seed,
                                    int sample_offset, int jitter, int device,
                                    void* stream) {
  decltype(&launch<false, KernelPolicy>) go = nullptr;
  switch (variant) {
    case kVarSink: go = launch<false, SinkPolicy>; break;
    case kVarRegisters: go = launch<false, RegistersPolicy>; break;
    case kVarRecordsMoved: go = launch<false, MovedPolicy>; break;
  }
  if (!go) return static_cast<int>(cudaErrorInvalidValue);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, img, jac, nullptr, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}

#else
// The sweep library's entry at point PT_TILE_POINT (pt_sched.cuh TileAt):
// render_fused's arguments at that launch shape. Also cudaErrorInvalidValue
// where the block's records exceed what a block may take (records_smem;
// ops/render_kernel.fit_tile keeps them within it).
extern "C" int PT_TILED(render_fused)(const float* sph, const int* sph_m, int n_sph,
                                      const float* tri, const int* tri_m, int n_tri,
                                      const float* mat, int n_mat, const float* par,
                                      float* img, float* jac, unsigned long long* counter,
                                      int height, int width, int row_start, int rows, int spp,
                                      int max_bounces, unsigned int seed, int sample_offset,
                                      int jitter, int device, void* stream) {
  using Pol = KernelPolicyAt<TileAt<PT_TILE_POINT>>;
  auto go = counter ? launch<true, Pol> : launch<false, Pol>;
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, img, jac, counter, height,
            width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, device,
            stream);
}
#endif
