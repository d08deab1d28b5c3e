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
//    material index and one byte of events: 17 bytes, in a thread-private
//    array that the compiler places in local memory (L1-cached, laid out
//    so that a warp's accesses coalesce). Albedo, emission and transparency
//    are read again from the material table in the sweep rather than
//    stored. max_bounces is a run-time value, so the array has a
//    compile-time size: kMaxRounds rounds, and the wrapper raises above
//    it. Scratch in device memory allocated by the wrapper would lift the
//    cap, at H * W * (B + 1) * 17 bytes a launch and without the L1;
//  * the bounce loop ends only on a structural death, a miss or total
//    internal reflection, never on zero throughput: a path that an
//    exactly black albedo killed still owes d_albedo = g * P_b * T_b, built
//    from the rounds after it. Those extra rounds add exact zeros to the
//    radiance. The sweep visits only the rounds the thread ran.
//
// kCount: see render_fwd.cu. Numerics: see pt_common.cuh.

#include "pt_common.cuh"

namespace {

using namespace ptc;

// Most bounce rounds a thread can store: max_bounces + 1 <= kMaxRounds.
constexpr int kMaxRounds = 32;

constexpr unsigned char kEvMiss = 4;  // beside kRefracted and kDied

// One pixel's radiance into `img` and Jacobian into the planes of `jac`
// (plane stride `hw`); returns the bounce rounds it ran.
template <bool kCount>
__device__ __forceinline__ int render_pixel(const Tables& sc, const Params& p,
                                            float* __restrict__ img,
                                            float* __restrict__ jac, size_t hw,
                                            int row, int col, int height,
                                            int width, int spp, int max_bounces,
                                            uint32_t seed, int sample_offset,
                                            int jitter, float inv_spp) {
  const uint32_t pix = static_cast<uint32_t>(row * width + col);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = static_cast<float>(row);
  const float inf = pos_inf();

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  // Per-bounce stores of the current sample.
  float st_pr[kMaxRounds], st_pg[kMaxRounds], st_pb[kMaxRounds];
  int st_mat[kMaxRounds];
  unsigned char st_ev[kMaxRounds];

  int rounds = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky planes
  float* const jpix = jac + pix;
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    // -- forward rounds, storing what the sweep needs --
    int n_rounds = 0;
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      if (kCount) ++rounds;
      n_rounds = bounce + 1;
      const Hit h = closest_hit(sc, q);
      st_pr[bounce] = q.tr;
      st_pg[bounce] = q.tg;
      st_pb[bounce] = q.tb;
      st_mat[bounce] = h.m;
      if (!(h.t < inf)) {
        st_ev[bounce] = kEvMiss;
        shade_miss(p, q);
        break;
      }
      const Material mt = fetch_material(sc, h.m);
      const int event = shade(h, mt, q);
      st_ev[bounce] = static_cast<unsigned char>(event);
      // Structural death only; zero throughput goes on (see above).
      if (event & kDied) break;
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
    for (int b = n_rounds - 1; b >= 0; --b) {
      const float pr = st_pr[b], pg = st_pg[b], pb = st_pb[b];
      const int event = st_ev[b];
      if (event & kEvMiss) {
        k_r += pr;
        k_g += pg;
        k_b += pb;
        t_r = p.sky_r;
        t_g = p.sky_g;
        t_b = p.sky_b;
        continue;
      }
      const int m = st_mat[b];
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
        j[0] += ca_r;
        j[hw] += ca_g;
        j[2 * hw] += ca_b;
        j[3 * hw] += pr;
        j[4 * hw] += pg;
        j[5 * hw] += pb;
        j[6 * hw] += ca_r * dr;
        j[7 * hw] += ca_g * dr;
        j[8 * hw] += ca_b * dr;
      }
      t_r = mt.em_r + mt.alb_r * th_r;
      t_g = mt.em_g + mt.alb_g * th_g;
      t_b = mt.em_b + mt.alb_b * th_b;
    }
  }
  float* o = img + 3 * static_cast<size_t>(pix);
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
  float* k = jpix + static_cast<size_t>(9 * sc.n_mat) * hw;
  k[0] = k_r;
  k[hw] = k_g;
  k[2 * hw] = k_b;
  return rounds;
}

template <bool kCount>
__global__ void __launch_bounds__(256)
render_fused_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                    int n_sph, const float* __restrict__ tri,
                    const int* __restrict__ tri_m, int n_tri,
                    const float* __restrict__ mat, int n_mat,
                    const float* __restrict__ par, float* __restrict__ img,
                    float* __restrict__ jac, unsigned long long* counter,
                    int height, int width, int spp, int max_bounces,
                    uint32_t seed, int sample_offset, int jitter,
                    float inv_spp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  int rounds = 0;
  if (col < width && row < height) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const size_t hw = static_cast<size_t>(height) * static_cast<size_t>(width);
    rounds = render_pixel<kCount>(sc, p, img, jac, hw, row, col, height, width,
                                  spp, max_bounces, seed, sample_offset, jitter,
                                  inv_spp);
  }
  if (kCount) block_add(rounds, counter);
}

}  // namespace

// The most bounces render_fused takes; the wrapper asks and raises above it.
extern "C" int render_fused_max_bounces() { return kMaxRounds - 1; }

// C entry, bound with ctypes. Tables and `par` as for render_fwd; `img` is
// (height, width, 3) float32; `jac` is (9 * n_mat + 3, height, width)
// float32 and must arrive zero-filled; `counter` is null, or one zeroed
// int64 that receives the executed thread-rounds. Launches on `stream` of
// device `device` and returns cudaGetLastError(), or cudaErrorInvalidValue
// if max_bounces is above the cap.
extern "C" int render_fused(const float* sph, const int* sph_m, int n_sph,
                            const float* tri, const int* tri_m, int n_tri,
                            const float* mat, int n_mat, const float* par,
                            float* img, float* jac, unsigned long long* counter,
                            int height, int width, int spp, int max_bounces,
                            unsigned int seed, int sample_offset, int jitter,
                            int device, void* stream) {
  if (max_bounces + 1 > kMaxRounds) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  auto kernel = counter ? render_fused_kernel<true> : render_fused_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, img, jac, counter,
      height, width, spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
