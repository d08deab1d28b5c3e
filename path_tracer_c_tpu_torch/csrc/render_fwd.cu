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
//  * one thread per pixel, 2-D blocks of 32 x 8, every per-ray quantity in
//    registers; no divisibility rule, the ragged edge is masked;
//  * the scene is read through const __restrict__ pointers; moving it to
//    shared or constant memory is later work;
//  * termination is zero throughput, as in the TPU kernel. A thread stops
//    its bounce loop once its throughput is exactly zero: every round it
//    skips would add only exact zeros. This per-thread exit takes the
//    place of the TPU kernel's whole-tile sky gate and bounce-0 hoist,
//    which are TPU scheduling choices;
//  * the half-b sphere quadratic, select-then-normalize sphere normals and
//    face normals precomputed by the wrapper, as in the TPU kernel.
//
// kCount is the TPU kernel's `count_rounds`, as a second instantiation so
// that the timed kernel carries no counter: it adds the bounce rounds every
// thread ran (thread-rounds) to counter[0], and to counter[1] the rounds
// every warp ran times its lanes in the image (warp lane-rounds): at the end
// of each sample the warp's in-range lanes take the largest round count of
// the sample (__reduce_max_sync), the warp's counterpart of the TPU's tile
// rounds. The reduction makes the warp reconverge at every sample, so the
// count does not depend on scheduling. Numerics: see pt_common.cuh.

#include "pt_common.cuh"

namespace {

using namespace ptc;

// One pixel's radiance into `out`; returns the bounce rounds it ran. The
// counting instantiation also adds the warp's lane-rounds of each sample to
// `warp_rounds` on the lowest lane of `lanes`, the warp's in-range lanes.
template <bool kCount>
__device__ __forceinline__ int render_pixel(const Tables& sc, const Params& p,
                                            float* __restrict__ out, int row,
                                            int col, int height, int width,
                                            int spp, int max_bounces,
                                            uint32_t seed, int sample_offset,
                                            int jitter, float inv_spp,
                                            unsigned lanes, int& warp_rounds) {
  const uint32_t pix = static_cast<uint32_t>(row * width + col);
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = static_cast<float>(row);
  const float inf = pos_inf();

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  int rounds = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (int s = 0; s < spp; ++s) {
    const int rounds0 = rounds;
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      if (kCount) ++rounds;
      const Hit h = closest_hit(sc, q);
      if (!(h.t < inf)) {
        shade_miss(p, q);
        break;
      }
      const Material mt = fetch_material(sc, h.m);
      shade(h, mt, q);
      // Exact early exit: with zero throughput every later round adds 0.
      if (q.tr == 0.0f && q.tg == 0.0f && q.tb == 0.0f) break;
    }
    shade_end(p, q);
    if (kCount) {
      const int widest = __reduce_max_sync(lanes, rounds - rounds0);
      const int lane = (threadIdx.y * blockDim.x + threadIdx.x) & 31;
      if (lane == __ffs(lanes) - 1) warp_rounds += widest * __popc(lanes);
    }
    acc_r += q.ar;
    acc_g += q.ag;
    acc_b += q.ab;
  }
  float* o = out + 3 * static_cast<size_t>(pix);
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
  return rounds;
}

template <bool kCount>
__global__ void __launch_bounds__(256)
render_fwd_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                  int n_sph, const float* __restrict__ tri,
                  const int* __restrict__ tri_m, int n_tri,
                  const float* __restrict__ mat, int n_mat,
                  const float* __restrict__ par, float* __restrict__ out,
                  unsigned long long* counter, int height, int width, int spp,
                  int max_bounces, uint32_t seed, int sample_offset, int jitter,
                  float inv_spp) {
  const int col = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = blockIdx.y * blockDim.y + threadIdx.y;
  const bool in_range = col < width && row < height;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes = kCount ? __ballot_sync(0xffffffffu, in_range) : 0u;
  int rounds = 0, warp_rounds = 0;
  if (in_range) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    rounds = render_pixel<kCount>(sc, p, out, row, col, height, width, spp,
                                  max_bounces, seed, sample_offset, jitter,
                                  inv_spp, lanes, warp_rounds);
  }
  if (kCount) {
    block_add(rounds, counter);
    block_add(warp_rounds, counter + 1);
  }
}

}  // namespace

// C entry, bound with ctypes. Pointers are device pointers of contiguous
// float32/int32 tables and the kNumParams camera/sky floats, packed by
// ops/render_kernel.py; `out` is (height, width, 3) float32. `counter` is
// null, or two zeroed int64 that receive the executed thread-rounds and warp
// lane-rounds (the counting instantiation runs then). Launches on `stream` of device
// `device` and returns cudaGetLastError().
extern "C" int render_fwd(const float* sph, const int* sph_m, int n_sph,
                          const float* tri, const int* tri_m, int n_tri,
                          const float* mat, int n_mat, const float* par,
                          float* out, unsigned long long* counter, int height,
                          int width, int spp, int max_bounces,
                          unsigned int seed, int sample_offset, int jitter,
                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // float32(1.0 / spp), rounded from double as the JAX package does.
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  const dim3 block(32, 8);
  const dim3 grid((width + block.x - 1) / block.x,
                  (height + block.y - 1) / block.y);
  auto kernel = counter ? render_fwd_kernel<true> : render_fwd_kernel<false>;
  kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, counter,
      height, width, spp, max_bounces, seed, sample_offset, jitter, inv_spp);
  return static_cast<int>(cudaGetLastError());
}
