// Speed-of-light probes for Hopper (sm_90a): what a block's start and end
// cost on the forward kernel's grid, and what a table load costs against
// the arithmetic beside it.
//
// Replace the two Pallas TPU kernels of scripts/sol_decompose.py:
//  * `_null_kernel` (B7): the forward kernel's grid and operand list, and
//    nothing else: out[pixel] = (sph[0], 0, 0). Here: B1's exact launch
//    (render_fwd.cu: its default tile, pt_sched.cuh FwdTile, one thread
//    a pixel, the ragged edge masked), its nine scene and camera pointers, its output layout
//    (H, W, 3). Its time over the blocks prices a block's start and end,
//    the operand plumbing and the image's one store.
//  * `kern` of `_mk_micro` (B8): per pixel, x = float(seed) * 1e-6, then
//    200 x 8 times x = ((x * a + b) * c + d) * e + x with the 5 scalars of
//    one object of an 8 x 5 table. The TPU kernel comes in two variants,
//    the scalars reloaded from SMEM every object or hoisted; here the
//    reload variant reads them through const __restrict__ pointers, as B1
//    reads its tables (render_fwd.cu), and the hoisted one into registers
//    before the loop. The difference of the two times prices a table load.
//
// What bounds them on an H100: B7 the 12 bytes a pixel it stores (12.6 MB at
// 1024^2, 3.8 us at 3.35 TB/s) and, in practice, the start of 8192 blocks;
// B8 its 9600 float32 operations a pixel (0.150 ms at 1024^2 at the data
// sheet's 67 TFLOP/s), and in the reload variant the loads.
//
// What the design does about that: nothing, on purpose: they are probes.
// The arithmetic is written with __fmul_rn and __fadd_rn (no fused FFMA,
// as the -fmad=false build of the render kernels issues it), so both
// variants issue the same float instructions and match their plain twins
// bit for bit. The reload variant takes the object count as a runtime
// argument and its loops are not unrolled: with a compile-time count and
// __restrict__ pointers nvcc would hoist the loads itself and the two
// variants would measure the same thing. The SASS shows it: the reload
// kernel keeps its 5 loads inside the loop, the hoisted one has its 40
// before it (chip_smoke.py checks).

#include "pt_sched.cuh"

namespace {

// B1's launch shape, which both probes copy.
using ProbeTile = ptc::FwdTile;

__global__ void __launch_bounds__(ProbeTile::kThreads)
sol_null_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m, int n_sph,
                const float* __restrict__ tri, const int* __restrict__ tri_m, int n_tri,
                const float* __restrict__ mat, int n_mat, const float* __restrict__ par,
                float* __restrict__ out, int height, int width) {
  int row, col;
  ProbeTile::pixel(row, col);
  if (col < width && row < height) {
    float* o = out + 3 * (static_cast<size_t>(row) * width + col);
    o[0] = sph[0];
    o[1] = 0.0f;
    o[2] = 0.0f;
  }
}

__device__ __forceinline__ float micro_step(float x, float a, float b, float c, float d,
                                            float e) {
  return __fadd_rn(
      __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fmul_rn(x, a), b), c), d), e), x);
}

// kNobj == 0: the reload variant (runtime object count, loads in the loop);
// kNobj > 0: the hoisted variant with that many objects.
template <int kNobj>
__global__ void __launch_bounds__(ProbeTile::kThreads)
sol_micro_kernel(const float* __restrict__ tab, const int* __restrict__ seed,
                 float* __restrict__ out, int height, int width, int nobj, int reps) {
  int row, col;
  ProbeTile::pixel(row, col);
  if (col >= width || row >= height) return;
  float x = __fmul_rn(__int2float_rn(seed[0]), 1e-6f);
  if constexpr (kNobj == 0) {
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
#pragma unroll 1
      for (int i = 0; i < nobj; ++i) {
        const float* t = tab + 5 * i;
        x = micro_step(x, t[0], t[1], t[2], t[3], t[4]);
      }
    }
  } else {
    float sc[5 * kNobj];
#pragma unroll
    for (int k = 0; k < 5 * kNobj; ++k) sc[k] = tab[k];
#pragma unroll 1
    for (int r = 0; r < reps; ++r) {
#pragma unroll
      for (int i = 0; i < kNobj; ++i)
        x = micro_step(x, sc[5 * i], sc[5 * i + 1], sc[5 * i + 2], sc[5 * i + 3],
                       sc[5 * i + 4]);
    }
  }
  out[static_cast<size_t>(row) * width + col] = x;
}

constexpr int kHoistedObjects = 8;

}  // namespace

// C entries, bound with ctypes; both launch on `stream` of device `device`
// and return cudaGetLastError().
//
// sol_null: the scene tables and camera params as render_fwd takes them
// (ops/render_kernel.py packs them), `out` (height, width, 3) float32.
extern "C" int sol_null(const float* sph, const int* sph_m, int n_sph, const float* tri,
                        const int* tri_m, int n_tri, const float* mat, int n_mat,
                        const float* par, float* out, int height, int width, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  sol_null_kernel<<<ProbeTile::grid(height, width), ProbeTile::block(), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, par, out, height, width);
  return static_cast<int>(cudaGetLastError());
}

// sol_micro: `tab` nobj x 5 float32, `seed` one int32, `out` (height, width)
// float32. hoisted != 0 takes the hoisted variant, which needs nobj == 8
// (cudaErrorInvalidValue otherwise).
extern "C" int sol_micro(const float* tab, const int* seed, float* out, int height, int width,
                         int nobj, int reps, int hoisted, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (hoisted && nobj != kHoistedObjects) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid = ProbeTile::grid(height, width), block = ProbeTile::block();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (hoisted) {
    sol_micro_kernel<kHoistedObjects><<<grid, block, 0, s>>>(tab, seed, out, height, width,
                                                             nobj, reps);
  } else {
    sol_micro_kernel<0><<<grid, block, 0, s>>>(tab, seed, out, height, width, nobj, reps);
  }
  return static_cast<int>(cudaGetLastError());
}
