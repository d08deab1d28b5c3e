// Op-rate calibration kernel for Hopper (sm_90a): dependent chains of one
// operation class, to measure what the card sustains for that class.
//
// Replaces the Pallas TPU kernel `_calib_kernel` of
// path_tracer_c_tpu/utils/flops.py. It computes the same function: every
// element runs reps x 16 dependent steps of one chain and writes its value:
//   alu     v = (v * 1.000000119 + 1e-7) * 0.999999881 - 1e-7  (4 operations)
//   sqrt    v = sqrt(v + 1.5)                                    (1 sqrt, 1 add)
//   trig    v = cos(v)
//   explog  v = log1p(|v| * 0.5)                                 (1 log1p, 2 ALU)
// Each chain has a bounded fixed point, so the values stay finite.
//
// What bounds it on an H100: the issue rate of the chain's instructions, by
// design: it exists to measure that rate (utils/flops.measure_op_rate), so
// the other kernels' operation counts can be held against it. It is built in
// the same -fmad=false library as the render kernels, so it measures the
// ceiling their instructions face: the alu chain is written with __fmul_rn
// and __fadd_rn, one FMUL and one FADD each, never a fused FFMA. sqrtf is
// IEEE-rounded (-prec-sqrt defaults to true), and cosf and log1pf are
// software routines of several instructions: the rates of those classes are
// the rates of those routines.
//
// What the design does about that: one thread an element, one chain a
// thread, 256-thread blocks; the caller sizes the launch to 2048 threads on
// every SM, so each scheduler has enough independent warps to hide the
// chain's latency. `reps` is a runtime argument (one build serves every
// count, and the difference of two counts removes the launch cost); the 16
// steps of a round are unrolled. Every thread writes its value, so no step
// is dead, and without fast-math nvcc does not reassociate the chain.

#include <cuda_runtime.h>

namespace {

template <int kKind>
__device__ __forceinline__ float calib_step(float v) {
  if constexpr (kKind == 0) {
    const float a = __fadd_rn(__fmul_rn(v, 1.000000119f), 1e-7f);
    return __fadd_rn(__fmul_rn(a, 0.999999881f), -1e-7f);
  } else if constexpr (kKind == 1) {
    return sqrtf(v + 1.5f);
  } else if constexpr (kKind == 2) {
    return cosf(v);
  } else {
    return log1pf(fabsf(v) * 0.5f);
  }
}

template <int kKind>
__global__ void __launch_bounds__(256)
calib_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int reps) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float v = x[i];
  for (int r = 0; r < reps; ++r) {
#pragma unroll
    for (int k = 0; k < 16; ++k) v = calib_step<kKind>(v);
  }
  out[i] = v;
}

}  // namespace

// C entry, bound with ctypes. `x` and `out` are device pointers of n
// float32; `kind` 0 alu, 1 sqrt, 2 trig, 3 explog. Launches on `stream` of
// device `device` and returns cudaGetLastError() (cudaErrorInvalidValue for
// an unknown kind).
extern "C" int calib(const float* x, float* out, int n, int kind, int reps, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n <= 0) return 0;
  const int block = 256;
  const int grid = (n + block - 1) / block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case 0: calib_kernel<0><<<grid, block, 0, s>>>(x, out, n, reps); break;
    case 1: calib_kernel<1><<<grid, block, 0, s>>>(x, out, n, reps); break;
    case 2: calib_kernel<2><<<grid, block, 0, s>>>(x, out, n, reps); break;
    case 3: calib_kernel<3><<<grid, block, 0, s>>>(x, out, n, reps); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
