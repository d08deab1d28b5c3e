// What the two fused primal + Jacobian kernels (render_fused.cu,
// render_phys_fused.cu) take as template policies: where a thread keeps its
// per-bounce records, where its plane adds go, and how its two loops over
// the rounds of a sample run. The timed kernels and their measurement
// instantiations are one body, render_pixel, under different policies, so
// that the difference of two instantiations' times prices one thing of the
// kernel itself (utils/sol_decompose.fused_decompose).
//
// A fused kernel's thread owns one pixel. For each of its samples it runs
// forward rounds that store per-bounce records until the path ends (a miss,
// a structural death, or the bounce budget), then a sweep over those records
// from the last round down, which adds into the pixel's Jacobian planes.

#pragma once

#include "pt_sched.cuh"

namespace ptc {

// One field of a thread's per-bounce records in dynamic shared memory, in a
// block launched at tile Tl (pt_sched.cuh): round b at p[b * Tl::kThreads],
// the block's threads side by side, so that a warp's 32 accesses to one
// round fall in distinct banks.
template <class T, class Tl>
struct SmemField {
  static constexpr int kStride = Tl::kThreads;
  T* p;
  __device__ __forceinline__ T& operator[](int b) const { return p[b * kStride]; }
};

// The thread's slot in a field of `rounds` rounds that starts at `base`;
// returns the field and moves `base` past it.
template <class T, class Tl>
__device__ __forceinline__ SmemField<T, Tl> smem_field(unsigned char*& base, int rounds) {
  SmemField<T, Tl> f{reinterpret_cast<T*>(base) + Tl::tid()};
  base += sizeof(T) * static_cast<size_t>(rounds) * Tl::kThreads;
  return f;
}

// Add `v` into a Jacobian plane at `p`: the kernels' read-modify-write of
// device memory.
struct PlaneAdds {
  __device__ __forceinline__ void add(float* p, float v) { *p += v; }
  __device__ __forceinline__ void flush(float*) {}
};

// The measurement instantiation's stand-in for PlaneAdds: the same values, in
// the same order, summed into one register and stored once at the pixel's end
// (flush), so that the difference of the two prices the planes' memory
// traffic. Its planes are not the Jacobian.
struct PlaneSink {
  float sum = 0.0f;
  __device__ __forceinline__ void add(float*, float v) { sum += v; }
  __device__ __forceinline__ void flush(float* p) { *p = sum; }
};

struct LaneLoops;

// Where B4 keeps the planes whose addresses depend on the pixel alone
// (render_phys_fused.cu ChipPlanes): in device memory, as every other plane;
// in slots in dynamic shared memory; in slots in a thread-private array
// (local memory, cached in L1).
enum PlaneSlots : int {
  kSlotsDevice = 0,
  kSlotsShared = 1,
  kSlotsLocal = 2,
};

// An instantiation of a fused kernel: its per-bounce records (`Records`,
// which has a `place(base, rounds)` and, where they live in dynamic shared
// memory, kShared), its plane adds (PlaneAdds or PlaneSink), kUnroll (0: the
// loops over the rounds run to the run-time bounce budget; n > 0: they are
// unrolled to n rounds, so that every record index is a constant and records
// of n entries stay in registers), the blocks of DefaultTile a multiprocessor
// that ptxas budgets its registers for (kMinBlocks: as many threads in blocks
// of its own tile), its loops over the rounds (LaneLoops or WarpLoops), B4
// only, where the planes whose addresses depend on the pixel alone live until
// the pixel's end (PlaneSlots), and its launch shape (Tile, pt_sched.cuh).
template <class Records_, class Adds_, int kUnroll_, int kMinBlocks_,
          class Loops_ = LaneLoops, int kPlaneSlots_ = kSlotsDevice, class Shape_ = DefaultTile>
struct Policy {
  using Records = Records_;
  using Adds = Adds_;
  using Loops = Loops_;
  using Shape = Shape_;
  static constexpr int kUnroll = kUnroll_;
  static constexpr int kMinBlocks = min_blocks<Shape_, kMinBlocks_>();
  static constexpr int kPlaneSlots = kPlaneSlots_;
  static constexpr bool kChipPlanes = kPlaneSlots_ != kSlotsDevice;
};

// The measurement instantiations of both kernels, which no user path runs,
// each one policy away from the timed kernel: the plane adds into a PlaneSink;
// the records in registers (kRegisterRounds rounds: max_bounces <= 3, config
// 4's fit shape; one block a multiprocessor, so that they fit); the records
// where the kernel does not keep them (B2: local memory; B4: shared memory).
// B4 only: warp-uniform loops; registers budgeted for three blocks a
// multiprocessor; its pixel-constant planes in slots in shared memory and in
// local memory (PlaneSlots).
enum Variant : int {
  kVarSink = 0,
  kVarRegisters = 1,
  kVarRecordsMoved = 2,
  kVarWarpLoops = 3,
  kVarThreeBlocks = 4,
  kVarSharedSlots = 5,
  kVarLocalSlots = 6,
};
constexpr int kRegisterRounds = 4;

// The forward rounds of one sample: round(b) for b = 0, 1, ... until it
// returns true (the path ended) or b reaches max_bounces; returns the rounds
// run. With kUnroll > 0 the loop is unrolled to kUnroll rounds (max_bounces <
// kUnroll, which the caller checks).
template <int kUnroll, class Round>
__device__ __forceinline__ int forward_rounds(int max_bounces, Round&& round) {
  int n = 0;
  if constexpr (kUnroll == 0) {
    for (int b = 0; b <= max_bounces; ++b) {
      n = b + 1;
      if (round(b)) break;
    }
  } else {
#pragma unroll
    for (int b = 0; b < kUnroll; ++b) {
      n = b + 1;
      if (round(b) || b == max_bounces) break;
    }
  }
  return n;
}

// The sweep of one sample: step(b) for b = n_rounds - 1 down to 0, unrolled
// as forward_rounds.
template <int kUnroll, class Step>
__device__ __forceinline__ void sweep_rounds(int n_rounds, Step&& step) {
  if constexpr (kUnroll == 0) {
    for (int b = n_rounds - 1; b >= 0; --b) step(b);
  } else {
#pragma unroll
    for (int b = kUnroll - 1; b >= 0; --b)
      if (b < n_rounds) step(b);
  }
}

// The two loop policies of a fused kernel, each a forward(max_bounces,
// lanes, round) and a sweep(n_rounds, lanes, step) as forward_rounds and
// sweep_rounds take them. `lanes` are the warp's lanes inside the image;
// every one of them calls both.
//
// LaneLoops: forward_rounds and sweep_rounds, each lane leaving a loop at its
// own last round (B2's loops).
struct LaneLoops {
  static constexpr bool kWarp = false;
  template <int kUnroll, class Round>
  static __device__ __forceinline__ int forward(int max_bounces, unsigned, Round&& round) {
    return forward_rounds<kUnroll>(max_bounces, round);
  }
  template <int kUnroll, class Step>
  static __device__ __forceinline__ void sweep(int n_rounds, unsigned, Step&& step) {
    sweep_rounds<kUnroll>(n_rounds, step);
  }
};

// WarpLoops: warp-uniform loops, render_phys_bwd.cu's form. The forward
// rounds run until no lane of the warp is alive, a lane whose path ended
// idling; the sweep runs the warp's longest lane's rounds, each lane its own
// from its last down. No lane leaves a loop alone. The same rounds, in the
// same order a lane, as LaneLoops, so the same bits.
struct WarpLoops {
  static constexpr bool kWarp = true;
  template <int kUnroll, class Round>
  static __device__ __forceinline__ int forward(int max_bounces, unsigned lanes, Round&& round) {
    static_assert(kUnroll == 0, "warp-uniform loops run to the run-time bounce budget");
    int n = 0;
    bool alive = true;
    for (int b = 0; b <= max_bounces; ++b) {
      if (!__any_sync(lanes, alive)) break;
      if (alive) {
        n = b + 1;
        alive = !round(b);
      }
    }
    return n;
  }
  template <int kUnroll, class Step>
  static __device__ __forceinline__ void sweep(int n_rounds, unsigned lanes, Step&& step) {
    static_assert(kUnroll == 0, "warp-uniform loops run to the run-time bounce budget");
    const int widest = __reduce_max_sync(lanes, n_rounds);
    for (int i = 0; i < widest; ++i)
      if (i < n_rounds) step(n_rounds - 1 - i);
  }
};

// The warp lane-rounds of one sample (the counting instantiations): the warp's
// in-range `lanes` wait for the longest lane's `n_rounds`, so the warp runs
// that many rounds times their number; added to `warp_rounds` of the first
// of them. Every lane of `lanes` must call it.
__device__ __forceinline__ void count_warp_rounds(unsigned lanes, int n_rounds,
                                                  int& warp_rounds) {
  const int widest = __reduce_max_sync(lanes, n_rounds);
  if (lane_id() == __ffs(lanes) - 1) warp_rounds += widest * __popc(lanes);
}

// The most shared memory a block may opt into on an H100 (227 KB).
constexpr size_t kSmemOptin = 232448;

// The dynamic shared memory the records of max_bounces + 1 rounds of
// `round_bytes` each take in a block of tile Tl, made the limit of `kernel`;
// cudaErrorInvalidValue, and no call of the runtime, above kSmemOptin
// (ops/render_kernel.fit_tile keeps a launch below it).
template <class Tl, class Kernel>
cudaError_t records_smem(Kernel kernel, int max_bounces, int round_bytes, size_t& bytes) {
  bytes = static_cast<size_t>(max_bounces + 1) * Tl::kThreads * round_bytes;
  if (bytes > kSmemOptin) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ptc
