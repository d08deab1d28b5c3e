// What the two forward kernels (render_fwd.cu, render_phys.cu) take as
// template policies: how a lane schedules its samples' rounds, and where the
// block reads the scene tables from. The timed kernels, their counting
// instantiations and their measurement instantiations are one body,
// render_pixel, under different policies, so that the difference of two
// instantiations' times prices one thing of the kernel itself
// (utils/sol_decompose.sol_decompose).
//
// Schedules. A lane owns one pixel and runs its samples in order; a sample's
// path ends on a miss, at zero throughput, or at the end of the bounce budget.
//  * PerSample: a sample's rounds, then the next sample. A warp runs each
//    sample for as many rounds as its longest lane, the others idle.
//  * Regen (path regeneration): the sample loop and the bounce loop are one
//    loop. A lane whose path ends closes its sample and starts its own next
//    one in the same iteration, so a warp runs as many rounds as its busiest
//    lane's total over all samples. The loop is warp-uniform: every lane of
//    the warp stays in it (lanes outside the image and lanes done with their
//    samples masked) until a vote of the whole warp finds no lane with a
//    sample left. A loop that lanes left one at a time by `break` hung on the
//    card (PERF.md, PR 6).
// Both schedules give every pixel the same samples, in the same order, with
// the same streams (start_path keys the PCG state on pixel and sample), so
// their images are equal bit for bit.
//
// Tables. GlobalTables: the device functions read the tables through the
// pointers the wrapper passes, with plain loads (explicit __ldg was 3% slower
// on an H100, PERF.md). SharedTables: every thread of the block takes part in
// copying the tables into dynamic shared memory, 16 bytes a load where the
// source is aligned, before any range test; then __syncthreads(), and the
// device functions read the copies. A scan reads one address across the warp,
// which shared memory broadcasts; a material fetch by hit index is a gather.
// The tables take table_words() words; above kSharedTableBudget bytes the
// wrappers take GlobalTables.
//
// Launch shape. Tile<TH, TW, WH, WW>: a block renders TH x TW pixels, one
// thread a pixel, and is launched as a 1-D block of TH * TW threads over a
// 2-D grid of blocks across the rows x width image; its warps are WH x WW
// footprints (WH * WW = 32) laid over the block row-major, lane l of a warp
// at (l / WW, l % WW) in its footprint. Every render kernel, and the probes
// that copy B1's launch, take their thread's pixel, block index and warp
// from the Tile of their policy and from nowhere else, so one body serves
// every shape. The ragged edge stays masked (`in_range`). The images do not
// depend on the tile: the streams and the camera key on the global pixel.
// TileAt<k> is point k of the shapes the sweep library instantiates
// (ops/render_kernel.py TILES, in this order). The timed library holds each
// kernel at its default point: B1, and the probes that copy its launch, at
// FwdTile; the others at point 0, DefaultTile.

#pragma once

#include "pt_common.cuh"

namespace ptc {

constexpr unsigned kFullWarp = 0xffffffffu;

struct PerSample {
  static constexpr bool kRegen = false;
};
struct Regen {
  static constexpr bool kRegen = true;
};
struct GlobalTables {
  static constexpr bool kShared = false;
};
struct SharedTables {
  static constexpr bool kShared = true;
};

// A launch shape (see above).
template <int TH, int TW, int WH, int WW>
struct Tile {
  static_assert(WH * WW == 32, "a warp's footprint holds its 32 lanes");
  static_assert(TH % WH == 0 && TW % WW == 0, "the footprints tile the block");
  static constexpr int kTH = TH, kTW = TW, kWH = WH, kWW = WW;
  static constexpr int kThreads = TH * TW;
  static constexpr int kWarps = kThreads / 32;
  static dim3 block() { return dim3(kThreads); }
  // The blocks over `rows` rows of `width` pixels.
  static dim3 grid(int rows, int width) {
    return dim3((width + TW - 1) / TW, (rows + TH - 1) / TH);
  }
  // The thread's index in its block, and its block's warp.
  static __device__ __forceinline__ int tid() { return threadIdx.x; }
  static __device__ __forceinline__ int warp() { return tid() >> 5; }
  // The thread's pixel: its row in the launch's block of rows, its column.
  static __device__ __forceinline__ void pixel(int& row, int& col) {
    constexpr int kAcross = TW / WW;  // footprints across a block
    const int t = tid(), lane = t & 31, w = t >> 5;
    row = blockIdx.y * TH + (w / kAcross) * WH + lane / WW;
    col = blockIdx.x * TW + (w % kAcross) * WW + lane % WW;
  }
};

using DefaultTile = Tile<8, 32, 1, 32>;

template <int kPoint>
struct TilePoint;
template <> struct TilePoint<0> { using type = DefaultTile; };
template <> struct TilePoint<1> { using type = Tile<4, 32, 1, 32>; };
template <> struct TilePoint<2> { using type = Tile<16, 32, 1, 32>; };
template <> struct TilePoint<3> { using type = Tile<16, 16, 2, 16>; };
template <> struct TilePoint<4> { using type = Tile<16, 16, 4, 8>; };
template <> struct TilePoint<5> { using type = Tile<8, 32, 4, 8>; };
template <> struct TilePoint<6> { using type = Tile<8, 16, 4, 8>; };
template <int kPoint>
using TileAt = typename TilePoint<kPoint>::type;

// B1's default point (ops/render_kernel.py DEFAULT_TILE): 8 x 16 pixels,
// warps of 4 x 8. It beat DefaultTile at each shape B1 was compared at on
// an H100, alone and as called (PERF.md, the tile sweep).
using FwdTile = TileAt<6>;

// The name of a C entry of the sweep library, built with -DPT_TILE_POINT=k:
// PT_TILED(render_fwd) is render_fwd_tiled_k.
#define PT_TILED_NAME(name, point) name##_tiled_##point
#define PT_TILED_AT(name, point) PT_TILED_NAME(name, point)
#define PT_TILED(name) PT_TILED_AT(name, PT_TILE_POINT)

// The blocks of tile Tl a multiprocessor that ptxas budgets registers for:
// those holding the threads of kBlocks blocks of DefaultTile, so that a
// thread's registers do not move with the tile (four blocks of 256: 64
// registers; three: 80).
template <class Tl, int kBlocks>
constexpr int min_blocks() {
  static_assert(kBlocks * DefaultTile::kThreads % Tl::kThreads == 0,
                "the tile divides the multiprocessor's threads");
  return kBlocks * DefaultTile::kThreads / Tl::kThreads;
}

template <class Sched_, class Tab_, class Shape_ = DefaultTile>
struct FwdPolicy {
  using Sched = Sched_;
  using Tab = Tab_;
  using Shape = Shape_;  // the launch shape (Tile)
};

// The forward kernels' measurement instantiations by number (the wrappers'
// VARIANTS), each the timed kernel (KernelPolicy of render_fwd.cu and
// render_phys.cu) under one other policy: the per-sample schedule; its
// tables read from device memory.
enum FwdVariant : int {
  kVarPerSample = 0,
  kVarGlobalTables = 1,
};
template <class Pol>
using PerSampleOf = FwdPolicy<PerSample, typename Pol::Tab, typename Pol::Shape>;
template <class Pol>
using GlobalTablesOf = FwdPolicy<typename Pol::Sched, GlobalTables, typename Pol::Shape>;
// The policy Pol at launch shape Tl (the sweep library's instantiations).
template <class Pol, class Tl>
using TiledOf = FwdPolicy<typename Pol::Sched, typename Pol::Tab, Tl>;

// Both kernels and all their instantiations are built for 1024 threads a
// multiprocessor, four blocks of 256 (__launch_bounds__(256, 4)) or as many
// threads at another tile (min_blocks): at most 64 registers a thread. Left
// to choose (a bound of 256 threads and one block) ptxas takes 78-95
// registers for them and they ran up to 27% slower (PERF.md).
constexpr int kFwdMinBlocks = 4;

// The most bytes of tables a block stages: at 64 registers a thread four
// blocks of 256 threads fill a multiprocessor's registers, and four such
// blocks' tables fit its 228 KB of shared memory beside the carve-out for L1.
// It is also the most dynamic shared memory a launch takes without opting in.
// At a tile of 128 threads (B1's FwdTile) eight blocks stage the tables, so
// above 28.5 KB of tables fewer than eight are resident.
constexpr int kSharedTableBudget = 48 * 1024;

// Words of one staged table of `n` words: rounded up to 16 bytes, so that
// every table starts 16-byte aligned.
__host__ __device__ constexpr int seg_words(int n) { return (n + 3) & ~3; }

// Words the staged tables take: the reference tier's (spheres, their
// materials, triangles, theirs, materials) and, with `physical`, the emitter
// tables of pt_phys.cuh (sphere pick list and radiance, triangle pick list,
// radiance and area, raw emission strength). Row counts as the wrappers pack
// them; ops/render_kernel.table_bytes mirrors this.
__host__ __device__ constexpr int table_words(int n_sph, int n_tri, int n_mat, bool physical) {
  return seg_words(n_sph * kSphStride) + seg_words(n_sph) + seg_words(n_tri * kTriStride) +
         seg_words(n_tri) + seg_words(n_mat * kMatStride) +
         (physical ? seg_words(n_sph) + seg_words(3 * n_sph) + seg_words(n_tri) +
                         seg_words(3 * n_tri) + seg_words(n_tri) + seg_words(n_mat)
                   : 0);
}

// Copy `n` words from `src` to shared memory at `dst` with every thread of
// the block (launched at tile Tl), 16 bytes a load where `src` is 16-byte
// aligned; returns the copy and moves `dst` past it. No thread may read the
// copy before the block's next __syncthreads().
template <class Tl, class T>
__device__ __forceinline__ const T* stage(const T* src, int n, uint32_t*& dst) {
  static_assert(sizeof(T) == 4, "tables hold 32-bit words");
  const int tid = Tl::tid();
  // Tl::kThreads, read at run time: as a constant, nvcc unrolled the copy
  // loops (B1 240 more loads and stores) and B3 ran 0.8-1.7% slower (PERF.md).
  const int nthreads = blockDim.x;
  T* const out = reinterpret_cast<T*>(dst);
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int n4 = n >> 2;
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (int i = tid; i < n4; i += nthreads) d4[i] = s4[i];
    done = n4 << 2;
  }
  const uint32_t* s1 = reinterpret_cast<const uint32_t*>(src);
  for (int i = done + tid; i < n; i += nthreads) dst[i] = s1[i];
  dst += seg_words(n);
  return out;
}

// Point `sc` at copies of its tables in shared memory from `dst` on (stage).
template <class Tl>
__device__ __forceinline__ void stage_tables(Tables& sc, uint32_t*& dst) {
  sc.sph = stage<Tl>(sc.sph, sc.n_sph * kSphStride, dst);
  sc.sph_m = stage<Tl>(sc.sph_m, sc.n_sph, dst);
  sc.tri = stage<Tl>(sc.tri, sc.n_tri * kTriStride, dst);
  sc.tri_m = stage<Tl>(sc.tri_m, sc.n_tri, dst);
  sc.mat = stage<Tl>(sc.mat, sc.n_mat * kMatStride, dst);
}

// What a round did, as bits: the sample's path ended (a miss or zero
// throughput); the round computed a light sample; it ran a shadow scan.
constexpr int kRoundEnded = 1, kRoundLight = 2, kRoundShadow = 4;

// What the counting instantiations count: the rounds a lane ran
// (thread-rounds); on the first lane of the warp's in-image lanes, the rounds
// the warp ran times those lanes (warp lane-rounds), and of them the rounds in
// which some lane computed a light sample, and ran a shadow scan.
struct RoundCounts {
  int thread = 0;
  int warp = 0, warp_light = 0, warp_shadow = 0;
};

// One round of the warp, counted on the first lane of `lanes` (the warp's
// in-image lanes): `bits` is this lane's round (0 where it ran none). Every
// lane of the warp calls it.
__device__ __forceinline__ void count_warp_round(unsigned lanes, int bits, RoundCounts& c) {
  const unsigned light = __ballot_sync(kFullWarp, bits & kRoundLight);
  const unsigned shadow = __ballot_sync(kFullWarp, bits & kRoundShadow);
  if (lane_id() == __ffs(lanes) - 1) {
    const int n = __popc(lanes);
    c.warp += n;
    if (light) c.warp_light += n;
    if (shadow) c.warp_shadow += n;
  }
}

// A lane's `spp` samples under schedule Sched. start(s) begins sample s;
// round() runs one round of the current sample and returns its bits (above);
// finish() closes the sample (the sky at the end of the budget, the
// accumulator). A sample runs at most max_bounces + 1 rounds. Lanes outside
// the image (`in_range` false) run no sample. Every lane of the warp calls it
// (the timed PerSample instantiation lets lanes outside the image leave at
// once: it has no warp vote). With kCount, `c` counts as RoundCounts says;
// `lanes` is the ballot of `in_range` over the warp.
template <class Sched, bool kCount, class Start, class Round, class Finish>
__device__ __forceinline__ void run_samples(bool in_range, unsigned lanes, int spp,
                                            int max_bounces, Start&& start, Round&& round,
                                            Finish&& finish, RoundCounts& c) {
  if constexpr (!Sched::kRegen) {
    if constexpr (!kCount) {
      if (!in_range) return;
      for (int s = 0; s < spp; ++s) {
        start(s);
        for (int b = 0; b <= max_bounces; ++b)
          if (round() & kRoundEnded) break;
        finish();
      }
    } else {
      // The same rounds, with the warp voting on each: it runs round b while
      // any lane's path is alive.
      for (int s = 0; s < spp; ++s) {
        if (in_range) start(s);
        bool alive = in_range;
        for (int b = 0; b <= max_bounces && __any_sync(kFullWarp, alive); ++b) {
          int bits = 0;
          if (alive) {
            ++c.thread;
            bits = round();
            alive = !(bits & kRoundEnded);
          }
          count_warp_round(lanes, bits, c);
        }
        if (in_range) finish();
      }
    }
  } else {
    int s = in_range ? 0 : spp;  // the sample this lane runs; spp: none left
    int b = 0;                    // its round in that sample
    if (s < spp) start(s);
    while (__any_sync(kFullWarp, s < spp)) {
      int bits = 0;
      if (s < spp) {
        if (kCount) ++c.thread;
        bits = round();
        if ((bits & kRoundEnded) || b == max_bounces) {
          finish();
          b = 0;
          if (++s < spp) start(s);
        } else {
          ++b;
        }
      }
      if (kCount) count_warp_round(lanes, bits, c);
    }
  }
}

}  // namespace ptc
