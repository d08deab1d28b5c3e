// The per-bounce records of the physical tier's two gradient kernels
// (render_phys_fused.cu, render_phys_bwd.cu), as the template policies of
// their bodies take them: where a thread keeps what its forward rounds
// store for its sweep.
//
// The timed kernels keep RoundStores (pt_phys.cuh) in local memory
// (LocalStores<kMaxRounds>); LocalStores<kRegisterRounds> with its loops
// unrolled keeps them in registers, and SharedStores keeps them in dynamic
// shared memory sized by max_bounces + 1 at launch, mat narrowed to int16
// (measurement instantiations only).

#pragma once

#include "pt_fused.cuh"
#include "pt_phys.cuh"

namespace ptc {

template <int kN>
struct LocalStores : RoundStoresN<kN> {
  static constexpr bool kShared = false;
  static constexpr int kRoundBytes = 0;
  __device__ __forceinline__ void place(unsigned char*, int) {}
};

// In a block of tile Tl (pt_sched.cuh).
template <class Tl>
struct SharedStores {
  static constexpr bool kShared = true;
  static constexpr int kRoundBytes = 5 * 4 + 2 + 1;
  SmemField<float, Tl> pr, pg, pb, w;
  SmemField<int, Tl> row;
  SmemField<short, Tl> mat;
  SmemField<unsigned char, Tl> ev;
  // The fields of `rounds` rounds, one after another from `base`.
  __device__ __forceinline__ void place(unsigned char* base, int rounds) {
    pr = smem_field<float, Tl>(base, rounds);
    pg = smem_field<float, Tl>(base, rounds);
    pb = smem_field<float, Tl>(base, rounds);
    w = smem_field<float, Tl>(base, rounds);
    row = smem_field<int, Tl>(base, rounds);
    mat = smem_field<short, Tl>(base, rounds);
    ev = smem_field<unsigned char, Tl>(base, rounds);
  }
};

}  // namespace ptc
