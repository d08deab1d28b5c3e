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

struct SharedStores {
  static constexpr bool kShared = true;
  static constexpr int kRoundBytes = 5 * 4 + 2 + 1;
  SmemField<float> pr, pg, pb, w;
  SmemField<int> row;
  SmemField<short> mat;
  SmemField<unsigned char> ev;
  // The fields of `rounds` rounds, one after another from `base`.
  __device__ __forceinline__ void place(unsigned char* base, int rounds) {
    pr = smem_field<float>(base, rounds);
    pg = smem_field<float>(base, rounds);
    pb = smem_field<float>(base, rounds);
    w = smem_field<float>(base, rounds);
    row = smem_field<int>(base, rounds);
    mat = smem_field<short>(base, rounds);
    ev = smem_field<unsigned char>(base, rounds);
  }
};

}  // namespace ptc
