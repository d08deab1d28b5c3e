// Fused primal + Jacobian kernel of the physical tier for Hopper (sm_90a):
// the forward pass of the physical tier's gradient.
//
// Replaces the Pallas TPU kernel `_phys_fused_kernel` of
// path_tracer_c_tpu/ops/pallas_physical.py. One launch emits the radiance
// image, equal bit for bit to render_phys.cu's, and three families of
// per-pixel Jacobian planes from which the backward pass is a contraction
// with the image cotangent (ops/render_physical_grad.py
// `contract_physical_jacobian`). Per sample the radiance is
//
//   sum_b P_b E_b addle_b + sum_b P_b albedo_b/pi le_b w_b valid_b + P_end sky
//
// with P_b the throughput before bounce b, E_b the hit's emission (added
// unless single counting skips it), and (le_b, w_b, valid_b) the light sample
// of a diffuse vertex: the sampled emitter's radiance, the geometry weight
// cos / pdf * pool, and whether it counted.
//
// Material and sky planes, (mp * n_mat + 3, H, W), mp = 9, or 12 with
// rough_grad; per material m and colour c, summed over samples and bounces:
//
//   A[m, c]  += P (S_h + nee)              at a hit on m (albedo)
//   S'[m, c] += addle P                    at a hit on m (emission), and
//            += valid P albedo w / pi      into the planes of the *sampled
//                                          emitter's* material
//   R[m, c]  += P (S_h + nee) dr           (transparency)
//   G[m, c]  += P (S_h + nee) drg          (roughness, the score function of
//                                          the lobe choice; rough_grad only)
//   K[c]     += P at a miss, and P_end     (sky)
//
// S is the radiance collected after the bounce per unit of throughput, built
// by a sweep from the path's last round down: the sky at the end of the
// budget and at a miss, S_h = 0 after a death by total internal reflection,
// and S_{b-1} = addle E + albedo (S_h + nee) at a hit; nee_c = valid le_c w /
// pi.
//
// Emitter-geometry planes: for the first n_em_cap sphere-emitter ordinals 12
// planes each, layout [k, comp (cx, cy, cz, r), colour], and with tri_nee for
// the first tri_em_cap triangle-emitter ordinals 27 each, layout [k, comp (v0
// xyz, v1 xyz, v2 xyz), colour]:
//
//   G[k, comp, c] += F_c dw/dcomp,  F_c = valid P_c albedo_c le_c / pi
//
// Both factors are prefix quantities, so these planes accumulate in the
// forward rounds, not in the sweep. dw/dcomp is the hand-derived adjoint of
// the weight chain (pt_phys.cuh), where the TPU kernel takes a jax.vjp. The
// pool factor inside w is the whole pool's size under tri_nee, for sphere
// picks too.
//
// What bounds it on an H100: the forward kernel's FP32/SFU issue and
// divergence, the adjoint's 180 (sphere) or 183 (triangle) operations per
// valid light sample when geometry planes are asked for, and the
// read-modify-writes of the planes, which the caches absorb (a thread owns its
// pixel; counted once each way the planes are (mp n_mat + 3 + 12 K + 27 Kt) *
// H * W * 4 bytes).
//
// What the design does about that, after render_fused.cu:
//  * one thread per pixel, blocks of 8 x 32 pixels (the launch shape a
//    policy, pt_sched.cuh Tile), the ragged edge masked; planes in
//    device memory, plane-major, zero-filled by the wrapper; no atomics; the
//    sky planes in registers;
//  * per bounce a thread stores the throughput before it, the material, one
//    byte of events and, of the light sample, its weight and the emitter's
//    row: 25 bytes (pt_phys.cuh `RoundStores`), where the TPU kernel stores 22
//    planes, in local memory: in shared memory (23 bytes with an int16
//    material, 53 KB a block at 8 bounces) the kernel ran 4-6% slower
//    (PERF.md). Albedo, emission, the emitter's radiance and material, dr and
//    drg are read or recomputed from the tables in the sweep;
//  * a thread adds into the planes of the material it hit and of the emitter
//    it sampled, and into the geometry planes of the one ordinal it sampled,
//    where the TPU kernel loops over every material and ordinal under masks.
//    A triangle pick touches no sphere plane and a sphere pick no triangle
//    plane;
//  * the bounce loop ends on a miss or total internal reflection only, never
//    on zero throughput (a path that a black albedo killed still owes its
//    later rounds' albedo gradient). Those extra rounds add exact zeros to the
//    radiance, the light sample included (0 * w with w finite), so the image
//    stays render_phys.cu's;
//  * tri_nee, rough_grad and counting are template parameters; next-event
//    estimation and the two caps are run-time values;
//  * the kernel is built for four blocks of 256 threads a multiprocessor
//    (__launch_bounds__(256, 4): 64 registers a thread; at another tile for
//    as many threads, pt_sched.cuh min_blocks). Left to itself ptxas
//    takes 105 to 120 registers and no spills, which fits two blocks; at 64
//    it spills 164 bytes and the kernel is 19% faster without geometry
//    planes and 13% faster with them (PERF.md): what holds the kernel is
//    latency that more resident warps hide, not the spills' traffic;
//  * its plane adds are read-modify-writes of device memory, which L1 and
//    L2 absorb: slots that keep the planes whose addresses depend on the
//    pixel alone (the sampled ordinal's geometry planes, the emitter's
//    emission planes) until the pixel's end took glossy's 274M geometry adds
//    off device memory and gained at most 2%, not on every card, while
//    costing up to 9% at other shapes; their own code (spills,
//    instructions) moved their time, not the adds (PERF.md). They stay as
//    measurement instantiations (ChipPlanes: in shared memory, geometry and
//    emission; in local memory, geometry only), as do warp-uniform loops
//    (+1.5% at glossy) and three blocks (-6% to +5% by shape).
//
// kCount: the counting instantiation adds the thread-rounds to counter[0],
// the light samples that counted to counter[1], its plane adds by family to
// counter[2..6] (material sweep, the hit's own emission, the sampled
// emitter's emission, sphere geometry, triangle geometry), and the warp
// lane-rounds
// (render_fused.cu: per sample, every lane waiting for the sample's longest
// path) to counter[7].
//
// render_pixel takes its records, its plane adds, its loops and where its
// pixel-constant planes live as a policy (pt_fused.cuh), as render_fused.cu's
// takes the first three: render_phys_fused_variant launches the measurement
// instantiations, each one policy away from the kernel (the plane adds, the
// geometry planes' included, into one register; the records in registers;
// the records in shared memory; these three without tri_nee; then with or
// without it warp-uniform loops, three blocks a multiprocessor, and the
// pixel-constant planes in shared or in local memory). No user path runs
// them.

#include <type_traits>

#include "pt_phys_grad.cuh"

namespace {

using namespace ptc;

// The plane pointers and sizes of one launch.
struct Planes {
  float* jac;   // (mp * n_mat + 3, rows, W)
  float* jgeo;  // (12 * n_em_cap, rows, W), or null
  float* jtri;  // (27 * tri_em_cap, rows, W), or null
  size_t hw;    // plane stride: the pixels of the block
  int n_em_cap, tri_em_cap;
};

// The most emitter materials whose emission planes a launch keeps on chip,
// and the most slots a thread keeps in local memory (kSlotsLocal).
constexpr int kMaxChipMats = 16;
constexpr int kMaxLocalSlots = 48;

// A thread's slots in a thread-private array (kSlotsLocal).
struct LocalField {
  static constexpr int kStride = 1;
  float* p;
  __device__ __forceinline__ float& operator[](int f) const { return p[f]; }
};

// Which planes whose addresses depend on the pixel alone a launch keeps on
// chip (Pol::kChipPlanes): the geometry planes of sphere ordinals below k and
// triangle ordinals below kt, and the emission planes S' of the block's
// emitter materials `emat` (n_emat of them).
struct ChipSplit {
  int k, kt, n_emat;
  const int* emat;
  __device__ __forceinline__ int mat_base() const { return 12 * k + 27 * kt; }
  __device__ __forceinline__ int used() const { return mat_base() + 3 * n_emat; }
  // The first slot of material m's emission planes, or -1 if they are not
  // on chip.
  __device__ __forceinline__ int mat_slot(int m) const {
    for (int i = 0; i < n_emat; ++i)
      if (emat[i] == m) return mat_base() + 3 * i;
    return -1;
  }
};

// A thread's slots of a ChipSplit, slot f at slot[f]: in dynamic shared
// memory (SmemField: the block's threads side by side, a warp's 32 accesses
// in distinct banks) or in local memory (LocalField). Sphere ordinal o from
// 12 o, triangle ordinal o from 12 k + 27 o, emitter material i from 12 k +
// 27 kt + 3 i, each in its planes' order. Zeroed at the pixel's start, they
// take the adds of their planes in the same order and are stored once at the
// pixel's end: into zero-filled planes that is the same bits as the adds in
// device memory.
template <class Field>
struct ChipPlanes : ChipSplit {
  Field slot;
  // The distance from one slot to the next.
  static constexpr size_t kStride = Field::kStride;
};

// The first `e` distinct emitter materials in [0, n_mat), in the order of the
// emitter tables: the live sphere emitters (em_list), then with tri_nee the
// live triangle emitters (tri_list); into `out` (shared), returning their
// number. One warp calls it, all 32 lanes; tests/test_torch_phys_fused_planes.py
// `emitter_materials` models it.
template <bool kTriNee>
__device__ __forceinline__ int find_emitter_materials(const Tables& sc, const int* em_list,
                                                      const int* tri_list, const int* counts,
                                                      int e, int* out) {
  const int lane = lane_id();
  const int n_s = counts[0];
  const int total = n_s + (kTriNee ? counts[1] : 0);
  int n = 0;
  for (int base = 0; base < total && n < e; base += 32) {
    const int i = base + lane;
    int m = -1;
    if (i < total) m = i < n_s ? sc.sph_m[em_list[i]] : sc.tri_m[tri_list[i - n_s]];
    if (m < 0 || m >= sc.n_mat) m = -1;
    for (int j = 0; j < n; ++j)
      if (out[j] == m) m = -1;
    // The lowest lane's material is next; every lane holding it drops it.
    for (unsigned left = __ballot_sync(0xffffffffu, m >= 0); left && n < e;
         left = __ballot_sync(0xffffffffu, m >= 0)) {
      const int next = __shfl_sync(0xffffffffu, m, __ffs(left) - 1);
      if (lane == 0) out[n] = next;
      ++n;
      if (m == next) m = -1;
    }
    __syncwarp();
  }
  return n;
}

// The plane adds the counting instantiation counts, by family: the material
// sweep's into the hit material's albedo, transparency and roughness planes;
// the emission planes' of the hit's own emission and of the sampled
// emitter's; the sphere and triangle geometry planes'.
struct AddCounts {
  int mat = 0, hit_em = 0, emitter_em = 0, sph = 0, tri = 0;
};

// F_c dw[comp] into the 3 kN geometry planes of one ordinal, plane i at
// j[i * stride], comp-major then colour.
template <int kN, class Adds>
__device__ __forceinline__ void add_ordinal(Adds& adds, float* j, size_t stride, float f_r,
                                            float f_g, float f_b, const float (&dw)[kN]) {
#pragma unroll
  for (int comp = 0; comp < kN; ++comp) {
    adds.add(j + (3 * comp) * stride, f_r * dw[comp]);
    adds.add(j + (3 * comp + 1) * stride, f_g * dw[comp]);
    adds.add(j + (3 * comp + 2) * stride, f_b * dw[comp]);
  }
}

// (r, g, b) into the three slots from `f` of a material's emission planes.
template <class Adds, class CP>
__device__ __forceinline__ void add_emission_slots(Adds& adds, const CP& cp, int f, float r,
                                                   float g, float b) {
  adds.add(&cp.slot[f], r);
  adds.add(&cp.slot[f + 1], g);
  adds.add(&cp.slot[f + 2], b);
}

// The timed kernel, and its measurement instantiations (pt_fused.cuh), each
// one policy away from it.
template <class Tl>
using KernelPolicyAt =
    Policy<LocalStores<kMaxRounds>, PlaneAdds, 0, 4, LaneLoops, kSlotsDevice, Tl>;
using KernelPolicy = KernelPolicyAt<DefaultTile>;
template <class Adds, class Loops = KernelPolicy::Loops, int kMinBlocks = KernelPolicy::kMinBlocks,
          int kSlots = KernelPolicy::kPlaneSlots>
using Like = Policy<LocalStores<kMaxRounds>, Adds, 0, kMinBlocks, Loops, kSlots>;
using SinkPolicy = Like<PlaneSink>;
using RegistersPolicy = Policy<LocalStores<kRegisterRounds>, PlaneAdds, kRegisterRounds, 1,
                               LaneLoops, KernelPolicy::kPlaneSlots>;
using MovedPolicy = Policy<SharedStores<DefaultTile>, PlaneAdds, 0, KernelPolicy::kMinBlocks,
                           KernelPolicy::Loops, KernelPolicy::kPlaneSlots>;
using WarpLoopsPolicy = Like<PlaneAdds, WarpLoops>;
using ThreeBlocksPolicy = Like<PlaneAdds, KernelPolicy::Loops, 3>;
template <int kSlots>
using SlotsPolicy = Like<PlaneAdds, KernelPolicy::Loops, KernelPolicy::kMinBlocks, kSlots>;

// One pixel's radiance into `img` and Jacobian planes into `pl`; returns the
// bounce rounds it ran and adds to `n_valid` the light samples that counted
// and to `cnt` its plane adds. `row` is the pixel's row in the block of rows
// from `row_start` (RowBlock, pt_common.cuh). `smem` is the block's dynamic
// shared memory: the records (SharedStores), then the slots of `cp`
// (Pol::kChipPlanes). `lanes` are the warp's lanes inside the image (the
// counting instantiation and WarpLoops).
template <bool kCount, bool kTriNee, bool kRough, class Pol>
__device__ __forceinline__ int render_pixel(const Tables& sc, const Emitters& em,
                                            const Params& p, float* __restrict__ img,
                                            const Planes& pl, ChipSplit split, int row, int col,
                                            int row_start, int height, int width, int spp,
                                            int max_bounces, uint32_t seed,
                                            int sample_offset, int jitter, bool nee,
                                            float inv_spp, unsigned lanes, int& n_valid,
                                            AddCounts& cnt, int& warp_rounds,
                                            unsigned char* smem) {
  constexpr int kMatPlanes = kRough ? 12 : 9;
  const RowBlock rb(row, col, row_start, width);
  const uint32_t pix = rb.pix;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = rb.frow;
  const float inf = pos_inf();
  const size_t hw = pl.hw;

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);

  typename Pol::Records st;
  st.place(smem, max_bounces + 1);
  constexpr bool kLocalSlots = Pol::kPlaneSlots == kSlotsLocal;
  constexpr bool kEmissionSlots = Pol::kPlaneSlots == kSlotsShared;
  float local_slots[kLocalSlots ? kMaxLocalSlots : 1];
  using Tl = typename Pol::Shape;
  ChipPlanes<std::conditional_t<kLocalSlots, LocalField, SmemField<float, Tl>>> cp;
  static_cast<ChipSplit&>(cp) = split;
  cp.slot = {nullptr};
  if constexpr (kLocalSlots) {
    cp.slot = LocalField{local_slots};
  } else if constexpr (Pol::kChipPlanes) {
    unsigned char* slots = smem;
    if constexpr (Pol::Records::kShared)
      slots += static_cast<size_t>(Pol::Records::kRoundBytes) * (max_bounces + 1) * Tl::kThreads;
    cp.slot = smem_field<float, Tl>(slots, 0);
  }
  if constexpr (Pol::kChipPlanes)
    for (int f = 0; f < cp.used(); ++f) cp.slot[f] = 0.0f;
  typename Pol::Adds adds;
  int rounds = 0;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky planes
  float* const jpix = pl.jac + rb.local;
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    bool prevd = false;
    // -- forward rounds, storing what the sweep needs --
    const int n_rounds = Pol::Loops::template forward<Pol::kUnroll>(max_bounces, lanes,
                                                                    [&](int bounce) {
      const Hit h = closest_hit(sc, q);
      const float pr = q.tr, pg = q.tg, pb = q.tb;
      st.pr[bounce] = pr;
      st.pg[bounce] = pg;
      st.pb[bounce] = pb;
      st.mat[bounce] = h.m;
      if (!(h.t < inf)) {
        st.ev[bounce] = kEvMiss;
        shade_miss(p, q);
        return true;
      }
      const Material mt = fetch_material(sc, h.m);
      const BounceRecord rec = shade_phys<false, kTriNee>(
          sc, em, h, mt, fetch_est(sc, em, h.m), nee, q, prevd, nullptr);
      st.ev[bounce] = static_cast<unsigned char>(rec.event);
      st.w[bounce] = rec.ls.w;
      st.row[bounce] = rec.ls.row;
      if (rec.event & kEvValid) {
        if (kCount) ++n_valid;
        // Emitter-geometry planes of the sampled ordinal, if it is tracked.
        const LightSample& ls = rec.ls;
        const float f_r = pr * mt.alb_r * ls.ler * kInvPi;
        const float f_g = pg * mt.alb_g * ls.leg * kInvPi;
        const float f_b = pb * mt.alb_b * ls.leb * kInvPi;
        if (ls.row >= 0) {
          if (ls.ord < pl.n_em_cap) {
            float dw[4];
            cone_w_adjoint(sc.sph + ls.row * kSphStride, rec.sox, rec.soy, rec.soz,
                           h.nx, h.ny, h.nz, rec.v1, ls.cp, ls.sn, ls.pool_f, dw);
            if (kCount) cnt.sph += 12;
            if (Pol::kChipPlanes && ls.ord < cp.k) {
              add_ordinal(adds, &cp.slot[12 * ls.ord], cp.kStride, f_r, f_g, f_b, dw);
            } else {
              add_ordinal(adds, pl.jgeo + static_cast<size_t>(12 * ls.ord) * hw + rb.local,
                          hw, f_r, f_g, f_b, dw);
            }
          }
        } else if (kTriNee && ls.ord < pl.tri_em_cap) {
          float dw[9];
          tri_w_adjoint(sc.tri + (~ls.row) * kTriStride, rec.sox, rec.soy, rec.soz,
                        h.nx, h.ny, h.nz, rec.v1, rec.v2, ls.pool_f, dw);
          if (kCount) cnt.tri += 27;
          if (Pol::kChipPlanes && ls.ord < cp.kt) {
            add_ordinal(adds, &cp.slot[12 * cp.k + 27 * ls.ord], cp.kStride, f_r, f_g, f_b,
                        dw);
          } else {
            add_ordinal(adds, pl.jtri + static_cast<size_t>(27 * ls.ord) * hw + rb.local, hw,
                        f_r, f_g, f_b, dw);
          }
        }
      }
      // Structural death only; zero throughput goes on (see above).
      return (rec.event & kDied) != 0;
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

    // -- sweep: last round down to 0, carrying S --
    float s_r = p.sky_r, s_g = p.sky_g, s_b = p.sky_b;
    Pol::Loops::template sweep<Pol::kUnroll>(n_rounds, lanes, [&](int b) {
      const float pr = st.pr[b], pg = st.pg[b], pb = st.pb[b];
      const int event = st.ev[b];
      if (event & kEvMiss) {
        k_r += pr;
        k_g += pg;
        k_b += pb;
        s_r = p.sky_r;
        s_g = p.sky_g;
        s_b = p.sky_b;
        return;
      }
      const int m = st.mat[b];
      const SweptHit sh = swept_hit(sc, em, st, b);
      const Material& mt = sh.mt;
      // A path that died here collects nothing downstream.
      const float sh_r = ((event & kDied) ? 0.0f : s_r) + sh.nee_r;
      const float sh_g = ((event & kDied) ? 0.0f : s_g) + sh.nee_g;
      const float sh_b = ((event & kDied) ? 0.0f : s_b) + sh.nee_b;
      const float ca_r = pr * sh_r, ca_g = pg * sh_g, ca_b = pb * sh_b;
      const bool addle = (event & kEvAddLe) != 0;
      if (m >= 0 && m < sc.n_mat) {
        float* j = jpix + static_cast<size_t>(kMatPlanes * m) * hw;
        if (kCount) cnt.mat += kRough ? 9 : 6;
        adds.add(j, ca_r);
        adds.add(j + hw, ca_g);
        adds.add(j + 2 * hw, ca_b);
        if (addle) {
          const int f = kEmissionSlots ? cp.mat_slot(m) : -1;
          if (kCount) cnt.hit_em += 3;
          if (f >= 0) {
            add_emission_slots(adds, cp, f, pr, pg, pb);
          } else {
            adds.add(j + 3 * hw, pr);
            adds.add(j + 4 * hw, pg);
            adds.add(j + 5 * hw, pb);
          }
        }
        const float dr = ratio_dr(mt, event);
        adds.add(j + 6 * hw, ca_r * dr);
        adds.add(j + 7 * hw, ca_g * dr);
        adds.add(j + 8 * hw, ca_b * dr);
        if (kRough) {
          const float drg = lobe_drg(mt, event);
          adds.add(j + 9 * hw, ca_r * drg);
          adds.add(j + 10 * hw, ca_g * drg);
          adds.add(j + 11 * hw, ca_b * drg);
        }
      }
      if (sh.valid && sh.emat >= 0 && sh.emat < sc.n_mat) {
        // The sampled emitter's emission, into its own material's planes.
        const int f = kEmissionSlots ? cp.mat_slot(sh.emat) : -1;
        if (kCount) cnt.emitter_em += 3;
        if (f >= 0) {
          add_emission_slots(adds, cp, f, sh.emw_r, sh.emw_g, sh.emw_b);
        } else {
          float* j = jpix + static_cast<size_t>(kMatPlanes * sh.emat + 3) * hw;
          adds.add(j, sh.emw_r);
          adds.add(j + hw, sh.emw_g);
          adds.add(j + 2 * hw, sh.emw_b);
        }
      }
      s_r = (addle ? mt.em_r : 0.0f) + mt.alb_r * sh_r;
      s_g = (addle ? mt.em_g : 0.0f) + mt.alb_g * sh_g;
      s_b = (addle ? mt.em_b : 0.0f) + mt.alb_b * sh_b;
    });
  }
  float* o = img + 3 * rb.local;
  o[0] = acc_r * inv_spp;
  o[1] = acc_g * inv_spp;
  o[2] = acc_b * inv_spp;
  float* k = jpix + static_cast<size_t>(kMatPlanes * sc.n_mat) * hw;
  k[0] = k_r;
  k[hw] = k_g;
  k[2 * hw] = k_b;
  if constexpr (Pol::kChipPlanes) {
    // The slots, each stored once into its plane.
    for (int f = 0; f < 12 * cp.k; ++f) pl.jgeo[f * hw + rb.local] = cp.slot[f];
    for (int f = 0; f < 27 * cp.kt; ++f) pl.jtri[f * hw + rb.local] = cp.slot[12 * cp.k + f];
    for (int i = 0; i < cp.n_emat; ++i) {
      float* j = jpix + static_cast<size_t>(kMatPlanes * cp.emat[i] + 3) * hw;
      const int f = cp.mat_base() + 3 * i;
      j[0] = cp.slot[f];
      j[hw] = cp.slot[f + 1];
      j[2 * hw] = cp.slot[f + 2];
    }
  }
  adds.flush(jpix);
  return rounds;
}

template <bool kCount, bool kTriNee, bool kRough, class Pol>
__global__ void __launch_bounds__(Pol::Shape::kThreads, Pol::kMinBlocks)
render_phys_fused_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                         int n_sph, const float* __restrict__ tri,
                         const int* __restrict__ tri_m, int n_tri,
                         const float* __restrict__ mat, int n_mat,
                         const int* __restrict__ em_list,
                         const float* __restrict__ le_sph,
                         const int* __restrict__ tri_list,
                         const float* __restrict__ le_tri,
                         const float* __restrict__ tri_area,
                         const float* __restrict__ mat_est,
                         const int* __restrict__ counts, const float* __restrict__ par,
                         float* __restrict__ img, float* __restrict__ jac,
                         float* __restrict__ jgeo, float* __restrict__ jtri,
                         unsigned long long* counter, int nee, int n_em_cap,
                         int tri_em_cap, int height, int width, int row_start, int rows,
                         int spp, int max_bounces, uint32_t seed, int sample_offset,
                         int jitter, float inv_spp, int chip_k, int chip_kt, int chip_e) {
  // The split comes last, so that it moves no other parameter: the code of
  // an instantiation with its planes in device memory then does not depend
  // on it, down to where its loops fall in the instruction cache (a shift of
  // two instructions there cost 0.2-0.7%; PERF.md).
  using Tl = typename Pol::Shape;
  int row, col;  // row: in the block of rows
  Tl::pixel(row, col);
  const bool in_range = col < width && row < rows;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes =
      kCount || Pol::Loops::kWarp ? __ballot_sync(0xffffffffu, in_range) : 0u;
  extern __shared__ float4 smem[];
  ChipSplit cp = {0, 0, 0, nullptr};
  if constexpr (Pol::kChipPlanes) {
    // The block's emitter materials whose emission planes live on chip,
    // found by its first warp.
    __shared__ int chip_emat[kMaxChipMats];
    __shared__ int chip_n_emat;
    cp = {chip_k, chip_kt, 0, chip_emat};
    if (Pol::kPlaneSlots == kSlotsShared && chip_e > 0) {
      if (Tl::warp() == 0) {
        const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
        const int n = find_emitter_materials<kTriNee>(sc, em_list, tri_list, counts, chip_e,
                                                      chip_emat);
        if (Tl::tid() == 0) chip_n_emat = n;
      }
      __syncthreads();
      cp.n_emat = chip_n_emat;
    }
  }
  int rounds = 0, n_valid = 0, warp_rounds = 0;
  AddCounts cnt;
  if (in_range) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est,
                         counts[0], counts[1]};
    const Planes pl = {jac, jgeo, jtri,
                       static_cast<size_t>(rows) * static_cast<size_t>(width),
                       n_em_cap, tri_em_cap};
    rounds = render_pixel<kCount, kTriNee, kRough, Pol>(
        sc, em, p, img, pl, cp, row, col, row_start, height, width, spp, max_bounces, seed,
        sample_offset, jitter, nee != 0, inv_spp, lanes, n_valid, cnt, warp_rounds,
        reinterpret_cast<unsigned char*>(smem));
  }
  if (kCount) {
    // The wrapper's order: render_physical_grad.COUNTERS.
    block_add<Tl>(rounds, counter);
    block_add<Tl>(n_valid, counter + 1);
    block_add<Tl>(cnt.mat, counter + 2);
    block_add<Tl>(cnt.hit_em, counter + 3);
    block_add<Tl>(cnt.emitter_em, counter + 4);
    block_add<Tl>(cnt.sph, counter + 5);
    block_add<Tl>(cnt.tri, counter + 6);
    block_add<Tl>(warp_rounds, counter + 7);
  }
}

// Launch render_phys_fused_kernel<kCount, kTriNee, kRough, Pol>; returns
// cudaGetLastError(), or cudaErrorInvalidValue where max_bounces + 1 exceeds
// the records, n_mat the int16 of shared-memory records, a cap has no planes
// or the planes on chip (chip_k sphere and chip_kt triangle ordinals, chip_e
// emitter materials; ignored without Pol::kChipPlanes) exceed the caps.
template <bool kCount, bool kTriNee, bool kRough, class Pol>
int launch(const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
           int n_tri, const float* mat, int n_mat, const int* em_list, const float* le_sph,
           const int* tri_list, const float* le_tri, const float* tri_area,
           const float* mat_est, const int* counts, const float* par, float* img, float* jac,
           float* jgeo, float* jtri, unsigned long long* counter, int nee, int n_em_cap,
           int tri_em_cap, int chip_k, int chip_kt, int chip_e, int height, int width,
           int row_start, int rows, int spp, int max_bounces, unsigned int seed,
           int sample_offset, int jitter, int device, void* stream) {
  constexpr int kRounds = Pol::kUnroll ? Pol::kUnroll : kMaxRounds;
  if (!Pol::kChipPlanes) chip_k = chip_kt = chip_e = 0;
  const int slots = 12 * chip_k + 27 * chip_kt + 3 * chip_e;
  if (max_bounces + 1 > kRounds || (Pol::Records::kShared && n_mat > 32767) ||
      n_em_cap < 0 || tri_em_cap < 0 || (n_em_cap > 0 && !jgeo) ||
      (tri_em_cap > 0 && (!jtri || !kTriNee)) || chip_k < 0 || chip_k > n_em_cap ||
      chip_kt < 0 || chip_kt > tri_em_cap || chip_e < 0 || chip_e > kMaxChipMats ||
      (Pol::kPlaneSlots == kSlotsLocal && (slots > kMaxLocalSlots || chip_e > 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  using Tl = typename Pol::Shape;
  const auto kernel = render_phys_fused_kernel<kCount, kTriNee, kRough, Pol>;
  const size_t records = Pol::Records::kShared
      ? static_cast<size_t>(max_bounces + 1) * Tl::kThreads * Pol::Records::kRoundBytes : 0;
  const size_t smem = records + (Pol::kPlaneSlots == kSlotsShared
                                     ? sizeof(float) * Tl::kThreads * static_cast<size_t>(slots)
                                     : 0);
  if (smem > 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<Tl::grid(rows, width), Tl::block(), smem, static_cast<cudaStream_t>(stream)>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
      le_tri, tri_area, mat_est, counts, par, img, jac, jgeo, jtri, counter, nee,
      n_em_cap, tri_em_cap, height, width, row_start, rows, spp, max_bounces, seed,
      sample_offset, jitter, inv_spp, chip_k, chip_kt, chip_e);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<false, false, false, KernelPolicy>);

template <bool kCount, bool kTriNee, class Pol = KernelPolicy>
LaunchFn pick_rough(int rough_grad) {
  return rough_grad ? launch<kCount, kTriNee, true, Pol>
                    : launch<kCount, kTriNee, false, Pol>;
}

}  // namespace

#ifndef PT_TILE_POINT
// The most bounces the physical gradient kernels take (render_phys_fused and
// render_phys_bwd); the wrappers ask and raise above it.
extern "C" int render_phys_grad_max_bounces() { return kMaxRounds - 1; }

// C entry, bound with ctypes. Tables, emitter tables, `counts`, `par` and the
// block of `rows` rows from `row_start` as for render_phys; `img` is (rows,
// width, 3) float32; `jac` is (mp * n_mat + 3, rows, width) float32 with mp =
// 12 if `rough_grad` else 9; `jgeo` is (12 * n_em_cap, rows, width) or null
// when n_em_cap is 0; `jtri` is (27 * tri_em_cap, rows, width) or null when
// tri_em_cap is 0 (it must be 0 without `tri_nee`). The planes must arrive
// zero-filled. `counter` is null, or eight zeroed int64 that receive the
// counts of render_physical_grad.COUNTERS. Launches on `stream` of device
// `device` and returns cudaGetLastError(), or cudaErrorInvalidValue if
// max_bounces is above the cap or a cap has no planes.
extern "C" int render_phys_fused(const float* sph, const int* sph_m, int n_sph,
                                 const float* tri, const int* tri_m, int n_tri,
                                 const float* mat, int n_mat, const int* em_list,
                                 const float* le_sph, const int* tri_list,
                                 const float* le_tri, const float* tri_area,
                                 const float* mat_est, const int* counts,
                                 const float* par, float* img, float* jac,
                                 float* jgeo, float* jtri,
                                 unsigned long long* counter, int nee, int tri_nee,
                                 int rough_grad, int n_em_cap, int tri_em_cap, int height,
                                 int width, int row_start, int rows, int spp, int max_bounces,
                                 unsigned int seed, int sample_offset, int jitter, int device,
                                 void* stream) {
  const LaunchFn go = counter
      ? (tri_nee ? pick_rough<true, true>(rough_grad) : pick_rough<true, false>(rough_grad))
      : (tri_nee ? pick_rough<false, true>(rough_grad) : pick_rough<false, false>(rough_grad));
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, img, jac, jgeo, jtri, counter, nee,
            n_em_cap, tri_em_cap, 0, 0, 0, height, width, row_start, rows, spp, max_bounces,
            seed, sample_offset, jitter, device, stream);
}

// A measurement instantiation of render_phys_fused (pt_fused.cuh `Variant`),
// with its arguments but no counter or rough_grad; tri_nee (and triangle
// planes) only for the variants of B4's own policies (kVarWarpLoops and
// after); `chip_k`, `chip_kt` and `chip_e` are the sphere ordinals, triangle
// ordinals and emitter materials whose planes the slots variants keep in
// slots (the wrapper's `chip_plane_split`; the others ignore them, and the
// planes of the first chip_k and chip_kt ordinals need no zero fill).
// Returns cudaErrorInvalidValue for an unknown variant, tri_nee where it is
// not taken, where max_bounces + 1 exceeds the variant's records or where
// the slots exceed the caps.
extern "C" int render_phys_fused_variant(int variant, const float* sph, const int* sph_m,
                                         int n_sph, const float* tri, const int* tri_m,
                                         int n_tri, const float* mat, int n_mat,
                                         const int* em_list, const float* le_sph,
                                         const int* tri_list, const float* le_tri,
                                         const float* tri_area, const float* mat_est,
                                         const int* counts, const float* par, float* img,
                                         float* jac, float* jgeo, float* jtri, int nee,
                                         int tri_nee, int n_em_cap, int tri_em_cap, int chip_k,
                                         int chip_kt, int chip_e, int height, int width,
                                         int row_start, int rows, int spp, int max_bounces,
                                         unsigned int seed, int sample_offset, int jitter,
                                         int device, void* stream) {
  LaunchFn go = nullptr;
  if (!tri_nee) {
    switch (variant) {
      case kVarSink: go = launch<false, false, false, SinkPolicy>; break;
      case kVarRegisters: go = launch<false, false, false, RegistersPolicy>; break;
      case kVarRecordsMoved: go = launch<false, false, false, MovedPolicy>; break;
      case kVarWarpLoops: go = launch<false, false, false, WarpLoopsPolicy>; break;
      case kVarThreeBlocks: go = launch<false, false, false, ThreeBlocksPolicy>; break;
      case kVarSharedSlots: go = launch<false, false, false, SlotsPolicy<kSlotsShared>>; break;
      case kVarLocalSlots: go = launch<false, false, false, SlotsPolicy<kSlotsLocal>>; break;
    }
  } else {
    switch (variant) {
      case kVarWarpLoops: go = launch<false, true, false, WarpLoopsPolicy>; break;
      case kVarThreeBlocks: go = launch<false, true, false, ThreeBlocksPolicy>; break;
      case kVarSharedSlots: go = launch<false, true, false, SlotsPolicy<kSlotsShared>>; break;
      case kVarLocalSlots: go = launch<false, true, false, SlotsPolicy<kSlotsLocal>>; break;
    }
  }
  if (!go) return static_cast<int>(cudaErrorInvalidValue);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, img, jac, jgeo, jtri, nullptr, nee,
            n_em_cap, tri_em_cap, chip_k, chip_kt, chip_e, height, width, row_start, rows, spp,
            max_bounces, seed, sample_offset, jitter, device, stream);
}

#else
// The sweep library's entry at point PT_TILE_POINT (pt_sched.cuh TileAt):
// render_phys_fused's arguments at that launch shape.
extern "C" int PT_TILED(render_phys_fused)(
    const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
    int n_tri, const float* mat, int n_mat, const int* em_list, const float* le_sph,
    const int* tri_list, const float* le_tri, const float* tri_area, const float* mat_est,
    const int* counts, const float* par, float* img, float* jac, float* jgeo, float* jtri,
    unsigned long long* counter, int nee, int tri_nee, int rough_grad, int n_em_cap,
    int tri_em_cap, int height, int width, int row_start, int rows, int spp, int max_bounces,
    unsigned int seed, int sample_offset, int jitter, int device, void* stream) {
  using Pol = KernelPolicyAt<TileAt<PT_TILE_POINT>>;
  const LaunchFn go =
      counter ? (tri_nee ? pick_rough<true, true, Pol>(rough_grad)
                         : pick_rough<true, false, Pol>(rough_grad))
              : (tri_nee ? pick_rough<false, true, Pol>(rough_grad)
                         : pick_rough<false, false, Pol>(rough_grad));
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, counts, par, img, jac, jgeo, jtri, counter, nee,
            n_em_cap, tri_em_cap, 0, 0, 0, height, width, row_start, rows, spp, max_bounces,
            seed, sample_offset, jitter, device, stream);
}
#endif
