// Two-pass backward kernel of the physical tier for Hopper (sm_90a): the
// parity oracle of the fused kernel (render_phys_fused.cu).
//
// Replaces the Pallas TPU kernel `_phys_bwd_kernel` of
// path_tracer_c_tpu/ops/pallas_physical.py. Given the cotangent g of the
// radiance image it replays the forward rounds, sweeps them from the last
// round down and reduces, over all pixels, samples and bounces, the
// cotangents themselves:
//
//   out (n_mat + 1, 8): per material albedo[3], emission colour[3], emission
//       strength, transparency; row n_mat holds the sky's three;
//   geo (max(n_em_cap, 1), 4): per sphere-emitter ordinal below n_em_cap the
//       centre's three and the radius', through the cone weight only.
//
// Its contract is narrower than the fused kernel's: no triangle vertices
// and no roughness. With gP = g / spp * P at a hit on material m, S_h the
// suffix radiance (0 after total internal reflection), nee and the sampled
// emitter (le, w, valid, its material e) as in render_phys_fused.cu:
//
//   albedo[m, c]       += gP_c (S_h_c + nee_c)
//   emission col[m, c] += addle gP_c est[m]
//   emission str[m]    += addle sum_c gP_c eco[m, c]
//   transparency[m]    += sum_c albedo[m, c] gP_c (S_h_c + nee_c) dr
//   emission col[e, c] += valid gP_c albedo[m, c] w / pi est[e]
//   emission str[e]    += valid sum_c gP_c albedo[m, c] w / pi eco[e, c]
//   sky[c]             += g_c / spp P_c at a miss, and g_c / spp P_end
//   geo[k, comp]       += valid (sum_c gP_c albedo[m, c] le_c / pi) dw/dcomp
//
// The geometry term needs prefix quantities and g only, so it is added in the
// forward round (the TPU kernel adds it in the sweep; the sum is the same).
//
// Five add sites carry the reduction (Site below): a hit's material row
// (albedo and transparency), its emission (where single counting adds it),
// the sampled emitter's emission, the emitter's geometry (forward rounds)
// and the sky (once a pixel).
//
// What bounds it on an H100: the forward kernel's FP32/SFU issue and
// divergence, then the reduction. On the TPU the grid runs in order and
// program (0, 0) zeroes the output; on the card the blocks run at once, and
// the lanes of a warp shade neighbouring pixels, which mostly hit the same
// few materials. A float atomicAdd into shared memory is a compare-and-swap
// loop (ATOMS.CAST.SPIN), so 32 lanes on one address take 32 trips: the
// parent design, every lane's atomics into one table a block, spent 43% of
// the kernel there (PERF.md).
//
// What the design does about that:
//  * one thread per pixel, blocks of 8 x 32 pixels (the launch shape a
//    policy, pt_sched.cuh Tile), forward rounds and stores shared with the
//    fused kernel (pt_phys.cuh, pt_phys_grad.cuh);
//  * both loops over a sample's rounds are warp-uniform: the forward rounds
//    end when no lane of the warp is alive, the sweep runs the warp's longest
//    lane's rounds, a lane taking its own rounds from its last down. Every
//    lane of the warp inside the image therefore reaches every add site in
//    the same order, with the same mask;
//  * at each site the lanes that add to one row sum their values first
//    (__match_any_sync, then a pairwise tree of shuffles in lane order,
//    group_sum), and the group's lowest lane adds the sums into its warp's
//    own table in shared memory with plain adds (WarpTables): no atomics. A
//    hit's material row and its emission are one add of 8 values;
//  * a block's tables (one a warp) are summed in a fixed order into its column of a
//    partial-sums buffer, and a second kernel sums the blocks in a fixed
//    order (render_phys_bwd_sum_kernel). The wrapper allocates the buffer;
//    the second pass writes `out` and `geo`. Every addition's order is fixed,
//    so two launches agree bit for bit;
//  * built for three blocks a multiprocessor (__launch_bounds__(256, 3): 80
//    registers and 160 bytes of spill), which ran 1-3% faster than four
//    blocks at 64 registers (PERF.md); at another tile for as many threads
//    (768; pt_sched.cuh min_blocks), so no tile of 512 threads;
//  * the NaN guard of the TPU kernel's sweep (stores of rounds that never
//    ran) has no counterpart: a thread sweeps only the rounds it ran.
//
// The measurement instantiations (BwdVariant), which no user path runs, are
// the same body with the values summed into one register a thread (Sink) or
// the records in shared memory (SharedStores).
//
// kCount: the counting instantiation adds to 24 int64 counters (Counter
// below): the forward and the sweep's thread-rounds and warp lane-rounds,
// and, for each site, the lanes that add, the distinct rows among a warp's
// adding lanes (summed over the warp's visits), the largest number of a
// warp's lanes on one row (the serial depth of per-lane atomics, summed
// likewise) and the warp visits with an adding lane.

#include "pt_phys_grad.cuh"

namespace {

using namespace ptc;

// The add sites, as the counting instantiation counts them (the kernel adds
// a hit's row and its emission, kSiteMat and kSiteMatLe, in one add).
enum Site : int { kSiteMat = 0, kSiteMatLe, kSiteEmitter, kSiteGeo, kSiteSky, kNumSites };

// The counters, in this order (ops/render_physical_grad.py BWD_COUNTS).
enum Counter : int {
  kCntFwdRounds = 0,
  kCntFwdWarp,
  kCntSweepRounds,
  kCntSweepWarp,
  kCntSite0,  // then, a site after another: lanes, groups, depth, visits
  kNumCounters = kCntSite0 + 4 * kNumSites,
};

// Sum v over the lanes of `mask` (each must call it) that share `peers`: the
// group's lowest lane ends with the group's sums, added in a fixed pairwise
// order (lanes ascending). A lane adds the next peer above it that is not
// done; then the peers at odd rank are done, and the ranks halve. The loop is
// warp-uniform over `mask` (__any_sync): no lane leaves it alone.
template <int N>
__device__ __forceinline__ void group_sum(unsigned mask, unsigned peers, float (&v)[N]) {
  const int lane = lane_id();
  int rank = __popc(peers & ((1u << lane) - 1u));
  unsigned above = peers & ~((2u << lane) - 1u);
  while (__any_sync(mask, above != 0u)) {
    const int next = __ffs(above) - 1;
    const int src = next < 0 ? lane : next;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const float t = __shfl_sync(mask, v[j], src);
      if (next >= 0) v[j] += t;
    }
    above &= ~__ballot_sync(mask, rank & 1);
    rank >>= 1;
  }
}

// The kernel's reduction in a block of tile Tl. add() is called by every
// lane of `lanes` (the warp's lanes inside the image) at every site; `on`: this lane adds; `idx`:
// the table entry of its first value (a site adds at a fixed column of a
// row, so lanes on one row share idx); v: the N values, for idx, idx + 1, ...
// The lanes that share idx sum first (group_sum) and the lowest adds the
// sums into the warp's own table: a table's leaders write distinct rows at a
// site, and __syncwarp orders one site's writes before the next's, so plain
// adds suffice.
template <class Tl>
struct WarpTables {
  static constexpr int kCopies = Tl::kWarps;  // tables a block
  float* tab;                                 // this warp's
  __device__ __forceinline__ WarpTables(float* tabs, int n_acc)
      : tab(tabs + Tl::warp() * n_acc) {}
  template <int N>
  __device__ __forceinline__ void add(unsigned lanes, bool on, int idx, float (&v)[N]) {
    const unsigned mask = __ballot_sync(lanes, on);
    if (on) {
      const unsigned peers = __match_any_sync(mask, idx);
      group_sum(mask, peers, v);
      if (lane_id() == __ffs(peers) - 1) {
#pragma unroll
        for (int j = 0; j < N; ++j) tab[idx + j] += v[j];
      }
    }
    __syncwarp(lanes);
  }
  __device__ __forceinline__ void flush() {}
};

// The measurement instantiation's stand-in: the same values summed into one
// register and added once a pixel (flush), so that the kernel against it
// prices the reduction. Its tables are not the cotangents.
struct SinkReduce {
  static constexpr int kCopies = 1;
  float* tab;
  float sum = 0.0f;
  __device__ __forceinline__ SinkReduce(float* tabs, int) : tab(tabs) {}
  template <int N>
  __device__ __forceinline__ void add(unsigned, bool on, int, float (&v)[N]) {
    if (on) {
#pragma unroll
      for (int j = 0; j < N; ++j) sum += v[j];
    }
  }
  __device__ __forceinline__ void flush() { atomicAdd(tab, sum); }
};

// The blocks of DefaultTile a multiprocessor ptxas budgets registers for, in
// every instantiation.
constexpr int kBwdMinBlocks = 3;

// An instantiation of the two-pass kernel: its records (pt_phys_grad.cuh),
// its reduction and its launch shape (pt_sched.cuh Tile).
template <class Records_, class Reduce_, class Shape_ = DefaultTile>
struct BwdPolicy {
  using Records = Records_;
  using Red = Reduce_;
  using Shape = Shape_;
  static constexpr int kMinBlocks = min_blocks<Shape_, kBwdMinBlocks>();
};

// The timed kernel at launch shape Tl (the sweep library's instantiations),
// and the timed kernel.
template <class Tl>
using KernelPolicyAt = BwdPolicy<LocalStores<kMaxRounds>, WarpTables<Tl>, Tl>;
using KernelPolicy = KernelPolicyAt<DefaultTile>;

// The measurement instantiations (ops/render_physical_grad.py BWD_VARIANTS),
// each one policy away from the kernel: the adds into one register; the
// records in shared memory.
enum BwdVariant : int { kBwdSink = 0, kBwdSharedRecords = 1 };

// The counting instantiation's counts of a site: every lane of `lanes` calls
// it; the block's counters are in shared memory.
__device__ __forceinline__ void count_site(unsigned long long* cnt, int site, unsigned lanes,
                                           bool on, int idx) {
  const unsigned mask = __ballot_sync(lanes, on);
  if (!on) return;
  const unsigned peers = __match_any_sync(mask, idx);
  const int depth = __reduce_max_sync(mask, __popc(peers));
  unsigned long long* c = cnt + kCntSite0 + 4 * site;
  const int lane = lane_id();
  if (lane == __ffs(peers) - 1) atomicAdd(c + 1, 1ull);
  if (lane == __ffs(mask) - 1) {
    atomicAdd(c, static_cast<unsigned long long>(__popc(mask)));
    atomicAdd(c + 2, static_cast<unsigned long long>(depth));
    atomicAdd(c + 3, 1ull);
  }
}

// One pixel's cotangents into its tables: rows of 8 per material, the sky's
// row, then rows of 4 per tracked emitter ordinal. A table's material row
// holds albedo[3], transparency, emission colour[3], emission strength, so
// that a hit adds its row's 8 and a sampled emitter the last 4 in one run
// each (the second pass puts `out` in its order). `row` is the pixel's row
// in the block of rows from `row_start` (RowBlock, pt_common.cuh); `g` holds
// the block's rows. `lanes`: the warp's lanes inside the image, all of which
// call it. `smem`: the block's records, where they are shared.
template <bool kCount, bool kTriNee, class Pol>
__device__ __forceinline__ void backward_pixel(
    const Tables& sc, const Emitters& em, const float* __restrict__ mat_eco,
    const Params& p, const float* __restrict__ g, typename Pol::Red& red,
    unsigned long long* cnt, int n_em_cap, int row, int col, int row_start, int height,
    int width, int spp, int max_bounces, uint32_t seed, int sample_offset, int jitter,
    bool nee, float inv_spp, unsigned lanes, unsigned char* smem) {
  const RowBlock rb(row, col, row_start, width);
  const uint32_t pix = rb.pix;
  const float fw = static_cast<float>(width);
  const float fh = static_cast<float>(height);
  const float fcol = static_cast<float>(col);
  const float frow = rb.frow;
  const float inf = pos_inf();
  const int geo0 = 8 * (sc.n_mat + 1);
  const bool first = lane_id() == __ffs(lanes) - 1;
  const int n_lanes = __popc(lanes);

  float pdx, pdy, pdz;
  camera_dir(p, fcol + 0.5f, frow + 0.5f, fw, fh, pdx, pdy, pdz);
  const float* gp = g + 3 * rb.local;
  const float g_r = gp[0] * inv_spp, g_g = gp[1] * inv_spp, g_b = gp[2] * inv_spp;

  typename Pol::Records st;
  st.place(smem, max_bounces + 1);
  int fwd_rounds = 0, fwd_warp = 0, sweep_rounds = 0, sweep_warp = 0;
  float k_r = 0.0f, k_g = 0.0f, k_b = 0.0f;  // the sky's cotangent
  for (int s = 0; s < spp; ++s) {
    Path q = start_path(p, pix, fcol, frow, fw, fh, pdx, pdy, pdz,
                        static_cast<uint32_t>(s + sample_offset), seed, jitter);
    bool prevd = false, alive = true;
    int n_rounds = 0;
    // -- forward rounds, until no lane of the warp is alive --
    for (int bounce = 0; bounce <= max_bounces; ++bounce) {
      if (!__any_sync(lanes, alive)) break;
      bool geo_on = false;
      int geo_idx = geo0;
      float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (alive) {
        n_rounds = bounce + 1;
        const Hit h = closest_hit(sc, q);
        const float pr = q.tr, pg = q.tg, pb = q.tb;
        st.pr[bounce] = pr;
        st.pg[bounce] = pg;
        st.pb[bounce] = pb;
        st.mat[bounce] = h.m;
        if (!(h.t < inf)) {
          st.ev[bounce] = kEvMiss;
          shade_miss(p, q);
          alive = false;
        } else {
          const Material mt = fetch_material(sc, h.m);
          const BounceRecord rec = shade_phys<false, kTriNee>(
              sc, em, h, mt, fetch_est(sc, em, h.m), nee, q, prevd, nullptr);
          st.ev[bounce] = static_cast<unsigned char>(rec.event);
          st.w[bounce] = rec.ls.w;
          st.row[bounce] = rec.ls.row;
          const LightSample& ls = rec.ls;
          if ((rec.event & kEvValid) && ls.row >= 0 && ls.ord < n_em_cap) {
            // The sampled sphere emitter's centre and radius, through w.
            float dw[4];
            cone_w_adjoint(sc.sph + ls.row * kSphStride, rec.sox, rec.soy, rec.soz, h.nx,
                           h.ny, h.nz, rec.v1, ls.cp, ls.sn, ls.pool_f, dw);
            const float cot_w = (g_r * pr * mt.alb_r * ls.ler + g_g * pg * mt.alb_g * ls.leg +
                                 g_b * pb * mt.alb_b * ls.leb) * kInvPi;
#pragma unroll
            for (int comp = 0; comp < 4; ++comp) dg[comp] = cot_w * dw[comp];
            geo_on = true;
            geo_idx = geo0 + 4 * ls.ord;
          }
          if (rec.event & kDied) alive = false;
        }
      }
      if constexpr (kCount) {
        fwd_rounds += n_rounds == bounce + 1;
        if (first) fwd_warp += n_lanes;
        count_site(cnt, kSiteGeo, lanes, geo_on, geo_idx);
      }
      red.add(lanes, geo_on, geo_idx, dg);
    }
    // The end of the budget: total += P_end * sky.
    k_r += g_r * q.tr;
    k_g += g_g * q.tg;
    k_b += g_b * q.tb;

    // -- sweep: the warp's longest lane's rounds; a lane from its last down,
    // carrying S --
    const int widest = __reduce_max_sync(lanes, n_rounds);
    float s_r = p.sky_r, s_g = p.sky_g, s_b = p.sky_b;
    for (int i = 0; i < widest; ++i) {
      const bool swept = i < n_rounds;
      bool on_mat = false, on_le = false, on_em = false;
      int m = 0, e = 0;
      float da[4], dl[4] = {0.0f, 0.0f, 0.0f, 0.0f}, de[4];
      if (swept) {
        const int b = n_rounds - 1 - i;
        const float gpr = g_r * st.pr[b], gpg = g_g * st.pg[b], gpb = g_b * st.pb[b];
        const int event = st.ev[b];
        if (event & kEvMiss) {
          k_r += gpr;
          k_g += gpg;
          k_b += gpb;
          s_r = p.sky_r;
          s_g = p.sky_g;
          s_b = p.sky_b;
        } else {
          m = st.mat[b];
          const SweptHit sh = swept_hit(sc, em, st, b);
          const Material& mt = sh.mt;
          const float sh_r = ((event & kDied) ? 0.0f : s_r) + sh.nee_r;
          const float sh_g = ((event & kDied) ? 0.0f : s_g) + sh.nee_g;
          const float sh_b = ((event & kDied) ? 0.0f : s_b) + sh.nee_b;
          const float da_r = gpr * sh_r, da_g = gpg * sh_g, da_b = gpb * sh_b;
          const bool addle = (event & kEvAddLe) != 0;
          on_mat = m >= 0 && m < sc.n_mat;
          on_le = on_mat && addle;
          if (on_mat) {
            const float cot_ratio = mt.alb_r * da_r + mt.alb_g * da_g + mt.alb_b * da_b;
            da[0] = da_r;
            da[1] = da_g;
            da[2] = da_b;
            da[3] = cot_ratio * ratio_dr(mt, event);
          }
          if (on_le) {
            const float es = em.mat_est[m];
            const float* eco = mat_eco + 3 * m;
            dl[0] = gpr * es;
            dl[1] = gpg * es;
            dl[2] = gpb * es;
            dl[3] = gpr * eco[0] + gpg * eco[1] + gpb * eco[2];
          }
          on_em = sh.valid && sh.emat >= 0 && sh.emat < sc.n_mat;
          if (on_em) {
            // The sampled emitter's radiance le = eco * est of its material.
            e = sh.emat;
            const float dle_r = gpr * mt.alb_r * kInvPi * sh.w;
            const float dle_g = gpg * mt.alb_g * kInvPi * sh.w;
            const float dle_b = gpb * mt.alb_b * kInvPi * sh.w;
            const float es = em.mat_est[e];
            const float* eco = mat_eco + 3 * e;
            de[0] = dle_r * es;
            de[1] = dle_g * es;
            de[2] = dle_b * es;
            de[3] = dle_r * eco[0] + dle_g * eco[1] + dle_b * eco[2];
          }
          s_r = (addle ? mt.em_r : 0.0f) + mt.alb_r * sh_r;
          s_g = (addle ? mt.em_g : 0.0f) + mt.alb_g * sh_g;
          s_b = (addle ? mt.em_b : 0.0f) + mt.alb_b * sh_b;
        }
      }
      if constexpr (kCount) {
        sweep_rounds += swept;
        if (first) sweep_warp += n_lanes;
        count_site(cnt, kSiteMat, lanes, on_mat, 8 * m);
        count_site(cnt, kSiteMatLe, lanes, on_le, 8 * m + 4);
        count_site(cnt, kSiteEmitter, lanes, on_em, 8 * e + 4);
      }
      // The hit's row: albedo and transparency, then its emission (zeros
      // where single counting skipped it).
      float dm[8] = {da[0], da[1], da[2], da[3], dl[0], dl[1], dl[2], dl[3]};
      red.add(lanes, on_mat, 8 * m, dm);
      red.add(lanes, on_em, 8 * e + 4, de);
    }
  }
  float dk[3] = {k_r, k_g, k_b};
  if constexpr (kCount) {
    count_site(cnt, kSiteSky, lanes, true, 8 * sc.n_mat);
    atomicAdd(cnt + kCntFwdRounds, static_cast<unsigned long long>(fwd_rounds));
    atomicAdd(cnt + kCntFwdWarp, static_cast<unsigned long long>(fwd_warp));
    atomicAdd(cnt + kCntSweepRounds, static_cast<unsigned long long>(sweep_rounds));
    atomicAdd(cnt + kCntSweepWarp, static_cast<unsigned long long>(sweep_warp));
  }
  red.add(lanes, true, 8 * sc.n_mat, dk);
  red.flush();
}

template <bool kCount, bool kTriNee, class Pol>
__global__ void __launch_bounds__(Pol::Shape::kThreads, Pol::kMinBlocks)
render_phys_bwd_kernel(const float* __restrict__ sph, const int* __restrict__ sph_m,
                       int n_sph, const float* __restrict__ tri,
                       const int* __restrict__ tri_m, int n_tri,
                       const float* __restrict__ mat, int n_mat,
                       const int* __restrict__ em_list, const float* __restrict__ le_sph,
                       const int* __restrict__ tri_list, const float* __restrict__ le_tri,
                       const float* __restrict__ tri_area,
                       const float* __restrict__ mat_est,
                       const float* __restrict__ mat_eco,
                       const int* __restrict__ counts, const float* __restrict__ par,
                       const float* __restrict__ g, float* __restrict__ partials,
                       unsigned long long* counter, int nee, int n_em_cap, int height,
                       int width, int row_start, int rows, int spp, int max_bounces,
                       uint32_t seed, int sample_offset, int jitter, float inv_spp,
                       int records_offset) {
  using Red = typename Pol::Red;
  using Tl = typename Pol::Shape;
  extern __shared__ float4 smem4[];
  float* tabs = reinterpret_cast<float*>(smem4);
  __shared__ unsigned long long cnt[kCount ? kNumCounters : 1];
  const int n_acc = 8 * (n_mat + 1) + 4 * max(n_em_cap, 1);
  const int tid = Tl::tid();
  for (int i = tid; i < Red::kCopies * n_acc; i += Tl::kThreads) tabs[i] = 0.0f;
  if (kCount && tid < kNumCounters) cnt[tid] = 0;
  __syncthreads();
  int row, col;  // row: in the block of rows
  Tl::pixel(row, col);
  const bool in_range = col < width && row < rows;
  // The warp's lanes inside the image, taken by all 32 lanes before the
  // range test.
  const unsigned lanes = __ballot_sync(0xffffffffu, in_range);
  if (in_range) {
    const Params p = *reinterpret_cast<const Params*>(par);
    const Tables sc = {sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat};
    const Emitters em = {em_list, le_sph, tri_list, le_tri, tri_area, mat_est,
                         counts[0], counts[1]};
    Red red(tabs, n_acc);
    backward_pixel<kCount, kTriNee, Pol>(
        sc, em, mat_eco, p, g, red, cnt, n_em_cap, row, col, row_start, height, width, spp,
        max_bounces, seed, sample_offset, jitter, nee != 0, inv_spp, lanes,
        reinterpret_cast<unsigned char*>(smem4) + records_offset);
  }
  __syncthreads();
  // The block's tables, summed in a fixed order, into its column of the
  // partial sums (entry-major: entry e of block j at e * n_blocks + j).
  const int n_blocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  for (int e = tid; e < n_acc; e += Tl::kThreads) {
    float v = tabs[e];
    for (int c = 1; c < Red::kCopies; ++c) v += tabs[c * n_acc + e];
    partials[static_cast<size_t>(e) * n_blocks + block] = v;
  }
  if (kCount && tid < kNumCounters) atomicAdd(counter + tid, cnt[tid]);
}

// The threads of a block of the second pass.
constexpr int kSumThreads = 256;

// The second pass: entry blockIdx.x of the tables, the sum over the blocks'
// partial sums in a fixed order (a thread's strided run ascending, then a
// tree over the threads), written to its place in `out` or, past n_out, to
// `geo_out`. Its blocks are 1-D and no pixel's.
__global__ void __launch_bounds__(kSumThreads)
render_phys_bwd_sum_kernel(const float* __restrict__ partials, int n_blocks, int n_out,
                           float* __restrict__ out, float* __restrict__ geo_out) {
  __shared__ float s[kSumThreads];
  const int e = blockIdx.x;
  const int tid = threadIdx.x;
  const float* row = partials + static_cast<size_t>(e) * n_blocks;
  float v = 0.0f;
  for (int j = tid; j < n_blocks; j += kSumThreads) v += row[j];
  s[tid] = v;
  __syncthreads();
  for (int half = kSumThreads / 2; half > 0; half /= 2) {
    if (tid < half) s[tid] += s[tid + half];
    __syncthreads();
  }
  if (tid == 0) {
    if (e < n_out) {
      const int c = e & 7;  // albedo[3], transparency, emission[3], strength
      out[e - c + (c < 3 ? c : (c == 3 ? 7 : c - 1))] = s[0];
    } else {
      geo_out[e - n_out] = s[0];
    }
  }
}

// The shared memory a block of Pol takes: its tables, then (16-byte
// aligned) its records where they are shared.
template <class Pol>
void smem_layout(int n_mat, int n_em_cap, int max_bounces, size_t& records_offset,
                 size_t& bytes) {
  const size_t n_acc = 8 * static_cast<size_t>(n_mat + 1) + 4 * static_cast<size_t>(n_em_cap > 0 ? n_em_cap : 1);
  records_offset = (sizeof(float) * Pol::Red::kCopies * n_acc + 15) / 16 * 16;
  bytes = records_offset + static_cast<size_t>(max_bounces + 1) * Pol::Shape::kThreads *
                               Pol::Records::kRoundBytes;
}

// Launch render_phys_bwd_kernel<kCount, kTriNee, Pol>, then the second pass;
// returns cudaGetLastError(), or cudaErrorInvalidValue where max_bounces + 1
// exceeds the records, n_mat the int16 of shared records, or the block's
// shared memory the card's 227 KB.
template <bool kCount, bool kTriNee, class Pol>
int launch(const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
           int n_tri, const float* mat, int n_mat, const int* em_list, const float* le_sph,
           const int* tri_list, const float* le_tri, const float* tri_area,
           const float* mat_est, const float* mat_eco, const int* counts, const float* par,
           const float* g, float* out, float* geo_out, float* partials,
           unsigned long long* counter, int nee, int n_em_cap, int height, int width,
           int row_start, int rows, int spp, int max_bounces, unsigned int seed,
           int sample_offset, int jitter, int device, void* stream) {
  size_t records_offset, smem;
  smem_layout<Pol>(n_mat, n_em_cap, max_bounces, records_offset, smem);
  if (max_bounces + 1 > kMaxRounds || n_em_cap < 0 ||
      (Pol::Records::kShared && n_mat > 32767) || smem > 232448)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_spp = static_cast<float>(1.0 / static_cast<double>(spp));
  using Tl = typename Pol::Shape;
  const dim3 grid = Tl::grid(rows, width);
  const auto kernel = render_phys_bwd_kernel<kCount, kTriNee, Pol>;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, Tl::block(), smem, st>>>(
      sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list, le_tri,
      tri_area, mat_est, mat_eco, counts, par, g, partials, counter, nee, n_em_cap, height,
      width, row_start, rows, spp, max_bounces, seed, sample_offset, jitter, inv_spp,
      static_cast<int>(records_offset));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_out = 8 * (n_mat + 1);
  const int n_acc = n_out + 4 * (n_em_cap > 0 ? n_em_cap : 1);
  render_phys_bwd_sum_kernel<<<n_acc, kSumThreads, 0, st>>>(
      partials, static_cast<int>(grid.x * grid.y), n_out, out, geo_out);
  return static_cast<int>(cudaGetLastError());
}

using LaunchFn = decltype(&launch<false, false, KernelPolicy>);

}  // namespace

#ifndef PT_TILE_POINT
// C entry, bound with ctypes. Tables, emitter tables, `counts` and `par` as
// for render_phys; `mat_eco` is (n_mat, 3) float32, the raw emission colours;
// `g` is (rows, width, 3) float32, the cotangent of the block of `rows` rows
// from `row_start` of the height x width image, whose pixels the kernel
// replays; `out` is (n_mat + 1, 8) float32 and `geo_out` (max(n_em_cap, 1),
// 4) float32, both written whole; `partials` is scratch of (8 * (n_mat + 1)
// + 4 * max(n_em_cap, 1)) * n_blocks float32, n_blocks = ceil(width / 32) *
// ceil(rows / 8) (the blocks of the launch's tile). `counter` is null, or kNumCounters zeroed int64 that
// receive the counts (the counting instantiation). Launches the kernel and
// the second pass on `stream` of device `device` and returns
// cudaGetLastError(), or cudaErrorInvalidValue if max_bounces is above the
// cap.
extern "C" int render_phys_bwd(const float* sph, const int* sph_m, int n_sph,
                               const float* tri, const int* tri_m, int n_tri,
                               const float* mat, int n_mat, const int* em_list,
                               const float* le_sph, const int* tri_list,
                               const float* le_tri, const float* tri_area,
                               const float* mat_est, const float* mat_eco,
                               const int* counts, const float* par, const float* g,
                               float* out, float* geo_out, float* partials,
                               unsigned long long* counter, int nee, int tri_nee,
                               int n_em_cap, int height, int width, int row_start,
                               int rows, int spp, int max_bounces, unsigned int seed,
                               int sample_offset, int jitter, int device, void* stream) {
  const LaunchFn go = counter ? (tri_nee ? launch<true, true, KernelPolicy>
                                         : launch<true, false, KernelPolicy>)
                              : (tri_nee ? launch<false, true, KernelPolicy>
                                         : launch<false, false, KernelPolicy>);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, mat_eco, counts, par, g, out, geo_out, partials,
            counter, nee, n_em_cap, height, width, row_start, rows, spp, max_bounces, seed,
            sample_offset, jitter, device, stream);
}

// The number of counters of the counting instantiation (the wrapper asks).
extern "C" int render_phys_bwd_counters() { return kNumCounters; }

// An instantiation of render_phys_bwd other than the timed kernel
// (BwdVariant), with its arguments but no counter and no tri_nee. Returns
// cudaErrorInvalidValue for an unknown variant, or as the kernel does.
extern "C" int render_phys_bwd_variant(int variant, const float* sph, const int* sph_m,
                                       int n_sph, const float* tri, const int* tri_m,
                                       int n_tri, const float* mat, int n_mat,
                                       const int* em_list, const float* le_sph,
                                       const int* tri_list, const float* le_tri,
                                       const float* tri_area, const float* mat_est,
                                       const float* mat_eco, const int* counts,
                                       const float* par, const float* g, float* out,
                                       float* geo_out, float* partials, int nee,
                                       int n_em_cap, int height, int width, int row_start,
                                       int rows, int spp, int max_bounces, unsigned int seed,
                                       int sample_offset, int jitter, int device,
                                       void* stream) {
  LaunchFn go = nullptr;
  switch (variant) {
    case kBwdSink:
      go = launch<false, false, BwdPolicy<LocalStores<kMaxRounds>, SinkReduce>>;
      break;
    case kBwdSharedRecords:
      go = launch<false, false,
                  BwdPolicy<SharedStores<DefaultTile>, WarpTables<DefaultTile>>>;
      break;
  }
  if (!go) return static_cast<int>(cudaErrorInvalidValue);
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, mat_eco, counts, par, g, out, geo_out, partials, nullptr,
            nee, n_em_cap, height, width, row_start, rows, spp, max_bounces, seed,
            sample_offset, jitter, device, stream);
}

#else
// The sweep library's entry at point PT_TILE_POINT (pt_sched.cuh TileAt; no
// point of 512 threads, see above): render_phys_bwd's arguments at that
// launch shape, without the counter; `partials` for its blocks.
extern "C" int PT_TILED(render_phys_bwd)(
    const float* sph, const int* sph_m, int n_sph, const float* tri, const int* tri_m,
    int n_tri, const float* mat, int n_mat, const int* em_list, const float* le_sph,
    const int* tri_list, const float* le_tri, const float* tri_area, const float* mat_est,
    const float* mat_eco, const int* counts, const float* par, const float* g, float* out,
    float* geo_out, float* partials, int nee, int tri_nee, int n_em_cap, int height, int width,
    int row_start, int rows, int spp, int max_bounces, unsigned int seed, int sample_offset,
    int jitter, int device, void* stream) {
  using Pol = KernelPolicyAt<TileAt<PT_TILE_POINT>>;
  const LaunchFn go = tri_nee ? launch<false, true, Pol> : launch<false, false, Pol>;
  return go(sph, sph_m, n_sph, tri, tri_m, n_tri, mat, n_mat, em_list, le_sph, tri_list,
            le_tri, tri_area, mat_est, mat_eco, counts, par, g, out, geo_out, partials, nullptr,
            nee, n_em_cap, height, width, row_start, rows, spp, max_bounces, seed,
            sample_offset, jitter, device, stream);
}
#endif
