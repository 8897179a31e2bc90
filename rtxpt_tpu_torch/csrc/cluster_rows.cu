// K6 and K7, the per-row clustered kernels, written by hand for Hopper
// (sm_90a): K3's and K5's tensor-core form (cluster_mma.cuh: the
// split-bf16 products by mma.sync into registers, the screen fused after
// them, the screened candidates resolved in exact f32) with the per-row
// gates of the TPU kernels kept.
//
// K6 replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_a (closest hit and
// shading in one kernel; launched by _kernel_a_call, pl.pallas_call at
// bounce_clustered.py:1394) with its has_env, has_tex / tex_maps and
// final_env switches; K7 replaces ::_kernel_b (per-row shadow any-hit;
// _kernel_b_call, pl.pallas_call at :1431). The JAX package runs them when
// its _FLAT switch is off; the port when bounce_clustered.FLAT is False.
// Plain versions: rtxpt_tpu_torch/pt/bounce_clustered.py
// closest_shade_reference and occlusion_rows_reference; wrappers
// bounce_clustered.closest_shade and occlusion_rows.
//
// The gates. A ray group (1024 lanes, R = 8 rows of 128) walks its
// candidate list nearest first. The TPU kernel visits a slot under a group
// gate (some active lane's committed t, as int32 bits, reaches the slot's
// hull entry) and then each row under its own (the row's entry bits te_r at
// most the largest committed t bits of its active lanes; with the prune
// off, te_r below +inf). A row needs only its own gates: the hull entry of
// a slot is at most each row's entry (the group beam contains the row
// beams), entries rise along the list and committed t only falls, so a row
// that passes its gate at slot s passed the group gate at every slot up to
// s, and a row whose largest committed t is below a slot's hull entry
// passes no later slot: it is done. Each warp belongs to one row (warp / 4).
//
// K6. One block of 512 threads (4 rows, half a group) under
// __launch_bounds__(512, 1), one thread per lane, so that K4's shading body
// (cluster_shade.cuh shade_hit, 118-128 registers) runs in the same thread
// after the walk: a 1024-thread block would cap it at 64 registers. Per
// visited slot each warp votes its largest committed t bits (a warp
// reduction, one shared word per warp) and one __syncthreads makes the
// row maxima known to the block, which then
//   1. drops the rows that are done and picks the next slot that a row
//      visits (its te_r at most the row's maximum), skipping the others
//      without a barrier (the maxima cannot change while no row visits);
//   2. prefetches, with cp.async into the other half of the f32 ring, the
//      slot after it that a row would visit at the current maxima (they
//      only fall, so the next visit is that slot or a later one; a later
//      one is staged again when it comes);
//   3. waits for this slot's copy, converts the rows det, u and v read to
//      K3's bf16 tile, and each warp of a visiting row writes its lanes' A
//      rows from make_operand_rows (o x d of the shifted origin, as
//      `_row_cols`; the operand is each route's own, F11);
//   4. each warp of a visiting row takes its two 16-ray tiles through K3's
//      5 mma.sync per 8 triangles and `screen`; the screened candidates are
//      recomputed with the plain version's f32 sums (cluster.cuh
//      quantities, on the staged rows and the operand read back by
//      operand_of_row) and run through consider<true> (t = t_num / |det|,
//      `_kernel_a`'s Divide) in increasing triangle order; a quad reduction
//      takes the least t, the lowest triangle on ties, and the lane keeps
//      the slot's winner when it is below its committed t (the earliest
//      slot wins ties).
// With the stats each visiting row marks `visited[row, slot]`. After the
// walk each thread refits its winner exactly in f32 (cluster.cuh refit, as
// K3) and shades it (shade_hit, with the attribute fetch reading the
// winner's row of its cluster block), so the HA rows of the K3 + K4 pair
// never cross global memory. Two blocks stage each slot of a group: twice
// K3's staging per lane. Shared memory per block: A 49,152 B, the B tile
// 13,520 B, the ring 2 x 41,904 B, the lists 8,192 B: 154,672 B (one block
// per SM).
//
// K7. K5's kernel (one block of 1024 threads per group, 212,016 B) with
// the row skips: lanes without a request start occluded, a block-wide vote
// (__syncthreads_or) ends the walk once every lane is occluded, a slot
// whose entry bits are +inf in every row is never staged, and a warp skips
// a slot's products, screen and counting when its row's entry bits are
// +inf or all its lanes are occluded (it still reaches every barrier). The
// resolve is K5's: each thread walks its screened list in triangle order
// through the plain strict test (cluster.cuh occludes) to its first
// occluder; the lane is then occluded and counts j + 1 tested pairs, or
// 128 without one, as the plain version.
//
// Exactness: the screen passes every candidate consider<true> can accept
// and every strict occluder (the screen's margins are 4x the selection's,
// whatever t, and its sums differ from the plain ones by a few f32 ulps of
// the terms), and the resolve runs the plain version's sums and rules in
// its order. So K6's winners, t's and row visits and K7's occ and test
// counts are the plain version's bit for bit, and since each row's gate
// reads only its committed t, so are the gates.
//
// Screen counts: with rtxpt_cluster_rows_screen_stats(1, ...) each block
// adds the pairs it screened (128 per lane of a visiting warp in K6, per
// unoccluded lane of one in K7), the pairs that passed and the lists that
// overflowed to three counters per kernel in device memory; the call reads
// and zeroes them. Off by default.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_mma.cuh"
#include "cluster_shade.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

using RG = Ring<false>;                  // no micromaps on this route
constexpr int kInfBits = 0x7F800000;     // +inf as int32 bits
constexpr int RL = 128;                  // lanes of a row

// K6's block: NT threads, NT / RL rows
constexpr int NT = 512;
constexpr int NROWS = NT / RL;
constexpr int NW = NT / 32;
constexpr int K6_A = NT * KQ * 2;
constexpr int K6_LIST_BASE = K6_A + B_BYTES + 2 * RG::FLOATS * 4;
constexpr int K6_SMEM = K6_LIST_BASE + NT * 2 * LIST;
// K7's block: K5's
constexpr int K7_LIST_BASE = A_BYTES + B_BYTES + 2 * RG::FLOATS * 4;
constexpr int K7_SMEM = K7_LIST_BASE + LIST_BYTES;
static_assert(K6_SMEM <= 232448 && K7_SMEM <= 232448, "shared memory of one block");
static_assert(K6_A % 16 == 0, "16-byte alignment of the shared-memory regions");

__device__ int g_screen_on;                     // count the screens (0 / 1)
__device__ unsigned long long g_screen[2][3];   // K6, K7: pairs, passed, overflowed

// The block's screen counts into the kernel's device counters.
__device__ __forceinline__ void count_screen(unsigned int* counts, int k, int l) {
  __syncthreads();
  if (l < 3) atomicAdd(&g_screen[k][l], (unsigned long long)counts[l]);
}

template <bool HasTex>
__global__ void __launch_bounds__(NT, 1)
closest_shade_kernel(const int* __restrict__ cand, const float* __restrict__ fs,
                     const int* __restrict__ is, float* __restrict__ fs_out,
                     int* __restrict__ is_out, float* __restrict__ sh_out,
                     float* __restrict__ hit_out, unsigned char* __restrict__ visited,
                     const float* __restrict__ blocks, Tables tb, Config cfg, int n,
                     int cand_w, int kslots, int noprune) {
  constexpr int NTS = NT;                // threads that stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const at = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const bt = reinterpret_cast<__nv_bfloat16*>(smem + K6_A);
  float* const ring = reinterpret_cast<float*>(smem + K6_A + B_BYTES);
  __shared__ int wmax[2][NW];            // each warp's largest committed t bits
  __shared__ unsigned int counts[3];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int grp = blockIdx.x / (R / NROWS);
  const int r0 = (blockIdx.x % (R / NROWS)) * NROWS;   // the block's first row
  const int lr = warp >> 2;                             // this warp's row, 0..NROWS-1
  const int i = blockIdx.x * NT + l;
  const int* cg = cand + (size_t)grp * cand_w;
  const int* hull = cg + 1 + kslots;
  const int* te = cg + 1 + 2 * kslots + r0;             // te[R * s + lr]
  auto F = [&](int k) { return fs[(size_t)k * n + i]; };
  const V3 o = v3(F(FS_O), F(FS_O + 1), F(FS_O + 2));
  const V3 d = v3(F(FS_D), F(FS_D + 1), F(FS_D + 2));
  const bool act = is[(size_t)IS_ACTIVE * n + i] > 0;
  const bool count_on = g_screen_on != 0;

  const int wrow = warp * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
  uint4* const arow = reinterpret_cast<uint4*>(at + (size_t)wrow * KQ);
  const Frag fr = frag_addrs(at, bt, warp, lane);
  uint8_t* const list = smem + K6_LIST_BASE + l * 2 * LIST;
  if (l < LANES / 8)
    reinterpret_cast<uint4*>(bt + ZERO_ROW * B_STRIDE)[l] = make_uint4(0, 0, 0, 0);
  if (l < 3) counts[l] = 0;

  // The first slot from `s` that a row of `alive` visits at the row maxima
  // `bnd` (count when none), dropping from `alive` the rows that are done.
  const int count = cg[0];
  auto next_visit = [&](int s, unsigned& alive, const int* bnd) {
    for (; s < count; ++s) {
      if (!noprune) {
        const int h = hull[s];
#pragma unroll
        for (int r = 0; r < NROWS; ++r)
          if (bnd[r] < h) alive &= ~(1u << r);
        if (alive == 0) return count;
      }
#pragma unroll
      for (int r = 0; r < NROWS; ++r) {
        const int e = te[R * s + r];
        if (((alive >> r) & 1) && (noprune ? e < kInfBits : e <= bnd[r])) return s;
      }
    }
    return count;
  };

  float best_t = kBigT;
  int best_c = 0, best_j = 0;
  unsigned alive = (1u << NROWS) - 1;
  int staged = count > 0 ? 0 : -1;       // the slot in flight into ring[buf]
  if (count > 0) stage_async<false, false, false, NTS>(ring, blocks, nullptr, nullptr, nullptr, cg[1], 0, l);
  cp_async_commit();
  int buf = 0;
  for (int s = 0, it = 0;; ++it) {
    // the vote: every thread is past the previous visit, so the ring slot
    // it read, the B tile and the A tiles are free
    const int bound = act ? __float_as_int(best_t) : 0;
    const int wm = __reduce_max_sync(0xffffffffu, bound);
    if (lane == 0) wmax[it & 1][warp] = wm;
    __syncthreads();
    int bnd[NROWS];
#pragma unroll
    for (int r = 0; r < NROWS; ++r)
      bnd[r] = max(max(wmax[it & 1][4 * r], wmax[it & 1][4 * r + 1]),
                   max(wmax[it & 1][4 * r + 2], wmax[it & 1][4 * r + 3]));
    s = next_visit(s, alive, bnd);
    if (s >= count) break;
    unsigned vis = 0;                    // the rows that visit slot s
#pragma unroll
    for (int r = 0; r < NROWS; ++r) {
      const int e = te[R * s + r];
      if (((alive >> r) & 1) && (noprune ? e < kInfBits : e <= bnd[r])) vis |= 1u << r;
    }
    if (staged != s) {                   // the prefetch guessed another slot
      cp_async_wait<0>();
      stage_async<false, false, false, NTS>(ring + buf * RG::FLOATS, blocks, nullptr, nullptr,
                                       nullptr, cg[1 + s], 0, l);
      cp_async_commit();
    }
    unsigned guess_alive = alive;
    const int nx = next_visit(s + 1, guess_alive, bnd);
    if (nx < count)
      stage_async<false, false, false, NTS>(ring + (buf ^ 1) * RG::FLOATS, blocks, nullptr,
                                       nullptr, nullptr, cg[1 + nx], 0, l);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* cur = ring + buf * RG::FLOATS;
    convert_tile<NTS>(bt, cur, l);
    const bool on = (vis >> lr) & 1;     // this warp's row visits
    if (on) {
      float hi[10], lo[10];
      make_operand_rows(d, o, v3(cur[RG::CEN], cur[RG::CEN + 1], cur[RG::CEN + 2]), hi, lo);
      write_a_row(arow, hi, lo);
      if (visited != nullptr && (l & (RL - 1)) == 0)
        visited[(size_t)(grp * R + r0 + lr) * kslots + s] = 1;
    }
    __syncthreads();                     // the B tile is complete; the A rows are written
    if (on) {
      float t_c = kBigT;
      int j_c = 0;
#pragma unroll 1
      for (int mt = 0; mt < 2; ++mt) {
        int cnt[2];
        screen_tile(fr.a, fr.det, fr.u, mt, q, list, cnt);
        if (count_on) {
          const unsigned int pass = __reduce_add_sync(0xffffffffu, cnt[0] + cnt[1]);
          const unsigned int over =
              __reduce_add_sync(0xffffffffu, (cnt[0] > LIST) + (cnt[1] > LIST));
          if (lane == 0) {
            atomicAdd(&counts[1], pass);
            atomicAdd(&counts[2], over);
          }
        }
        // each screened candidate in exact f32 through consider<true>, in
        // increasing triangle order
        float ray_t[2] = {kBigT, kBigT};
        int ray_j[2] = {0, 0};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (cnt[r] == 0) continue;
          float hi[10], lo[10];
          operand_of_row(at + (size_t)(warp * 32 + mt * 16 + g + 8 * r) * KQ, hi, lo);
          bool unk = false;
          const int n_c = listed_count(cnt[r]);
#pragma unroll 1
          for (int c = 0; c < n_c; ++c) {
            const int j = listed(list + r * LIST, cnt[r], c, q);
            consider<true>(quantities(cur, j, hi, lo), j, cfg.max_travel, nullptr, ray_t[r],
                           ray_j[r], unk);
          }
        }
        // the quad's least t per ray, the lowest triangle on ties; the
        // ray's own thread (lane 4g + 2mt + r) keeps it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float tv = ray_t[r];
          int jv = ray_j[r];
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) {
            const float to = __shfl_xor_sync(0xffffffffu, tv, m);
            const int jo = __shfl_xor_sync(0xffffffffu, jv, m);
            if (to < tv || (to == tv && jo < jv)) {
              tv = to;
              jv = jo;
            }
          }
          if (q == 2 * mt + r) {
            t_c = tv;
            j_c = jv;
          }
        }
      }
      if (t_c < best_t) {
        best_t = t_c;
        best_c = cg[1 + s];
        best_j = j_c;
      }
      if (count_on && lane == 0) atomicAdd(&counts[0], 32u * CT);
    }
    staged = nx;
    buf ^= 1;
    s += 1;
  }
  cp_async_wait<0>();
  if (count_on) count_screen(counts, 0, l);

  // the winner's rows (zero when the lane has none), refit, shading
  const bool had = best_t < kBigT;
  const float* wb = blocks + (size_t)best_c * BLK_FLOATS;
  auto crow = [&](int a) {
    return had ? wb[(ATTR_BASE + a / 4) * LANES + (a % 4) * CT + best_j] : 0.0f;
  };
  auto crow3 = [&](int a) { return v3(crow(a), crow(a + 1), crow(a + 2)); };
  const V3 cen = had ? block_center(wb) : v3(0.0f, 0.0f, 0.0f);
  const Refit rf = refit(o - cen, d, crow3(AT_V0), crow3(AT_E1), crow3(AT_E2),
                         cfg.max_travel);
  const bool hit = had && rf.ok && crow(AT_VALID) > 0.5f;
  Hit h;
  h.t = hit ? rf.t : kBigT;
  h.u = rf.u;
  h.v = rf.v;
  h.det = hit ? rf.det : -1.0f;
  h.prim = -1;                           // surface_and_shade reads it only via A
  h.unk = false;
  auto attr = [&](int k) { return crow(kAttrRows[k]); };
  shade_hit<HasTex, false, false, false>(i, n, load_state(i, n, fs, is), h,
                                         hit ? crow(AT_GIDX) : -1.0f, attr, fs_out, is_out,
                                         sh_out, hit_out, nullptr, tb, cfg);
}

__global__ void __launch_bounds__(FL, 1)
shadow_rows_kernel(const int* __restrict__ cand, const float* __restrict__ sh,
                   const float* __restrict__ blocks, float* __restrict__ occ_out,
                   int* __restrict__ tests, int n, int cand_w, int kslots) {
  constexpr int NTS = FL;                // threads that stage
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const at = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const bt = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* const ring = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  __shared__ unsigned int counts[3];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int row = warp >> 2;             // this warp's 128-lane row
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  const int* te = cg + 1 + 2 * kslots;   // te[R * s + row]
  auto SH = [&](int k) { return sh[(size_t)k * n + i]; };
  const V3 o = v3(SH(SH_O), SH(SH_O + 1), SH(SH_O + 2));
  const V3 d = v3(SH(SH_D), SH(SH_D + 1), SH(SH_D + 2));
  const float dist = SH(SH_DIST) * kShadowScale;
  bool occ = !(SH(SH_DO) > 0.5f);
  const bool count_on = g_screen_on != 0;

  const int wrow = warp * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
  uint4* const arow = reinterpret_cast<uint4*>(at + (size_t)wrow * KQ);
  const Frag fr = frag_addrs(at, bt, warp, lane);
  uint8_t* const list = smem + K7_LIST_BASE + l * 2 * LIST;
  if (l < LANES / 8)
    reinterpret_cast<uint4*>(bt + ZERO_ROW * B_STRIDE)[l] = make_uint4(0, 0, 0, 0);
  if (l < 3) counts[l] = 0;

  // the first slot from `s` with some row's entry below +inf (count when
  // none): the others no row visits
  const int count = cg[0];
  auto next_live = [&](int s) {
    for (; s < count; ++s) {
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (te[R * s + r] < kInfBits) return s;
    }
    return count;
  };

  int tested = 0;
  int s = next_live(0);
  if (s < count)
    stage_async<false, false, false, NTS>(ring, blocks, nullptr, nullptr, nullptr, cg[1 + s], 0, l);
  cp_async_commit();
  for (int buf = 0; s < count; buf ^= 1) {
    // every thread is past the previous visit: its ring slot, the B tile
    // and the A tiles are free
    if (!__syncthreads_or(!occ)) break;
    const float* cur = ring + buf * RG::FLOATS;
    const int nx = next_live(s + 1);
    if (nx < count)
      stage_async<false, false, false, NTS>(ring + (buf ^ 1) * RG::FLOATS, blocks, nullptr,
                                       nullptr, nullptr, cg[1 + nx], 0, l);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    convert_tile<NTS>(bt, cur, l);
    const bool on = te[R * s + row] < kInfBits && __any_sync(0xffffffffu, !occ);
    if (on) {
      if (!occ) {
        float hi[10], lo[10];
        make_operand_rows(d, o, v3(cur[RG::CEN], cur[RG::CEN + 1], cur[RG::CEN + 2]), hi, lo);
        write_a_row(arow, hi, lo);
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) arow[k] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();                     // the B tile is complete; the A rows are written
    if (on) {
      int first = CT;                    // the slot's first occluder of this lane's ray
#pragma unroll 1
      for (int mt = 0; mt < 2; ++mt) {
        int cnt[2];
        screen_tile(fr.a, fr.det, fr.u, mt, q, list, cnt);
        if (count_on) {
          const unsigned int pass = __reduce_add_sync(0xffffffffu, cnt[0] + cnt[1]);
          const unsigned int over =
              __reduce_add_sync(0xffffffffu, (cnt[0] > LIST) + (cnt[1] > LIST));
          if (lane == 0) {
            atomicAdd(&counts[1], pass);
            atomicAdd(&counts[2], over);
          }
        }
        // each screened candidate in exact f32 (the plain sums and strict
        // test) in increasing triangle order up to the thread's first
        // occluder; the ray is lane 4g + 2mt + r of the warp
        int ray_j[2] = {CT, CT};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float rdist = __shfl_sync(0xffffffffu, dist, 4 * g + 2 * mt + r);
          if (cnt[r] == 0) continue;
          float hi[10], lo[10];
          operand_of_row(at + (size_t)(warp * 32 + mt * 16 + g + 8 * r) * KQ, hi, lo);
          const int n_c = listed_count(cnt[r]);
#pragma unroll 1
          for (int c = 0; c < n_c; ++c) {
            const int j = listed(list + r * LIST, cnt[r], c, q);
            if (occludes(quantities(cur, j, hi, lo), j, rdist, nullptr, nullptr, 0.0f)) {
              ray_j[r] = j;
              break;
            }
          }
        }
        // the quad's least occluder per ray; the ray's own thread keeps it
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          int jv = ray_j[r];
#pragma unroll
          for (int m = 1; m <= 2; m <<= 1) jv = min(jv, __shfl_xor_sync(0xffffffffu, jv, m));
          if (q == 2 * mt + r) first = jv;
        }
      }
      if (count_on) {
        const unsigned int live = __popc(__ballot_sync(0xffffffffu, !occ));
        if (lane == 0) atomicAdd(&counts[0], CT * live);
      }
      if (!occ) {
        tested += first < CT ? first + 1 : CT;
        occ = first < CT;
      }
    }
    s = nx;
  }
  cp_async_wait<0>();
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr && tested > 0) atomicAdd(tests + blockIdx.x, tested);
  if (count_on) count_screen(counts, 1, l);
}

}  // namespace

// K6. `visited` (NULL or [n_groups * R, kslots] bytes, zeroed by the caller)
// receives a 1 for each slot a row visited; `env` ([ET_SIZE] or NULL) is the environment table, which
// `final_env` needs; `tex` / `tex_meta` / `n_tex` / `tex_maps` the texture
// tables as K4 takes them (NULL for the untextured variant). `blocks` must
// be 16-byte aligned (the wrapper checks).
extern "C" int rtxpt_cluster_rows_closest_shade(
    const int* cand, const float* fs, const int* is, float* fs_out, int* is_out,
    float* sh_out, float* hit_out, unsigned char* visited, const float* blocks,
    const float* mat_rows, const float* light_rows, const float* env, const float* tex,
    const int* tex_meta, int n_tex, int tex_maps, int n_groups, int kslots,
    float max_travel, int noprune, int n_lights, unsigned int sample_idx, int nee_mode,
    int enable_mis, float firefly, int rr_enable, int min_rr, int low_discrepancy,
    int energy_comp, int maxb, int final_env, void* stream) {
  rt::Tables tb;
  tb.tri = nullptr;
  tb.attr = nullptr;
  tb.mat = mat_rows;
  tb.light = light_rows;
  tb.env = env;
  tb.tex = reinterpret_cast<const float4*>(tex);
  tb.tex_meta = tex_meta;
  tb.n_tex = n_tex;
  tb.tex_maps = tex_maps;
  tb.n_tris = 0;
  tb.tpad = 0;
  tb.n_lights = n_lights;
  tb.micro = nullptr;
  tb.cover = nullptr;
  rt::Config cfg;
  cfg.sample_idx = sample_idx;
  cfg.nee_mode = nee_mode;
  cfg.enable_mis = enable_mis != 0;
  cfg.firefly = firefly;
  cfg.rr_enable = rr_enable != 0;
  cfg.min_rr = min_rr;
  cfg.max_travel = max_travel;
  cfg.low_discrepancy = low_discrepancy != 0;
  cfg.energy_comp = energy_comp != 0;
  cfg.maxb = maxb;
  cfg.final_env = final_env != 0;
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  const int nblk = n_groups * (R / NROWS);
  auto kern = tex != nullptr ? closest_shade_kernel<true> : closest_shade_kernel<false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, K6_SMEM);
  if (e != cudaSuccess) return (int)e;
  kern<<<nblk, NT, K6_SMEM, (cudaStream_t)stream>>>(cand, fs, is, fs_out, is_out, sh_out,
                                                    hit_out, visited, blocks, tb, cfg, n,
                                                    cand_w, kslots, noprune);
  return (int)cudaGetLastError();
}

// K7. `tests` (NULL or [n_groups] i32, zeroed by the caller) receives, per
// group, the ray-triangle pairs its lanes tested. `blocks` must be 16-byte
// aligned (the wrapper checks).
extern "C" int rtxpt_cluster_rows_shadow(const int* cand, const float* sh,
                                         const float* blocks, float* occ, int* tests,
                                         int n_groups, int kslots, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  const cudaError_t e = cudaFuncSetAttribute(
      shadow_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K7_SMEM);
  if (e != cudaSuccess) return (int)e;
  shadow_rows_kernel<<<n_groups, FL, K7_SMEM, (cudaStream_t)stream>>>(
      cand, sh, blocks, occ, tests, n, cand_w, kslots);
  return (int)cudaGetLastError();
}

// The screen counters: `out` (NULL or 6 host values) receives K6's and
// then K7's pairs screened, passed and lists overflowed since the last
// call, which zeroes them; `enable` sets whether later launches count.
// Synchronous.
extern "C" int rtxpt_cluster_rows_screen_stats(int enable, unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && out != nullptr)
    e = cudaMemcpyFromSymbol(out, g_screen, sizeof(g_screen));
  const unsigned long long zero[6] = {0, 0, 0, 0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen_on, &enable, sizeof(int));
  return (int)e;
}
