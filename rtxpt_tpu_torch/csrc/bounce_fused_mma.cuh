// K1's closest hit and NEE shadow ray on the tensor cores, and the block
// body of its two libraries (bounce_fused.cu, the sixteen reference-mode
// instantiations; bounce_fused_restart.cu, the sixteen of the real-time
// fill). The per-lane shading is bounce_fused.cuh's; the generic tensor-core
// helpers (cp.async, ldmatrix, mma.sync, the split-bf16 A row) are
// cluster_mma.cuh's, K3's form.
//
// The product form. Each triangle's det, u and v numerators are dot
// products of its f32 coefficient rows c with the ray's r = [d | o x d]
// (det reads d, u and v all six components). The tile
// (bounce_fused.coefficient_tile, built once per scene) holds c_hi =
// bf16(c) and c_lo = bf16(c - c_hi); the lane's A row is K3's stacked
// [r_hi | l1 | l2 | r_hi] per component (r_lo = r - r_hi split exactly into
// l1 = bf16(r_lo), l2 = r_lo - l1), and the tile's virtual stacked rows are
// [c_hi | c_hi | c_hi | c_lo], so the tensor cores sum c_hi x r exactly and
// c_lo x r_hi. Unlike the clustered tables, c is full f32, so what the
// stacks leave out, c_lo x r_lo and (c - c_hi - c_lo) x r, is not zero: at
// most 2^-15 of T = sum |c_k| |r_k| together (coefficient_tile derives it),
// the f32 accumulations add at most ~2^-18 T. Per pair the error term e =
// 2^-13 x the triangle's scale (its largest L1 row norm) x the ray's
// largest |r_k| bounds T's share three times over.
//
// The screen (`screen`). The plain test (tri_test) accepts a pair only if
// its u and v numerators have det's sign and |u_num| + |v_num| <= |det|
// (up to its rounding), and its numerators lie within e of these. So with
// w = kScreen |det| + e and lim = |det| + 2w + 2e, a pair passes where
// |det| >= e (det's sign is known), |det| > 0, the signed numerators are
// >= -w and their sum <= lim; or where |det| < e (the sign is not known)
// and |u_num| + |v_num| <= lim. Every pair the plain test accepts passes,
// whatever t; a padding triangle (zero row, zero scale) and a zero A row
// (a lane past n, or without a shadow request) never do. The passing pairs
// are resolved by tri_test itself on the f32 rows, so K1's results stay
// bit-exact with bounce_reference.
//
// Layout. Blocks of 512 threads (16 warps; 128 registers a thread, one
// block per SM), one batch of 32 consecutive rays per warp: the block
// stages the whole tile (at most 2048 triangles: 31 x 2,056 bf16 and 8 KB
// of scales) into shared memory with cp.async while its lanes load their
// rays, and no block barrier follows. Persistent blocks that walked the
// batches in a fixed order were 16-22% slower on the 14- and 36-triangle
// tables (tools/k1_variants.py, PERF.md): the hardware's block scheduler
// balances the shading's uneven cost better. Within a batch, K3's layout: lane
// 4g + q owns ray 4g + q and writes its A row to tile q / 2, row
// g + 8 (q % 2); the accumulator e of thread 4g + q holds ray row
// g + 8 (e / 2) of tile mt, i.e. the ray of lane 4g + 2 mt + e / 2, and
// triangle 8 ch + 2q + e % 2. Per chunk of 8 triangles and 16 rays: one
// ldmatrix.x2 (det) and two .x4 (u, v) of B, 5 mma.sync.m16n8k16.
//
// Tables of at most 16 triangles (kExactChunks chunks) take kernels of
// their own, the CUDA-core K1's (bounce_fused.cuh bounce_ray: one thread
// per ray, the exact loops, 128-thread blocks): there the screen's fixed
// cost per warp (the operand, the mask exchange, a resolve of most
// candidates anyway) outweighs the exact tests it saves. On the card
// (tools/k1_variants.py, k1_compare.py; PERF.md) the screen was 4-12%
// slower on 8-16 triangles and 3-5% faster on 32-36, and the same exact
// loops inside this kernel (512- or 128-thread blocks, 128 registers)
// 5-8% slower than in a kernel without the screen.
//
// The resolve. A passing pair sets one bit of the thread's mask for that
// ray (bit 2c + e % 2 of chunk c of a group of 16 chunks, 128 triangles);
// after each group the quad exchanges its masks (3 shuffles), so that each
// lane holds its own ray's candidates from all four threads, and resolves
// them with tri_test: the closest hit keeps the least (t, triangle index)
// among the valid, non-TRANSPARENT ones, which is the plain version's
// strict-`<` scan in triangle order; the shadow ray stops at its first
// occluder (the micromap rules as in `occluded`). Resolving per group
// bounds the masks at 32 bits whatever the table's size, and lets a warp
// whose requesting lanes are all occluded end its shadow walk.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bounce_fused.cuh"
#include "cluster_mma.cuh"

namespace rt {
namespace k1 {

constexpr int kWarps = 16;                 // warps of a block
constexpr int kThreads = 32 * kWarps;      // one block per SM
constexpr int kExactThreads = 128;         // the exact kernels' blocks
constexpr int kTileRows = 30;              // det c_hi, c_lo (3 + 3), u, v (6 + 6)
constexpr int kZeroRow = kTileRows;        // the staged tile's zero row
constexpr int kGroup = 16;                 // chunks of 8 triangles per resolve
constexpr int kExactChunks = 2;            // tables of at most 16 triangles: exact kernels
constexpr int kMaxTris = 2048;              // bounce_fused.MAX_TRIS: the largest tile
constexpr float kScreen = 4.0f * (float)2e-3;   // K3's screen margin, of |det|
constexpr float kEps = 1.0f / 8192.0f;          // the error term's 2^-13
constexpr unsigned kFull = 0xffffffffu;

// The staged tile's row stride in bf16 (a multiple of 64 plus 8: the rows
// an ldmatrix phase reads fall in distinct 16-byte bank groups) and the
// dynamic shared memory of a block: the tile with its zero row, the
// scales, the A rows.
__host__ __device__ inline int tile_stride(int t8) { return (t8 + 63) / 64 * 64 + 8; }
__host__ __device__ inline int scale_offset(int t8) {
  return (kTileRows + 1) * tile_stride(t8) * 2;
}
__host__ __device__ inline int arow_offset(int t8) { return scale_offset(t8) + 4 * t8; }
__host__ __device__ inline int smem_bytes(int t8) {
  return arow_offset(t8) + kThreads * cl::KQ * 2;
}

// The counters of rtxpt_bounce_fused[_restart]_screen_stats: closest-hit
// pairs screened and passed, shadow pairs screened and passed, shadow walks
// ended before the table's end, pairs the exact test accepts that the
// screen rejected (checked only while counting).
enum { SC_PAIRS, SC_PASSED, SC_SPAIRS, SC_SPASSED, SC_EARLY, SC_MISSED, SC_N };
__device__ int g_screen_on;
__device__ unsigned long long g_screen[SC_N];

// The tile row of virtual row k of quantity qn's stacked B (det 0, u 1,
// v 2): component k / 4, stack k % 4 (c_lo in stack 3); the zero row where
// the quantity does not read the component.
__device__ __forceinline__ int tile_row(int qn, int k) {
  const int comp = k >> 2;
  const int nc = qn == 0 ? 3 : 6;
  if (comp >= nc) return kZeroRow;
  const int base = qn == 0 ? 0 : (qn == 1 ? 6 : 18);
  return base + ((k & 3) == 3 ? nc : 0) + comp;
}

// Whether a pair can pass the plain test (see the header): e is the
// pair's error term.
// The signs are flipped by det's sign bit (a zero det is screened by
// |det| alone), and the margins are rounded once (fma): their slack is far
// above a rounding.
__device__ __forceinline__ bool screen(float det, float un, float vn, float e) {
  const float absd = fabsf(det);
  const uint32_t sign = __float_as_uint(det) & 0x80000000u;
  const float su = __uint_as_float(__float_as_uint(un) ^ sign);
  const float sv = __uint_as_float(__float_as_uint(vn) ^ sign);
  const float w = __fmaf_rn(kScreen, absd, e);
  const float lim = __fmaf_rn(2.0f, w + e, absd);
  if (absd < e) return fabsf(un) + fabsf(vn) <= lim;
  return absd > 0.0f && fminf(su, sv) >= -w && su + sv <= lim;
}

// Issue the copies of the tile and the scales and write the zero row;
// every thread of the block. The caller waits (cp_async_wait, then a block
// barrier).
__device__ __forceinline__ void stage_tile(unsigned char* smem, const __nv_bfloat16* tile,
                                           const float* scale, int t8) {
  __nv_bfloat16* bt = reinterpret_cast<__nv_bfloat16*>(smem);
  const int stride = tile_stride(t8);
  const int pieces = t8 / 8;  // 16-byte pieces of a row
  for (int k = threadIdx.x; k < kTileRows * pieces; k += kThreads) {
    const int r = k / pieces, c = k - r * pieces;
    cl::cp_async16(bt + r * stride + 8 * c, tile + (size_t)r * t8 + 8 * c);
  }
  float* sc = reinterpret_cast<float*>(smem + scale_offset(t8));
  for (int k = threadIdx.x; k < t8 / 4; k += kThreads) cl::cp_async16(sc + 4 * k, scale + 4 * k);
  for (int k = threadIdx.x; k < stride / 8; k += kThreads)
    reinterpret_cast<uint4*>(bt + kZeroRow * stride)[k] = make_uint4(0, 0, 0, 0);
  cl::cp_async_commit();
}

// One warp's view of the staged tile: the ldmatrix row addresses of its
// lane (its A slot, the B rows of det, u and v), its own A row, the scales.
struct Warp {
  uint32_t a, det, u, v;
  uint4* arow;
  const float* scale;
  int lane, g, q, chunks;
};

__device__ __forceinline__ Warp warp_view(unsigned char* smem, int t8) {
  const int l = threadIdx.x, lane = l & 31, warp = l >> 5;
  const __nv_bfloat16* bt = reinterpret_cast<const __nv_bfloat16*>(smem);
  __nv_bfloat16* at = reinterpret_cast<__nv_bfloat16*>(smem + arow_offset(t8));
  const int stride = tile_stride(t8);
  Warp w;
  w.lane = lane;
  w.g = lane >> 2;
  w.q = lane & 3;
  w.chunks = t8 / 8;
  const int mslot = lane >> 3, mr = lane & 7;
  w.a = cl::smem_u32(at + (warp * 32 + mr + 8 * (mslot & 1)) * cl::KQ + 8 * (mslot >> 1));
  w.det = cl::smem_u32(bt + tile_row(0, lane & 15) * stride);
  w.u = cl::smem_u32(bt + tile_row(1, lane) * stride);
  w.v = cl::smem_u32(bt + tile_row(2, lane) * stride);
  w.arow = reinterpret_cast<uint4*>(
      at + (warp * 32 + (w.q >> 1) * 16 + w.g + 8 * (w.q & 1)) * cl::KQ);
  w.scale = reinterpret_cast<const float*>(smem + scale_offset(t8));
  return w;
}

// Write the lane's A row for the ray (d, x = o x d), a zero row unless
// `live`, load the warp's A fragments, and return each of the thread's
// four rays' error factor kEps x max |r_k| (ray r = 2 mt + e / 2 is lane
// 4g + r's).
__device__ __forceinline__ void operand(const Warp& w, V3 d, V3 x, bool live,
                                        uint32_t (&a)[2][2][4], float (&me)[4]) {
  const float r[6] = {d.x, d.y, d.z, x.x, x.y, x.z};
  float hi[10] = {}, lo[10] = {}, m = 0.0f;  // components 6-9 stay zero
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    hi[k] = live ? cl::bf16_round(r[k]) : 0.0f;
    lo[k] = live ? r[k] - hi[k] : 0.0f;
    m = fmaxf(m, fabsf(r[k]));  // passes over a NaN component
  }
  const float m_eps = live ? kEps * m : 0.0f;
  __syncwarp();  // the warp's last reads of its A rows are done
  cl::write_a_row(w.arow, hi, lo);
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      cl::ldsm_x4(a[mt][ks], w.a + (mt * 16 * cl::KQ + ks * 16) * 2);
#pragma unroll
  for (int r4 = 0; r4 < 4; ++r4) me[r4] = __shfl_sync(kFull, m_eps, 4 * w.g + r4);
}

// The products and the screen of chunks ch0 .. ch0 + n - 1 (one group):
// bit 2c + e % 2 of m[r] for chunk ch0 + c, ray r = 2 mt + e / 2.
__device__ __forceinline__ void screen_group(const Warp& w, const uint32_t (&a)[2][2][4],
                                             const float (&me)[4], int ch0, int n,
                                             uint32_t (&m)[4]) {
  m[0] = m[1] = m[2] = m[3] = 0;
#pragma unroll 1
  for (int c = 0; c < n; ++c) {
    const int ch = ch0 + c;
    const uint32_t off = ch * 16;  // 8 bf16 columns
    uint32_t bd[2], bu[4], bv[4];
    cl::ldsm_x2_t(bd, w.det + off);
    cl::ldsm_x4_t(bu, w.u + off);
    cl::ldsm_x4_t(bv, w.v + off);
    const float2 ns = *reinterpret_cast<const float2*>(w.scale + 8 * ch + 2 * w.q);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      float qd[4] = {0.0f, 0.0f, 0.0f, 0.0f}, qu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      float qv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      cl::mma_bf16(qd, a[mt][0], bd[0], bd[1]);
      cl::mma_bf16(qu, a[mt][0], bu[0], bu[1]);
      cl::mma_bf16(qu, a[mt][1], bu[2], bu[3]);
      cl::mma_bf16(qv, a[mt][0], bv[0], bv[1]);
      cl::mma_bf16(qv, a[mt][1], bv[2], bv[3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 2 * mt + (e >> 1);
        const float e_err = ((e & 1) ? ns.y : ns.x) * me[r];
        if (screen(qd[e], qu[e], qv[e], e_err)) m[r] |= 1u << (2 * c + (e & 1));
      }
    }
  }
}

__device__ __forceinline__ uint32_t pick(const uint32_t (&m)[4], int k) {
  return k == 0 ? m[0] : (k == 1 ? m[1] : (k == 2 ? m[2] : m[3]));
}

// The lane's own ray's candidates of the group from the quad's four
// threads: mine[k] is thread q ^ k's mask (whole warp, converged).
__device__ __forceinline__ void own_masks(int q, const uint32_t (&m)[4], uint32_t (&mine)[4]) {
  mine[0] = pick(m, q);
#pragma unroll
  for (int k = 1; k < 4; ++k) mine[k] = __shfl_xor_sync(kFull, pick(m, q ^ k), k);
}

// Triangle of bit b of thread qs's mask in the group starting at j0.
__device__ __forceinline__ int tri_of(int j0, int qs, int b) {
  return j0 + 8 * (b >> 1) + 2 * qs + (b & 1);
}

// While counting: the group's pairs of this lane's ray that the screen
// rejected and the exact test accepts (tri_test: inside, 0 < t).
__device__ __forceinline__ int missed(const Tables& tb, int j0, int n, int q,
                                      const uint32_t (&mine)[4], V3 o, V3 d, V3 x) {
  int count = 0;
  for (int j = j0; j < j0 + 8 * n; ++j) {
    const int b = 2 * ((j - j0) >> 3) + (j & 1);
    if ((pick(mine, q ^ ((j >> 1) & 3)) >> b) & 1u) continue;
    float u, v, t, det;
    count += tri_test(tb.tri + j * TC_ROWS, o, d, x, u, v, t, det) ? 1 : 0;
  }
  return count;
}

__device__ __forceinline__ int popc4(const uint32_t (&m)[4]) {
  return __popc(m[0]) + __popc(m[1]) + __popc(m[2]) + __popc(m[3]);
}

// Add a warp's counts (lane 0's atomics).
__device__ __forceinline__ void add_counts(int slot0, unsigned long long pairs, int passed,
                                      int slot2, int extra) {
  const unsigned int p = __reduce_add_sync(kFull, (unsigned int)passed);
  const unsigned int x = __reduce_add_sync(kFull, (unsigned int)extra);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&g_screen[slot0], pairs);
    atomicAdd(&g_screen[slot0 + 1], (unsigned long long)p);
    if (x) atomicAdd(&g_screen[slot2], (unsigned long long)x);
  }
}

// Closest hit of each lane's ray (o, d) over the tile, as
// bounce_fused.cuh's per-thread scan gives it: strict `<` in triangle
// order, t < tmax, HasOmm's micro-TRANSPARENT candidates rejected and the
// winner's UNKNOWN state kept. Every lane of the warp calls it; a lane
// that is not `live` screens a zero row and returns a miss.
template <bool HasOmm>
__device__ Hit closest(const Warp& w, const Tables& tb, V3 o, V3 d, float tmax, bool live,
                       bool count_on) {
  Hit h;
  h.t = kBig; h.u = 0.0f; h.v = 0.0f; h.det = 0.0f; h.prim = -1; h.unk = false;
  const V3 x = cross3(o, d);
  uint32_t a[2][2][4];
  float me[4];
  operand(w, d, x, live, a, me);
  int passed = 0, miss = 0;
  for (int ch0 = 0; ch0 < w.chunks; ch0 += kGroup) {
    const int n = min(kGroup, w.chunks - ch0);
    uint32_t m[4], mine[4];
    screen_group(w, a, me, ch0, n, m);
    own_masks(w.q, m, mine);
    const int j0 = 8 * ch0;
    if (count_on) {
      passed += popc4(m);
      if (live) miss += missed(tb, j0, n, w.q, mine, o, d, x);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      uint32_t bits = mine[k];
      while (bits) {
        const int j = tri_of(j0, w.q ^ k, __ffs(bits) - 1);
        bits &= bits - 1;
        float u, v, t, det;
        const bool ok = tri_test(tb.tri + j * TC_ROWS, o, d, x, u, v, t, det);
        if (!(ok && t < tmax && (t < h.t || (t == h.t && j < h.prim)))) continue;
        int st = MICRO_OPAQUE;
        if constexpr (HasOmm) {
          st = tri_micro_state(tb, j, u, v);
          if (st == MICRO_TRANSPARENT) continue;
        }
        h.t = t; h.u = u; h.v = v; h.det = det; h.prim = j;
        h.unk = st == MICRO_UNKNOWN;
      }
    }
  }
  if (count_on) {
    const unsigned int lanes = __popc(__ballot_sync(kFull, live));
    add_counts(SC_PAIRS, 8ull * w.chunks * lanes, passed, SC_MISSED, miss);
  }
  return h;
}

// The occluder of the shadow ray (o, d) of a lane that `wants` one in
// (0, tmax), as bounce_fused.cuh's `occluded` finds it (HasOmm: TRANSPARENT
// candidates never occlude, UNKNOWN ones where u_alpha < the coverage): its
// triangle index, or -1. kFirst: the first occluder in table order, the one
// the per-thread loop stops at (K2 reports the pairs up to it); otherwise
// the first the resolve meets (K1 needs only whether there is one). Every
// lane of the warp calls it; the others screen a zero row and return -1.
template <bool HasOmm, bool kFirst = false>
__device__ int occluder_warp(const Warp& w, const Tables& tb, V3 o, V3 d, float tmax,
                             float u_alpha, bool want, bool count_on) {
  const V3 x = cross3(o, d);
  uint32_t a[2][2][4];
  float me[4];
  operand(w, d, x, want, a, me);
  int first = -1;
  int passed = 0, miss = 0, chunks = 0;
  for (int ch0 = 0; ch0 < w.chunks; ch0 += kGroup) {
    const int n = min(kGroup, w.chunks - ch0);
    uint32_t m[4], mine[4];
    screen_group(w, a, me, ch0, n, m);
    own_masks(w.q, m, mine);
    const int j0 = 8 * ch0;
    chunks += n;
    if (count_on) {
      passed += popc4(m);
      if (want && first < 0) miss += missed(tb, j0, n, w.q, mine, o, d, x);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      // an occluder of an earlier group precedes every candidate of this one
      uint32_t bits = (first < 0 || (kFirst && first >= j0)) ? mine[k] : 0u;
      while (bits) {
        const int j = tri_of(j0, w.q ^ k, __ffs(bits) - 1);
        bits &= bits - 1;
        if (kFirst && first >= 0 && j > first) continue;
        float u, v, t, det;
        if (!(tri_test(tb.tri + j * TC_ROWS, o, d, x, u, v, t, det) && t < tmax)) continue;
        if constexpr (HasOmm) {
          const int st = tri_micro_state(tb, j, u, v);
          if (st == MICRO_TRANSPARENT) continue;
          if (st == MICRO_UNKNOWN && !(u_alpha < RT_LDG(tb.cover + j))) continue;
        }
        first = j;
        if (!kFirst) break;
      }
    }
    if (__all_sync(kFull, first >= 0 || !want)) break;
  }
  if (count_on) {
    const unsigned int lanes = __popc(__ballot_sync(kFull, want));
    add_counts(SC_SPAIRS, 8ull * chunks * lanes, passed, SC_MISSED, miss);
    if ((threadIdx.x & 31) == 0 && chunks < w.chunks) atomicAdd(&g_screen[SC_EARLY], 1ull);
  }
  return first;
}

// Whether the shadow ray has an occluder (occluder_warp's first found).
template <bool HasOmm>
__device__ bool occluded_warp(const Warp& w, const Tables& tb, V3 o, V3 d, float tmax,
                              float u_alpha, bool want, bool count_on) {
  return occluder_warp<HasOmm>(w, tb, o, d, tmax, u_alpha, want, count_on) >= 0;
}

// The block body of both libraries: stage the tile, then each warp's batch
// of 32 rays: the closest hit (or, with Restart and `inj`, the injected
// hit), hit rows 0-4, then per live lane the final environment round or
// surface_and_shade with the state, SF_* rows and hit row 5 written, then
// the warp's shadow walk for the lanes with a request and their
// contribution. The shading is bounce_fused.cuh's per-lane body.
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit, bool Restart>
__device__ __forceinline__ void bounce_block(
    const float* __restrict__ fs, const int* __restrict__ is, const float* __restrict__ fs2,
    float* __restrict__ fs_out, int* __restrict__ is_out, float* __restrict__ hit_out,
    float* __restrict__ surf_out, float* __restrict__ fs2_out, const float* __restrict__ inj,
    const __nv_bfloat16* __restrict__ tile, const float* __restrict__ scale, int t8,
    const Tables& tb, const Config& cfg, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  stage_tile(smem, tile, scale, t8);
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  V3 o = splat(0.0f), d = splat(0.0f);
  if (live) {
    o = v3(fs[(FS_O + 0) * n + i], fs[(FS_O + 1) * n + i], fs[(FS_O + 2) * n + i]);
    d = v3(fs[(FS_D + 0) * n + i], fs[(FS_D + 1) * n + i], fs[(FS_D + 2) * n + i]);
  }
  cl::cp_async_wait<0>();
  __syncthreads();
  if (__all_sync(kFull, !live)) return;  // a warp past n, after the barrier
  const Warp w = warp_view(smem, t8);
  const bool count_on = g_screen_on != 0;
  Hit h;
  h.t = kBig; h.u = 0.0f; h.v = 0.0f; h.det = 0.0f; h.prim = -1; h.unk = false;
  if (Restart && inj != nullptr) {
    if (live) h = injected_hit(i, n, inj);
  } else {
    h = closest<HasOmm>(w, tb, o, d, cfg.max_travel, live, count_on);
  }
  float* ho = hit_out + i;
  if (live) {
    ho[0] = h.t < kBig ? h.t : 0.0f;
    ho[n] = (float)h.prim;
    ho[2 * n] = h.u;
    ho[3 * n] = h.v;
    ho[4 * n] = h.det > 0.0f ? 1.0f : 0.0f;
  }
  // the rest of the state after the screen, so that its fragments do not
  // share the registers with it
  RayState s;
  Split sp;
  if (live) {
    s = load_state(i, n, fs, is);
    if constexpr (HasSplit) sp = load_split(i, n, fs2);
  }
  if (cfg.final_env) {  // one value for the launch: no warp diverges on it
    if (live) {
      final_env_state<HasSplit>(s, h.t < kBig, tb, cfg,
                                (1 << 1) | (1 << 2) | (1 << 4) | (1 << 5), &sp);
      store_state(i, n, s, fs_out, is_out);
      if constexpr (HasSplit) store_split(i, n, sp, fs2_out);
      ho[5 * n] = 0.0f;
    }
    return;
  }
  ShadowRay sr;
  sr.do_nee = false;
  sr.o = splat(0.0f);
  sr.d = splat(0.0f);
  sr.dist = 0.0f;
  sr.u_alpha = 0.0f;
  if (live) {
    const int lb_in = s.lb;
    auto attr = [&](int r) {
      return h.prim >= 0 ? RT_LDG(tb.attr + r * tb.tpad + h.prim) : 0.0f;
    };
    SurfRows sf;
    sr = surface_and_shade<HasTex, HasOmm, HasPrio, HasSplit, decltype(attr), Restart>(
        s, h, attr, tb, cfg, surf_out != nullptr ? &sf : nullptr, &sp);
    // the state goes out now; an unoccluded shadow ray rewrites L
    store_state(i, n, s, fs_out, is_out);
    if (surf_out != nullptr) {
      store_surf(i, n, sf, surf_out);
      ho[5 * n] = sf.shaded ? (lb_in > 0 ? 2.0f : 1.0f) : 0.0f;
    } else {
      ho[5 * n] = sr.do_nee ? 1.0f : 0.0f;
    }
  }
  const bool want = live && sr.do_nee;
  if (__any_sync(kFull, want) &&
      !occluded_warp<HasOmm>(w, tb, sr.o, sr.d, sr.dist, sr.u_alpha, want, count_on) && want) {
    s.L = s.L + sr.contrib;
    float* fo = fs_out + i;
    fo[(FS_L + 0) * n] = s.L.x; fo[(FS_L + 1) * n] = s.L.y; fo[(FS_L + 2) * n] = s.L.z;
    if constexpr (HasSplit) {
      sp.ld = sp.ld + sp.cdiff;
      sp.ls = sp.ls + sr.contrib - sp.cdiff;
    }
  }
  if constexpr (HasSplit)
    if (live) store_split(i, n, sp, fs2_out);
}

}  // namespace k1
}  // namespace rt
