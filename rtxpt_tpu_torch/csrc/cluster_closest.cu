// K3, the clustered closest-hit kernel, written by hand for Hopper (sm_90a),
// flat, with opacity micromaps, and instanced: the split-bf16 products on the
// tensor cores (mma.sync, bf16 in, f32 accumulate), a screen fused after them
// in registers, and the screened candidates resolved in exact f32.
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_a1 (launched there by
// _kernel_a1_call, pl.pallas_call at bounce_clustered.py:1188), the flat
// variant (instanced=False), the instanced one (instanced=True, the
// branches at :237-245, :270-271, :324-330, :351-356 and :385-386) and the
// flat one with opacity micromaps (omm=True, :290-297, :318-319). The
// instanced variant has no micromaps: the JAX package never builds
// instanced tables for alpha-tested geometry (accel/tlas.py:183-184). Plain
// version: rtxpt_tpu_torch/pt/bounce_clustered.py closest_hit_reference;
// wrapper: bounce_clustered.closest_hit.
//
// What bounds it: operations. A visit tests 1024 rays against 128
// triangles. Per pair, the four quantities (det, u, v and t numerators) are
// sums of c_hi*r_hi + c_hi*r_lo + c_lo*r_hi over the operand's components
// (57 multiplies and 53 adds on the f32 units), and the selection (sign,
// margins, strict test, t * (1 / |det|) with the tie bump, running
// minimum) is ~27 f32 operations. Here det, u and v are one small matrix
// product per visit on the tensor cores, and the f32 work per pair is a
// ~10-operation screen on them; the few pairs that pass it are resolved in
// exact f32.
//
// The product form. The coefficients are bf16-exact (accel/cluster.py
// stores c_hi and c_lo = bf16(c - c_hi)) and so is r_hi = bf16(r). The f32
// residual r_lo = r - r_hi has at most 16 significant bits, so it splits
// exactly into l1 = bf16(r_lo) and l2 = r_lo - l1, both bf16. The four
// stacks A = [r_hi | l1 | l2 | r_hi] against B = [c_hi | c_hi | c_hi | c_lo]
// give every product of the plain version exactly; only the order and
// rounding of the f32 accumulation differ, which on coincident and
// edge-sharing triangles decides near-ties the other way (0.12% of the
// city's lanes when these sums drove the whole selection). The depth is
// ordered component-major, k = 4 * component + stack: det reads components
// 0-2 (k-step 0), u and v 0-5 (k-steps 0-1), so a chunk of 8 triangles
// takes 5 m16n8k16 products for 16 rays. The t numerators (components 6-9)
// are not screened on: only the screened pairs need them, in exact f32.
//
// The selection. The tensor cores' sums only screen: a candidate passes
// inside the edge margins widened 4x, whatever t (`screen`). The plain
// version's valid candidates all pass, since these sums differ from its
// own by a few f32 ulps of the terms and the margins are 2e-3 of |det|; on
// the small city's camera rays 0.02-0.05% of the pairs pass
// (tests/test_torch_k3_product.py). Each passing candidate is recomputed
// with the plain version's f32 sums (cluster.cuh quantities, on the f32
// coefficient rows staged for the copy and the ray's operand read back
// exactly from its A row) and goes through `consider`, the plain
// selection's rules. So K3 keeps the plain version's winners, t's and
// visit counts bit for bit, and its HA rows with them.
//
// Design. One block of 1024 threads per 1024-lane ray group, one thread per
// lane for the operand, the walk's state and the winner's refit; each warp's
// 32 rays are two 16-row tiles of the product. The block walks the group's
// candidate clusters nearest first. Before each slot a block-wide vote
// (__syncthreads_or) applies the prune: the slot is visited only while some
// active lane's committed t (as int32 bits) is at least the slot's hull
// entry distance. A visit:
//   1. prefetches the next slot's rows 0..19, its center (and micromap
//      words, or the instance's M10) into the other half of an f32 ring in
//      shared memory with cp.async; a prefetch past a stop is dropped;
//   2. waits for this slot's copy and converts the rows det, u and v read
//      (c_hi and c_lo of components 0-5) to a bf16 tile [13][520] (row 12
//      zero: the components a quantity does not read point there; the pad
//      spreads ldmatrix's rows over the banks); the stacked B rows are
//      virtual, each ldmatrix row address picks its tile row, so c_hi is
//      staged once and not three times;
//   3. builds each lane's cluster-local operand with the f32 arithmetic of
//      make_operand (after xform_operand on instanced tables), splits it
//      into r_hi, l1, l2 and writes its bf16 row of the warp's A tile (all
//      ten components, 48 wide). Lane 4g + q goes to tile q / 2, row
//      g + 8 (q % 2), so that each ray's results land in its own quad;
//   4. per 16-ray tile: A fragments by ldmatrix, kept in registers over the
//      16 chunks of 8 triangles; per chunk B fragments by ldmatrix.trans and
//      5 mma.sync into 12 accumulators, which hold det, u and v of the same
//      4 (ray, triangle) pairs in each thread; the screen appends a passing
//      triangle to the thread's list for that ray (8 entries in shared
//      memory; past 8 the thread takes all 32 of its triangles); then the
//      exact pass over each list, and a quad shuffle reduction takes the
//      least t, the lowest triangle on ties; the ray's own thread keeps the
//      slot's winner when its t is below the committed one (the earliest
//      slot wins ties). No product leaves the registers.
// Shared memory per block: A 98,304 B, the bf16 B tile 13,520 B, the ring
// 2 x 41,904 B, the lists 16,384 B: 212,016 B (one block per SM; 1024
// threads cap the registers at 64).
//
// The instanced variant. The candidate rows carry pool block ids and, from
// 1 + (2 + R) * kslots on, each slot's instance id. The ring also carries
// the instance's M10 (400 bytes), and each thread maps its world operand
// [d, o x d, o, 1] into the instance's object frame (xform_operand) before
// the split. t stays the world parameter, so the selection across
// instances compares t as it is. A thread also keeps its winner's instance;
// after the loop it maps its ray again with that instance's M10 (the same
// sums, so the same object ray), refits on it and exports the instance in
// HA_INST. The attribute rows stay in object space; bounce_clustered
// .post_attr_inst brings them to world space after the pages merge.
//
// Micromaps. The ring also carries the cluster's 128 micromap words (512 B
// of the side table, accel/cluster.py omm_word). A candidate that passes
// the geometric test decodes its micro-cell at its split-bf16 (u, v)
// (cluster.cuh guarded_state, ~25 operations): a TRANSPARENT cell is
// rejected unless the point is near a cell edge (the JAX kernel's _EDGE4
// rule: there the split-bf16 error could flip the cell, so it resolves as
// UNKNOWN), and the winner's UNKNOWN or near-edge flag goes to HA_UNK for
// K4's alpha test.
//
// The winner's attribute rows are read from the f32 blocks in global
// memory once, after the walk, and the winner is refit exactly in f32
// (cluster.cuh refit): a lane with the plain version's winner gets its HA
// rows bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

constexpr int KQ = 48;                   // bf16 per A row (40 used)
constexpr int COEF_ROWS = 20;            // rows 0..9 c_hi, 10..19 c_lo
constexpr int TILE_COMPS = 6;            // components det, u and v read
constexpr int ZERO_ROW = 2 * TILE_COMPS; // the bf16 tile's zero row
constexpr int B_STRIDE = LANES + 8;      // bf16 per tile row
constexpr int CHUNKS = CT / 8;           // 8-triangle chunks of a cluster
// One ring slot, in floats: the coefficient rows, the center (padded to
// 4), the micromap words, an instance's M10 (padded to 104).
constexpr int RING_CEN = COEF_ROWS * LANES;
constexpr int RING_MW = RING_CEN + 4;
constexpr int RING_XM = RING_MW + CT;
constexpr int RING_FLOATS = RING_XM + 104;
constexpr int LIST = 8;                  // screened candidates a thread keeps per ray
constexpr int A_BYTES = FL * KQ * 2;
constexpr int B_BYTES = (ZERO_ROW + 1) * B_STRIDE * 2;
constexpr int LIST_BASE = A_BYTES + B_BYTES + 2 * RING_FLOATS * 4;
constexpr int SMEM_BYTES = LIST_BASE + FL * 2 * LIST;
static_assert(A_BYTES % 16 == 0 && B_BYTES % 16 == 0 && RING_MW % 4 == 0 &&
                  RING_XM % 4 == 0 && RING_FLOATS % 4 == 0,
              "16-byte alignment of the shared-memory regions");
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// d += a (16 x 16, row-major) * b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats (bf16-exact) as one bf16x2 word, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tile row of virtual row k of quantity `qn`'s stacked B (det 0, u 1,
// v 2): component k / 4, stack k % 4 (c_lo in stack 3, at tile row
// TILE_COMPS + component); the zero row where the quantity does not read
// the component (Q_ROWS of bounce_clustered.py).
__device__ __forceinline__ int tile_row(int qn, int k) {
  const int comp = k >> 2;
  if (comp >= (qn == 0 ? 3 : TILE_COMPS)) return ZERO_ROW;
  return (k & 3) == 3 ? TILE_COMPS + comp : comp;
}

// The screen on the tensor cores' det, u and v numerators: inside the edge
// margins widened to kScreen (4x), whatever t. Far wider than the
// difference between these sums and the plain version's (a few f32 ulps of
// the terms), so every candidate the plain version finds valid passes; a
// degenerate or padding triangle (|det| = 0) does not.
constexpr float kScreen = 4.0f * kMargin;

__device__ __forceinline__ bool screen(float det, float un, float vn) {
  const Quant q = signed_quant(det, un, vn, 0.0f);
  const float w = kScreen * q.absd;
  return q.absd > 0.0f && q.su >= -w && q.sv >= -w && q.su + q.sv <= q.absd + w + w;
}

// A ray's operand (hi, lo) read back from its A row: r_hi as is, and
// lo = l1 + l2, which is exact (make_operand's f32 residual).
__device__ __forceinline__ void operand_of_row(const __nv_bfloat16* row, float* hi,
                                               float* lo) {
  const uint2* w = reinterpret_cast<const uint2*>(row);
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    const uint2 v = w[k];
    hi[k] = __uint_as_float(v.x << 16);
    lo[k] = __uint_as_float(v.x & 0xFFFF0000u) + __uint_as_float(v.y << 16);
  }
}

// Issue the cp.async copies of slot data into one ring slot: rows 0..19 of
// cluster `cid`'s block, its center, its micromap words (OMM) or instance
// `iid`'s M10 (INST). The caller commits.
template <bool INST, bool OMM>
__device__ __forceinline__ void stage_async(float* slot, const float* blocks,
                                            const int* micro, const float* xf,
                                            int cid, int iid, int l) {
  const float* src = blocks + (size_t)cid * BLK_FLOATS;
  for (int k = l; k < COEF_ROWS * LANES / 4; k += FL)
    cp_async16(slot + 4 * k, src + 4 * k);
  if (l < 3) cp_async4(slot + RING_CEN + l, src + CENTER_ROW * LANES + l * CT);
  if constexpr (OMM) {
    if (l >= 32 && l < 32 + CT / 4)
      cp_async16(slot + RING_MW + 4 * (l - 32), micro + (size_t)cid * CT + 4 * (l - 32));
  }
  if constexpr (INST) {
    if (l >= 64 && l < 64 + XF_FLOATS / 4)
      cp_async16(slot + RING_XM + 4 * (l - 64), xf + (size_t)iid * XF_FLOATS + 4 * (l - 64));
  }
}

template <bool INST, bool OMM>
__global__ void __launch_bounds__(FL, 1)
cluster_closest_kernel(const int* __restrict__ cand, const float* __restrict__ od,
                       const float* __restrict__ blocks, const float* __restrict__ xf,
                       const int* __restrict__ micro, float* __restrict__ ha,
                       int* __restrict__ visits, int n, int cand_w, int kslots,
                       float max_travel, int noprune) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const at = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const bt = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* const ring = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  const int* cinst = cg + 1 + (2 + R) * kslots;
  auto OD = [&](int r) { return od[(size_t)r * n + i]; };
  const V3 d = v3(OD(OD_D), OD(OD_D + 1), OD(OD_D + 2));
  const V3 oxd = v3(OD(OD_OXD), OD(OD_OXD + 1), OD(OD_OXD + 2));
  const V3 o = v3(OD(OD_O), OD(OD_O + 1), OD(OD_O + 2));
  const bool act = OD(OD_ACT) > 0.5f;

  // This lane's row of the warp's A tile (tile q / 2, row g + 8 (q % 2)),
  // and the ldmatrix row addresses: A rows of this thread's matrix slot,
  // and each quantity's B rows (u and v share theirs, 128 columns apart).
  const int wrow = warp * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
  uint4* const arow = reinterpret_cast<uint4*>(at + (size_t)wrow * KQ);
  const int mslot = lane >> 3, mr = lane & 7;
  const uint32_t a_addr =
      smem_u32(at + (size_t)(warp * 32 + mr + 8 * (mslot & 1)) * KQ + 8 * (mslot >> 1));
  const uint32_t b_det =
      smem_u32(bt + tile_row(0, lane & 15) * B_STRIDE + 0 * CT);
  const uint32_t b_u = smem_u32(bt + tile_row(1, lane) * B_STRIDE + 1 * CT);
  const uint32_t b_v = b_u + CT * 2;
  uint8_t* const list = smem + LIST_BASE + l * 2 * LIST;
  if (l < LANES / 8)
    reinterpret_cast<uint4*>(bt + ZERO_ROW * B_STRIDE)[l] = make_uint4(0, 0, 0, 0);

  float best_t = kBigT;
  int best_c = 0, best_j = 0, best_i = 0;
  bool best_unk = false;
  const int count = cg[0];
  if (count > 0)
    stage_async<INST, OMM>(ring, blocks, micro, xf, cg[1], INST ? cinst[0] : 0, l);
  cp_async_commit();
  int s = 0;
  for (; s < count; ++s) {
    const int te_bits = cg[1 + kslots + s];
    const int bound_bits = act ? __float_as_int(best_t) : 0;
    if (!__syncthreads_or(noprune || bound_bits >= te_bits)) break;
    // every thread is past the previous visit: its ring slot, the B tile
    // and the A tiles are free
    const float* cur = ring + (s & 1) * RING_FLOATS;
    if (s + 1 < count)
      stage_async<INST, OMM>(ring + ((s + 1) & 1) * RING_FLOATS, blocks, micro, xf,
                             cg[2 + s], INST ? cinst[s + 1] : 0, l);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    for (int k = l; k < 2 * TILE_COMPS * LANES / 4; k += FL) {
      const int row = k >> 7;  // tile row: c_hi 0..5, then c_lo 0..5
      const int src = row < TILE_COMPS ? row : row - TILE_COMPS + 10;
      const float4 v = reinterpret_cast<const float4*>(cur + src * LANES)[k & 127];
      *reinterpret_cast<uint2*>(bt + row * B_STRIDE + (k & 127) * 4) =
          make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
    }
    const int cid = cg[1 + s];
    const int iid = INST ? cinst[s] : 0;

    // the lane's operand: make_operand's f32 arithmetic, then the split
    const V3 c = v3(cur[RING_CEN], cur[RING_CEN + 1], cur[RING_CEN + 2]);
    V3 dv = d, oxdv = oxd, ov = o;
    if constexpr (INST) xform_operand(cur + RING_XM, d, oxd, o, dv, oxdv, ov);
    float hi[10], lo[10];
    make_operand(dv, oxdv, ov, c, hi, lo);
    uint32_t w[20];  // component k: [r_hi, l1] [l2, r_hi]
#pragma unroll
    for (int k = 0; k < 10; ++k) {
      const float l1 = bf16_round(lo[k]);
      w[2 * k] = pack_bf16(hi[k], l1);
      w[2 * k + 1] = pack_bf16(lo[k] - l1, hi[k]);
    }
#pragma unroll
    for (int k = 0; k < 5; ++k)
      arow[k] = make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
    arow[5] = make_uint4(0, 0, 0, 0);
    __syncthreads();  // the B tile is complete; the A rows are written

    const int* words = OMM ? reinterpret_cast<const int*>(cur + RING_MW) : nullptr;
    float t_c = kBigT;
    int key_c = 0;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      uint32_t a[2][4];
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) ldsm_x4(a[ks], a_addr + (mt * 16 * KQ + ks * 16) * 2);
      int cnt[2] = {0, 0};
#pragma unroll 1
      for (int ch = 0; ch < CHUNKS; ++ch) {
        const uint32_t off = ch * 16;  // 8 bf16 columns
        uint32_t bd[2], bu[4], bv[4];
        ldsm_x2_t(bd, b_det + off);
        ldsm_x4_t(bu, b_u + off);
        ldsm_x4_t(bv, b_v + off);
        float qd[4] = {0.0f, 0.0f, 0.0f, 0.0f}, qu[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float qv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(qd, a[0], bd[0], bd[1]);
        mma_bf16(qu, a[0], bu[0], bu[1]);
        mma_bf16(qu, a[1], bu[2], bu[3]);
        mma_bf16(qv, a[0], bv[0], bv[1]);
        mma_bf16(qv, a[1], bv[2], bv[3]);
        // accumulator e: ray row g + 8 (e / 2) of the tile, triangle
        // 8 ch + 2q + e % 2; a candidate that passes the screen joins the
        // ray's list in increasing triangle order
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (screen(qd[e], qu[e], qv[e])) {
            const int r = e >> 1;
            if (cnt[r] < LIST) list[r * LIST + cnt[r]] = (uint8_t)(ch * 8 + 2 * q + (e & 1));
            ++cnt[r];
          }
        }
      }
      // each listed candidate in exact f32 (the plain version's sums, on
      // the staged f32 rows and the operand read back from the A tile),
      // through `consider`; a list that overflowed takes all 32 of the
      // thread's triangles
      float ray_t[2] = {kBigT, kBigT};
      int ray_j[2] = {0, 0};
      bool ray_u[2] = {false, false};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (cnt[r] == 0) continue;
        float hi[10], lo[10];
        operand_of_row(at + (size_t)(warp * 32 + mt * 16 + g + 8 * r) * KQ, hi, lo);
        const int n_c = cnt[r] <= LIST ? cnt[r] : CT / 4;
#pragma unroll 1
        for (int c = 0; c < n_c; ++c) {
          const int j = cnt[r] <= LIST ? (int)list[r * LIST + c] : (c >> 1) * 8 + 2 * q + (c & 1);
          consider(quantities(cur, j, hi, lo), j, max_travel, words, ray_t[r], ray_j[r],
                   ray_u[r]);
        }
      }
      // the quad's least t per ray, the lowest triangle on ties; the ray's
      // own thread (lane 4g + 2mt + r) keeps it
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tv = ray_t[r];
        int key = (ray_j[r] << 1) | (ray_u[r] ? 1 : 0);
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          const float to = __shfl_xor_sync(0xffffffffu, tv, m);
          const int ko = __shfl_xor_sync(0xffffffffu, key, m);
          if (to < tv || (to == tv && ko < key)) {
            tv = to;
            key = ko;
          }
        }
        if (q == 2 * mt + r) {
          t_c = tv;
          key_c = key;
        }
      }
    }
    if (t_c < best_t) {
      best_t = t_c;
      best_c = cid;
      best_j = key_c >> 1;
      best_i = iid;
      best_unk = (key_c & 1) != 0;
    }
  }
  cp_async_wait<0>();

  if (visits != nullptr && l == 0) visits[blockIdx.x] = s;

  // the winner's rows (zero when the lane has none), refit, HA rows out
  const bool had = best_t < kBigT;
  const float* wb = blocks + (size_t)best_c * BLK_FLOATS;
  auto attr = [&](int a) {
    return had ? wb[(ATTR_BASE + a / 4) * LANES + (a % 4) * CT + best_j] : 0.0f;
  };
  auto attr3 = [&](int a) { return v3(attr(a), attr(a + 1), attr(a + 2)); };
  const V3 cen = had ? v3(wb[CENTER_ROW * LANES], wb[CENTER_ROW * LANES + CT],
                          wb[CENTER_ROW * LANES + 2 * CT])
                     : v3(0.0f, 0.0f, 0.0f);
  V3 dr = d, orr = o;
  if constexpr (INST) {
    V3 oxd_o;
    xform_operand(xf + (size_t)best_i * XF_FLOATS, d, oxd, o, dr, oxd_o, orr);
    if (!had) dr = orr = v3(0.0f, 0.0f, 0.0f);
  }
  const Refit r = refit(orr - cen, dr, attr3(AT_V0), attr3(AT_E1), attr3(AT_E2),
                        max_travel);
  const bool hit = had && r.ok && attr(AT_VALID) > 0.5f;
  float* out = ha + i;
  out[(size_t)HA_T * n] = hit ? r.t : kBigT;
  out[(size_t)HA_U * n] = r.u;
  out[(size_t)HA_V * n] = r.v;
  out[(size_t)HA_FRONT * n] = hit ? r.det : -1.0f;
  out[(size_t)HA_PRIM * n] = hit ? attr(AT_GIDX) : -1.0f;
#pragma unroll
  for (int k = 0; k < HA_NATTR; ++k) out[(size_t)(HA_ATTR + k) * n] = attr(kAttrRows[k]);
  out[(size_t)HA_UNK * n] = (OMM && hit && best_unk) ? 1.0f : 0.0f;
  out[(size_t)HA_INST * n] = (INST && hit) ? (float)best_i : -1.0f;
}

template <bool INST, bool OMM>
int launch(const int* cand, const float* od, const float* blocks, const float* xf,
           const int* micro, float* ha, int* visits, int n_groups, int cand_w,
           int kslots, float max_travel, int noprune, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      cluster_closest_kernel<INST, OMM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cluster_closest_kernel<INST, OMM><<<n_groups, FL, SMEM_BYTES, stream>>>(
      cand, od, blocks, xf, micro, ha, visits, n_groups * FL, cand_w, kslots,
      max_travel, noprune);
  return (int)cudaGetLastError();
}

}  // namespace

// `visits` (NULL or [n_groups] i32) receives the slots each group visited;
// `micro` (NULL, or the [C, CT] micromap words) selects the omm variant.
// `blocks` and `micro` must be 16-byte aligned (the wrapper checks).
extern "C" int rtxpt_cluster_closest(const int* cand, const float* od,
                                     const float* blocks, const int* micro,
                                     float* ha, int* visits, int n_groups,
                                     int kslots, float max_travel, int noprune,
                                     void* stream) {
  const int cand_w = 1 + (2 + R) * kslots;
  if (micro != nullptr)
    return launch<false, true>(cand, od, blocks, nullptr, micro, ha, visits, n_groups,
                               cand_w, kslots, max_travel, noprune,
                               (cudaStream_t)stream);
  return launch<false, false>(cand, od, blocks, nullptr, nullptr, ha, visits, n_groups,
                              cand_w, kslots, max_travel, noprune, (cudaStream_t)stream);
}

// The instanced variant: `cand` rows [1 + (3 + R) * kslots] (pool block ids,
// then each slot's instance id at 1 + (2 + R) * kslots), `xf` [I, 10, 10]
// (16-byte aligned).
extern "C" int rtxpt_cluster_closest_inst(const int* cand, const float* od,
                                          const float* blocks, const float* xf,
                                          float* ha, int* visits, int n_groups,
                                          int kslots, float max_travel,
                                          int noprune, void* stream) {
  const int cand_w = 1 + (3 + R) * kslots;
  return launch<true, false>(cand, od, blocks, xf, nullptr, ha, visits, n_groups,
                             cand_w, kslots, max_travel, noprune, (cudaStream_t)stream);
}
