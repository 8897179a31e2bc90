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
// The product form, the ring, the tiles and the screen are shared with K5
// (cluster_mma.cuh): [r_hi | l1 | l2 | r_hi] x [c_hi | c_hi | c_hi | c_lo]
// gives every product of the plain version exactly; only the order and
// rounding of the f32 accumulation differ, which on coincident and
// edge-sharing triangles decides near-ties the other way (0.12% of the
// city's lanes when these sums drove the whole selection).
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
#include "cluster_mma.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

using RG = Ring<false>;                   // the ring carries no coverages
constexpr int LIST_BASE = A_BYTES + B_BYTES + 2 * RG::FLOATS * 4;
constexpr int SMEM_BYTES = LIST_BASE + LIST_BYTES;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

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
  const Frag fr = frag_addrs(at, bt, warp, lane);
  uint8_t* const list = smem + LIST_BASE + l * 2 * LIST;
  if (l < LANES / 8)
    reinterpret_cast<uint4*>(bt + ZERO_ROW * B_STRIDE)[l] = make_uint4(0, 0, 0, 0);

  float best_t = kBigT;
  int best_c = 0, best_j = 0, best_i = 0;
  bool best_unk = false;
  const int count = cg[0];
  if (count > 0)
    stage_async<INST, OMM, false>(ring, blocks, micro, nullptr, xf, cg[1],
                                  INST ? cinst[0] : 0, l);
  cp_async_commit();
  int s = 0;
  for (; s < count; ++s) {
    const int te_bits = cg[1 + kslots + s];
    const int bound_bits = act ? __float_as_int(best_t) : 0;
    if (!__syncthreads_or(noprune || bound_bits >= te_bits)) break;
    // every thread is past the previous visit: its ring slot, the B tile
    // and the A tiles are free
    const float* cur = ring + (s & 1) * RG::FLOATS;
    if (s + 1 < count)
      stage_async<INST, OMM, false>(ring + ((s + 1) & 1) * RG::FLOATS, blocks, micro,
                                    nullptr, xf, cg[2 + s], INST ? cinst[s + 1] : 0, l);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    convert_tile(bt, cur, l);
    const int cid = cg[1 + s];
    const int iid = INST ? cinst[s] : 0;

    // the lane's operand: make_operand's f32 arithmetic, then the split
    const V3 c = v3(cur[RG::CEN], cur[RG::CEN + 1], cur[RG::CEN + 2]);
    V3 dv = d, oxdv = oxd, ov = o;
    if constexpr (INST) xform_operand(cur + RG::XM, d, oxd, o, dv, oxdv, ov);
    float hi[10], lo[10];
    make_operand(dv, oxdv, ov, c, hi, lo);
    write_a_row(arow, hi, lo);
    __syncthreads();  // the B tile is complete; the A rows are written

    const int* words = OMM ? reinterpret_cast<const int*>(cur + RG::MW) : nullptr;
    float t_c = kBigT;
    int key_c = 0;
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      int cnt[2];
      screen_tile(fr.a, fr.det, fr.u, mt, q, list, cnt);
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
        const int n_c = listed_count(cnt[r]);
#pragma unroll 1
        for (int c = 0; c < n_c; ++c) {
          const int j = listed(list + r * LIST, cnt[r], c, q);
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
