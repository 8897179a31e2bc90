// K3, the clustered closest-hit kernel, written by hand for Hopper (sm_90a),
// flat and instanced.
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
// Design. One block of 1024 threads per 1024-lane ray group, one thread per
// lane. The block walks the group's candidate clusters nearest first. Before
// each slot a block-wide vote (__syncthreads_or) applies the prune: the slot
// is visited only while some active lane's committed t (as int32 bits) is at
// least the slot's hull entry distance; the vote is also the barrier that
// frees the staging buffer. A visit stages the block's rows 0..20 (the
// split-bf16 coefficients and the center, 43 KB) in shared memory with 16-byte
// loads; each thread then builds its cluster-local operand and tests all 128
// triangles, reading the coefficients as shared-memory broadcasts. A thread
// keeps only (t, cluster, triangle) of its best candidate; the winner's
// attribute rows are read from global memory once, after the loop, and the
// winner is refit exactly in f32 (cluster.cuh).
//
// The instanced variant. The candidate rows carry pool block ids and, from
// 1 + (2 + R) * kslots on, each slot's instance id. A visit also stages the
// instance's M10 (400 bytes) beside the block, and each thread maps its world
// operand [d, o x d, o, 1] into the instance's object frame (xform_operand)
// before the flat test. t stays the world parameter, so the selection across
// instances compares t as it is. A thread also keeps its winner's instance;
// after the loop it maps its ray again with that instance's M10 (the same
// sums, so the same object ray), refits on it and exports the instance in
// HA_INST. The attribute rows stay in object space; bounce_clustered
// .post_attr_inst brings them to world space after the pages merge.
//
// What bounds it: operations. A visit costs each lane 128 x (57 multiplies
// and 53 adds of the split-bf16 quantities, 27 operations of the selection)
// against 43 KB of staged data shared by 1024 lanes, so it is far above the
// card's bytes-per-operation balance; the instanced map adds 171 operations
// per lane and visit. The quantities are a bf16 matrix product that tensor
// cores could take; the selection is f32 work either way. Here both run on
// the f32 units: the shared-memory broadcasts (38 loads per triangle) and
// -fmad=false (no fused multiply-add, for parity with the plain version)
// double the instruction count. This first version keeps it simple: one
// staging buffer (no cp.async double buffering), no tensor cores, no
// compaction of inactive lanes (they sort to the end of the wavefront, so
// their groups cull to empty lists).
//
// Micromaps. A visit also stages the cluster's 128 micromap words (512 B of
// the side table, accel/cluster.py omm_word) beside the block. A candidate
// that passes the geometric test decodes its micro-cell at its split-bf16
// (u, v) (cluster.cuh guarded_state, ~25 operations): a TRANSPARENT cell is
// rejected unless the point is near a cell edge (the JAX kernel's _EDGE4
// rule: there the split-bf16 error could flip the cell, so it resolves as
// UNKNOWN), and the winner's UNKNOWN or near-edge flag goes to HA_UNK for
// K4's alpha test.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

template <bool INST, bool OMM>
__global__ void __launch_bounds__(FL, 1)
cluster_closest_kernel(const int* __restrict__ cand, const float* __restrict__ od,
                       const float* __restrict__ blocks, const float* __restrict__ xf,
                       const int* __restrict__ micro, float* __restrict__ ha,
                       int* __restrict__ visits, int n, int cand_w, int kslots,
                       float max_travel, int noprune) {
  __shared__ __align__(16) float stage[STAGE_ROWS * LANES];
  __shared__ float xm[INST ? XF_FLOATS : 1];
  __shared__ int mw[OMM ? CT : 1];
  const int l = threadIdx.x;
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  const int* cinst = cg + 1 + (2 + R) * kslots;
  auto OD = [&](int r) { return od[(size_t)r * n + i]; };
  const V3 d = v3(OD(OD_D), OD(OD_D + 1), OD(OD_D + 2));
  const V3 oxd = v3(OD(OD_OXD), OD(OD_OXD + 1), OD(OD_OXD + 2));
  const V3 o = v3(OD(OD_O), OD(OD_O + 1), OD(OD_O + 2));
  const bool act = OD(OD_ACT) > 0.5f;

  float best_t = kBigT;
  int best_c = 0, best_j = 0, best_i = 0;
  bool best_unk = false;
  const int count = cg[0];
  int s = 0;
  for (; s < count; ++s) {
    const int te_bits = cg[1 + kslots + s];
    const int bound_bits = act ? __float_as_int(best_t) : 0;
    if (!__syncthreads_or(noprune || bound_bits >= te_bits)) break;
    const int cid = cg[1 + s];
    stage_block(stage, blocks, cid, l, FL);
    int iid = 0;
    if constexpr (INST) {
      iid = cinst[s];
      if (l < XF_FLOATS) xm[l] = xf[(size_t)iid * XF_FLOATS + l];
    }
    if constexpr (OMM) {
      if (l < CT) mw[l] = micro[(size_t)cid * CT + l];
    }
    __syncthreads();
    const V3 c = block_center(stage);
    V3 dv = d, oxdv = oxd, ov = o;
    if constexpr (INST) xform_operand(xm, d, oxd, o, dv, oxdv, ov);
    float hi[10], lo[10];
    make_operand(dv, oxdv, ov, c, hi, lo);
    float t_c;
    int j_c;
    bool unk_c;
    closest_in_block(stage, hi, lo, max_travel, t_c, j_c, OMM ? mw : nullptr, unk_c);
    if (t_c < best_t) {
      best_t = t_c;
      best_c = cid;
      best_j = j_c;
      best_i = iid;
      best_unk = unk_c;
    }
  }

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

}  // namespace

// `visits` (NULL or [n_groups] i32) receives the slots each group visited;
// `micro` (NULL, or the [C, CT] micromap words) selects the omm variant.
extern "C" int rtxpt_cluster_closest(const int* cand, const float* od,
                                     const float* blocks, const int* micro,
                                     float* ha, int* visits, int n_groups,
                                     int kslots, float max_travel, int noprune,
                                     void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  if (micro != nullptr)
    cluster_closest_kernel<false, true><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
        cand, od, blocks, nullptr, micro, ha, visits, n, cand_w, kslots, max_travel,
        noprune);
  else
    cluster_closest_kernel<false, false><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
        cand, od, blocks, nullptr, nullptr, ha, visits, n, cand_w, kslots, max_travel,
        noprune);
  return (int)cudaGetLastError();
}

// The instanced variant: `cand` rows [1 + (3 + R) * kslots] (pool block ids,
// then each slot's instance id at 1 + (2 + R) * kslots), `xf` [I, 10, 10].
extern "C" int rtxpt_cluster_closest_inst(const int* cand, const float* od,
                                          const float* blocks, const float* xf,
                                          float* ha, int* visits, int n_groups,
                                          int kslots, float max_travel,
                                          int noprune, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (3 + R) * kslots;
  cluster_closest_kernel<true, false><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
      cand, od, blocks, xf, nullptr, ha, visits, n, cand_w, kslots, max_travel,
      noprune);
  return (int)cudaGetLastError();
}
