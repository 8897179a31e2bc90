// K5, the clustered shadow any-hit kernel, written by hand for Hopper
// (sm_90a), flat and instanced.
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_b1 and _kernel_b1_inst
// (bounce_clustered.py:394 and :405, body _kernel_b1_body, launched by
// _kernel_b1_call, pl.pallas_call at bounce_clustered.py:1235), and
// _kernel_b1's micromap variant (omm=True, :443-454). _kernel_b1_inst with
// omm is unreachable in the JAX package (alpha-tested scenes are never
// instanced, accel/tlas.py:183-184), so it is not ported. Plain version:
// rtxpt_tpu_torch/pt/bounce_clustered.py occlusion_reference; wrapper:
// bounce_clustered.occlusion.
//
// Design. K3's candidate walk (cluster_closest.cu): one block of 1024
// threads per 1024-lane group of sorted shadow rays; here the slot's rows
// 0..20 are staged in shared memory as f32 and each thread tests its lane
// on the f32 units. The test is strict (no
// margins) and ends at dist * (1 - SHADOW_T_EPS). A lane stops testing once
// it is occluded, and the block leaves the walk once every lane is
// (__syncthreads_or of the unoccluded lanes, taken before each slot; it is
// also the barrier that frees the staging buffer). Lanes without a request
// start occluded.
//
// The instanced variant (_kernel_b1_inst): the candidate rows carry pool
// block ids and each slot's instance id (from 1 + (2 + R) * kslots on); a
// visit stages the instance's M10 beside the block and each unoccluded lane
// maps its world operand into the instance's object frame (xform_operand)
// before the flat test. The distance stays the world one.
//
// What bounds it: operations (57 multiplies and 53 adds of the split-bf16
// quantities and 14 operations of the strict test per ray-triangle pair,
// against broadcast shared-memory coefficients, -fmad=false for parity),
// but a lane's loop ends at its first occluder and the block's at its last
// unoccluded lane. K3 takes the same products on the tensor cores; this
// kernel does not yet.
//
// Micromaps: a visit also stages the cluster's 128 words and coverages (1 KB
// of the side table); an occluder candidate on a TRANSPARENT cell does not
// occlude unless near a cell edge, and one on an UNKNOWN or near-edge cell
// occludes where the request's alpha uniform (row SH_UA) is under the
// triangle's coverage (cluster.cuh occluded_in_block).
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

template <bool INST, bool OMM>
__global__ void __launch_bounds__(FL, 1)
cluster_shadow_kernel(const int* __restrict__ cand, const float* __restrict__ sh,
                      const float* __restrict__ blocks, const float* __restrict__ xf,
                      const int* __restrict__ micro, const float* __restrict__ cover,
                      float* __restrict__ occ_out, int* __restrict__ tests, int n,
                      int cand_w, int kslots) {
  __shared__ __align__(16) float stage[STAGE_ROWS * LANES];
  __shared__ float xm[INST ? XF_FLOATS : 1];
  __shared__ int mw[OMM ? CT : 1];
  __shared__ float mc[OMM ? CT : 1];
  const int l = threadIdx.x;
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  const int* cinst = cg + 1 + (2 + R) * kslots;
  auto SH = [&](int r) { return sh[(size_t)r * n + i]; };
  const V3 o = v3(SH(SH_O), SH(SH_O + 1), SH(SH_O + 2));
  const V3 d = v3(SH(SH_D), SH(SH_D + 1), SH(SH_D + 2));
  const V3 oxd = cross3(o, d);
  const float dist = SH(SH_DIST) * kShadowScale;
  const float u_alpha = OMM ? SH(SH_UA) : 0.0f;
  bool occ = !(SH(SH_DO) > 0.5f);

  const int count = cg[0];
  int tested = 0;
  for (int s = 0; s < count; ++s) {
    if (!__syncthreads_or(!occ)) break;
    const int cid = cg[1 + s];
    stage_block(stage, blocks, cid, l, FL);
    if constexpr (INST) {
      if (l < XF_FLOATS) xm[l] = xf[(size_t)cinst[s] * XF_FLOATS + l];
    }
    if constexpr (OMM) {
      if (l < CT) {
        mw[l] = micro[(size_t)cid * CT + l];
        mc[l] = cover[(size_t)cid * CT + l];
      }
    }
    __syncthreads();
    if (!occ) {
      const V3 c = block_center(stage);
      V3 dv = d, oxdv = oxd, ov = o;
      if constexpr (INST) xform_operand(xm, d, oxd, o, dv, oxdv, ov);
      float hi[10], lo[10];
      make_operand(dv, oxdv, ov, c, hi, lo);
      occ = occluded_in_block(stage, hi, lo, dist, tested, OMM ? mw : nullptr,
                              OMM ? mc : nullptr, u_alpha);
    }
  }
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr && tested > 0) atomicAdd(tests + blockIdx.x, tested);
}

}  // namespace

// `tests` (NULL or [n_groups] i32, zeroed by the caller) receives, per group,
// the ray-triangle pairs its lanes tested; `micro` and `cover` (NULL, or the
// [C, CT] micromap words and coverages) select the omm variant.
extern "C" int rtxpt_cluster_shadow(const int* cand, const float* sh,
                                    const float* blocks, const int* micro,
                                    const float* cover, float* occ, int* tests,
                                    int n_groups, int kslots, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  if (micro != nullptr)
    cluster_shadow_kernel<false, true><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
        cand, sh, blocks, nullptr, micro, cover, occ, tests, n, cand_w, kslots);
  else
    cluster_shadow_kernel<false, false><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
        cand, sh, blocks, nullptr, nullptr, nullptr, occ, tests, n, cand_w, kslots);
  return (int)cudaGetLastError();
}

// The instanced variant: `cand` rows [1 + (3 + R) * kslots] (pool block ids,
// then each slot's instance id at 1 + (2 + R) * kslots), `xf` [I, 10, 10].
extern "C" int rtxpt_cluster_shadow_inst(const int* cand, const float* sh,
                                         const float* blocks, const float* xf,
                                         float* occ, int* tests, int n_groups,
                                         int kslots, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (3 + R) * kslots;
  cluster_shadow_kernel<true, false><<<n_groups, FL, 0, (cudaStream_t)stream>>>(
      cand, sh, blocks, xf, nullptr, nullptr, occ, tests, n, cand_w, kslots);
  return (int)cudaGetLastError();
}
