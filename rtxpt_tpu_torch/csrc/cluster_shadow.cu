// K5, the clustered shadow any-hit kernel, written by hand for Hopper
// (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_b1 (body
// _kernel_b1_body, launched by _kernel_b1_call, pl.pallas_call at
// bounce_clustered.py:1235), flat and not instanced. Plain version:
// rtxpt_tpu_torch/pt/bounce_clustered.py occlusion_reference; wrapper:
// bounce_clustered.occlusion.
//
// Design. The candidate walk of K3 (cluster_closest.cu): one block of 1024
// threads per 1024-lane group of sorted shadow rays, the slot's rows 0..20
// staged in shared memory, one thread per lane. The test is strict (no
// margins) and ends at dist * (1 - SHADOW_T_EPS). A lane stops testing once
// it is occluded, and the block leaves the walk once every lane is
// (__syncthreads_or of the unoccluded lanes, taken before each slot; it is
// also the barrier that frees the staging buffer). Lanes without a request
// start occluded.
//
// What bounds it: operations, as K3 (57 multiplies and 53 adds of the
// split-bf16 quantities and 14 operations of the strict test per ray-triangle
// pair, against broadcast shared-memory coefficients, -fmad=false for
// parity), but a lane's loop ends at its first occluder and the block's at
// its last unoccluded lane.
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

__global__ void __launch_bounds__(FL, 1)
cluster_shadow_kernel(const int* __restrict__ cand, const float* __restrict__ sh,
                      const float* __restrict__ blocks, float* __restrict__ occ_out,
                      int* __restrict__ tests, int n, int cand_w, int kslots) {
  __shared__ __align__(16) float stage[STAGE_ROWS * LANES];
  const int l = threadIdx.x;
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  auto SH = [&](int r) { return sh[(size_t)r * n + i]; };
  const V3 o = v3(SH(SH_O), SH(SH_O + 1), SH(SH_O + 2));
  const V3 d = v3(SH(SH_D), SH(SH_D + 1), SH(SH_D + 2));
  const V3 oxd = cross3(o, d);
  const float dist = SH(SH_DIST) * kShadowScale;
  bool occ = !(SH(SH_DO) > 0.5f);

  const int count = cg[0];
  int tested = 0;
  for (int s = 0; s < count; ++s) {
    if (!__syncthreads_or(!occ)) break;
    const int cid = cg[1 + s];
    const float4* src = reinterpret_cast<const float4*>(blocks + (size_t)cid * BLK_FLOATS);
    float4* dst = reinterpret_cast<float4*>(stage);
    for (int k = l; k < STAGE_ROWS * LANES / 4; k += FL) dst[k] = src[k];
    __syncthreads();
    if (!occ) {
      const V3 c = v3(stage[CENTER_ROW * LANES], stage[CENTER_ROW * LANES + CT],
                      stage[CENTER_ROW * LANES + 2 * CT]);
      float hi[10], lo[10];
      make_operand(d, oxd, o, c, hi, lo);
      occ = occluded_in_block(stage, hi, lo, dist, tested);
    }
  }
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr && tested > 0) atomicAdd(tests + blockIdx.x, tested);
}

}  // namespace

// `tests` (NULL or [n_groups] i32, zeroed by the caller) receives, per group,
// the ray-triangle pairs its lanes tested.
extern "C" int rtxpt_cluster_shadow(const int* cand, const float* sh,
                                    const float* blocks, float* occ, int* tests,
                                    int n_groups, int kslots, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  cluster_shadow_kernel<<<n_groups, FL, 0, (cudaStream_t)stream>>>(
      cand, sh, blocks, occ, tests, n, cand_w, kslots);
  return (int)cudaGetLastError();
}
