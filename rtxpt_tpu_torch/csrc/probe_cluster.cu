// K10, the cluster-visit probe, written by hand for Hopper (sm_90a).
//
// Replaces scripts/micro_cluster_kernel.py::kernel (launched there by run,
// pl.pallas_call at micro_cluster_kernel.py:88): the JAX package's
// feasibility probe for the clustered closest-hit kernel, which times one
// dense product per cluster visit. Plain version: rtxpt_tpu_torch/probes/
// micro_cluster_kernel.py cluster_reference; wrapper: micro_cluster_kernel.run.
//
// Input: counts [G] i32 (candidates per group), cands [G, 16] i32 (cluster
// ids, the first `count` of them visited), cols [8, 16, 128] f32 (8 rows of
// 128 rays, 16 coefficients each; the same rays for every group), tris
// [C, 16, 512] f32 (a cluster's 16 coefficient rows; the 512 columns are det,
// u, v and t of 128 triangles, 128 wide each). Output: best [G, 8, 128] f32:
// for each row r and ray l, the running minimum over the visited clusters
// and their 128 triangles j of ((det + u) + v) + t, where each quantity is
// sum_k cols[r, k, l] * tris[c, k, q] (1e30 where nothing was visited).
//
// The TPU kernel computes all eight rows and stores row 0 only
// (micro_cluster_kernel.py:81). This kernel writes the whole [G, 8, 128]
// state, so that the compiler keeps all the work the probe exists to time;
// the wrapper returns best[:, 0:1], the TPU kernel's output.
//
// Design. One block of 1024 threads per group, one thread per (row, ray).
// A thread keeps its 16 coefficients in registers. A visit stages the
// cluster's [16, 512] block (32 KB) in shared memory, transposed to one
// 64-float record per triangle (det, u, v, t, 16 coefficients each), so that
// a thread reads a triangle as sixteen 16-byte shared-memory broadcasts. Each
// quantity is summed in k order, a multiply then an add (-fmad=false, as the
// plain version rounds), in f32 on the CUDA cores: the precision of the TPU
// kernel's HIGHEST dot; no TF32.
//
// What bounds it: operations. A (ray, triangle) pair costs 4 x (16
// multiplies + 15 adds) + 3 adds + 1 minimum = 128 f32 operations against
// 32 KB of staged data shared by 1024 threads; the bytes are negligible.
// This first version keeps one staging buffer (no cp.async double
// buffering) and no tensor cores: whether products on the tensor cores beat
// these per-thread sums is the question the probe asks (PERF.md, section 6).
#include <cuda_runtime.h>

#include "rt_error.cuh"

namespace {

constexpr int kRows = 8;          // ray rows per group
constexpr int kRays = 128;        // rays per row
constexpr int kThreads = kRows * kRays;
constexpr int kK = 16;            // coefficients per ray and triangle
constexpr int kCT = 128;          // triangles per cluster
constexpr int kCols = 4 * kCT;    // det | u | v | t
constexpr int kSlots = 16;        // candidate slots per group
constexpr float kBig = 1e30f;

// NaN-propagating minimum (jnp.minimum, torch.minimum)
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

__global__ void __launch_bounds__(kThreads)
probe_cluster_kernel(const int* __restrict__ counts, const int* __restrict__ cands,
                     const float* __restrict__ cols, const float4* __restrict__ tris,
                     float* __restrict__ best_out) {
  // one record of 4 quantities x 16 coefficients per triangle
  __shared__ float4 tile[kCT * 4 * (kK / 4)];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;           // r * 128 + l
  const int r = lane / kRays, l = lane % kRays;
  float c[kK];
#pragma unroll
  for (int k = 0; k < kK; ++k) c[k] = cols[(r * kK + k) * kRays + l];
  const int count = counts[g];
  float best = kBig;
  for (int i = 0; i < kSlots; ++i) {
    if (i >= count) break;                // uniform across the block
    const int cid = cands[g * kSlots + i];
    const float4* blk = tris + (size_t)cid * (kK * kCols / 4);
    __syncthreads();                      // the previous tile is read
    float* t = reinterpret_cast<float*>(tile);
    for (int e = threadIdx.x; e < kK * kCols / 4; e += kThreads) {
      const float4 v = blk[e];
      const int k = (4 * e) / kCols, q0 = (4 * e) % kCols;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = q0 + m, qi = q / kCT, j = q % kCT;
        t[(j * 4 + qi) * kK + k] = vs[m];
      }
    }
    __syncthreads();
    float mv = 0.0f;
    for (int j = 0; j < kCT; ++j) {
      float qv[4];
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        const float4* rec = tile + (j * 4 + qi) * (kK / 4);
        float p = 0.0f;
#pragma unroll
        for (int k4 = 0; k4 < kK / 4; ++k4) {
          const float4 w = rec[k4];
          if (k4 == 0) p = c[0] * w.x;
          else p = p + c[4 * k4] * w.x;
          p = p + c[4 * k4 + 1] * w.y;
          p = p + c[4 * k4 + 2] * w.z;
          p = p + c[4 * k4 + 3] * w.w;
        }
        qv[qi] = p;
      }
      const float s = ((qv[0] + qv[1]) + qv[2]) + qv[3];
      mv = j == 0 ? s : nan_min(mv, s);
    }
    best = nan_min(best, mv);
  }
  best_out[(size_t)g * kThreads + lane] = best;
}

}  // namespace

extern "C" int rtxpt_probe_cluster(const int* counts, const int* cands, const float* cols,
                                   const float* tris, float* best, int n_groups,
                                   void* stream) {
  if (n_groups > 0)
    probe_cluster_kernel<<<n_groups, kThreads, 0, (cudaStream_t)stream>>>(
        counts, cands, cols, reinterpret_cast<const float4*>(tris), best);
  return (int)cudaGetLastError();
}
