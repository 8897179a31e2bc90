// K11, the all-rows flat-lane clustered intersection probe, written by hand
// for Hopper (sm_90a).
//
// Replaces scripts/micro_flat_kernel.py::kernel (launched there by run,
// pl.pallas_call at micro_flat_kernel.py:153): the JAX package's probe of
// the flat form that became K3 (_flat_cols / _kernel_a1 of
// rtxpt_tpu/pt/bounce_clustered.py). Plain version: rtxpt_tpu_torch/probes/
// micro_flat_kernel.py flat_reference; wrapper: micro_flat_kernel.run.
//
// Input: cand [G, 1, 17] i32 (count, then 16 cluster ids), od [G, 6, 1024]
// f32 (o and d of a group's 1024 rays, flat lanes), blocks [C, 24, 512] f32
// (rows 0..9 the bf16-rounded hi parts, rows 10..19 the bf16-rounded lo
// parts of 10 coefficient rows; the 512 columns det | u | v | t of 128
// triangles). Output: t [G, 8, 128] f32 (1e30 on a miss) and prim
// [G, 8, 128] f32 (cluster id * 128 + triangle, 0 on a miss), lane
// r * 128 + l of the group at [r, l].
//
// What it computes, per lane. The ray operand rvec = [d, o x d, o, 1] (10
// rows) is split once per group into r_hi = bf16(rvec) and r_lo = rvec - r_hi
// (the TPU would round r_lo to bf16 too; here it stays f32, as the JAX
// kernel computes in interpret mode on the CPU). Per visited cluster and
// triangle, each of det, u, v, t is the 30-term product
// sum_k chi[k] r_hi[k] + sum_k chi[k] r_lo[k] + sum_k clo[k] r_hi[k]
// (the TPU kernel's [32, 512] x [32, 1024] dot without its two zero rows),
// summed in that order, a multiply then an add (-fmad=false). The selection
// (micro_flat_kernel.py:88-109): the sign of det, the 2e-3 margins,
// t = st / max(|det|, 1e-30), the minimum over the 128 triangles and the
// first triangle that reaches it; the lane's winner moves only when the
// cluster's t is strictly smaller. At the end the TPU kernel brings the flat
// [8, 1024] state to [8, 128] rows with 8 permutation matmuls; that is an
// index here: lane r * 128 + l is row r, column l.
//
// Design. One block of 1024 threads per group, one thread per flat lane;
// the lane's r_hi and r_lo stay in registers. A visit stages the block's
// rows 0..19 (40 KB) in shared memory, transposed to one 80-float record per
// triangle (det, u, v, t, each chi[0..9] then clo[0..9]), read as 16-byte
// broadcasts.
//
// What bounds it: operations. A pair costs 4 x (30 multiplies + 29 adds) of
// the products and 27 f32 operations of the selection against 40 KB of
// staged data shared by 1024 lanes; the products could run on the tensor
// cores in bf16 (the probe's question), the selection is f32 work either
// way. This first version keeps one staging buffer and no tensor cores.
#include <cuda_runtime.h>

#include "rt_error.cuh"

namespace {

constexpr int kFlat = 1024;       // lanes per group
constexpr int kCT = 128;          // triangles per cluster
constexpr int kCols = 4 * kCT;    // det | u | v | t
constexpr int kRowsIn = 24;       // rows of a block in device memory
constexpr int kKc = 10;           // coefficient rows
constexpr int kRec = 2 * kKc;     // floats per (triangle, quantity) record
constexpr int kSlots = 16;
constexpr float kBig = 1e30f;

__device__ __forceinline__ float bf16_hi(float x) {
  // round to nearest even at bf16 (the TPU's astype(bfloat16), torch's
  // float -> bfloat16 conversion), as f32
  const unsigned u = __float_as_uint(x);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

__global__ void __launch_bounds__(kFlat)
probe_flat_kernel(const int* __restrict__ cand, const float* __restrict__ od,
                  const float4* __restrict__ blocks, float* __restrict__ t_out,
                  float* __restrict__ prim_out) {
  __shared__ float4 tile[kCT * 4 * kRec / 4];
  const int g = blockIdx.x;
  const int lane = threadIdx.x;
  const float* o = od + (size_t)g * 6 * kFlat;
  const float o0 = o[0 * kFlat + lane], o1 = o[1 * kFlat + lane],
              o2 = o[2 * kFlat + lane];
  const float d0 = o[3 * kFlat + lane], d1 = o[4 * kFlat + lane],
              d2 = o[5 * kFlat + lane];
  const float rvec[kKc] = {d0, d1, d2,
                           o1 * d2 - o2 * d1, o2 * d0 - o0 * d2, o0 * d1 - o1 * d0,
                           o0, o1, o2, 1.0f};
  float rhi[kKc], rlo[kKc];
#pragma unroll
  for (int k = 0; k < kKc; ++k) {
    rhi[k] = bf16_hi(rvec[k]);
    rlo[k] = rvec[k] - rhi[k];
  }
  const int* cg = cand + (size_t)g * (1 + kSlots);
  const int count = cg[0];
  float best_t = kBig, best_j = 0.0f, best_c = 0.0f;
  for (int i = 0; i < kSlots; ++i) {
    if (i >= count) break;                // uniform across the block
    const int cid = cg[1 + i];
    const float4* blk = blocks + (size_t)cid * (kRowsIn * kCols / 4);
    __syncthreads();                      // the previous tile is read
    float* tl = reinterpret_cast<float*>(tile);
    for (int e = threadIdx.x; e < kRec * kCols / 4; e += kFlat) {
      const float4 v = blk[e];            // rows 0..19 lead the block
      const int k = (4 * e) / kCols, q0 = (4 * e) % kCols;
      const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int q = q0 + m, qi = q / kCT, j = q % kCT;
        tl[(j * 4 + qi) * kRec + k] = vs[m];
      }
    }
    __syncthreads();
    float t_c = 0.0f;
    int jc = kCT;
    bool nan_seen = false;
    for (int j = 0; j < kCT; ++j) {
      float qv[4];
#pragma unroll
      for (int qi = 0; qi < 4; ++qi) {
        // chi[0..9], clo[0..9]: five 16-byte broadcasts
        const float4* r4 = tile + (j * 4 + qi) * (kRec / 4);
        float rec[kRec];
#pragma unroll
        for (int k4 = 0; k4 < kRec / 4; ++k4) {
          const float4 w = r4[k4];
          rec[4 * k4] = w.x;
          rec[4 * k4 + 1] = w.y;
          rec[4 * k4 + 2] = w.z;
          rec[4 * k4 + 3] = w.w;
        }
        float p = rec[0] * rhi[0];
#pragma unroll
        for (int k = 1; k < kKc; ++k) p = p + rec[k] * rhi[k];
#pragma unroll
        for (int k = 0; k < kKc; ++k) p = p + rec[k] * rlo[k];
#pragma unroll
        for (int k = 0; k < kKc; ++k) p = p + rec[kKc + k] * rhi[k];
        qv[qi] = p;
      }
      const float det = qv[0];
      const float sgn = det >= 0.0f ? 1.0f : -1.0f;
      const float absd = det * sgn, su = qv[1] * sgn, sv = qv[2] * sgn,
                  st = qv[3] * sgn;
      const float mm = 2e-3f * absd;
      const bool valid = (absd > 1e-30f) & (su >= -mm) & (sv >= -mm) &
                         (su + sv <= (absd + mm) + mm) & (st > 0.0f);
      const float den = absd < 1e-30f ? 1e-30f : absd;   // NaN stays NaN
      const float tm = valid ? st / den : kBig;
      // t_c = min over the triangles (NaN-propagating, as jnp.min), and the
      // first triangle whose t_m reaches it
      if (tm != tm) nan_seen = true;
      if (j == 0 || tm < t_c) {
        t_c = tm;
        jc = j;
      }
    }
    if (nan_seen) {
      t_c = __int_as_float(0x7FC00000);
      jc = kCT;                           // no t_m <= NaN
    }
    if (t_c < best_t) {                   // strictly: the earlier visit keeps
      best_t = t_c;
      best_j = (float)jc;
      best_c = (float)cid;
    }
  }
  t_out[(size_t)g * kFlat + lane] = best_t;
  prim_out[(size_t)g * kFlat + lane] = best_j + best_c * (float)kCT;
}

}  // namespace

extern "C" int rtxpt_probe_flat(const int* cand, const float* od, const float* blocks,
                                float* t, float* prim, int n_groups, void* stream) {
  if (n_groups > 0)
    probe_flat_kernel<<<n_groups, kFlat, 0, (cudaStream_t)stream>>>(
        cand, od, reinterpret_cast<const float4*>(blocks), t, prim);
  return (int)cudaGetLastError();
}
