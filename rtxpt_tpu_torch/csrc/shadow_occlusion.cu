// K2, the shadow any-hit kernel of external NEE, written by hand for Hopper
// (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_pallas.py::_shadow_kernel (launched by
// shadow_occlusion_call, pl.pallas_call at bounce_pallas.py:1597), with and
// without opacity micromaps (omm=True: a micro-TRANSPARENT candidate never
// occludes, an UNKNOWN one where the request's alpha uniform, row SR_UA, is
// under the triangle's coverage; K1's occluded<true>). Plain version:
// rtxpt_tpu_torch/pt/bounce_fused.py occlusion_reference; wrapper:
// bounce_fused.occlusion.
//
// Input: the shadow requests that pt/nee_external.py builds on the surfaces
// K1 exported, sh [SR_ROWS, n] (origin, direction, distance, request flag).
// Output: occ [n], 1 = occluded or no request, 0 = visible.
//
// Design. One thread per request, as K1: each thread walks the resident
// triangle table (tri_coef, read through the read-only cache; every thread of
// a warp reads the same row, so one broadcast load serves the warp) with K1's
// own occluded() and tri_test(), so K1 and K2 find the same hits, and stops at
// its first occluder. A lane without a request writes 1 and tests nothing.
// `tests` (NULL, or [n] i32) receives the pairs each lane tested up to and
// including its first occluder, for the bound.
//
// What bounds it: operations. 38 f32 operations per ray-triangle pair
// (tri_test, -fmad=false for parity) against 36 bytes of request read and 4
// written per lane; a lane's loop ends at its first occluder, a warp's at its
// slowest lane.
#include <cuda_runtime.h>

#include "bounce_fused.cuh"
#include "rt_error.cuh"

namespace {

constexpr int kThreads = 128;

template <bool HasOmm>
__global__ void __launch_bounds__(kThreads)
shadow_occlusion_kernel(const float* __restrict__ sh, float* __restrict__ occ_out,
                        int* __restrict__ tests, rt::Tables tb, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto SH = [&](int r) { return sh[(size_t)r * n + i]; };
  bool occ = true;
  int tested = 0;
  if (SH(rt::SR_DO) > 0.5f) {
    const rt::V3 o = rt::v3(SH(rt::SR_O), SH(rt::SR_O + 1), SH(rt::SR_O + 2));
    const rt::V3 d = rt::v3(SH(rt::SR_D), SH(rt::SR_D + 1), SH(rt::SR_D + 2));
    occ = rt::occluded<HasOmm>(tb, o, d, SH(rt::SR_DIST), HasOmm ? SH(rt::SR_UA) : 0.0f,
                               tested);
  }
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr) tests[i] = tested;
}

}  // namespace

// `micro` and `cover` ([tpad] each, or NULL): the micromap words and
// coverages of the omm variant.
extern "C" int rtxpt_shadow_occlusion(const float* sh, float* occ, int* tests,
                                      const float* tri_coef, const int* micro,
                                      const float* cover, int n, int n_tris,
                                      void* stream) {
  rt::Tables tb;
  tb.tri = tri_coef;
  tb.attr = nullptr;
  tb.mat = nullptr;
  tb.light = nullptr;
  tb.n_tris = n_tris;
  tb.tpad = 0;
  tb.n_lights = 0;
  tb.micro = micro;
  tb.cover = cover;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (micro != nullptr)
    shadow_occlusion_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        sh, occ, tests, tb, n);
  else
    shadow_occlusion_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        sh, occ, tests, tb, n);
  return (int)cudaGetLastError();
}
