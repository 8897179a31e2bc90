// K4, the clustered shading kernel, written by hand for Hopper (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_a2 (launched there by
// _kernel_a2_call, pl.pallas_call at bounce_clustered.py:1327) without its
// final_env, texture, priority, micromap, split-channel and external-NEE
// branches. Plain version: rtxpt_tpu_torch/pt/bounce_clustered.py
// shade_reference; wrapper: bounce_clustered.shade.
//
// Design. One thread per lane over a 1-D grid, as K1 (bounce_fused.cu): the
// per-thread body is K1's surface_and_shade (bounce_fused.cuh), with the
// attribute fetch reading K3's HA rows instead of the triangle table. It
// writes the next wavefront state, the NEE shadow request (SH rows, resolved
// by K5) and the hit rows. Every row is SoA [rows, N], so neighbouring threads
// touch neighbouring addresses.
//
// What bounds it: instructions and latency in the serial shading chain
// (hashes, Sobol' folds, light sample, BSDF eval, pdf and sample), as in K1.
// Per lane it reads 35 HA rows + 15 + 8 state rows (232 B) and writes
// 15 + 8 + 15 + 6 rows (176 B): 408 B, 0.25 ms at 3.35 TB/s for a 2^21-lane
// 1080p wavefront.
#include <cuda_runtime.h>

#include "bounce_fused.cuh"
#include "cluster.cuh"
#include "rt_error.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
cluster_shade_kernel(const float* __restrict__ ha, const float* __restrict__ fs,
                     const int* __restrict__ is, float* __restrict__ fs_out,
                     int* __restrict__ is_out, float* __restrict__ sh_out,
                     float* __restrict__ hit_out, rt::Tables tb, rt::Config cfg,
                     int n) {
  using namespace rt::cl;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  auto H = [&](int r) { return ha[(size_t)r * n + i]; };
  rt::RayState s = rt::load_state(i, n, fs, is);
  rt::Hit h;
  h.t = H(HA_T);
  h.u = H(HA_U);
  h.v = H(HA_V);
  h.det = H(HA_FRONT);
  h.prim = -1;                       // surface_and_shade reads it only via A
  auto attr = [&](int r) { return H(HA_ATTR + r); };
  const rt::ShadowRay sr = rt::surface_and_shade(s, h, attr, tb, cfg);
  rt::store_state(i, n, s, fs_out, is_out);
  float* so = sh_out + i;
  const size_t sn = (size_t)n;
  so[(SH_O + 0) * sn] = sr.o.x; so[(SH_O + 1) * sn] = sr.o.y; so[(SH_O + 2) * sn] = sr.o.z;
  so[(SH_D + 0) * sn] = sr.d.x; so[(SH_D + 1) * sn] = sr.d.y; so[(SH_D + 2) * sn] = sr.d.z;
  so[SH_DIST * sn] = sr.dist;
  so[(SH_CONTRIB + 0) * sn] = sr.contrib.x;
  so[(SH_CONTRIB + 1) * sn] = sr.contrib.y;
  so[(SH_CONTRIB + 2) * sn] = sr.contrib.z;
  so[SH_DO * sn] = sr.do_nee ? 1.0f : 0.0f;
  for (int r = SH_CDIFF; r < SH_ROWS; ++r) so[r * sn] = 0.0f;
  float* ho = hit_out + i;
  ho[0] = h.t < rt::kBig ? h.t : 0.0f;
  ho[sn] = H(HA_PRIM);
  ho[2 * sn] = h.u;
  ho[3 * sn] = h.v;
  ho[4 * sn] = h.det > 0.0f ? 1.0f : 0.0f;
  ho[5 * sn] = sr.do_nee ? 1.0f : 0.0f;
}

}  // namespace

extern "C" int rtxpt_cluster_shade(
    const float* ha, const float* fs, const int* is, float* fs_out, int* is_out,
    float* sh_out, float* hit_out, const float* mat_rows, const float* light_rows,
    int n, int n_lights, unsigned int sample_idx, int nee_mode, int enable_mis,
    float firefly, int rr_enable, int min_rr, int low_discrepancy,
    int energy_comp, int maxb, void* stream) {
  rt::Tables tb;
  tb.tri = nullptr;
  tb.attr = nullptr;
  tb.mat = mat_rows;
  tb.light = light_rows;
  tb.n_tris = 0;
  tb.tpad = 0;
  tb.n_lights = n_lights;
  rt::Config cfg;
  cfg.sample_idx = sample_idx;
  cfg.nee_mode = nee_mode;
  cfg.enable_mis = enable_mis != 0;
  cfg.firefly = firefly;
  cfg.rr_enable = rr_enable != 0;
  cfg.min_rr = min_rr;
  cfg.max_travel = 0.0f;             // no intersection in this kernel
  cfg.low_discrepancy = low_discrepancy != 0;
  cfg.energy_comp = energy_comp != 0;
  cfg.maxb = maxb;
  const int blocks = (n + kThreads - 1) / kThreads;
  cluster_shade_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      ha, fs, is, fs_out, is_out, sh_out, hit_out, tb, cfg, n);
  return (int)cudaGetLastError();
}
