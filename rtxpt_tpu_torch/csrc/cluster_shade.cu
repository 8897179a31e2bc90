// K4, the clustered shading kernel, written by hand for Hopper (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_a2 (launched there by
// _kernel_a2_call, pl.pallas_call at bounce_clustered.py:1327) without its
// split-channel branch: NEE in the kernel
// (slots 0-2) or exported for external NEE (slots 3-5: the SF_* rows to
// `surf_out` and the shading flag in hit row 5, as K1 exports them; the JAX
// kernel computes those rows but leaves its surf_out unwritten), and the
// environment switches has_env and final_env of K1 (bounce_fused.cuh), and
// K1's texture switch has_tex / tex_maps on the HA rows (the template
// parameter HasTex; the UV, LODB, tangent rows ride in HA from K3's winner),
// and K1's micromap switch (the template parameter HasOmm, omm=True at
// :561-571: K3's HA_UNK flag into the alpha test and the pass-through, the
// alpha uniform out in SH_UA), and K1's nested-priority switch (the
// template parameter HasPrio, prio=True at :464, :560: the false-hit
// pass-through on K3's winner), and the split-channel switch (the template
// parameter HasSplit, cfg_key[9] at :469-494, :536-539, :557-559,
// :586-588: the fs2 rows in and out, the NEE diffuse part in SH_CDIFF; all
// sixteen combinations instantiated). Plain version: rtxpt_tpu_torch/pt/bounce_clustered.py shade_reference;
// wrapper: bounce_clustered.shade.
//
// Design. One thread per lane over a 1-D grid, as K1 (bounce_fused.cu): the
// per-thread body (cluster_shade.cuh shade_lane) is K1's surface_and_shade
// (bounce_fused.cuh), with the
// attribute fetch reading K3's HA rows instead of the triangle table. It
// writes the next wavefront state, the NEE shadow request (SH rows, resolved
// by K5) and the hit rows. Every row is SoA [rows, N], so neighbouring threads
// touch neighbouring addresses.
//
// What bounds it: instructions and latency in the serial shading chain
// (hashes, Sobol' folds, light sample, BSDF eval, pdf and sample), as in K1.
// Per lane it reads 35 HA rows + 15 + 8 state rows (232 B) and writes
// 15 + 8 + 15 + 6 rows (176 B): 408 B, 0.25 ms at 3.35 TB/s for a 2^21-lane
// 1080p wavefront; the export adds 24 rows (96 B), the environment table's
// 164 KB count once per launch and stay in L1 / L2, and so does the texture
// atlas (a float4 per fetch through __ldg, up to four fetches per lane).
// The split variant reads and writes the seven fs2 rows (56 B) and writes
// the three SH_CDIFF rows it otherwise zeroes: 56 B more per lane.
#include <cuda_runtime.h>

#include "cluster_shade.cuh"
#include "rt_error.cuh"

namespace {

constexpr int kThreads = 128;

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(kThreads)
cluster_shade_kernel(const float* __restrict__ ha, const float* __restrict__ fs,
                     const int* __restrict__ is, const float* __restrict__ fs2,
                     float* __restrict__ fs_out, int* __restrict__ is_out,
                     float* __restrict__ sh_out, float* __restrict__ hit_out,
                     float* __restrict__ surf_out, float* __restrict__ fs2_out,
                     rt::Tables tb, rt::Config cfg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::cl::shade_lane<HasTex, HasOmm, HasPrio, HasSplit>(i, n, ha, fs, is, fs2, fs_out,
                                                        is_out, sh_out, hit_out, surf_out,
                                                        fs2_out, tb, cfg);
}

// The instantiation of the switches (tex, omm, prio, split) from the
// runtime flags, one template parameter at a time.
template <bool... B, class... Args>
void launch(const bool* flags, int blocks, cudaStream_t stream, Args... args) {
  if constexpr (sizeof...(B) == 4) {
    cluster_shade_kernel<B...><<<blocks, kThreads, 0, stream>>>(args...);
  } else if (flags[sizeof...(B)]) {
    launch<B..., true>(flags, blocks, stream, args...);
  } else {
    launch<B..., false>(flags, blocks, stream, args...);
  }
}

}  // namespace

// `surf_out` ([SF_ROWS, n] or NULL) receives the exported surface in the
// external modes; `env` ([ET_SIZE] or NULL) is the environment table, which
// `final_env` needs; `tex` / `tex_meta` / `n_tex` / `tex_maps` the texture
// tables as K1 takes them (NULL for the untextured variant); `omm` selects
// the micromap variant, `prio` the nested-priority one; `fs2` and `fs2_out`
// ([NF2, n] each, or NULL) the split one.
extern "C" int rtxpt_cluster_shade(
    const float* ha, const float* fs, const int* is, float* fs_out, int* is_out,
    float* sh_out, float* hit_out, float* surf_out, const float* fs2, float* fs2_out,
    const float* mat_rows,
    const float* light_rows, const float* env, const float* tex, const int* tex_meta,
    int n_tex, int tex_maps, int omm, int prio, int n, int n_lights,
    unsigned int sample_idx, int nee_mode, int enable_mis, float firefly,
    int rr_enable, int min_rr, int low_discrepancy, int energy_comp, int maxb,
    int final_env, void* stream) {
  rt::Tables tb;
  tb.tri = nullptr;
  tb.attr = nullptr;
  tb.mat = mat_rows;
  tb.light = light_rows;
  tb.env = env;
  tb.tex = reinterpret_cast<const float4*>(tex);
  tb.tex_meta = tex_meta;
  tb.n_tex = n_tex;
  tb.tex_maps = tex_maps;
  tb.n_tris = 0;
  tb.tpad = 0;
  tb.n_lights = n_lights;
  tb.micro = nullptr;                // K3 decoded the cell: HA_UNK
  tb.cover = nullptr;
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
  cfg.final_env = final_env != 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  const bool flags[4] = {tex != nullptr, omm != 0, prio != 0, fs2 != nullptr};
  launch<>(flags, blocks, (cudaStream_t)stream, ha, fs, is, fs2, fs_out, is_out, sh_out,
           hit_out, surf_out, fs2_out, tb, cfg, n);
  return (int)cudaGetLastError();
}
