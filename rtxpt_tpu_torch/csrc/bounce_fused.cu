// K1, the fused bounce kernel, written by hand for Hopper (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_pallas.py::_bounce_kernel (launched there by
// _bounce_call, pl.pallas_call at bounce_pallas.py:1714) in the reference-mode
// configuration, with NEE in the kernel (nee slots 0-2) or exported for
// external NEE (slots 3-5: the SF_* surface rows go to `surf_out`), and the
// environment switches has_env (the table `env`: miss radiance with MIS,
// the environment light's importance sample) and final_env (the closing
// environment-only round), and the texture switch has_tex / tex_maps
// (bounce_pallas.py:1051-1125: base colour, metal-rough, emissive and normal
// maps by stochastic texture filtering), and the micromap switch omm
// (bounce_pallas.py:587-698 _micro_state, _intersect_group, _occluded_group;
// :1078-1160 the MIP-0 alpha test and the pass-through; :1350-1365 the
// pass-through lane's state), and the nested-priority switch prio
// (bounce_pallas.py:1138-1156: the false-hit rejection and the interior
// list's lower slot; the same pass-through), and the split-channel switch
// split_ch (bounce_pallas.py:1401-1422, :1501-1504, :1543-1545, :1568-1570:
// the fs2 rows in and out). Plain version:
// rtxpt_tpu_torch/pt/bounce_fused.py bounce_reference; wrapper:
// bounce_fused.bounce.
//
// Design. One thread per ray over a 1-D grid; the wavefront state is SoA
// ([rows, N] columns), so neighbouring threads read neighbouring addresses.
// The TPU kernel's matmul-factored intersection and one-hot gathers become
// per-thread loops and indexed loads: every thread walks all triangles'
// 20-float coefficient rows (tri_coef), which all threads of a warp read at
// the same address (one broadcast load per warp through the read-only
// cache; Cornell's 36 triangles are 2.9 KB), and only the winner's attribute
// column is read from global memory.
//
// What bounds it: instructions and latency, not bytes. Per ray and bounce it
// reads 92 B of state (15 f32 + 8 i32 rows) and writes 116 B (the state and
// 6 hit rows), but runs two loops over all triangles (closest hit and the shadow
// ray, ~40 flops per triangle) and a serial shading chain (hashes, Sobol'
// folds, BSDF eval/pdf/sample). This first version keeps it simple: no
// shared-memory staging, no ray compaction (inactive lanes still run the
// intersection loop, as on the TPU), and -fmad=false for parity with the
// plain version.
//
// The environment table (164 KB: 128 KB of float4 texels, 32 KB of
// conditional CDFs, four 64-entry rows) is read from global memory through
// __ldg, so it stays in L1 / L2; a miss reads one texel, a NEE sample two
// binary searches (6 + 7 probes) and one texel. Staging it in shared memory
// is later work.
//
// Textures: has_tex is a template parameter, so the untextured kernel keeps
// its registers. The textured one reads each map as ONE nearest texel of a
// jittered position and level (stochastic filtering): a float4 through
// __ldg from the flat atlas (10-16k texels, 160-260 KB, stay in L2), the
// level and offsets from the texture's 17-int meta row. No hardware texture
// unit: its linear filter weighs with 8-bit fractions and could not match
// the plain version, and one nearest texel needs no filter.
//
// Micromaps: has_omm is a second template parameter, so the three other
// instantiations keep their code. Per triangle the kernel reads one u32 word
// and one f32 coverage (8 B, beside the 80-byte coefficient row) instead of
// the TPU's 16-bit word halves, which exist for its matrix unit. The state
// is decoded only for a candidate that passes the geometric test (the
// closest hit) or occludes (the shadow ray): micro_index is ~15 f32
// operations and a shift. A pass-through lane does not branch away from
// its warp: it runs the shading chain as the plain version does, whose
// results it then discards.
//
// Priorities: has_prio is a third template parameter, so the four
// instantiations without it keep their code and registers. The false-hit
// test reads two more material lanes (MT_PRIO of the hit's and of the
// current medium, the medium's through L1 as the IoR lanes are) and rides
// the micromaps' pass-through: a false hit keeps its path state but for
// the interior list's lower slot, and continues the same ray.
//
// Split channels: HasSplit is a fourth template parameter, so the eight
// instantiations without it keep their code and registers. The split adds
// seven f32 rows in and seven out per ray (56 B beside the 208 B of state
// and hit rows), three floats of NEE diffuse part held across the shadow
// ray, and one more BSDF evaluation of the diffuse lobes (bsdf_eval_split)
// on the NEE sample: the ratio f_d / f that splits the clamped
// contribution at logical bounce 0 reads the same f as the contribution.
// All sixteen combinations are instantiated: the JAX kernel's split
// composes with every other switch.
#include <cuda_runtime.h>

#include "bounce_fused.cuh"
#include "rt_error.cuh"

namespace {

constexpr int kThreads = 128;

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(kThreads)
bounce_fused_kernel(const float* __restrict__ fs, const int* __restrict__ is,
                    const float* __restrict__ fs2, float* __restrict__ fs_out,
                    int* __restrict__ is_out, float* __restrict__ hit_out,
                    float* __restrict__ surf_out, float* __restrict__ fs2_out,
                    rt::Tables tb, rt::Config cfg, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::bounce_ray<HasTex, HasOmm, HasPrio, HasSplit>(i, n, fs, is, fs2, fs_out, is_out,
                                                    hit_out, surf_out, fs2_out, tb, cfg);
}

// The instantiation of the switches (tex, omm, prio, split) from the
// runtime flags, one template parameter at a time.
template <bool... B, class... Args>
void launch(const bool* flags, int blocks, cudaStream_t stream, Args... args) {
  if constexpr (sizeof...(B) == 4) {
    bounce_fused_kernel<B...><<<blocks, kThreads, 0, stream>>>(args...);
  } else if (flags[sizeof...(B)]) {
    launch<B..., true>(flags, blocks, stream, args...);
  } else {
    launch<B..., false>(flags, blocks, stream, args...);
  }
}

}  // namespace

// `surf_out` ([SF_ROWS, n] or NULL) receives the exported surface in the
// external modes; `env` ([ET_SIZE] or NULL) is the environment table, which
// `final_env` needs; `tex` ([texels, 4] or NULL for the untextured variant)
// and `tex_meta` ([n_tex, TX_COLS]) are the texture tables, `tex_maps` the
// maps' bits; `micro` and `cover` ([tpad] each, or NULL for the variant
// without micromaps) the micromap words and coverages; `prio` selects the
// nested-priority variant; `fs2` and `fs2_out` ([NF2, n] each, or NULL)
// select the split variant.
extern "C" int rtxpt_bounce_fused(
    const float* fs, const int* is, float* fs_out, int* is_out, float* hit_out,
    float* surf_out, const float* fs2, float* fs2_out, const float* tri_coef, const float* attr_rows, const float* mat_rows,
    const float* light_rows, const float* env, const float* tex, const int* tex_meta,
    int n_tex, int tex_maps, const int* micro, const float* cover, int n, int n_tris,
    int tpad, int n_lights,
    unsigned int sample_idx, int nee_mode, int enable_mis, float firefly,
    int rr_enable, int min_rr, float max_travel, int low_discrepancy,
    int energy_comp, int maxb, int final_env, int prio, void* stream) {
  rt::Tables tb;
  tb.tri = tri_coef;
  tb.attr = attr_rows;
  tb.mat = mat_rows;
  tb.light = light_rows;
  tb.env = env;
  tb.tex = reinterpret_cast<const float4*>(tex);
  tb.tex_meta = tex_meta;
  tb.n_tex = n_tex;
  tb.tex_maps = tex_maps;
  tb.n_tris = n_tris;
  tb.tpad = tpad;
  tb.n_lights = n_lights;
  tb.micro = micro;
  tb.cover = cover;
  rt::Config cfg;
  cfg.sample_idx = sample_idx;
  cfg.nee_mode = nee_mode;
  cfg.enable_mis = enable_mis != 0;
  cfg.firefly = firefly;
  cfg.rr_enable = rr_enable != 0;
  cfg.min_rr = min_rr;
  cfg.max_travel = max_travel;
  cfg.low_discrepancy = low_discrepancy != 0;
  cfg.energy_comp = energy_comp != 0;
  cfg.maxb = maxb;
  cfg.final_env = final_env != 0;
  int blocks = (n + kThreads - 1) / kThreads;
  const bool flags[4] = {tex != nullptr, micro != nullptr, prio != 0, fs2 != nullptr};
  launch<>(flags, blocks, (cudaStream_t)stream, fs, is, fs2, fs_out, is_out, hit_out,
           surf_out, fs2_out, tb, cfg, n);
  return (int)cudaGetLastError();
}
