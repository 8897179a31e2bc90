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
// the fs2 rows in and out); its inject and first_direct switches are
// bounce_fused_restart.cu's. Plain version:
// rtxpt_tpu_torch/pt/bounce_fused.py bounce_reference; wrapper:
// bounce_fused.bounce.
//
// Design. The wavefront state is SoA ([rows, N] columns), so neighbouring
// lanes read neighbouring addresses. The TPU kernel's matmul-factored
// intersection (bounce_pallas.py:567, HIGHEST precision) becomes a matrix
// product on the tensor cores again, as a screen: one block of 512 threads
// per SM stages the scene's bf16 coefficient tile (det, u and v of every
// triangle, bounce_fused.coefficient_tile) in shared memory once, and each
// warp takes 32 rays at a time through split-bf16 mma.sync products and a
// screen with a derived error margin; the few pairs that pass are resolved
// by the plain f32 test in triangle order, for the closest hit and again
// for the NEE shadow ray (bounce_fused_mma.cuh has the form, the bound and
// the layout). The TPU kernel's one-hot gathers become indexed loads: only
// the winner's attribute column is read from global memory. -fmad=false
// keeps every f32 operation of the shading and of the resolve rounded as
// the plain version rounds it. Tables of at most 16 triangles take a
// second kernel of each switch set, bounce_fused_kernel_exact: the
// CUDA-core form (one thread per ray walking every triangle with the
// exact test, bounce_fused.cuh bounce_ray), which is faster there.
//
// What bounds it: instructions and latency, not bytes. Per ray and bounce it
// reads 92 B of state (15 f32 + 8 i32 rows) and writes 116 B (the state and
// 6 hit rows). Its CUDA-core predecessor ran every pair of ray and triangle
// through the exact test (~60 issued instructions a pair, twice with the
// shadow ray): on the rooms' 552 and the kitchen's 1,186 triangles that loop
// was most of a launch. Here a pair costs a share of 5 mma.sync per 8
// triangles and 16 rays and ~20 f32 operations of screen, and the exact test
// runs on the pairs that pass (a line through the scene crosses a few dozen
// triangles); what remains is the serial shading chain (hashes, Sobol'
// folds, BSDF eval/pdf/sample) and its loads.
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
//
// The real-time fill (the V-buffer restart and first_direct=False) is a
// fifth switch, Restart, in a kernel of its own (bounce_fused_restart_kernel,
// the `inj` pointer its last parameter): as a runtime branch in every
// instantiation it moved the registers of eleven of the sixteen (116-128
// against 115-128, and a 4-byte spill in omm_prio_split; ptxas for sm_90a),
// so the sixteen reference-mode kernels keep their code
// and the restart gets sixteen of its own: the JAX kernel's inject and
// first_direct compose with every other switch (a stable-planes fill of a
// textured, alpha-tested or priority scene with STF, with or without the
// split channels), so every combination is reachable. In a restart launch
// a non-null `inj` replaces the closest hit by five coalesced loads
// per ray (t, prim, u, v, front; 20 B), and the winner's attribute column is
// read as after the loop; `inj` is one pointer for the launch, so no warp
// diverges on it (a null `inj` is a later bounce of a first_direct=False
// fill). With injection a launch reads 228 B of state per ray and writes
// 116 B; it tests no closest-hit pair, only the shadow ray's.
#include <cuda_runtime.h>

#include "bounce_fused_launch.cuh"
#include "rt_error.cuh"

namespace {

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(rt::k1::kThreads, 1)
bounce_fused_kernel(const float* __restrict__ fs, const int* __restrict__ is,
                    const float* __restrict__ fs2, float* __restrict__ fs_out,
                    int* __restrict__ is_out, float* __restrict__ hit_out,
                    float* __restrict__ surf_out, float* __restrict__ fs2_out,
                    const __nv_bfloat16* __restrict__ tile, const float* __restrict__ scale,
                    int t8, rt::Tables tb, rt::Config cfg, int n) {
  rt::k1::bounce_block<HasTex, HasOmm, HasPrio, HasSplit, false>(
      fs, is, fs2, fs_out, is_out, hit_out, surf_out, fs2_out, nullptr, tile, scale, t8, tb,
      cfg, n);
}

// The CUDA-core form for tables of at most 16 triangles (bounce_fused_mma.cuh
// kExactChunks): one thread per ray, the exact loops; the same arguments.
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(rt::k1::kExactThreads)
bounce_fused_kernel_exact(const float* __restrict__ fs, const int* __restrict__ is,
                          const float* __restrict__ fs2, float* __restrict__ fs_out,
                          int* __restrict__ is_out, float* __restrict__ hit_out,
                          float* __restrict__ surf_out, float* __restrict__ fs2_out,
                          const __nv_bfloat16* __restrict__, const float* __restrict__, int,
                          rt::Tables tb, rt::Config cfg, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::bounce_ray<HasTex, HasOmm, HasPrio, HasSplit, false>(
      i, n, fs, is, fs2, fs_out, is_out, hit_out, surf_out, fs2_out, nullptr, tb, cfg);
}

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
struct Kernel {
  template <class... Args>
  static int launch(int n, int t8, cudaStream_t stream, Args... args) {
    return rt::launch_k1(bounce_fused_kernel<HasTex, HasOmm, HasPrio, HasSplit>,
                         bounce_fused_kernel_exact<HasTex, HasOmm, HasPrio, HasSplit>, n, t8,
                         stream, args...);
  }
};

}  // namespace

// `surf_out` ([SF_ROWS, n] or NULL) receives the exported surface in the
// external modes; `env` ([ET_SIZE] or NULL) is the environment table, which
// `final_env` needs; `tex` ([texels, 4] or NULL for the untextured variant)
// and `tex_meta` ([n_tex, TX_COLS]) are the texture tables, `tex_maps` the
// maps' bits; `micro` and `cover` ([tpad] each, or NULL for the variant
// without micromaps) the micromap words and coverages; `tile` ([30, t8]
// bf16) and `scale` ([t8] f32), both 16-byte aligned, the screen's
// coefficient tile (t8: the triangle count rounded up to 8); `prio` selects
// the nested-priority variant; `fs2` and `fs2_out` ([NF2, n] each, or NULL)
// select the split variant.
extern "C" int rtxpt_bounce_fused(
    const float* fs, const int* is, float* fs_out, int* is_out, float* hit_out,
    float* surf_out, const float* fs2, float* fs2_out, const float* tri_coef, const float* attr_rows, const float* mat_rows,
    const float* light_rows, const float* env, const float* tex, const int* tex_meta,
    int n_tex, int tex_maps, const int* micro, const float* cover, const void* tile,
    const float* scale, int t8, int n, int n_tris, int tpad, int n_lights,
    unsigned int sample_idx, int nee_mode, int enable_mis, float firefly,
    int rr_enable, int min_rr, float max_travel, int low_discrepancy,
    int energy_comp, int maxb, int final_env, int prio, void* stream) {
  const rt::Tables tb = rt::bounce_tables(tri_coef, attr_rows, mat_rows, light_rows, env, tex,
                                          tex_meta, n_tex, tex_maps, micro, cover, n_tris, tpad,
                                          n_lights);
  const rt::Config cfg = rt::bounce_config(sample_idx, nee_mode, enable_mis, firefly, rr_enable,
                                           min_rr, max_travel, low_discrepancy, energy_comp,
                                           maxb, final_env, 1);
  const bool flags[4] = {tex != nullptr, micro != nullptr, prio != 0, fs2 != nullptr};
  return rt::launch_switches<Kernel>(flags, n, t8, (cudaStream_t)stream, fs, is, fs2, fs_out,
                                     is_out, hit_out, surf_out, fs2_out,
                                     static_cast<const __nv_bfloat16*>(tile), scale, t8, tb,
                                     cfg, n);
}

// K1's screen counters (bounce_fused_mma.cuh): `out` (NULL or 6 host
// values) receives the counts since the last call, which zeroes them;
// `enable` sets whether later launches count. Synchronous.
extern "C" int rtxpt_bounce_fused_screen_stats(int enable, unsigned long long* out) {
  return rt::k1::screen_stats(enable, out);
}
