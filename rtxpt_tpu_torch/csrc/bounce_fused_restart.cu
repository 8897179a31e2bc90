// K1's real-time fill, written by hand for Hopper (sm_90a): the V-buffer
// restart and first_direct=False of the fused bounce kernel.
//
// Replaces rtxpt_tpu/pt/bounce_pallas.py::_bounce_kernel with inject=True
// (:1392, :1403; the body at :1427-1442: bounce 0 of a stable-planes fill
// takes each ray's hit, (t, prim, u, v, front), from five injected rows
// instead of tracing it, and fetches the winner's attributes) and
// first_direct=False (:1393; the gates at :981-986 and :1267-1268: the
// emission and environment gathered at logical bounce 1 and NEE at logical
// bounce 0 are left to the caller). Launched there by _bounce_call
// (bounce_pallas.py:1637; the rows packed at :1813-1822, passed at bounce
// 0 only, :1865). Plain version: rtxpt_tpu_torch/pt/bounce_fused.py
// bounce_reference with `inj` and `first_direct`; wrapper bounce_fused.bounce.
//
// Design. The per-ray body is K1's (bounce_fused.cuh bounce_ray) with its
// fifth template parameter, Restart, on: a non-null `inj` replaces the
// intersection loop by five coalesced loads per ray (20 B), and the
// winner's attribute column is read as after the loop. The TPU kernel's
// one-hot attribute matmul (_attrs_from_prim, :1375-1386) exists only for
// its matrix unit; here it is the same indexed load the loop's winner
// takes. `inj` is one pointer for the whole launch, so no warp diverges on
// it; it is null past bounce 0 of a first_direct=False fill, which then
// traces as K1 does. The restart is a kernel of its own, so the sixteen
// reference-mode instantiations of bounce_fused.cu keep their registers; it
// composes with every other switch, as in the JAX kernel (a stable-planes
// fill of a textured, alpha-tested or priority scene with STF, with or
// without the split channels), so all sixteen combinations are instantiated
// (the injected hits were alpha-resolved by the BUILD pass: the winner is
// never UNKNOWN). A separate library, so nvcc builds it beside
// bounce_fused.cu.
//
// What bounds it: with injection a launch reads 228 B of state per ray
// (the 208 B of K1's state and hit rows and the 20 B injected) and tests
// no closest-hit pair, only the shadow ray's; the shading chain and the
// shadow ray's loop over all triangles remain, so it is bound by
// instructions and latency as K1 is.
#include <cuda_runtime.h>

#include "bounce_fused_launch.cuh"
#include "rt_error.cuh"

namespace {

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(rt::kBounceThreads)
bounce_fused_restart_kernel(const float* __restrict__ fs, const int* __restrict__ is,
                            const float* __restrict__ fs2, float* __restrict__ fs_out,
                            int* __restrict__ is_out, float* __restrict__ hit_out,
                            float* __restrict__ surf_out, float* __restrict__ fs2_out,
                            const float* __restrict__ inj, rt::Tables tb, rt::Config cfg,
                            int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  rt::bounce_ray<HasTex, HasOmm, HasPrio, HasSplit, true>(
      i, n, fs, is, fs2, fs_out, is_out, hit_out, surf_out, fs2_out, inj, tb, cfg);
}

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
struct Kernel {
  template <class... Args>
  static void launch(int blocks, cudaStream_t stream, Args... args) {
    bounce_fused_restart_kernel<HasTex, HasOmm, HasPrio, HasSplit>
        <<<blocks, rt::kBounceThreads, 0, stream>>>(args...);
  }
};

}  // namespace

// rtxpt_bounce_fused's arguments (bounce_fused.cu), without final_env (the
// final environment round takes no restart), and `inj` ([5, n] or NULL:
// the injected V-buffer hits, t, prim, u, v, front) and `first_direct` (0:
// the first vertex's direct light left out).
extern "C" int rtxpt_bounce_fused_restart(
    const float* fs, const int* is, float* fs_out, int* is_out, float* hit_out,
    float* surf_out, const float* fs2, float* fs2_out, const float* tri_coef, const float* attr_rows, const float* mat_rows,
    const float* light_rows, const float* env, const float* tex, const int* tex_meta,
    int n_tex, int tex_maps, const int* micro, const float* cover, int n, int n_tris,
    int tpad, int n_lights,
    unsigned int sample_idx, int nee_mode, int enable_mis, float firefly,
    int rr_enable, int min_rr, float max_travel, int low_discrepancy,
    int energy_comp, int maxb, int prio, const float* inj, int first_direct, void* stream) {
  const rt::Tables tb = rt::bounce_tables(tri_coef, attr_rows, mat_rows, light_rows, env, tex,
                                          tex_meta, n_tex, tex_maps, micro, cover, n_tris, tpad,
                                          n_lights);
  const rt::Config cfg = rt::bounce_config(sample_idx, nee_mode, enable_mis, firefly, rr_enable,
                                           min_rr, max_travel, low_discrepancy, energy_comp,
                                           maxb, 0, first_direct);
  const bool flags[4] = {tex != nullptr, micro != nullptr, prio != 0, fs2 != nullptr};
  rt::launch_switches<Kernel>(flags, rt::bounce_blocks(n), (cudaStream_t)stream, fs, is, fs2,
                              fs_out, is_out, hit_out, surf_out, fs2_out, inj, tb, cfg, n);
  return (int)cudaGetLastError();
}
