// The host side of K1's launch, shared by its two libraries:
// bounce_fused.cu (the sixteen reference-mode instantiations) and
// bounce_fused_restart.cu (the sixteen of the real-time fill), which nvcc
// builds side by side.
#pragma once

#include <cuda_runtime.h>

#include "bounce_fused.cuh"

namespace rt {

constexpr int kBounceThreads = 128;

inline int bounce_blocks(int n) { return (n + kBounceThreads - 1) / kBounceThreads; }

inline Tables bounce_tables(const float* tri_coef, const float* attr_rows, const float* mat_rows,
                            const float* light_rows, const float* env, const float* tex,
                            const int* tex_meta, int n_tex, int tex_maps, const int* micro,
                            const float* cover, int n_tris, int tpad, int n_lights) {
  Tables tb;
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
  return tb;
}

inline Config bounce_config(unsigned int sample_idx, int nee_mode, int enable_mis, float firefly,
                            int rr_enable, int min_rr, float max_travel, int low_discrepancy,
                            int energy_comp, int maxb, int final_env, int first_direct) {
  Config cfg;
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
  cfg.first_direct = first_direct != 0;
  return cfg;
}

// The instantiation of the switches (tex, omm, prio, split) from the
// runtime flags, one template parameter at a time:
// K<tex, omm, prio, split>::launch(blocks, stream, args...).
template <template <bool, bool, bool, bool> class K, bool... B, class... Args>
void launch_switches(const bool* flags, int blocks, cudaStream_t stream, Args... args) {
  if constexpr (sizeof...(B) == 4) {
    K<B...>::launch(blocks, stream, args...);
  } else if (flags[sizeof...(B)]) {
    launch_switches<K, B..., true>(flags, blocks, stream, args...);
  } else {
    launch_switches<K, B..., false>(flags, blocks, stream, args...);
  }
}

}  // namespace rt
