// The host side of K1's launch, shared by its two libraries:
// bounce_fused.cu (the sixteen reference-mode instantiations) and
// bounce_fused_restart.cu (the sixteen of the real-time fill), which nvcc
// builds side by side.
#pragma once

#include <cuda_runtime.h>

#include <mutex>
#include <utility>
#include <vector>

#include "bounce_fused_mma.cuh"

namespace rt {

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

// Raise `screen`'s limit of dynamic shared memory to the largest tile's
// (k1::kMaxTris triangles) once per kernel and device, not at every launch:
// the wrappers' host time is most of a small launch.
inline cudaError_t allow_largest_tile(const void* screen) {
  static std::mutex mu;
  static std::vector<std::pair<const void*, int>> raised;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(mu);
  for (const auto& r : raised)
    if (r.first == screen && r.second == dev) return cudaSuccess;
  e = cudaFuncSetAttribute(screen, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           k1::smem_bytes(k1::kMaxTris));
  if (e == cudaSuccess) raised.emplace_back(screen, dev);
  return e;
}

// Launch K1 on n rays: `screen` (the tensor-core form) in blocks of
// k1::kThreads, one batch of 32 rays a warp, with the tile's dynamic shared
// memory (t8 triangles); or, for a table of at most k1::kExactChunks
// chunks, `exact` (one thread per ray) in blocks of k1::kExactThreads. Both
// take the same arguments. Returns the CUDA error.
template <class Fn, class... Args>
int launch_k1(Fn* screen, Fn* exact, int n, int t8, cudaStream_t stream, Args... args) {
  if (t8 / 8 <= k1::kExactChunks) {
    exact<<<(n + k1::kExactThreads - 1) / k1::kExactThreads, k1::kExactThreads, 0, stream>>>(
        args...);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = allow_largest_tile(reinterpret_cast<const void*>(screen));
  if (e != cudaSuccess) return (int)e;
  const int smem = k1::smem_bytes(t8);
  screen<<<(n + k1::kThreads - 1) / k1::kThreads, k1::kThreads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// The instantiation of the switches (tex, omm, prio, split) from the
// runtime flags, one template parameter at a time:
// K<tex, omm, prio, split>::launch(n, t8, stream, args...).
template <template <bool, bool, bool, bool> class K, bool... B, class... Args>
int launch_switches(const bool* flags, int n, int t8, cudaStream_t stream, Args... args) {
  if constexpr (sizeof...(B) == 4) {
    return K<B...>::launch(n, t8, stream, args...);
  } else if (flags[sizeof...(B)]) {
    return launch_switches<K, B..., true>(flags, n, t8, stream, args...);
  } else {
    return launch_switches<K, B..., false>(flags, n, t8, stream, args...);
  }
}

namespace k1 {

// Read and zero the library's screen counters into `out` (NULL or SC_N
// host values) and set whether later launches count.
inline int screen_stats(int enable, unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && out != nullptr)
    e = cudaMemcpyFromSymbol(out, g_screen, sizeof(g_screen));
  const unsigned long long zero[SC_N] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen_on, &enable, sizeof(int));
  return (int)e;
}

}  // namespace k1

}  // namespace rt
