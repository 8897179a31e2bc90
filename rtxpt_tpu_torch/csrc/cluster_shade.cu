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
// Design. One thread per lane, as K1 (bounce_fused.cu): the per-thread body
// (cluster_shade.cuh shade_staged) is K1's surface_and_shade
// (bounce_fused.cuh), with the attribute fetch reading K3's HA rows instead
// of the triangle table. It writes the next wavefront state, the NEE shadow
// request (SH rows, resolved by K5) and the hit rows. Every row is SoA
// [rows, N], so neighbouring threads touch neighbouring addresses.
//
// The inputs are staged. One block of kStageLanes (128) threads takes a
// tile of 128 lanes: warp 0 copies each of the tile's input row segments
// (512 bytes; cluster_shade.cuh StagePlan: the HA rows the variant reads,
// the 15 + 8 state rows, the 7 split rows, 23-32 KB) with cp.async.bulk
// into dynamic shared memory, completing on one mbarrier; the block waits
// once and shades from shared memory. All the tile's input rows are in
// flight at once, where before each HA row was a dependent load issued
// where the serial shading chain first needed it, and the SM's other
// blocks shade while one block's copies land. Persistent blocks with two
// stages (the next tile's copy in flight while this one shades) were
// slower on the card at every grid tried, 1.4x on the city's plain variant
// at 4 blocks an SM: the second stage doubles a block's shared memory, so
// fewer warps run (tools/k1_bench.py --kernel k4 --sweep at commit
// 7518973; PERF.md). The bulk copies need 16-byte aligned rows: n a
// multiple of 4 and the input arrays 16-byte aligned (the wrapper checks;
// the path's launches are whole groups of 1024 lanes). The stores stay direct: with the plain
// variant's 44 output rows written to shared memory instead the kernel was
// 3% faster, the most that staging them could give. Nor is the register
// count bounded: compiled for 5 blocks an SM (at most 102 registers) the
// variants ran from 8% faster to 10% slower by variant and mode.
//
// What bounds it: bytes, and latency in the serial shading chain (hashes,
// Sobol' folds, light sample, BSDF eval, pdf and sample), as in K1.
// Per lane the plain variant reads the 21 HA rows it copies + 15 + 8 state
// rows (176 B) and writes 15 + 8 + 15 + 6 rows (176 B): 352 B, 0.22 ms at
// 3.35 TB/s for a 2^21-lane 1080p wavefront (chip_smoke.py _k4_bytes counts
// the rows a launch copies, bounce_clustered.shade_ha_read); the texture
// variant reads 11 HA rows more, the micromap one 1; the export reads
// AT_LID and writes 24 rows (100 B); the final round reads the 5 hit rows
// and the state (288 B). The environment table's 164 KB count once per
// launch and stay in L1 / L2, and so does the texture atlas (a float4 per
// fetch through __ldg, up to four fetches per lane). The split variant
// reads and writes the seven fs2 rows: 56 B more per lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_shade.cuh"
#include "rt_error.cuh"

namespace {

using rt::cl::kStageLanes;
using rt::cl::StagePlan;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

struct Rows {
  const float* ha;
  const float* fs;
  const int* is;
  const float* fs2;
};

template <class P>
__device__ __forceinline__ const float* row_src(const Rows& in, int k, int n) {
  const int a = P::array_of(k);
  const size_t off = (size_t)P::row_of(k) * n;
  return a == 0 ? in.ha + off
       : a == 1 ? in.fs + off
       : a == 2 ? reinterpret_cast<const float*>(in.is) + off : in.fs2 + off;
}

// Warp 0: the copies of tile `tile`'s rows into the stage `st`, completing
// on `bar` (lane 0 announces the bytes first).
template <class P>
__device__ __forceinline__ void issue(const Rows& in, float* st, uint64_t* bar, int tile, int n,
                                      bool final_env, bool exports) {
  const int lane = threadIdx.x;
  const int lanes = min(kStageLanes, n - tile * kStageLanes);
  const uint32_t seg = (uint32_t)lanes * 4u;
  if (lane == 0) {
    int rows = 0;
    for (int k = 0; k < P::kSlots; ++k) rows += P::copies(k, final_env, exports) ? 1 : 0;
    bar_expect(bar, seg * rows);
  }
  __syncwarp();
  for (int k = lane; k < P::kSlots; k += 32)
    if (P::copies(k, final_env, exports))
      bulk_copy(st + k * kStageLanes, row_src<P>(in, k, n) + (size_t)tile * kStageLanes, seg,
                bar);
}

template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
__global__ void __launch_bounds__(kStageLanes)
cluster_shade_kernel(Rows in, float* __restrict__ fs_out, int* __restrict__ is_out,
                     float* __restrict__ sh_out, float* __restrict__ hit_out,
                     float* __restrict__ surf_out, float* __restrict__ fs2_out,
                     rt::Tables tb, rt::Config cfg, int n) {
  using P = StagePlan<HasTex, HasOmm, HasSplit>;
  extern __shared__ __align__(128) float stage[];   // P::kSlots x kStageLanes
  __shared__ __align__(8) uint64_t bar;
  const int tile = blockIdx.x;
  const bool exports = surf_out != nullptr;
  if (threadIdx.x == 0) {
    bar_init(&bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 32) issue<P>(in, stage, &bar, tile, n, cfg.final_env, exports);
  bar_wait(&bar, 0u);
  const int i = tile * kStageLanes + threadIdx.x;
  if (i < n)
    rt::cl::shade_staged<HasTex, HasOmm, HasPrio, HasSplit>(
        i, n, threadIdx.x, stage, fs_out, is_out, sh_out, hit_out, surf_out, fs2_out, tb, cfg);
}

// One kernel's launch: one block a tile, the stage in dynamic shared memory
// (at most 32 KB, under the 48 KB a launch takes without raising its limit).
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit>
struct Launch {
  static int run(int n, cudaStream_t stream, Rows in, float* fs_out, int* is_out,
                 float* sh_out, float* hit_out, float* surf_out, float* fs2_out,
                 const rt::Tables& tb, const rt::Config& cfg) {
    using P = StagePlan<HasTex, HasOmm, HasSplit>;
    auto* kern = &cluster_shade_kernel<HasTex, HasOmm, HasPrio, HasSplit>;
    static_assert(P::kBytes <= 48 * 1024, "K4's stage: the default dynamic limit");
    const int tiles = (n + kStageLanes - 1) / kStageLanes;
    kern<<<tiles, kStageLanes, P::kBytes, stream>>>(in, fs_out, is_out, sh_out, hit_out,
                                                    surf_out, fs2_out, tb, cfg, n);
    return (int)cudaGetLastError();
  }
};

// The instantiation of the switches (tex, omm, prio, split) from the
// runtime flags, one template parameter at a time.
template <bool... B, class... Args>
int launch(const bool* flags, Args... args) {
  if constexpr (sizeof...(B) == 4) {
    return Launch<B...>::run(args...);
  } else if (flags[sizeof...(B)]) {
    return launch<B..., true>(flags, args...);
  } else {
    return launch<B..., false>(flags, args...);
  }
}

int shade(const float* ha, const float* fs, const int* is, float* fs_out, int* is_out,
          float* sh_out, float* hit_out, float* surf_out, const float* fs2, float* fs2_out,
          const float* mat_rows, const float* light_rows, const float* env, const float* tex,
          const int* tex_meta, int n_tex, int tex_maps, int omm, int prio, int n, int n_lights,
          unsigned int sample_idx, int nee_mode, int enable_mis, float firefly, int rr_enable,
          int min_rr, int low_discrepancy, int energy_comp, int maxb, int final_env,
          void* stream) {
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
  if (n <= 0) return 0;
  const Rows in = {ha, fs, is, fs2};
  const bool flags[4] = {tex != nullptr, omm != 0, prio != 0, fs2 != nullptr};
  return launch<>(flags, n, (cudaStream_t)stream, in, fs_out, is_out, sh_out, hit_out,
                  surf_out, fs2_out, tb, cfg);
}

}  // namespace

// n must be a multiple of 4 and ha, fs, is and fs2 16-byte aligned (the
// wrapper checks). `surf_out` ([SF_ROWS, n] or NULL) receives the exported surface in the
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
  return shade(ha, fs, is, fs_out, is_out, sh_out, hit_out, surf_out, fs2, fs2_out, mat_rows,
               light_rows, env, tex, tex_meta, n_tex, tex_maps, omm, prio, n, n_lights,
               sample_idx, nee_mode, enable_mis, firefly, rr_enable, min_rr, low_discrepancy,
               energy_comp, maxb, final_env, stream);
}
