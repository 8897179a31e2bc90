// K6 and K7, the per-row clustered kernels, written by hand for Hopper
// (sm_90a).
//
// K6 replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_a (closest hit and
// shading in one kernel; launched by _kernel_a_call, pl.pallas_call at
// bounce_clustered.py:1394) with its has_env, has_tex / tex_maps and
// final_env switches; K7 replaces ::_kernel_b (per-row shadow any-hit;
// _kernel_b_call, pl.pallas_call at :1431). The JAX package runs them when
// its _FLAT switch is off; the port when bounce_clustered.FLAT is False.
// Plain versions: rtxpt_tpu_torch/pt/bounce_clustered.py
// closest_shade_reference and occlusion_rows_reference; wrappers
// bounce_clustered.closest_shade and occlusion_rows.
//
// Design. One block of 128 threads per 128-lane row of a ray group (R = 8
// rows of a 1024-lane group), one thread per lane. The TPU kernel visits a
// group's candidate slot under a group gate (some active lane's committed t
// reaches the slot's hull entry) and then each row under its own gate (the
// row's entry bits te_r at most the worst committed t of its active lanes;
// +inf bits without the prune). A row block needs only its own gate: the
// cull's hull entry of a slot is at most each row's entry (the group beam
// contains the row beams), entries rise along the list and committed t
// only falls, so a row that passes its gate at slot i passed the group gate
// at every slot up to i, and a row whose worst committed t is below the
// slot's hull entry passes no later slot (the walk breaks there). Per slot
// two block votes (__syncthreads_or) take the row's gate; the first is also
// the barrier that frees the staging buffer. A visit stages the block's
// rows 0..20 (split-bf16 coefficients and the center, 43 KB) in shared
// memory (cluster.cuh stage_block, as K5 and K7; with the stats,
// thread 0 marks the (row, slot) pair in `visited`), and each thread tests
// the 128 triangles (cluster.cuh closest_in_block with Divide:
// t = t_num / |det| as in _kernel_a) on the per-row operand
// (make_operand_rows: o x d of the shifted origin, as _row_cols).
//
// After the walk each thread refits its winner exactly in f32 (cluster.cuh
// refit, as K3) and shades it in the same thread: K4's body
// (cluster_shade.cuh shade_hit), with the attribute fetch reading the
// winner's row of its cluster block. So the HA rows of the K3 + K4 pair
// never cross global memory. Why 128-thread blocks and not K3's 1024: the
// shading body takes 118-128 registers in K4; in a 1024-thread block a
// thread may hold 64, so the fused body would spill. With 128 threads the
// compiler may give the body up to 255.
//
// K7: the same row blocks. Lanes without a request start occluded; a row
// leaves the walk once all its lanes are occluded (the group leaves it
// once every row has), skips a slot whose entry bits are +inf, and each
// unoccluded lane tests the strict any-hit (cluster.cuh occluded_in_block)
// on the per-row operand up to dist * (1 - SHADOW_T_EPS).
//
// What bounds them: K6, the operations of the split-bf16 quantities and the
// selection per visited row and slot, as K3, then K4's shading; K7, K5's
// pairs. A row block stages a whole cluster block for 128 lanes where K3
// stages it for 1024, so its staging traffic (from L2) is 8 times K3's per
// lane; a slow kernel that is right comes first here (no cp.async double
// buffering, no tensor cores).
#include <cuda_runtime.h>

#include "cluster_shade.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

constexpr int RL = 128;                  // lanes of a row: one block
constexpr int kInfBits = 0x7F800000;     // +inf as int32 bits

template <bool HasTex>
__global__ void __launch_bounds__(RL)
closest_shade_kernel(const int* __restrict__ cand, const float* __restrict__ fs,
                     const int* __restrict__ is, float* __restrict__ fs_out,
                     int* __restrict__ is_out, float* __restrict__ sh_out,
                     float* __restrict__ hit_out, unsigned char* __restrict__ visited,
                     const float* __restrict__ blocks, Tables tb, Config cfg, int n,
                     int cand_w, int kslots, int noprune) {
  __shared__ __align__(16) float stage[STAGE_ROWS * LANES];
  const int row = blockIdx.x;            // row r of group g
  const int g = row / R, r = row % R;
  const int i = row * RL + threadIdx.x;
  const int* cg = cand + (size_t)g * cand_w;
  auto F = [&](int k) { return fs[(size_t)k * n + i]; };
  const V3 o = v3(F(FS_O), F(FS_O + 1), F(FS_O + 2));
  const V3 d = v3(F(FS_D), F(FS_D + 1), F(FS_D + 2));
  const bool act = is[(size_t)IS_ACTIVE * n + i] > 0;

  float best_t = kBigT;
  int best_c = 0, best_j = 0;
  const int count = cg[0];
  for (int s = 0; s < count; ++s) {
    const int te_r = cg[1 + 2 * kslots + R * s + r];
    if (noprune) {
      __syncthreads();                   // the staging buffer is free
      if (te_r >= kInfBits) continue;
    } else {
      const int bound = act ? __float_as_int(best_t) : 0;
      if (!__syncthreads_or(bound >= cg[1 + kslots + s])) break;
      if (!__syncthreads_or(bound >= te_r)) continue;
    }
    if (visited != nullptr && threadIdx.x == 0) visited[(size_t)row * kslots + s] = 1;
    const int cid = cg[1 + s];
    stage_block(stage, blocks, cid, threadIdx.x, RL);
    __syncthreads();
    float hi[10], lo[10];
    make_operand_rows(d, o, block_center(stage), hi, lo);
    float t_c;
    int j_c;
    bool unk_c;
    closest_in_block<true>(stage, hi, lo, cfg.max_travel, t_c, j_c, nullptr, unk_c);
    if (t_c < best_t) {
      best_t = t_c;
      best_c = cid;
      best_j = j_c;
    }
  }

  // the winner's rows (zero when the lane has none), refit, shading
  const bool had = best_t < kBigT;
  const float* wb = blocks + (size_t)best_c * BLK_FLOATS;
  auto crow = [&](int a) {
    return had ? wb[(ATTR_BASE + a / 4) * LANES + (a % 4) * CT + best_j] : 0.0f;
  };
  auto crow3 = [&](int a) { return v3(crow(a), crow(a + 1), crow(a + 2)); };
  const V3 cen = had ? block_center(wb) : v3(0.0f, 0.0f, 0.0f);
  const Refit rf = refit(o - cen, d, crow3(AT_V0), crow3(AT_E1), crow3(AT_E2),
                         cfg.max_travel);
  const bool hit = had && rf.ok && crow(AT_VALID) > 0.5f;
  Hit h;
  h.t = hit ? rf.t : kBigT;
  h.u = rf.u;
  h.v = rf.v;
  h.det = hit ? rf.det : -1.0f;
  h.prim = -1;                           // surface_and_shade reads it only via A
  h.unk = false;
  auto attr = [&](int k) { return crow(kAttrRows[k]); };
  shade_hit<HasTex, false, false, false>(i, n, load_state(i, n, fs, is), h,
                                         hit ? crow(AT_GIDX) : -1.0f, attr, fs_out, is_out,
                                         sh_out, hit_out, nullptr, tb, cfg);
}

__global__ void __launch_bounds__(RL)
shadow_rows_kernel(const int* __restrict__ cand, const float* __restrict__ sh,
                   const float* __restrict__ blocks, float* __restrict__ occ_out,
                   int* __restrict__ tests, int n, int cand_w, int kslots) {
  __shared__ __align__(16) float stage[STAGE_ROWS * LANES];
  const int row = blockIdx.x;
  const int g = row / R, r = row % R;
  const int i = row * RL + threadIdx.x;
  const int* cg = cand + (size_t)g * cand_w;
  auto SH = [&](int k) { return sh[(size_t)k * n + i]; };
  const V3 o = v3(SH(SH_O), SH(SH_O + 1), SH(SH_O + 2));
  const V3 d = v3(SH(SH_D), SH(SH_D + 1), SH(SH_D + 2));
  const float dist = SH(SH_DIST) * kShadowScale;
  bool occ = !(SH(SH_DO) > 0.5f);

  const int count = cg[0];
  int tested = 0;
  for (int s = 0; s < count; ++s) {
    if (!__syncthreads_or(!occ)) break;
    if (cg[1 + 2 * kslots + R * s + r] >= kInfBits) continue;
    stage_block(stage, blocks, cg[1 + s], threadIdx.x, RL);
    __syncthreads();
    if (!occ) {
      float hi[10], lo[10];
      make_operand_rows(d, o, block_center(stage), hi, lo);
      occ = occluded_in_block(stage, hi, lo, dist, tested, nullptr, nullptr, 0.0f);
    }
  }
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr && tested > 0) atomicAdd(tests + g, tested);
}

}  // namespace

// K6. `visited` (NULL or [n_groups * R, kslots] bytes, zeroed by the caller)
// receives a 1 for each slot a row visited; `env` ([ET_SIZE] or NULL) is the environment table, which
// `final_env` needs; `tex` / `tex_meta` / `n_tex` / `tex_maps` the texture
// tables as K4 takes them (NULL for the untextured variant).
extern "C" int rtxpt_cluster_rows_closest_shade(
    const int* cand, const float* fs, const int* is, float* fs_out, int* is_out,
    float* sh_out, float* hit_out, unsigned char* visited, const float* blocks,
    const float* mat_rows, const float* light_rows, const float* env, const float* tex,
    const int* tex_meta, int n_tex, int tex_maps, int n_groups, int kslots,
    float max_travel, int noprune, int n_lights, unsigned int sample_idx, int nee_mode,
    int enable_mis, float firefly, int rr_enable, int min_rr, int low_discrepancy,
    int energy_comp, int maxb, int final_env, void* stream) {
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
  tb.micro = nullptr;
  tb.cover = nullptr;
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
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  const int rows = n_groups * R;
  if (tex != nullptr)
    closest_shade_kernel<true><<<rows, RL, 0, (cudaStream_t)stream>>>(
        cand, fs, is, fs_out, is_out, sh_out, hit_out, visited, blocks, tb, cfg, n,
        cand_w, kslots, noprune);
  else
    closest_shade_kernel<false><<<rows, RL, 0, (cudaStream_t)stream>>>(
        cand, fs, is, fs_out, is_out, sh_out, hit_out, visited, blocks, tb, cfg, n,
        cand_w, kslots, noprune);
  return (int)cudaGetLastError();
}

// K7. `tests` (NULL or [n_groups] i32, zeroed by the caller) receives, per
// group, the ray-triangle pairs its lanes tested.
extern "C" int rtxpt_cluster_rows_shadow(const int* cand, const float* sh,
                                         const float* blocks, float* occ, int* tests,
                                         int n_groups, int kslots, void* stream) {
  const int n = n_groups * FL;
  const int cand_w = 1 + (2 + R) * kslots;
  shadow_rows_kernel<<<n_groups * R, RL, 0, (cudaStream_t)stream>>>(
      cand, sh, blocks, occ, tests, n, cand_w, kslots);
  return (int)cudaGetLastError();
}
