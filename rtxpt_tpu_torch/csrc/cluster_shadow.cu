// K5, the clustered shadow any-hit kernel, written by hand for Hopper
// (sm_90a), flat, with opacity micromaps, and instanced: the split-bf16
// products on the tensor cores (mma.sync, bf16 in, f32 accumulate), K3's
// screen fused after them in registers, and the screened candidates
// resolved in exact f32 in triangle order.
//
// Replaces rtxpt_tpu/pt/bounce_clustered.py::_kernel_b1 and _kernel_b1_inst
// (bounce_clustered.py:394 and :405, body _kernel_b1_body, launched by
// _kernel_b1_call, pl.pallas_call at bounce_clustered.py:1235), and
// _kernel_b1's micromap variant (omm=True, :443-454). _kernel_b1_inst with
// omm is unreachable in the JAX package (alpha-tested scenes are never
// instanced, accel/tlas.py:183-184), so it is not ported. Plain version:
// rtxpt_tpu_torch/pt/bounce_clustered.py occlusion_reference; wrapper:
// bounce_clustered.occlusion.
//
// What bounds it: operations. Each unoccluded lane tests each triangle of a
// slot up to its first occluder: the four split-bf16 quantities (57
// multiplies and 53 adds) and the 14-operation strict test per pair. On
// alpha-tested geometry the first occluder is rarely early (TRANSPARENT
// cells do not occlude), so a lane walks all 128 triangles of most slots.
// Here det, u and v of all 128 triangles are one small matrix product per
// visit on the tensor cores (cluster_mma.cuh, K3's form), and the f32 work
// per pair is K3's ~10-operation screen on them.
//
// Exactness. The screen passes a pair inside the edge margins widened to
// 4 x 2e-3 of |det|, whatever t; the strict test (no margins) lies inside
// it, so every occluder of the plain version passes (its sums differ from
// these by a few f32 ulps of the terms). Each passing pair is recomputed
// with the plain version's f32 sums (cluster.cuh quantities, on the staged
// f32 rows and the operand read back exactly from its A row) and goes
// through the plain test (cluster.cuh occludes, micromaps included), in
// increasing triangle order; the least occluding triangle j of the lane's
// four threads is the plain version's first occluder. The lane is then
// occluded and counts j + 1 tested pairs, or 128 when none occludes, as
// the plain version: occ and the per-group test counts are bit-exact.
//
// Design. K3's (cluster_closest.cu): one block of 1024 threads per
// 1024-lane group of sorted shadow rays, one thread per lane for the
// operand and the walk's state; each warp's 32 rays are two 16-row tiles of
// the product. Lanes without a request start occluded. Before each slot a
// block-wide vote (__syncthreads_or) ends the walk once every lane is
// occluded. A visit:
//   1. prefetches the next slot's rows 0..19, its center (and micromap
//      words and coverages, or the instance's M10) into the other half of
//      an f32 ring in shared memory with cp.async;
//   2. waits for this slot's copy and converts the rows det, u and v read
//      to the bf16 tile with K3's virtual stacked B rows;
//   3. a warp with an unoccluded lane writes its A rows: each unoccluded
//      lane its cluster-local operand (make_operand's f32 arithmetic, after
//      xform_operand on instanced tables) split into r_hi, l1, l2; each
//      occluded lane a zero row, which no screen passes;
//   4. per 16-ray tile: A fragments by ldmatrix; per chunk of 8 triangles
//      B fragments by ldmatrix.trans and 5 mma.sync into 12 accumulators;
//      the screen appends a passing triangle to the thread's list for that
//      ray (K3's list: 8 entries, past 8 the thread takes all 32 of its
//      triangles); then the exact pass over each list up to the thread's
//      first occluder, and a quad minimum gives the ray's.
// A warp whose 32 lanes are all occluded skips steps 3-4 (its lanes test
// nothing, as in the plain version) but reaches every block barrier.
// Shared memory per block: A 98,304 B, the bf16 B tile 13,520 B, the ring
// 2 x 42,416 B, the lists 16,384 B: 213,040 B (one block per SM; 1024
// threads cap the registers at 64).
//
// The instanced variant (_kernel_b1_inst): the candidate rows carry pool
// block ids and each slot's instance id (from 1 + (2 + R) * kslots on); the
// ring also carries the instance's M10, and each unoccluded lane maps its
// world operand into the instance's object frame before the split. The
// distance stays the world one.
//
// Micromaps: the ring also carries the cluster's 128 words and coverages
// (1 KB of the side table); the exact pass decodes a candidate's micro-cell
// only after the strict geometric test (cluster.cuh occludes).
//
// Screen counts: with rtxpt_cluster_shadow_screen_stats(1, ...) each block
// adds, at its end, the pairs its unoccluded lanes screened (128 per lane
// and visit), the pairs that passed the screen and the lists that
// overflowed to three counters in device memory; the call reads and zeroes
// them. Off by default: a launch then costs one uniform branch per tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster.cuh"
#include "cluster_mma.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;
using namespace rt::cl;

using RG = Ring<true>;                   // the ring carries coverages
constexpr int LIST_BASE = A_BYTES + B_BYTES + 2 * RG::FLOATS * 4;
constexpr int SMEM_BYTES = LIST_BASE + LIST_BYTES;
static_assert(SMEM_BYTES <= 232448, "shared memory of one block");

__device__ int g_screen_on;                     // count the screen (0 / 1)
__device__ unsigned long long g_screen[3];      // pairs, passed, overflowed

template <bool INST, bool OMM>
__global__ void __launch_bounds__(FL, 1)
cluster_shadow_kernel(const int* __restrict__ cand, const float* __restrict__ sh,
                      const float* __restrict__ blocks, const float* __restrict__ xf,
                      const int* __restrict__ micro, const float* __restrict__ cover,
                      float* __restrict__ occ_out, int* __restrict__ tests, int n,
                      int cand_w, int kslots) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* const at = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* const bt = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);
  float* const ring = reinterpret_cast<float*>(smem + A_BYTES + B_BYTES);
  __shared__ unsigned int counts[3];
  const int l = threadIdx.x;
  const int lane = l & 31, warp = l >> 5;
  const int g = lane >> 2, q = lane & 3;
  const size_t i = (size_t)blockIdx.x * FL + l;
  const int* cg = cand + (size_t)blockIdx.x * cand_w;
  const int* cinst = cg + 1 + (2 + R) * kslots;
  auto SH = [&](int r) { return sh[(size_t)r * n + i]; };
  const V3 o = v3(SH(SH_O), SH(SH_O + 1), SH(SH_O + 2));
  const V3 d = v3(SH(SH_D), SH(SH_D + 1), SH(SH_D + 2));
  const V3 oxd = cross3(o, d);
  const float dist = SH(SH_DIST) * kShadowScale;
  const float u_alpha = OMM ? SH(SH_UA) : 0.0f;
  bool occ = !(SH(SH_DO) > 0.5f);
  const bool count_on = g_screen_on != 0;

  // This lane's row of the warp's A tile and the ldmatrix row addresses,
  // as K3's
  const int wrow = warp * 32 + (q >> 1) * 16 + g + 8 * (q & 1);
  uint4* const arow = reinterpret_cast<uint4*>(at + (size_t)wrow * KQ);
  const Frag fr = frag_addrs(at, bt, warp, lane);
  uint8_t* const list = smem + LIST_BASE + l * 2 * LIST;
  if (l < LANES / 8)
    reinterpret_cast<uint4*>(bt + ZERO_ROW * B_STRIDE)[l] = make_uint4(0, 0, 0, 0);
  if (l < 3) counts[l] = 0;

  const int count = cg[0];
  int tested = 0;
  if (count > 0)
    stage_async<INST, OMM, true>(ring, blocks, micro, cover, xf, cg[1],
                                 INST ? cinst[0] : 0, l);
  cp_async_commit();
  for (int s = 0; s < count; ++s) {
    // every thread is past the previous visit: its ring slot, the B tile
    // and the A tiles are free
    if (!__syncthreads_or(!occ)) break;
    const float* cur = ring + (s & 1) * RG::FLOATS;
    if (s + 1 < count)
      stage_async<INST, OMM, true>(ring + ((s + 1) & 1) * RG::FLOATS, blocks, micro,
                                   cover, xf, cg[2 + s], INST ? cinst[s + 1] : 0, l);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    convert_tile(bt, cur, l);
    const bool warp_live = __any_sync(0xffffffffu, !occ);
    if (warp_live) {
      if (!occ) {
        const V3 c = v3(cur[RG::CEN], cur[RG::CEN + 1], cur[RG::CEN + 2]);
        V3 dv = d, oxdv = oxd, ov = o;
        if constexpr (INST) xform_operand(cur + RG::XM, d, oxd, o, dv, oxdv, ov);
        float hi[10], lo[10];
        make_operand(dv, oxdv, ov, c, hi, lo);
        write_a_row(arow, hi, lo);
      } else {
#pragma unroll
        for (int k = 0; k < 6; ++k) arow[k] = make_uint4(0, 0, 0, 0);
      }
    }
    __syncthreads();  // the B tile is complete; the A rows are written
    if (!warp_live) continue;

    const int* words = OMM ? reinterpret_cast<const int*>(cur + RG::MW) : nullptr;
    const float* cov = OMM ? cur + RG::CV : nullptr;
    int first = CT;  // the slot's first occluder of this lane's ray
#pragma unroll 1
    for (int mt = 0; mt < 2; ++mt) {
      int cnt[2];
      screen_tile(fr.a, fr.det, fr.u, mt, q, list, cnt);
      if (count_on) {
        const unsigned int pass = __reduce_add_sync(0xffffffffu, cnt[0] + cnt[1]);
        const unsigned int over =
            __reduce_add_sync(0xffffffffu, (cnt[0] > LIST) + (cnt[1] > LIST));
        if (lane == 0) {
          atomicAdd(&counts[1], pass);
          atomicAdd(&counts[2], over);
        }
      }
      // each listed candidate in exact f32 (the plain version's sums and
      // test), in increasing triangle order up to the thread's first
      // occluder; a list that overflowed takes all 32 of the thread's
      // triangles. The ray is lane 4g + 2mt + r of the warp.
      int ray_j[2] = {CT, CT};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int src = 4 * g + 2 * mt + r;
        const float rdist = __shfl_sync(0xffffffffu, dist, src);
        const float rua = OMM ? __shfl_sync(0xffffffffu, u_alpha, src) : 0.0f;
        if (cnt[r] == 0) continue;
        float hi[10], lo[10];
        operand_of_row(at + (size_t)(warp * 32 + mt * 16 + g + 8 * r) * KQ, hi, lo);
        const int n_c = listed_count(cnt[r]);
#pragma unroll 1
        for (int c = 0; c < n_c; ++c) {
          const int j = listed(list + r * LIST, cnt[r], c, q);
          if (occludes(quantities(cur, j, hi, lo), j, rdist, words, cov, rua)) {
            ray_j[r] = j;
            break;
          }
        }
      }
      // the quad's least occluder per ray; the ray's own thread
      // (lane 4g + 2mt + r) keeps it
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        int jv = ray_j[r];
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) jv = min(jv, __shfl_xor_sync(0xffffffffu, jv, m));
        if (q == 2 * mt + r) first = jv;
      }
    }
    if (count_on) {
      const unsigned int live = __popc(__ballot_sync(0xffffffffu, !occ));
      if (lane == 0) atomicAdd(&counts[0], CT * live);
    }
    if (!occ) {
      tested += first < CT ? first + 1 : CT;
      occ = first < CT;
    }
  }
  cp_async_wait<0>();
  occ_out[i] = occ ? 1.0f : 0.0f;
  if (tests != nullptr && tested > 0) atomicAdd(tests + blockIdx.x, tested);
  if (count_on) {
    __syncthreads();
    if (l < 3) atomicAdd(&g_screen[l], (unsigned long long)counts[l]);
  }
}

template <bool INST, bool OMM>
int launch(const int* cand, const float* sh, const float* blocks, const float* xf,
           const int* micro, const float* cover, float* occ, int* tests, int n_groups,
           int cand_w, int kslots, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      cluster_shadow_kernel<INST, OMM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (e != cudaSuccess) return (int)e;
  cluster_shadow_kernel<INST, OMM><<<n_groups, FL, SMEM_BYTES, stream>>>(
      cand, sh, blocks, xf, micro, cover, occ, tests, n_groups * FL, cand_w, kslots);
  return (int)cudaGetLastError();
}

}  // namespace

// `tests` (NULL or [n_groups] i32, zeroed by the caller) receives, per group,
// the ray-triangle pairs its lanes tested; `micro` and `cover` (NULL, or the
// [C, CT] micromap words and coverages) select the omm variant. `blocks`,
// `micro` and `cover` must be 16-byte aligned (the wrapper checks).
extern "C" int rtxpt_cluster_shadow(const int* cand, const float* sh,
                                    const float* blocks, const int* micro,
                                    const float* cover, float* occ, int* tests,
                                    int n_groups, int kslots, void* stream) {
  const int cand_w = 1 + (2 + R) * kslots;
  if (micro != nullptr)
    return launch<false, true>(cand, sh, blocks, nullptr, micro, cover, occ, tests,
                               n_groups, cand_w, kslots, (cudaStream_t)stream);
  return launch<false, false>(cand, sh, blocks, nullptr, nullptr, nullptr, occ, tests,
                              n_groups, cand_w, kslots, (cudaStream_t)stream);
}

// The instanced variant: `cand` rows [1 + (3 + R) * kslots] (pool block ids,
// then each slot's instance id at 1 + (2 + R) * kslots), `xf` [I, 10, 10]
// (16-byte aligned).
extern "C" int rtxpt_cluster_shadow_inst(const int* cand, const float* sh,
                                         const float* blocks, const float* xf,
                                         float* occ, int* tests, int n_groups,
                                         int kslots, void* stream) {
  const int cand_w = 1 + (3 + R) * kslots;
  return launch<true, false>(cand, sh, blocks, xf, nullptr, nullptr, occ, tests,
                             n_groups, cand_w, kslots, (cudaStream_t)stream);
}

// The screen counters: `out` (NULL or 3 host values) receives the pairs
// screened, passed and the lists overflowed since the last call, which
// zeroes them; `enable` sets whether later launches count. Synchronous.
extern "C" int rtxpt_cluster_shadow_screen_stats(int enable,
                                                 unsigned long long* out) {
  cudaError_t e = cudaDeviceSynchronize();
  if (e == cudaSuccess && out != nullptr)
    e = cudaMemcpyFromSymbol(out, g_screen, sizeof(g_screen));
  const unsigned long long zero[3] = {0, 0, 0};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen, zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_screen_on, &enable, sizeof(int));
  return (int)e;
}
