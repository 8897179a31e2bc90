// K2, the shadow any-hit kernel of external NEE, written by hand for Hopper
// (sm_90a).
//
// Replaces rtxpt_tpu/pt/bounce_pallas.py::_shadow_kernel (launched by
// shadow_occlusion_call, pl.pallas_call at bounce_pallas.py:1597), with and
// without opacity micromaps (omm=True: a micro-TRANSPARENT candidate never
// occludes, an UNKNOWN one where the request's alpha uniform, row SR_UA, is
// under the triangle's coverage). Plain version: rtxpt_tpu_torch/pt/
// bounce_fused.py occlusion_reference; wrapper: bounce_fused.occlusion.
//
// Input: the shadow requests that pt/nee_external.py builds on the surfaces
// K1 exported, sh [SR_ROWS, n] (origin, direction, distance, request flag,
// alpha uniform), and the scene's triangle table as K1 reads it. Output: occ
// [n], 1 = occluded or no request, 0 = visible; `tests` (NULL, or [n] i32)
// the pairs each lane tested in table order up to and including its first
// occluder (all n_tris where none occludes, 0 without a request), the count
// of the per-thread loop, for the bound.
//
// Design. Only a fifth to a third of the lanes carry a request, so each
// block first packs its requests: it reads the SR_DO flags of its lanes,
// kSpan or kExactSpan a thread (a lane without a request writes occ 1 and
// tests 0), counts them per warp with a ballot, and writes the requesting
// lanes' indices to shared memory after a prefix over the warps' counts.
// Its warps then take
// the packed requests in batches of 32. A block's lanes are 32-lane
// segments strided over the whole launch (`pack_requests`): requests crowd
// in parts of the frame, and with contiguous lanes the blocks over a floor
// got four rounds of batches while most others idled (0.46 ms against
// 0.12 ms on the rooms' requests, PERF.md, PR 18).
//  - Tables of more than bounce_fused.EXACT_TRIS triangles: K1's shadow
//    screen (bounce_fused_mma.cuh occluder_warp, kFirst): the block stages
//    the scene's coefficient tile with cp.async while it reads the flags,
//    each batch screens every (request, triangle) pair on the tensor cores
//    and resolves the pairs that pass with the exact f32 test, group by group
//    of 128 triangles in table order; within the first group that holds an
//    occluder each lane takes the lowest one, so `tests` stays the per-thread
//    loop's. 512-thread blocks, as K1's screen.
//  - Tables of at most EXACT_TRIS triangles: each lane of a batch runs the
//    exact per-thread loop (bounce_fused.cuh occluded, K1's), 128-thread
//    blocks; there the screen's fixed cost per warp outweighs the tests it
//    saves (PERF.md, PR 17).
// Both find K1's hits: occ and `tests` are bit-exact with the plain version.
//
// What bounds it: operations. On the screen, per pair the split-bf16
// products (10 m16n8k16 per 8 triangles and 16 requests) at the tensor-core
// rates and 13 f32 operations of the screen, plus the exact test (38 f32) of
// the few pairs that pass; on the exact loop 38 f32 operations a pair. The
// requests (36 bytes a lane read, 8 written) and the table once are far
// below either.
#include <cuda_runtime.h>

#include "bounce_fused_launch.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;

// Lanes a block packs per thread: 4 on the screen (its 512-thread blocks,
// one per SM, then hold a launch's requests in one round of batches), 1 on
// the exact loop (at 4 the packing cost more than 14 triangles' tests: 24%
// slower than the per-lane kernel before it, PERF.md, PR 18).
constexpr int kSpan = 4;
constexpr int kExactSpan = 1;

// The blocks of a launch over n lanes: each takes kSpanT x kThreads / 32
// segments of 32 consecutive lanes.
template <int kThreads, int kSpanT>
inline int pack_blocks(int n) {
  const int lanes = kSpanT * kThreads;
  return (n + lanes - 1) / lanes;
}

// Pack the block's requests: lanes without one get occ 1 and tests 0, the
// others' indices go to `live` in order. The block's lanes are segments of
// 32 consecutive lanes strided by the grid (block b takes segments b,
// b + gridDim.x, ...), so that every block draws its requests from the
// whole launch: where the requests crowd in one part of the frame, no block
// gets more batches than its warps take at once while others idle. Each
// warp reads one segment's flags (128 bytes) per step. Returns the count
// (the same in every thread). Ends with a block barrier.
template <int kThreads, int kSpanT>
__device__ __forceinline__ int pack_requests(const float* __restrict__ sh,
                                             float* __restrict__ occ_out,
                                             int* __restrict__ tests, int n, int* live,
                                             int* count, int* offset) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t ballot[kSpanT];
  int lane_of[kSpanT];
#pragma unroll
  for (int s = 0; s < kSpanT; ++s) {
    const int i = (blockIdx.x + (s * kWarps + warp) * gridDim.x) * 32 + lane;
    lane_of[s] = i;
    const bool want = i < n && sh[(size_t)SR_DO * n + i] > 0.5f;
    if (i < n && !want) {
      occ_out[i] = 1.0f;
      if (tests != nullptr) tests[i] = 0;
    }
    ballot[s] = __ballot_sync(k1::kFull, want);
    if (lane == 0) count[s * kWarps + warp] = __popc(ballot[s]);
  }
  __syncthreads();
  if (threadIdx.x <= kSpanT * kWarps) {
    int sum = 0;
    for (int k = 0; k < (int)threadIdx.x; ++k) sum += count[k];
    offset[threadIdx.x] = sum;  // offset[kSpanT x kWarps]: the total
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSpanT; ++s)
    if ((ballot[s] >> lane) & 1u)
      live[offset[s * kWarps + warp] + __popc(ballot[s] & ((1u << lane) - 1u))] = lane_of[s];
  const int total = offset[kSpanT * kWarps];
  __syncthreads();
  return total;
}

struct Request {
  V3 o, d;
  float dist, u_alpha;
};

__device__ __forceinline__ Request load_request(const float* __restrict__ sh, int n, int i,
                                                bool live) {
  Request r;
  r.o = r.d = splat(0.0f);
  r.dist = r.u_alpha = 0.0f;
  if (live) {
    auto SH = [&](int row) { return sh[(size_t)row * n + i]; };
    r.o = v3(SH(SR_O), SH(SR_O + 1), SH(SR_O + 2));
    r.d = v3(SH(SR_D), SH(SR_D + 1), SH(SR_D + 2));
    r.dist = SH(SR_DIST);
    r.u_alpha = SH(SR_UA);
  }
  return r;
}

// The tensor-core form, tables of more than EXACT_TRIS triangles.
template <bool HasOmm>
__global__ void __launch_bounds__(k1::kThreads)
shadow_occlusion_kernel(const float* __restrict__ sh, float* __restrict__ occ_out,
                        int* __restrict__ tests, const __nv_bfloat16* __restrict__ tile,
                        const float* __restrict__ scale, int t8, Tables tb, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int live[kSpan * k1::kThreads];
  __shared__ int count[kSpan * k1::kWarps], offset[kSpan * k1::kWarps + 1];
  k1::stage_tile(smem, tile, scale, t8);
  const int total =
      pack_requests<k1::kThreads, kSpan>(sh, occ_out, tests, n, live, count, offset);
  cl::cp_async_wait<0>();
  __syncthreads();
  if (total == 0) return;
  const k1::Warp w = k1::warp_view(smem, t8);
  const bool count_on = k1::g_screen_on != 0;
  for (int b = (threadIdx.x >> 5) * 32; b < total; b += k1::kThreads) {
    const int idx = b + (threadIdx.x & 31);
    const bool want = idx < total;
    const int i = want ? live[idx] : 0;
    const Request r = load_request(sh, n, i, want);
    const int first = k1::occluder_warp<HasOmm, true>(w, tb, r.o, r.d, r.dist,
                                                      HasOmm ? r.u_alpha : 0.0f, want,
                                                      count_on);
    if (want) {
      occ_out[i] = first >= 0 ? 1.0f : 0.0f;
      if (tests != nullptr) tests[i] = first >= 0 ? first + 1 : tb.n_tris;
    }
  }
}

// The exact per-lane loop, tables of at most EXACT_TRIS triangles.
constexpr int kExactThreads = k1::kExactThreads;

template <bool HasOmm>
__global__ void __launch_bounds__(kExactThreads)
shadow_occlusion_kernel_exact(const float* __restrict__ sh, float* __restrict__ occ_out,
                              int* __restrict__ tests, Tables tb, int n) {
  __shared__ int live[kExactSpan * kExactThreads];
  __shared__ int count[kExactSpan * kExactThreads / 32];
  __shared__ int offset[kExactSpan * kExactThreads / 32 + 1];
  const int total =
      pack_requests<kExactThreads, kExactSpan>(sh, occ_out, tests, n, live, count, offset);
  for (int idx = threadIdx.x; idx < total; idx += kExactThreads) {
    const int i = live[idx];
    const Request r = load_request(sh, n, i, true);
    int tested = 0;
    const bool occ = occluded<HasOmm>(tb, r.o, r.d, r.dist, HasOmm ? r.u_alpha : 0.0f, tested);
    occ_out[i] = occ ? 1.0f : 0.0f;
    if (tests != nullptr) tests[i] = tested;
  }
}

template <bool HasOmm>
int launch(const float* sh, float* occ, int* tests, const __nv_bfloat16* tile,
           const float* scale, int t8, const Tables& tb, int n, cudaStream_t stream) {
  if (t8 / 8 <= k1::kExactChunks) {
    shadow_occlusion_kernel_exact<HasOmm>
        <<<pack_blocks<kExactThreads, kExactSpan>(n), kExactThreads, 0, stream>>>(sh, occ, tests,
                                                                                  tb, n);
    return (int)cudaGetLastError();
  }
  const cudaError_t e =
      allow_largest_tile(reinterpret_cast<const void*>(&shadow_occlusion_kernel<HasOmm>));
  if (e != cudaSuccess) return (int)e;
  shadow_occlusion_kernel<HasOmm>
      <<<pack_blocks<k1::kThreads, kSpan>(n), k1::kThreads, k1::smem_bytes(t8), stream>>>(
          sh, occ, tests, tile, scale, t8, tb, n);
  return (int)cudaGetLastError();
}

}  // namespace

// `micro` and `cover` ([tpad] each, or NULL): the micromap words and
// coverages of the omm variant; `tile` [30, t8] bf16 and `scale` [t8] f32:
// the coefficient tile of the scene (bounce_fused.coefficient_tile).
extern "C" int rtxpt_shadow_occlusion(const float* sh, float* occ, int* tests,
                                      const float* tri_coef, const int* micro,
                                      const float* cover, const void* tile,
                                      const float* scale, int t8, int n, int n_tris,
                                      void* stream) {
  const Tables tb = bounce_tables(tri_coef, nullptr, nullptr, nullptr, nullptr, nullptr,
                                  nullptr, 0, 0, micro, cover, n_tris, 0, 0);
  const __nv_bfloat16* bt = static_cast<const __nv_bfloat16*>(tile);
  if (micro != nullptr)
    return launch<true>(sh, occ, tests, bt, scale, t8, tb, n, (cudaStream_t)stream);
  return launch<false>(sh, occ, tests, bt, scale, t8, tb, n, (cudaStream_t)stream);
}

// K2's screen counters (bounce_fused_mma.cuh; the shadow slots): `out` (NULL
// or 6 host values) receives the counts since the last call, which zeroes
// them; `enable` sets whether later launches count. Synchronous.
extern "C" int rtxpt_shadow_occlusion_screen_stats(int enable, unsigned long long* out) {
  return rt::k1::screen_stats(enable, out);
}
