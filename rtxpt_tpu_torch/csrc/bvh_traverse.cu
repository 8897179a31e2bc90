// K9, the BVH walk of the general tier, written by hand for Hopper (sm_90a):
// a 4-wide walk, nearest child first, in four instantiations: closest-hit
// and any-hit, each with and without opacity micromaps.
//
// Replaces rtxpt_tpu/accel/traverse_pallas.py::_step_kernel (launched by
// _traverse_call, pl.pallas_call at traverse_pallas.py:165, through
// traverse_vmem). Plain version: rtxpt_tpu_torch/accel/traverse.py
// _traverse_wide (held to the JAX package's threaded walk, `_traverse`, by
// the CPU tests); wrapper: traverse.walk.
//
// Input: rays o, d [n, 3], tmin, tmax [n]; the 4-wide node table [W, 32] and
// the leaf triangles [T, 12] of accel/bvh.py collapse_wide. Output: t [n]
// (tmax on a miss), prim [n] (the packed leaf index, -1 on a miss; the
// wrapper's caller maps it through prim_tri), uv [n, 2], front [n] (bool);
// with non-NULL visits / tests, the wide nodes each ray visited and its
// triangle tests. With `micro` ([T] micromap words in leaf order, or NULL) a
// leaf hit whose micro-triangle is TRANSPARENT is rejected inside the walk:
// the micromap branch of the JAX package's XLA walk (rtxpt_tpu/accel/
// traverse.py:113-121), which its TPU step kernel does not have; here K9
// serves every BVH query on the card, so it carries the test.
//
// Design. The TPU kernel gathers node rows with a one-hot matrix product over
// a VMEM-resident table of at most 4096 nodes, runs a fixed 24 steps per
// launch and is relaunched by an XLA while loop until every lane is done.
// On the card one thread takes one ray and walks the 4-wide tree to the end
// (rt::wide_walk in accel.cuh): per step one 128-byte line of 4 child boxes
// (eight 16-byte loads, one sector-aligned line), 4 slab tests, the hit
// leaves' triangles (one 48-byte row each), and the hit inner children
// pushed on a per-thread stack (local memory, bvh.WIDE_STACK entries; the
// build raises for a tree that could need more), the nearest on top, so
// that the closest hit prunes by its best t early. The wide table is about
// half the binary table's bytes with the triangles apart, and a ray visits
// about a quarter of the nodes the threaded skip-link walk visits.
//
// What bounds it: operations, about 4 slab tests and their ordering per
// visited wide node and 54 f32 operations per triangle test (counted from
// the `visits` and `tests` outputs); its bytes are the rays and the tables
// once. In practice each step still waits on its node's load (a dependent
// chain per thread), and the rays of a warp diverge in their walks.
#include <cuda_runtime.h>

#include "accel.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;

// 128-thread blocks: 64 and 128 were the fastest on the city and the
// foliage, 256 and 512 up to 18% slower; staging the tree's top levels in
// shared memory did not pay (PERF.md, PR 18)
constexpr int kThreads = 128;

template <bool kAny, bool kOmm>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin, const float* __restrict__ tmax,
                    const float* __restrict__ nodes, const float* __restrict__ tris,
                    const int* __restrict__ micro, float* __restrict__ t_out,
                    int* __restrict__ prim_out, float* __restrict__ uv_out,
                    uint8_t* __restrict__ front_out, int* __restrict__ visits,
                    int* __restrict__ tests, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 O = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const V3 D = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const Walk w = wide_walk<kAny, kOmm>(nodes, tris, O, D, tmin[i], tmax[i], micro);
  t_out[i] = w.t;
  prim_out[i] = w.prim;
  uv_out[2 * i] = w.u;
  uv_out[2 * i + 1] = w.v;
  front_out[i] = w.front ? 1 : 0;
  if (visits != nullptr) {
    visits[i] = w.visits;
    tests[i] = w.tests;
  }
}

}  // namespace

extern "C" int rtxpt_bvh_traverse(const float* o, const float* d, const float* tmin,
                                  const float* tmax, const float* nodes, const float* tris,
                                  const int* micro, float* t, int* prim, float* uv,
                                  unsigned char* front, int* visits, int* tests, int n,
                                  int any_hit, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  auto kernel = any_hit ? (micro != nullptr ? bvh_traverse_kernel<true, true>
                                            : bvh_traverse_kernel<true, false>)
                        : (micro != nullptr ? bvh_traverse_kernel<false, true>
                                            : bvh_traverse_kernel<false, false>);
  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(o, d, tmin, tmax, nodes, tris, micro, t,
                                                       prim, uv, front, visits, tests, n);
  return (int)cudaGetLastError();
}
