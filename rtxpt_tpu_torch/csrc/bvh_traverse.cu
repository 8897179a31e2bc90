// K9, the threaded-BVH walk of the general tier, written by hand for Hopper
// (sm_90a), in closest-hit and any-hit variants.
//
// Replaces rtxpt_tpu/accel/traverse_pallas.py::_step_kernel (launched by
// _traverse_call, pl.pallas_call at traverse_pallas.py:165, through
// traverse_vmem). Plain version: rtxpt_tpu_torch/accel/traverse.py
// _traverse; wrapper: traverse.walk.
//
// Input: rays o, d [n, 3], tmin, tmax [n]; the node table [M, 17] of
// accel/bvh.py (AABB, prim and miss link as floats, leaf triangle). Output:
// t [n] (tmax on a miss), prim [n] (the packed leaf index, -1 on a miss; the
// wrapper's caller maps it through prim_tri), uv [n, 2], front [n] (bool);
// with non-NULL visits / tests, the nodes each ray visited and its triangle
// tests. With `micro` ([T] micromap words in leaf order, or NULL) a leaf hit
// whose micro-triangle is TRANSPARENT is rejected inside the walk: the
// micromap branch of the JAX package's XLA walk (rtxpt_tpu/accel/
// traverse.py:113-121), which its TPU step kernel does not have; here K9
// serves every BVH query on the card, so it carries the test.
//
// Design. The TPU kernel gathers node rows with a one-hot matrix product over
// a VMEM-resident table of at most 4096 nodes, runs a fixed 24 steps per
// launch and is relaunched by an XLA while loop until every lane is done.
// On the card one thread takes one ray and walks the skip-link order to the
// end (rt::bvh_walk in accel.cuh): no step cap, no node cap, no stack. Node
// rows are read from global memory through the read-only cache; a leaf's
// triangle is read only when the leaf's AABB is hit.
//
// What bounds it: operations, about 50 f32 operations per visited node (slab
// test, and at a hit leaf the triangle test), counted from the `visits`
// output; its bytes are the rays and the table once. In practice each step
// waits on the load of its node row (a dependent chain per thread), and the
// rays of a warp diverge in their walks.
#include <cuda_runtime.h>

#include "accel.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;

template <bool kAny>
__global__ void __launch_bounds__(kThreads)
bvh_traverse_kernel(const float* __restrict__ o, const float* __restrict__ d,
                    const float* __restrict__ tmin, const float* __restrict__ tmax,
                    const float* __restrict__ nodes, const int* __restrict__ micro,
                    float* __restrict__ t_out,
                    int* __restrict__ prim_out, float* __restrict__ uv_out,
                    uint8_t* __restrict__ front_out, int* __restrict__ visits,
                    int* __restrict__ tests, int n) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const V3 O = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
  const V3 D = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
  const Walk w = bvh_walk<kAny>(nodes, O, D, tmin[i], tmax[i], micro);
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
                                  const float* tmax, const float* nodes, const int* micro,
                                  float* t, int* prim, float* uv, unsigned char* front,
                                  int* visits, int* tests, int n, int any_hit,
                                  void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  if (any_hit)
    bvh_traverse_kernel<true><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        o, d, tmin, tmax, nodes, micro, t, prim, uv, front, visits, tests, n);
  else
    bvh_traverse_kernel<false><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        o, d, tmin, tmax, nodes, micro, t, prim, uv, front, visits, tests, n);
  return (int)cudaGetLastError();
}
