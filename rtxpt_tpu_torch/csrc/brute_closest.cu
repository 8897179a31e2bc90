// K8, the brute-force closest-hit kernel of the general tier, written by hand
// for Hopper (sm_90a).
//
// Replaces rtxpt_tpu/accel/brute_pallas.py::_kernel (launched by _call,
// pl.pallas_call at brute_pallas.py:93, through intersect_brute_pallas), the
// TPU kernel of rtxpt_tpu/accel/brute.py's all-pairs test. Plain version:
// rtxpt_tpu_torch/accel/brute.py::_intersect_chunk; wrapper: brute.closest.
//
// Input: rays o, d [n, 3], tmin, tmax [n]; the triangle table [n_tris, 16]
// (accel/brute.py TB_*: the factored operands n, e2, v0 x e2, e1, v0 x e1,
// v0 . n, one 64-byte row per triangle, n_tris <= 4096). Output: t [n] (tmax
// on a miss), prim [n] (-1 on a miss), uv [n, 2] (0 on a miss), front [n]
// (bool, det > 0 at the hit).
//
// Design. The TPU kernel computes the four Moller-Trumbore quantities of a
// 512 x 512 tile of pairs as one [512, 128] x [128, 2048] matrix product and
// min-reduces along the triangles. Here one thread takes one ray: a block of
// 128 rays stages the table in tiles of 128 triangles (8 KB, 16-byte loads)
// in shared memory, and each thread walks the tile in index order, keeping
// the first pair with the smallest t (a strict t < best: the same winner as
// the TPU kernel's iota-min). Every thread of a warp reads the same row, so a
// row is one shared-memory broadcast.
//
// What bounds it: operations. A pair costs about 45 f32 operations (four
// factored quantities, the reciprocal, the tests) against 64 bytes of table
// shared by all rays; per ray 32 bytes are read and 20 written.
#include <cuda_runtime.h>

#include "accel.cuh"
#include "rt_error.cuh"

namespace {

using namespace rt;

constexpr int kThreads = 128;
constexpr int kTile = 128;     // triangles per shared-memory tile

__global__ void __launch_bounds__(kThreads)
brute_closest_kernel(const float* __restrict__ o, const float* __restrict__ d,
                     const float* __restrict__ tmin, const float* __restrict__ tmax,
                     const float4* __restrict__ table, float* __restrict__ t_out,
                     int* __restrict__ prim_out, float* __restrict__ uv_out,
                     uint8_t* __restrict__ front_out, int n, int n_tris) {
  __shared__ float4 tile[kTile * (TB_ROWS / 4)];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  V3 O = v3(0.0f, 0.0f, 0.0f), D = v3(0.0f, 0.0f, 1.0f);
  float t_lo = 0.0f, t_hi = -1.0f;
  if (live) {
    O = v3(o[3 * i], o[3 * i + 1], o[3 * i + 2]);
    D = v3(d[3 * i], d[3 * i + 1], d[3 * i + 2]);
    t_lo = tmin[i];
    t_hi = tmax[i];
  }
  const V3 X = cross3(O, D);
  float best = INFINITY, bu = 0.0f, bv = 0.0f, bdet = 0.0f;
  int bj = -1;
  for (int base = 0; base < n_tris; base += kTile) {
    const int count = min(kTile, n_tris - base);
    __syncthreads();   // the previous tile is no longer read
    for (int k = threadIdx.x; k < count * (TB_ROWS / 4); k += kThreads)
      tile[k] = table[(size_t)base * (TB_ROWS / 4) + k];
    __syncthreads();
    for (int j = 0; j < count; ++j) {
      const float* r = reinterpret_cast<const float*>(tile + j * (TB_ROWS / 4));
      float t, u, v, det;
      if (brute_pair(r, O, D, X, t_lo, t_hi, t, u, v, det) && t < best) {
        best = t;
        bu = u;
        bv = v;
        bdet = det;
        bj = base + j;
      }
    }
  }
  if (!live) return;
  const bool hit = bj >= 0;
  t_out[i] = hit ? best : t_hi;
  prim_out[i] = bj;
  uv_out[2 * i] = hit ? bu : 0.0f;
  uv_out[2 * i + 1] = hit ? bv : 0.0f;
  front_out[i] = (hit && bdet > 0.0f) ? 1 : 0;
}

}  // namespace

extern "C" int rtxpt_brute_closest(const float* o, const float* d, const float* tmin,
                                   const float* tmax, const float* table, float* t,
                                   int* prim, float* uv, unsigned char* front, int n,
                                   int n_tris, void* stream) {
  const int blocks = (n + kThreads - 1) / kThreads;
  brute_closest_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      o, d, tmin, tmax, reinterpret_cast<const float4*>(table), t, prim, uv, front, n,
      n_tris);
  return (int)cudaGetLastError();
}
