// Per-ray bodies of the general tier's two intersection kernels: the
// brute-force pair test of K8 (brute_closest.cu) and the threaded-BVH walk of
// K9 (bvh_traverse.cu). Their plain versions are
// rtxpt_tpu_torch/accel/brute.py::_intersect_chunk and
// rtxpt_tpu_torch/accel/traverse.py::_traverse.
//
// Parity rules, as in wide.cuh: every expression keeps the operation order of
// the plain version (a dot product is (x + y) + z), the libraries are built
// with -fmad=false, and min / max propagate NaN as torch.minimum and
// torch.maximum do (fminf / fmaxf would drop it), so a ray with NaN
// components ends its walk where the plain version's does.
#pragma once

#include <math.h>
#include <stdint.h>

#include "omm.cuh"
#include "wide.cuh"

#ifdef __CUDACC__
#define RT_LDG(p) __ldg(p)
#else
#define RT_LDG(p) (*(p))
#endif

namespace rt {

// K8's per-triangle rows (accel/brute.py TB_*): n, e2, v0 x e2, e1, v0 x e1,
// v0 . n; 16 floats, one 64-byte row.
enum { TB_N = 0, TB_E2 = 3, TB_V0XE2 = 6, TB_E1 = 9, TB_V0XE1 = 12,
       TB_V0N = 15, TB_ROWS = 16 };
// The threaded BVH's node rows (accel/bvh.py): AABB min, max, prim, miss
// link, leaf triangle v0, e1, e2.
enum { ND_MIN = 0, ND_MAX = 3, ND_PRIM = 6, ND_MISS = 7, ND_V0 = 8,
       ND_E1 = 11, ND_E2 = 14, ND_ROWS = 17 };

RT_HD float minimum_(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// Factored Moller-Trumbore of one (ray, triangle) pair; x = o x d. True when
// the pair is a hit within (tmin, tmax).
RT_HD bool brute_pair(const float* r, V3 o, V3 d, V3 x, float tmin, float tmax,
                      float& t, float& u, float& v, float& det) {
  const V3 n = v3(r[TB_N], r[TB_N + 1], r[TB_N + 2]);
  const V3 e2 = v3(r[TB_E2], r[TB_E2 + 1], r[TB_E2 + 2]);
  const V3 a = v3(r[TB_V0XE2], r[TB_V0XE2 + 1], r[TB_V0XE2 + 2]);
  const V3 e1 = v3(r[TB_E1], r[TB_E1 + 1], r[TB_E1 + 2]);
  const V3 b = v3(r[TB_V0XE1], r[TB_V0XE1 + 1], r[TB_V0XE1 + 2]);
  det = -dot3(d, n);
  const float un = dot3(x, e2) + dot3(d, a);
  const float vn = -dot3(x, e1) - dot3(d, b);
  const float tn = dot3(o, n) - r[TB_V0N];
  const bool ok = fabsf(det) > 1e-12f;
  const float inv = ok ? 1.0f / det : 0.0f;
  u = un * inv;
  v = vn * inv;
  t = tn * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < tmax;
}

RT_HD float safe_inv(float x) {
  return fabsf(x) > 1e-24f ? 1.0f / x : (x >= 0.0f ? 1e30f : -1e30f);
}

struct Walk {
  float t, u, v;
  int prim;          // packed leaf index, -1 = miss
  bool front;
  int visits;        // nodes visited
  int tests;         // leaves whose AABB was hit (triangle tests)
};

// One ray's walk of the threaded BVH to the end (or, kAny, to its first hit).
// With `micro` (the micromap words in leaf order, or null) a hit whose
// micro-triangle is TRANSPARENT is rejected (traverse.py _traverse).
template <bool kAny>
RT_HD Walk bvh_walk(const float* __restrict__ nodes, V3 o, V3 d, float tmin,
                    float tmax, const int* __restrict__ micro = nullptr) {
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Walk w;
  w.t = tmax;
  w.u = 0.0f;
  w.v = 0.0f;
  w.prim = -1;
  w.front = false;
  w.visits = 0;
  w.tests = 0;
  int node = 0;
  while (node >= 0) {
    const float* g = nodes + (size_t)node * ND_ROWS;
    ++w.visits;
    const float tx0 = (RT_LDG(g + ND_MIN) - o.x) * inv.x;
    const float ty0 = (RT_LDG(g + ND_MIN + 1) - o.y) * inv.y;
    const float tz0 = (RT_LDG(g + ND_MIN + 2) - o.z) * inv.z;
    const float tx1 = (RT_LDG(g + ND_MAX) - o.x) * inv.x;
    const float ty1 = (RT_LDG(g + ND_MAX + 1) - o.y) * inv.y;
    const float tz1 = (RT_LDG(g + ND_MAX + 2) - o.z) * inv.z;
    const float tn = maximum_(
        maximum_(maximum_(minimum_(tx0, tx1), minimum_(ty0, ty1)), minimum_(tz0, tz1)),
        tmin);
    const float tf = minimum_(
        minimum_(minimum_(maximum_(tx0, tx1), maximum_(ty0, ty1)), maximum_(tz0, tz1)),
        w.t);
    const bool aabb_hit = tn <= tf;
    const int pr = (int)RT_LDG(g + ND_PRIM);
    const bool leaf = pr >= 0;
    bool tri_hit = false;
    if (leaf && aabb_hit) {
      ++w.tests;
      const V3 v0 = v3(RT_LDG(g + ND_V0), RT_LDG(g + ND_V0 + 1), RT_LDG(g + ND_V0 + 2));
      const V3 e1 = v3(RT_LDG(g + ND_E1), RT_LDG(g + ND_E1 + 1), RT_LDG(g + ND_E1 + 2));
      const V3 e2 = v3(RT_LDG(g + ND_E2), RT_LDG(g + ND_E2 + 1), RT_LDG(g + ND_E2 + 2));
      const V3 pvec = cross3(d, e2);
      const float det = dot3(e1, pvec);
      const bool ok = fabsf(det) > 1e-9f;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const V3 tvec = o - v0;
      const float u = dot3(tvec, pvec) * inv_det;
      const V3 qvec = cross3(tvec, e1);
      const float v = dot3(d, qvec) * inv_det;
      const float th = dot3(e2, qvec) * inv_det;
      tri_hit = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > tmin && th < w.t;
      if (tri_hit && micro != nullptr)
        tri_hit = micro_state((uint32_t)RT_LDG(micro + pr), micro_index(u, v)) !=
                  MICRO_TRANSPARENT;
      if (tri_hit) {
        w.t = th;
        w.u = u;
        w.v = v;
        w.prim = pr;
        w.front = det > 0.0f;
      }
    }
    int nxt = (aabb_hit && !leaf) ? node + 1 : (int)RT_LDG(g + ND_MISS);
    if (kAny && tri_hit) nxt = -1;
    node = nxt;
  }
  return w;
}

}  // namespace rt
