// Per-ray body of the general tier's BVH walk K9 (bvh_traverse.cu): the
// 4-wide walk; its plain version is
// rtxpt_tpu_torch/accel/traverse.py::_traverse_wide. K8's pair test, the
// other intersection body of the tier, is brute.cuh's.
//
// Parity rules, as in wide.cuh: every expression keeps the operation order of
// the plain version (a dot product is (x + y) + z), the libraries are built
// with -fmad=false, and min / max propagate NaN as torch.minimum and
// torch.maximum do (fminf / fmaxf would drop it), so a ray with NaN
// components ends its walk where the plain version's does.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#include "omm.cuh"
#include "wide.cuh"

#ifdef __CUDACC__
#define RT_LDG(p) __ldg(p)
#else
#define RT_LDG(p) (*(p))
#endif

namespace rt {

// K9's 4-wide nodes (accel/bvh.py collapse_wide): 32 floats, one 128-byte
// line; the children's AABBs as structure of arrays, then their references.
enum { WN_MINX = 0, WN_MINY = 4, WN_MINZ = 8, WN_MAXX = 12, WN_MAXY = 16,
       WN_MAXZ = 20, WN_REF = 24, WN_ROWS = 32 };
// its leaf triangles: v0, e1, e2, each padded to 4 floats (48 bytes)
enum { WT_V0 = 0, WT_E1 = 4, WT_E2 = 8, WT_ROWS = 12 };
constexpr int kWideStack = 96;                 // bvh.WIDE_STACK
constexpr float kWideSlack = 1.0f / 1048576.0f;  // traverse.WIDE_SLACK, 2^-20

struct F4 {
  float x, y, z, w;
};

// One 16-byte load through the read-only cache (p 16-byte aligned).
RT_HD F4 ldg4(const float* p) {
#ifdef __CUDA_ARCH__
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  F4 r = {v.x, v.y, v.z, v.w};
#else
  F4 r = {p[0], p[1], p[2], p[3]};
#endif
  return r;
}

RT_HD float lane4(F4 v, int c) { return c == 0 ? v.x : (c == 1 ? v.y : (c == 2 ? v.z : v.w)); }

RT_HD float minimum_(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

RT_HD int float_bits(float x) {
#ifdef __CUDA_ARCH__
  return __float_as_int(x);
#else
  int r;
  memcpy(&r, &x, sizeof(r));
  return r;
#endif
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

// One ray's walk of the 4-wide BVH (traverse.py _traverse_wide, its plain
// version, step for step). The stack holds (wide node, entry t); the root
// goes first. A popped entry beyond the limit (tmax, and after the first hit
// best_t + |best_t| x kWideSlack) is dropped unvisited. A visit loads the
// node's 128-byte line as eight 16-byte loads, slab-tests the 4 children
// against [tmin, limit], tests the hit leaves' triangles in slot order (a
// hit replaces the best where th < t, or th == t and its leaf index is lower:
// the least (t, leaf) whatever the order), then pushes the hit inner
// children, the nearest (least entry, then slot) on top. kAny ends at the
// first accepted hit and pushes in slot order (the first slot on top): any
// occluder ends it, and the ordering cost more than it saved on the city's
// shadow rays (PERF.md, PR 18). kOmm: a hit whose micro-triangle is TRANSPARENT
// (`micro`, the micromap words in leaf order) is rejected.
template <bool kAny, bool kOmm>
RT_HD Walk wide_walk(const float* __restrict__ nodes, const float* __restrict__ tris, V3 o,
                     V3 d, float tmin, float tmax, const int* __restrict__ micro) {
  const V3 inv = v3(safe_inv(d.x), safe_inv(d.y), safe_inv(d.z));
  Walk w;
  w.t = tmax;
  w.u = 0.0f;
  w.v = 0.0f;
  w.prim = -1;
  w.front = false;
  w.visits = 0;
  w.tests = 0;
  // kAny's limit stays tmax (it ends at its first hit), so it never drops
  // an entry and keeps no entry t
  int stk_n[kWideStack];
  float stk_t[kAny ? 1 : kWideStack];
  int sp = 1;
  stk_n[0] = 0;
  stk_t[0] = -INFINITY;
  while (sp > 0) {
    --sp;
    const float lim = (!kAny && w.prim >= 0) ? w.t + fabsf(w.t) * kWideSlack : tmax;
    if (!kAny && stk_t[sp] > lim) continue;
    const float* g = nodes + (size_t)stk_n[sp] * WN_ROWS;
    ++w.visits;
    const F4 mnx = ldg4(g + WN_MINX), mny = ldg4(g + WN_MINY), mnz = ldg4(g + WN_MINZ);
    const F4 mxx = ldg4(g + WN_MAXX), mxy = ldg4(g + WN_MAXY), mxz = ldg4(g + WN_MAXZ);
    const F4 rf = ldg4(g + WN_REF);
    float tn[4];
    int ref[4];
    bool hit[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float tx0 = (lane4(mnx, c) - o.x) * inv.x;
      const float ty0 = (lane4(mny, c) - o.y) * inv.y;
      const float tz0 = (lane4(mnz, c) - o.z) * inv.z;
      const float tx1 = (lane4(mxx, c) - o.x) * inv.x;
      const float ty1 = (lane4(mxy, c) - o.y) * inv.y;
      const float tz1 = (lane4(mxz, c) - o.z) * inv.z;
      tn[c] = maximum_(
          maximum_(maximum_(minimum_(tx0, tx1), minimum_(ty0, ty1)), minimum_(tz0, tz1)),
          tmin);
      const float tf = minimum_(
          minimum_(minimum_(maximum_(tx0, tx1), maximum_(ty0, ty1)), maximum_(tz0, tz1)),
          lim);
      ref[c] = float_bits(lane4(rf, c));
      hit[c] = tn[c] <= tf && ref[c] != 0;
    }
    bool found = false;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!hit[c] || ref[c] > 0 || (kAny && found)) continue;
      const int leaf = -ref[c] - 1;
      ++w.tests;
      const float* tr = tris + (size_t)leaf * WT_ROWS;
      const F4 a = ldg4(tr + WT_V0), b = ldg4(tr + WT_E1), e = ldg4(tr + WT_E2);
      const V3 v0 = v3(a.x, a.y, a.z), e1 = v3(b.x, b.y, b.z), e2 = v3(e.x, e.y, e.z);
      const V3 pvec = cross3(d, e2);
      const float det = dot3(e1, pvec);
      const bool ok = fabsf(det) > 1e-9f;
      const float inv_det = ok ? 1.0f / det : 0.0f;
      const V3 tvec = o - v0;
      const float u = dot3(tvec, pvec) * inv_det;
      const V3 qvec = cross3(tvec, e1);
      const float v = dot3(d, qvec) * inv_det;
      const float th = dot3(e2, qvec) * inv_det;
      bool acc = ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && th > tmin &&
                 (th < w.t || (th == w.t && leaf < w.prim));
      if (kOmm && acc)
        acc = micro_state((uint32_t)RT_LDG(micro + leaf), micro_index(u, v)) !=
              MICRO_TRANSPARENT;
      if (acc) {
        w.t = th;
        w.u = u;
        w.v = v;
        w.prim = leaf;
        w.front = det > 0.0f;
        found = true;
      }
    }
    if (kAny && found) break;
    int cnt = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) cnt += (hit[c] && ref[c] > 0) ? 1 : 0;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!hit[c] || ref[c] <= 0) continue;
      int rank = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        rank += (k != c && hit[k] && ref[k] > 0 &&
                 (kAny ? k < c : (tn[k] < tn[c] || (tn[k] == tn[c] && k < c)))) ? 1 : 0;
      stk_n[sp + cnt - 1 - rank] = ref[c];
      if (!kAny) stk_t[sp + cnt - 1 - rank] = tn[c];
    }
    sp += cnt;
  }
  return w;
}

}  // namespace rt
