// The brute-force pair test of K8 (brute_closest.cu), the general tier's
// closest hit over every (ray, triangle) pair, and its screen; the plain
// version is rtxpt_tpu_torch/accel/brute.py::_intersect_chunk. Kept apart
// from accel.cuh (K9's walk) so that K8 can include K1's tensor-core
// screen (bounce_fused_mma.cuh) beside it.
//
// Parity rules, as in wide.cuh: every expression keeps the operation order
// of the plain version (a dot product is (x + y) + z), and the library is
// built with -fmad=false.
#pragma once

#include <math.h>

#include "wide.cuh"

namespace rt {

// K8's per-triangle rows (accel/brute.py TB_*): n, e2, v0 x e2, e1, v0 x e1,
// v0 . n; 16 floats, one 64-byte row.
enum { TB_N = 0, TB_E2 = 3, TB_V0XE2 = 6, TB_E1 = 9, TB_V0XE1 = 12,
       TB_V0N = 15, TB_ROWS = 16 };
constexpr float kBruteHuge = 4.2535296e37f;   // 2^125: brute_screen passes it

// The det and u numerators of one (ray, triangle) pair of K8's rows r, and
// its v numerator; x = o x d (accel/brute.py _intersect_chunk's sums).
RT_HD void brute_det_u(const float* r, V3 d, V3 x, float& det, float& un) {
  const V3 n = v3(r[TB_N], r[TB_N + 1], r[TB_N + 2]);
  const V3 e2 = v3(r[TB_E2], r[TB_E2 + 1], r[TB_E2 + 2]);
  const V3 a = v3(r[TB_V0XE2], r[TB_V0XE2 + 1], r[TB_V0XE2 + 2]);
  det = -dot3(d, n);
  un = dot3(x, e2) + dot3(d, a);
}

RT_HD float brute_v(const float* r, V3 d, V3 x) {
  const V3 e1 = v3(r[TB_E1], r[TB_E1 + 1], r[TB_E1 + 2]);
  const V3 b = v3(r[TB_V0XE1], r[TB_V0XE1 + 1], r[TB_V0XE1 + 2]);
  return -dot3(x, e1) - dot3(d, b);
}

RT_HD void brute_numerators(const float* r, V3 d, V3 x, float& det, float& un, float& vn) {
  brute_det_u(r, d, x, det, un);
  vn = brute_v(r, d, x);
}

// The rest of the factored Moller-Trumbore test, on brute_numerators' det,
// un and vn: true when the pair is a hit within (tmin, tmax).
RT_HD bool brute_accept(const float* r, V3 o, float det, float un, float vn, float tmin,
                        float tmax, float& t, float& u, float& v) {
  const V3 n = v3(r[TB_N], r[TB_N + 1], r[TB_N + 2]);
  const float tn = dot3(o, n) - r[TB_V0N];
  const bool ok = fabsf(det) > 1e-12f;
  const float inv = ok ? 1.0f / det : 0.0f;
  u = un * inv;
  v = vn * inv;
  t = tn * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > tmin && t < tmax;
}

// Factored Moller-Trumbore of one (ray, triangle) pair; x = o x d. True when
// the pair is a hit within (tmin, tmax).
RT_HD bool brute_pair(const float* r, V3 o, V3 d, V3 x, float tmin, float tmax,
                      float& t, float& u, float& v, float& det) {
  float un, vn;
  brute_numerators(r, d, x, det, un, vn);
  return brute_accept(r, o, det, un, vn, tmin, tmax, t, u, v);
}

// K8's screen on the exact numerators (brute_numerators' own, bit for bit):
// false only where brute_accept rejects the pair whatever its t. With s =
// det's sign, su = s un, sv = s vn and w = |det| 2^-20, it passes where
// |det| > 1e-12 (brute_accept's own test), su >= -w, sv >= -w and
// su + sv <= |det| + w, each rounded once. Why every accepted pair passes:
// inv = RN(1 / det) and u = RN(un inv) err by at most 2^-24 each (no
// underflow: |det| > 1e-12, and a product that underflows only moves u
// toward 0). u >= 0 holds for a negative su only where u rounds to -0, i.e.
// |su| < 2^-149 |det| < w. RN(u + v) <= 1 needs u + v <= 1 + 2^-24, so
// (su + sv) / |det| <= (1 + 2^-24) / (1 - 2^-24)^2 + 2^-148 < 1 + 2^-22; the
// screen's sum rounds up by at most 2^-24 of itself and its bound
// RN(|det| + w) down by at most 2^-24 of |det| + w, both far inside the
// 2^-20 slack. A |det| of 2^125 or more passes whatever its numerators:
// there inv may be subnormal and err by more. NaN numerators fail both
// (brute_accept's comparisons with a NaN u or v are false).
RT_HD bool brute_screen(float det, float un, float vn) {
  const float absd = fabsf(det);
  const float w = absd * (1.0f / 1048576.0f);
  const float su = det < 0.0f ? -un : un;
  const float sv = det < 0.0f ? -vn : vn;
  return absd > 1e-12f &&
         (absd >= kBruteHuge || (su >= -w && sv >= -w && su + sv <= absd + w));
}

// brute_screen's test of det and u_num alone: false only where it fails
// whatever v_num.
RT_HD bool brute_screen_u(float det, float un) {
  const float absd = fabsf(det);
  const float w = absd * (1.0f / 1048576.0f);
  const float su = det < 0.0f ? -un : un;
  return absd > 1e-12f && (absd >= kBruteHuge || su >= -w);
}

}  // namespace rt
