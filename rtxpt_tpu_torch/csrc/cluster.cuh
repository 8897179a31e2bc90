// The clustered tier's per-lane math, shared by K3 (cluster_closest.cu), K5
// (cluster_shadow.cu) and the per-row K6 and K7 (cluster_rows.cu; the
// tensor-core form of K3 and K5 is in cluster_mma.cuh): the
// cluster block layout and its staging in shared memory, the split-bf16 ray
// operand (and the per-row one),
// the world -> object map of the operand on instanced tables, the
// intersection quantities of one staged block, the closest-hit selection with
// its edge margins and tie bump, the strict any-hit test, the micromap
// state of a candidate with the near-edge rule, and the exact f32 refit of
// the winner. The plain versions of the same functions are in
// rtxpt_tpu_torch/pt/bounce_clustered.py (_operand, object_operand,
// _quantities, closest_hit_reference, occlusion_reference, _refit); every
// expression keeps their operation order, and the library is built with
// -fmad=false.
#pragma once

#include <stdint.h>
#include <string.h>

#include "omm.cuh"
#include "wide.cuh"

#ifdef __CUDACC__
#include <cuda_bf16.h>
#endif

namespace rt {
namespace cl {

// Block layout [BLK_ROWS, LANES] f32 (rtxpt_tpu_torch/accel/cluster.py):
// rows 0..9 coefficient hi, 10..19 coefficient lo, 20 the cluster center,
// 21.. the attribute rows, logical row a at [21 + a / 4, (a % 4) * CT + j].
constexpr int CT = 128;
constexpr int BLK_ROWS = 32;
constexpr int LANES = 4 * CT;
constexpr int BLK_FLOATS = BLK_ROWS * LANES;
constexpr int CENTER_ROW = 20;
constexpr int ATTR_BASE = 21;
constexpr int STAGE_ROWS = 21;      // what a visit reads: rows 0..20
constexpr int FL = 1024;            // lanes of a ray group
constexpr int R = 8;                // 128-lane rows of a group
constexpr int XF_FLOATS = 100;      // an instance's M10, row-major [10,10]
enum { AT_V0 = 0, AT_E1 = 3, AT_E2 = 6, AT_GIDX = 25, AT_VALID = 26 };

// Row maps of pt/bounce_clustered.py
enum { OD_D = 0, OD_OXD = 3, OD_O = 6, OD_ACT = 9, OD_ROWS = 10 };
enum { HA_T = 0, HA_U = 1, HA_V = 2, HA_FRONT = 3, HA_PRIM = 4, HA_ATTR = 5,
       HA_NATTR = 28, HA_UNK = 33, HA_INST = 34, HA_ROWS = 35 };
enum { SH_O = 0, SH_D = 3, SH_DIST = 6, SH_CONTRIB = 7, SH_DO = 10,
       SH_CDIFF = 11, SH_UA = 14, SH_ROWS = 15 };

// HA row HA_ATTR + i holds cluster attribute row kAttrRows[i]
// (bounce_clustered.ATTR_ROWS; tests/test_torch_cluster.py checks it).
RT_CONST const int kAttrRows[HA_NATTR] = {
    12, 13, 14, 15, 16, 17, 18, 19, 20, 9, 10, 11, 21, 22,
    23, 24, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38};

// bounce_clustered.py constants, rounded to f32 as torch rounds a Python
// scalar against an f32 tensor.
constexpr float kMargin = (float)2e-3;
constexpr float kTieScale = (float)(1.0 + 1e-4);
constexpr float kRefitLo = (float)(-1e-3);
constexpr float kRefitHi = (float)(1.0 + 1e-3);
constexpr float kShadowScale = (float)(1.0 - 2e-4);
constexpr float kMinDet = (float)1e-30;
constexpr float kBigT = (float)1e30;
// the near-edge band of a micro-cell (bounce_clustered._EDGE4), in cell
// units: the split-bf16 (u, v) carry margin-scale error
constexpr float kEdge = (float)(4.0 * 4.0 * 2e-3);
constexpr float kEdgeHi = (float)(1.0 - 4.0 * 4.0 * 2e-3);

#ifdef __CUDACC__
// Stage rows 0..STAGE_ROWS-1 of cluster `cid`'s block in shared memory with
// 16-byte loads, thread `l` of the block's `nthreads`; the caller syncs.
__device__ __forceinline__ void stage_block(float* stage, const float* blocks,
                                            int cid, int l, int nthreads) {
  const float4* src = reinterpret_cast<const float4*>(blocks + (size_t)cid * BLK_FLOATS);
  float4* dst = reinterpret_cast<float4*>(stage);
  for (int k = l; k < STAGE_ROWS * LANES / 4; k += nthreads) dst[k] = src[k];
}
#endif

// The cluster center of a staged (or global) block.
RT_HD V3 block_center(const float* blk) {
  return v3(blk[CENTER_ROW * LANES], blk[CENTER_ROW * LANES + CT],
            blk[CENTER_ROW * LANES + 2 * CT]);
}

// f32 -> bf16 -> f32, round to nearest even (torch's .to(torch.bfloat16)).
RT_HD float bf16_round(float x) {
#ifdef __CUDA_ARCH__
  return __bfloat162float(__float2bfloat16_rn(x));
#else
  uint32_t u;
  memcpy(&u, &x, 4);
  u = (u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u;
  memcpy(&x, &u, 4);
  return x;
#endif
}

// The ray operand [d | o' x d | o' | 1] in the coordinates of a cluster with
// center c (o' = o - c, o' x d = o x d - c x d), split into bf16 hi and f32
// lo parts after the shift (bounce_clustered._operand).
RT_HD void make_operand(V3 d, V3 oxd, V3 o, V3 c, float* hi, float* lo) {
  const float cxd0 = c.y * d.z - c.z * d.y;
  const float cxd1 = c.z * d.x - c.x * d.z;
  const float cxd2 = c.x * d.y - c.y * d.x;
  const float op[9] = {d.x, d.y, d.z, oxd.x - cxd0, oxd.y - cxd1,
                       oxd.z - cxd2, o.x - c.x, o.y - c.y, o.z - c.z};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    hi[k] = bf16_round(op[k]);
    lo[k] = op[k] - hi[k];
  }
  hi[9] = 1.0f;
  lo[9] = 0.0f;
}

// The per-row kernels' operand (K6 and K7, cluster_rows.cu;
// bounce_clustered._operand_rows): the origin is shifted first
// (o' = o - c) and o' x d is taken of the shifted origin, where
// make_operand shifts the global o x d.
RT_HD void make_operand_rows(V3 d, V3 o, V3 c, float* hi, float* lo) {
  const float ox = o.x - c.x, oy = o.y - c.y, oz = o.z - c.z;
  const float op[9] = {d.x, d.y, d.z, oy * d.z - oz * d.y, oz * d.x - ox * d.z,
                       ox * d.y - oy * d.x, ox, oy, oz};
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    hi[k] = bf16_round(op[k]);
    lo[k] = op[k] - hi[k];
  }
  hi[9] = 1.0f;
  lo[9] = 0.0f;
}

// The ray operand in an instance's object frame: rows 0..8 of
// M10 @ [d, o x d, o, 1], each row summed over the ten columns in order
// (bounce_clustered.object_operand). The object direction is not
// normalised, so t stays the world ray parameter.
RT_HD void xform_operand(const float* m, V3 d, V3 oxd, V3 o, V3& d_o,
                         V3& oxd_o, V3& o_o) {
  const float b[10] = {d.x, d.y, d.z, oxd.x, oxd.y, oxd.z, o.x, o.y, o.z, 1.0f};
  float r[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    float acc = m[k * 10] * b[0];
#pragma unroll
    for (int j = 1; j < 10; ++j) acc = acc + m[k * 10 + j] * b[j];
    r[k] = acc;
  }
  d_o = v3(r[0], r[1], r[2]);
  oxd_o = v3(r[3], r[4], r[5]);
  o_o = v3(r[6], r[7], r[8]);
}

// One quantity of triangle lane `lane` against the operand, over the
// coefficient rows k0..k0+NK-1: c_hi*r_hi, then c_hi*r_lo, then c_lo*r_hi,
// summed left to right (bounce_clustered._quantities, Q_ROWS).
template <int K0, int NK>
RT_HD float quantity(const float* blk, int lane, const float* hi, const float* lo) {
  float acc = blk[K0 * LANES + lane] * hi[K0];
#pragma unroll
  for (int k = K0 + 1; k < K0 + NK; ++k) acc = acc + blk[k * LANES + lane] * hi[k];
#pragma unroll
  for (int k = K0; k < K0 + NK; ++k) acc = acc + blk[k * LANES + lane] * lo[k];
#pragma unroll
  for (int k = K0; k < K0 + NK; ++k) acc = acc + blk[(10 + k) * LANES + lane] * hi[k];
  return acc;
}

// |det|, u, v, t numerators of triangle j, signed so that |det| >= 0.
struct Quant {
  float absd, su, sv, st;
};

// The four quantities signed by det's sign (bounce_clustered._signed).
RT_HD Quant signed_quant(float det, float un, float vn, float tn) {
  const float s = det >= 0.0f ? 1.0f : -1.0f;
  Quant q;
  q.absd = det * s;
  q.su = un * s;
  q.sv = vn * s;
  q.st = tn * s;
  return q;
}

RT_HD Quant quantities(const float* blk, int j, const float* hi, const float* lo) {
  return signed_quant(quantity<0, 3>(blk, j, hi, lo),
                      quantity<0, 6>(blk, CT + j, hi, lo),
                      quantity<0, 6>(blk, 2 * CT + j, hi, lo),
                      quantity<6, 4>(blk, 3 * CT + j, hi, lo));
}

// The micromap state of a candidate at its split-bf16 barycentrics
// u, v = clip(s / |det|, 0, 1), and whether the point lies within kEdge of
// its micro-cell's edges: K3 and K5 take such a candidate as UNKNOWN
// (bounce_clustered._micro_state_guarded; plain: micro_state_guarded).
RT_HD int guarded_state(uint32_t word, const Quant& q, bool& near) {
  const float inv_d = 1.0f / max_(q.absd, kMinDet);
  const float u = clamp_(q.su * inv_d, 0.0f, 1.0f);
  const float v = clamp_(q.sv * inv_d, 0.0f, 1.0f);
  const float uu = u * 4.0f, vv = v * 4.0f;
  const float du = uu - min_(floorf(uu), 3.0f);
  const float dv = vv - min_(floorf(vv), 3.0f);
  near = du < kEdge || du > kEdgeHi || dv < kEdge || dv > kEdgeHi ||
         fabsf(du + dv - 1.0f) < kEdge;
  return micro_state(word, micro_index(u, v));
}

// One candidate of the closest-hit selection: triangle j with the signed
// quantities q. It is valid inside the conservative edge margins at
// 0 < t < max_travel; strictly-inside candidates win ties over margin-only
// ones (tie bump); it replaces (t_c, j_c, unk_c) when valid and t < t_c, so
// a scan in increasing j keeps the lowest index on ties. With `words` (the
// block's micromap words), a micro-TRANSPARENT candidate is rejected unless
// near a cell edge, and unk_c flags a winner on an UNKNOWN or near-edge
// cell. Divide: t = t_num / |det| (K6, `_kernel_a`) instead of
// t_num * (1 / |det|) (K3, `_kernel_a1`). t is only computed for a valid
// candidate: an invalid one can never win.
template <bool Divide = false>
RT_HD void consider(const Quant& q, int j, float max_travel, const int* words,
                    float& t_c, int& j_c, bool& unk_c) {
  const float mm = kMargin * q.absd;
  bool valid = q.absd > kMinDet && q.su >= -mm && q.sv >= -mm &&
               q.su + q.sv <= q.absd + mm + mm && q.st > 0.0f &&
               q.st < max_travel * q.absd;
  if (!valid) return;
  const bool strict = q.su >= 0.0f && q.sv >= 0.0f && q.su + q.sv <= q.absd;
  float tt = Divide ? q.st / max_(q.absd, kMinDet)
                    : q.st * (1.0f / max_(q.absd, kMinDet));
  tt = tt * (strict ? 1.0f : kTieScale);
  bool unk = false;
  if (words != nullptr) {
    bool near;
    const int st = guarded_state((uint32_t)words[j], q, near);
    valid = st != MICRO_TRANSPARENT || near;
    unk = st == MICRO_UNKNOWN || near;
  }
  if (valid && tt < t_c) {
    t_c = tt;
    j_c = j;
    unk_c = unk;
  }
}

// Closest split-bf16 hit in one staged block (the per-row K6): `consider`
// over its 128 triangles in order. t_c = kBigT when nothing is valid.
template <bool Divide = false>
RT_HD void closest_in_block(const float* blk, const float* hi, const float* lo,
                            float max_travel, float& t_c, int& j_c,
                            const int* words, bool& unk_c) {
  t_c = kBigT;
  j_c = 0;
  unk_c = false;
  for (int j = 0; j < CT; ++j)
    consider<Divide>(quantities(blk, j, hi, lo), j, max_travel, words, t_c, j_c,
                     unk_c);
}

// Whether triangle j with the signed quantities q occludes: strictly inside
// (no margins) at 0 < t < dist. With `words` (the block's micromap words)
// and `cover` (their coverages), a micro-TRANSPARENT candidate never
// occludes unless near a cell edge, and an UNKNOWN or near-edge one where
// u_alpha < its coverage.
RT_HD bool occludes(const Quant& q, int j, float dist, const int* words,
                    const float* cover, float u_alpha) {
  if (!(q.absd > kMinDet && q.su >= 0.0f && q.sv >= 0.0f &&
        q.su + q.sv <= q.absd && q.st > 0.0f && q.st < dist * q.absd))
    return false;
  if (words != nullptr) {
    bool near;
    const int st = guarded_state((uint32_t)words[j], q, near);
    if (st == MICRO_TRANSPARENT && !near) return false;
    if ((st == MICRO_UNKNOWN || near) && !(u_alpha < cover[j])) return false;
  }
  return true;
}

// Any triangle of the staged block that occludes (`occludes`, in increasing
// j). Adds the triangles tested (up to and including the first occluder) to
// `tested`.
RT_HD bool occluded_in_block(const float* blk, const float* hi, const float* lo,
                             float dist, int& tested, const int* words,
                             const float* cover, float u_alpha) {
  for (int j = 0; j < CT; ++j) {
    if (occludes(quantities(blk, j, hi, lo), j, dist, words, cover, u_alpha)) {
      tested += j + 1;
      return true;
    }
  }
  tested += CT;
  return false;
}

// Exact f32 refit of the winner (bounce_clustered._refit). v0, e1, e2 are
// cluster-local, o_local = o - center. Writes t (kBigT unless hit), u, v,
// det and returns whether the refit accepts the hit.
struct Refit {
  float t, u, v, det;
  bool ok;
};

RT_HD Refit refit(V3 o_local, V3 d, V3 v0, V3 e1, V3 e2, float max_travel) {
  const V3 pvec = cross3(d, e2);
  const float detx = dot3(e1, pvec);
  const bool ok = fabsf(detx) > kMinDet;
  const float inv = ok ? 1.0f / detx : 0.0f;
  const V3 tvec = o_local - v0;
  float u = dot3(tvec, pvec) * inv;
  const V3 qvec = cross3(tvec, e1);
  float v = dot3(d, qvec) * inv;
  const float tx = dot3(e2, qvec) * inv;
  Refit r;
  r.ok = ok && u >= kRefitLo && v >= kRefitLo && u + v <= kRefitHi &&
         tx > 0.0f && tx < max_travel;
  u = clamp_(u, 0.0f, 1.0f);
  v = clamp_(v, 0.0f, 1.0f);
  const float scale = 1.0f / max_(u + v, 1.0f);
  r.u = u * scale;
  r.v = v * scale;
  r.t = tx;
  r.det = detx;
  return r;
}

}  // namespace cl
}  // namespace rt
