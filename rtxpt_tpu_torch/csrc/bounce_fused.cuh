// One bounce of one ray: closest hit, surface fetch, emissive MIS, NEE with
// its shadow ray, BSDF scatter and Russian roulette. The per-thread body of
// the fused bounce kernel (bounce_fused.cu); the plain version of the same
// function is rtxpt_tpu_torch/pt/bounce_fused.py::bounce_reference, and the
// TPU original is rtxpt_tpu/pt/bounce_pallas.py::_bounce_kernel with
// surface_and_shade in the reference-mode configuration (no split
// channels, no injection), with NEE in the kernel
// (modes 1, 2) or exported for external NEE (modes 3-5: the SF_* surface
// rows; the shadow rays are then resolved by K2, shadow_occlusion.cu).
// With the environment table (Tables::env) a miss gathers the environment
// with its MIS weight, the environment light is importance-sampled from
// the table's two-level CDF, and the final environment-only round
// (Config::final_env) closes the path. The texture switch is the template
// parameter HasTex (bounce_pallas.py:1051-1125): the base-colour,
// metal-rough, emissive and normal maps that Tables::tex_maps names, one
// stochastic texel each (tex_fetch, bounce_pallas._tex_fetch_w), so the
// untextured instantiation keeps its registers. The opacity-micromap switch
// is the template parameter HasOmm (bounce_pallas.py:587-698, :1078-1160,
// :1350-1365): the closest hit rejects micro-TRANSPARENT candidates and
// flags an UNKNOWN winner, whose base alpha at MIP 0 then decides whether
// the lane passes through; the shadow ray's UNKNOWN candidates occlude
// where the lane's alpha uniform is under the triangle's coverage. The
// nested-priority switch is the template parameter HasPrio
// (bounce_pallas.py:1138-1156, :1350-1362): a hit on a lower-priority
// medium's boundary inside a higher one, or on the back of a medium the
// ray is not in, is a false hit; the interior list's lower slot (med1)
// records it and the lane passes through as on a failed alpha test. The
// split-channel switch is the template parameter HasSplit
// (bounce_pallas.py:987-1008, :1211-1215, :1281-1287, :1309-1313, and the
// fs2 rows at :1401-1422, :1501-1504, :1543-1545, :1568-1570): NRD's
// diffuse/specular partition of the radiance, in the seven fs2 rows. The
// real-time fill's switches are the template parameter Restart of
// bounce_ray: with it, the V-buffer restart (bounce_pallas.py:1427-1442)
// takes each lane's hit from the injected rows, when given, instead of the
// intersection loop, and Config::first_direct false (bounce_pallas.py
// :980-986, :1267-1268) leaves out the environment and emission gathered at
// logical bounce 1 and NEE at logical bounce 0. Without it the code is the
// reference mode's, so those instantiations keep their registers.
#pragma once

#include "omm.cuh"
#include "rng.cuh"
#include "wide.cuh"

#ifdef __CUDACC__
#define RT_LDG(p) __ldg(p)
#else
#define RT_LDG(p) (*(p))
struct float4 {
  float x, y, z, w;
};
#endif

namespace rt {

// Row maps (rtxpt_tpu_torch/pt/bounce_fused.py)
enum { FS_O = 0, FS_D = 3, FS_THP = 6, FS_L = 9, FS_PREVPDF = 12, FS_CONE = 13,
       FS_SPREAD = 14, NF = 15 };
enum { IS_ACTIVE = 0, IS_PREVDELTA = 1, IS_MED0 = 2, IS_MED1 = 3, IS_PX = 4,
       IS_PY = 5, IS_BUDGET = 6, IS_LBOUNCE = 7, NI = 8 };
// split-channel rows: L_diff, L_spec, the first scatter's specular flag
enum { F2_LD = 0, F2_LS = 3, F2_FSPEC = 6, NF2 = 7 };
enum { AT_N0 = 0, AT_N1 = 3, AT_N2 = 6, AT_GN = 9, AT_MID = 12, AT_LPDF = 13,
       AT_LAREA = 14, AT_ISLIGHT = 15, AT_UV0 = 16, AT_UV1 = 18, AT_UV2 = 20,
       AT_LODB = 22, AT_LID = 23, AT_TANG = 24, AT_TSGN = 27, AT_ROWS = 28 };
enum { MT_BASE = 0, MT_METAL = 3, MT_ROUGH = 4, MT_IOR = 5, MT_TRANS = 6,
       MT_DTRANS = 7, MT_EMISSIVE = 8, MT_SPEC = 11, MT_THIN = 12,
       MT_VOLABS = 13, MT_EPOLY = 16, MT_EAVG = 22, MT_BTEX = 23,
       MT_MRTEX = 24, MT_ETEX = 25, MT_NTEX = 26, MT_ACUT = 27, MT_PRIO = 28 };
enum { LROW_KIND = 0, LROW_P0 = 1, LROW_P1 = 4, LROW_P2 = 7, LROW_EM = 10,
       LROW_EXTRA = 13, LROW_NORMAL = 17, LROW_POWER = 20, LROW_CDF = 21 };
enum { TC_DET = 0, TC_U = 3, TC_V = 9, TC_T = 15, TC_ROWS = 20 };
enum { EFFECT_SCATTER = 29, EFFECT_NEE = 31, EFFECT_RR = 37, EFFECT_STF = 41,
       EFFECT_ALPHA = 43 };
// texture meta row per texture (bounce_fused.py TX_*): base width, height,
// MIP count, the 14 MIP start texels; tex_maps bits: base 1, metal-rough 2,
// emissive 4, normal 8
enum { TX_W = 0, TX_H = 1, TX_NMIPS = 2, TX_OFF = 3, TX_COLS = 17 };
enum { TEX_BASE = 1, TEX_MR = 2, TEX_EMIT = 4, TEX_NORMAL = 8 };
// external-NEE surface export rows (SF_*) and shadow-request rows (SR_*)
enum { SF_POS = 0, SF_SHN = 3, SF_GN = 6, SF_MID = 9, SF_BASE = 10, SF_METAL = 13,
       SF_ROUGH = 14, SF_ETA = 15, SF_THP = 16, SF_EMIT = 19, SF_PGEO = 22,
       SF_LID = 23, SF_ROWS = 24 };
enum { SR_O = 0, SR_D = 3, SR_DIST = 6, SR_DO = 7, SR_UA = 8, SR_ROWS = 9 };
// the environment table (bounce_fused.py ET_*): [64][128] float4 texels
// (r, g, b, texel pdf), [64][128] conditional CDFs, then per row the
// marginal CDF, cos(pi i / 64) (entry 0 a pad), the texel solid angle, and
// cos / sin of the rotation and the environment light's power pmf
enum { ENV_H = 64, ENV_W = 128, ET_TEX = 0, ET_COND = ET_TEX + ENV_H * ENV_W * 4,
       ET_ROWCDF = ET_COND + ENV_H * ENV_W, ET_COSB = ET_ROWCDF + ENV_H,
       ET_SA = ET_COSB + ENV_H, ET_COS = ET_SA + ENV_H, ET_SIN = ET_COS + 1,
       ET_SELPDF = ET_COS + 2, ET_SIZE = ET_COS + 64 };
constexpr float kBig = (float)1e30;
constexpr int kLanes = 128;        // lane tables: [rows, 128]

struct Tables {
  const float* tri;     // [tpad, TC_ROWS]
  const float* attr;    // [AT_ROWS, tpad]
  const float* mat;     // [MT_ROWS, 128]
  const float* light;   // [LROWS, 128]
  const float* env;     // [ET_SIZE], or null without an environment light
  const float4* tex;    // [texels] RGBA atlas, or null (untextured variant)
  const int* tex_meta;  // [n_tex, TX_COLS]
  int n_tex, tex_maps;
  int n_tris, tpad, n_lights;
  const int* micro;     // [tpad] micromap words (u32 bits), or null
  const float* cover;   // [tpad] unknown-cell coverages
};

struct Config {
  uint32_t sample_idx;
  int nee_mode;         // 0 off | 1 uniform | 2 power | 3 NEE-AT |
                        // 4 uniform-external | 5 power-external
  bool enable_mis;
  float firefly;
  bool rr_enable;
  int min_rr;
  float max_travel;
  bool low_discrepancy;
  bool energy_comp;
  int maxb;
  bool final_env;       // the final environment-only round
  bool first_direct;    // false: the caller shades the first vertex's
                        // direct light (the stable-planes fill under an
                        // external direct-light pass)
};

struct Hit {
  float t, u, v, det;
  int prim;
  bool unk;             // the winner's micro-triangle is UNKNOWN (HasOmm)
};

// Triangle j against the ray [d | o x d | o | 1], summed in the plain
// version's order (bounce_fused._tri_params).
RT_HD bool tri_test(const float* c, V3 o, V3 d, V3 x, float& u, float& v, float& t,
                    float& det) {
  det = RT_LDG(c + TC_DET) * d.x + RT_LDG(c + TC_DET + 1) * d.y +
        RT_LDG(c + TC_DET + 2) * d.z;
  float un = RT_LDG(c + TC_U) * d.x + RT_LDG(c + TC_U + 1) * d.y +
             RT_LDG(c + TC_U + 2) * d.z + RT_LDG(c + TC_U + 3) * x.x +
             RT_LDG(c + TC_U + 4) * x.y + RT_LDG(c + TC_U + 5) * x.z;
  float vn = RT_LDG(c + TC_V) * d.x + RT_LDG(c + TC_V + 1) * d.y +
             RT_LDG(c + TC_V + 2) * d.z + RT_LDG(c + TC_V + 3) * x.x +
             RT_LDG(c + TC_V + 4) * x.y + RT_LDG(c + TC_V + 5) * x.z;
  float tn = RT_LDG(c + TC_T) * o.x + RT_LDG(c + TC_T + 1) * o.y +
             RT_LDG(c + TC_T + 2) * o.z + RT_LDG(c + TC_T + 3);
  bool ok = fabsf(det) > (float)1e-12;
  float inv = ok ? 1.0f / det : 0.0f;
  u = un * inv;
  v = vn * inv;
  t = tn * inv;
  return ok && u >= 0.0f && v >= 0.0f && u + v <= 1.0f && t > 0.0f;
}

// The micromap state of triangle j at its candidate barycentrics.
RT_HD int tri_micro_state(const Tables& tb, int j, float u, float v) {
  return micro_state((uint32_t)RT_LDG(tb.micro + j), micro_index(u, v));
}

// Closest hit over every triangle; strict `<` keeps the lowest index on ties
// (bounce_pallas._intersect_group). HasOmm: micro-TRANSPARENT candidates are
// rejected, and the winner's UNKNOWN state is kept.
template <bool HasOmm>
RT_HD Hit intersect(const Tables& tb, V3 o, V3 d, float tmax) {
  Hit h;
  h.t = kBig; h.u = 0.0f; h.v = 0.0f; h.det = 0.0f; h.prim = -1; h.unk = false;
  V3 x = cross3(o, d);
  for (int j = 0; j < tb.n_tris; ++j) {
    float u, v, t, det;
    bool ok = tri_test(tb.tri + j * TC_ROWS, o, d, x, u, v, t, det);
    if (ok && t < tmax && t < h.t) {
      int st = MICRO_OPAQUE;
      if constexpr (HasOmm) {
        st = tri_micro_state(tb, j, u, v);
        if (st == MICRO_TRANSPARENT) continue;
      }
      h.t = t; h.u = u; h.v = v; h.det = det; h.prim = j;
      h.unk = st == MICRO_UNKNOWN;
    }
  }
  return h;
}

// Any hit in (0, tmax) (bounce_pallas._occluded_group); `tested` counts the
// ray-triangle pairs tested, up to and including the first occluder. HasOmm:
// a micro-TRANSPARENT candidate never occludes, an UNKNOWN one where
// u_alpha < the triangle's coverage.
template <bool HasOmm>
RT_HD bool occluded(const Tables& tb, V3 o, V3 d, float tmax, float u_alpha, int& tested) {
  V3 x = cross3(o, d);
  for (int j = 0; j < tb.n_tris; ++j) {
    float u, v, t, det;
    ++tested;
    if (tri_test(tb.tri + j * TC_ROWS, o, d, x, u, v, t, det) && t < tmax) {
      if constexpr (HasOmm) {
        const int st = tri_micro_state(tb, j, u, v);
        if (st == MICRO_TRANSPARENT) continue;
        if (st == MICRO_UNKNOWN && !(u_alpha < RT_LDG(tb.cover + j))) continue;
      }
      return true;
    }
  }
  return false;
}

template <bool HasOmm>
RT_HD bool occluded(const Tables& tb, V3 o, V3 d, float tmax, float u_alpha) {
  int tested = 0;
  return occluded<HasOmm>(tb, o, d, tmax, u_alpha, tested);
}

RT_HD V3 ray_offset(V3 pos, V3 gn, V3 dir) {
  float mag = sqrtf(max_(dot3(pos, pos), 0.0f));
  float scale = max_(mag, 1.0f) * (float)3e-5;
  float side = dot3(dir, gn) >= 0.0f ? 1.0f : -1.0f;
  return pos + gn * (side * scale);
}

RT_HD float lane(const float* table, int row, int col) {
  return RT_LDG(table + row * kLanes + col);
}
RT_HD V3 lane3(const float* table, int row, int col) {
  return v3(lane(table, row, col), lane(table, row + 1, col), lane(table, row + 2, col));
}

// First index with cdf[i] >= u over the 128-lane CDF (pads are 1.0).
RT_HD int searchsorted128(const float* cdf, float u) {
  int lo = 0;
  for (int bit = 64; bit >= 1; bit >>= 1) {
    int probe = lo + bit - 1;
    probe = probe < 0 ? 0 : (probe > 127 ? 127 : probe);
    lo += RT_LDG(cdf + probe) < u ? bit : 0;
  }
  return lo < 0 ? 0 : (lo > 127 ? 127 : lo);
}

RT_HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }

// ----- the environment (bounce_pallas.py:721-875; plain versions
// bounce_fused.py atan2_poly, env_texel_of_dir, env_eval_pdf, env_sample_k)

RT_HD float minimum_(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

// atan2(z, x) by the JAX kernels' minimax polynomial (|err| < 2e-5 rad).
RT_HD float atan2_poly(float z, float x) {
  float ax = fabsf(x), az = fabsf(z);
  float mx = maximum_(ax, az), mn = minimum_(ax, az);
  float t = mn / max_(mx, (float)1e-30);
  float t2 = t * t;
  float p = t * ((float)0.99997726 + t2 * ((float)-0.33262347 + t2 * (
      (float)0.19354346 + t2 * ((float)-0.11643287 + t2 * (
          (float)0.05265332 - t2 * (float)0.01172120)))));
  p = az > ax ? (float)(0.5 * 3.141592653589793) - p : p;
  p = x < 0.0f ? kPi - p : p;
  return z < 0.0f ? -p : p;
}

// #{i : cdf[i] <= u} over a non-decreasing CDF of n = 2^k entries: the
// binary search takes the count's side of a tie.
RT_HD int count_le(const float* cdf, int n, float u) {
  int lo = 0;
  for (int bit = n >> 1; bit >= 1; bit >>= 1)
    lo += RT_LDG(cdf + lo + bit - 1) <= u ? bit : 0;
  return lo + (lo == n - 1 && RT_LDG(cdf + n - 1) <= u ? 1 : 0);
}

struct EnvTexel {
  V3 L;
  float pdf;    // the texel's selection pmf
};

RT_HD EnvTexel env_texel(const float* env, int yi, int xi) {
  const float4* tex = reinterpret_cast<const float4*>(env + ET_TEX);
  float4 v = RT_LDG(tex + yi * ENV_W + xi);
  EnvTexel e;
  e.L = v3(v.x, v.y, v.z);
  e.pdf = v.w;
  return e;
}

// The texel of direction d: the row counts the boundaries cos(pi i / 64) at
// or above d.y (no acos), the column is the polynomial atan2's.
RT_HD void env_texel_of_dir(const float* env, V3 d, int& yi, int& xi) {
  int cnt = 0;
  for (int i = 1; i < ENV_H; ++i) cnt += d.y <= RT_LDG(env + ET_COSB + i) ? 1 : 0;
  yi = clampi(cnt, 0, ENV_H - 1);
  float c = RT_LDG(env + ET_COS), s = RT_LDG(env + ET_SIN);
  float xr = c * d.x + s * d.z;
  float zr = -s * d.x + c * d.z;
  float u = atan2_poly(zr, xr) * (float)(1.0 / (2.0 * 3.141592653589793));
  u = u - floorf(u);
  xi = clampi((int)(u * (float)ENV_W), 0, ENV_W - 1);
}

// The radiance of direction d and the NEE pdf of sampling it (selection pmf,
// 1 / n_lights when uniform, times the texel pdf over its solid angle).
RT_HD EnvTexel env_eval_pdf(const float* env, V3 d, bool nee_uniform, int n_lights) {
  int yi, xi;
  env_texel_of_dir(env, d, yi, xi);
  EnvTexel e = env_texel(env, yi, xi);
  float sel = nee_uniform ? (float)(1.0 / (double)(n_lights > 1 ? n_lights : 1))
                          : RT_LDG(env + ET_SELPDF);
  e.pdf = sel * e.pdf / RT_LDG(env + ET_SA + yi);
  return e;
}

struct EnvSample {
  V3 wi, L;
  float pdf;    // solid-angle pdf of the texel CDF (no selection pmf)
};

// Importance sample: u1 picks the row by the marginal CDF, u2 the column by
// the row's conditional CDF, the rescaled residues jitter in the texel.
RT_HD EnvSample env_sample(const float* env, float u1, float u2) {
  u1 = clamp_(u1, 0.0f, (float)(1.0 - 1e-7));
  u2 = clamp_(u2, 0.0f, (float)(1.0 - 1e-7));
  const float* rowcdf = env + ET_ROWCDF;
  int yi = clampi(count_le(rowcdf, ENV_H, u1), 0, ENV_H - 1);
  float c_lo = yi > 0 ? RT_LDG(rowcdf + yi - 1) : 0.0f;
  float c_hi = RT_LDG(rowcdf + yi);
  float jv = clamp_((u1 - c_lo) / max_(c_hi - c_lo, (float)1e-12), 0.0f,
                    (float)(1.0 - 1e-6));
  const float* cond = env + ET_COND + yi * ENV_W;
  int xi = clampi(count_le(cond, ENV_W, u2), 0, ENV_W - 1);
  float d_lo = xi > 0 ? RT_LDG(cond + xi - 1) : 0.0f;
  float d_hi = RT_LDG(cond + xi);
  float ju = clamp_((u2 - d_lo) / max_(d_hi - d_lo, (float)1e-12), 0.0f,
                    (float)(1.0 - 1e-6));
  float u = ((float)xi + ju) * (float)(1.0 / ENV_W);
  float v = ((float)yi + jv) * (float)(1.0 / ENV_H);
  float phi = u * (float)(2.0 * 3.141592653589793);
  float theta = v * kPi;
  float st = sinf(theta);
  float x = st * cosf(phi);
  float z = st * sinf(phi);
  float y = cosf(theta);
  float c = RT_LDG(env + ET_COS), s = RT_LDG(env + ET_SIN);
  EnvTexel e = env_texel(env, yi, xi);
  EnvSample es;
  es.wi = v3(c * x - s * z, y, s * x + c * z);
  es.L = e.L;
  es.pdf = e.pdf / RT_LDG(env + ET_SA + yi);
  return es;
}

// ----- the stochastic texel fetch (bounce_pallas._tex_fetch_w; plain
// version bounce_fused.tex_fetch): the level floor(mip + ju0) clipped to the
// texture's MIPs, the level's size max(floor(w 2^-level + 0.5), 1), the uv
// jittered by (ju - 0.5) / size and wrapped, one texel; white for tid < 0.
RT_HD float4 tex_fetch(const Tables& tb, int tid, float uv_u, float uv_v, float mip,
                       float ju0, float ju1) {
  float4 c;
  if (tid < 0) {
    c.x = c.y = c.z = c.w = 1.0f;
    return c;
  }
  const int* m = tb.tex_meta + clampi(tid, 0, tb.n_tex - 1) * TX_COLS;
  int level = (int)floorf(mip + ju0);
  level = level < 0 ? 0 : level;
  const int top = RT_LDG(m + TX_NMIPS) - 1;
  level = level > top ? top : level;
  const float p2 = ldexpf(1.0f, -level);              // 2^-level, exact
  const float wl = max_(floorf((float)RT_LDG(m + TX_W) * p2 + 0.5f), 1.0f);
  const float hl = max_(floorf((float)RT_LDG(m + TX_H) * p2 + 0.5f), 1.0f);
  float u = uv_u + (ju0 - 0.5f) / wl;
  float v = uv_v + (ju1 - 0.5f) / hl;
  u = u - floorf(u);
  v = v - floorf(v);
  const int wi = (int)wl, hi = (int)hl;
  const int xi = clampi((int)(u * wl), 0, wi - 1);
  const int yi = clampi((int)(v * hl), 0, hi - 1);
  return RT_LDG(tb.tex + RT_LDG(m + TX_OFF + level) + yi * wi + xi);
}

// The split channels of one ray (its fs2 column): the diffuse and specular
// radiance so far and the first scatter's specular flag; surface_and_shade
// leaves the NEE contribution's diffuse part in cdiff.
struct Split {
  V3 ld, ls, cdiff;
  float fspec;
};

RT_HD Split load_split(int i, int n, const float* __restrict__ fs2) {
  auto F = [&](int r) { return fs2[r * n + i]; };
  Split sp;
  sp.ld = v3(F(F2_LD), F(F2_LD + 1), F(F2_LD + 2));
  sp.ls = v3(F(F2_LS), F(F2_LS + 1), F(F2_LS + 2));
  sp.fspec = F(F2_FSPEC);
  sp.cdiff = splat(0.0f);
  return sp;
}

RT_HD void store_split(int i, int n, const Split& sp, float* __restrict__ fs2_out) {
  float* fo = fs2_out + i;
  fo[(F2_LD + 0) * n] = sp.ld.x; fo[(F2_LD + 1) * n] = sp.ld.y; fo[(F2_LD + 2) * n] = sp.ld.z;
  fo[(F2_LS + 0) * n] = sp.ls.x; fo[(F2_LS + 1) * n] = sp.ls.y; fo[(F2_LS + 2) * n] = sp.ls.z;
  fo[F2_FSPEC * n] = sp.fspec;
}

// A contribution c whose diffuse part is cd, split into the channels.
RT_HD void split_add(Split& sp, V3 cd, V3 c) {
  sp.ld = sp.ld + cd;
  sp.ls = sp.ls + (c - cd);
}

// Per-ray wavefront state (the FS_* / IS_* rows of one column).
struct RayState {
  V3 o, d, thp, L;
  float prev_pdf, cone, spread;
  bool active, prev_delta;
  int med0, med1, px, py, budget, lb;
};

// What surface_and_shade leaves for its caller: the pending NEE shadow ray
// and, with micromaps, the lane's alpha uniform for its test.
struct ShadowRay {
  bool do_nee;
  V3 o, d, contrib;
  float dist;
  float u_alpha;
};

// The shaded surface that the external modes export (the SF_* rows) and
// whether the lane was shaded.
struct SurfRows {
  V3 pos, sh_n, gn, base, thp, emit;
  float mid, metal, rough, eta, p_geo, lid;
  bool shaded;
};

RT_HD RayState load_state(int i, int n, const float* __restrict__ fs,
                          const int* __restrict__ is) {
  auto F = [&](int r) { return fs[r * n + i]; };
  auto I = [&](int r) { return is[r * n + i]; };
  RayState s;
  s.o = v3(F(FS_O), F(FS_O + 1), F(FS_O + 2));
  s.d = v3(F(FS_D), F(FS_D + 1), F(FS_D + 2));
  s.thp = v3(F(FS_THP), F(FS_THP + 1), F(FS_THP + 2));
  s.L = v3(F(FS_L), F(FS_L + 1), F(FS_L + 2));
  s.prev_pdf = F(FS_PREVPDF);
  s.cone = F(FS_CONE);
  s.spread = F(FS_SPREAD);
  s.active = I(IS_ACTIVE) > 0;
  s.prev_delta = I(IS_PREVDELTA) > 0;
  s.med0 = I(IS_MED0);
  s.med1 = I(IS_MED1);
  s.px = I(IS_PX);
  s.py = I(IS_PY);
  s.budget = I(IS_BUDGET);
  s.lb = I(IS_LBOUNCE);
  return s;
}

RT_HD void store_state(int i, int n, const RayState& s, float* __restrict__ fs_out,
                       int* __restrict__ is_out) {
  float* fo = fs_out + i;
  fo[(FS_O + 0) * n] = s.o.x; fo[(FS_O + 1) * n] = s.o.y; fo[(FS_O + 2) * n] = s.o.z;
  fo[(FS_D + 0) * n] = s.d.x; fo[(FS_D + 1) * n] = s.d.y; fo[(FS_D + 2) * n] = s.d.z;
  fo[(FS_THP + 0) * n] = s.thp.x; fo[(FS_THP + 1) * n] = s.thp.y; fo[(FS_THP + 2) * n] = s.thp.z;
  fo[(FS_L + 0) * n] = s.L.x; fo[(FS_L + 1) * n] = s.L.y; fo[(FS_L + 2) * n] = s.L.z;
  fo[FS_PREVPDF * n] = s.prev_pdf;
  fo[FS_CONE * n] = s.cone;
  fo[FS_SPREAD * n] = s.spread;
  int* io = is_out + i;
  io[IS_ACTIVE * n] = s.active ? 1 : 0;
  io[IS_PREVDELTA * n] = s.prev_delta ? 1 : 0;
  io[IS_MED0 * n] = s.med0;
  io[IS_MED1 * n] = s.med1;
  io[IS_PX * n] = s.px;
  io[IS_PY * n] = s.py;
  io[IS_BUDGET * n] = s.budget;
  io[IS_LBOUNCE * n] = s.lb;
}

// Post-intersection bounce body (bounce_pallas.surface_and_shade; plain
// version bounce_fused.surface_and_shade): surface fetch, volume absorption,
// emissive-hit MIS, one NEE light sample + BSDF eval, BSDF scatter, medium
// stack, Russian roulette. Advances `s` to the next bounce and returns the
// shadow ray; the caller resolves its occlusion and adds `contrib`. In the
// external modes (3-5) there is no shadow ray: the surface goes to `sf`
// instead, and in mode 3 (NEE-AT) the emission too, unweighted.
// `A(r)` fetches the hit's attribute row r (AT_*): K1 reads the attribute
// table by prim, K4 (cluster_shade.cu) reads K3's HA rows. HasTex: the
// texture switch, after the ray cone's update (the tables' atlas). HasOmm:
// the alpha uniform is drawn, and with the base-colour map on an UNKNOWN
// hit (h.unk) whose MIP-0 base alpha is under the material's cutoff passes
// through: not shaded, its path state kept, the same ray continued from
// just past the surface (plain version: passthru). HasPrio: a priority
// false hit (a boundary of a non-thin transmissive material that enters a
// medium of lower priority than med0's, or leaves a medium other than
// med0) updates med1 (the entered medium if it outranks med1's, -1 if the
// left one is med1) and passes through the same way; Beer-Lambert over the
// skipped segment still applies, as the kept throughput is taken after it.
// HasSplit (`sp`, the ray's split channels): the environment of a miss and
// the emission after the first vertex go to the first scatter's channel
// (sp->fspec), the NEE contribution's diffuse part goes to sp->cdiff (its
// exact lobe share, bsdf_eval_split over bsdf_eval after the firefly clamp,
// at logical bounce 0; the first scatter's channel after), and the scatter
// of a shaded lane at logical bounce 0 sets sp->fspec.
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit, class AttrFetch,
          bool ReadsFirstDirect = false>
RT_HD ShadowRay surface_and_shade(RayState& s, const Hit& h, const AttrFetch& A,
                                  const Tables& tb, const Config& cfg,
                                  SurfRows* sf = nullptr, Split* sp = nullptr) {
  const int mode = cfg.nee_mode;
  const bool use_nee = (mode == 1 || mode == 2) && tb.n_lights > 0;
  const bool ext_nee = (mode >= 3 && mode <= 5) && tb.n_lights > 0;
  const bool nee_uniform = mode == 1 || mode == 4;
  // emissive-hit MIS with the baked per-triangle selection pdf: every mode
  // but NEE-AT, whose mixture pmf lives in the external tile state
  const bool em_mis = (mode == 1 || mode == 2 || mode == 4 || mode == 5) && tb.n_lights > 0;
  const V3 d = s.d;
  const float t = h.t;
  const bool hit = t < kBig;
  const bool front = h.det > 0.0f;
  const float bu = h.u, bv = h.v;
  auto A3 = [&](int r) { return v3(A(r), A(r + 1), A(r + 2)); };
  const int lb = s.lb;

  uint32_t seed_base = hash_combine(hash_combine((uint32_t)s.px, (uint32_t)s.py), (uint32_t)lb);
  // the emission and environment that count: all, or without the first
  // vertex's direct light not those gathered at logical bounce 1
  // (K1's restart instantiations read Config::first_direct; the others, K4
  // and K6 always shade it)
  const bool first_direct = !ReadsFirstDirect || cfg.first_direct;
  const bool em_gate = first_direct || lb != 1;
  if (tb.env != nullptr && s.active && !hit && em_gate) {
    // HandleMiss: the environment, weighted against its NEE pdf
    EnvTexel e = env_eval_pdf(tb.env, d, nee_uniform, tb.n_lights);
    float w_env = 1.0f;
    if ((use_nee || ext_nee) && cfg.enable_mis)
      w_env = (s.prev_delta || lb == 0) ? 1.0f : power_heuristic(s.prev_pdf, e.pdf);
    const V3 c_env = s.thp * e.L * w_env;
    s.L = s.L + c_env;
    if constexpr (HasSplit) split_add(*sp, sp->fspec > 0.5f ? splat(0.0f) : c_env, c_env);
  }
  bool hit_mask = s.active && hit;
  bool active = s.active && hit;                 // miss terminates
  bool not_expired = (lb < s.budget) && (lb < cfg.maxb);
  active = active && not_expired;
  hit_mask = hit_mask && not_expired;

  V3 pos = s.o + t * d;
  V3 gn = A3(AT_GN);
  gn = front ? gn : -gn;
  V3 n0 = A3(AT_N0), n1 = A3(AT_N1), n2 = A3(AT_N2);
  float bw = 1.0f - bu - bv;
  V3 sh_n = normalize3(bw * n0 + bu * n1 + bv * n2);
  sh_n = dot3(sh_n, gn) > 0.0f ? sh_n : -sh_n;
  int mid = clampi((int)A(AT_MID), 0, 127);

  const float* mt = tb.mat;
  V3 base_color = lane3(mt, MT_BASE, mid);
  float metallic = lane(mt, MT_METAL, mid);
  float roughness = lane(mt, MT_ROUGH, mid);
  float transmission = lane(mt, MT_TRANS, mid);
  float dtrans = lane(mt, MT_DTRANS, mid);
  V3 emissive = lane3(mt, MT_EMISSIVE, mid);
  float spec_scale = lane(mt, MT_SPEC, mid);
  bool thin = lane(mt, MT_THIN, mid) > 0.5f;
  float ior = lane(mt, MT_IOR, mid);

  s.cone = s.cone + s.spread * (hit ? t : 0.0f);
  float base_alpha0 = 1.0f;
  if constexpr (HasTex) {
    // every lane fetches, as the plain version does (its SF_* export of a
    // lane that is not shaded reads the same values)
    const float uv_u = bw * A(AT_UV0) + bu * A(AT_UV1) + bv * A(AT_UV2);
    const float uv_v = bw * A(AT_UV0 + 1) + bu * A(AT_UV1 + 1) + bv * A(AT_UV2 + 1);
    const float mip = 0.5f * log2f(max_(s.cone * s.cone, (float)1e-30)) + A(AT_LODB);
    Sampler stx(hash_combine(seed_base, EFFECT_STF), cfg.sample_idx, cfg.low_discrepancy);
    const float ju0 = stx.dim(0), ju1 = stx.dim(1);
    auto tfetch = [&](int row, bool& has) {
      const int tid = (int)lane(mt, row, mid);
      has = tid >= 0;
      return tex_fetch(tb, tid, uv_u, uv_v, mip, ju0, ju1);
    };
    bool has;
    if (tb.tex_maps & TEX_BASE) {
      const float4 c = tfetch(MT_BTEX, has);
      if (has) base_color = base_color * v3(c.x, c.y, c.z);
      if constexpr (HasOmm) {
        // the alpha test reads MIP 0, as the bake does
        const float4 c0 = tex_fetch(tb, (int)lane(mt, MT_BTEX, mid), uv_u, uv_v, -100.0f,
                                    ju0, ju1);
        if (has) base_alpha0 = c0.w;
      }
    }
    if (tb.tex_maps & TEX_MR) {           // glTF: B = metallic, G = roughness
      const float4 c = tfetch(MT_MRTEX, has);
      if (has) {
        metallic = metallic * c.z;
        roughness = roughness * c.y;
      }
    }
    if (tb.tex_maps & TEX_EMIT) {
      const float4 c = tfetch(MT_ETEX, has);
      if (has) emissive = emissive * v3(c.x, c.y, c.z);
    }
    if (tb.tex_maps & TEX_NORMAL) {
      // tangent-space normal map: the baked UV tangent, Gram-Schmidt against
      // the shading normal, the perturbed normal kept in the geometric
      // hemisphere
      const float4 c = tfetch(MT_NTEX, has);
      const V3 n_ts = v3(c.x * 2.0f - 1.0f, c.y * 2.0f - 1.0f, c.z * 2.0f - 1.0f);
      const V3 tang_raw = A3(AT_TANG);
      const float tsgn = A(AT_TSGN);
      const V3 t_gs = tang_raw - sh_n * dot3(tang_raw, sh_n);
      const float tlen = sqrtf(dot3(t_gs, t_gs));
      const bool ok_t = (tsgn != 0.0f) && (tlen > (float)1e-8);
      const V3 tang = t_gs / max_(tlen, (float)1e-8);
      const V3 bitan = cross3(sh_n, tang) * tsgn;
      V3 n_pert = normalize3(n_ts.x * tang + n_ts.y * bitan + max_(n_ts.z, 0.05f) * sh_n);
      n_pert = dot3(n_pert, gn) > 0.0f ? n_pert : sh_n;
      if (has && ok_t) sh_n = n_pert;
    }
  }
  bool passthru = false;
  if constexpr (HasOmm && HasTex) {
    if (tb.tex_maps & TEX_BASE) {
      const float acut = lane(mt, MT_ACUT, mid);
      passthru = hit_mask && h.unk && acut >= 0.0f && base_alpha0 < acut;
    }
  }
  int med1 = s.med1;
  if constexpr (HasPrio) {
    auto prow = [&](int med) {
      return med >= 0 ? lane(mt, MT_PRIO, clampi(med, 0, 127)) : -1.0f;
    };
    const float p_hit = lane(mt, MT_PRIO, mid);
    const bool boundary = !thin && transmission > 0.0f;
    const bool false_enter = boundary && front && p_hit < prow(s.med0);
    const bool false_exit = boundary && !front && mid != s.med0;
    const bool prio_fh = hit_mask && (false_enter || false_exit);
    // the interior list's bookkeeping for the skipped boundary
    if (prio_fh && false_enter && (med1 < 0 || p_hit > prow(med1)))
      med1 = mid;
    else if (prio_fh && false_exit && mid == med1)
      med1 = -1;
    passthru = passthru || prio_fh;
  }
  const bool has_pass = (HasOmm && HasTex && (tb.tex_maps & TEX_BASE)) || HasPrio;
  bool hit_shade = hit_mask && !passthru;

  V3 thp = s.thp;
  float cur_ior = s.med0 >= 0 ? lane(mt, MT_IOR, clampi(s.med0, 0, 127)) : 1.0f;
  float below_ior = med1 >= 0 ? lane(mt, MT_IOR, clampi(med1, 0, 127)) : 1.0f;
  if (s.med0 >= 0) {
    V3 sigma = lane3(mt, MT_VOLABS, clampi(s.med0, 0, 127));
    thp = thp * v3(expf(-sigma.x * t), expf(-sigma.y * t), expf(-sigma.z * t));
  }

  // make_bsdf_w
  BSDF b;
  V3 f0_dielec = splat(0.08f * spec_scale);
  b.f0 = f0_dielec * (1.0f - metallic) + base_color * metallic;
  b.diffuse = base_color * (1.0f - metallic);
  float mat_ior = max_(ior, (float)(1.0 + 1e-4));
  b.eta = front ? cur_ior / mat_ior : cur_ior / max_(below_ior, 1.0f);
  b.alpha = clamp_(roughness * roughness, 0.0f, 1.0f);
  b.transmission = transmission * (1.0f - metallic);
  b.dtrans = dtrans * (1.0f - metallic);
  b.ms = cfg.energy_comp;
  for (int k = 0; k < 6; ++k) b.ep[k] = cfg.energy_comp ? lane(mt, MT_EPOLY + k, mid) : 0.0f;
  b.e_avg = cfg.energy_comp ? lane(mt, MT_EAVG, mid) : 0.0f;
  emissive = front ? emissive : splat(0.0f);

  // ----- emissive hit + MIS (baked per-triangle light pdf / area) -----
  float cos_l = fabsf(dot3(-d, gn));
  float area = max_(A(AT_LAREA), (float)1e-12);
  float p_geo = t * t / max_(area * max_(cos_l, (float)1e-9), (float)1e-12);
  float w_em = 1.0f;
  if (em_mis && cfg.enable_mis) {
    float sel_pdf_hit = nee_uniform ? A(AT_ISLIGHT) * (1.0f / (float)tb.n_lights)
                                    : A(AT_LPDF);
    float p_light = A(AT_ISLIGHT) > 0.5f ? sel_pdf_hit * p_geo : 0.0f;
    w_em = (s.prev_delta || lb == 0) ? 1.0f : power_heuristic(s.prev_pdf, p_light);
  }
  V3 em3 = splat(0.0f);
  if (mode == 3) {
    if (hit_shade && em_gate) em3 = thp * emissive;
  } else if (hit_shade && em_gate) {
    const V3 em_c = thp * emissive * w_em;
    s.L = s.L + em_c;
    // the primary vertex's emission goes to neither channel
    if constexpr (HasSplit)
      if (lb > 0) split_add(*sp, sp->fspec > 0.5f ? splat(0.0f) : em_c, em_c);
  }
  if (sf != nullptr) {
    sf->pos = pos;
    sf->sh_n = sh_n;
    sf->gn = gn;
    sf->mid = (float)mid;
    sf->base = base_color;
    sf->metal = metallic;
    sf->rough = roughness;
    sf->eta = b.eta;
    sf->thp = thp;
    sf->emit = em3;
    sf->p_geo = A(AT_ISLIGHT) > 0.5f ? p_geo : 0.0f;
    sf->lid = A(AT_LID);
    sf->shaded = hit_shade;
  }

  V3 wo = to_local3(-d, sh_n);

  // ----- NEE (one candidate) -----
  ShadowRay sr;
  sr.do_nee = false;
  sr.o = pos;
  sr.d = d;
  sr.dist = 0.0f;
  sr.contrib = splat(0.0f);
  sr.u_alpha = 0.0f;
  if constexpr (HasOmm) {
    Sampler sa(hash_combine(seed_base, EFFECT_ALPHA), cfg.sample_idx, cfg.low_discrepancy);
    sr.u_alpha = sa.dim(0);
  }
  if (use_nee) {
    Sampler sn(hash_combine(seed_base, EFFECT_NEE), cfg.sample_idx, cfg.low_discrepancy);
    float u_sel = clamp_(sn.dim(0), 0.0f, (float)(1.0 - 1e-7));
    float u1 = sn.dim(2), u2 = sn.dim(3);
    int li;
    float sel_pdf;
    if (nee_uniform) {
      li = clampi((int)(u_sel * (float)tb.n_lights), 0, tb.n_lights - 1);
      sel_pdf = (float)(1.0 / (double)tb.n_lights);
    } else {
      li = clampi(searchsorted128(tb.light + LROW_CDF * kLanes, u_sel), 0, tb.n_lights - 1);
      sel_pdf = lane(tb.light, LROW_POWER, li);
    }
    LightFields lf;
    lf.kind = (int)lane(tb.light, LROW_KIND, li);
    lf.p0 = lane3(tb.light, LROW_P0, li);
    lf.p1 = lane3(tb.light, LROW_P1, li);
    lf.p2 = lane3(tb.light, LROW_P2, li);
    lf.em = lane3(tb.light, LROW_EM, li);
    lf.extra0 = lane(tb.light, LROW_EXTRA, li);
    lf.extra1 = lane(tb.light, LROW_EXTRA + 1, li);
    lf.normal = lane3(tb.light, LROW_NORMAL, li);
    LightSample ls = sample_light(lf, sel_pdf, pos, u1, u2);
    if (tb.env != nullptr && lf.kind == KIND_ENV) {
      EnvSample es = env_sample(tb.env, u1, u2);
      ls.wi = es.wi;
      ls.dist = kDeltaDist;
      ls.Li = es.L;
      ls.pdf = sel_pdf * es.pdf;
      ls.is_delta = false;
      ls.valid = (ls.pdf > (float)1e-12) && (sel_pdf > 0.0f);
    }
    V3 wi_l = to_local3(ls.wi, sh_n);
    V3 f_l = bsdf_eval(b, wo, wi_l);
    float pdf_b = bsdf_pdf(b, wo, wi_l);
    sr.do_nee = hit_shade && ls.valid && (luminance3(f_l) > 0.0f) &&
                (first_direct || lb > 0);
    sr.o = ray_offset(pos, gn, ls.wi);
    float w_nee = 1.0f;
    if (cfg.enable_mis) w_nee = ls.is_delta ? 1.0f : power_heuristic(ls.pdf, pdf_b);
    sr.contrib = thp * f_l * ls.Li * (w_nee / max_(ls.pdf, (float)1e-12));
    if (cfg.firefly > 0.0f) {
      float lum = luminance3(sr.contrib);
      sr.contrib = sr.contrib * min_(cfg.firefly / max_(lum, (float)1e-12), 1.0f);
    }
    if constexpr (HasSplit) {
      V3 f_dp, f_sp;
      bsdf_eval_split(b, wo, wi_l, f_dp, f_sp);
      const V3 ratio = f_dp / max3_(f_l, (float)1e-12);
      sp->cdiff = lb == 0 ? sr.contrib * ratio
                          : (sp->fspec > 0.5f ? splat(0.0f) : sr.contrib);
    }
    float dist_eff = ls.dist - dot3(sr.o - pos, ls.wi);
    sr.dist = sr.do_nee ? dist_eff * (float)(1.0 - 1e-4) : 0.0f;
    sr.d = ls.wi;
  }

  // ----- scatter -----
  Sampler ss(hash_combine(seed_base, EFFECT_SCATTER), cfg.sample_idx, cfg.low_discrepancy);
  float u_lobe = ss.dim(0), su1 = ss.dim(2), su2 = ss.dim(3);
  BSDFSample bs = bsdf_sample(b, wo, u_lobe, su1, su2);
  V3 wi_world = to_world3(bs.wi, sh_n);
  if constexpr (HasSplit) {
    if (lb == 0 && hit_shade)
      sp->fspec = (bs.lobe == LOBE_SPECULAR_REFL || bs.lobe == LOBE_SPECULAR_TRANS) ? 1.0f
                                                                                    : 0.0f;
  }
  bool leak = (bs.wi.z > 0.0f) != (dot3(wi_world, gn) > 0.0f);
  active = active && (passthru || (bs.valid && !leak && (luminance3(bs.weight) > 0.0f)));
  const V3 thp_ns = thp;                       // what a pass-through lane keeps
  thp = thp * bs.weight;

  bool transmitted = bs.wi.z < 0.0f;
  bool entering = transmitted && front && !thin;
  bool exiting = transmitted && !front && !thin;
  int new_med0 = entering ? mid : (exiting ? med1 : s.med0);
  int new_med1 = entering ? s.med0 : (exiting ? -1 : med1);

  if (cfg.rr_enable) {
    Sampler srr(hash_combine(seed_base, EFFECT_RR), cfg.sample_idx, cfg.low_discrepancy);
    float u_rr = srr.dim(0);
    float p_cont = clamp_(maximum_(maximum_(thp.x, thp.y), thp.z), 0.05f, 1.0f);
    bool rr_on = lb >= cfg.min_rr && !passthru;
    active = active && !(rr_on && (u_rr >= p_cont));
    if (rr_on) thp = thp / p_cont;
  }

  s.active = active;
  s.lb = lb + (hit_shade ? 1 : 0);
  if (has_pass && passthru) {
    // continue the same ray from just past the rejected surface; the
    // scatter state does not advance
    const float t_adv = t * (float)(1.0 + 1e-4) + (float)1e-5;
    s.o = s.o + d * t_adv;
    s.thp = thp_ns;
    s.med1 = med1;
    return sr;
  }
  s.o = ray_offset(pos, gn, wi_world);
  s.d = wi_world;
  s.thp = thp;
  s.prev_pdf = bs.pdf;
  s.prev_delta = bs.is_delta;
  s.med0 = new_med0;
  s.med1 = new_med1;
  s.spread = s.spread + sqrtf(b.alpha) * 0.25f * (1.0f - (bs.is_delta ? 1.0f : 0.0f));
  return sr;
}

// The final environment-only round (bounce_fused.py final_env_state): an
// active ray that misses adds thp x the environment, weighted against the
// environment's NEE pdf when MIS is on and the NEE mode is one of
// `nee_modes` (a bit per mode: K1 1, 2, 4, 5; K4 1, 2); the ray ends.
// HasSplit: the environment goes to the first scatter's channel.
template <bool HasSplit>
RT_HD void final_env_state(RayState& s, bool hit, const Tables& tb, const Config& cfg,
                           int nee_modes, Split* sp = nullptr) {
  const bool use_nee = ((nee_modes >> cfg.nee_mode) & 1) && tb.n_lights > 0;
  if (s.active && !hit) {
    EnvTexel e = env_eval_pdf(tb.env, s.d, cfg.nee_mode == 1, tb.n_lights);
    float w_env = 1.0f;
    if (use_nee && cfg.enable_mis)
      w_env = s.prev_delta ? 1.0f : power_heuristic(s.prev_pdf, e.pdf);
    const V3 c_env = s.thp * e.L * w_env;
    s.L = s.L + c_env;
    if constexpr (HasSplit) split_add(*sp, sp->fspec > 0.5f ? splat(0.0f) : c_env, c_env);
  }
  s.active = false;
}

// The hit of ray i from the injected rows inj [5, n]: t, prim (negative: a
// miss, t = kBig), u, v, front (> 0.5: det +1, else -1); never UNKNOWN (the
// pass that built the V-buffer resolved the alpha test).
RT_HD Hit injected_hit(int i, int n, const float* __restrict__ inj) {
  Hit h;
  const float prim = RT_LDG(inj + n + i);
  const bool miss = prim < 0.0f;
  h.t = miss ? kBig : RT_LDG(inj + i);
  h.prim = miss ? -1 : (int)prim;
  h.u = RT_LDG(inj + 2 * n + i);
  h.v = RT_LDG(inj + 3 * n + i);
  h.det = RT_LDG(inj + 4 * n + i) > 0.5f ? 1.0f : -1.0f;
  h.unk = false;
  return h;
}

RT_HD void store_surf(int i, int n, const SurfRows& sf, float* __restrict__ surf_out) {
  float* so = surf_out + i;
  auto put3 = [&](int r, V3 v) {
    so[r * n] = v.x; so[(r + 1) * n] = v.y; so[(r + 2) * n] = v.z;
  };
  put3(SF_POS, sf.pos);
  put3(SF_SHN, sf.sh_n);
  put3(SF_GN, sf.gn);
  so[SF_MID * n] = sf.mid;
  put3(SF_BASE, sf.base);
  so[SF_METAL * n] = sf.metal;
  so[SF_ROUGH * n] = sf.rough;
  so[SF_ETA * n] = sf.eta;
  put3(SF_THP, sf.thp);
  put3(SF_EMIT, sf.emit);
  so[SF_PGEO * n] = sf.p_geo;
  so[SF_LID * n] = sf.lid;
}

// One bounce of ray i: closest hit, surface_and_shade, the shadow ray, and the
// state and hit rows written back ([rows, n] SoA columns). With `surf_out`
// (the external modes 3-5 with lights) the surface rows go there, no shadow
// ray is traced, and hit row 5 holds the shading flag: 0 not shaded, 1 shaded
// at logical bounce 0, 2 shaded later (bounce_pallas.py:1556-1560).
// HasSplit: the split rows fs2 in and fs2_out out ([NF2, n]); an unoccluded
// NEE contribution adds cdiff to L_diff and the rest to L_spec (in the
// external modes trace_paths_fused merges it). Restart: with `inj` ([5, n],
// or null) the closest hit is read from the injected rows (the V-buffer
// restart; one pointer for the launch, so no warp diverges on it), and
// Config::first_direct is read; without Restart `inj` is not read.
template <bool HasTex, bool HasOmm, bool HasPrio, bool HasSplit, bool Restart>
RT_HD void bounce_ray(int i, int n, const float* __restrict__ fs, const int* __restrict__ is,
                      const float* __restrict__ fs2, float* __restrict__ fs_out,
                      int* __restrict__ is_out, float* __restrict__ hit_out,
                      float* __restrict__ surf_out, float* __restrict__ fs2_out,
                      const float* __restrict__ inj, const Tables& tb,
                      const Config& cfg) {
  RayState s = load_state(i, n, fs, is);
  Split sp;
  if constexpr (HasSplit) sp = load_split(i, n, fs2);
  const int lb_in = s.lb;
  Hit h;
  if constexpr (Restart) {
    h = inj != nullptr ? injected_hit(i, n, inj) : intersect<HasOmm>(tb, s.o, s.d, cfg.max_travel);
  } else {
    h = intersect<HasOmm>(tb, s.o, s.d, cfg.max_travel);
  }
  float* ho = hit_out + i;
  ho[0] = h.t < kBig ? h.t : 0.0f;
  ho[n] = (float)h.prim;
  ho[2 * n] = h.u;
  ho[3 * n] = h.v;
  ho[4 * n] = h.det > 0.0f ? 1.0f : 0.0f;
  if (cfg.final_env) {
    final_env_state<HasSplit>(s, h.t < kBig, tb, cfg,
                              (1 << 1) | (1 << 2) | (1 << 4) | (1 << 5), &sp);
    store_state(i, n, s, fs_out, is_out);
    if constexpr (HasSplit) store_split(i, n, sp, fs2_out);
    ho[5 * n] = 0.0f;
    return;
  }
  auto attr = [&](int r) {
    return h.prim >= 0 ? RT_LDG(tb.attr + r * tb.tpad + h.prim) : 0.0f;
  };
  SurfRows sf;
  ShadowRay sr = surface_and_shade<HasTex, HasOmm, HasPrio, HasSplit, decltype(attr), Restart>(
      s, h, attr, tb, cfg, surf_out != nullptr ? &sf : nullptr, &sp);
  if (sr.do_nee && !occluded<HasOmm>(tb, sr.o, sr.d, sr.dist, sr.u_alpha)) {
    s.L = s.L + sr.contrib;
    if constexpr (HasSplit) {
      sp.ld = sp.ld + sp.cdiff;
      sp.ls = sp.ls + sr.contrib - sp.cdiff;
    }
  }
  store_state(i, n, s, fs_out, is_out);
  if constexpr (HasSplit) store_split(i, n, sp, fs2_out);
  if (surf_out != nullptr) {
    store_surf(i, n, sf, surf_out);
    ho[5 * n] = sf.shaded ? (lb_in > 0 ? 2.0f : 1.0f) : 0.0f;
  } else {
    ho[5 * n] = sr.do_nee ? 1.0f : 0.0f;
  }
}

}  // namespace rt
