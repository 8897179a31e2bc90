// Per-thread shading math (counterpart of rtxpt_tpu/pt/wide.py and
// rtxpt_tpu_torch/pt/wide.py): vec3 helpers, the StandardBSDF lobes with
// Kulla-Conty energy compensation, and the triangle / point / spot /
// directional light sample. Written once for every kernel that shades
// (the fused bounce kernel K1 and the clustered shading kernel K4).
//
// Parity rules: every expression keeps the operation order of the plain
// PyTorch version, the library is built with -fmad=false (no contraction),
// clamps propagate NaN as torch.clamp does, and a division by a constant is
// a multiply by its float reciprocal, as torch on CUDA does for a Python
// scalar divisor.
#pragma once

#include <math.h>
#include <stdint.h>

#include "rng.cuh"

namespace rt {

constexpr float kPi = (float)3.141592653589793;
constexpr float kInvPi = 1.0f / kPi;
constexpr float kTwoPi = (float)(2.0 * 3.141592653589793);
constexpr float kEps2 = (float)(1e-8 * 1e-8);
constexpr float kDeltaAlpha = (float)1e-4;
constexpr float kMinCos = (float)1e-6;
constexpr float kDeltaDist = (float)1e8;

enum { LOBE_DIFFUSE_REFL = 0, LOBE_SPECULAR_REFL = 1,
       LOBE_SPECULAR_TRANS = 2, LOBE_DIFFUSE_TRANS = 3 };
enum { KIND_TRIANGLE = 0, KIND_POINT = 1, KIND_DIRECTIONAL = 2,
       KIND_SPOT = 3, KIND_ENV = 4 };

// torch.clamp / torch.maximum semantics: NaN in, NaN out.
RT_HD float max_(float x, float lo) { return (x != x) ? x : (x > lo ? x : lo); }
RT_HD float min_(float x, float hi) { return (x != x) ? x : (x < hi ? x : hi); }
RT_HD float clamp_(float x, float lo, float hi) { return min_(max_(x, lo), hi); }
RT_HD float maximum_(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

struct V3 {
  float x, y, z;
};

RT_HD V3 v3(float x, float y, float z) { V3 r; r.x = x; r.y = y; r.z = z; return r; }
RT_HD V3 splat(float s) { return v3(s, s, s); }
RT_HD V3 operator+(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
RT_HD V3 operator-(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
RT_HD V3 operator-(V3 a) { return v3(-a.x, -a.y, -a.z); }
RT_HD V3 operator*(V3 a, V3 b) { return v3(a.x * b.x, a.y * b.y, a.z * b.z); }
RT_HD V3 operator*(V3 a, float s) { return v3(a.x * s, a.y * s, a.z * s); }
RT_HD V3 operator*(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
RT_HD V3 operator/(V3 a, float s) { return v3(a.x / s, a.y / s, a.z / s); }
RT_HD V3 operator/(V3 a, V3 b) { return v3(a.x / b.x, a.y / b.y, a.z / b.z); }
RT_HD V3 sel(bool c, V3 a, V3 b) { return c ? a : b; }
RT_HD V3 max3_(V3 a, float lo) { return v3(max_(a.x, lo), max_(a.y, lo), max_(a.z, lo)); }

RT_HD float dot3(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
RT_HD V3 cross3(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
RT_HD V3 normalize3(V3 v) {
  float inv = 1.0f / sqrtf(max_(dot3(v, v), kEps2));
  return v * inv;
}
RT_HD float luminance3(V3 c) { return c.x * 0.2126f + c.y * 0.7152f + c.z * 0.0722f; }

// Branchless orthonormal basis (Duff et al. 2017).
RT_HD void onb3(V3 n, V3& t, V3& b) {
  float sign = n.z >= 0.0f ? 1.0f : -1.0f;
  float a = -1.0f / (sign + n.z);
  float bb = n.x * n.y * a;
  t = v3(1.0f + sign * n.x * n.x * a, sign * bb, -sign * n.x);
  b = v3(bb, sign + n.y * n.y * a, -n.y);
}
RT_HD V3 to_local3(V3 v, V3 n) {
  V3 t, b;
  onb3(n, t, b);
  return v3(dot3(v, t), dot3(v, b), dot3(v, n));
}
RT_HD V3 to_world3(V3 v, V3 n) {
  V3 t, b;
  onb3(n, t, b);
  return v.x * t + v.y * b + v.z * n;
}

RT_HD float power_heuristic(float pa, float pb) {
  float a2 = pa * pa;
  return pa > 0.0f ? a2 / max_(a2 + pb * pb, (float)1e-30) : 0.0f;
}

// ---------------------------------------------------------------------------
// Microfacet pieces (pt/bsdf.py)
// ---------------------------------------------------------------------------

RT_HD float ggx_ndf(float alpha, float hz) {
  float a2 = alpha * alpha;
  float den = hz * hz * (a2 - 1.0f) + 1.0f;
  return a2 / max_(kPi * den * den, (float)1e-12);
}
RT_HD float smith_lambda(float alpha, float wz) {
  wz = clamp_(fabsf(wz), kMinCos, 1.0f);
  float a2 = alpha * alpha;
  float tan2 = (1.0f - wz * wz) / (wz * wz);
  return 0.5f * (sqrtf(1.0f + a2 * tan2) - 1.0f);
}
RT_HD float smith_g1(float alpha, float wz) { return 1.0f / (1.0f + smith_lambda(alpha, wz)); }
RT_HD float smith_g2(float alpha, float woz, float wiz) {
  return 1.0f / (1.0f + smith_lambda(alpha, woz) + smith_lambda(alpha, wiz));
}
RT_HD float fresnel_dielectric(float cos_i, float eta) {
  cos_i = clamp_(cos_i, 0.0f, 1.0f);
  float sin2_t = eta * eta * (1.0f - cos_i * cos_i);
  bool tir = sin2_t >= 1.0f;
  float cos_t = sqrtf(max_(1.0f - sin2_t, 0.0f));
  float rs = (eta * cos_i - cos_t) / max_(eta * cos_i + cos_t, (float)1e-12);
  float rp = (cos_i - eta * cos_t) / max_(cos_i + eta * cos_t, (float)1e-12);
  float f = 0.5f * (rs * rs + rp * rp);
  return tir ? 1.0f : f;
}
RT_HD float pow5(float x) { float x2 = x * x; return x2 * x2 * x; }
RT_HD float fresnel_schlick_scalar(float f0, float cos_h) {
  float w = pow5(clamp_(1.0f - cos_h, 0.0f, 1.0f));
  float present = f0 > (float)1e-6 ? 1.0f : 0.0f;
  return f0 + (1.0f - f0) * w * present;
}
RT_HD V3 fresnel_schlick3(V3 f0, float cos_h) {
  float w = pow5(clamp_(1.0f - cos_h, 0.0f, 1.0f));
  float present = luminance3(f0) > (float)1e-6 ? 1.0f : 0.0f;
  return f0 + (splat(1.0f) - f0) * (w * present);
}

// ---------------------------------------------------------------------------
// BSDF (wide.py: make_bsdf_w .. bsdf_sample_w); transmission_color is 1
// ---------------------------------------------------------------------------

struct BSDF {
  V3 diffuse, f0;
  float alpha, transmission, dtrans, eta;
  bool ms;            // Kulla-Conty lobe on
  float ep[6];        // E(mu) polynomial in sqrt(mu)
  float e_avg;
};

RT_HD V3 ms_color(const BSDF& b) {
  V3 f_avg = b.f0 + (splat(1.0f) - b.f0) * (1.0f / 21.0f);
  return f_avg * f_avg * b.e_avg / max3_(splat(1.0f) - f_avg * (1.0f - b.e_avg), (float)1e-4);
}

RT_HD void lobe_probs(const BSDF& b, float& pd, float& ps, float& pt, float& pdt) {
  float f0_lum = luminance3(b.f0);
  float f_avg = f0_lum > (float)1e-6 ? clamp_(f0_lum + 0.04f, 0.0f, 1.0f) : 0.0f;
  float d = luminance3(b.diffuse) * (1.0f - b.transmission) * (1.0f - b.dtrans);
  if (b.ms) d = d + (b.alpha >= kDeltaAlpha ? luminance3(ms_color(b)) * (1.0f - b.e_avg) : 0.0f);
  float dt = b.dtrans * 1.0f;                 // * luminance(transmission_color)
  float s = f_avg;
  float t = b.transmission * (1.0f - f_avg) * 1.0f;
  float total = d + s + t + dt;
  float safe = max_(total, (float)1e-9);
  bool ok = total > (float)1e-9;
  pd = ok ? d / safe : 1.0f;
  ps = ok ? s / safe : 0.0f;
  pt = ok ? t / safe : 0.0f;
  pdt = ok ? dt / safe : 0.0f;
}

RT_HD V3 eval_diffuse(const BSDF& b, V3 wo, V3 wi) {
  float f0_lum = clamp_(luminance3(b.f0), 0.0f, 1.0f);
  float fd = 1.0f - fresnel_schlick_scalar(f0_lum, clamp_(wo.z, 0.0f, 1.0f));
  V3 f = (b.diffuse * kInvPi) * (fd * max_(wi.z, 0.0f));
  bool valid = (wo.z > kMinCos) && (wi.z > kMinCos);
  return valid ? f : splat(0.0f);
}
RT_HD V3 eval_diffuse_trans(const BSDF& b, V3 wo, V3 wi) {
  float f = (1.0f * b.dtrans) * kInvPi * max_(-wi.z, 0.0f);
  bool valid = (wo.z > kMinCos) && (wi.z < -kMinCos);
  return valid ? splat(f) : splat(0.0f);
}
RT_HD float E_poly(const BSDF& b, float mu) {
  float t = sqrtf(clamp_(mu, 0.0f, 1.0f));
  float acc = b.ep[5];
  for (int k = 4; k >= 0; --k) acc = acc * t + b.ep[k];
  return clamp_(acc, 0.0f, 1.0f);
}
RT_HD V3 eval_spec_ms(const BSDF& b, V3 wo, V3 wi) {
  float e_o = E_poly(b, wo.z);
  float e_i = E_poly(b, wi.z);
  float f = ((1.0f - e_o) * (1.0f - e_i)) / (kPi * max_(1.0f - b.e_avg, (float)1e-4));
  V3 f_cos = (f * max_(wi.z, 0.0f)) * ms_color(b);
  bool valid = (wo.z > kMinCos) && (wi.z > kMinCos) && (b.alpha >= kDeltaAlpha);
  return valid ? f_cos : splat(0.0f);
}
RT_HD V3 eval_spec_refl(const BSDF& b, V3 wo, V3 wi) {
  V3 h = normalize3(wo + wi);
  float doth = max_(dot3(wo, h), 0.0f);
  float D = ggx_ndf(b.alpha, h.z);
  float G = smith_g2(b.alpha, wo.z, wi.z);
  V3 F = fresnel_schlick3(b.f0, doth);
  V3 spec = F * (D * G / max_(4.0f * wo.z, (float)1e-9));
  bool valid = (wo.z > kMinCos) && (wi.z > kMinCos) && (b.alpha >= kDeltaAlpha);
  return valid ? spec : splat(0.0f);
}
RT_HD V3 eval_spec_trans(const BSDF& b, V3 wo, V3 wi) {
  float eta = b.eta;
  V3 h = normalize3(-(eta * wo + wi));
  h = h * (h.z < 0.0f ? -1.0f : 1.0f);
  float dot_oh = dot3(wo, h);
  float dot_ih = dot3(wi, h);
  float F = fresnel_dielectric(fabsf(dot_oh), eta);
  float D = ggx_ndf(b.alpha, h.z);
  float G = smith_g2(b.alpha, wo.z, fabsf(wi.z));
  float denom = dot_oh * eta + dot_ih;
  float jac = fabsf(dot_ih) / max_(denom * denom, (float)1e-9);
  float f_cos = (1.0f - F) * D * G * jac * fabsf(dot_oh) / max_(fabsf(wo.z), kMinCos);
  bool valid = (wo.z > kMinCos) && (wi.z < -kMinCos) && (b.alpha >= kDeltaAlpha) &&
               (dot_oh > 0.0f) && (dot_ih < 0.0f);
  return valid ? splat(1.0f * (b.transmission * f_cos)) : splat(0.0f);
}

RT_HD V3 bsdf_eval(const BSDF& b, V3 wo, V3 wi) {
  V3 f = eval_diffuse(b, wo, wi) * (1.0f - b.transmission) * (1.0f - b.dtrans) +
         eval_diffuse_trans(b, wo, wi) + eval_spec_refl(b, wo, wi) +
         eval_spec_trans(b, wo, wi);
  if (b.ms) f = f + eval_spec_ms(b, wo, wi);
  return f;
}

// bsdf_eval split into its diffuse part (diffuse reflection and
// transmission) and its specular part (microfacet reflection, transmission
// and the Kulla-Conty lobe), in the plain version's order
// (wide.py bsdf_eval_split_w; the JAX package's wide.py:323).
RT_HD void bsdf_eval_split(const BSDF& b, V3 wo, V3 wi, V3& f_d, V3& f_s) {
  f_d = eval_diffuse(b, wo, wi) * (1.0f - b.transmission) * (1.0f - b.dtrans) +
        eval_diffuse_trans(b, wo, wi);
  f_s = eval_spec_refl(b, wo, wi) + eval_spec_trans(b, wo, wi);
  if (b.ms) f_s = f_s + eval_spec_ms(b, wo, wi);
}

RT_HD float ggx_vndf_pdf(V3 wo, V3 h, float alpha) {
  float woz = max_(wo.z, kMinCos);
  float doth = max_(dot3(wo, h), 0.0f);
  return smith_g1(alpha, woz) * ggx_ndf(alpha, h.z) * doth / woz;
}

RT_HD float bsdf_pdf(const BSDF& b, V3 wo, V3 wi) {
  float pd, ps, pt, pdt;
  lobe_probs(b, pd, ps, pt, pdt);
  bool smooth = b.alpha >= kDeltaAlpha;
  float pdf_d = max_(wi.z, 0.0f) * kInvPi;
  float pdf_dt = max_(-wi.z, 0.0f) * kInvPi;

  V3 h_r = normalize3(wo + wi);
  float pdf_s = ggx_vndf_pdf(wo, h_r, b.alpha) / max_(4.0f * fabsf(dot3(wo, h_r)), (float)1e-9);
  pdf_s = (smooth && wi.z > kMinCos && wo.z > kMinCos) ? pdf_s : 0.0f;

  float eta = b.eta;
  V3 h_t = normalize3(-(eta * wo + wi));
  h_t = h_t * (h_t.z < 0.0f ? -1.0f : 1.0f);
  float dot_oh = dot3(wo, h_t);
  float dot_ih = dot3(wi, h_t);
  float denom = dot_oh * eta + dot_ih;
  float jac_t = fabsf(dot_ih) / max_(denom * denom, (float)1e-9);
  float F = fresnel_dielectric(fabsf(dot_oh), eta);
  float pdf_t = ggx_vndf_pdf(wo, h_t, b.alpha) * jac_t * (1.0f - F);
  pdf_t = (smooth && wi.z < -kMinCos && wo.z > kMinCos && dot_oh > 0.0f && dot_ih < 0.0f)
              ? pdf_t : 0.0f;
  return pd * pdf_d + ps * pdf_s + pt * pdf_t + pdt * pdf_dt;
}

RT_HD V3 sample_cosine_hemisphere(float u1, float u2) {
  float r = sqrtf(u1);
  float phi = kTwoPi * u2;
  float z = sqrtf(max_(1.0f - u1, 0.0f));
  return v3(r * cosf(phi), r * sinf(phi), z);
}

RT_HD V3 sample_ggx_vndf(V3 wo, float alpha, float u1, float u2) {
  V3 vh = normalize3(v3(alpha * wo.x, alpha * wo.y, wo.z));
  float lensq = vh.x * vh.x + vh.y * vh.y;
  float inv_len = 1.0f / sqrtf(max_(lensq, (float)1e-20));
  bool big = lensq > (float)1e-16;
  V3 t1 = v3(big ? -vh.y * inv_len : 1.0f, big ? vh.x * inv_len : 0.0f, 0.0f);
  V3 t2 = cross3(vh, t1);
  float r = sqrtf(u1);
  float phi = kTwoPi * u2;
  float p1 = r * cosf(phi);
  float p2 = r * sinf(phi);
  float s = 0.5f * (1.0f + vh.z);
  p2 = (1.0f - s) * sqrtf(max_(1.0f - p1 * p1, 0.0f)) + s * p2;
  V3 nh = p1 * t1 + p2 * t2 + sqrtf(max_(1.0f - p1 * p1 - p2 * p2, 0.0f)) * vh;
  V3 h = v3(alpha * nh.x, alpha * nh.y, max_(nh.z, 0.0f));
  return normalize3(h);
}

struct BSDFSample {
  V3 wi, weight;
  float pdf;
  bool is_delta, valid;
  int lobe;
};

RT_HD BSDFSample bsdf_sample(const BSDF& b, V3 wo, float u_lobe, float u1, float u2) {
  float pd, ps, pt, pdt;
  lobe_probs(b, pd, ps, pt, pdt);
  float woz = wo.z;
  bool smooth = b.alpha >= kDeltaAlpha;

  float c1 = pd;
  float c2 = pd + ps;
  float c3 = pd + ps + pt;
  bool sel_d = u_lobe < c1;
  bool sel_s = !sel_d && (u_lobe < c2);
  bool sel_t = !sel_d && !sel_s && (u_lobe < c3);

  BSDFSample out;
  out.lobe = sel_d ? LOBE_DIFFUSE_REFL
                   : (sel_s ? LOBE_SPECULAR_REFL
                            : (sel_t ? LOBE_SPECULAR_TRANS : LOBE_DIFFUSE_TRANS));

  V3 wi_cos = sample_cosine_hemisphere(u1, u2);
  float alpha_s = max_(b.alpha, kDeltaAlpha);
  V3 h = sample_ggx_vndf(wo, alpha_s, u1, u2);
  V3 h_eff = smooth ? h : v3(0.0f, 0.0f, 1.0f);
  V3 wi_refl = normalize3(2.0f * dot3(wo, h_eff) * h_eff - wo);

  float eta = b.eta;
  float cos_oh = clamp_(dot3(wo, h_eff), 0.0f, 1.0f);
  float sin2_t = eta * eta * (1.0f - cos_oh * cos_oh);
  bool tir = sin2_t >= 1.0f;
  float cos_t = sqrtf(max_(1.0f - sin2_t, 0.0f));
  V3 wi_refr = normalize3(-eta * wo + (eta * cos_oh - cos_t) * h_eff);
  V3 wi_dt = v3(wi_cos.x, wi_cos.y, -wi_cos.z);

  V3 wi = sel_d ? wi_cos : (sel_s ? wi_refl : (sel_t ? (tir ? wi_refl : wi_refr) : wi_dt));
  bool is_delta = !smooth && (sel_s || sel_t);

  V3 f = bsdf_eval(b, wo, wi);
  float pdf = bsdf_pdf(b, wo, wi);
  V3 w_smooth = f / max_(pdf, (float)1e-12);

  V3 f_mirror = fresnel_schlick3(b.f0, clamp_(woz, 0.0f, 1.0f));
  float Fd = fresnel_dielectric(clamp_(woz, 0.0f, 1.0f), eta);
  V3 w_delta_s = f_mirror / max_(ps, (float)1e-9);
  float w_delta_t = 1.0f * (b.transmission * (1.0f - Fd)) / max_(pt, (float)1e-9);
  if (tir) w_delta_t = 1.0f * b.transmission / max_(pt, (float)1e-9);
  V3 w_delta = sel_s ? w_delta_s : splat(w_delta_t);

  V3 weight = is_delta ? w_delta : w_smooth;
  out.wi = wi;
  out.pdf = is_delta ? 0.0f : pdf;
  out.is_delta = is_delta;
  out.valid = (woz > kMinCos) && isfinite(luminance3(weight));
  out.weight = max3_(weight, 0.0f);
  return out;
}

// ---------------------------------------------------------------------------
// Light sample (wide.sample_light_fields_w; its environment branch is
// bounce_fused.cuh's env_sample, which needs the environment table)
// ---------------------------------------------------------------------------

struct LightFields {
  int kind;
  V3 p0, p1, p2, em, normal;
  float extra0, extra1;
};

struct LightSample {
  V3 wi, Li;
  float dist, pdf;
  bool is_delta, valid;
};

RT_HD LightSample sample_light(const LightFields& lf, float sel_pdf, V3 pos, float u1, float u2) {
  LightSample s;
  bool is_tri = lf.kind == KIND_TRIANGLE;
  bool is_point = lf.kind == KIND_POINT;
  bool is_spot = lf.kind == KIND_SPOT;
  bool is_dir = lf.kind == KIND_DIRECTIONAL;
  bool valid_tri = true;
  if (is_tri) {
    // Heitz 2019 square-root-free triangle mapping
    float b0 = u1 * 0.5f;
    float b1 = u2 * 0.5f;
    float offset = b1 - b0;
    float nb0 = offset > 0.0f ? b0 : b0 - offset;
    float nb1 = offset > 0.0f ? b1 + offset : b1;
    V3 lp = lf.p0 + nb0 * lf.p1 + nb1 * lf.p2;
    V3 to_l = lp - pos;
    float d2 = max_(dot3(to_l, to_l), (float)1e-12);
    float dist = sqrtf(d2);
    s.wi = to_l / dist;
    float cos_l = dot3(-s.wi, lf.normal);
    float area = max_(lf.extra0, (float)1e-12);
    s.pdf = sel_pdf * d2 / max_(area * max_(cos_l, (float)1e-9), (float)1e-12);
    s.dist = dist;
    s.Li = lf.em;
    valid_tri = cos_l > (float)1e-6;
  } else if (is_point || is_spot) {
    V3 to_p = lf.p0 - pos;
    float d2p = max_(dot3(to_p, to_p), (float)1e-12);
    float dist_p = sqrtf(d2p);
    s.wi = to_p / dist_p;
    V3 li_point = lf.em / d2p;
    if (is_spot) {
      float cos_spot = dot3(-s.wi, lf.p1);
      float a = clamp_((cos_spot - lf.extra1) / max_(lf.extra0 - lf.extra1, (float)1e-6),
                       0.0f, 1.0f);
      a = a * a;
      li_point = li_point * a;
    }
    s.Li = li_point;
    s.dist = dist_p;
    s.pdf = sel_pdf;
  } else {
    s.wi = -lf.p1;
    s.dist = kDeltaDist;
    s.Li = lf.em;
    s.pdf = sel_pdf;
  }
  s.is_delta = is_point || is_spot || is_dir;
  s.valid = (valid_tri || !is_tri) && (s.pdf > (float)1e-12) && (sel_pdf > 0.0f);
  return s;
}

}  // namespace rt
