"""Wide shading math (counterpart of rtxpt_tpu/pt/wide.py) in plain torch.

Operands follow the JAX module's convention: a scalar is any-shaped
tensor (here one column per ray, [N]); a vec3 is a [3, ...] stack. This is
the plain version of the shading that runs inside the fused bounce
kernel; csrc/wide.cuh holds the same functions per thread, written in the
same operation order.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from rtxpt_tpu_torch.pt.bsdf import (
    DELTA_ALPHA, LOBE_DIFFUSE_REFL, LOBE_DIFFUSE_TRANS, LOBE_SPECULAR_REFL,
    LOBE_SPECULAR_TRANS, MIN_COS, fresnel_dielectric, ggx_ndf, smith_g1,
    smith_g2,
)
from rtxpt_tpu_torch.utils.math import (  # noqa: F401 (part of this API)
    power_heuristic, sample_triangle_barycentrics)

EPS = 1e-8
PI = math.pi


# ---------------------------------------------------------------------------
# vec3 math over a leading axis
# ---------------------------------------------------------------------------


def vec3(x, y, z):
    return torch.stack([x, y, z], dim=0)


def splat3(s):
    return torch.stack([s, s, s], dim=0)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return vec3(a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])


def normalize3(v):
    inv = 1.0 / torch.sqrt(torch.clamp(dot3(v, v), min=EPS * EPS))
    return v * inv


def luminance3(c):
    return c[0] * 0.2126 + c[1] * 0.7152 + c[2] * 0.0722


def onb3(n):
    """Branchless orthonormal basis (Duff et al. 2017); returns (t, b)."""
    z = n[2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[0] * n[1] * a
    t = vec3(1.0 + sign * n[0] * n[0] * a, sign * b, -sign * n[0])
    bt = vec3(b, sign + n[1] * n[1] * a, -n[1])
    return t, bt


def to_local3(v, n):
    t, b = onb3(n)
    return vec3(dot3(v, t), dot3(v, b), dot3(v, n))


def to_world3(v, n):
    t, b = onb3(n)
    return v[0] * t + v[1] * b + v[2] * n


def sample_cosine_hemisphere3(u1, u2):
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    z = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    return vec3(r * torch.cos(phi), r * torch.sin(phi), z)


# ---------------------------------------------------------------------------
# BSDF
# ---------------------------------------------------------------------------


class BSDFW(NamedTuple):
    """Wide BSDF parameters: vec3 fields [3, ...], scalars [...]."""

    diffuse: torch.Tensor
    specular_f0: torch.Tensor
    alpha: torch.Tensor
    transmission: torch.Tensor
    diffuse_transmission: torch.Tensor
    eta: torch.Tensor
    transmission_color: torch.Tensor
    # Kulla-Conty fit: [6, ...] sqrt(mu) polynomial of E(mu) + E_avg;
    # None disables the multiple-scattering lobe.
    e_poly: Optional[torch.Tensor] = None
    e_avg: Optional[torch.Tensor] = None


def make_bsdf_w(base_color, metallic, roughness, ior, transmission,
                diffuse_transmission, specular_scale, front,
                cur_ior, below_ior, e_poly=None, e_avg=None) -> BSDFW:
    f0_dielec = splat3(0.08 * specular_scale)
    specular_f0 = f0_dielec * (1.0 - metallic) + base_color * metallic
    diffuse = base_color * (1.0 - metallic)
    mat_ior = torch.clamp(ior, min=1.0 + 1e-4)
    eta = torch.where(front, cur_ior / mat_ior,
                      cur_ior / torch.clamp(below_ior, min=1.0))
    alpha = torch.clamp(roughness * roughness, 0.0, 1.0)
    return BSDFW(diffuse=diffuse, specular_f0=specular_f0, alpha=alpha,
                 transmission=transmission * (1.0 - metallic),
                 diffuse_transmission=diffuse_transmission * (1.0 - metallic),
                 eta=eta, transmission_color=torch.ones_like(base_color),
                 e_poly=e_poly, e_avg=e_avg)


def _pow5(x):
    x2 = x * x
    return x2 * x2 * x


def fresnel_schlick_scalar(f0, cos_h):
    w = _pow5(torch.clamp(1.0 - cos_h, 0.0, 1.0))
    present = (f0 > 1e-6).to(w.dtype)
    return f0 + (1.0 - f0) * w * present


def fresnel_schlick3(f0, cos_h):
    w = _pow5(torch.clamp(1.0 - cos_h, 0.0, 1.0))
    present = (luminance3(f0) > 1e-6).to(w.dtype)
    return f0 + (1.0 - f0) * (w * present)


def sample_ggx_vndf3(wo, alpha, u1, u2):
    """Heitz 2018 visible-NDF sampling."""
    vh = normalize3(vec3(alpha * wo[0], alpha * wo[1], wo[2]))
    lensq = vh[0] * vh[0] + vh[1] * vh[1]
    inv_len = 1.0 / torch.sqrt(torch.clamp(lensq, min=1e-20))
    big = lensq > 1e-16
    t1 = vec3(torch.where(big, -vh[1] * inv_len, 1.0),
              torch.where(big, vh[0] * inv_len, 0.0),
              torch.zeros_like(vh[0]))
    t2 = cross3(vh, t1)
    r = torch.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[2])
    p2 = (1.0 - s) * torch.sqrt(torch.clamp(1.0 - p1 * p1, min=0.0)) + s * p2
    nh = (p1 * t1 + p2 * t2
          + torch.sqrt(torch.clamp(1.0 - p1 * p1 - p2 * p2, min=0.0)) * vh)
    h = vec3(alpha * nh[0], alpha * nh[1], torch.clamp(nh[2], min=0.0))
    return normalize3(h)


def ggx_vndf_pdf3(wo, h, alpha):
    woz = torch.clamp(wo[2], min=MIN_COS)
    doth = torch.clamp(dot3(wo, h), min=0.0)
    return smith_g1(alpha, woz) * ggx_ndf(alpha, h[2]) * doth / woz


def _lobe_probs_w(data: BSDFW):
    f0_lum = luminance3(data.specular_f0)
    f_avg = torch.where(f0_lum > 1e-6,
                        torch.clamp(f0_lum + 0.04, 0.0, 1.0), 0.0)
    pd = luminance3(data.diffuse) * (1.0 - data.transmission) * \
        (1.0 - data.diffuse_transmission)
    if data.e_poly is not None:
        pd = pd + torch.where(data.alpha >= DELTA_ALPHA,
                              luminance3(_ms_color_w(data))
                              * (1.0 - data.e_avg), 0.0)
    pdt = data.diffuse_transmission * luminance3(data.transmission_color)
    ps = f_avg
    pt = data.transmission * (1.0 - f_avg) * \
        luminance3(data.transmission_color)
    total = pd + ps + pt + pdt
    safe = torch.clamp(total, min=1e-9)
    ok = total > 1e-9
    return (torch.where(ok, pd / safe, 1.0), torch.where(ok, ps / safe, 0.0),
            torch.where(ok, pt / safe, 0.0), torch.where(ok, pdt / safe, 0.0))


def _eval_diffuse_w(data: BSDFW, wo, wi):
    woz, wiz = wo[2], wi[2]
    f0_lum = torch.clamp(luminance3(data.specular_f0), 0.0, 1.0)
    fd = 1.0 - fresnel_schlick_scalar(f0_lum, torch.clamp(woz, 0.0, 1.0))
    f = data.diffuse / PI * (fd * torch.clamp(wiz, min=0.0))
    valid = (woz > MIN_COS) & (wiz > MIN_COS)
    return torch.where(valid, f, 0.0)


def _eval_diffuse_trans_w(data: BSDFW, wo, wi):
    woz, wiz = wo[2], wi[2]
    f = (data.transmission_color * data.diffuse_transmission
         / PI * torch.clamp(-wiz, min=0.0))
    valid = (woz > MIN_COS) & (wiz < -MIN_COS)
    return torch.where(valid, f, 0.0)


def _E_w(data: BSDFW, mu):
    """Per-lane E(mu): degree-5 Horner in sqrt(mu)."""
    t = torch.sqrt(torch.clamp(mu, 0.0, 1.0))
    c = data.e_poly
    acc = c[5]
    for k in (4, 3, 2, 1, 0):
        acc = acc * t + c[k]
    return torch.clamp(acc, 0.0, 1.0)


def _ms_color_w(data: BSDFW):
    e_avg = data.e_avg
    f_avg = data.specular_f0 + (1.0 - data.specular_f0) / 21.0
    return f_avg * f_avg * e_avg / torch.clamp(
        1.0 - f_avg * (1.0 - e_avg), min=1e-4)


def _eval_spec_ms_w(data: BSDFW, wo, wi):
    """Kulla-Conty compensation lobe * cos."""
    woz, wiz = wo[2], wi[2]
    e_o = _E_w(data, woz)
    e_i = _E_w(data, wiz)
    f = ((1.0 - e_o) * (1.0 - e_i)
         / (PI * torch.clamp(1.0 - data.e_avg, min=1e-4)))
    f_cos = (f * torch.clamp(wiz, min=0.0)) * _ms_color_w(data)
    valid = (woz > MIN_COS) & (wiz > MIN_COS) & (data.alpha >= DELTA_ALPHA)
    return torch.where(valid, f_cos, 0.0)


def _eval_spec_refl_w(data: BSDFW, wo, wi):
    woz, wiz = wo[2], wi[2]
    h = normalize3(wo + wi)
    doth = torch.clamp(dot3(wo, h), min=0.0)
    D = ggx_ndf(data.alpha, h[2])
    G = smith_g2(data.alpha, woz, wiz)
    F = fresnel_schlick3(data.specular_f0, doth)
    spec = F * (D * G / torch.clamp(4.0 * woz, min=1e-9))
    valid = (woz > MIN_COS) & (wiz > MIN_COS) & (data.alpha >= DELTA_ALPHA)
    return torch.where(valid, spec, 0.0)


def _eval_spec_trans_w(data: BSDFW, wo, wi):
    woz, wiz = wo[2], wi[2]
    eta = data.eta
    h = normalize3(-(eta * wo + wi))
    h = h * torch.where(h[2] < 0.0, -1.0, 1.0)
    dot_oh = dot3(wo, h)
    dot_ih = dot3(wi, h)
    F = fresnel_dielectric(torch.abs(dot_oh), eta)
    D = ggx_ndf(data.alpha, h[2])
    G = smith_g2(data.alpha, woz, torch.abs(wiz))
    denom = dot_oh * eta + dot_ih
    jac = torch.abs(dot_ih) / torch.clamp(denom * denom, min=1e-9)
    f_cos = ((1.0 - F) * D * G * jac * torch.abs(dot_oh)
             / torch.clamp(torch.abs(woz), min=MIN_COS))
    valid = ((woz > MIN_COS) & (wiz < -MIN_COS)
             & (data.alpha >= DELTA_ALPHA)
             & (dot_oh > 0.0) & (dot_ih < 0.0))
    f = data.transmission_color * (data.transmission * f_cos)
    return torch.where(valid, f, 0.0)


def bsdf_eval_w(data: BSDFW, wo, wi):
    """Sum of the non-delta lobes f(wo,wi)*|cos(wi)| (vec3)."""
    f = (_eval_diffuse_w(data, wo, wi)
         * (1.0 - data.transmission) * (1.0 - data.diffuse_transmission)
         + _eval_diffuse_trans_w(data, wo, wi)
         + _eval_spec_refl_w(data, wo, wi)
         + _eval_spec_trans_w(data, wo, wi))
    if data.e_poly is not None:
        f = f + _eval_spec_ms_w(data, wo, wi)
    return f


def bsdf_eval_split_w(data: BSDFW, wo, wi):
    """bsdf_eval_w split into (diffuse-ish, specular-ish) parts."""
    f_d = (_eval_diffuse_w(data, wo, wi)
           * (1.0 - data.transmission) * (1.0 - data.diffuse_transmission)
           + _eval_diffuse_trans_w(data, wo, wi))
    f_s = (_eval_spec_refl_w(data, wo, wi)
           + _eval_spec_trans_w(data, wo, wi))
    if data.e_poly is not None:
        f_s = f_s + _eval_spec_ms_w(data, wo, wi)
    return f_d, f_s


def bsdf_pdf_w(data: BSDFW, wo, wi):
    pd, ps, pt, pdt = _lobe_probs_w(data)
    woz, wiz = wo[2], wi[2]
    smooth = data.alpha >= DELTA_ALPHA

    pdf_d = torch.clamp(wiz, min=0.0) / PI
    pdf_dt = torch.clamp(-wiz, min=0.0) / PI

    h_r = normalize3(wo + wi)
    pdf_s = ggx_vndf_pdf3(wo, h_r, data.alpha) / torch.clamp(
        4.0 * torch.abs(dot3(wo, h_r)), min=1e-9)
    pdf_s = torch.where(smooth & (wiz > MIN_COS) & (woz > MIN_COS),
                        pdf_s, 0.0)

    eta = data.eta
    h_t = normalize3(-(eta * wo + wi))
    h_t = h_t * torch.where(h_t[2] < 0.0, -1.0, 1.0)
    dot_oh = dot3(wo, h_t)
    dot_ih = dot3(wi, h_t)
    denom = dot_oh * eta + dot_ih
    jac_t = torch.abs(dot_ih) / torch.clamp(denom * denom, min=1e-9)
    F = fresnel_dielectric(torch.abs(dot_oh), eta)
    pdf_t = ggx_vndf_pdf3(wo, h_t, data.alpha) * jac_t * (1.0 - F)
    pdf_t = torch.where(smooth & (wiz < -MIN_COS) & (woz > MIN_COS)
                        & (dot_oh > 0.0) & (dot_ih < 0.0), pdf_t, 0.0)
    return pd * pdf_d + ps * pdf_s + pt * pdf_t + pdt * pdf_dt


def bsdf_sample_w(data: BSDFW, wo, u_lobe, u1, u2):
    """Returns dict(wi vec3, weight vec3, pdf, is_delta, lobe i32, valid)."""
    pd, ps, pt, pdt = _lobe_probs_w(data)
    woz = wo[2]
    smooth = data.alpha >= DELTA_ALPHA

    c1 = pd
    c2 = pd + ps
    c3 = pd + ps + pt
    sel_d = u_lobe < c1
    sel_s = (~sel_d) & (u_lobe < c2)
    sel_t = (~sel_d) & (~sel_s) & (u_lobe < c3)
    lobe = torch.where(sel_d, LOBE_DIFFUSE_REFL,
                       torch.where(sel_s, LOBE_SPECULAR_REFL,
                                   torch.where(sel_t, LOBE_SPECULAR_TRANS,
                                               LOBE_DIFFUSE_TRANS)))

    wi_cos = sample_cosine_hemisphere3(u1, u2)

    alpha_s = torch.clamp(data.alpha, min=DELTA_ALPHA)
    h = sample_ggx_vndf3(wo, alpha_s, u1, u2)
    h_eff = torch.where(smooth, h, vec3(torch.zeros_like(woz),
                                        torch.zeros_like(woz),
                                        torch.ones_like(woz)))
    wi_refl = normalize3(2.0 * dot3(wo, h_eff) * h_eff - wo)

    eta = data.eta
    cos_oh = torch.clamp(dot3(wo, h_eff), 0.0, 1.0)
    sin2_t = eta * eta * (1.0 - cos_oh * cos_oh)
    tir = sin2_t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2_t, min=0.0))
    wi_refr = normalize3(-eta * wo + (eta * cos_oh - cos_t) * h_eff)
    wi_dt = vec3(wi_cos[0], wi_cos[1], -wi_cos[2])

    wi = torch.where(sel_d, wi_cos,
                     torch.where(sel_s, wi_refl,
                                 torch.where(sel_t,
                                             torch.where(tir, wi_refl,
                                                         wi_refr),
                                             wi_dt)))

    is_delta = (~smooth) & (sel_s | sel_t)

    f = bsdf_eval_w(data, wo, wi)
    pdf = bsdf_pdf_w(data, wo, wi)
    w_smooth = f / torch.clamp(pdf, min=1e-12)

    f_mirror = fresnel_schlick3(data.specular_f0, torch.clamp(woz, 0.0, 1.0))
    Fd = fresnel_dielectric(torch.clamp(woz, 0.0, 1.0), eta)
    w_delta_s = f_mirror / torch.clamp(ps, min=1e-9)
    w_delta_t = (data.transmission_color
                 * (data.transmission * (1.0 - Fd))
                 / torch.clamp(pt, min=1e-9))
    w_delta_t = torch.where(tir,
                            data.transmission_color * data.transmission
                            / torch.clamp(pt, min=1e-9),
                            w_delta_t)
    w_delta = torch.where(sel_s, w_delta_s, w_delta_t)

    weight = torch.where(is_delta, w_delta, w_smooth)
    pdf_out = torch.where(is_delta, 0.0, pdf)

    valid = (woz > MIN_COS) & torch.isfinite(luminance3(weight))
    return dict(wi=wi, weight=torch.clamp(weight, min=0.0), pdf=pdf_out,
                is_delta=is_delta, lobe=lobe, valid=valid)


# ---------------------------------------------------------------------------
# Light sampling
# ---------------------------------------------------------------------------

# Light-table rows of the [LROWS, 128] lane table (bounce_fused.pack_lights)
LROW_KIND = 0
LROW_P0 = 1            # 1:4
LROW_P1 = 4            # 4:7
LROW_P2 = 7            # 7:10
LROW_EM = 10           # 10:13
LROW_EXTRA = 13        # 13:17
LROW_NORMAL = 17       # 17:20
LROW_POWER = 20
LROW_CDF = 21
LROWS = 22

_DELTA_DIST = 1e8

KIND_TRIANGLE = 0
KIND_POINT = 1
KIND_DIRECTIONAL = 2
KIND_SPOT = 3
KIND_ENV = 4


class LightFieldsW(NamedTuple):
    kind: torch.Tensor
    p0: torch.Tensor       # vec3
    p1: torch.Tensor       # vec3
    p2: torch.Tensor       # vec3
    em: torch.Tensor       # vec3
    extra: torch.Tensor    # [4, ...]
    normal: torch.Tensor   # vec3
    power: torch.Tensor


def sample_light_fields_w(lf: LightFieldsW, sel_pdf, shade_pos, u1, u2,
                          env=None):
    """Per-kind light sample from gathered light fields (triangle, point,
    spot, directional, and the environment when `env`, the kernels'
    environment sample (wi vec3, Li vec3, source pdf) drawn from the same
    u1, u2, is given). Returns dict(wi vec3, dist, Li vec3, pdf, is_delta,
    valid)."""
    kind = lf.kind

    b0, b1, b2 = sample_triangle_barycentrics(u1, u2)
    lp = lf.p0 + b1 * lf.p1 + b2 * lf.p2
    to_l = lp - shade_pos
    d2 = torch.clamp(dot3(to_l, to_l), min=1e-12)
    dist_tri = torch.sqrt(d2)
    wi_tri = to_l / dist_tri
    cos_l = dot3(-wi_tri, lf.normal)
    area = torch.clamp(lf.extra[0], min=1e-12)
    pdf_tri = sel_pdf * d2 / torch.clamp(
        area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    valid_tri = cos_l > 1e-6

    to_p = lf.p0 - shade_pos
    d2p = torch.clamp(dot3(to_p, to_p), min=1e-12)
    dist_p = torch.sqrt(d2p)
    wi_p = to_p / dist_p
    li_point = lf.em / d2p
    cos_spot = dot3(-wi_p, lf.p1)
    spot_atten = torch.clamp(
        (cos_spot - lf.extra[1])
        / torch.clamp(lf.extra[0] - lf.extra[1], min=1e-6), 0.0, 1.0)
    spot_atten = spot_atten * spot_atten

    wi_dir = -lf.p1

    is_tri = kind == KIND_TRIANGLE
    is_point = kind == KIND_POINT
    is_spot = kind == KIND_SPOT
    is_dir = kind == KIND_DIRECTIONAL

    wi = torch.where(is_tri, wi_tri,
                     torch.where(is_point | is_spot, wi_p, wi_dir))
    dist = torch.where(is_tri, dist_tri,
                       torch.where(is_point | is_spot, dist_p,
                                   torch.full_like(dist_p, _DELTA_DIST)))
    Li = torch.where(is_tri, lf.em,
                     torch.where(is_point, li_point,
                                 torch.where(is_spot, li_point * spot_atten,
                                             lf.em)))
    pdf = torch.where(is_tri, pdf_tri, sel_pdf)
    if env is not None:
        env_wi, env_li, env_src_pdf = env
        is_env = kind == KIND_ENV
        wi = torch.where(is_env, env_wi, wi)
        dist = torch.where(is_env, _DELTA_DIST, dist)
        Li = torch.where(is_env, env_li, Li)
        pdf = torch.where(is_env, sel_pdf * env_src_pdf, pdf)
    is_delta = is_point | is_spot | is_dir
    valid = (valid_tri | ~is_tri) & (pdf > 1e-12) & (sel_pdf > 0.0)
    return dict(wi=wi, dist=dist, Li=Li, pdf=pdf, is_delta=is_delta,
                valid=valid)
