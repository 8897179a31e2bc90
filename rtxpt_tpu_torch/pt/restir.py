"""ReSTIR DI (counterpart of rtxpt_tpu/pt/restir.py). Only
`eval_light_sample` is ported: NEE-AT's `sample_adaptive`
(lighting/neeat.py) re-evaluates its chosen light with it. The
reservoirs, the resampling passes and the G-buffer come with the
real-time slice."""

from __future__ import annotations

import torch

import math

from rtxpt_tpu_torch.lighting.envmap import _uv_to_dir, env_eval
from rtxpt_tpu_torch.lighting.lights_baker import (
    _DELTA_DIST, KIND_ENV, KIND_ENVQUAD, KIND_POINT, KIND_SPHERE, KIND_SPOT,
    KIND_TRIANGLE, LightList,
)
from rtxpt_tpu_torch.utils import math as m


def eval_light_sample(lights: LightList, envmap, li, uv, shade_pos):
    """Re-evaluate a light sample given by light index li [N] and sample
    parameters uv [N, 2] at shade_pos [N, 3], deterministically (the same
    mapping as lights_baker.sample_light) for every kind; the environment
    kinds read uv as a uniform square sample (jacobian
    1 / (2 pi^2 sin theta)), not as a CDF draw.

    Returns (wi [N,3], dist [N], Li [N,3], source pdf [N]: solid angle,
    with the power selection pmf folded in, at least 1e-12)."""
    lix = torch.clamp(li, min=0).to(torch.int64)
    kind = lights.kind[lix]
    p0 = lights.p0[lix]
    p1 = lights.p1[lix]
    p2 = lights.p2[lix]
    em = lights.emission[lix]
    ex = lights.extra[lix]
    nl = lights.normal[lix]
    sel_pdf = lights.power[lix]

    _, b1, b2 = m.sample_triangle_barycentrics(uv[..., 0], uv[..., 1])
    lp = p0 + b1[..., None] * p1 + b2[..., None] * p2
    to_l = lp - shade_pos
    d2 = torch.clamp(m.dot(to_l, to_l, False), min=1e-12)
    dist_tri = torch.sqrt(d2)
    wi_tri = to_l / dist_tri[..., None]
    cos_l = m.dot(-wi_tri, nl, False)
    area = torch.clamp(ex[..., 0], min=1e-12)
    pdf_tri = sel_pdf * d2 / torch.clamp(
        area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    li_tri = torch.where((cos_l > 1e-6)[..., None], em, 0.0)

    to_p = p0 - shade_pos
    d2p = torch.clamp(m.dot(to_p, to_p, False), min=1e-12)
    dist_p = torch.sqrt(d2p)
    wi_p = to_p / dist_p[..., None]
    li_point = em / d2p[..., None]
    cos_spot = m.dot(-wi_p, p1, False)
    spot_atten = torch.clamp((cos_spot - ex[..., 1])
                             / torch.clamp(ex[..., 0] - ex[..., 1], min=1e-6),
                             0.0, 1.0) ** 2

    is_tri = kind == KIND_TRIANGLE
    is_point = kind == KIND_POINT
    is_spot = kind == KIND_SPOT
    wi = -p1
    dist = torch.full_like(dist_p, _DELTA_DIST)
    Li = em
    pdf = sel_pdf
    if KIND_SPHERE in lights.kinds:
        is_sph = kind == KIND_SPHERE
        r_sph = ex[..., 2]
        sin2_max = torch.clamp(r_sph * r_sph / d2p, 0.0, 1.0 - 1e-6)
        cos_max = torch.sqrt(1.0 - sin2_max)
        cos_t = 1.0 - uv[..., 0] * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi_s = 2.0 * math.pi * uv[..., 1]
        t_s, b_s = m.orthonormal_basis(wi_p)
        wi_sph = (t_s * (sin_t * torch.cos(phi_s))[..., None]
                  + b_s * (sin_t * torch.sin(phi_s))[..., None]
                  + wi_p * cos_t[..., None])
        disc = torch.clamp(r_sph * r_sph - d2p * (1.0 - cos_t * cos_t),
                           min=0.0)
        dist_sph = torch.clamp(dist_p * cos_t - torch.sqrt(disc), min=1e-5)
        pdf_sph = sel_pdf / torch.clamp(2.0 * math.pi * (1.0 - cos_max),
                                        min=1e-9)
        wi = torch.where(is_sph[..., None], wi_sph, wi)
        dist = torch.where(is_sph, dist_sph, dist)
        Li = torch.where(is_sph[..., None],
                         torch.where((d2p > r_sph * r_sph)[..., None], em,
                                     0.0), Li)
        pdf = torch.where(is_sph, pdf_sph, pdf)
    if KIND_ENV in lights.kinds:
        is_env = kind == KIND_ENV
        wi_env = _uv_to_dir(envmap, uv[..., 0], uv[..., 1])
        sin_e = torch.clamp(torch.sin(uv[..., 1] * math.pi), min=1e-4)
        wi = torch.where(is_env[..., None], wi_env, wi)
        Li = torch.where(is_env[..., None], env_eval(envmap, wi_env), Li)
        pdf = torch.where(is_env,
                          sel_pdf / (2.0 * math.pi * math.pi * sin_e), pdf)
    if KIND_ENVQUAD in lights.kinds:
        is_envq = kind == KIND_ENVQUAD
        uq = ex[..., 0] + uv[..., 0] * (ex[..., 2] - ex[..., 0])
        vq = ex[..., 1] + uv[..., 1] * (ex[..., 3] - ex[..., 1])
        wi_envq = _uv_to_dir(envmap, uq, vq)
        area_q = torch.clamp((ex[..., 2] - ex[..., 0])
                             * (ex[..., 3] - ex[..., 1]), min=1e-9)
        sin_q = torch.clamp(torch.sin(vq * math.pi), min=1e-4)
        wi = torch.where(is_envq[..., None], wi_envq, wi)
        Li = torch.where(is_envq[..., None], env_eval(envmap, wi_envq), Li)
        pdf = torch.where(is_envq, sel_pdf / (area_q * 2.0 * math.pi
                                              * math.pi * sin_q), pdf)
    wi = torch.where(is_tri[..., None], wi_tri,
                     torch.where((is_point | is_spot)[..., None], wi_p, wi))
    dist = torch.where(is_tri, dist_tri,
                       torch.where(is_point | is_spot, dist_p, dist))
    Li = torch.where(is_tri[..., None], li_tri,
                     torch.where(is_point[..., None], li_point,
                                 torch.where(is_spot[..., None],
                                             li_point * spot_atten[..., None],
                                             Li)))
    pdf = torch.where(is_tri, pdf_tri, pdf)
    return wi, dist, Li, torch.clamp(pdf, min=1e-12)
