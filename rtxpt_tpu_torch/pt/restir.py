"""ReSTIR DI (counterpart of rtxpt_tpu/pt/restir.py). Only
`eval_light_sample` is ported: NEE-AT's `sample_adaptive`
(lighting/neeat.py) re-evaluates its chosen light with it. The
reservoirs, the resampling passes and the G-buffer come with the
real-time slice."""

from __future__ import annotations

import torch

from rtxpt_tpu_torch.lighting.lights_baker import (
    _DELTA_DIST, KIND_POINT, KIND_SPOT, KIND_TRIANGLE, LightList,
)
from rtxpt_tpu_torch.utils import math as m


def eval_light_sample(lights: LightList, envmap, li, uv, shade_pos):
    """Re-evaluate a light sample given by light index li [N] and sample
    parameters uv [N, 2] at shade_pos [N, 3], deterministically (the same
    mapping as lights_baker.sample_light), for triangle, point, spot and
    directional lights; the other kinds raise NotImplementedError.

    Returns (wi [N,3], dist [N], Li [N,3], source pdf [N]: solid angle,
    with the power selection pmf folded in, at least 1e-12)."""
    lights.require_sampled_kinds()
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
    wi = torch.where(is_tri[..., None], wi_tri,
                     torch.where((is_point | is_spot)[..., None], wi_p, -p1))
    dist = torch.where(is_tri, dist_tri,
                       torch.where(is_point | is_spot, dist_p,
                                   torch.full_like(dist_p, _DELTA_DIST)))
    Li = torch.where(is_tri[..., None], li_tri,
                     torch.where(is_point[..., None], li_point,
                                 torch.where(is_spot[..., None],
                                             li_point * spot_atten[..., None],
                                             em)))
    pdf = torch.where(is_tri, pdf_tri, sel_pdf)
    return wi, dist, Li, torch.clamp(pdf, min=1e-12)
