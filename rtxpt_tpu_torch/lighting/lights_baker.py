"""Lights baker (counterpart of rtxpt_tpu/lighting/lights_baker.py):
emissive triangles and analytic lights -> one polymorphic light list with
a power-proportional selection CDF. Host numpy code (the same operations
as the JAX package, so the fields agree bit for bit); the result is a
LightList of tensors. `sample_light` selects and samples lights over a
wavefront, for triangle, point, spot and directional lights, and
`light_pdf_for_tri_hit` gives the NEE pdf of an emissive triangle that a
BSDF ray hit (the emissive MIS of the general wavefront); on a two-level
scene `emissive_prim_index` maps the hit to its entry of the expanded
light bake. The environment
light, environment quads and sphere lights come with the environment
slice."""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.scene.scene import (
    LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPHERE, SceneData,
)
from rtxpt_tpu_torch.utils import math as m

# Polymorphic light kinds (same codes as the JAX package)
KIND_TRIANGLE = 0
KIND_POINT = 1
KIND_DIRECTIONAL = 2
KIND_SPOT = 3
KIND_ENV = 4
KIND_SPHERE = 5
KIND_ENVQUAD = 6

_LUM = np.asarray([0.2126, 0.7152, 0.0722])
_DELTA_DIST = 1e8   # "infinite" distance for directional shadow rays
_UNPORTED_KINDS = {KIND_ENV: "environment", KIND_SPHERE: "sphere",
                   KIND_ENVQUAD: "environment-quad"}


@dataclass(frozen=True)
class LightList:
    kind: torch.Tensor       # [L] i32
    p0: torch.Tensor         # [L,3] tri v0 / light position
    p1: torch.Tensor         # [L,3] tri edge1 / spot direction
    p2: torch.Tensor         # [L,3] tri edge2
    emission: torch.Tensor   # [L,3]
    extra: torch.Tensor      # [L,4] tri (area, ...), spot (cos_in, cos_out)
    normal: torch.Tensor     # [L,3]
    power: torch.Tensor      # [L] normalized selection pmf
    cdf: torch.Tensor        # [L] inclusive selection CDF
    tri_light: torch.Tensor  # [T] i32 triangle -> light index (-1 none)
    env_light: int           # index of the environment light (-1 none)
    num: int
    # the light kinds present, read once from `kind` at construction
    kinds: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kinds", frozenset(
            int(k) for k in np.unique(self.kind.detach().cpu().numpy())))

    @property
    def count(self) -> int:
        return self.kind.shape[0]

    def require_sampled_kinds(self):
        """Raise NotImplementedError, naming the kind, when the list holds
        a light that `sample_light` does not sample yet."""
        for kind in sorted(self.kinds & _UNPORTED_KINDS.keys()):
            raise NotImplementedError(
                f"sampling {_UNPORTED_KINDS[kind]} lights is not ported to "
                f"rtxpt_tpu_torch yet")


def lights_from_numpy(fields: dict, device="cuda") -> LightList:
    """LightList on `device` (the GPU by default; raises when there is
    none) from the JAX package's LightList fields as numpy arrays (kind,
    p0, p1, p2, emission, extra, normal, power, cdf, tri_light, env_light,
    num)."""
    device = rtxpt_tpu_torch.device(device)

    def t(key, dtype=np.float32):
        return torch.tensor(np.asarray(fields[key], dtype), device=device)

    return LightList(
        kind=t("kind", np.int32), p0=t("p0"), p1=t("p1"), p2=t("p2"),
        emission=t("emission"), extra=t("extra"), normal=t("normal"),
        power=t("power"), cdf=t("cdf"), tri_light=t("tri_light", np.int32),
        env_light=int(fields["env_light"]), num=int(fields["num"]))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def bake_lights(scene: SceneData, envmap, scene_radius: float,
                device="cuda") -> LightList:
    """Collect emissive triangles + analytic lights into a LightList on
    `device` (the GPU by default; raises without one)."""
    device = rtxpt_tpu_torch.device(device)
    geo = scene.geometry
    pos = _np(geo.positions)
    idx = _np(geo.indices)
    mat_id = _np(geo.tri_material)
    emissive = _np(scene.materials.emissive)

    kinds, p0s, p1s, p2s, ems, extras, normals, powers = \
        [], [], [], [], [], [], [], []
    tri_light = np.full((len(idx),), -1, np.int32)

    # --- emissive triangles ---
    tri_em = emissive[mat_id]
    lum = tri_em @ _LUM
    for t in np.nonzero(lum > 0.0)[0]:
        v0, v1, v2 = pos[idx[t, 0]], pos[idx[t, 1]], pos[idx[t, 2]]
        e1, e2 = v1 - v0, v2 - v0
        cr = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cr)
        if area <= 1e-12:
            continue
        tri_light[t] = len(kinds)
        kinds.append(KIND_TRIANGLE)
        p0s.append(v0)
        p1s.append(e1)
        p2s.append(e2)
        ems.append(tri_em[t])
        extras.append([area, 0.0, 0.0, 0.0])
        normals.append(cr / (2.0 * area))
        powers.append(float(lum[t]) * area * np.pi)   # one-sided Lambert

    # --- analytic lights ---
    al = scene.analytic_lights
    akind = _np(al.kind)
    for i in range(len(akind)):
        k = int(akind[i])
        inten = _np(al.intensity[i])
        ilum = float(inten @ _LUM)
        if k == LIGHT_POINT:
            kinds.append(KIND_POINT)
            powers.append(4.0 * np.pi * ilum)
        elif k == LIGHT_DIRECTIONAL:
            kinds.append(KIND_DIRECTIONAL)
            powers.append(np.pi * scene_radius * scene_radius * ilum)
        elif k == LIGHT_SPHERE:
            r = float(_np(al.angular_size[i]))
            kinds.append(KIND_SPHERE)
            powers.append(4.0 * np.pi * np.pi * r * r * ilum)
        else:
            kinds.append(KIND_SPOT)
            co = float(_np(al.cos_outer[i]))
            powers.append(2.0 * np.pi * max(1.0 - co, 0.05) * ilum)
        p0s.append(_np(al.position[i]))
        p1s.append(_np(al.direction[i]))
        p2s.append(np.zeros(3))
        ems.append(inten)
        extras.append([float(_np(al.cos_inner[i])),
                       float(_np(al.cos_outer[i])),
                       float(_np(al.angular_size[i])), 0.0])
        normals.append(_np(al.direction[i]))

    mean_lum = float(np.asarray(envmap.mean_radiance) @ _LUM)
    if mean_lum > 0.0:
        raise NotImplementedError(
            "environment lights are not ported to rtxpt_tpu_torch yet")

    n = len(kinds)
    if n == 0:
        # one dummy zero-power light keeps the shapes non-empty
        kinds = [KIND_POINT]
        p0s, p1s, p2s, ems = ([np.zeros(3)] for _ in range(4))
        extras = [[0.0] * 4]
        normals = [np.asarray([0.0, 1.0, 0.0])]
        powers = [0.0]
        n = 1

    powers = np.asarray(powers, np.float64)
    total = powers.sum()
    pdf = powers / total if total > 0 else np.full(n, 1.0 / n)
    cdf = np.cumsum(pdf)
    cdf[-1] = 1.0

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return LightList(
        kind=t(kinds, np.int32), p0=t(p0s), p1=t(p1s), p2=t(p2s),
        emission=t(ems), extra=t(extras), normal=t(normals),
        power=t(pdf), cdf=t(cdf), tri_light=t(tri_light, np.int32),
        env_light=-1, num=n)


# ---------------------------------------------------------------------------
# Device sampling
# ---------------------------------------------------------------------------


def sample_light(lights: LightList, envmap, shade_pos, u_sel, u1, u2,
                 uniform: bool = False):
    """Light selection (power CDF, or uniform when `uniform`) and a sample
    of the chosen light, over a wavefront: shade_pos [N,3], u_* [N].

    Returns dict(wi [N,3], dist [N], Li [N,3] unshadowed incident radiance,
    pdf [N] solid-angle pdf (delta lights fold in only the selection pmf
    and report `is_delta`), valid [N], light_index [N] i32). `envmap` is
    read by the environment kinds, which raise NotImplementedError."""
    lights.require_sampled_kinds()
    u_sel = torch.clamp(u_sel, 0.0, 1.0 - 1e-7)
    if uniform:
        nf = float(lights.num)
        li = torch.clamp((u_sel * nf).to(torch.int64), 0, lights.count - 1)
        sel_pdf = torch.full_like(u_sel, 1.0) / nf
    else:
        li = torch.clamp(torch.searchsorted(lights.cdf, u_sel), 0,
                         lights.count - 1)
        sel_pdf = lights.power[li]
    kind = lights.kind[li]
    p0 = lights.p0[li]
    p1 = lights.p1[li]
    p2 = lights.p2[li]
    em = lights.emission[li]
    ex = lights.extra[li]
    nl = lights.normal[li]

    # --- triangle area light ---
    b0, b1, b2 = m.sample_triangle_barycentrics(u1, u2)
    lp = p0 + b1[..., None] * p1 + b2[..., None] * p2
    to_l = lp - shade_pos
    d2 = torch.clamp(m.dot(to_l, to_l, False), min=1e-12)
    dist_tri = torch.sqrt(d2)
    wi_tri = to_l / dist_tri[..., None]
    cos_l = m.dot(-wi_tri, nl, False)
    area = torch.clamp(ex[..., 0], min=1e-12)
    pdf_tri = sel_pdf * d2 / torch.clamp(
        area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    valid_tri = cos_l > 1e-6

    # --- point / spot ---
    to_p = p0 - shade_pos
    d2p = torch.clamp(m.dot(to_p, to_p, False), min=1e-12)
    dist_p = torch.sqrt(d2p)
    wi_p = to_p / dist_p[..., None]
    li_point = em / d2p[..., None]
    cos_spot = m.dot(-wi_p, p1, False)
    spot_atten = torch.clamp((cos_spot - ex[..., 1])
                             / torch.clamp(ex[..., 0] - ex[..., 1], min=1e-6),
                             0.0, 1.0)
    spot_atten = spot_atten * spot_atten

    # --- directional ---
    wi_dir = -p1

    is_tri = kind == KIND_TRIANGLE
    is_point = kind == KIND_POINT
    is_spot = kind == KIND_SPOT
    wi = torch.where(is_tri[..., None], wi_tri,
                     torch.where((is_point | is_spot)[..., None], wi_p,
                                 wi_dir))
    dist = torch.where(is_tri, dist_tri,
                       torch.where(is_point | is_spot, dist_p,
                                   torch.full_like(dist_p, _DELTA_DIST)))
    Li = torch.where(is_tri[..., None], em,
                     torch.where(is_point[..., None], li_point,
                                 torch.where(is_spot[..., None],
                                             li_point * spot_atten[..., None],
                                             em)))
    pdf = torch.where(is_tri, pdf_tri, sel_pdf)
    is_delta = is_point | is_spot | (kind == KIND_DIRECTIONAL)
    valid = (valid_tri | ~is_tri) & (pdf > 1e-12) & (sel_pdf > 0.0)
    return dict(wi=wi, dist=dist, Li=Li, pdf=pdf, is_delta=is_delta,
                valid=valid, light_index=li.to(torch.int32))


def emissive_prim_index(scene, prim, inst):
    """The light-bake triangle id of a hit (prim, inst) [N]. Flattened
    scenes bake per triangle, so it is the hit's own id (`inst` is not
    read and may be None). Two-level scenes bake the expanded (instance x
    emissive pool triangle) list: the id is inst_light_base[inst] +
    em_rank[prim], -1 where the hit triangle is not emissive or the ray
    missed; they need `inst`. The gathers index the pool and the
    instances, never the light list, so a scene without emissive
    triangles is safe."""
    tl = getattr(scene, "tlas", None)
    if tl is None:
        return prim
    if inst is None:
        raise ValueError("emissive_prim_index: a two-level scene needs the "
                         "hit's instance ids")
    rank = tl.em_rank[torch.clamp(prim, min=0).long()]
    base = tl.inst_light_base[torch.clamp(inst, min=0).long()]
    ok = (prim >= 0) & (inst >= 0) & (rank >= 0)
    return torch.where(ok, base + rank, -1)


def tri_light_of(lights: LightList, prim):
    """Light index of each hit triangle [N] (-1: none, or a miss). A light
    list without triangles (an empty tri_light) gives -1 everywhere instead
    of gathering from an empty table."""
    if lights.tri_light.numel() == 0:
        return torch.full_like(prim, -1, dtype=torch.int32)
    li = lights.tri_light[torch.clamp(prim, min=0).long()]
    return torch.where(prim >= 0, li, -1)


def light_pdf_for_tri_hit(lights: LightList, prim, dist, cos_l,
                          uniform: bool = False):
    """Solid-angle NEE pdf of having sampled the emissive triangle that a
    BSDF ray hit, [N] (0 where the hit is no light). prim [N] original
    triangle id (-1 miss); dist [N]; cos_l [N] |cos| at the light."""
    li = tri_light_of(lights, prim)
    has_light = li >= 0
    lix = torch.clamp(li, min=0).long()
    if uniform:
        sel_pdf = 1.0 / float(lights.num)
    else:
        sel_pdf = lights.power[lix]
    area = torch.clamp(lights.extra[lix, 0], min=1e-12)
    pdf = sel_pdf * dist * dist / torch.clamp(
        area * torch.clamp(cos_l, min=1e-9), min=1e-12)
    return torch.where(has_light, pdf, 0.0)
