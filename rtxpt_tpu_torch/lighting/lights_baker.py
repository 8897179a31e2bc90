"""Lights baker (counterpart of rtxpt_tpu/lighting/lights_baker.py):
emissive triangles, analytic lights (point, spot, directional, sphere)
and the environment (one kEnvironment light, or `env_quads` region
lights) -> one polymorphic light list with a power-proportional selection
CDF. Host numpy code (the same operations as the JAX package, so the
fields agree bit for bit); the result is a LightList of tensors.

`sample_light` selects and samples lights of every kind over a
wavefront; `light_pdf_for_tri_hit` gives the NEE pdf of an emissive
triangle that a BSDF ray hit and `env_dir_pdf` that of an environment
direction (the MIS counterparts of the general wavefront); on a
two-level scene `emissive_prim_index` maps a hit to its entry of the
expanded light bake."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import math

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.lighting.envmap import (
    _dir_to_uv, _uv_to_dir, env_eval, env_pdf, env_sample)
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
_DELTA_DIST = 1e8   # "infinite" distance for directional / env shadow rays
ENV_QUAD_GRID = (64, 128)   # the uv grid of env_quad_grid


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
    # environment-quad mode: [64,128] i32 light index per equirect uv cell
    # (None when the environment is one kEnvironment light, or absent)
    env_quad_grid: Optional[torch.Tensor] = None
    # the light kinds present, read once from `kind` at construction
    kinds: frozenset = field(init=False, repr=False, compare=False)

    def __post_init__(self):
        object.__setattr__(self, "kinds", frozenset(
            int(k) for k in np.unique(self.kind.detach().cpu().numpy())))

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def lights_from_numpy(fields: dict, device="cuda") -> LightList:
    """LightList on `device` (the GPU by default; raises when there is
    none) from the JAX package's LightList fields as numpy arrays (kind,
    p0, p1, p2, emission, extra, normal, power, cdf, tri_light, env_light,
    num, and env_quad_grid, absent or None without environment quads)."""
    device = rtxpt_tpu_torch.device(device)

    def t(key, dtype=np.float32):
        return torch.tensor(np.asarray(fields[key], dtype), device=device)

    return LightList(
        kind=t("kind", np.int32), p0=t("p0"), p1=t("p1"), p2=t("p2"),
        emission=t("emission"), extra=t("extra"), normal=t("normal"),
        power=t("power"), cdf=t("cdf"), tri_light=t("tri_light", np.int32),
        env_light=int(fields["env_light"]), num=int(fields["num"]),
        env_quad_grid=(None if fields.get("env_quad_grid") is None
                       else t("env_quad_grid", np.int32)))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _env_quad_decompose(img: np.ndarray, n_quads: int):
    """Greedy power-median subdivision of the equirect domain into n_quads
    rects (the JAX package's `_env_quad_decompose`, operation for
    operation). Returns (rects [Q,4] u0 v0 u1 v1, mass [Q] power
    fraction, mean [Q,3] radiance)."""
    h, w = img.shape[:2]
    lum = img @ _LUM
    sin_t = np.sin((np.arange(h) + 0.5) / h * np.pi)[:, None]
    mass = lum * sin_t
    rects = [(0, 0, h, w)]                    # texel rects (y0, x0, y1, x1)
    while len(rects) < n_quads:
        # split the most powerful rect along its longer axis (u counts
        # twice) at the power median
        pw = [mass[y0:y1, x0:x1].sum() for (y0, x0, y1, x1) in rects]
        k = int(np.argmax(pw))
        y0, x0, y1, x1 = rects.pop(k)
        if (y1 - y0) * (x1 - x0) <= 1:
            rects.append((y0, x0, y1, x1))
            break
        if (x1 - x0) * 2 >= (y1 - y0):
            col = mass[y0:y1, x0:x1].sum(0).cumsum()
            cut = int(np.searchsorted(col, col[-1] * 0.5)) + 1
            cut = min(max(cut, 1), x1 - x0 - 1)
            rects += [(y0, x0, y1, x0 + cut), (y0, x0 + cut, y1, x1)]
        else:
            row = mass[y0:y1, x0:x1].sum(1).cumsum()
            cut = int(np.searchsorted(row, row[-1] * 0.5)) + 1
            cut = min(max(cut, 1), y1 - y0 - 1)
            rects += [(y0, x0, y0 + cut, x1), (y0 + cut, x0, y1, x1)]
    total = max(mass.sum(), 1e-12)
    out_r = np.asarray([(x0 / w, y0 / h, x1 / w, y1 / h)
                        for (y0, x0, y1, x1) in rects], np.float32)
    out_m = np.asarray([mass[y0:y1, x0:x1].sum() / total
                        for (y0, x0, y1, x1) in rects], np.float32)
    out_e = np.asarray([img[y0:y1, x0:x1].reshape(-1, 3).mean(0)
                        for (y0, x0, y1, x1) in rects], np.float32)
    return out_r, out_m, out_e


def bake_lights(scene: SceneData, envmap, scene_radius: float,
                env_quads: int = 0, device="cuda") -> LightList:
    """Collect emissive triangles + analytic lights + the environment into
    a LightList on `device` (the GPU by default; raises without one).
    `env_quads > 0` bakes the environment as that many kEnvironmentQuad
    region lights instead of one kEnvironment light."""
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

    # --- environment (kEnvironment / kEnvironmentQuad) ---
    env_light = -1
    env_quad_grid = None
    mean_lum = float(np.asarray(envmap.mean_radiance) @ _LUM)
    env_power = np.pi * scene_radius * scene_radius * mean_lum * np.pi
    if mean_lum > 0.0 and env_quads > 0:
        rects, massf, means = _env_quad_decompose(_np(envmap.image),
                                                  env_quads)
        gh, gw = ENV_QUAD_GRID
        env_quad_grid = np.full((gh, gw), -1, np.int32)
        for q in range(len(rects)):
            u0, v0, u1, v1 = rects[q]
            kinds.append(KIND_ENVQUAD)
            p0s.append(np.zeros(3))
            p1s.append(np.zeros(3))
            p2s.append(np.zeros(3))
            ems.append(means[q])
            extras.append([u0, v0, u1, v1])
            normals.append(np.asarray([0.0, 1.0, 0.0]))
            powers.append(env_power * float(massf[q]))
            x0 = int(round(u0 * gw))
            x1 = max(int(round(u1 * gw)), x0 + 1)
            y0 = int(round(v0 * gh))
            y1 = max(int(round(v1 * gh)), y0 + 1)
            env_quad_grid[y0:y1, x0:x1] = len(kinds) - 1
        assert (env_quad_grid >= 0).all()
    elif mean_lum > 0.0:
        env_light = len(kinds)
        kinds.append(KIND_ENV)
        p0s.append(np.zeros(3))
        p1s.append(np.zeros(3))
        p2s.append(np.zeros(3))
        ems.append(np.asarray(envmap.mean_radiance))
        extras.append([0.0] * 4)
        normals.append(np.asarray([0.0, 1.0, 0.0]))
        powers.append(env_power)

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
        env_light=env_light, num=n,
        env_quad_grid=(None if env_quad_grid is None
                       else t(env_quad_grid, np.int32)))


# ---------------------------------------------------------------------------
# Device sampling
# ---------------------------------------------------------------------------


def sample_light(lights: LightList, envmap, shade_pos, u_sel, u1, u2,
                 uniform: bool = False):
    """Light selection (power CDF, or uniform when `uniform`) and a sample
    of the chosen light, over a wavefront: shade_pos [N,3], u_* [N].

    Returns dict(wi [N,3], dist [N], Li [N,3] unshadowed incident radiance,
    pdf [N] solid-angle pdf (delta lights fold in only the selection pmf
    and report `is_delta`, as spheres do, which no geometry backs),
    valid [N], light_index [N] i32). `envmap` (lighting/envmap.py) serves
    the environment kinds; the branches of kinds the list lacks are not
    computed."""
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

    is_tri = kind == KIND_TRIANGLE
    is_point = kind == KIND_POINT
    is_spot = kind == KIND_SPOT
    is_dir = kind == KIND_DIRECTIONAL
    is_sph = kind == KIND_SPHERE
    is_env = kind == KIND_ENV
    is_envq = kind == KIND_ENVQUAD
    # --- directional: the base of the selects below ---
    wi = -p1
    dist = torch.full_like(dist_p, _DELTA_DIST)
    Li = em
    pdf = sel_pdf
    valid = torch.ones_like(is_tri)
    if KIND_ENV in lights.kinds:
        wi_env, li_env, pdf_env = env_sample(envmap, u1, u2)
        wi = torch.where(is_env[..., None], wi_env, wi)
        Li = torch.where(is_env[..., None], li_env, Li)
        pdf = torch.where(is_env, sel_pdf * pdf_env, pdf)
    if KIND_ENVQUAD in lights.kinds:
        # uniform uv in the quad's rect
        uq = ex[..., 0] + u1 * (ex[..., 2] - ex[..., 0])
        vq = ex[..., 1] + u2 * (ex[..., 3] - ex[..., 1])
        wi_envq = _uv_to_dir(envmap, uq, vq)
        area_q = torch.clamp((ex[..., 2] - ex[..., 0])
                             * (ex[..., 3] - ex[..., 1]), min=1e-9)
        sin_q = torch.clamp(torch.sin(vq * math.pi), min=1e-4)
        wi = torch.where(is_envq[..., None], wi_envq, wi)
        Li = torch.where(is_envq[..., None], env_eval(envmap, wi_envq), Li)
        pdf = torch.where(is_envq, sel_pdf / (area_q * 2.0 * math.pi
                                              * math.pi * sin_q), pdf)
    if KIND_SPHERE in lights.kinds:
        # uniform cone toward the subtended cap
        r_sph = ex[..., 2]
        sin2_max = torch.clamp(r_sph * r_sph / d2p, 0.0, 1.0 - 1e-6)
        cos_max = torch.sqrt(1.0 - sin2_max)
        cos_t = 1.0 - u1 * (1.0 - cos_max)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        phi_s = 2.0 * math.pi * u2
        t_s, b_s = m.orthonormal_basis(wi_p)
        wi_sph = (t_s * (sin_t * torch.cos(phi_s))[..., None]
                  + b_s * (sin_t * torch.sin(phi_s))[..., None]
                  + wi_p * cos_t[..., None])
        # distance to the near sphere surface along wi
        disc = torch.clamp(r_sph * r_sph - d2p * (1.0 - cos_t * cos_t),
                           min=0.0)
        dist_sph = torch.clamp(dist_p * cos_t - torch.sqrt(disc), min=1e-5)
        pdf_sph = sel_pdf / torch.clamp(2.0 * math.pi * (1.0 - cos_max),
                                        min=1e-9)
        wi = torch.where(is_sph[..., None], wi_sph, wi)
        dist = torch.where(is_sph, dist_sph, dist)
        Li = torch.where(is_sph[..., None], em, Li)
        pdf = torch.where(is_sph, pdf_sph, pdf)
        valid = torch.where(is_sph, d2p > r_sph * r_sph, valid)
    point_or_spot = (is_point | is_spot)[..., None]
    wi = torch.where(is_tri[..., None], wi_tri,
                     torch.where(point_or_spot, wi_p, wi))
    dist = torch.where(is_tri, dist_tri,
                       torch.where(is_point | is_spot, dist_p, dist))
    Li = torch.where(is_tri[..., None], em,
                     torch.where(is_point[..., None], li_point,
                                 torch.where(is_spot[..., None],
                                             li_point * spot_atten[..., None],
                                             Li)))
    pdf = torch.where(is_tri, pdf_tri, pdf)
    is_delta = is_point | is_spot | is_dir | is_sph
    valid = torch.where(is_tri, valid_tri, valid) & (pdf > 1e-12) \
        & (sel_pdf > 0.0)
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


def env_select_pdf(lights: LightList, uniform: bool = False) -> float:
    """Discrete probability of selecting the environment light (0 without
    one)."""
    if lights.env_light < 0:
        return 0.0
    if uniform:
        return float(np.float32(1.0) / np.float32(lights.num))
    return float(lights.power[lights.env_light])


def env_quad_of_dir(lights: LightList, envmap, d):
    """(light index [N] int64, uv rect area [N], sin theta [N]) of the
    environment quad holding each direction d [N,3]: the MIS counterpart
    of a miss in quad mode."""
    u, v = _dir_to_uv(envmap, d)
    gh, gw = lights.env_quad_grid.shape
    yi = torch.clamp((v * gh).to(torch.int64), 0, gh - 1)
    xi = torch.clamp((u * gw).to(torch.int64), 0, gw - 1)
    li = lights.env_quad_grid[yi, xi].to(torch.int64)
    ex = lights.extra[torch.clamp(li, min=0)]
    area = torch.clamp((ex[..., 2] - ex[..., 0]) * (ex[..., 3] - ex[..., 1]),
                       min=1e-9)
    sin_t = torch.clamp(torch.sin(v * math.pi), min=1e-4)
    return li, area, sin_t


def env_dir_pdf(lights: LightList, envmap, d, uniform: bool = False):
    """Solid-angle pdf [N] that the power / uniform NEE strategy samples
    direction d [N,3] from the environment: the selection pmf times the
    texel-CDF pdf, or in quad mode the holding quad's selection pmf times
    the uniform-rect jacobian."""
    if lights.env_quad_grid is None:
        return env_select_pdf(lights, uniform) * env_pdf(envmap, d)
    li, area, sin_t = env_quad_of_dir(lights, envmap, d)
    if uniform:
        sel = float(np.float32(1.0) / np.float32(lights.num)) + 0.0 * area
    else:
        sel = lights.power[torch.clamp(li, min=0)]
    return sel / (area * 2.0 * math.pi * math.pi * sin_t)
