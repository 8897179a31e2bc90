"""Surface loading (counterpart of rtxpt_tpu/pt/surface.py): a hit ->
interpolated shading data and BSDF parameters over the scene's gather
packs (`scene.build_packs`), with the materials' texture maps when the
scene has a texture atlas; and the ray-origin offset that every tier
shares. On a two-level scene the pack rows are in object space, and the
hit's instance brings them to world space.

Textures (the general tier's): the ray cone's width sets the MIP level
(0.5 log2(width^2 / |2 area|)); the base-colour, emissive, metal-rough
and normal maps are sampled bilinearly at the nearest MIP
(scene/textures.py sample_texture), or with stochastic texture filtering
one jittered texel each (`stf_u`); the normal map perturbs the shading
normal in the triangle's UV tangent frame."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rtxpt_tpu_torch.pt.bsdf import BSDFData, make_bsdf_data
from rtxpt_tpu_torch.scene import scene as S
from rtxpt_tpu_torch.scene.textures import (
    sample_texture, sample_texture_stochastic)
from rtxpt_tpu_torch.utils import math as m


@dataclass(frozen=True)
class Surface:
    pos: torch.Tensor       # [N,3] hit position (world)
    geo_n: torch.Tensor     # [N,3] geometric normal, oriented toward wo
    sh_n: torch.Tensor      # [N,3] shading normal, oriented toward wo
    uv: torch.Tensor        # [N,2]
    front: torch.Tensor     # [N] bool: ray arrived on the CCW front side
    mat_id: torch.Tensor    # [N] i64
    emissive: torch.Tensor  # [N,3] (zero on back faces)
    bsdf: BSDFData


def load_surface(scene, hit, ray_o, ray_d, cur_ior=None,
                 below_ior=None, cone_width=None, stf_u=None) -> Surface:
    """Shading data of the hits (`accel.traverse.Hit`) of rays ray_o,
    ray_d [N,3]. Lanes that missed hold garbage-but-finite values of
    triangle 0; callers mask them. `cur_ior` / `below_ior` [N] come from
    the medium stack (air when None); `cone_width` [N] is the ray cone's
    width at the hit (a textured scene needs it), `stf_u` [N,2] the
    stochastic filter's uniforms (bilinear filtering when None)."""
    g = scene.tri_pack[torch.clamp(hit.prim, min=0).long()]     # [N,25]
    v0, v1, v2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    n0, n1, n2 = g[:, 9:12], g[:, 12:15], g[:, 15:18]
    t0, t1, t2 = g[:, 18:20], g[:, 20:22], g[:, 22:24]
    mid = g[:, 24].long()
    if getattr(scene, "tlas", None) is not None and hit.inst is not None:
        # object space -> world: positions through the instance's o2w
        # part, normals through its normal matrix
        tp = scene.tlas.inst_pack[torch.clamp(hit.inst, min=0).long()]
        rot, tr = tp[:, 0:9].reshape(-1, 3, 3), tp[:, 9:12]
        nmat = tp[:, 12:21].reshape(-1, 3, 3)
        v0, v1, v2 = (m.matvec(rot, x) + tr for x in (v0, v1, v2))
        n0, n1, n2 = (m.matvec(nmat, x) for x in (n0, n1, n2))

    u = hit.bary[:, 0:1]
    v = hit.bary[:, 1:2]
    w = 1.0 - u - v
    pos = w * v0 + u * v1 + v * v2
    sh_n = m.normalize(w * n0 + u * n1 + v * n2)
    uv = w * t0 + u * t1 + v * t2

    e1 = v1 - v0
    e2 = v2 - v0
    geo_n = m.normalize(m.cross(e1, e2))
    # orient both normals toward the incoming ray (the wo side)
    toward = m.dot(geo_n, -ray_d) > 0.0
    front = toward[:, 0]
    geo_n = torch.where(toward, geo_n, -geo_n)
    sh_n = torch.where(m.dot(sh_n, geo_n) > 0.0, sh_n, -sh_n)

    mp = scene.mat_pack[mid]                                   # [N,18]
    base_color = mp[:, S.MP_BASE:S.MP_BASE + 3]
    metallic, roughness = mp[:, S.MP_METAL], mp[:, S.MP_ROUGH]
    emissive = mp[:, S.MP_EMISSIVE:S.MP_EMISSIVE + 3]
    if getattr(scene, "textures", None) is not None:
        # ray-cone LOD: log2 of the cone width over sqrt(|2 area|)
        tri_area2 = torch.clamp(m.length(m.cross(e1, e2), False), min=1e-20)
        mip = 0.5 * torch.log2(torch.clamp(cone_width * cone_width,
                                           min=1e-30) / tri_area2)
        base_color, metallic, roughness, emissive, sh_n = _textured(
            scene, mid, uv, mip, stf_u, base_color, metallic, roughness,
            emissive, sh_n, geo_n, t0, t1, t2, e1, e2)
    # one-sided emission: front faces only
    emissive = torch.where(front[:, None], emissive, 0.0)
    bsdf = make_bsdf_data(
        base_color, metallic, roughness,
        mp[:, S.MP_IOR], mp[:, S.MP_TRANS], mp[:, S.MP_DTRANS],
        mp[:, S.MP_SPEC], front, cur_ior=cur_ior, below_ior=below_ior,
        anisotropy=mp[:, S.MP_ANISO])
    return Surface(pos=pos, geo_n=geo_n, sh_n=sh_n, uv=uv, front=front,
                   mat_id=mid, emissive=emissive, bsdf=bsdf)


def _textured(scene, mid, uv, mip, stf_u, base_color, metallic, roughness,
              emissive, sh_n, geo_n, t0, t1, t2, e1, e2):
    """The materials' maps at the hits (rtxpt_tpu/pt/surface.py:112-165):
    base colour and emissive multiply, metal-rough scales metallic by B
    and roughness by G (glTF), the normal map perturbs sh_n in the UV
    tangent frame (Gram-Schmidt against sh_n; a degenerate UV mapping or
    tangent keeps sh_n, a perturbed normal below the geometric one too)."""
    atlas, mats = scene.textures, scene.materials
    if stf_u is None:
        def sample(tid):
            return sample_texture(atlas, tid, uv, mip)
    else:
        def sample(tid):
            return sample_texture_stochastic(atlas, tid, uv, mip, stf_u)
    bt = mats.base_color_tex[mid]
    tex_rgba = sample(bt)
    base_color = torch.where((bt >= 0)[:, None],
                             base_color * tex_rgba[:, :3], base_color)
    et = mats.emissive_tex[mid]
    etex = sample(et)
    emissive = torch.where((et >= 0)[:, None], emissive * etex[:, :3],
                           emissive)
    mr = mats.metal_rough_tex[mid]
    mrtex = sample(mr)
    has_mr = mr >= 0
    metallic = torch.where(has_mr, metallic * mrtex[:, 2], metallic)
    roughness = torch.where(has_mr, roughness * mrtex[:, 1], roughness)

    nt = mats.normal_tex[mid]
    ntex = sample(nt)
    n_ts = ntex[:, :3] * 2.0 - 1.0                  # tangent space, [-1, 1]
    duv1 = t1 - t0
    duv2 = t2 - t0
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok_uv = torch.abs(det_uv) > 1e-12
    r = torch.where(ok_uv, 1.0 / torch.where(ok_uv, det_uv, 1.0), 0.0)
    tang = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * r[:, None]
    tang = tang - sh_n * m.dot(tang, sh_n)
    tlen = m.length(tang, False)
    ok = ok_uv & (tlen > 1e-8)
    tang = tang / torch.clamp(tlen, min=1e-8)[:, None]
    bitan = m.cross(sh_n, tang) * torch.sign(det_uv)[:, None]
    n_pert = m.normalize(n_ts[:, 0:1] * tang + n_ts[:, 1:2] * bitan
                         + torch.clamp(n_ts[:, 2:3], min=0.05) * sh_n)
    n_pert = torch.where(m.dot(n_pert, geo_n) > 0.0, n_pert, sh_n)
    sh_n = torch.where((nt >= 0)[:, None] & ok[:, None], n_pert, sh_n)
    return base_color, metallic, roughness, emissive, sh_n


def guide_buffers(surf: Surface, depth, hit, split: bool) -> dict:
    """The aux guide buffers of first hits (rtxpt_tpu/pt/integrator.py
    :389-400): albedo (diffuse + specular F0), shading normal, depth, world
    position and emission, and with `split` the diffuse albedo and the
    specular one (F0 + 0.04); where `hit` [N] does not hold, 1 in the
    albedos and 0 elsewhere."""
    b = surf.bsdf
    h = hit[:, None]
    out = dict(albedo=torch.where(h, b.diffuse + b.specular_f0, 1.0))
    if split:
        out["albedo_diff"] = torch.where(h, b.diffuse, 1.0)
        out["albedo_spec"] = torch.where(h, b.specular_f0 + 0.04, 1.0)
    out.update(normal=torch.where(h, surf.sh_n, 0.0),
               depth=torch.where(hit, depth, 0.0),
               wpos=torch.where(h, surf.pos, 0.0),
               emission=torch.where(h, surf.emissive, 0.0))
    return out


def ray_offset(pos, geo_n, direction):
    """Self-intersection-robust ray origin: `pos` moved along the geometric
    normal, to the side `direction` leaves on. Vectors [..., 3]."""
    scale = torch.clamp(m.length(pos, False), min=1.0) * 3e-5
    side = torch.where(m.dot(direction, geo_n, False) >= 0.0, 1.0, -1.0)
    return pos + geo_n * (side * scale)[..., None]
