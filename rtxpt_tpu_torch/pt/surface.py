"""Surface loading (counterpart of rtxpt_tpu/pt/surface.py): a hit ->
interpolated shading data and BSDF parameters over the scene's gather
packs (`scene.build_packs`), the untextured path; and the ray-origin
offset that every tier shares. On a two-level scene the pack rows are in
object space, and the hit's instance brings them to world space.

The ray cone the JAX package carries into `load_surface` sets only the
texture level of detail; the port serves no textures yet, so it neither
takes a cone width nor returns a mip level."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from rtxpt_tpu_torch.pt.bsdf import BSDFData, make_bsdf_data
from rtxpt_tpu_torch.scene import scene as S
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
                 below_ior=None) -> Surface:
    """Shading data of the hits (`accel.traverse.Hit`) of rays ray_o,
    ray_d [N,3]. Lanes that missed hold garbage-but-finite values of
    triangle 0; callers mask them. `cur_ior` / `below_ior` [N] come from
    the medium stack (air when None)."""
    if getattr(scene, "textures", None) is not None:
        raise NotImplementedError("textured surfaces are not ported to "
                                  "rtxpt_tpu_torch yet")
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

    geo_n = m.normalize(m.cross(v1 - v0, v2 - v0))
    # orient both normals toward the incoming ray (the wo side)
    toward = m.dot(geo_n, -ray_d) > 0.0
    front = toward[:, 0]
    geo_n = torch.where(toward, geo_n, -geo_n)
    sh_n = torch.where(m.dot(sh_n, geo_n) > 0.0, sh_n, -sh_n)

    mp = scene.mat_pack[mid]                                   # [N,18]
    # one-sided emission: front faces only
    emissive = torch.where(front[:, None],
                           mp[:, S.MP_EMISSIVE:S.MP_EMISSIVE + 3], 0.0)
    bsdf = make_bsdf_data(
        mp[:, S.MP_BASE:S.MP_BASE + 3], mp[:, S.MP_METAL], mp[:, S.MP_ROUGH],
        mp[:, S.MP_IOR], mp[:, S.MP_TRANS], mp[:, S.MP_DTRANS],
        mp[:, S.MP_SPEC], front, cur_ior=cur_ior, below_ior=below_ior,
        anisotropy=mp[:, S.MP_ANISO])
    return Surface(pos=pos, geo_n=geo_n, sh_n=sh_n, uv=uv, front=front,
                   mat_id=mid, emissive=emissive, bsdf=bsdf)


def ray_offset(pos, geo_n, direction):
    """Self-intersection-robust ray origin: `pos` moved along the geometric
    normal, to the side `direction` leaves on. Vectors [..., 3]."""
    scale = torch.clamp(m.length(pos, False), min=1.0) * 3e-5
    side = torch.where(m.dot(direction, geo_n, False) >= 0.0, 1.0, -1.0)
    return pos + geo_n * (side * scale)[..., None]
