"""Stable planes: the path-space decomposition of real-time mode
(counterpart of rtxpt_tpu/pt/stable_planes.py).

The BUILD pass walks each camera ray deterministically (no random numbers,
so the planes are stable from frame to frame) through delta surfaces
(smooth mirrors, metals and dielectrics), along the dominant lobe at each:
transmission where (1 - F) carries more luminance than the reflection,
else reflection. The walk ends on the first non-delta surface, the base of
plane 0. At each delta vertex the other lobe's restart ray is a fork; the
two strongest forks (by throughput luminance) seed planes 1 and 2, each of
which walks its own dominant chain to a base. Branch IDs follow the 4-ary
code of the reference: id' = id * 4 + (1 + lobe), lobe 0 the delta
reflection and 1 the transmission, root 1. Each plane keeps its base hit
as a V-buffer (triangle, barycentrics, t, front face), from which the FILL
pass restarts `integrator.trace_paths(first_hit=...)` without tracing the
plane's first segment again.

Every closest-hit query goes through `accel.traverse.scene_closest`: the
brute-force kernel K8 on scenes with brute tables, the BVH walk K9
otherwise, the TLAS walk on two-level scenes (their plain versions on CPU
tensors).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rtxpt_tpu_torch.accel.traverse import Hit, scene_closest
from rtxpt_tpu_torch.pt import bsdf as B
from rtxpt_tpu_torch.pt.surface import load_surface, ray_offset
from rtxpt_tpu_torch.utils import math as m

MAX_PLANES = 3          # cStablePlaneCount (StablePlanes.hlsli:31)
MAX_DELTA_DEPTH = 3


class Plane(NamedTuple):
    o: torch.Tensor          # [N,3] restart ray origin
    d: torch.Tensor          # [N,3] restart ray direction
    thp: torch.Tensor        # [N,3] throughput carried to this plane
    valid: torch.Tensor      # [N] plane exists
    branch_id: torch.Tensor  # [N] i32 4-ary stableBranchID of the chain
    # guide buffers at the plane's base surface (for its denoiser)
    pos: torch.Tensor        # [N,3]
    normal: torch.Tensor     # [N,3]
    albedo: torch.Tensor     # [N,3]
    depth: torch.Tensor      # [N] accumulated chain length
    nverts: torch.Tensor     # [N] i32 path vertices consumed by the chain
    # V-buffer of the base hit (restart trace_paths with first_hit=...)
    vb_prim: torch.Tensor    # [N] i32
    vb_bary: torch.Tensor    # [N,2]
    vb_t: torch.Tensor       # [N]
    vb_front: torch.Tensor   # [N] bool

    def vbuffer(self, max_travel=1e30) -> Hit:
        """The base hits as `first_hit`: a miss (prim -1, t = max_travel)
        where the plane does not exist."""
        return Hit(t=torch.where(self.valid, self.vb_t, max_travel),
                   prim=torch.where(self.valid, self.vb_prim, -1),
                   bary=self.vb_bary, front=self.vb_front)


class _Fork(NamedTuple):
    o: torch.Tensor
    d: torch.Tensor
    thp: torch.Tensor
    valid: torch.Tensor
    branch_id: torch.Tensor
    nverts: torch.Tensor


def _w(cond, a, b):
    """torch.where with `cond` [N] broadcast over a's trailing axes."""
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def _is_delta(surf):
    return (surf.bsdf.alpha < B.DELTA_ALPHA) & (
        (m.luminance(surf.bsdf.specular_f0) > 0.04)
        | (surf.bsdf.transmission > 0.5))


def _delta_lobes(surf, cur_d):
    """Delta reflection and transmission directions and their Fresnel
    weights: (wi_r, wi_t, w_refl, w_trans)."""
    wo = m.to_local(-cur_d, surf.sh_n)
    woz = torch.clamp(wo[..., 2], 0.0, 1.0)
    f_mirror = B.fresnel_schlick(surf.bsdf.specular_f0, woz)
    eta = surf.bsdf.eta
    fd = B.fresnel_dielectric(woz, eta)
    has_trans = surf.bsdf.transmission > 0.5

    wi = m.normalize(-cur_d)
    wi_r = 2.0 * m.dot(wi, surf.sh_n) * surf.sh_n - wi
    cos_i = m.dot(-cur_d, surf.sh_n)[..., 0]
    sin2t = eta * eta * torch.clamp(1.0 - cos_i ** 2, min=0.0)
    tir = sin2t >= 1.0
    cos_t = torch.sqrt(torch.clamp(1.0 - sin2t, min=0.0))
    wi_t = m.normalize(eta[:, None] * cur_d
                       + (eta * cos_i - cos_t)[:, None] * surf.sh_n)
    # dielectrics split by exact Fresnel (total internal reflection gives
    # all to the reflection); metals and mirrors reflect by Schlick
    w_refl = torch.where(has_trans[:, None],
                         torch.where(tir[:, None], 1.0, fd[:, None]),
                         torch.clamp(f_mirror, min=1e-3))
    w_trans = torch.where((has_trans & ~tir)[:, None], (1.0 - fd)[:, None],
                          0.0)
    return wi_r, wi_t, w_refl, w_trans


def _walk(scene, o, d, thp0, valid0, bid0, nv0, max_depth: int,
          collect_forks: bool):
    """Dominant-lobe delta walk. Returns (plane, forks (f1, f2),
    background)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    zeros3 = torch.zeros((n, 3), dtype=f32, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    t0 = torch.zeros((n,), dtype=f32, device=dev)
    t_far = torch.full((n,), 1e30, dtype=f32, device=dev)

    cur_o, cur_d = o, d
    thp = thp0
    walking = valid0
    bid = bid0
    nverts = nv0
    chain_len = t0
    background = zb

    plane = None
    f1 = _Fork(zeros3, zeros3, zeros3, zb, zi, zi)
    f2 = _Fork(zeros3, zeros3, zeros3, zb, zi, zi)

    for depth in range(max_depth + 1):
        hit = scene_closest(scene, cur_o, cur_d, t0, t_far)
        surf = load_surface(scene, hit, cur_o, cur_d, cone_width=t0)
        miss = hit.miss & walking
        background = background | (miss & (chain_len == 0.0))
        walking = walking & ~hit.miss
        chain_len = chain_len + torch.where(walking, hit.t, 0.0)

        delta = _is_delta(surf) & walking & (depth < max_depth)
        terminal = walking & ~delta

        albedo = surf.bsdf.diffuse + surf.bsdf.specular_f0
        prim = hit.prim.to(torch.int32)
        if plane is None:
            plane = Plane(o=cur_o, d=cur_d, thp=thp, valid=terminal,
                          branch_id=bid, pos=surf.pos, normal=surf.sh_n,
                          albedo=albedo, depth=chain_len, nverts=nverts,
                          vb_prim=prim, vb_bary=hit.bary, vb_t=hit.t,
                          vb_front=hit.front)
        else:
            new = terminal & ~plane.valid
            plane = Plane(
                o=_w(new, cur_o, plane.o), d=_w(new, cur_d, plane.d),
                thp=_w(new, thp, plane.thp), valid=plane.valid | new,
                branch_id=_w(new, bid, plane.branch_id),
                pos=_w(new, surf.pos, plane.pos),
                normal=_w(new, surf.sh_n, plane.normal),
                albedo=_w(new, albedo, plane.albedo),
                depth=_w(new, chain_len, plane.depth),
                nverts=_w(new, nverts, plane.nverts),
                vb_prim=_w(new, prim, plane.vb_prim),
                vb_bary=_w(new, hit.bary, plane.vb_bary),
                vb_t=_w(new, hit.t, plane.vb_t),
                vb_front=_w(new, hit.front, plane.vb_front))

        wi_r, wi_t, w_refl, w_trans = _delta_lobes(surf, cur_d)
        lum_r = m.luminance(thp * w_refl)
        lum_t = m.luminance(thp * w_trans)
        dom_trans = delta & (lum_t > lum_r)

        if collect_forks:
            # the non-dominant lobe is a fork candidate; keep the two
            # strongest by throughput luminance
            fd = _w(dom_trans, wi_r, wi_t)
            fo = ray_offset(surf.pos, surf.geo_n, fd)
            fthp = thp * _w(dom_trans, w_refl, w_trans)
            fbid = bid * 4 + torch.where(dom_trans, 1, 2).to(torch.int32)
            fnv = nverts + 1                 # the fork vertex is consumed
            flum = m.luminance(fthp)
            fvalid = delta & (flum > 1e-4)

            put1 = fvalid & (~f1.valid | (flum > m.luminance(f1.thp)))
            # the previous f1 moves down to f2 where it is overwritten
            demote = put1 & f1.valid
            put2 = fvalid & ~put1 & (~f2.valid
                                     | (flum > m.luminance(f2.thp)))
            f2 = _Fork(
                o=_w(demote, f1.o, _w(put2, fo, f2.o)),
                d=_w(demote, f1.d, _w(put2, fd, f2.d)),
                thp=_w(demote, f1.thp, _w(put2, fthp, f2.thp)),
                valid=torch.where(demote, f1.valid, f2.valid | put2),
                branch_id=_w(demote, f1.branch_id,
                             _w(put2, fbid, f2.branch_id)),
                nverts=_w(demote, f1.nverts, _w(put2, fnv, f2.nverts)))
            f1 = _Fork(
                o=_w(put1, fo, f1.o), d=_w(put1, fd, f1.d),
                thp=_w(put1, fthp, f1.thp), valid=f1.valid | put1,
                branch_id=_w(put1, fbid, f1.branch_id),
                nverts=_w(put1, fnv, f1.nverts))

        # continue along the dominant lobe
        wi = _w(dom_trans, wi_t, wi_r)
        thp = thp * _w(delta, _w(dom_trans, w_trans, w_refl),
                       torch.ones_like(thp))
        bid = torch.where(delta, bid * 4 + torch.where(dom_trans, 2, 1)
                          .to(torch.int32), bid)
        nverts = nverts + delta.to(torch.int32)
        cur_o = _w(delta, ray_offset(surf.pos, surf.geo_n, wi), cur_o)
        cur_d = _w(delta, wi, cur_d)
        walking = delta

    return plane, (f1, f2), background


def decompose(scene, o, d):
    """The BUILD pass: deterministic delta-tree exploration from the camera
    rays o, d [N,3]. Returns (planes, a list of MAX_PLANES Plane, the
    background mask [N]: camera rays that miss everything)."""
    n = o.shape[0]
    dev = o.device
    o, d = o.contiguous(), d.contiguous()   # camera origins are broadcast
    ones3 = torch.ones((n, 3), dtype=torch.float32, device=dev)
    root_id = torch.ones((n,), dtype=torch.int32, device=dev)
    zi = torch.zeros((n,), dtype=torch.int32, device=dev)
    plane0, (f1, f2), background = _walk(
        scene, o, d, ones3, torch.ones((n,), dtype=torch.bool, device=dev),
        root_id, zi, MAX_DELTA_DEPTH, collect_forks=True)
    # planes 1 and 2 continue each fork's own dominant chain (the fork rays
    # already start past their fork vertex)
    plane1, _, _ = _walk(scene, f1.o, f1.d, f1.thp, f1.valid, f1.branch_id,
                         f1.nverts, MAX_DELTA_DEPTH - 1, collect_forks=False)
    plane2, _, _ = _walk(scene, f2.o, f2.d, f2.thp, f2.valid, f2.branch_id,
                         f2.nverts, MAX_DELTA_DEPTH - 1, collect_forks=False)
    return [plane0, plane1, plane2], background
