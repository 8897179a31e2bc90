"""Opacity micromaps and alpha-tested traversal (counterpart of
rtxpt_tpu/scene/omm.py).

The bake classifies every alpha-tested triangle against its base-colour
texture's alpha, sampled over the triangle: OPAQUE triangles need no
test, TRANSPARENT ones are dropped before the BVH, the lights and the
kernel tables are built, and MIXED ones get a level-2 micromap: 16
micro-triangles of 2-bit states (0 opaque, 1 unknown, 2 transparent)
packed little-endian by `micro_index` into one 32-bit word, and the mean
alpha-pass fraction over the UNKNOWN cells (the coverage the kernels'
stochastic shadow test draws against). The bake is numpy and draws its
sample points from the same seeded generators as the JAX package, so
classes, words and coverages come out equal to its bake.

At run time decisive states resolve inside the traversal (the BVH walk,
the fused and clustered kernels reject micro-TRANSPARENT hits), and only
micro-UNKNOWN hits take the texture alpha test: the general tier's
`intersect_closest_alpha` re-traces past a failing hit (at most
MAX_ALPHA_RETRACE times); the kernel tiers pass through it on the next
wavefront iteration (pt/bounce_fused.py surface_and_shade).

The words are u32. CPU PyTorch has no u32 right shift, so the port's
tables keep their bits as int32 (the top bit may be set) and
`micro_state` decodes a state in int64 with masks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from rtxpt_tpu_torch.scene.textures import sample_texture

OPAQUE, MIXED, TRANSPARENT = 0, 1, 2
# micro-triangle 2-bit states (packed little-endian by micro index)
MICRO_OPAQUE, MICRO_UNKNOWN, MICRO_TRANSPARENT = 0, 1, 2
MICRO_LEVEL = 2                      # 4^2 = 16 micro-triangles = 32 bits
_BAKE_SAMPLES = 64
_MICRO_SAMPLES = 16
MAX_ALPHA_RETRACE = 4


def micro_index(u, v, level: int = MICRO_LEVEL):
    """Micro-triangle index of barycentric (u, v) at `level` (S = 2^level
    rows; row b holds 2 (S - b) - 1 cells, upright and inverted
    interleaved). numpy inputs (float64, as the bake) give int64; torch
    inputs (f32, as the kernels) give int32."""
    S = 1 << level
    eps = 1e-7
    if isinstance(u, torch.Tensor):
        uu = u * S
        vv = v * S
        a = torch.clamp(torch.floor(uu), max=S - 1)
        b = torch.clamp(torch.floor(vv), max=S - 1)
        inv = ((uu - a) + (vv - b)) > 1.0 + eps
        a = torch.minimum(a, S - 1 - b)
        idx = (b * (2 * S - b) + 2 * a
               + torch.where(inv & (a + b < S - 1), 1.0, 0.0))
        return idx.to(torch.int32)
    uu = u * S
    vv = v * S
    a = np.minimum(np.floor(uu), S - 1)
    b = np.minimum(np.floor(vv), S - 1)
    inv = ((uu - a) + (vv - b) > 1.0 + eps)
    a = np.minimum(a, S - 1 - b)
    idx = b * (2 * S - b) + 2 * a + np.where(inv & (a + b < S - 1), 1, 0)
    return idx.astype(np.int64) if isinstance(idx, np.ndarray) else int(idx)


def micro_state(word, mi):
    """The 2-bit state of micro-triangle `mi` in `word` (tensors; a word
    stored as int32 with its top bit set reads as its u32 value)."""
    w = word.to(torch.int64) & 0xFFFFFFFF
    return (w >> (2 * mi.to(torch.int64))) & 3


def _micro_sample_grid(level: int):
    """Per-micro-triangle barycentric sample points [M,2] (s1 + s2 <= 1),
    the JAX package's generator and seed."""
    rng = np.random.default_rng(13)
    s1 = rng.uniform(0, 1, _MICRO_SAMPLES)
    s2 = rng.uniform(0, 1, _MICRO_SAMPLES)
    flip = s1 + s2 > 1
    s1 = np.where(flip, 1 - s1, s1)
    s2 = np.where(flip, 1 - s2, s2)
    return np.stack([s1, s2], -1)


def _micro_uv():
    """[16 * M, 2] barycentric sample points of every micro-triangle, in
    micro_index order."""
    S = 1 << MICRO_LEVEL
    ss = _micro_sample_grid(MICRO_LEVEL)
    micro_uv = np.zeros((S * S, _MICRO_SAMPLES, 2), np.float64)
    for b in range(S):
        for a in range(S - b):
            idx_up = b * (2 * S - b) + 2 * a
            micro_uv[idx_up] = np.stack([a + ss[:, 0], b + ss[:, 1]], -1) / S
            if a + b < S - 1:
                micro_uv[idx_up + 1] = np.stack(
                    [a + 1 - ss[:, 0], b + 1 - ss[:, 1]], -1) / S
    return micro_uv.reshape(-1, 2)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _alpha_at(img, uvpts):
    """Nearest-texel alpha of `img` at uv points [..., 2] (repeat wrap)."""
    h, w = img.shape[:2]
    xi = np.clip((uvpts[..., 0] % 1.0) * w, 0, w - 1).astype(int)
    yi = np.clip((uvpts[..., 1] % 1.0) * h, 0, h - 1).astype(int)
    a = img[yi, xi, 3]
    if a.dtype == np.uint8:
        a = a.astype(np.float32) / 255.0
    return a


def bake_opacity(host_scene, materials, textures_np) -> Optional[np.ndarray]:
    """Classes [T] uint8 of every flattened triangle, or None when the
    scene has no alpha-tested material."""
    out = bake_opacity_micromaps(host_scene, materials, textures_np)
    return None if out is None else out[0]


def bake_opacity_micromaps(host_scene, materials, textures_np):
    """The full bake: (classes [T] uint8, micromaps [T] uint32,
    cover_unknown [T] f32) over the flattened triangles, or None when no
    material is alpha-tested or the host has no textures. A triangle is
    alpha-tested when its material has a cutoff >= 0 and a base-colour
    texture with an alpha channel; its 64 bake samples' pass fraction
    classifies it, and a MIXED triangle's 16 x 16 micro samples give its
    word and coverage. The JAX package's bake triangle by triangle, here
    vectorised over each instance's triangles (the same elementwise
    float64 arithmetic, so equal results)."""
    cutoff = _np(materials.alpha_cutoff)
    tex_idx = _np(materials.base_color_tex)
    if not (cutoff >= 0).any() or textures_np is None:
        return None

    rng = np.random.default_rng(7)
    b1 = rng.uniform(0, 1, _BAKE_SAMPLES)
    b2 = rng.uniform(0, 1, _BAKE_SAMPLES)
    flip = b1 + b2 > 1
    b1 = np.where(flip, 1 - b1, b1)
    b2 = np.where(flip, 1 - b2, b2)
    n_micro = (1 << MICRO_LEVEL) ** 2
    micro_uv = _micro_uv()
    w0 = 1.0 - micro_uv[:, 0] - micro_uv[:, 1]
    shifts = (2 * np.arange(n_micro)).astype(np.uint64)

    classes, micromaps, covers = [], [], []
    for inst in host_scene.instances:
        t = len(inst.indices)
        cls = np.zeros((t,), np.uint8)
        words = np.zeros((t,), np.uint32)
        cov = np.ones((t,), np.float32)
        mats = np.asarray(inst.material).astype(np.int64)
        for mat in np.unique(mats):
            tid = int(tex_idx[mat])
            if cutoff[mat] < 0 or tid < 0:
                continue
            img = textures_np[tid]
            if img.shape[-1] < 4:
                continue
            sel = np.nonzero(mats == mat)[0]
            tri = np.asarray(inst.indices)[sel]
            uv = inst.uvs
            u0, u1, u2 = (uv[tri[:, k]] for k in range(3))     # [s,2]
            uvs = (u0[:, None] * (1 - b1 - b2)[None, :, None]
                   + u1[:, None] * b1[None, :, None]
                   + u2[:, None] * b2[None, :, None])           # [s,64,2]
            frac = (_alpha_at(img, uvs) >= cutoff[mat]).mean(-1)
            opaque = frac >= 1.0 - 1e-6
            transparent = ~opaque & (frac <= 1e-6)
            mixed = ~opaque & ~transparent
            cls[sel[transparent]] = TRANSPARENT
            cov[sel[transparent]] = 0.0
            if not mixed.any():
                continue
            ms = sel[mixed]
            m0, m1, m2 = u0[mixed], u1[mixed], u2[mixed]
            uvm = (m0[:, None] * w0[None, :, None]
                   + m1[:, None] * micro_uv[None, :, 0:1]
                   + m2[:, None] * micro_uv[None, :, 1:2])     # [s,256,2]
            am = _alpha_at(img, uvm).reshape(len(ms), n_micro,
                                             _MICRO_SAMPLES)
            passed = am >= cutoff[mat]
            st = np.where(passed.all(-1), MICRO_OPAQUE,
                          np.where(~passed.any(-1), MICRO_TRANSPARENT,
                                   MICRO_UNKNOWN)).astype(np.uint64)
            words[ms] = (st << shifts[None]).sum(-1).astype(np.uint32)
            unk = st == MICRO_UNKNOWN                           # [s,16]
            n_unk = unk.sum(-1)
            p_unk = (passed & unk[..., None]).sum((-1, -2))
            cover = np.where(n_unk > 0, p_unk / np.maximum(
                n_unk * _MICRO_SAMPLES, 1), frac[mixed])
            cls[ms] = MIXED
            cov[ms] = cover
        classes.append(cls)
        micromaps.append(words)
        covers.append(cov)
    return (np.concatenate(classes).astype(np.uint8),
            np.concatenate(micromaps).astype(np.uint32),
            np.concatenate(covers).astype(np.float32))


def alpha_fail(scene, hit):
    """[N] bool: the hits that the alpha test rejects (rtxpt_tpu/scene/
    omm.py intersect_closest_alpha's test): a MIXED triangle whose
    micro-triangle state is TRANSPARENT, or UNKNOWN with its base-colour
    texture's alpha (bilinear at MIP 0) under the material's cutoff
    (without micromaps, every MIXED hit takes the texture test)."""
    geo = scene.geometry
    mats = scene.materials
    prim = torch.clamp(hit.prim, min=0).long()
    mixed = ~hit.miss & (scene.tri_opacity[prim] == MIXED)
    tri = geo.indices[prim].long()
    u = hit.bary[:, 0:1]
    v = hit.bary[:, 1:2]
    uv = ((1 - u - v) * geo.uvs[tri[:, 0]] + u * geo.uvs[tri[:, 1]]
          + v * geo.uvs[tri[:, 2]])
    mid = geo.tri_material[prim].long()
    cut = mats.alpha_cutoff[mid]
    rgba = sample_texture(scene.textures, mats.base_color_tex[mid], uv,
                          torch.zeros_like(cut))
    tex_fail = (rgba[:, 3] < cut) & (cut >= 0.0)
    if scene.tri_micromap is None:
        return mixed & tex_fail
    st = micro_state(scene.tri_micromap[prim],
                     micro_index(hit.bary[:, 0], hit.bary[:, 1]))
    return mixed & ((st == MICRO_TRANSPARENT)
                    | ((st == MICRO_UNKNOWN) & tex_fail))


def intersect_closest_alpha(scene, o, d, tmin, tmax):
    """Closest hit with the alpha test: a rejected hit is re-traced from
    just past it (a relative step, t (1 + 1e-4) + 1e-5: an absolute one
    underflows in f32 far out), at most MAX_ALPHA_RETRACE times. The JAX
    package runs every round; a round in which nothing fails leaves every
    hit as it is, so the loop stops there."""
    from rtxpt_tpu_torch.accel.traverse import intersect_closest

    hit = intersect_closest(scene.bvh, o, d, tmin, tmax)
    if scene.tri_opacity is None or scene.textures is None:
        return hit
    cur_tmin = tmin
    for _ in range(MAX_ALPHA_RETRACE):
        fail = alpha_fail(scene, hit)
        if not bool(fail.any()):
            break
        cur_tmin = torch.where(fail, hit.t * (1.0 + 1e-4) + 1e-5, cur_tmin)
        hit = hit.where(fail, intersect_closest(scene.bvh, o, d, cur_tmin,
                                                tmax))
    return hit


def intersect_any_alpha(scene, o, d, tmin, tmax):
    """Occlusion [N] bool with the alpha test: the alpha-tested closest
    hit within (tmin, tmax)."""
    return ~intersect_closest_alpha(scene, o, d, tmin, tmax).miss
