"""Texture atlas (counterpart of rtxpt_tpu/scene/textures.py): every
texture's MIP chain in ONE flat [texels, 4] RGBA array with a per-texture,
per-MIP offset table; a fetch is offset arithmetic plus gathers at the
ray-cone-selected MIP.

`bake_textures` builds the MIP chains in host numpy with the JAX package's
box filter, so every field agrees with it, and holds the result as torch
tensors on the render device. `sample_texture` (bilinear at the nearest
MIP) and `sample_texture_stochastic` (one jittered texel: stochastic
texture filtering) are the general tier's samplers. The fused and
clustered kernels read the atlas through pt/bounce_fused.py
`build_tex_tables` with their own per-lane fetch (`tex_fetch`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

import rtxpt_tpu_torch

MAX_MIPS = 14


@dataclass(frozen=True)
class TextureAtlas:
    data: torch.Tensor        # [texels, 4] f32 RGBA (linear)
    mip_offset: torch.Tensor  # [T, MAX_MIPS] i32 start texel of each MIP
    width: torch.Tensor       # [T] i32 base width
    height: torch.Tensor      # [T] i32 base height
    n_mips: torch.Tensor      # [T] i32

    @property
    def count(self) -> int:
        return self.width.shape[0]

    @property
    def device(self):
        return self.data.device


def _build_mips(img: np.ndarray) -> List[np.ndarray]:
    """Box-filtered MIP chain down to 1x1 (even-size halving, numpy)."""
    mips = [img]
    cur = img
    while max(cur.shape[0], cur.shape[1]) > 1:
        h, w = cur.shape[:2]
        nh, nw = max(h // 2, 1), max(w // 2, 1)
        # pad to even for clean 2x2 averaging
        ph, pw = nh * 2, nw * 2
        pad = cur[:ph, :pw]
        if pad.shape[0] < ph or pad.shape[1] < pw:
            pad = np.pad(cur, ((0, ph - cur.shape[0]), (0, pw - cur.shape[1]),
                               (0, 0)), mode="edge")
        nxt = pad.reshape(nh, 2, nw, 2, 4).mean((1, 3))
        mips.append(nxt.astype(np.float32))
        cur = nxt
        if len(mips) >= MAX_MIPS:
            break
    return mips


def bake_textures(images: List[np.ndarray], device="cuda") -> TextureAtlas:
    """images: list of [h,w,3|4] float (linear, 0..1-ish) or uint8 arrays
    -> the atlas on `device` (the GPU by default; raises without one)."""
    device = rtxpt_tpu_torch.device(device)
    datas = []
    offsets = np.zeros((len(images), MAX_MIPS), np.int64)
    widths, heights, nmips = [], [], []
    cursor = 0
    for t, img in enumerate(images):
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        img = img.astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[-1] == 1:
            img = np.repeat(img, 3, axis=-1)
        if img.shape[-1] == 3:
            img = np.concatenate([img, np.ones_like(img[..., :1])], -1)
        mips = _build_mips(img)
        widths.append(img.shape[1])
        heights.append(img.shape[0])
        nmips.append(len(mips))
        for k, mp in enumerate(mips):
            offsets[t, k] = cursor
            datas.append(mp.reshape(-1, 4))
            cursor += mp.shape[0] * mp.shape[1]
        for k in range(len(mips), MAX_MIPS):
            offsets[t, k] = offsets[t, len(mips) - 1]
    data = (np.concatenate(datas) if datas
            else np.zeros((1, 4), np.float32))

    def i32(a):
        return torch.tensor(np.asarray(a, np.int32), device=device)

    return TextureAtlas(
        data=torch.tensor(data, dtype=torch.float32, device=device),
        mip_offset=i32(offsets), width=i32(widths), height=i32(heights),
        n_mips=i32(nmips))


def _level_rows(atlas: TextureAtlas, tex_id, level_of):
    """(texture ids clamped to the atlas, level, level width and height,
    level offset) for `level_of(n_mips)` -> level per lane."""
    tid = torch.clamp(tex_id.long(), 0, atlas.count - 1)
    nm = atlas.n_mips[tid].long()
    level = level_of(nm)
    wl = torch.clamp(atlas.width[tid].long() >> level, min=1)
    hl = torch.clamp(atlas.height[tid].long() >> level, min=1)
    off = atlas.mip_offset[tid].long().gather(-1, level[..., None])[..., 0]
    return level, wl, hl, off


def _clip(x, hi):
    """jnp.clip(x, 0, hi): max with 0 first, then min with hi."""
    return torch.minimum(torch.clamp(x, min=0), hi)


def sample_texture_stochastic(atlas: TextureAtlas, tex_id, uv, lod,
                              u_jitter):
    """Stochastic filtering: ONE texel fetch, the bilinear / trilinear
    footprint realized by jittering the sample position and the level
    (unbiased in expectation). tex_id [N] (-1 -> white), uv [N,2] (repeat
    wrap), lod [N], u_jitter [N,2] uniforms. Returns [N,4]."""
    _, wl, hl, off = _level_rows(atlas, tex_id, lambda nm: _clip(
        torch.floor(lod + u_jitter[..., 0]).to(torch.int32).long(), nm - 1))
    u = (uv[..., 0] + (u_jitter[..., 0] - 0.5) / wl.float()) % 1.0
    v = (uv[..., 1] + (u_jitter[..., 1] - 0.5) / hl.float()) % 1.0
    xi = _clip((u * wl).to(torch.int32).long(), wl - 1)
    yi = _clip((v * hl).to(torch.int32).long(), hl - 1)
    col = atlas.data[off + yi * wl + xi]
    return torch.where((tex_id >= 0)[..., None], col, 1.0)


def sample_texture(atlas: TextureAtlas, tex_id, uv, lod):
    """Bilinear fetch at the nearest MIP (round half to even, as
    jnp.round). tex_id [N] (-1 -> white), uv [N,2] (repeat wrap), lod [N]
    float. Returns [N,4]."""
    _, wl, hl, off = _level_rows(atlas, tex_id, lambda nm: _clip(
        torch.round(lod).to(torch.int32).long(), nm - 1))
    u = uv[..., 0] % 1.0
    v = uv[..., 1] % 1.0
    x = u * wl.float() - 0.5
    y = v * hl.float() - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]

    def fetch(xi, yi):
        xi = torch.remainder(xi.to(torch.int32).long(), wl)
        yi = torch.remainder(yi.to(torch.int32).long(), hl)
        return atlas.data[off + yi * wl + xi]

    c00 = fetch(x0, y0)
    c10 = fetch(x0 + 1, y0)
    c01 = fetch(x0, y0 + 1)
    c11 = fetch(x0 + 1, y0 + 1)
    col = ((c00 * (1 - fx) + c10 * fx) * (1 - fy)
           + (c01 * (1 - fx) + c11 * fx) * fy)
    return torch.where((tex_id >= 0)[..., None], col, 1.0)
