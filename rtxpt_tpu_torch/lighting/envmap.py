"""Environment map (counterpart of rtxpt_tpu/lighting/envmap.py): an
equirect radiance image with a two-level importance-sampling CDF (row
marginal + per-row conditional).

The bake runs in host numpy with the JAX package's operations, so every
field agrees with it; the result holds torch tensors on the render device.
Coordinates: y up; u = azimuth around +y from +x toward +z, v = polar
angle from +y; the azimuth rotation applies in the direction <-> uv maps.

`env_eval`, `env_pdf` and `env_sample` are the general tier's sampler
(`torch.atan2` / `torch.acos`, as the JAX package's `jnp.arctan2` /
`jnp.arccos`). The fused and clustered kernels read the fixed 64 x 128
table that pt/bounce_fused.py `build_env_table` bakes from this map, and
find the texel of a direction with their own polynomial atan2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import rtxpt_tpu_torch


@dataclass(frozen=True)
class EnvMap:
    image: torch.Tensor          # [H,W,3] radiance (pre-scaled)
    row_cdf: torch.Tensor        # [H] inclusive CDF of the row marginal
    cond_cdf: torch.Tensor       # [H,W] inclusive CDF of each row
    texel_pdf: torch.Tensor      # [H,W] discrete selection pmf per texel
    cos_rot: float               # azimuth rotation (float32 values)
    sin_rot: float
    mean_radiance: np.ndarray    # [3] f32 sin-weighted sphere average

    @property
    def shape(self):
        return tuple(self.image.shape[:2])

    @property
    def has_radiance(self) -> bool:
        return bool(np.any(self.mean_radiance > 0.0))


def resample_equirect(image: np.ndarray, h: int, w: int) -> np.ndarray:
    """Box-average an equirect [H,W,3] to (h, w) (the JAX package's
    operations: 2x nearest upsample, then 2x2 means)."""
    image = np.asarray(image, np.float32)
    sh, sw = image.shape[:2]
    ys = (np.arange(h * 2) * sh) // (h * 2)
    xs = (np.arange(w * 2) * sw) // (w * 2)
    up = image[np.clip(ys, 0, sh - 1)][:, np.clip(xs, 0, sw - 1)]
    return up.reshape(h, 2, w, 2, 3).mean((1, 3))


def _f32(x) -> float:
    return float(np.float32(x))


def envmap_from_numpy(image, row_cdf, cond_cdf, texel_pdf, cos_rot, sin_rot,
                      mean_radiance, device="cuda") -> EnvMap:
    """EnvMap on `device` (the GPU by default; raises without one) from
    the JAX package's EnvMap fields as numpy arrays."""
    device = rtxpt_tpu_torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return EnvMap(image=t(image), row_cdf=t(row_cdf), cond_cdf=t(cond_cdf),
                  texel_pdf=t(texel_pdf), cos_rot=_f32(cos_rot),
                  sin_rot=_f32(sin_rot),
                  mean_radiance=np.asarray(mean_radiance, np.float32))


def bake_envmap(image: Optional[np.ndarray], scale: float = 1.0,
                rotation: float = 0.0, res=None, device="cuda") -> EnvMap:
    """EnvMap from an equirect [H,W,3] image (None = a black 4x8 map) on
    `device`. `res=(h, w)` resamples the scaled source first
    (`resample_equirect`); prepare bakes the kernels' 64 x 128 this way."""
    if image is None:
        image = np.zeros((4, 8, 3), np.float32)
    image = np.asarray(image, np.float32) * scale
    if res is not None and tuple(image.shape[:2]) != tuple(res):
        image = resample_equirect(image, res[0], res[1])
    h, w = image.shape[:2]
    lum = (image[..., 0] * 0.2126 + image[..., 1] * 0.7152
           + image[..., 2] * 0.0722)
    theta = (np.arange(h) + 0.5) / h * np.pi
    weight = lum * np.sin(theta)[:, None]
    total = weight.sum()
    if total <= 0.0:
        weight = np.ones_like(weight)
        total = weight.sum()
    pdf = weight / total
    row_p = pdf.sum(axis=1)
    row_cdf = np.cumsum(row_p)
    row_cdf[-1] = 1.0
    cond = pdf / np.maximum(row_p[:, None], 1e-12)
    cond = np.where(row_p[:, None] > 0, cond, 1.0 / w)
    cond_cdf = np.cumsum(cond, axis=1)
    cond_cdf[:, -1] = 1.0
    mean = ((image * np.sin(theta)[:, None, None]).sum((0, 1))
            / max(np.sin(theta).sum() * image.shape[1], 1e-9))
    return envmap_from_numpy(image, row_cdf, cond_cdf, pdf,
                             np.cos(rotation), np.sin(rotation), mean,
                             device=device)


def _dir_to_uv(env: EnvMap, d):
    """World directions [N,3] -> (u, v) in [0,1)^2, with the rotation."""
    x = env.cos_rot * d[..., 0] + env.sin_rot * d[..., 2]
    z = -env.sin_rot * d[..., 0] + env.cos_rot * d[..., 2]
    u = torch.remainder(torch.atan2(z, x) / (2.0 * math.pi), 1.0)
    v = torch.acos(torch.clamp(d[..., 1], -1.0, 1.0)) / math.pi
    return u, v


def _uv_to_dir(env: EnvMap, u, v):
    phi = u * 2.0 * math.pi
    theta = v * math.pi
    st = torch.sin(theta)
    x = st * torch.cos(phi)
    z = st * torch.sin(phi)
    y = torch.cos(theta)
    xr = env.cos_rot * x - env.sin_rot * z
    zr = env.sin_rot * x + env.cos_rot * z
    return torch.stack([xr, y, zr], dim=-1)


def _texel(env: EnvMap, d):
    h, w = env.shape
    u, v = _dir_to_uv(env, d)
    xi = torch.clamp((u * w).to(torch.int64), 0, w - 1)
    yi = torch.clamp((v * h).to(torch.int64), 0, h - 1)
    return yi, xi


def env_eval(env: EnvMap, d):
    """Radiance of directions d [N,3] (nearest texel), [N,3]."""
    yi, xi = _texel(env, d)
    return env.image[yi, xi]


def _texel_solid_angle(env: EnvMap, yi):
    h, w = env.shape
    theta = (yi.to(torch.float32) + 0.5) / h * math.pi
    return (2.0 * math.pi / w) * (math.pi / h) * torch.clamp(
        torch.sin(theta), min=1e-6)


def env_pdf(env: EnvMap, d):
    """Solid-angle pdf of env_sample producing direction d, [N]."""
    yi, xi = _texel(env, d)
    return env.texel_pdf[yi, xi] / _texel_solid_angle(env, yi)


def count_le(cdf, u):
    """#{i : cdf[i] <= u} for a non-decreasing CDF: cdf [K] shared by all
    u [N], or one row per lane, cdf [N, K]. A binary search that takes the
    same side of a tie as the count, so it picks the JAX package's
    index."""
    k = cdf.shape[-1]
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    bit = 1 << (k.bit_length() - 1)
    while bit >= 1:
        probe = torch.clamp(lo + bit - 1, max=k - 1)
        c = cdf[probe] if cdf.dim() == 1 else \
            torch.gather(cdf, 1, probe[:, None])[:, 0]
        lo = lo + bit * ((c <= u) & (lo + bit <= k)).to(torch.int64)
        bit //= 2
    return lo


def env_sample(env: EnvMap, u1, u2):
    """Importance-sample the map with two uniforms [N]: u1 picks the row
    by the marginal CDF, u2 the column by the row's conditional CDF, and
    the rescaled residues jitter inside the texel. Returns (dir [N,3],
    radiance [N,3], pdf [N])."""
    h, w = env.shape
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    u2 = torch.clamp(u2, 0.0, 1.0 - 1e-7)
    yi = torch.clamp(count_le(env.row_cdf, u1), 0, h - 1)
    c_lo = torch.where(yi > 0, env.row_cdf[torch.clamp(yi - 1, min=0)], 0.0)
    c_hi = env.row_cdf[yi]
    jv = torch.clamp((u1 - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    cond = env.cond_cdf[yi]                                  # [N, w]
    xi = torch.clamp(count_le(cond, u2), 0, w - 1)
    d_lo = torch.where(
        xi > 0, torch.gather(cond, 1, torch.clamp(xi - 1, min=0)[:, None])[
            :, 0], 0.0)
    d_hi = torch.gather(cond, 1, xi[:, None])[:, 0]
    ju = torch.clamp((u2 - d_lo) / torch.clamp(d_hi - d_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    u = (xi.to(torch.float32) + ju) / w
    v = (yi.to(torch.float32) + jv) / h
    d = _uv_to_dir(env, u, v)
    radiance = env.image[yi, xi]
    pdf = env.texel_pdf[yi, xi] / _texel_solid_angle(env, yi)
    return d, radiance, pdf
