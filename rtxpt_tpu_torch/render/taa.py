"""Temporal anti-aliasing and bloom (counterpart of rtxpt_tpu/render/taa.py):
the history reprojected by the motion vectors, clamped to the 3x3
neighbourhood's colour bounds and blended exponentially; a thresholded
multi-scale bloom. Plain torch on [H, W, 3] images, as the JAX package's
XLA code."""

from __future__ import annotations

from typing import Optional

import torch

from rtxpt_tpu_torch.render.denoise import _bilinear_sample, _grid, _shift2d


def taa_resolve(color, motion, history: Optional[torch.Tensor],
                alpha: float = 0.1):
    """color [H,W,3], motion [H,W,2] (prev = cur + motion), history or
    None. Returns (resolved, new_history)."""
    if history is None:
        return color, color
    h, w = color.shape[:2]
    yy, xx = _grid(h, w, motion)
    prev = _bilinear_sample(history, yy, xx)
    cmin = color
    cmax = color
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            nb = _shift2d(color, dy, dx)
            cmin = torch.minimum(cmin, nb)
            cmax = torch.maximum(cmax, nb)
    prev = torch.minimum(torch.maximum(prev, cmin), cmax)
    inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    a = torch.where(inside, alpha, 1.0)[..., None]
    out = prev * (1.0 - a) + color * a
    return out, out


def _blur_separable(img, radius: int = 2):
    wts = [1.0, 4.0, 6.0, 4.0, 1.0]
    total = sum(wts)
    out = torch.zeros_like(img)
    for i, wi in enumerate(wts):
        out = out + wi * _shift2d(img, 0, (i - 2) * radius)
    out = out / total
    out2 = torch.zeros_like(out)
    for i, wi in enumerate(wts):
        out2 = out2 + wi * _shift2d(out, (i - 2) * radius, 0)
    return out2 / total


def bloom(hdr, threshold: float = 1.0, intensity: float = 0.05):
    """Thresholded multi-scale bloom added to linear HDR [H,W,3]."""
    bright = torch.clamp(hdr - threshold, min=0.0)
    b = _blur_separable(bright, 1)
    b = b + _blur_separable(bright, 3)
    b = b + _blur_separable(bright, 7)
    return hdr + intensity * b
