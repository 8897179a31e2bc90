"""Vector math helpers (counterpart of rtxpt_tpu/utils/math.py), the
subset that the camera and the display transform use. Vectors are
[..., 3] float32; dot products are written out component by component so
that every device sums in the same order."""

from __future__ import annotations

import torch

EPS = 1e-8


def dot(a, b, keepdims=True):
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s[..., None] if keepdims else s


def length(v, keepdims=True):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims), min=0.0))


def normalize(v):
    return v * (1.0 / torch.sqrt(torch.clamp(dot(v, v), min=EPS * EPS)))


def luminance(c):
    """Rec.709 luminance of linear RGB [..., 3] -> [...]."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=1e-7), 1.0 / 2.4) - 0.055)
