"""Tone mapping (counterpart of rtxpt_tpu/render/postprocess.py): fixed
exposure + ACES-fitted / Reinhard / linear curves."""

from __future__ import annotations

import torch

from rtxpt_tpu_torch.utils import math as m


def aces_film(x):
    """ACES filmic fit (Narkowicz)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def reinhard(x):
    return x / (1.0 + x)


def tonemap(hdr, exposure: float = 1.0, curve: str = "aces"):
    """Linear HDR [H,W,3] -> display sRGB [H,W,3] in [0,1]."""
    x = hdr * exposure
    if curve == "aces":
        x = aces_film(x)
    elif curve == "reinhard":
        x = reinhard(x)
    elif curve == "linear":
        x = torch.clamp(x, 0.0, 1.0)
    elif curve == "none":
        return x
    else:
        raise ValueError(f"unknown tone curve {curve!r}")
    return m.linear_to_srgb(x)
