"""Environment map (counterpart of rtxpt_tpu/lighting/envmap.py), the
no-image case only: a black environment of zero radiance, so the lights
bake adds no environment light (`env_light = -1`). Image-based lighting,
its two-level CDF and the in-kernel environment sampler come with a later
slice."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass(frozen=True)
class EnvMap:
    image: np.ndarray          # [H,W,3] radiance (pre-scaled)
    cos_rot: float
    sin_rot: float
    mean_radiance: np.ndarray  # [3]


def bake_envmap(image: Optional[np.ndarray], scale: float = 1.0,
                rotation: float = 0.0) -> EnvMap:
    """The black environment the JAX package bakes for `image=None`
    (a 4x8 zero image). Raises for an image: not ported yet."""
    if image is not None:
        raise NotImplementedError(
            "environment map images are not ported to rtxpt_tpu_torch yet")
    img = np.zeros((4, 8, 3), np.float32) * scale
    return EnvMap(image=img, cos_rot=float(np.cos(rotation)),
                  sin_rot=float(np.sin(rotation)),
                  mean_radiance=np.zeros((3,), np.float32))
