"""Procedural sky (counterpart of rtxpt_tpu/lighting/sky.py): an analytic
clear-sky radiance (luminance gradient, circumsolar glow, horizon haze)
evaluated into the equirect grid that lighting/envmap.py bakes, with the
sun baked in as a finite disk or left out. Host numpy, the JAX package's
operations, so the image is bit-identical to its."""

from __future__ import annotations

import numpy as np


def make_sky(width: int = 256, height: int = 128,
             sun_dir=(0.3, 0.6, 0.2), turbidity: float = 2.5,
             sun_intensity: float = 50.0, sky_scale: float = 1.0,
             bake_sun: bool = True, sun_angular_radius: float = 0.02):
    """Returns an equirect [H,W,3] float32 radiance image (y-up mapping
    matching lighting/envmap.py)."""
    sun = np.asarray(sun_dir, np.float64)
    sun = sun / np.linalg.norm(sun)

    v = (np.arange(height) + 0.5) / height * np.pi        # polar from +y
    u = (np.arange(width) + 0.5) / width * 2.0 * np.pi    # azimuth
    theta, phi = np.meshgrid(v, u, indexing="ij")
    d = np.stack([np.sin(theta) * np.cos(phi),
                  np.cos(theta),
                  np.sin(theta) * np.sin(phi)], -1)

    cos_gamma = np.clip(d @ sun, -1.0, 1.0)
    gamma = np.arccos(cos_gamma)
    cos_theta_up = np.clip(d[..., 1], -1.0, 1.0)

    # Perez-style gradient terms (tuned constants, clear sky)
    t = turbidity
    a = 0.18 - 0.06 * t
    b = -0.20
    c = 0.3 + 0.05 * t
    e = 0.35
    up = np.maximum(cos_theta_up, 0.01)
    lum = (1.0 + a * np.exp(b / up)) * \
        (1.0 + c * np.exp(-3.0 * gamma) + e * cos_gamma ** 2)
    lum = np.maximum(lum, 0.0)

    # Blue-to-warm chroma by sun elevation + horizon desaturation
    zenith = np.asarray([0.20, 0.35, 0.85])
    horizon = np.asarray([0.65, 0.70, 0.80])
    w = np.clip(cos_theta_up, 0.0, 1.0)[..., None]
    color = horizon[None, None] * (1 - w) + zenith[None, None] * w
    img = (lum[..., None] * color * sky_scale).astype(np.float32)

    # ground: dim warm bounce color
    ground = np.asarray([0.25, 0.22, 0.18], np.float32) * 0.3 * sky_scale
    img[cos_theta_up < 0.0] = ground

    if bake_sun:
        disk = gamma < sun_angular_radius
        img[disk] = sun_intensity
    return img
