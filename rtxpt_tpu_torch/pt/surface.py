"""Surface helpers (counterpart of rtxpt_tpu/pt/surface.py): the ray-origin
offset that the fused bounce step, its external NEE and the shadow
requests share. `load_surface` comes with the general wavefront tier."""

from __future__ import annotations

import torch

from rtxpt_tpu_torch.utils import math as m


def ray_offset(pos, geo_n, direction):
    """Self-intersection-robust ray origin: `pos` moved along the geometric
    normal, to the side `direction` leaves on. Vectors [..., 3]."""
    scale = torch.clamp(m.length(pos, False), min=1.0) * 3e-5
    side = torch.where(m.dot(direction, geo_n, False) >= 0.0, 1.0, -1.0)
    return pos + geo_n * (side * scale)[..., None]
