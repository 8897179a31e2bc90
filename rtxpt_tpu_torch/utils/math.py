"""Vector math helpers (counterpart of rtxpt_tpu/utils/math.py): the subset
that the camera, the display transform, the light sampling, the BSDF and
the general wavefront use. Vectors are [..., 3] float32; dot
products are written out component by component so that every device
sums in the same order. pt/wide.py, which keeps vectors as [3, ...]
stacks, takes its elementwise helpers from here."""

from __future__ import annotations

import math

import torch

EPS = 1e-8


def dot(a, b, keepdims=True):
    s = a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]
    return s[..., None] if keepdims else s


def matvec(m, x):
    """[..., 3, 3] matrices times [..., 3] vectors, each row a `dot`."""
    return dot(m, x[..., None, :], False)


def length(v, keepdims=True):
    return torch.sqrt(torch.clamp(dot(v, v, keepdims), min=0.0))


def normalize(v):
    return v * (1.0 / torch.sqrt(torch.clamp(dot(v, v), min=EPS * EPS)))


def cross(a, b):
    """a x b of [..., 3] vectors, written out component by component."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]],
                       dim=-1)


def luminance(c):
    """Rec.709 luminance of linear RGB [..., 3] -> [...]."""
    return c[..., 0] * 0.2126 + c[..., 1] * 0.7152 + c[..., 2] * 0.0722


def orthonormal_basis(n):
    """Branchless ONB from a unit normal (Duff et al. 2017): (t, b)."""
    z = n[..., 2]
    sign = torch.where(z >= 0.0, 1.0, -1.0)
    a = -1.0 / (sign + z)
    b = n[..., 0] * n[..., 1] * a
    t = torch.stack([1.0 + sign * n[..., 0] * n[..., 0] * a, sign * b,
                     -sign * n[..., 0]], dim=-1)
    bt = torch.stack([b, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]],
                     dim=-1)
    return t, bt


def to_local(v, n):
    """World -> tangent space, z along n."""
    t, b = orthonormal_basis(n)
    return torch.stack([dot(v, t, False), dot(v, b, False),
                        dot(v, n, False)], dim=-1)


def to_world(v, n):
    """Tangent space (z along n) -> world."""
    t, b = orthonormal_basis(n)
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def sample_cosine_hemisphere(u1, u2):
    """Cosine-weighted hemisphere (local frame, z up): (dir, pdf)."""
    r = torch.sqrt(u1)
    phi = 2.0 * math.pi * u2
    d = torch.stack([r * torch.cos(phi), r * torch.sin(phi),
                     torch.sqrt(torch.clamp(1.0 - u1, min=0.0))], dim=-1)
    return d, torch.clamp(d[..., 2], min=EPS) / math.pi


def sample_triangle_barycentrics(u1, u2):
    """Low-distortion uniform triangle sampling (Heitz 2019 square-root-free
    mapping). Returns (b0, b1, b2)."""
    b0 = u1 * 0.5
    b1 = u2 * 0.5
    offset = b1 - b0
    b0 = torch.where(offset > 0.0, b0, b0 - offset)
    b1 = torch.where(offset > 0.0, b1 + offset, b1)
    return 1.0 - b0 - b1, b0, b1


def power_heuristic(pdf_a, pdf_b):
    """MIS power heuristic (beta = 2) weight for strategy a."""
    a2 = pdf_a * pdf_a
    return torch.where(pdf_a > 0.0,
                       a2 / torch.clamp(a2 + pdf_b * pdf_b, min=1e-30), 0.0)


def linear_to_srgb(c):
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(
        c <= 0.0031308, c * 12.92,
        1.055 * torch.pow(torch.clamp(c, min=1e-7), 1.0 / 2.4) - 0.055)
