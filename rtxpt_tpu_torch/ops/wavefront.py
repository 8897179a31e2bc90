"""Wavefront sort keys and the sort with payload rows (counterpart of
rtxpt_tpu/ops/wavefront.py, the part the clustered tier uses).

The JAX package sorts with `lax.sort`, which is stable; here a stable
`torch.sort` gives the permutation and the payload rows are gathered
with it, so both packages order tied keys the same way.
"""

from __future__ import annotations

import torch


def _spread6(v):
    v = (v | (v << 8)) & 0x00F00F
    v = (v | (v << 4)) & 0x0C30C3
    v = (v | (v << 2)) & 0x249249
    return v


def _spread16(v):
    v = (v | (v << 8)) & 0x00FF00FF
    v = (v | (v << 4)) & 0x0F0F0F0F
    v = (v | (v << 2)) & 0x33333333
    v = (v | (v << 1)) & 0x55555555
    return v


def pixel_morton_key(px, py):
    """22-bit image-space Morton key (int32): sorting the primary
    wavefront by it turns 1024-lane groups into ~32x32 pixel tiles."""
    x = px.to(torch.int32)
    y = py.to(torch.int32)
    return (_spread16(y) << 1) | _spread16(x)


def ray_coherence_key(o3, d3, scene_lo, scene_ext, active):
    """Coherence key for inter-bounce sorting (int32). Bits from high to
    low: 3-bit direction octant, 2-bit dominant axis, 15-bit origin-cell
    Morton code over a 32^3 grid of the scene bounds; inactive lanes get
    2^30 and sort last, so their groups cull to empty lists."""
    q = torch.clamp(((o3 - scene_lo[:, None]) / scene_ext[:, None]) * 31.0,
                    0.0, 31.0).to(torch.int32)
    cell = (_spread6(q[0]) << 2) | (_spread6(q[1]) << 1) | _spread6(q[2])
    pos = (d3 > 0).to(torch.int32)
    octant = pos[0] | (pos[1] << 1) | (pos[2] << 2)
    dom = torch.argmax(torch.abs(d3), dim=0).to(torch.int32)
    key = (((octant << 2) | dom) << 15) | cell
    return torch.where(active, key, 2 ** 30)


def sort_rows_by_key(key, rows):
    """Stable sort of stacked rows [K, N] by int32 keys ascending.
    Returns (sorted key, sorted rows [K, N], perm) with perm[i] the
    original lane now at slot i."""
    skey, perm = torch.sort(key, stable=True)
    return skey, rows[:, perm], perm


def unsort_rows(src, rows):
    """Undo a lane permutation: `src[i]` is the original lane now at slot
    i. Returns rows [K, N] in original lane order."""
    out = torch.empty_like(rows)
    out[:, src.long()] = rows
    return out
