"""Clustered scene tables for large scenes (counterpart of
rtxpt_tpu/accel/cluster.py, the flat host build).

The triangles, already Morton-ordered by `prepare`, are cut into
variable-length contiguous clusters of at most CT = 128 triangles at the
subtree boundaries of the implicit radix tree over their Morton codes
(`radix_cut_offsets`). Each cluster gets an AABB, which the per-bounce
cull (accel/cull.py) tests against ray-group beams, and one block that
the clustered kernels (csrc/cluster_*.cu) read when they visit it.

Block layout [BLK_ROWS = 32, LANES = 4*CT = 512] f32, the JAX package's:

  rows 0..9    coefficient HI rows k (bf16-exact): lane q*CT + j holds
               coefficient k of quantity q in (det, u, v, t) for
               triangle j, against the ray operand [d | o' x d | o' | 1]
               with o' = o - center (cluster-local coordinates)
  rows 10..19  coefficient LO rows, bf16(c - c_hi)
  row 20       cluster center: lanes [0, CT) cx, [CT, 2CT) cy,
               [2CT, 3CT) cz
  rows 21..30  logical attribute row i at [21 + i // 4, (i % 4)*CT + j]
  row 31       zero

The split-bf16 coefficients exist for the TPU's bf16 matrix unit; the
Hopper kernels keep them so that both packages select hits from the same
numbers. Everything here is numpy, bit for bit the JAX package's build;
`ClusterTables` holds the result as tensors on the render device.
`refresh_cluster_tables` and the instanced build are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

CT = 128                 # triangles per cluster
BLK_ROWS = 32
CENTER_ROW = 20
ATTR_BASE = 21
LANES = 4 * CT
# device block budget (~512 MB of blocks, about 1M triangles)
MAX_CLUSTERS = (1 << 29) // (BLK_ROWS * LANES * 4)

# Logical attribute rows (positions cluster-local)
AT_V0 = 0                # 0:3
AT_E1 = 3                # 3:6
AT_E2 = 6                # 6:9
AT_GN = 9                # 9:12 unit geometric normal
AT_N0 = 12               # 12:15 shading normal at v0
AT_N1 = 15
AT_N2 = 18
AT_MID = 21              # material id
AT_LPDF = 22             # baked light-selection pdf of this tri's light
AT_LAREA = 23            # light area
AT_ISLIGHT = 24
AT_GIDX = 25             # global (prepared-order) triangle index
AT_VALID = 26            # 1 for real triangles, 0 for padding
AT_UV0 = 27              # 27:29 texture uv at v0
AT_UV1 = 29
AT_UV2 = 31
AT_LODB = 33             # -0.5*log2(tri_area2): ray-cone LOD bias
AT_LID = 34              # light id of this tri's light (-1 = not a light)
AT_TANG = 35             # 35:38 UV tangent premultiplied by 1/det_uv
AT_TSGN = 38             # sign(det_uv); 0 = degenerate UV mapping
AT_ROWS = 39


@dataclass(frozen=True)
class ClusterTables:
    """Device tables of the clustered tier."""

    blocks: torch.Tensor      # [C, BLK_ROWS, LANES] f32
    aabb_lo: torch.Tensor     # [C, 3] f32
    aabb_hi: torch.Tensor     # [C, 3] f32
    mat_rows: torch.Tensor    # [MT_ROWS, 128]
    light_rows: torch.Tensor  # [LROWS, 128]
    offsets: torch.Tensor     # [C+1] i32 triangle range of each cluster
    n_clusters: int = 0
    n_tris: int = 0
    n_lights: int = 0

    @property
    def device(self):
        return self.blocks.device


def bf16_round(x: np.ndarray) -> np.ndarray:
    """Round-to-nearest-even f32 -> bf16 -> f32 (numpy emulation)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    rounded = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return rounded.astype(np.uint32).view(np.float32)


def morton_codes(x: np.ndarray) -> np.ndarray:
    """30-bit Morton codes for points x [N,3] (10 bits/axis)."""
    lo = x.min(0)
    ext = np.maximum(x.max(0) - lo, 1e-12)
    q = np.clip(((x - lo) / ext) * 1023.0, 0, 1023).astype(np.uint32)

    def spread(v):
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])


def morton_permutation(positions: np.ndarray, indices: np.ndarray
                       ) -> np.ndarray:
    """Triangle permutation sorting centroids along the Morton curve."""
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    cen = (v0 + v1 + v2) / 3.0
    return np.argsort(morton_codes(cen), kind="stable").astype(np.int64)


def radix_cut_offsets(codes: np.ndarray, max_size: int) -> np.ndarray:
    """Cut the implicit radix tree over SORTED Morton codes into maximal
    subtrees of <= max_size leaves; returns [K+1] range offsets. Subtrees
    of a radix tree are contiguous ranges that follow the geometry, so
    their boxes are tighter than fixed-length runs'."""
    n = len(codes)
    cuts = []
    stack = [(0, n, 29)]
    while stack:
        lo, hi, bit = stack.pop()
        if hi - lo <= max_size:
            cuts.append(lo)
            continue
        if bit < 0:
            cuts.extend(range(lo, hi, max_size))
            continue
        mid = lo + int(np.searchsorted(
            (codes[lo:hi] >> np.uint32(bit)) & 1, 1, side="left"))
        if mid == lo or mid == hi:
            stack.append((lo, hi, bit - 1))
        else:
            stack.append((mid, hi, bit - 1))
            stack.append((lo, mid, bit - 1))
    cuts.sort()
    return np.array(cuts + [n], np.int64)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def build_cluster_blocks(positions, normals, indices, tri_material, lights,
                         uvs=None):
    """The numpy arrays of the flat cluster build: (blocks [C,32,512],
    aabb_lo [C,3], aabb_hi [C,3], offsets [C+1]). Triangles must already
    be Morton-ordered; `lights` is the baked LightList of the same
    triangle order."""
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    indices = np.asarray(indices, np.int32)
    tri_material = np.asarray(tri_material, np.int32)
    t = len(indices)

    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    gn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

    tri_light = _np(lights.tri_light)[:t]
    if len(tri_light) < t:
        tri_light = np.concatenate(
            [tri_light, np.full((t - len(tri_light),), -1,
                                tri_light.dtype if tri_light.size
                                else np.int64)])
    has_l = tri_light >= 0
    li = np.maximum(tri_light, 0)
    lpdf = np.where(has_l, _np(lights.power)[li], 0.0)
    larea = np.where(has_l, _np(lights.extra)[li, 0], 1.0)

    # Variable-length Morton ranges laid out in fixed CT-wide slots;
    # slot_tri maps (cluster, lane) -> triangle, and padding lanes get
    # zero coefficients (det 0: never selected) and AT_VALID 0.
    cen = (v0 + v1 + v2) / 3.0
    offsets = radix_cut_offsets(morton_codes(cen), CT)
    n_clusters = len(offsets) - 1
    if n_clusters > MAX_CLUSTERS:
        raise NotImplementedError(
            f"{n_clusters} clusters: the device block budget holds "
            f"{MAX_CLUSTERS}")
    sizes = np.diff(offsets)
    slot_tri = offsets[:-1, None] + np.arange(CT)[None, :]    # [K,CT]
    slot_valid = (np.arange(CT)[None, :] < sizes[:, None])
    slot_tri = np.where(slot_valid, slot_tri, 0).reshape(-1)
    vmaskf = slot_valid.reshape(-1).astype(np.float32)

    def pp(x):
        y = x[slot_tri]
        return y * (vmaskf if y.ndim == 1
                    else vmaskf[:, None]).astype(x.dtype)

    v0p, e1p, e2p, np_, gnp = pp(v0), pp(e1), pp(e2), pp(n), pp(gn)
    n0p = pp(normals[indices[:, 0]])
    n1p = pp(normals[indices[:, 1]])
    n2p = pp(normals[indices[:, 2]])
    midp = pp(tri_material.astype(np.float32))
    lpdfp, lareap = pp(lpdf.astype(np.float32)), pp(larea.astype(np.float32))
    islp = pp(has_l.astype(np.float32))
    validp = pp(np.ones((t,), np.float32))

    # Per-cluster AABB over real triangles (padding contributes nothing).
    vs = np.stack([pp(v0), pp(v0 + e1), pp(v0 + e2)], axis=1)  # [tpad,3,3]
    vs = vs.reshape(n_clusters, CT * 3, 3)
    validc = validp.reshape(n_clusters, CT, 1)
    big = np.float32(1e30)
    vmask = np.repeat(validc, 3, axis=1) > 0.5
    lo = np.where(vmask, vs, big).min(axis=1)
    hi = np.where(vmask, vs, -big).max(axis=1)
    center = ((lo + hi) * 0.5).astype(np.float32)           # [C,3]

    cen_tri = np.repeat(center, CT, axis=0)                  # [tpad,3]
    v0l = v0p - cen_tri * validp[:, None]   # keep padding at 0
    v0xe2 = np.cross(v0l, e2p)
    v0xe1 = np.cross(v0l, e1p)
    v0n = np.einsum("tj,tj->t", v0l, np_)

    blocks = np.zeros((n_clusters, BLK_ROWS, LANES), np.float32)

    def coef(q, k3, vals):
        vv = vals.reshape(n_clusters, CT, -1)
        for k in range(vv.shape[2]):
            blocks[:, k3 + k, q * CT:(q + 1) * CT] = vv[:, :, k]

    coef(0, 0, -np_)                 # det: -n . d
    coef(1, 0, v0xe2)                # u:  (v0'xe2).d + e2.(o'xd)
    coef(1, 3, e2p)
    coef(2, 0, -v0xe1)               # v
    coef(2, 3, -e1p)
    coef(3, 6, np_)                  # t:  n.o' - v0'.n
    coef(3, 9, -v0n[:, None])

    # split-bf16: rows 0..9 -> (hi, lo) with hi bf16-exact
    c_full = blocks[:, 0:10, :].copy()
    c_hi = bf16_round(c_full)
    blocks[:, 0:10, :] = c_hi
    blocks[:, 10:20, :] = bf16_round(c_full - c_hi)

    for a in range(3):
        blocks[:, CENTER_ROW, a * CT:(a + 1) * CT] = center[:, a:a + 1]

    attr = np.zeros((n_clusters, AT_ROWS, CT), np.float32)

    def put3(i, arr):
        attr[:, i:i + 3, :] = arr.reshape(
            n_clusters, CT, 3).transpose(0, 2, 1)

    def put1(i, arr):
        attr[:, i, :] = arr.reshape(n_clusters, CT)

    put3(AT_V0, v0l)
    put3(AT_E1, e1p)
    put3(AT_E2, e2p)
    put3(AT_GN, gnp)
    put3(AT_N0, n0p)
    put3(AT_N1, n1p)
    put3(AT_N2, n2p)
    put1(AT_MID, midp)
    put1(AT_LPDF, lpdfp)
    put1(AT_LAREA, lareap)
    put1(AT_ISLIGHT, islp)
    put1(AT_LID, pp(tri_light.astype(np.float32)))
    # clusters are variable-length ranges, so the kernel cannot rebuild
    # the triangle index as cid*CT + j; f32 is exact to 2^24
    put1(AT_GIDX, slot_tri.astype(np.float32))
    put1(AT_VALID, validp)
    if uvs is not None:
        from rtxpt_tpu_torch.pt.bounce_fused import _tangent_rows
        uvs = np.asarray(uvs, np.float32)
        for row, vi in ((AT_UV0, 0), (AT_UV1, 1), (AT_UV2, 2)):
            uvv = pp(uvs[indices[:, vi]])
            put1(row, uvv[:, 0])
            put1(row + 1, uvv[:, 1])
        tang = _tangent_rows(uvs, indices, e1, e2)
        put3(AT_TANG, pp(np.ascontiguousarray(tang[0:3].T)))
        put1(AT_TSGN, pp(tang[3]))
    tri_area2 = np.linalg.norm(np_, axis=-1)
    put1(AT_LODB, (-0.5 * np.log2(np.maximum(tri_area2, 1e-20))
                   ).astype(np.float32))
    for i in range(AT_ROWS):
        blocks[:, ATTR_BASE + i // 4, (i % 4) * CT:(i % 4 + 1) * CT] = \
            attr[:, i, :]
    return blocks, lo.astype(np.float32), hi.astype(np.float32), offsets


def cluster_tables_from_numpy(blocks, aabb_lo, aabb_hi, mat_rows, light_rows,
                              offsets, n_clusters, n_tris, n_lights,
                              device) -> ClusterTables:
    """ClusterTables on `device` from numpy arrays of the JAX layout."""
    def f(a):   # copies only arrays that are not writable f32 already
        return torch.from_numpy(np.require(a, np.float32, "CW")).to(device)

    return ClusterTables(
        blocks=f(blocks), aabb_lo=f(aabb_lo), aabb_hi=f(aabb_hi),
        mat_rows=f(mat_rows), light_rows=f(light_rows),
        offsets=torch.from_numpy(np.require(offsets, np.int32, "CW")).to(
            device),
        n_clusters=int(n_clusters), n_tris=int(n_tris),
        n_lights=int(n_lights))


def build_cluster_tables(positions, normals, indices, tri_material,
                         materials, lights, uvs=None,
                         device: Optional[torch.device] = None
                         ) -> ClusterTables:
    """Bake the cluster tables of a flat, Morton-ordered scene onto
    `device`. Raises NotImplementedError, naming the feature, for a
    scene the clustered tier does not serve (anisotropic materials,
    sphere or environment lights, more than 128 materials)."""
    from rtxpt_tpu_torch.lighting.lights_baker import (
        KIND_ENV, KIND_ENVQUAD, KIND_SPHERE)
    from rtxpt_tpu_torch.pt.bounce_fused import (
        MAX_MATERIALS, pack_lights, pack_materials)

    if float(np.max(_np(materials.anisotropy), initial=0.0)) > 0.0:
        raise NotImplementedError("anisotropic materials are not ported "
                                  "to the clustered tier")
    if np.any(np.isin(_np(lights.kind), [KIND_SPHERE, KIND_ENVQUAD,
                                         KIND_ENV])) or lights.env_light >= 0:
        raise NotImplementedError("sphere and environment lights are not "
                                  "ported to the clustered tier")
    n_mats = len(_np(materials.base_color))
    t = len(indices)
    if t == 0 or n_mats > MAX_MATERIALS:
        raise NotImplementedError(
            f"{t} triangles, {n_mats} materials: the clustered tier takes "
            f">= 1 triangle and at most {MAX_MATERIALS} materials")
    blocks, lo, hi, offsets = build_cluster_blocks(
        positions, normals, indices, tri_material, lights, uvs=uvs)
    return cluster_tables_from_numpy(
        blocks, lo, hi, pack_materials(materials), pack_lights(lights),
        offsets, len(offsets) - 1, t, int(lights.num), device)
