"""Clustered scene tables for large scenes (counterpart of
rtxpt_tpu/accel/cluster.py): the flat host build and the instanced one.

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
`refresh_cluster_tables` is not ported yet.

Opacity micromaps. The JAX package widens an alpha-tested scene's blocks
to 7 quantity slots (det, u, v, t, word low half, word high half,
coverage): the 16-bit halves and the coverage ride its matrix product at
the constant-1 operand slot. The port keeps the 4-slot blocks and puts
them in a side table: per cluster lane one u32 word (`omm_word`, stored
as i32) and one f32 coverage (`omm_cov`), which K3 and K5 stage beside
the block (1 KB per visit). The coverage stored is the JAX kernels'
effective value, its split-bf16 hi + lo (exact in f32), so the
stochastic shadow test compares the same number; the words are exact
either way. `cluster_tables_from_numpy` converts the JAX 7-slot blocks.

The instanced build (`build_cluster_tables_instanced`) bakes one set of
object-space blocks per prototype of the two-level scene (accel/tlas.py)
and expands only the cull's boxes per (instance, cluster): geometry
memory is O(prototypes). Each world candidate names its pool block
(`wc_block`) and its instance (`wc_inst`), whose world -> object map of
the ray operand (`xf`) the kernels apply per visit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import rtxpt_tpu_torch

CT = 128                 # triangles per cluster
OMM_SLOTS = 7            # quantity slots of the JAX package's micromap blocks
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
    # [C+1] i32 triangle range of each cluster (None on instanced tables)
    offsets: Optional[torch.Tensor]
    n_clusters: int = 0       # world candidates on instanced tables
    n_tris: int = 0           # pool triangles on instanced tables
    n_lights: int = 0
    # ---- instanced tables (build_cluster_tables_instanced) ----
    # `blocks` holds the prototypes' object-space blocks; aabb_lo / aabb_hi
    # are the world boxes of the expanded (instance x cluster) candidates
    instanced: bool = False
    wc_block: Optional[torch.Tensor] = None   # [Cw] i32 pool block
    wc_inst: Optional[torch.Tensor] = None    # [Cw] i32 instance
    # [I,10,10] f32 M10, the world -> object map of the ray operand
    # [d, o x d, o, 1] (the JAX package's xf tile holds its transpose,
    # padded to [16,128]); cross products map as (Ax) x (Ay) =
    # det(A) A^-T (x x y)
    xf: Optional[torch.Tensor] = None
    # [I,19] o2w linear (9) | normal matrix (9) | LOD bias offset (1)
    inst_post: Optional[torch.Tensor] = None
    # [ET_SIZE] the kernels' environment table (pt/bounce_fused.py
    # build_env_table); None without an environment light
    env: Optional[torch.Tensor] = None
    # the texture tables (pt/bounce_fused.py build_tex_tables): the atlas
    # [texels, 4], the meta rows [T, TX_COLS] i32 and the map flags
    tex: Optional[torch.Tensor] = None
    tex_meta: Optional[torch.Tensor] = None
    tex_maps: tuple = (0, 0, 0, 0)
    # opacity micromaps (flat tables): [C, CT] i32 words (u32 bits) and
    # [C, CT] f32 unknown-cell coverages per cluster lane
    omm: bool = False
    omm_word: Optional[torch.Tensor] = None
    omm_cov: Optional[torch.Tensor] = None

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
                         uvs=None, tri_gidx=None, tri_micromap=None,
                         tri_cover=None):
    """The numpy arrays of the flat cluster build: (blocks [C,32,512],
    aabb_lo [C,3], aabb_hi [C,3], offsets [C+1]), and with `tri_micromap`
    ([t] u32 words) and `tri_cover` ([t] f32) also the side table
    (omm_word [C,CT] i32, omm_cov [C,CT] f32; zero on padding lanes).
    Triangles must already be Morton-ordered; `lights` is the baked
    LightList of the same triangle order. `tri_gidx` ([t], optional)
    overrides the exported triangle index AT_GIDX: the instanced build
    passes pool ids."""
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
    if tri_gidx is not None:
        put1(AT_GIDX, pp(np.asarray(tri_gidx, np.float32)))
    else:
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
    out = (blocks, lo.astype(np.float32), hi.astype(np.float32), offsets)
    if tri_micromap is None:
        return out
    words = np.asarray(tri_micromap).astype(np.uint32).view(np.int32)
    cov = (np.asarray(tri_cover, np.float32) if tri_cover is not None
           else np.ones((t,), np.float32))
    cov_hi = bf16_round(cov)
    cov = cov_hi + bf16_round(cov - cov_hi)       # the JAX kernels' value
    word = np.where(vmaskf > 0.5, words[slot_tri], 0).astype(np.int32)
    return out + (word.reshape(n_clusters, CT),
                  pp(cov).astype(np.float32).reshape(n_clusters, CT))


def omm_blocks_to_port(blocks: np.ndarray):
    """The JAX package's 7-slot micromap blocks [C, 32, 7*CT] -> (the
    port's 4-slot blocks [C, 32, 4*CT], omm_word [C, CT] i32, omm_cov
    [C, CT] f32): quantities 0-3 and the center as they are, the
    attribute rows repacked from 7 to 4 per row, the word from its two
    16-bit halves (hi + lo coefficient rows at the constant-1 slot 9,
    exact) and the coverage as the kernels sum it (hi + lo)."""
    blocks = np.asarray(blocks, np.float32)
    c = blocks.shape[0]
    out = np.zeros((c, BLK_ROWS, LANES), np.float32)
    out[:, 0:ATTR_BASE, :] = blocks[:, 0:ATTR_BASE, :LANES]
    for i in range(AT_ROWS):
        out[:, ATTR_BASE + i // 4, (i % 4) * CT:(i % 4 + 1) * CT] = \
            blocks[:, ATTR_BASE + i // OMM_SLOTS,
                   (i % OMM_SLOTS) * CT:(i % OMM_SLOTS + 1) * CT]

    def slot(q):
        return blocks[:, 9, q * CT:(q + 1) * CT] \
            + blocks[:, 19, q * CT:(q + 1) * CT]

    word = slot(4).astype(np.int64) | (slot(5).astype(np.int64) << 16)
    return out, word.astype(np.uint32).view(np.int32), slot(6)


def cluster_tables_from_numpy(blocks, aabb_lo, aabb_hi, mat_rows, light_rows,
                              offsets, n_clusters, n_tris, n_lights,
                              device="cuda", instanced=False, wc_block=None,
                              wc_inst=None, xf=None, inst_post=None,
                              env_rows=None, tex_ct=None, tex_meta=None,
                              tex_maps=(0, 0, 0, 0), omm=False,
                              omm_word=None, omm_cov=None) -> ClusterTables:
    """ClusterTables on `device` (the GPU by default; raises without one)
    from numpy arrays of the JAX layout. Instanced tables take `wc_block`,
    `wc_inst`, `inst_post` and `xf`, either the port's M10 [I,10,10] or
    the JAX package's tile [I,16,128] (X[i,j] = M10[j,i]); `env_rows` is
    the JAX package's environment table or the port's
    (bounce_fused.env_table); `tex_ct` / `tex_meta` the JAX package's
    texture tables or the port's (bounce_fused.tex_tables), with
    `tex_maps` the materials' map flags. `omm`: the JAX package's 7-slot
    micromap blocks (converted by `omm_blocks_to_port`), or the port's
    4-slot blocks with `omm_word` and `omm_cov`."""
    from rtxpt_tpu_torch.pt.bounce_fused import env_table, tex_tables

    device = rtxpt_tpu_torch.device(device)

    def f(a):   # copies only arrays that are not writable f32 already
        return torch.from_numpy(np.require(a, np.float32, "CW")).to(device)

    def i32(a):
        return torch.from_numpy(np.require(a, np.int32, "CW")).to(device)

    parts = dict(wc_block=wc_block, wc_inst=wc_inst, xf=xf,
                 inst_post=inst_post)
    if bool(instanced) != all(v is not None for v in parts.values()):
        raise ValueError("instanced cluster tables need wc_block, wc_inst, "
                         "xf and inst_post; flat ones take none of them")
    if instanced:
        xf = np.asarray(xf, np.float32)
        if xf.shape[1:] == (16, 128):
            xf = xf[:, :10, :10].transpose(0, 2, 1)
        if xf.shape[1:] != (10, 10):
            raise ValueError(f"xf: expected [I,10,10] or [I,16,128], got "
                             f"{list(xf.shape)}")
        parts = dict(wc_block=i32(wc_block), wc_inst=i32(wc_inst), xf=f(xf),
                     inst_post=f(inst_post))
    if (tex_ct is None) != (tex_meta is None):
        raise ValueError("texture tables need both tex_ct and tex_meta")
    if tex_ct is not None:
        tex, meta = tex_tables(tex_ct, tex_meta)
        parts.update(tex=f(tex), tex_meta=i32(meta),
                     tex_maps=tuple(int(x) for x in tex_maps))
    blocks = np.asarray(blocks)
    if omm:
        if instanced:
            raise ValueError("omm: the instanced tier has no micromaps "
                             "(prepare flattens alpha-tested scenes)")
        if blocks.shape[-1] == OMM_SLOTS * CT:
            blocks, omm_word, omm_cov = omm_blocks_to_port(blocks)
        elif omm_word is None or omm_cov is None:
            raise ValueError("omm cluster tables need the micromap lanes "
                             "(7-slot blocks) or omm_word and omm_cov")
        parts.update(omm=True, omm_word=i32(omm_word), omm_cov=f(omm_cov))
    if blocks.shape[1:] != (BLK_ROWS, LANES):
        raise ValueError(f"blocks: expected [C, {BLK_ROWS}, {LANES}], got "
                         f"{list(blocks.shape)}")
    return ClusterTables(
        blocks=f(blocks), aabb_lo=f(aabb_lo), aabb_hi=f(aabb_hi),
        mat_rows=f(mat_rows), light_rows=f(light_rows),
        offsets=None if offsets is None else i32(offsets),
        n_clusters=int(n_clusters), n_tris=int(n_tris),
        n_lights=int(n_lights), instanced=bool(instanced),
        env=None if env_rows is None else f(env_table(env_rows)), **parts)


def _check_served(materials, lights):
    """Raise NotImplementedError, naming the feature, for what the
    clustered tier does not serve: sphere or environment-quad lights
    (the JAX package leaves them to the general tier), more than 128
    materials."""
    from rtxpt_tpu_torch.lighting.lights_baker import (
        KIND_ENVQUAD, KIND_SPHERE)
    from rtxpt_tpu_torch.pt.bounce_fused import MAX_MATERIALS

    if np.any(np.isin(_np(lights.kind), [KIND_SPHERE, KIND_ENVQUAD])):
        raise NotImplementedError("sphere and environment-quad lights: "
                                  "the general tier samples them")
    n_mats = len(_np(materials.base_color))
    if n_mats > MAX_MATERIALS:
        raise NotImplementedError(
            f"{n_mats} materials: the clustered tier takes at most "
            f"{MAX_MATERIALS}")


def _tex_parts(textures, materials) -> dict:
    """The texture keywords of cluster_tables_from_numpy for a
    TextureAtlas (none for an atlas the kernels' tables refuse:
    bounce_fused.build_tex_tables)."""
    from rtxpt_tpu_torch.pt.bounce_fused import build_tex_tables, tex_maps_of

    tex = build_tex_tables(textures)
    if tex is None:
        return {}
    return dict(tex_ct=tex[0], tex_meta=tex[1],
                tex_maps=tex_maps_of(materials))


def build_cluster_tables(positions, normals, indices, tri_material,
                         materials, lights, uvs=None, envmap=None,
                         textures=None, device="cuda", tri_micromap=None,
                         tri_cover=None) -> ClusterTables:
    """Bake the cluster tables of a flat, Morton-ordered scene onto
    `device` (the GPU by default; raises without one), with the
    environment table when the lights hold an environment light (`envmap`
    baked at 64 x 128), the texture tables of `textures` (a
    TextureAtlas) where the kernels' tables take it, and the micromap
    side table of `tri_micromap` / `tri_cover` ([t] each, scene/omm.py,
    in the same triangle order). Raises
    NotImplementedError, naming the feature,
    for a scene the clustered tier does not serve (anisotropic materials,
    sphere or environment-quad lights, more than 128 materials, no
    triangle)."""
    from rtxpt_tpu_torch.pt.bounce_fused import (
        lights_env_table, pack_lights, pack_materials)

    if float(np.max(_np(materials.anisotropy), initial=0.0)) > 0.0:
        raise NotImplementedError("anisotropic materials are not ported "
                                  "to the clustered tier")
    _check_served(materials, lights)
    t = len(indices)
    if t == 0:
        raise NotImplementedError("a scene without triangles: the "
                                  "clustered tier takes >= 1 triangle")
    built = build_cluster_blocks(
        positions, normals, indices, tri_material, lights, uvs=uvs,
        tri_micromap=tri_micromap, tri_cover=tri_cover)
    blocks, lo, hi, offsets = built[:4]
    omm = {}
    if tri_micromap is not None:
        omm = dict(omm=True, omm_word=built[4], omm_cov=built[5])
    return cluster_tables_from_numpy(
        blocks, lo, hi, pack_materials(materials), pack_lights(lights),
        offsets, len(offsets) - 1, t, int(lights.num), device,
        env_rows=lights_env_table(lights, envmap),
        **_tex_parts(textures, materials), **omm)


def instance_operand_map(A: np.ndarray, t_w: np.ndarray):
    """(M10 [10,10] f64, det A) of an instance with object -> world map
    x -> A x + t_w: M10 maps a world ray operand [d, o x d, o, 1] to the
    object frame's [d_o, o_o x d_o, o_o, 1], with d_o = A^-1 d and
    o_o = A^-1 o + t_o, t_o = -A^-1 t_w. The object direction stays
    unnormalised, so the ray parameter t is the world one."""
    det_a = float(np.linalg.det(A))
    a_inv = np.linalg.inv(A)
    t_o = -a_inv @ t_w
    m = np.zeros((10, 10), np.float64)
    m[0:3, 0:3] = a_inv
    tx = np.array([[0, -t_o[2], t_o[1]],
                   [t_o[2], 0, -t_o[0]],
                   [-t_o[1], t_o[0], 0]])
    m[3:6, 0:3] = tx @ a_inv
    m[3:6, 3:6] = (1.0 / det_a) * A.T           # det(A^-1) A^-1^-T
    m[6:9, 6:9] = a_inv
    m[6:9, 9] = t_o
    m[9, 9] = 1.0
    return m, det_a


def build_cluster_tables_instanced(built, host, materials, lights,
                                   envmap=None, textures=None, device="cuda",
                                   max_instances=65536
                                   ) -> Optional[ClusterTables]:
    """Instanced cluster tables of a two-level scene (`built` is
    tlas.build_two_level's dict) on `device` (the GPU by default; raises
    without one): object-space blocks per prototype, Morton-ordered and
    cut as the flat build cuts a scene, with AT_GIDX the pool triangle
    id; the world candidate list (instance x prototype cluster) with its
    world boxes, block and instance ids; per instance the operand map M10
    (`instance_operand_map`) and the attribute post-transform
    (`inst_post`).

    Returns None, as the JAX package does, for what the instanced tier
    leaves to the TLAS walk: emissive materials on pool triangles,
    instance transforms of non-positive determinant (mirrored ones would
    flip the facing test), anisotropic materials, sphere or
    environment-quad lights, an environment light whose map is not at the
    kernels' 64 x 128 (the two-level path bakes the source's own
    resolution), more than `max_instances` instances or candidates past
    the block budget. Raises NotImplementedError as `build_cluster_tables`
    does for more than 128 materials."""
    from rtxpt_tpu_torch.lighting.lights_baker import (
        KIND_ENVQUAD, KIND_SPHERE)
    from rtxpt_tpu_torch.pt.bounce_fused import (
        env_table_serves, lights_env_table, pack_lights, pack_materials)

    tl = built["tlas"]
    tri_base = np.asarray(built["tri_base"], np.int64)
    inst_mesh = _np(tl.inst_mesh)
    inst_pack = _np(tl.inst_pack)
    n_inst = len(inst_mesh)
    n_proto = len(tri_base) - 1
    if n_inst == 0 or n_inst > max_instances:
        return None
    if float(np.max(_np(materials.anisotropy), initial=0.0)) > 0.0:
        return None
    used = np.unique(np.asarray(built["tri_material"], np.int64))
    if np.any(np.abs(_np(materials.emissive)[used]) > 0.0):
        return None
    if np.any(np.isin(_np(lights.kind), [KIND_SPHERE, KIND_ENVQUAD])) or \
            not env_table_serves(lights, envmap):
        return None
    _check_served(materials, lights)

    pos = np.asarray(built["positions"], np.float32)
    nrm = np.asarray(built["normals"], np.float32)
    uv = np.asarray(built["uvs"], np.float32)
    idx = np.asarray(built["indices"], np.int32)
    mid = np.asarray(built["tri_material"], np.int32)

    # per-prototype object-space bakes
    proto = []
    block_base = np.zeros(n_proto + 1, np.int64)
    for p in range(n_proto):
        t0, t1 = int(tri_base[p]), int(tri_base[p + 1])
        pidx = idx[t0:t1]
        perm = morton_permutation(pos, pidx)
        blocks, lo, hi, _ = build_cluster_blocks(
            pos, nrm, pidx[perm], mid[t0:t1][perm], lights, uvs=uv,
            tri_gidx=(t0 + perm).astype(np.int32))
        proto.append((blocks, lo, hi))
        block_base[p + 1] = block_base[p] + len(blocks)

    # the expanded world candidate list and the per-instance maps
    wc_lo, wc_hi, wc_block, wc_inst = [], [], [], []
    xf = np.zeros((n_inst, 10, 10), np.float32)
    inst_post = np.zeros((n_inst, 19), np.float32)
    for i in range(n_inst):
        p = int(inst_mesh[i])
        A = inst_pack[i, 0:9].reshape(3, 3)
        t_w = inst_pack[i, 9:12]
        if float(np.linalg.det(A)) <= 1e-12:
            return None                            # mirrored / degenerate
        m, det_a = instance_operand_map(A, t_w)
        xf[i] = m.astype(np.float32)
        inst_post[i, 0:9] = A.reshape(-1)
        inst_post[i, 9:18] = inst_pack[i, 12:21]
        # tri_area2 = |n| scales as det(A)^(4/3) under A (exactly so for a
        # uniform scale), so LODB = -0.5 log2(area2) shifts by this
        inst_post[i, 18] = np.float32(-(2.0 / 3.0) * np.log2(max(
            det_a, 1e-12)))
        _, lo_p, hi_p = proto[p]
        c = (lo_p + hi_p) * 0.5
        e = (hi_p - lo_p) * 0.5
        wc = c @ A.T + t_w
        we = e @ np.abs(A).T
        wc_lo.append((wc - we).astype(np.float32))
        wc_hi.append((wc + we).astype(np.float32))
        nb = len(lo_p)
        wc_block.append(np.arange(nb, dtype=np.int32)
                        + np.int32(block_base[p]))
        wc_inst.append(np.full((nb,), i, np.int32))
    wc_lo = np.concatenate(wc_lo)
    n_cand = len(wc_lo)
    if n_cand > 4 * MAX_CLUSTERS:
        return None
    return cluster_tables_from_numpy(
        np.concatenate([b for b, _, _ in proto]), wc_lo,
        np.concatenate(wc_hi), pack_materials(materials), pack_lights(lights),
        None, n_cand, int(tri_base[-1]), int(lights.num), device,
        instanced=True, wc_block=np.concatenate(wc_block),
        wc_inst=np.concatenate(wc_inst), xf=xf, inst_post=inst_post,
        env_rows=lights_env_table(lights, envmap),
        **_tex_parts(textures, materials))
