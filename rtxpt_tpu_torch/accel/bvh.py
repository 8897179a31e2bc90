"""Threaded (skip-link) BVH (counterpart of rtxpt_tpu/accel/bvh.py).

Nodes are stored in preorder with a miss link:

    next(node) = node + 1            if the AABB is hit and node is internal
    next(node) = miss[node]          otherwise (leaf tested, or AABB missed)

so a walk needs no stack; it ends at next == -1. One [M, 17] f32 row per
node carries the whole per-node payload, the JAX package's layout:

    0:3 AABB min | 3:6 AABB max | 6 prim as f32 (-1 internal) |
    7 miss link as f32 (-1 done) | 8:11 leaf triangle v0 | 11:14 e1 |
    14:17 e2

(integers in f32 are exact below 2^24; the build asserts it). The plain
threaded walk (accel/traverse.py `_traverse`) reads these rows.

The BVH walk kernel K9 (csrc/bvh_traverse.cu) and its plain version
(`_traverse_wide`) walk the same tree collapsed to 4 children a node
(`collapse_wide`, once per scene), one 128-byte row per wide node:

    0:4 the children's AABB min x | 4:8 min y | 8:12 min z |
    12:16 max x | 16:20 max y | 20:24 max z |
    24:28 the child references as i32 bits: 0 no child, r > 0 the inner
    wide node r, r < 0 the leaf -r - 1 (its packed leaf index) | 28:32 zero

Each child box is the binary node's AABB bit for bit. A binary node's box
contains its descendants' boxes and the slab test is monotone in the box,
so skipping the collapsed binary nodes between two wide levels loses no
hit. The leaf triangles sit in their own [T, 12] f32 table in leaf order,
48 bytes a row: v0, 0, e1, 0, e2, 0, the floats the [M, 17] rows hold.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NODE_ROWS = 17
WIDE_ROWS = 32        # f32 per wide node: one 128-byte row
WIDE_TRI_ROWS = 12    # f32 per leaf triangle: 48 bytes
WIDE_REF = 24         # first child reference of a wide row
# entries of K9's per-ray stack (csrc/accel.cuh kWideStack); a tree whose
# walk could need more raises in `bvh_from_packed`
WIDE_STACK = 96


@dataclass(frozen=True)
class ThreadedBVH:
    nodes: torch.Tensor       # [M,17] f32
    # per-triangle operands of the brute-force closest hit (accel/brute.py),
    # present for scenes of at most brute.BRUTE_MAX_TRIS triangles
    brute: Optional[object]   # brute.BruteTris
    tri_v0: torch.Tensor      # [T,3] f32 packed triangles in leaf order
    tri_e1: torch.Tensor      # [T,3] f32 (v1 - v0)
    tri_e2: torch.Tensor      # [T,3] f32 (v2 - v0)
    prim_tri: torch.Tensor    # [T] i32 packed index -> original triangle id
    wide: torch.Tensor        # [W, WIDE_ROWS] f32 4-wide nodes (K9's)
    wide_tris: torch.Tensor   # [T, WIDE_TRI_ROWS] f32 leaf triangles
    wide_depth: int           # levels of the 4-wide tree
    wide_stack: int           # stack entries its walk can need at most
    # [T] i32 opacity micromap words (u32 bits) in packed order: the walk
    # rejects micro-TRANSPARENT hits (scene/omm.py); None without
    tri_micro: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def num_wide(self) -> int:
        return self.wide.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.tri_v0.shape[0]

    @property
    def device(self):
        return self.nodes.device

    def replace(self, **kw) -> "ThreadedBVH":
        return dataclasses.replace(self, **kw)


def bvh_from_packed(packed: np.ndarray, prim_tri: np.ndarray, v0, e1, e2,
                    brute=None, device="cuda") -> ThreadedBVH:
    """ThreadedBVH on `device` (the GPU by default; raises without one)
    from the packed [M,17] node table, the leaf-order -> original triangle
    map and the leaf-order triangles."""
    import rtxpt_tpu_torch

    device = rtxpt_tpu_torch.device(device)

    def t(a, dtype=np.float32):
        return torch.tensor(np.asarray(a, dtype), device=device)

    packed = np.asarray(packed, np.float32)
    assert len(packed) < (1 << 24), "int-in-f32 packing limit"
    wide, tris, depth, stack = collapse_wide(packed)
    if stack > WIDE_STACK:
        raise ValueError(
            f"BVH too deep for the walk's stack: its 4-wide tree has "
            f"{depth} levels and its walk can need {stack} stack entries, "
            f"K9 keeps {WIDE_STACK}")
    return ThreadedBVH(
        nodes=t(packed), brute=brute, tri_v0=t(v0), tri_e1=t(e1),
        tri_e2=t(e2), prim_tri=t(prim_tri, np.int32), wide=t(wide),
        wide_tris=t(tris), wide_depth=depth, wide_stack=stack)


def _box_area(packed):
    ext = packed[:, 3:6].astype(np.float64) - packed[:, 0:3]
    return ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] \
        + ext[:, 2] * ext[:, 0]


def collapse_wide(packed: np.ndarray):
    """The threaded binary table packed [M, 17] collapsed to 4 children a
    node: (wide [W, WIDE_ROWS] f32, tris [T, WIDE_TRI_ROWS] f32, depth,
    stack). Level by level from the root, each wide node takes its binary
    node's two children, replaces each inner one by its two children, and
    where that leaves three, the inner one of the largest AABB area by its
    two; children keep the binary tree's left-to-right order. Wide nodes
    are numbered level by level. `stack` bounds the entries a walk that
    pushes a node's hit inner children can hold: the largest, over the
    wide nodes, of the siblings left on the stack above the root plus the
    node's own inner children."""
    m = len(packed)
    prim = packed[:, 6].astype(np.int64)
    inner = prim < 0
    ids = np.arange(m)
    left = np.where(inner, ids + 1, -1)
    right = np.where(inner, packed[np.minimum(ids + 1, m - 1), 7]
                     .astype(np.int64), -1)
    area = _box_area(packed)

    def pair(c):
        """[F, 2]: an inner node's two children, a leaf and no child."""
        isin = inner[c]
        return np.stack([np.where(isin, left[c], c),
                         np.where(isin, right[c], -1)], 1)

    levels, frontier, below = [], np.zeros(1, np.int64), np.zeros(1, np.int64)
    stack = 1
    while len(frontier):
        if inner[frontier[0]]:
            kids = np.concatenate([pair(left[frontier]),
                                   pair(right[frontier])], 1)
            # the present children first, in order
            order = np.argsort(kids < 0, axis=1, kind="stable")
            kids = np.take_along_axis(kids, order, 1)
        else:                                   # a single-leaf tree
            kids = np.array([[frontier[0], -1, -1, -1]])
        three = np.nonzero((kids >= 0).sum(1) == 3)[0]
        s3 = kids[three, :3]
        a = np.where(inner[s3], area[s3], -1.0)
        grow = a.max(1) >= 0
        rows, p, s3 = three[grow], a.argmax(1)[grow], s3[grow]
        cols = np.arange(4)[None]
        pick = s3[np.arange(len(rows)), p][:, None]
        val = np.take_along_axis(s3, np.clip(np.where(cols < p[:, None],
                                                      cols, cols - 1), 0, 2),
                                 1)
        val = np.where(cols == p[:, None], left[pick], val)
        kids[rows] = np.where(cols == p[:, None] + 1, right[pick], val)
        present = kids >= 0
        is_in = present & inner[np.maximum(kids, 0)]
        k = is_in.sum(1)
        stack = max(stack, int((below + k).max()))
        levels.append((kids, present, is_in))
        nxt_below = np.repeat(below + k - 1, k)
        frontier, below = kids[is_in], nxt_below
    # number the wide nodes level by level; inner references point into
    # the next level
    w = sum(len(kids) for kids, _, _ in levels)
    wide = np.zeros((w, WIDE_ROWS), np.float32)
    refs = wide[:, WIDE_REF:WIDE_REF + 4].view(np.int32)
    base = 0
    for kids, present, is_in in levels:
        f = len(kids)
        nxt = base + f
        safe = np.maximum(kids, 0)
        box = np.where(present[..., None], packed[safe, 0:6], 0.0)
        wide[base:nxt, 0:24] = box.transpose(0, 2, 1).reshape(f, 24)
        inner_ids = np.zeros(kids.shape, np.int64)
        inner_ids[is_in] = nxt + np.arange(int(is_in.sum()))
        r = np.where(is_in, inner_ids, np.where(present, -prim[safe] - 1, 0))
        refs[base:nxt] = r.astype(np.int32)
        base = nxt
    leaf = np.nonzero(~inner)[0]
    tris = np.zeros((len(leaf), WIDE_TRI_ROWS), np.float32)
    tris[prim[leaf]] = np.concatenate([
        packed[leaf, 8:11], np.zeros((len(leaf), 1), np.float32),
        packed[leaf, 11:14], np.zeros((len(leaf), 1), np.float32),
        packed[leaf, 14:17], np.zeros((len(leaf), 1), np.float32)], 1)
    return wide, tris, len(levels), stack


def bvh_from_numpy(fields: dict, device="cuda") -> ThreadedBVH:
    """ThreadedBVH on `device` (the GPU by default) from the JAX package's
    ThreadedBVH fields as numpy arrays (nodes, prim_tri, tri_v0, tri_e1,
    tri_e2, and brute: None or the BruteTris fields e1_t, e2_t, n_t,
    v0xe2_t, v0xe1_t, v0n; tri_micro: None or the micromap words in leaf
    order)."""
    import rtxpt_tpu_torch
    from rtxpt_tpu_torch.accel.brute import brute_from_fields

    device = rtxpt_tpu_torch.device(device)
    brute = fields.get("brute")
    bvh = bvh_from_packed(
        fields["nodes"], fields["prim_tri"], fields["tri_v0"],
        fields["tri_e1"], fields["tri_e2"],
        brute=None if brute is None else brute_from_fields(brute, device),
        device=device)
    micro = fields.get("tri_micro")
    if micro is not None:
        bvh = bvh.replace(tri_micro=torch.tensor(
            np.asarray(micro).astype(np.int64).astype(np.uint32)
            .view(np.int32), device=device))
    return bvh
