"""Threaded (skip-link) BVH (counterpart of rtxpt_tpu/accel/bvh.py).

Nodes are stored in preorder with a miss link:

    next(node) = node + 1            if the AABB is hit and node is internal
    next(node) = miss[node]          otherwise (leaf tested, or AABB missed)

so a walk needs no stack; it ends at next == -1. One [M, 17] f32 row per
node carries the whole per-node payload, the JAX package's layout:

    0:3 AABB min | 3:6 AABB max | 6 prim as f32 (-1 internal) |
    7 miss link as f32 (-1 done) | 8:11 leaf triangle v0 | 11:14 e1 |
    14:17 e2

(integers in f32 are exact below 2^24; the build asserts it). The BVH
walk kernel K9 (csrc/bvh_traverse.cu) reads these rows as they are.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

NODE_ROWS = 17


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
    # [T] i32 opacity micromap words (u32 bits) in packed order: the walk
    # rejects micro-TRANSPARENT hits (scene/omm.py); None without
    tri_micro: Optional[torch.Tensor] = None

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

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
    return ThreadedBVH(
        nodes=t(packed), brute=brute, tri_v0=t(v0), tri_e1=t(e1),
        tri_e2=t(e2), prim_tri=t(prim_tri, np.int32))


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
