"""Two-level acceleration structure (counterpart of rtxpt_tpu/accel/tlas.py):
a small threaded BVH over instances above one BVH per mesh prototype.

Instances that share a prototype (`MeshInstance.mesh_key`, or the same
positions array) share its triangles and its BVH: geometry memory is
O(prototypes), not O(instances). The host build (`build_two_level`) is the
JAX package's numpy code, so both packages build the same arrays.

The walk (`_traverse_tlas`) is one loop over ONE node pool [M, 22]: the
TLAS rows first, then every prototype's BVH rows. An instance leaf row
carries its world -> object transform; entering it saves the leaf's miss
link as the one-deep resume point (there are exactly two levels) and
re-bases the ray into the prototype's frame. A prototype subtree's exit
links are the POP sentinel, which restores the world ray and jumps to the
resume point. The object direction is not normalised, so t stays the
world ray parameter across both levels.

Node row layout ([M,22] f32; integers in f32 exact below 2^24):
    0:6   AABB lo/hi       (world for TLAS rows, object for mesh rows)
    6     prim             mesh leaf: pool-packed triangle id; else -1
    7     miss link        next preorder node on miss; -1 done; -2 POP
    8:17  mesh leaf: triangle v0 | e1 | e2 (object space)
          instance leaf: world -> object rotation, row-major
    17:20 instance leaf: world -> object translation
    20    instance leaf: the prototype subtree's entry node; else -1
    21    instance leaf: instance id; else -1

Emissive prototypes: the lights bake runs over the expanded (instance x
emissive pool triangle) list, in instance-major, pool order; a hit
(prim, inst) maps to its light through inst_light_base[inst] +
em_rank[prim] (lights_baker.emissive_prim_index).

The walk is plain PyTorch, as the JAX package computes it outside Pallas;
`refit_tlas` (rigid animation) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import sys
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.accel.traverse import Hit, _cross, _dot3, _safe_inv
from rtxpt_tpu_torch.utils.math import matvec

_POP = -2.0
_F32I_MAX = 1 << 24
_TRI_EPS = 1e-9
NODE_ROWS = 22


@dataclass(frozen=True)
class TLAS:
    nodes: torch.Tensor       # [M,22] f32 unified node pool
    prim_tri: torch.Tensor    # [Tp] i32 packed -> original pool triangle
    inst_pack: torch.Tensor   # [I,21] o2w rot (9) | o2w trans (3) | nmat (9)
    # refit machinery (static topology)
    inst_rows: torch.Tensor   # [I] i32 node row of instance i's leaf
    inst_mesh: torch.Tensor   # [I] i32 prototype id
    mesh_lo: torch.Tensor     # [P,3] object-space prototype AABBs
    mesh_hi: torch.Tensor     # [P,3]
    leaf_order: torch.Tensor  # [I] i32 instance id at TLAS leaf slot k
    int_rows: torch.Tensor    # [K] i32 node rows of TLAS internal nodes
    int_level: torch.Tensor   # [K] i32 floor(log2(range length))
    int_a: torch.Tensor       # [K] i32 left range-min lookup index
    int_b: torch.Tensor       # [K] i32 right range-min lookup index
    # emissive instancing: expanded light id = inst_light_base + em_rank
    em_rank: torch.Tensor          # [Tpool] i32, -1 = not emissive
    inst_light_base: torch.Tensor  # [I] i32
    n_instances: int = 0
    n_meshes: int = 0

    @property
    def num_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def device(self):
        return self.nodes.device


_I32_FIELDS = ("prim_tri", "inst_rows", "inst_mesh", "leaf_order",
               "int_rows", "int_level", "int_a", "int_b", "em_rank",
               "inst_light_base")


def tlas_from_numpy(fields: dict, device="cuda") -> TLAS:
    """TLAS on `device` (the GPU by default; raises without one) from the
    JAX package's TLAS fields as numpy arrays and ints."""
    device = rtxpt_tpu_torch.device(device)
    kw = {}
    for f in dataclasses.fields(TLAS):
        v = fields[f.name]
        if f.name in ("n_instances", "n_meshes"):
            kw[f.name] = int(v)
        else:
            dtype = np.int32 if f.name in _I32_FIELDS else np.float32
            kw[f.name] = torch.from_numpy(
                np.require(np.asarray(v), dtype, "CW")).to(device)
    return TLAS(**kw)


# ---------------------------------------------------------------------------
# Host build
# ---------------------------------------------------------------------------


def _box_tree_preorder(lo: np.ndarray, hi: np.ndarray):
    """Median-split threaded BVH over boxes. Returns (rows, leaf_order,
    ranges): rows = list of (aabb_lo, aabb_hi, leaf_id, miss) in preorder
    with miss links; leaf_id >= 0 marks a leaf (an index into lo/hi), -1
    an internal node. leaf_order lists the leaf ids in preorder; every
    internal node covers the contiguous slice ranges[row] of it."""
    n = len(lo)
    cen = (lo + hi) * 0.5
    rows = []
    leaf_order = []
    ranges = []

    def rec(ids: np.ndarray, miss: int) -> int:
        my = len(rows)
        blo = lo[ids].min(0)
        bhi = hi[ids].max(0)
        if len(ids) == 1:
            rows.append([blo, bhi, int(ids[0]), miss])
            ranges.append((len(leaf_order), len(leaf_order)))
            leaf_order.append(int(ids[0]))
            return my
        rows.append([blo, bhi, -1, miss])
        ranges.append(None)
        axis = int(np.argmax(bhi - blo))
        order = ids[np.argsort(cen[ids, axis], kind="stable")]
        half = len(order) // 2
        a0 = len(leaf_order)
        left_ids, right_ids = order[:half], order[half:]
        # a subtree over k boxes takes 2k - 1 rows, so the right child's
        # row is known before the left subtree is built
        right_row = my + 1 + (2 * len(left_ids) - 1)
        rec(left_ids, right_row)
        got = rec(right_ids, miss)
        assert got == right_row
        ranges[my] = (a0, len(leaf_order) - 1)
        return my

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 4 * n + 1000))
    try:
        rec(np.arange(n), -1)
    finally:
        sys.setrecursionlimit(old_limit)
    return rows, np.asarray(leaf_order, np.int64), ranges


def _mesh_key(inst) -> object:
    k = getattr(inst, "mesh_key", None)
    return k if k is not None else id(inst.positions)


def build_two_level(host, min_sharing: float = 1.5,
                    device="cuda") -> Optional[dict]:
    """Group host.instances by shared prototype and build the two-level
    structure, with its TLAS on `device` (the GPU by default; raises
    without one). Returns None (the caller flattens) when instances per
    prototype stay below `min_sharing` and the host does not set
    force_instancing, or when a material is alpha-tested on a textured
    scene.

    Returns a dict: tlas, the pool arrays (positions, normals, uvs,
    indices, tri_material, tri_subinstance), tri_base [P+1] (each
    prototype's first pool triangle) and the expanded emissive list for
    the lights bake (light_positions, light_indices, light_materials,
    light_subinstance)."""
    from rtxpt_tpu_torch.accel.lbvh import build_packed

    device = rtxpt_tpu_torch.device(device)
    insts = host.instances
    if not insts:
        return None
    keys = [_mesh_key(it) for it in insts]
    protos: List[int] = []            # instance index of first occurrence
    proto_of: List[int] = []          # per-instance prototype id
    seen = {}
    for i, k in enumerate(keys):
        if k in seen:
            proto_of.append(seen[k])
        else:
            seen[k] = len(protos)
            proto_of.append(len(protos))
            protos.append(i)
    n_inst, n_proto = len(insts), len(protos)
    force = getattr(host, "force_instancing", False)
    if n_inst / n_proto < min_sharing and not force:
        return None
    if host.textures:
        mats = host.materials
        if mats is not None and np.any(_np(mats.alpha_cutoff) >= 0):
            return None               # the alpha retrace is BVH-path only

    # ---- object pool (prototypes concatenated, original triangle order)
    pool_pos, pool_nrm, pool_uv, pool_idx = [], [], [], []
    pool_mat, pool_sub = [], []
    tri_base = np.zeros(n_proto + 1, np.int64)
    vert_base = 0
    for p, i0 in enumerate(protos):
        it = insts[i0]
        pool_pos.append(np.asarray(it.positions, np.float32))
        pool_nrm.append(np.asarray(it.normals, np.float32))
        uvs = it.uvs if it.uvs is not None else np.zeros(
            (len(it.positions), 2), np.float32)
        pool_uv.append(np.asarray(uvs, np.float32))
        pool_idx.append(np.asarray(it.indices, np.int64) + vert_base)
        pool_mat.append(np.asarray(it.material, np.int32))
        pool_sub.append(np.full((len(it.indices),), i0, np.int32))
        vert_base += len(it.positions)
        tri_base[p + 1] = tri_base[p] + len(it.indices)
    positions = np.concatenate(pool_pos)
    normals = np.concatenate(pool_nrm)
    uvs = np.concatenate(pool_uv)
    indices = np.concatenate(pool_idx).astype(np.int32)
    tri_material = np.concatenate(pool_mat)
    tri_subinstance = np.concatenate(pool_sub)

    # rank each pool triangle among its prototype's emissive triangles
    em_rank = np.full((len(indices),), -1, np.int32)
    if host.materials is not None:
        em = _np(host.materials.emissive)
        lum = em @ np.asarray([0.2126, 0.7152, 0.0722])
        emissive_mat = lum > 0.0                   # as bake_lights decides
        for p in range(n_proto):
            tm = tri_material[tri_base[p]:tri_base[p + 1]]
            mask = emissive_mat[np.clip(tm, 0, len(emissive_mat) - 1)]
            em_rank[tri_base[p]:tri_base[p + 1]][mask] = \
                np.arange(int(mask.sum()), dtype=np.int32)

    # ---- per-prototype mesh BVHs (object space)
    mesh_tables, mesh_prim_tri = [], []
    mesh_lo = np.zeros((n_proto, 3), np.float32)
    mesh_hi = np.zeros((n_proto, 3), np.float32)
    for p, i0 in enumerate(protos):
        it = insts[i0]
        packed, order = build_packed(it.positions, it.indices)
        tbl = np.array(np.asarray(packed, np.float32))     # [m,17]
        mesh_tables.append(tbl)
        mesh_prim_tri.append(np.asarray(order).astype(np.int64)
                             + tri_base[p])
        mesh_lo[p] = tbl[0, 0:3]
        mesh_hi[p] = tbl[0, 3:6]

    # ---- instance transforms + world AABBs
    o2w = np.stack([np.asarray(it.transform, np.float32)
                    for it in insts])                  # [I,4,4]
    A = o2w[:, :3, :3]
    b = o2w[:, :3, 3]
    w2o = np.linalg.inv(o2w)[:, :4, :4]
    c = ((mesh_lo + mesh_hi) * 0.5)[proto_of]
    e = ((mesh_hi - mesh_lo) * 0.5)[proto_of]
    cw = np.einsum("nij,nj->ni", A, c) + b
    ew = np.einsum("nij,nj->ni", np.abs(A), e)
    inst_lo, inst_hi = cw - ew, cw + ew

    trows, leaf_order, ranges = _box_tree_preorder(inst_lo, inst_hi)
    n_tlas = len(trows)

    node_base = np.zeros(n_proto + 1, np.int64)
    node_base[0] = n_tlas
    for p in range(n_proto):
        node_base[p + 1] = node_base[p] + len(mesh_tables[p])
    packed_base = np.zeros(n_proto + 1, np.int64)
    for p in range(n_proto):
        packed_base[p + 1] = packed_base[p] + len(mesh_prim_tri[p])
    m_total = int(node_base[-1])
    assert m_total < _F32I_MAX and packed_base[-1] < _F32I_MAX

    nodes = np.zeros((m_total, NODE_ROWS), np.float32)
    nodes[:, 6] = -1.0
    nodes[:, 20] = -1.0
    nodes[:, 21] = -1.0

    # TLAS rows
    inst_rows = np.zeros(n_inst, np.int64)
    int_rows, int_ranges = [], []
    for r, (blo, bhi, leaf_id, miss) in enumerate(trows):
        nodes[r, 0:3] = blo
        nodes[r, 3:6] = bhi
        nodes[r, 7] = float(miss)
        if leaf_id >= 0:
            p = proto_of[leaf_id]
            nodes[r, 8:17] = w2o[leaf_id, :3, :3].reshape(-1)
            nodes[r, 17:20] = w2o[leaf_id, :3, 3]
            nodes[r, 20] = float(node_base[p])
            nodes[r, 21] = float(leaf_id)
            inst_rows[leaf_id] = r
        else:
            int_rows.append(r)
            int_ranges.append(ranges[r])

    # mesh pool rows: leaf prims re-based into the packed pool, exit links
    # become POP, internal links re-based to the pool rows
    for p in range(n_proto):
        tbl = mesh_tables[p]
        base = node_base[p]
        dst = nodes[base:base + len(tbl)]
        dst[:, 0:17] = tbl
        pr = tbl[:, 6]
        dst[:, 6] = np.where(pr >= 0, pr + float(packed_base[p]), -1.0)
        ms = tbl[:, 7]
        dst[:, 7] = np.where(ms >= 0, ms + float(base), _POP)

    prim_tri = np.concatenate(mesh_prim_tri).astype(np.int32)

    # inst pack: o2w rotation | o2w translation | normal matrix (the w2o
    # rotation transposed)
    nmat = np.transpose(w2o[:, :3, :3], (0, 2, 1))
    inst_pack = np.concatenate([
        A.reshape(n_inst, 9), b, nmat.reshape(n_inst, 9)], axis=1)

    # sparse-table lookup indices of the internal nodes' range-min refit
    int_rows = np.asarray(int_rows, np.int64)
    rg = np.asarray(int_ranges, np.int64).reshape(-1, 2)
    ln = rg[:, 1] - rg[:, 0] + 1
    lev = np.floor(np.log2(np.maximum(ln, 1))).astype(np.int64)
    ib = rg[:, 1] - (1 << lev) + 1

    # the expanded emissive list: per (instance, emissive pool triangle),
    # world-space vertices, instance-major, pool order
    inst_light_base = np.zeros(n_inst, np.int64)
    exp_tris, exp_mats, exp_insts = [], [], []
    run = 0
    v0i = positions[indices[:, 0]]
    v1i = positions[indices[:, 1]]
    v2i = positions[indices[:, 2]]
    for i in range(n_inst):
        inst_light_base[i] = run
        p = proto_of[i]
        t0, t1 = tri_base[p], tri_base[p + 1]
        sel = np.nonzero(em_rank[t0:t1] >= 0)[0] + t0
        if len(sel):
            tri = np.stack([v0i[sel], v1i[sel], v2i[sel]], 1)  # [E,3,3]
            exp_tris.append(tri @ A[i].T + b[i])
            exp_mats.append(tri_material[sel])
            exp_insts.append(np.full((len(sel),), i, np.int32))
        run += len(sel)
    if exp_tris:
        et = np.concatenate(exp_tris).astype(np.float32)   # [E,3,3]
        light_positions = et.reshape(-1, 3)
        light_indices = np.arange(et.shape[0] * 3,
                                  dtype=np.int32).reshape(-1, 3)
        light_materials = np.concatenate(exp_mats).astype(np.int32)
        light_subinstance = np.concatenate(exp_insts)
    else:
        light_positions = np.zeros((0, 3), np.float32)
        light_indices = np.zeros((0, 3), np.int32)
        light_materials = np.zeros((0,), np.int32)
        light_subinstance = np.zeros((0,), np.int32)

    tl = tlas_from_numpy(dict(
        nodes=nodes, prim_tri=prim_tri,
        inst_pack=inst_pack.astype(np.float32), inst_rows=inst_rows,
        inst_mesh=np.asarray(proto_of, np.int32), mesh_lo=mesh_lo,
        mesh_hi=mesh_hi, leaf_order=leaf_order, int_rows=int_rows,
        int_level=lev, int_a=rg[:, 0], int_b=ib, em_rank=em_rank,
        inst_light_base=inst_light_base, n_instances=n_inst,
        n_meshes=n_proto), device)
    return dict(tlas=tl, positions=positions, normals=normals, uvs=uvs,
                indices=indices, tri_material=tri_material,
                tri_subinstance=tri_subinstance, tri_base=tri_base,
                light_positions=light_positions,
                light_indices=light_indices,
                light_materials=light_materials,
                light_subinstance=light_subinstance)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---------------------------------------------------------------------------
# The walk
# ---------------------------------------------------------------------------


def _traverse_tlas(tl: TLAS, o, d, tmin, tmax, any_hit: bool):
    """The two-level walk over rays o, d [N,3] f32, tmin, tmax [N] f32: the
    enter / pop state machine of the module docstring, every live ray one
    node per step. Finished rays drop out between steps; each ray's result
    is that of a walk of its own. Returns dict(t [N], prim [N] i32 packed
    pool id (-1 miss), inst [N] i32 instance of the hit, uv [N,2],
    front [N] bool)."""
    n = o.shape[0]
    dev = o.device
    t = tmax.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    hit_inst = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    # per live ray: node, current instance, resume node, current frame ray
    live = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    inst = torch.full((n,), -1, dtype=torch.int64, device=dev)
    resume = torch.full((n,), -1, dtype=torch.int64, device=dev)
    co, cd, cinvd = o.clone(), d.clone(), _safe_inv(d)
    while live.numel():
        g = tl.nodes[node]                             # [L,22]
        tmin_l, t_l = tmin[live], t[live]
        t0 = (g[:, 0:3] - co) * cinvd
        t1 = (g[:, 3:6] - co) * cinvd
        tn = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=1), tmin_l)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=1), t_l)
        aabb_hit = tn <= tf
        pr = g[:, 6].to(torch.int32)
        miss_link = g[:, 7].to(torch.int64)
        enter = g[:, 20].to(torch.int64)
        is_leaf = pr >= 0
        v0, e1, e2 = g[:, 8:11], g[:, 11:14], g[:, 14:17]
        pvec = _cross(cd, e2)
        det = _dot3(e1, pvec)
        ok_det = torch.abs(det) > _TRI_EPS
        inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0),
                              0.0)
        tvec = co - v0
        u = _dot3(tvec, pvec) * inv_det
        qvec = _cross(tvec, e1)
        v = _dot3(cd, qvec) * inv_det
        th = _dot3(e2, qvec) * inv_det
        tri_hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (th > tmin_l) & (th < t_l) & is_leaf & aabb_hit)
        won = live[tri_hit]
        t[won] = th[tri_hit]
        prim[won] = pr[tri_hit]
        hit_inst[won] = inst[tri_hit].to(torch.int32)
        uv[won] = torch.stack([u, v], dim=1)[tri_hit]
        front[won] = (det > 0.0)[tri_hit]

        enter_ok = aabb_hit & (enter >= 0)
        descend = aabb_hit & ~is_leaf & (enter < 0)
        nxt = torch.where(descend, node + 1, miss_link)
        nxt = torch.where(enter_ok, enter, nxt)
        pop = nxt == -2
        # re-basing: world -> object on enter, back to world on pop
        if bool(enter_ok.any()) or bool(pop.any()):
            ow, dw = o[live], d[live]
            rot = g[:, 8:17].reshape(-1, 3, 3)
            o_obj = matvec(rot, ow) + g[:, 17:20]
            d_obj = matvec(rot, dw)
            ek, pk = enter_ok[:, None], pop[:, None]
            co = torch.where(ek, o_obj, torch.where(pk, ow, co))
            cd = torch.where(ek, d_obj, torch.where(pk, dw, cd))
            cinvd = torch.where(ek | pk, _safe_inv(cd), cinvd)
        nxt = torch.where(pop, resume, nxt)
        resume = torch.where(enter_ok, miss_link, resume)
        inst = torch.where(enter_ok, g[:, 21].to(torch.int64),
                           torch.where(pop, -1, inst))
        if any_hit:
            nxt = torch.where(tri_hit, -1, nxt)
        keep = nxt >= 0
        live, node = live[keep], nxt[keep]
        inst, resume = inst[keep], resume[keep]
        co, cd, cinvd = co[keep], cd[keep], cinvd[keep]
    return dict(t=t, prim=prim, inst=hit_inst, uv=uv, front=front)


def intersect_closest_tlas(tl: TLAS, o, d, tmin, tmax) -> Hit:
    """Closest hit over the two-level structure: Hit.prim is the pool
    triangle id and Hit.inst the instance (shading needs both)."""
    s = _traverse_tlas(tl, o, d, tmin, tmax, any_hit=False)
    prim = torch.where(s["prim"] >= 0,
                       tl.prim_tri[torch.clamp(s["prim"], min=0).long()], -1)
    return Hit(t=s["t"], prim=prim, bary=s["uv"], front=s["front"],
               inst=torch.where(prim >= 0, s["inst"], -1))


def intersect_any_tlas(tl: TLAS, o, d, tmin, tmax):
    """Visibility over the two-level structure: True where occluded."""
    return _traverse_tlas(tl, o, d, tmin, tmax, any_hit=True)["prim"] >= 0
