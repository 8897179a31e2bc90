"""BVH walk and the scene's ray queries (counterpart of
rtxpt_tpu/accel/traverse.py).

`walk` runs the CUDA kernel K9 (csrc/bvh_traverse.cu) on CUDA tensors and
its plain version `_traverse_wide` on CPU tensors: each ray walks the
4-wide tree (accel/bvh.py `collapse_wide`) nearest child first with a
stack. `_traverse` is the JAX package's walk of the threaded binary BVH
in skip-link order, kept as the model the wide walk is held to: at each
node a slab test against the AABB, and at a leaf whose AABB it hit the
Möller-Trumbore test of the leaf triangle (|det| > 1e-9, tmin < t < the
best t so far); it descends to node + 1 on an internal hit and follows
the miss link otherwise. The any-hit variants stop at their first hit.
A BVH with opacity micromaps (`tri_micro`, the words in leaf order)
rejects a hit whose micro-triangle is TRANSPARENT inside the walk
(rtxpt_tpu/accel/traverse.py:113-121); the other states are the alpha
retrace's (scene/omm.py).

The plain versions advance every live ray one step at a time and drop
the finished rays between steps; the result of each ray is the same as a
walk of its own. min and max propagate NaN (as jnp.minimum and
torch.minimum do), so a ray with NaN components ends as in the JAX
package.

`intersect_closest` and `intersect_any` take the brute force
(accel/brute.py, K8) when the BVH carries brute tables and the walk
otherwise; `scene_closest` and `scene_any` are the queries the
integrator makes, and route a two-level scene to the TLAS walk
(accel/tlas.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel.bvh import (
    WIDE_REF, WIDE_ROWS, WIDE_TRI_ROWS, ThreadedBVH)
from rtxpt_tpu_torch.scene import omm

_INVD_MAX = 1e30
_TRI_EPS = 1e-9
# the wide walk's prune slack after its first hit: a child is skipped where
# its entry exceeds best_t + |best_t| x 2^-20 (csrc/accel.cuh kWideSlack)
WIDE_SLACK = 2.0 ** -20


@dataclass(frozen=True)
class Hit:
    t: torch.Tensor        # [N] f32 hit distance (tmax where missed)
    prim: torch.Tensor     # [N] i32 original triangle id, -1 = miss
    bary: torch.Tensor     # [N,2] f32 barycentrics (u toward v1, v toward v2)
    front: torch.Tensor    # [N] bool geometric front face (ccw)
    # [N] i32 instance of the hit on a two-level scene (-1 = miss); None
    # on a flat scene
    inst: Optional[torch.Tensor] = None

    @property
    def miss(self):
        return self.prim < 0

    def where(self, cond, other: "Hit") -> "Hit":
        """Per ray, `other`'s hit where cond [N] holds, else this one."""
        def pick(a, b):
            c = cond.reshape(cond.shape + (1,) * (a.ndim - 1))
            return torch.where(c, b, a)
        return Hit(t=pick(self.t, other.t), prim=pick(self.prim, other.prim),
                   bary=pick(self.bary, other.bary),
                   front=pick(self.front, other.front),
                   inst=None if self.inst is None
                   else pick(self.inst, other.inst))

    def take(self, sl) -> "Hit":
        """The hits of rays `sl` (a slice or an index tensor)."""
        return Hit(t=self.t[sl], prim=self.prim[sl], bary=self.bary[sl],
                   front=self.front[sl],
                   inst=None if self.inst is None else self.inst[sl])


def _safe_inv(d):
    mag = torch.abs(d)
    sgn = torch.where(d >= 0.0, 1.0, -1.0)
    return torch.where(mag > 1e-24, 1.0 / torch.where(mag > 1e-24, d, 1.0),
                       sgn * _INVD_MAX)


def _dot3(a, b):
    """Row-wise dot of [L,3] tensors, summed as (x + y) + z."""
    return a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1] + a[:, 2] * b[:, 2]


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _triangle(v0, e1, e2, o, d, tmin):
    """The Möller-Trumbore test of triangles v0, e1, e2 [L, 3] against rays
    o, d [L, 3]: (th, u, v, det, inside: the pair hits beyond tmin [L],
    whatever the best t)."""
    pvec = _cross(d, e2)
    det = _dot3(e1, pvec)
    ok_det = torch.abs(det) > _TRI_EPS
    inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    tvec = o - v0
    u = _dot3(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot3(d, qvec) * inv_det
    th = _dot3(e2, qvec) * inv_det
    inside = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
              & (th > tmin))
    return th, u, v, det, inside


def _traverse(bvh: ThreadedBVH, o, d, tmin, tmax, any_hit: bool,
              stats: bool = False):
    """The plain version of K9. o, d [N,3]; tmin, tmax [N]. Returns
    dict(t [N], prim [N] i32 packed leaf index (-1 miss), uv [N,2],
    front [N] bool), plus with `stats` visits [N] i32 (nodes each ray
    visited) and tests [N] i32 (leaves whose AABB it hit, i.e. triangle
    tests)."""
    n = o.shape[0]
    dev = o.device
    invd = _safe_inv(d)
    t = tmax.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    live = torch.arange(n, device=dev)
    node = torch.zeros((n,), dtype=torch.int64, device=dev)
    while live.numel():
        g = bvh.nodes[node]                            # [L,17]
        ol, dl, il = o[live], d[live], invd[live]
        tmin_l, t_l = tmin[live], t[live]
        t0 = (g[:, 0:3] - ol) * il
        t1 = (g[:, 3:6] - ol) * il
        tn = torch.maximum(torch.amax(torch.minimum(t0, t1), dim=1), tmin_l)
        tf = torch.minimum(torch.amin(torch.maximum(t0, t1), dim=1), t_l)
        aabb_hit = tn <= tf
        pr = g[:, 6].to(torch.int32)
        is_leaf = pr >= 0
        th, u, v, det, inside = _triangle(g[:, 8:11], g[:, 11:14],
                                          g[:, 14:17], ol, dl, tmin_l)
        tri_hit = inside & (th < t_l) & is_leaf & aabb_hit
        if bvh.tri_micro is not None:
            mi = torch.clamp(omm.micro_index(u, v), 0, 15)
            st = omm.micro_state(bvh.tri_micro[torch.clamp(pr, min=0).long()],
                                 mi)
            tri_hit = tri_hit & (st != omm.MICRO_TRANSPARENT)
        won = live[tri_hit]
        t[won] = th[tri_hit]
        prim[won] = pr[tri_hit]
        uv[won] = torch.stack([u, v], dim=1)[tri_hit]
        front[won] = (det > 0.0)[tri_hit]
        if stats:
            visits[live] += 1
            tests[live] += (is_leaf & aabb_hit).to(torch.int32)
        nxt = torch.where(aabb_hit & ~is_leaf, node + 1,
                          g[:, 7].to(torch.int64))
        if any_hit:
            nxt = torch.where(tri_hit, -1, nxt)
        keep = nxt >= 0
        live, node = live[keep], nxt[keep]
    out = dict(t=t, prim=prim, uv=uv, front=front)
    if stats:
        out.update(visits=visits, tests=tests)
    return out


def _traverse_wide(bvh: ThreadedBVH, o, d, tmin, tmax, any_hit: bool,
                   stats: bool = False):
    """The plain version of K9: the walk of the 4-wide tree (bvh.wide,
    bvh.wide_tris). Returns `_traverse`'s dict; with `stats` visits [N]
    i32 (wide nodes each ray loaded) and tests [N] i32 (triangle tests).

    Per ray, a stack of (wide node, entry t) starts with the root. Each
    step pops the top; an entry beyond the limit (tmax, and after the
    first hit best_t + |best_t| x WIDE_SLACK) is dropped unvisited.
    A visit slab-tests the node's 4 child boxes against [tmin, limit], then
    tests the hit leaves' triangles in slot order: a hit replaces the best
    where th < t, or th == t and its leaf index is lower, so the winner is
    the least (t, leaf) whatever the order (the threaded walk keeps the
    earliest leaf among equal t). Then it pushes the hit inner children,
    the nearest (least entry, then slot) on top. The any-hit walk ends at
    its first accepted hit and pushes in slot order (the first slot on
    top)."""
    n = o.shape[0]
    dev = o.device
    invd = _safe_inv(d)
    t = tmax.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    uv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    front = torch.zeros((n,), dtype=torch.bool, device=dev)
    visits = torch.zeros((n,), dtype=torch.int32, device=dev)
    tests = torch.zeros((n,), dtype=torch.int32, device=dev)
    boxes = bvh.wide[:, :WIDE_REF].reshape(-1, 6, 4)
    refs = bvh.wide.view(torch.int32)[:, WIDE_REF:WIDE_REF + 4]
    depth = bvh.wide_stack
    stk_n = torch.zeros((n, depth), dtype=torch.int64, device=dev)
    stk_t = torch.full((n, depth), -float("inf"), dtype=torch.float32,
                       device=dev)
    sp = torch.ones((n,), dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    slot = torch.arange(4, device=dev)
    while live.numel():
        top = sp[live] - 1
        node, entry = stk_n[live, top], stk_t[live, top]
        sp[live] = top
        tl = t[live]
        lim = torch.where(prim[live] >= 0, tl + tl.abs() * WIDE_SLACK,
                          tmax[live])
        go = ~(entry > lim)
        v, node, lim = live[go], node[go], lim[go]
        if stats:
            visits[v] += 1
        bx = boxes[node]                                   # [V,6,4]
        ov, iv = o[v][:, :, None], invd[v][:, :, None]
        t0 = (bx[:, 0:3] - ov) * iv
        t1 = (bx[:, 3:6] - ov) * iv
        lo, hi = torch.minimum(t0, t1), torch.maximum(t0, t1)
        tn = torch.maximum(torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]),
                                         lo[:, 2]), tmin[v][:, None])
        tf = torch.minimum(torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]),
                                         hi[:, 2]), lim[:, None])
        r = refs[node]                                     # [V,4]
        hit = (tn <= tf) & (r != 0)
        done = torch.zeros((v.numel(),), dtype=torch.bool, device=dev)
        for c in range(4):
            sel = torch.nonzero(hit[:, c] & (r[:, c] < 0) & ~done)[:, 0]
            if not sel.numel():
                continue
            rays = v[sel]
            leaf = -r[sel, c] - 1
            if stats:
                tests[rays] += 1
            tri = bvh.wide_tris[leaf.long()]
            th, u, vv, det, inside = _triangle(
                tri[:, 0:3], tri[:, 4:7], tri[:, 8:11], o[rays], d[rays],
                tmin[rays])
            tb = t[rays]
            acc = inside & ((th < tb) | ((th == tb) & (leaf < prim[rays])))
            if bvh.tri_micro is not None:
                mi = torch.clamp(omm.micro_index(u, vv), 0, 15)
                st = omm.micro_state(bvh.tri_micro[leaf.long()], mi)
                acc = acc & (st != omm.MICRO_TRANSPARENT)
            won = rays[acc]
            t[won] = th[acc]
            prim[won] = leaf[acc]
            uv[won] = torch.stack([u, vv], dim=1)[acc]
            front[won] = (det > 0.0)[acc]
            if any_hit:
                done[sel[acc]] = True
        inner = hit & (r > 0) & ~done[:, None]
        if any_hit:
            sp[v[done]] = 0
        cnt = inner.sum(1)
        # nearest first; the any-hit walk in slot order
        key = torch.where(inner, slot.to(tn.dtype)[None] if any_hit else tn,
                          float("inf"))
        ahead = ((key[:, None, :] < key[:, :, None])
                 | ((key[:, None, :] == key[:, :, None])
                    & (slot[None, :] < slot[:, None])[None]))
        rank = (ahead & inner[:, None, :]).sum(2)
        pos = sp[v][:, None] + cnt[:, None] - 1 - rank
        rows = v[:, None].expand(-1, 4)
        stk_n[rows[inner], pos[inner]] = r[inner].long()
        stk_t[rows[inner], pos[inner]] = tn[inner]
        sp[v] += cnt
        live = live[sp[live] > 0]
    out = dict(t=t, prim=prim, uv=uv, front=front)
    if stats:
        out.update(visits=visits, tests=tests)
    return out


def walk(bvh: ThreadedBVH, o, d, tmin, tmax, any_hit: bool = False,
         stats: bool = False):
    """The BVH walk over rays o, d [N,3] f32, tmin, tmax [N] f32: K9
    (csrc/bvh_traverse.cu; with the BVH's micromaps its micromap test,
    counted as "bvh_traverse_omm") for CUDA tensors, `_traverse_wide` for
    CPU tensors; returns `_traverse`'s dict, with the wide walk's counts.
    Build and launch errors raise; nothing falls back."""
    if o.device.type == "cpu":
        return _traverse_wide(bvh, o, d, tmin, tmax, any_hit, stats)
    if o.device.type != "cuda":
        raise ValueError(f"traverse.walk: no kernel for device {o.device}")
    n = o.shape[0]
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    kernels.check_tensor("o", o, f32, (n, 3), dev)
    kernels.check_tensor("d", d, f32, (n, 3), dev)
    kernels.check_tensor("tmin", tmin, f32, (n,), dev)
    kernels.check_tensor("tmax", tmax, f32, (n,), dev)
    kernels.check_tensor("wide", bvh.wide, f32, (bvh.num_wide, WIDE_ROWS),
                         dev)
    kernels.check_tensor("wide_tris", bvh.wide_tris, f32,
                         (bvh.num_triangles, WIDE_TRI_ROWS), dev)
    if bvh.wide.data_ptr() % 128 or bvh.wide_tris.data_ptr() % 16:
        raise ValueError("wide nodes must be 128-byte aligned and wide_tris "
                         "16-byte aligned")
    micro = bvh.tri_micro
    if micro is not None:
        kernels.check_tensor("tri_micro", micro, i32,
                             (bvh.num_triangles,), dev)
    out = dict(t=torch.empty((n,), dtype=f32, device=dev),
               prim=torch.empty((n,), dtype=i32, device=dev),
               uv=torch.empty((n, 2), dtype=f32, device=dev),
               front=torch.empty((n,), dtype=torch.bool, device=dev))
    if stats:
        out.update(visits=torch.empty((n,), dtype=i32, device=dev),
                   tests=torch.empty((n,), dtype=i32, device=dev))
    if n > 0:
        with torch.cuda.device(dev):
            kernels.BVH_TRAVERSE.launch(
                "rtxpt_bvh_traverse", o.data_ptr(), d.data_ptr(),
                tmin.data_ptr(), tmax.data_ptr(), bvh.wide.data_ptr(),
                bvh.wide_tris.data_ptr(),
                None if micro is None else micro.data_ptr(),
                out["t"].data_ptr(), out["prim"].data_ptr(),
                out["uv"].data_ptr(), out["front"].data_ptr(),
                out["visits"].data_ptr() if stats else None,
                out["tests"].data_ptr() if stats else None,
                n, int(any_hit), torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches["bvh_traverse" if micro is None
                         else "bvh_traverse_omm"] += 1
    return out


def intersect_closest(bvh: ThreadedBVH, o, d, tmin, tmax) -> Hit:
    """Closest-hit query over a ray wavefront (scatter rays)."""
    if bvh.brute is not None:
        from rtxpt_tpu_torch.accel.brute import intersect_closest_brute
        return intersect_closest_brute(bvh.brute, o, d, tmin, tmax)
    s = walk(bvh, o, d, tmin, tmax, any_hit=False)
    prim = torch.where(s["prim"] >= 0,
                       bvh.prim_tri[torch.clamp(s["prim"], min=0).long()], -1)
    return Hit(t=s["t"], prim=prim, bary=s["uv"], front=s["front"])


def intersect_any(bvh: ThreadedBVH, o, d, tmin, tmax):
    """Visibility query: True where occluded (shadow rays)."""
    if bvh.brute is not None:
        from rtxpt_tpu_torch.accel.brute import intersect_any_brute
        return intersect_any_brute(bvh.brute, o, d, tmin, tmax)
    return walk(bvh, o, d, tmin, tmax, any_hit=True)["prim"] >= 0


def scene_closest(scene, o, d, tmin, tmax) -> Hit:
    """Closest hit against a SceneData: the TLAS walk on a two-level
    scene, the flattened BVH otherwise."""
    if getattr(scene, "tlas", None) is not None:
        from rtxpt_tpu_torch.accel.tlas import intersect_closest_tlas
        return intersect_closest_tlas(scene.tlas, o, d, tmin, tmax)
    return intersect_closest(scene.bvh, o, d, tmin, tmax)


def scene_any(scene, o, d, tmin, tmax):
    """Occlusion [N] bool against a SceneData (see scene_closest)."""
    if getattr(scene, "tlas", None) is not None:
        from rtxpt_tpu_torch.accel.tlas import intersect_any_tlas
        return intersect_any_tlas(scene.tlas, o, d, tmin, tmax)
    return intersect_any(scene.bvh, o, d, tmin, tmax)
