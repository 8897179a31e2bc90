"""BVH walk and the scene's ray queries (counterpart of
rtxpt_tpu/accel/traverse.py).

`walk` runs the CUDA kernel K9 (csrc/bvh_traverse.cu) on CUDA tensors and
the plain version `_traverse` on CPU tensors. Each ray walks the threaded
BVH (accel/bvh.py) in skip-link order to the end: at each node a slab test
against the AABB, and at a leaf whose AABB it hit the Möller-Trumbore test
of the leaf triangle (|det| > 1e-9, tmin < t < the best t so far); it
descends to node + 1 on an internal hit and follows the miss link
otherwise. The any-hit variant stops at its first hit. A BVH with
opacity micromaps (`tri_micro`, the words in leaf order) rejects a hit
whose micro-triangle is TRANSPARENT inside the walk
(rtxpt_tpu/accel/traverse.py:113-121); the other states are the alpha
retrace's (scene/omm.py).

The plain version advances every live ray one node per step and drops the
finished rays between steps; the result of each ray is the same as a walk
of its own. min and max propagate NaN (as jnp.minimum and torch.minimum
do), so a ray with NaN components ends as in the JAX package.

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
from rtxpt_tpu_torch.accel.bvh import NODE_ROWS, ThreadedBVH
from rtxpt_tpu_torch.scene import omm

_INVD_MAX = 1e30
_TRI_EPS = 1e-9


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
        v0, e1, e2 = g[:, 8:11], g[:, 11:14], g[:, 14:17]
        pvec = _cross(dl, e2)
        det = _dot3(e1, pvec)
        ok_det = torch.abs(det) > _TRI_EPS
        inv_det = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0),
                              0.0)
        tvec = ol - v0
        u = _dot3(tvec, pvec) * inv_det
        qvec = _cross(tvec, e1)
        v = _dot3(dl, qvec) * inv_det
        th = _dot3(e2, qvec) * inv_det
        tri_hit = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                   & (th > tmin_l) & (th < t_l) & is_leaf & aabb_hit)
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


def walk(bvh: ThreadedBVH, o, d, tmin, tmax, any_hit: bool = False,
         stats: bool = False):
    """The BVH walk over rays o, d [N,3] f32, tmin, tmax [N] f32: K9
    (csrc/bvh_traverse.cu; with the BVH's micromaps its micromap test,
    counted as "bvh_traverse_omm") for CUDA tensors, `_traverse` for CPU
    tensors; returns `_traverse`'s dict. Build and launch errors raise;
    nothing falls back."""
    if o.device.type == "cpu":
        return _traverse(bvh, o, d, tmin, tmax, any_hit, stats)
    if o.device.type != "cuda":
        raise ValueError(f"traverse.walk: no kernel for device {o.device}")
    n = o.shape[0]
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    kernels.check_tensor("o", o, f32, (n, 3), dev)
    kernels.check_tensor("d", d, f32, (n, 3), dev)
    kernels.check_tensor("tmin", tmin, f32, (n,), dev)
    kernels.check_tensor("tmax", tmax, f32, (n,), dev)
    kernels.check_tensor("nodes", bvh.nodes, f32, (bvh.num_nodes, NODE_ROWS),
                         dev)
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
                tmin.data_ptr(), tmax.data_ptr(), bvh.nodes.data_ptr(),
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
