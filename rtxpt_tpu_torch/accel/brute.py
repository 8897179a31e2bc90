"""Brute-force ray/triangle closest hit (counterpart of
rtxpt_tpu/accel/brute.py): the factored Möller-Trumbore test over every
(ray, triangle) pair, for scenes of at most BRUTE_MAX_TRIS triangles.

Every Möller-Trumbore quantity is bilinear in per-ray and per-triangle
vectors:

    det   = -d . n                          (n = e1 x e2)
    u_num = (o x d) . e2 + d . (v0 x e2)
    v_num = -(o x d) . e1 - d . (v0 x e1)
    t_num = o . n - v0 . n

so the per-triangle operands are e1, e2, n, v0 x e2, v0 x e1 and v0 . n
(`BruteTris`). A pair is a hit when |det| > 1e-12, u >= 0, v >= 0,
u + v <= 1 and tmin < t < tmax; each ray keeps its nearest hit, ties going
to the lowest triangle index. This form rounds differently from the direct
test of the BVH walk (accel/traverse.py).

`closest` runs the CUDA kernel K8 (csrc/brute_closest.cu) on CUDA tensors
and the plain version `_intersect_chunk` on CPU tensors. Both read
`BruteTris.table`, one 16-float row per triangle, and sum every dot
product as (x + y) + z, so they round alike. The JAX package's
[128, 4*Tpad] operand table exists for the TPU's matrix unit.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel.traverse import Hit
from rtxpt_tpu_torch.utils import math as m

# Largest scene (triangles) served by the brute force instead of the BVH
# walk, and the most (ray, triangle) pairs the plain version holds at once.
BRUTE_MAX_TRIS = 4096
_MAX_PAIRS = 1 << 22

# K8's per-triangle rows (BruteTris.table [T, TB_ROWS])
TB_N = 0          # 0:3 n = e1 x e2
TB_E2 = 3         # 3:6
TB_V0XE2 = 6      # 6:9
TB_E1 = 9         # 9:12
TB_V0XE1 = 12     # 12:15
TB_V0N = 15       # v0 . n
TB_ROWS = 16      # 64-byte rows


@dataclass(frozen=True)
class BruteTris:
    """The per-triangle operands, one TB_ROWS-float row per triangle (the
    plain version reads the same table as K8)."""

    table: torch.Tensor     # [T, TB_ROWS] f32

    @property
    def num_triangles(self) -> int:
        return self.table.shape[0]


# the JAX package's BruteTris fields ([3,T], and v0n [T]) by table column
FIELDS = (("n_t", TB_N), ("e2_t", TB_E2), ("v0xe2_t", TB_V0XE2),
          ("e1_t", TB_E1), ("v0xe1_t", TB_V0XE1))


def brute_from_fields(fields: dict, device="cuda") -> BruteTris:
    """BruteTris on `device` (the GPU by default; raises without one) from
    numpy arrays e1_t, e2_t, n_t, v0xe2_t, v0xe1_t [3,T] and v0n [T] (the
    JAX package's BruteTris fields)."""
    import rtxpt_tpu_torch

    device = rtxpt_tpu_torch.device(device)
    v0n = np.asarray(fields["v0n"], np.float32)
    table = np.zeros((len(v0n), TB_ROWS), np.float32)
    for key, col in FIELDS:
        table[:, col:col + 3] = np.asarray(fields[key], np.float32).T
    table[:, TB_V0N] = v0n
    return BruteTris(table=torch.from_numpy(table).to(device))


def brute_from_edges(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     device="cuda") -> BruteTris:
    """Operands from host triangles (the JAX package's numpy operations, so
    the numbers are its numbers)."""
    n = np.cross(e1, e2)
    return brute_from_fields(dict(
        e1_t=e1.T, e2_t=e2.T, n_t=n.T, v0xe2_t=np.cross(v0, e2).T,
        v0xe1_t=np.cross(v0, e1).T, v0n=np.einsum("tj,tj->t", v0, n)),
        device)


def build_brute(positions, indices, device="cuda") -> BruteTris:
    """BruteTris of triangles (host arrays) on `device` (the GPU by
    default; raises without one)."""
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int32)
    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    return brute_from_edges(v0, v1 - v0, v2 - v0, device)


def _dot(a, b_t):
    """[N,3] . [3,T] -> [N,T], summed as (x + y) + z (K8's order)."""
    return a[:, 0:1] * b_t[0] + a[:, 1:2] * b_t[1] + a[:, 2:3] * b_t[2]


def _intersect_chunk(tris: BruteTris, o, d, tmin, tmax):
    """The plain version of K8 over rays o, d [N,3], tmin, tmax [N]:
    dict(t [N] (tmax on a miss), prim [N] i32 (-1), uv [N,2], front [N])."""
    c = tris.table.T                                   # [TB_ROWS, T]
    n, e1, e2 = c[TB_N:TB_N + 3], c[TB_E1:TB_E1 + 3], c[TB_E2:TB_E2 + 3]
    oxd = m.cross(o, d)
    det = -_dot(d, n)
    u_num = _dot(oxd, e2) + _dot(d, c[TB_V0XE2:TB_V0XE2 + 3])
    v_num = -_dot(oxd, e1) - _dot(d, c[TB_V0XE1:TB_V0XE1 + 3])
    t_num = _dot(o, n) - c[TB_V0N][None, :]
    ok_det = torch.abs(det) > 1e-12
    inv = torch.where(ok_det, 1.0 / torch.where(ok_det, det, 1.0), 0.0)
    u = u_num * inv
    v = v_num * inv
    t = t_num * inv
    valid = (ok_det & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
             & (t > tmin[:, None]) & (t < tmax[:, None]))
    t_m = torch.where(valid, t, torch.inf)
    t_best = torch.amin(t_m, dim=1)
    hit = torch.isfinite(t_best)
    n_t = t_m.shape[1]
    iota = torch.arange(n_t, device=o.device)[None, :]
    j = torch.amin(torch.where(t_m <= t_best[:, None], iota, n_t), dim=1)
    jc = torch.clamp(j, max=n_t - 1)[:, None]

    def pick(x):
        return torch.gather(x, 1, jc)[:, 0]

    zero = torch.zeros_like(t_best)
    return dict(
        t=torch.where(hit, t_best, tmax),
        prim=torch.where(hit, j, -1).to(torch.int32),
        uv=torch.stack([torch.where(hit, pick(u), zero),
                        torch.where(hit, pick(v), zero)], dim=-1),
        front=hit & (pick(det) > 0.0))


def _closest_plain(tris: BruteTris, o, d, tmin, tmax):
    n = o.shape[0]
    chunk = max(min(n, _MAX_PAIRS // max(tris.num_triangles, 1)), 1)
    parts = [_intersect_chunk(tris, o[lo:lo + chunk], d[lo:lo + chunk],
                              tmin[lo:lo + chunk], tmax[lo:lo + chunk])
             for lo in range(0, n, chunk)]
    if len(parts) == 1:
        return parts[0]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def closest(tris: BruteTris, o, d, tmin, tmax):
    """Closest hit over rays o, d [N,3] f32, tmin, tmax [N] f32: K8
    (csrc/brute_closest.cu) for CUDA tensors, the plain version for CPU
    tensors. Returns dict(t, prim, uv, front) as `_intersect_chunk`. Build
    and launch errors raise; nothing falls back."""
    if o.device.type == "cpu":
        return _closest_plain(tris, o, d, tmin, tmax)
    if o.device.type != "cuda":
        raise ValueError(f"brute.closest: no kernel for device {o.device}")
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    kernels.check_tensor("o", o, f32, (n, 3), dev)
    kernels.check_tensor("d", d, f32, (n, 3), dev)
    kernels.check_tensor("tmin", tmin, f32, (n,), dev)
    kernels.check_tensor("tmax", tmax, f32, (n,), dev)
    n_tris = tris.num_triangles
    kernels.check_tensor("table", tris.table, f32, (n_tris, TB_ROWS), dev)
    if n_tris == 0:
        raise ValueError("brute.closest: an empty triangle table")
    out = dict(t=torch.empty((n,), dtype=f32, device=dev),
               prim=torch.empty((n,), dtype=torch.int32, device=dev),
               uv=torch.empty((n, 2), dtype=f32, device=dev),
               front=torch.empty((n,), dtype=torch.bool, device=dev))
    if n > 0:
        with torch.cuda.device(dev):
            kernels.BRUTE_CLOSEST.launch(
                "rtxpt_brute_closest", o.data_ptr(), d.data_ptr(),
                tmin.data_ptr(), tmax.data_ptr(), tris.table.data_ptr(),
                out["t"].data_ptr(), out["prim"].data_ptr(),
                out["uv"].data_ptr(), out["front"].data_ptr(), n, n_tris,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches["brute_closest"] += 1
    return out


def intersect_closest_brute(tris: BruteTris, o, d, tmin, tmax) -> Hit:
    s = closest(tris, o, d, tmin, tmax)
    return Hit(t=s["t"], prim=s["prim"], bary=s["uv"], front=s["front"])


def intersect_any_brute(tris: BruteTris, o, d, tmin, tmax):
    """Occlusion [N] bool: a closest hit within (tmin, tmax), as the JAX
    package computes it."""
    return ~intersect_closest_brute(tris, o, d, tmin, tmax).miss
