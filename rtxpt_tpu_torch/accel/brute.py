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

K8 screens each pair before the divide and resolves the pairs that pass
with the plain version's arithmetic: on the CUDA cores for tables of at
most MMA_TRIS triangles (the screen on the exact det, u and v numerators,
`screen_model`), on K1's tensor-core screen above (`brute_tile`, the
scene's split-bf16 coefficient tile of the same rows, built beside a CUDA
table of more than MMA_TRIS and at most MMA_MAX_TRIS triangles; larger ones
stay on the CUDA cores).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.accel.traverse import Hit
from rtxpt_tpu_torch.utils import math as m

# Largest scene (triangles) served by the brute force instead of the BVH
# walk, and the most (ray, triangle) pairs the plain version holds at once.
BRUTE_MAX_TRIS = 4096
_MAX_PAIRS = 1 << 22
# K8's routes: tables of more than MMA_TRIS and at most MMA_MAX_TRIS
# triangles take the tensor-core screen (K1's, whose tile holds at most
# bounce_fused.MAX_TRIS triangles), the others the CUDA-core screen
MMA_TRIS = 80
MMA_MAX_TRIS = 2048
# brute.cuh brute_screen: the slack of the exact-numerator screen (2^-20 of
# |det|) and the |det| at and above which every pair passes (2^125)
SCREEN_SLACK = 2.0 ** -20
SCREEN_HUGE = 2.0 ** 125

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
    plain version reads the same table as K8), and on a CUDA device, for
    the tables that K8's tensor-core route takes (`route`), its tile of
    them (`brute_tile`)."""

    table: torch.Tensor     # [T, TB_ROWS] f32
    tile: Optional[torch.Tensor] = None    # [TT_ROWS, T8] bf16
    scale: Optional[torch.Tensor] = None   # [T8] f32

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
    table = torch.from_numpy(table)
    tile = scale = None
    if device.type == "cuda" and _route(len(v0n)) == "mma":
        tile, scale = (x.to(device) for x in brute_tile(table))
    return BruteTris(table=table.to(device), tile=tile, scale=scale)


def tile_coefficients(table: torch.Tensor) -> torch.Tensor:
    """K1's coefficient rows [T, TC_ROWS] (bounce_fused TC_DET, TC_U,
    TC_V over the ray's [d | o x d]) of K8's rows: det = -d . n, so its
    row is -n; u = (o x d) . e2 + d . (v0 x e2): [v0 x e2 | e2]; v = -(o x
    d) . e1 - d . (v0 x e1): [-(v0 x e1) | -e1]. The t row stays zero (the
    screen reads none). Each entry is one of K8's, its sign flipped or
    not."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    t = table.detach().to("cpu", torch.float32)
    coef = torch.zeros((t.shape[0], bf.TC_ROWS), dtype=torch.float32)
    coef[:, bf.TC_DET:bf.TC_DET + 3] = -t[:, TB_N:TB_N + 3]
    coef[:, bf.TC_U:bf.TC_U + 3] = t[:, TB_V0XE2:TB_V0XE2 + 3]
    coef[:, bf.TC_U + 3:bf.TC_U + 6] = t[:, TB_E2:TB_E2 + 3]
    coef[:, bf.TC_V:bf.TC_V + 3] = -t[:, TB_V0XE1:TB_V0XE1 + 3]
    coef[:, bf.TC_V + 3:bf.TC_V + 6] = -t[:, TB_E1:TB_E1 + 3]
    return coef


def brute_tile(table: torch.Tensor):
    """(tile [TT_ROWS, T8] bf16, scale [T8] f32) on the CPU: K1's
    split-bf16 coefficient tile (bounce_fused.coefficient_tile, its error
    term and scales) of K8's rows, the operand of K8's tensor-core
    route."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    n = table.shape[0]
    coef = tile_coefficients(table)
    pad = torch.zeros((-(-n // 8) * 8 - n, coef.shape[1]))
    return bf.coefficient_tile(torch.cat([coef, pad]), n)


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


def _route(n_tris: int) -> str:
    return "mma" if MMA_TRIS < n_tris <= MMA_MAX_TRIS else "cuda-core"


def route(tris: BruteTris) -> str:
    """K8's route for the table: "mma" (the tensor-core screen) for more
    than MMA_TRIS and at most MMA_MAX_TRIS triangles, else "cuda-core"."""
    return _route(tris.num_triangles)


def screen_model(tris: BruteTris, o, d):
    """[N, T] bool: the pairs K8's CUDA-core screen passes (brute.cuh
    brute_screen), on the det, u and v numerators that `_intersect_chunk`
    computes (the kernel's, bit for bit): |det| > 1e-12 and, unless |det|
    >= SCREEN_HUGE, u_num and v_num with det's sign at or above -w and
    their sum at most |det| + w, w = SCREEN_SLACK |det|. Every pair the
    plain test accepts passes (see brute.cuh)."""
    c = tris.table.T
    oxd = m.cross(o, d)
    det = -_dot(d, c[TB_N:TB_N + 3])
    u_num = _dot(oxd, c[TB_E2:TB_E2 + 3]) + _dot(d, c[TB_V0XE2:TB_V0XE2 + 3])
    v_num = -_dot(oxd, c[TB_E1:TB_E1 + 3]) - _dot(d, c[TB_V0XE1:TB_V0XE1 + 3])
    absd = torch.abs(det)
    w = absd * SCREEN_SLACK
    su = torch.where(det < 0.0, -u_num, u_num)
    sv = torch.where(det < 0.0, -v_num, v_num)
    return (absd > 1e-12) & ((absd >= SCREEN_HUGE) | (
        (su >= -w) & (sv >= -w) & (su + sv <= absd + w)))


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
    tile = scale = None
    t8 = 0
    if route(tris) == "mma":
        if tris.tile is None:
            raise ValueError("brute.closest: the table has no tensor-core "
                             "tile")
        t8 = tris.tile.shape[1]
        kernels.check_tensor("tile", tris.tile, torch.bfloat16,
                             (tris.tile.shape[0], t8), dev)
        kernels.check_tensor("scale", tris.scale, f32, (t8,), dev)
        tile, scale = tris.tile.data_ptr(), tris.scale.data_ptr()
    out = dict(t=torch.empty((n,), dtype=f32, device=dev),
               prim=torch.empty((n,), dtype=torch.int32, device=dev),
               uv=torch.empty((n, 2), dtype=f32, device=dev),
               front=torch.empty((n,), dtype=torch.bool, device=dev))
    if n > 0:
        with torch.cuda.device(dev):
            kernels.BRUTE_CLOSEST.launch(
                "rtxpt_brute_closest", o.data_ptr(), d.data_ptr(),
                tmin.data_ptr(), tmax.data_ptr(), tris.table.data_ptr(),
                tile, scale, t8, out["t"].data_ptr(), out["prim"].data_ptr(),
                out["uv"].data_ptr(), out["front"].data_ptr(), n, n_tris,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches["brute_closest"] += 1
    return out


def screen_stats(device, enable: bool) -> dict:
    """Read and zero K8's screen counters on `device` and set whether later
    launches count (off by default; counting runs the counting
    instantiations, which also test every rejected pair exactly). Counts
    since the last call: `pairs` screened (each live ray's n_tris), `passed`
    (the CUDA-core route's pairs, or the tensor-core route's over its tile,
    padding included) and `missed`, pairs the plain test accepts that the
    screen rejected (it must stay 0); `share` = passed / pairs (None
    without pairs). Synchronous."""
    from rtxpt_tpu_torch.pt import bounce_fused as bf
    out = (ctypes.c_ulonglong * len(bf.SCREEN_COUNTS))()   # K1's slots
    with torch.cuda.device(device):
        kernels.BRUTE_CLOSEST.launch("rtxpt_brute_closest_screen_stats",
                                     int(enable), out)
    total = {k: int(v) for k, v in zip(bf.SCREEN_COUNTS, out)}
    return dict(pairs=total["pairs"], passed=total["passed"],
                missed=total["missed"],
                share=total["passed"] / total["pairs"] if total["pairs"]
                else None)


def intersect_closest_brute(tris: BruteTris, o, d, tmin, tmax) -> Hit:
    s = closest(tris, o, d, tmin, tmax)
    return Hit(t=s["t"], prim=s["prim"], bary=s["uv"], front=s["front"])


def intersect_any_brute(tris: BruteTris, o, d, tmin, tmax):
    """Occlusion [N] bool: a closest hit within (tmin, tmax), as the JAX
    package computes it."""
    return ~intersect_closest_brute(tris, o, d, tmin, tmax).miss
