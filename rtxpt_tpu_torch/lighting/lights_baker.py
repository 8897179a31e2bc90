"""Lights baker (counterpart of rtxpt_tpu/lighting/lights_baker.py):
emissive triangles and analytic lights -> one polymorphic light list with
a power-proportional selection CDF. Host numpy code (the same operations
as the JAX package, so the fields agree bit for bit); the result is a
LightList of tensors. The environment light and environment quads come
with the environment slice."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from rtxpt_tpu_torch.scene.scene import (
    LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPHERE, SceneData,
)

# Polymorphic light kinds (same codes as the JAX package)
KIND_TRIANGLE = 0
KIND_POINT = 1
KIND_DIRECTIONAL = 2
KIND_SPOT = 3
KIND_ENV = 4
KIND_SPHERE = 5
KIND_ENVQUAD = 6

_LUM = np.asarray([0.2126, 0.7152, 0.0722])


@dataclass(frozen=True)
class LightList:
    kind: torch.Tensor       # [L] i32
    p0: torch.Tensor         # [L,3] tri v0 / light position
    p1: torch.Tensor         # [L,3] tri edge1 / spot direction
    p2: torch.Tensor         # [L,3] tri edge2
    emission: torch.Tensor   # [L,3]
    extra: torch.Tensor      # [L,4] tri (area, ...), spot (cos_in, cos_out)
    normal: torch.Tensor     # [L,3]
    power: torch.Tensor      # [L] normalized selection pmf
    cdf: torch.Tensor        # [L] inclusive selection CDF
    tri_light: torch.Tensor  # [T] i32 triangle -> light index (-1 none)
    env_light: int           # index of the environment light (-1 none)
    num: int

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def bake_lights(scene: SceneData, envmap, scene_radius: float,
                device="cpu") -> LightList:
    """Collect emissive triangles + analytic lights into a LightList."""
    geo = scene.geometry
    pos = _np(geo.positions)
    idx = _np(geo.indices)
    mat_id = _np(geo.tri_material)
    emissive = _np(scene.materials.emissive)

    kinds, p0s, p1s, p2s, ems, extras, normals, powers = \
        [], [], [], [], [], [], [], []
    tri_light = np.full((len(idx),), -1, np.int32)

    # --- emissive triangles ---
    tri_em = emissive[mat_id]
    lum = tri_em @ _LUM
    for t in np.nonzero(lum > 0.0)[0]:
        v0, v1, v2 = pos[idx[t, 0]], pos[idx[t, 1]], pos[idx[t, 2]]
        e1, e2 = v1 - v0, v2 - v0
        cr = np.cross(e1, e2)
        area = 0.5 * np.linalg.norm(cr)
        if area <= 1e-12:
            continue
        tri_light[t] = len(kinds)
        kinds.append(KIND_TRIANGLE)
        p0s.append(v0)
        p1s.append(e1)
        p2s.append(e2)
        ems.append(tri_em[t])
        extras.append([area, 0.0, 0.0, 0.0])
        normals.append(cr / (2.0 * area))
        powers.append(float(lum[t]) * area * np.pi)   # one-sided Lambert

    # --- analytic lights ---
    al = scene.analytic_lights
    akind = _np(al.kind)
    for i in range(len(akind)):
        k = int(akind[i])
        inten = _np(al.intensity[i])
        ilum = float(inten @ _LUM)
        if k == LIGHT_POINT:
            kinds.append(KIND_POINT)
            powers.append(4.0 * np.pi * ilum)
        elif k == LIGHT_DIRECTIONAL:
            kinds.append(KIND_DIRECTIONAL)
            powers.append(np.pi * scene_radius * scene_radius * ilum)
        elif k == LIGHT_SPHERE:
            r = float(_np(al.angular_size[i]))
            kinds.append(KIND_SPHERE)
            powers.append(4.0 * np.pi * np.pi * r * r * ilum)
        else:
            kinds.append(KIND_SPOT)
            co = float(_np(al.cos_outer[i]))
            powers.append(2.0 * np.pi * max(1.0 - co, 0.05) * ilum)
        p0s.append(_np(al.position[i]))
        p1s.append(_np(al.direction[i]))
        p2s.append(np.zeros(3))
        ems.append(inten)
        extras.append([float(_np(al.cos_inner[i])),
                       float(_np(al.cos_outer[i])),
                       float(_np(al.angular_size[i])), 0.0])
        normals.append(_np(al.direction[i]))

    mean_lum = float(np.asarray(envmap.mean_radiance) @ _LUM)
    if mean_lum > 0.0:
        raise NotImplementedError(
            "environment lights are not ported to rtxpt_tpu_torch yet")

    n = len(kinds)
    if n == 0:
        # one dummy zero-power light keeps the shapes non-empty
        kinds = [KIND_POINT]
        p0s, p1s, p2s, ems = ([np.zeros(3)] for _ in range(4))
        extras = [[0.0] * 4]
        normals = [np.asarray([0.0, 1.0, 0.0])]
        powers = [0.0]
        n = 1

    powers = np.asarray(powers, np.float64)
    total = powers.sum()
    pdf = powers / total if total > 0 else np.full(n, 1.0 / n)
    cdf = np.cumsum(pdf)
    cdf[-1] = 1.0

    def t(a, dtype=np.float32):
        return torch.as_tensor(np.asarray(a, dtype), device=device)

    return LightList(
        kind=t(kinds, np.int32), p0=t(p0s), p1=t(p1s), p2=t(p2s),
        emission=t(ems), extra=t(extras), normal=t(normals),
        power=t(pdf), cdf=t(cdf), tri_light=t(tri_light, np.int32),
        env_light=-1, num=n)
