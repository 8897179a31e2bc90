"""Procedural test scenes (counterpart of rtxpt_tpu/scene/procedural.py):
the Cornell box, the furnace box and the single triangle under one
analytic light. The other scenes come with their slices."""

from __future__ import annotations

import numpy as np
import torch

from rtxpt_tpu_torch.scene.camera import look_at
from rtxpt_tpu_torch.scene.scene import (
    LIGHT_DIRECTIONAL, LIGHT_POINT, LIGHT_SPHERE, AnalyticLights, HostScene,
    Materials, MeshInstance,
)


def _quad(p0, p1, p2, p3, mat: int):
    """Two-triangle quad with consistent winding; normal from geometry."""
    pos = np.asarray([p0, p1, p2, p3], np.float32)
    n = np.cross(pos[1] - pos[0], pos[3] - pos[0])
    n = n / np.linalg.norm(n)
    nrm = np.tile(n[None], (4, 1)).astype(np.float32)
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)
    mt = np.asarray([mat, mat], np.int32)
    return pos, nrm, uv, idx, mt


def _merge(parts):
    pos, nrm, uv, idx, mat = [], [], [], [], []
    off = 0
    for p, n, u, i, mt in parts:
        pos.append(p)
        nrm.append(n)
        uv.append(u)
        idx.append(i + off)
        mat.append(mt)
        off += len(p)
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(uv),
            np.concatenate(idx), np.concatenate(mat))


def _box(lo, hi, mat: int):
    """Axis-aligned box (outward normals)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    return _merge([
        _quad([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1], mat),
        _quad([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0], mat),
        _quad([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1], mat),
        _quad([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0], mat),
        _quad([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0], mat),
        _quad([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1], mat),
    ])


def _materials(rows) -> Materials:
    """rows: list of dicts with material fields."""
    mats = Materials.create(len(rows))

    def col(key, default):
        return torch.as_tensor(
            np.asarray([r.get(key, default) for r in rows], np.float32))

    return mats.replace(
        base_color=col("base_color", [0.5, 0.5, 0.5]),
        metallic=col("metallic", 0.0),
        roughness=col("roughness", 0.5),
        ior=col("ior", 1.5),
        transmission=col("transmission", 0.0),
        diffuse_transmission=col("diffuse_transmission", 0.0),
        emissive=col("emissive", [0.0, 0.0, 0.0]),
        thin=col("thin", 0.0),
        volume_absorption=col("volume_absorption", [0.0, 0.0, 0.0]),
        specular_f0_scale=col("specular", 0.5),
    )


def cornell_box(light_emission=(17.0, 12.0, 4.0), boxes: bool = True,
                sphere_specular: bool = False) -> HostScene:
    """The classic Cornell box in [0,1]^3 (open toward the +z camera).

    Materials: 0 white, 1 red, 2 green, 3 emissive, 4 tall box
    (optionally GGX metal)."""
    WHITE, RED, GREEN, LIGHT, TALL = 0, 1, 2, 3, 4
    parts = [
        _quad([0, 0, 1], [1, 0, 1], [1, 0, 0], [0, 0, 0], WHITE),   # floor
        _quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], WHITE),   # ceiling
        _quad([0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], WHITE),   # back
        _quad([0, 0, 1], [0, 0, 0], [0, 1, 0], [0, 1, 1], RED),     # left
        _quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], GREEN),   # right
        # area light slightly below the ceiling, emitting down (-y)
        _quad([0.35, 0.9985, 0.35], [0.65, 0.9985, 0.35],
              [0.65, 0.9985, 0.65], [0.35, 0.9985, 0.65], LIGHT),
    ]
    if boxes:
        parts.append(_box([0.12, 0.0, 0.08], [0.47, 0.60, 0.43], TALL))
        parts.append(_box([0.55, 0.0, 0.50], [0.85, 0.30, 0.80], WHITE))
    pos, nrm, uv, idx, mat = _merge(parts)

    mats = _materials([
        dict(base_color=[0.730, 0.735, 0.729], roughness=1.0),
        dict(base_color=[0.611, 0.0555, 0.062], roughness=1.0),
        dict(base_color=[0.117, 0.4125, 0.115], roughness=1.0),
        dict(base_color=[0.0, 0.0, 0.0], emissive=list(light_emission)),
        dict(base_color=[0.85, 0.85, 0.88],
             metallic=1.0 if sphere_specular else 0.0,
             roughness=0.15 if sphere_specular else 1.0),
    ])
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="cornell")],
        materials=mats)
    scene.camera = dict(position=[0.5, 0.5, 2.45], target=[0.5, 0.5, 0.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=28.0)
    return scene


def furnace_box(albedo: float = 1.0, emission: float = 0.5) -> HostScene:
    """Closed uniform box of albedo `a` and emission `e`: the radiance
    converges to e / (1 - a) everywhere."""
    pos, nrm, uv, idx, mat = _box([0, 0, 0], [1, 1, 1], 0)
    idx = idx[:, ::-1].copy()            # flip normals inward
    nrm = -nrm
    mats = _materials([
        dict(base_color=[albedo] * 3, roughness=1.0, specular=0.0,
             emissive=[emission] * 3),
    ])
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="furnace")],
        materials=mats)
    scene.camera = dict(position=[0.5, 0.5, 0.5], target=[0.5, 0.5, 0.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=60.0)
    return scene


def single_triangle(light_kind: str = "point") -> HostScene:
    """One diffuse triangle lit by one analytic light."""
    pos = np.asarray([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, 1]], np.float32), (3, 1))
    uv = np.asarray([[0, 0], [1, 0], [0.5, 1]], np.float32)
    idx = np.asarray([[0, 1, 2]], np.int32)
    mat = np.asarray([0], np.int32)
    mats = _materials([dict(base_color=[0.8, 0.6, 0.4], roughness=1.0)])

    def one(v, dtype=torch.float32):
        return torch.as_tensor(np.asarray(v, np.float32)).to(dtype)

    if light_kind == "point":
        kind, position = LIGHT_POINT, [[0.0, 0.0, 2.0]]
        intensity, size = [[10.0, 10.0, 10.0]], [0.0]
    elif light_kind == "sphere":
        r = 0.05
        radiance = 10.0 / (np.pi * r * r)
        kind, position = LIGHT_SPHERE, [[0.0, 0.0, 2.0]]
        intensity, size = [[radiance] * 3], [r]
    else:
        kind, position = LIGHT_DIRECTIONAL, [[0.0, 0.0, 0.0]]
        intensity, size = [[2.0, 2.0, 2.0]], [0.0]
    lights = AnalyticLights(
        kind=one([kind], torch.int32), position=one(position),
        direction=one([[0.0, 0.0, -1.0]]), intensity=one(intensity),
        angular_size=one(size), cos_inner=one([-2.0]),
        cos_outer=one([-2.0]))
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="tri")],
        materials=mats, analytic_lights=lights)
    scene.camera = dict(position=[0, 0, 3.0], target=[0, 0, 0],
                        up=[0, 1, 0], fov_y_deg=45.0)
    return scene


def default_camera(scene: HostScene, width: int, height: int, device="cpu"):
    c = scene.camera or dict(position=[0, 1, 3], target=[0, 0, 0],
                             up=[0, 1, 0], fov_y_deg=45.0)
    return look_at(c["position"], c["target"], c["up"], c["fov_y_deg"],
                   width, height, device=device)
