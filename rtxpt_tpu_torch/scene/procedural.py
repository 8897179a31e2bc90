"""Procedural test scenes (counterpart of rtxpt_tpu/scene/procedural.py):
the Cornell box, the furnace box, the single triangle under one analytic
light, the many-light rooms, the large-scene city (also textured,
normal-mapped and sky-lit), the textured Cornell box and the kitchen, with
their procedural textures (checker, wood, ripple normal map), and the
curtain Cornell box of the JAX package's alpha tests with the foliage
texture `leaf_texture`, and the 'Bistro' stress scene `bistro_scene`
(textures, a normal map, alpha-tested foliage, glass with nested
priorities and 160 bulbs). The other scenes come with their slices.

Two instanced scenes have no counterpart in the JAX package's module: they
are the constructions of its instancing tests, `instanced_boxes`
(tests/test_tlas.py `_instanced_scene`) and `instanced_city`
(tests/test_cluster_instanced.py `_instanced_city`), array for array.
Neither has `overlap_boxes`: the nested-priority tests' overlapping media
(tests/test_nested_priority.py `_overlap_scene`, and with `wall` its
subdivided form of tests/test_cluster_omm.py `_overlap_scene_big`), nor
`overlap_curtain`: those media with an alpha-tested curtain, on whose
tables every texture, micromap and priority switch of K1 and K4 has
work."""

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


def _quad_grid(p0, p1, p2, p3, nx: int, ny: int, mat: int):
    """Subdivided quad (2*nx*ny triangles), bilinear interpolation of the
    corners; normal from geometry (planar quads assumed)."""
    p0, p1, p2, p3 = (np.asarray(p, np.float32) for p in (p0, p1, p2, p3))
    us = np.linspace(0.0, 1.0, nx + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, ny + 1, dtype=np.float32)
    uu, vv = np.meshgrid(us, vs, indexing="ij")        # [nx+1, ny+1]
    pos = ((1 - uu)[..., None] * (1 - vv)[..., None] * p0
           + uu[..., None] * (1 - vv)[..., None] * p1
           + uu[..., None] * vv[..., None] * p2
           + (1 - uu)[..., None] * vv[..., None] * p3)
    pos = pos.reshape(-1, 3)
    n = np.cross(p1 - p0, p3 - p0)
    n = n / max(np.linalg.norm(n), 1e-12)
    nrm = np.tile(n[None], (len(pos), 1)).astype(np.float32)
    uvc = np.stack([uu, vv], axis=-1).reshape(-1, 2).astype(np.float32)
    i0 = (np.arange(nx)[:, None] * (ny + 1) + np.arange(ny)[None, :])
    i0 = i0.reshape(-1)
    a, b, c, d = i0, i0 + (ny + 1), i0 + (ny + 1) + 1, i0 + 1
    idx = np.concatenate([np.stack([a, b, c], -1),
                          np.stack([a, c, d], -1)]).astype(np.int32)
    mt = np.full((len(idx),), mat, np.int32)
    return pos, nrm, uvc, idx, mt


def _box_grid(lo, hi, s: int, mat: int):
    """Axis-aligned box with each face subdivided s x s (12*s^2 tris)."""
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    g = _quad_grid
    return _merge([
        g([x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1], s, s, mat),
        g([x1, y0, z0], [x0, y0, z0], [x0, y1, z0], [x1, y1, z0], s, s, mat),
        g([x1, y0, z1], [x1, y0, z0], [x1, y1, z0], [x1, y1, z1], s, s, mat),
        g([x0, y0, z0], [x0, y0, z1], [x0, y1, z1], [x0, y1, z0], s, s, mat),
        g([x0, y1, z1], [x1, y1, z1], [x1, y1, z0], [x0, y1, z0], s, s, mat),
        g([x0, y0, z0], [x1, y0, z0], [x1, y0, z1], [x0, y0, z1], s, s, mat),
    ])


def rooms_scene(n_rooms: int = 12, subdiv: int = 2) -> HostScene:
    """Occlusion-heavy many-light scene: a row of n_rooms closed cells, each
    lit only by its own emissive ceiling panel (two triangles of a
    material of its own), behind full-height divider walls; the front of
    every room is open toward the camera. Each image tile sees one panel
    while the power pmf spreads samples over all of them: the workload
    that NEE-AT's per-tile adaptation exists for. 2 * n_rooms lights;
    26 * n_rooms + 8 * (n_rooms + 1) triangles at subdiv 2."""
    WALL, FLOOR, PANEL0 = 0, 1, 2
    Wr, H, D = 2.0, 2.4, 3.0
    g = _quad_grid
    s = subdiv
    parts = []
    for r in range(n_rooms):
        x0, x1 = r * Wr, (r + 1) * Wr
        parts += [
            # floor (+y) / ceiling (-y)
            g([x0, 0, D], [x1, 0, D], [x1, 0, 0], [x0, 0, 0], s, s, FLOOR),
            g([x0, H, 0], [x1, H, 0], [x1, H, D], [x0, H, D], s, s, WALL),
            # back wall only: the front stays open
            g([x0, 0, 0], [x1, 0, 0], [x1, H, 0], [x0, H, 0], s, s, WALL),
            # the room's emissive panel
            g([x0 + 0.5, H - 0.05, 1.0], [x1 - 0.5, H - 0.05, 1.0],
              [x1 - 0.5, H - 0.05, 2.0], [x0 + 0.5, H - 0.05, 2.0],
              1, 1, PANEL0 + r),
        ]
    # divider walls, the two ends included (full height: rooms are closed)
    for r in range(n_rooms + 1):
        x = r * Wr
        parts.append(g([x, 0, 0], [x, 0, D], [x, H, D], [x, H, 0],
                       s, s, WALL))
    pos, nrm, uv, idx, mat = _merge(parts)
    mdefs = [dict(base_color=[0.75, 0.74, 0.72], roughness=1.0),
             dict(base_color=[0.6, 0.62, 0.66], roughness=0.9)]
    rng = np.random.default_rng(5)
    for r in range(n_rooms):
        tint = 0.6 + 0.4 * rng.random(3)
        mdefs.append(dict(base_color=[0, 0, 0],
                          emissive=(18.0 * tint).tolist()))
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="rooms")],
        materials=_materials(mdefs))
    # frontal view through the open side: every room interior visible
    cx = n_rooms * Wr * 0.5
    scene.camera = dict(position=[cx, H * 0.55, D + n_rooms * Wr * 0.42],
                        target=[cx, H * 0.45, 0.0],
                        up=[0, 1, 0], fov_y_deg=46.0)
    return scene


def city_scene(tri_budget: int = 350_000, seed: int = 0,
               blocks: int = 8, textured: bool = False,
               with_env: bool = False,
               normal_mapped: bool = False) -> HostScene:
    """The large-scene city: a blocks x blocks grid of subdivided tower
    boxes on a subdivided ground plane, lit by 24 emissive street panels
    and a directional sun. Deterministic in (tri_budget, seed, blocks);
    the triangle count lands within ~5% of tri_budget (339,888 at the
    default 350,000). `textured` gives the ground and two facade
    families checker base-colour textures, `normal_mapped` gives the ground
    the ripple normal map, `with_env` adds the JAX package's sky (a
    128 x 64 make_sky at half scale)."""
    rng = np.random.default_rng(seed)
    nb = blocks * blocks
    # tris: ground 2*g^2 + nb * 12*s^2 + lights; solve s for the budget.
    g = 24
    s = max(1, int(np.sqrt(max(tri_budget - 2 * g * g, 12) / (12 * nb))))
    GROUND, EMISSIVE, GLASS = 0, 5, 6
    palette = [1, 2, 3, 4]
    parts = [_quad_grid([0, 0, 0], [blocks * 10.0, 0, 0],
                        [blocks * 10.0, 0, blocks * 10.0],
                        [0, 0, blocks * 10.0], g, g, GROUND)]
    for bi in range(blocks):
        for bj in range(blocks):
            cx = bi * 10.0 + 5.0
            cz = bj * 10.0 + 5.0
            w = rng.uniform(2.5, 4.0)
            dpt = rng.uniform(2.5, 4.0)
            h = rng.uniform(4.0, 22.0)
            mat = palette[int(rng.integers(0, len(palette)))]
            if rng.uniform() < 0.12:
                mat = GLASS
            parts.append(_box_grid([cx - w, 0.0, cz - dpt],
                                   [cx + w, h, cz + dpt], s, mat))
    # Street lamps: single-quad emissive panels, one light per triangle
    # (under the 128-light table).
    lamps = min(24, nb)
    for k in range(lamps):
        bi = (k * 7) % blocks
        bj = (k * 3 + 1) % blocks
        cx = bi * 10.0 + 1.2
        cz = bj * 10.0 + 1.2
        y = 4.5
        parts.append(_quad([cx - 0.6, y, cz - 0.6], [cx + 0.6, y, cz - 0.6],
                           [cx + 0.6, y, cz + 0.6], [cx - 0.6, y, cz + 0.6],
                           EMISSIVE))
    pos, nrm, uv, idx, mat = _merge(parts)

    mats = _materials([
        dict(base_color=[0.45, 0.43, 0.40], roughness=0.9),     # ground
        dict(base_color=[0.65, 0.55, 0.45], roughness=0.8),
        dict(base_color=[0.55, 0.60, 0.65], roughness=0.5),
        dict(base_color=[0.70, 0.35, 0.25], roughness=0.85),
        dict(base_color=[0.75, 0.75, 0.78], metallic=1.0, roughness=0.25),
        dict(base_color=[0.0, 0.0, 0.0], emissive=[400.0, 340.0, 220.0]),
        dict(base_color=[0.9, 0.95, 1.0], roughness=0.05,
             transmission=1.0, ior=1.5),                        # glass
    ])
    # Late-afternoon sun: a delta directional light.
    sun_d = np.asarray([0.45, -0.72, 0.3], np.float32)
    sun_d /= np.linalg.norm(sun_d)

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32))

    sun = AnalyticLights(
        kind=torch.as_tensor([LIGHT_DIRECTIONAL], dtype=torch.int32),
        position=torch.zeros((1, 3)), direction=f32(sun_d[None]),
        intensity=f32([[3.0, 2.7, 2.2]]), angular_size=torch.zeros((1,)),
        cos_inner=torch.full((1,), -2.0), cos_outer=torch.full((1,), -2.0))
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="city")],
        materials=mats, analytic_lights=sun)
    if textured:
        scene.textures = [
            checker_texture(64, (0.95, 0.92, 0.88), (0.55, 0.52, 0.5)),
            checker_texture(64, (0.85, 0.88, 0.95), (0.35, 0.4, 0.5),
                            cells=16),
        ]
        bt = np.full((7,), -1, np.int32)
        bt[0] = 0                       # ground
        bt[1] = 1                       # facade family 1
        bt[3] = 1
        scene.materials = scene.materials.replace(
            base_color_tex=torch.as_tensor(bt))
    if normal_mapped:
        scene.textures = (scene.textures or []) + [
            ripple_normal_texture(64)]
        nt = np.full((7,), -1, np.int32)
        nt[0] = len(scene.textures) - 1   # bumpy ground
        scene.materials = scene.materials.replace(
            normal_tex=torch.as_tensor(nt))
    if with_env:
        from rtxpt_tpu_torch.lighting.sky import make_sky
        scene.envmap_image = make_sky(
            128, 64, sun_dir=(0.45, 0.72, -0.3), sun_intensity=40.0,
            bake_sun=True)
        scene.envmap_scale = 0.5
    c = blocks * 5.0
    scene.camera = dict(position=[c - 18.0, 6.0, c + 26.0],
                        target=[c, 4.0, c],
                        up=[0.0, 1.0, 0.0], fov_y_deg=55.0)
    return scene


def ripple_normal_texture(n: int = 64, amp: float = 0.6,
                          waves: int = 4) -> np.ndarray:
    """[n,n,4] tangent-space ripple normal map, ((n_ts)+1)/2 encoded: a
    deterministic bump pattern."""
    yy, xx = np.meshgrid(np.linspace(0, 1, n, endpoint=False),
                         np.linspace(0, 1, n, endpoint=False),
                         indexing="ij")
    dzdx = amp * np.cos(2.0 * np.pi * waves * xx)
    dzdy = amp * np.sin(2.0 * np.pi * waves * yy)
    v = np.stack([-dzdx, -dzdy, np.ones_like(dzdx)], axis=-1)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    img = np.empty((n, n, 4), np.float32)
    img[..., :3] = (v + 1.0) * 0.5
    img[..., 3] = 1.0
    return img


def checker_texture(n: int = 64, c0=(0.9, 0.9, 0.9), c1=(0.25, 0.25, 0.3),
                    cells: int = 8) -> np.ndarray:
    """[n,n,4] checkerboard (a power-of-two n: the kernels' texture path
    takes power-of-two sizes, for exact MIP halving)."""
    yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    m = ((xx * cells // n + yy * cells // n) % 2).astype(np.float32)
    img = np.empty((n, n, 4), np.float32)
    img[..., :3] = (np.asarray(c0, np.float32)[None, None] * (1 - m[..., None])
                    + np.asarray(c1, np.float32)[None, None] * m[..., None])
    img[..., 3] = 1.0
    return img


def wood_texture(n: int = 64, base=(0.45, 0.30, 0.17),
                 dark=(0.30, 0.18, 0.09), rings: int = 10) -> np.ndarray:
    """[n,n,4] deterministic wood-like ring texture (power-of-two n)."""
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    r = np.sqrt((xx - 0.3) ** 2 + 4.0 * (yy - 0.5) ** 2)
    w = 0.5 + 0.5 * np.sin(2 * np.pi * rings * r
                           + 2.0 * np.sin(6.0 * xx))
    img = np.empty((n, n, 4), np.float32)
    img[..., :3] = (np.asarray(base, np.float32)[None, None]
                    * (1 - w[..., None])
                    + np.asarray(dark, np.float32)[None, None]
                    * w[..., None])
    img[..., 3] = 1.0
    return img


def textured_cornell(with_env: bool = True, with_mr: bool = False,
                     with_normal: bool = False,
                     light_emission=(17.0, 12.0, 4.0)) -> HostScene:
    """The Cornell box with a checker base-colour texture on the white
    material, optionally a metal-rough texture on the tall box
    (`with_mr`), the ripple normal map on the white material
    (`with_normal`) and the procedural sky (`with_env`)."""
    host = cornell_box(light_emission=light_emission)
    host.textures = [checker_texture(64),
                     checker_texture(32, (0.8, 0.8, 0.8), (0.4, 0.4, 0.4),
                                     cells=4)]
    bt = np.full((len(host.materials.base_color),), -1, np.int32)
    bt[0] = 0                   # white walls and box get the checker
    host.materials = host.materials.replace(
        base_color_tex=torch.as_tensor(bt))
    if with_mr:
        mr = np.full_like(bt, -1)
        mr[4] = 1
        host.materials = host.materials.replace(
            metal_rough_tex=torch.as_tensor(mr))
    if with_normal:
        host.textures = host.textures + [ripple_normal_texture(64)]
        nt = np.full_like(bt, -1)
        nt[0] = len(host.textures) - 1      # bumpy white walls and box
        host.materials = host.materials.replace(
            normal_tex=torch.as_tensor(nt))
    if with_env:
        from rtxpt_tpu_torch.lighting.sky import make_sky
        host.envmap_image = make_sky(128, 64, sun_dir=(0.4, 0.5, 0.3),
                                     sun_intensity=30.0, bake_sun=True)
        host.envmap_scale = 0.4
    return host


def kitchen_scene(panel_grid: int = 16, subdiv: int = 3,
                  with_env: bool = True) -> HostScene:
    """A kitchen-class interior: a closed room with a window opening,
    textured floor (checker) and counters (wood), mixed materials
    (diffuse, metal, glass, ceramic) and a panel_grid^2 grid of emissive
    ceiling panels (2 panel_grid^2 emissive triangles, 512 at the default
    16: a many-light scene). 1,186 triangles at the defaults.

    Materials: 0 wall, 1 floor (checker), 2 counter (wood), 3 metal,
    4 glass, 5 panel (emissive), 6 ceramic, 7 dark accent."""
    WALL, FLOOR, WOOD, METAL, GLASS, PANEL, CERAMIC, DARK = range(8)
    W, H, D = 6.0, 3.0, 6.0
    s = subdiv
    g = _quad_grid
    parts = [
        # floor (+y normal), subdivided
        g([0, 0, D], [W, 0, D], [W, 0, 0], [0, 0, 0], 4 * s, 4 * s, FLOOR),
        # ceiling (-y)
        g([0, H, 0], [W, H, 0], [W, H, D], [0, H, D], 2 * s, 2 * s, WALL),
        # back wall (+z normal, at z=0)
        g([0, 0, 0], [W, 0, 0], [W, H, 0], [0, H, 0], 2 * s, s, WALL),
        # front wall (-z, at z=D)
        g([W, 0, D], [0, 0, D], [0, H, D], [W, H, D], 2 * s, s, WALL),
        # right wall (-x, at x=W)
        g([W, 0, 0], [W, 0, D], [W, H, D], [W, H, 0], 2 * s, s, WALL),
    ]
    # left wall (x=0) with a window opening [z 2..4, y 1..2.2]: four quads
    # around the hole, through which the environment enters
    z0, z1, y0, y1 = 2.0, 4.0, 1.0, 2.2
    parts += [
        g([0, 0, D], [0, 0, 0], [0, y0, 0], [0, y0, D], 2 * s, 1, WALL),
        g([0, y1, D], [0, y1, 0], [0, H, 0], [0, H, D], 2 * s, 1, WALL),
        g([0, y0, z0], [0, y0, 0], [0, y1, 0], [0, y1, z0], s, 1, WALL),
        g([0, y0, D], [0, y0, z1], [0, y1, z1], [0, y1, D], s, 1, WALL),
    ]
    # emissive ceiling panels, slightly below the ceiling, emitting down
    m = panel_grid
    px0, pz0, pw = 0.8, 0.8, (W - 1.6)
    cell = pw / m
    for i in range(m):
        for j in range(m):
            x = px0 + i * cell
            z = pz0 + j * cell
            e = 0.22 * cell
            parts.append(_quad([x + e, H - 0.02, z + e],
                               [x + cell - e, H - 0.02, z + e],
                               [x + cell - e, H - 0.02, z + cell - e],
                               [x + e, H - 0.02, z + cell - e], PANEL))
    # counters along the back and right walls: wood tops, dark bases
    parts += [
        _box([0.2, 0.0, 0.2], [W - 0.2, 0.85, 0.85], DARK),
        g([0.2, 0.86, 0.85], [W - 0.2, 0.86, 0.85],
          [W - 0.2, 0.86, 0.2], [0.2, 0.86, 0.2], 4, 2, WOOD),
        _box([W - 0.85, 0.0, 0.85], [W - 0.2, 0.85, D - 1.2], DARK),
        g([W - 0.85, 0.86, D - 1.2], [W - 0.2, 0.86, D - 1.2],
          [W - 0.2, 0.86, 0.85], [W - 0.85, 0.86, 0.85], 2, 4, WOOD),
    ]
    # fridge (metal), table (wood top, metal legs), glass splash panel,
    # ceramic pots
    parts += [
        _box([0.25, 0.0, D - 1.5], [1.15, 2.0, D - 0.6], METAL),
        g([2.2, 1.05, 4.2], [3.8, 1.05, 4.2],
          [3.8, 1.05, 2.8], [2.2, 1.05, 2.8], 3, 3, WOOD),
        _box([2.25, 0.0, 2.85], [2.4, 1.03, 3.0], METAL),
        _box([3.6, 0.0, 2.85], [3.75, 1.03, 3.0], METAL),
        _box([2.25, 0.0, 4.0], [2.4, 1.03, 4.15], METAL),
        _box([3.6, 0.0, 4.0], [3.75, 1.03, 4.15], METAL),
        _box([1.7, 0.86, 0.25], [2.9, 1.75, 0.33], GLASS),
        _box([4.6, 0.86, 0.4], [4.95, 1.25, 0.75], CERAMIC),
        _box([5.1, 0.86, 0.45], [5.35, 1.1, 0.7], CERAMIC),
    ]
    pos, nrm, uv, idx, mat = _merge(parts)

    mats = _materials([
        dict(base_color=[0.78, 0.77, 0.74], roughness=1.0),
        dict(base_color=[1.0, 1.0, 1.0], roughness=0.8),
        dict(base_color=[1.0, 1.0, 1.0], roughness=0.55),
        dict(base_color=[0.9, 0.9, 0.92], metallic=1.0, roughness=0.25),
        dict(base_color=[1.0, 1.0, 1.0], transmission=1.0, roughness=0.0,
             ior=1.5, thin=1.0),
        dict(base_color=[0.0, 0.0, 0.0], emissive=[22.0, 20.0, 17.0]),
        dict(base_color=[0.92, 0.90, 0.86], roughness=0.12),
        dict(base_color=[0.13, 0.12, 0.12], roughness=0.6),
    ])
    scene = HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="kitchen")],
        materials=mats)
    scene.textures = [checker_texture(64, (0.92, 0.92, 0.9),
                                      (0.2, 0.22, 0.26), cells=12),
                      wood_texture(64)]
    bt = np.full((8,), -1, np.int32)
    bt[FLOOR] = 0
    bt[WOOD] = 1
    scene.materials = scene.materials.replace(
        base_color_tex=torch.as_tensor(bt))
    if with_env:
        from rtxpt_tpu_torch.lighting.sky import make_sky
        scene.envmap_image = make_sky(
            128, 64, sun_dir=(-0.6, 0.5, 0.4), sun_intensity=60.0,
            bake_sun=True)
        scene.envmap_scale = 1.0
    scene.camera = dict(position=[4.9, 1.7, 5.3], target=[2.2, 1.1, 1.8],
                        up=[0.0, 1.0, 0.0], fov_y_deg=55.0)
    return scene


def leaf_texture(n: int = 64, seed: int = 3) -> np.ndarray:
    """[n,n,4] alpha-tested leaf-cluster card texture: green blobs on a
    transparent background (alpha 0 / 1 around the 0.5 cutoff)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    a = np.zeros((n, n), np.float32)
    col = np.zeros((n, n, 3), np.float32)
    for _ in range(26):
        cxy = rng.uniform(0.12, 0.88, 2)
        rr = rng.uniform(0.05, 0.14)
        el = rng.uniform(0.6, 1.6)
        d2 = ((xx - cxy[0]) / rr) ** 2 + ((yy - cxy[1]) / (rr * el)) ** 2
        inside = d2 < 1.0
        a[inside] = 1.0
        g = rng.uniform(0.25, 0.55)
        col[inside] = [0.08 + 0.2 * g, 0.3 + g * 0.5, 0.06 + 0.12 * g]
    return np.concatenate([col, a[..., None]], axis=-1).astype(np.float32)


def _alpha_checker(n: int, cutout: bool) -> np.ndarray:
    """[n,n,4] dark curtain texture; with `cutout` its alpha is a
    one-texel checkerboard (0 / 1), else opaque."""
    tex = np.ones((n, n, 4), np.float32)
    tex[..., :3] = 0.2
    if cutout:
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        tex[..., 3] = ((yy + xx) % 2).astype(np.float32)
    return tex


CURTAIN = 5      # the curtain's material in curtain_cornell


def curtain_cornell(cutout: bool = True, grid: int = 0, texture=None,
                    tex_n: int = 64) -> HostScene:
    """The Cornell box without its boxes and with a screen-filling curtain
    in front of the back wall, alpha-tested (cutoff 0.5, thin, material
    CURTAIN) against its base-colour texture: the JAX package's alpha
    tests' scenes. grid 0: the curtain is one quad with an 8 x 8
    checkerboard alpha (tests/test_omm_alpha.py `_alpha_scene`); grid > 0:
    a grid x grid quad grid with a tex_n x tex_n checkerboard
    (tests/test_cluster_omm.py `_alpha_scene_big` at grid 40), or with
    `texture` (e.g. `leaf_texture(64)`: a foliage card)."""
    host = cornell_box(boxes=False)
    corners = ([0.02, 0.02, 0.5], [0.98, 0.02, 0.5], [0.98, 0.98, 0.5],
               [0.02, 0.98, 0.5])
    if grid:
        pos, nrm, uv, idx, mat = _quad_grid(*corners, grid, grid, CURTAIN)
    else:
        pos, nrm, uv, idx, mat = _quad(*corners, CURTAIN)
    host.instances.append(MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                       indices=idx, material=mat,
                                       name="curtain"))
    if texture is None:
        texture = _alpha_checker(tex_n if grid else 8, cutout)
    host.textures = [texture]
    old = host.materials
    mats = Materials.create(CURTAIN + 1)
    n_old = old.base_color.shape[0]
    mats = mats.replace(**{
        f: torch.cat([getattr(old, f), getattr(mats, f)[n_old:]])
        for f in ("base_color", "metallic", "roughness", "ior",
                  "transmission", "diffuse_transmission", "emissive",
                  "specular_f0_scale", "thin", "alpha_cutoff",
                  "volume_absorption", "base_color_tex", "emissive_tex",
                  "metal_rough_tex", "normal_tex")})

    def put(field, value):
        arr = getattr(mats, field).clone()
        arr[CURTAIN] = torch.as_tensor(value, dtype=arr.dtype)
        return arr

    host.materials = mats.replace(
        base_color=put("base_color", [0.9, 0.9, 0.9]),
        roughness=put("roughness", 1.0),
        alpha_cutoff=put("alpha_cutoff", 0.5),
        base_color_tex=put("base_color_tex", 0),
        thin=put("thin", 1.0))
    return host


def _instance_xform(tx, ty, tz, scale=1.0, yaw=0.0):
    """Object -> world [4,4]: a yaw about +y, a uniform scale, a shift."""
    c, s = np.cos(yaw), np.sin(yaw)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]],
                         np.float32) * scale
    m[:3, 3] = [tx, ty, tz]
    return m


def _point_light(position, intensity) -> AnalyticLights:
    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32))

    return AnalyticLights(
        kind=torch.as_tensor([LIGHT_POINT], dtype=torch.int32),
        position=f32([position]), direction=f32([[0.0, -1.0, 0.0]]),
        intensity=f32([intensity]), angular_size=torch.zeros((1,)),
        cos_inner=torch.ones((1,)) * -2.0, cos_outer=torch.ones((1,)) * -2.0)


def _box_mesh(size=0.4):
    """A 12-triangle box with vertex normals averaged over its faces."""
    s = size
    v = np.array([[-s, -s, -s], [s, -s, -s], [s, s, -s], [-s, s, -s],
                  [-s, -s, s], [s, -s, s], [s, s, s], [-s, s, s]],
                 np.float32)
    f = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                  [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                  [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]], np.int32)
    n = np.zeros_like(v)
    for tri in f:
        n[tri] += np.cross(v[tri[1]] - v[tri[0]], v[tri[2]] - v[tri[0]])
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-9)
    return v, n, np.zeros((len(v), 2), np.float32), f


def instanced_boxes(grid: int = 3, force: bool = True) -> HostScene:
    """grid x grid boxes sharing one prototype (mesh_key "box"), a floor
    and an emissive panel (one instance each), and a point light: the
    two-level scene of tests/test_tlas.py. 12 grid^2 + 4 world triangles,
    so the prepared scene has no cluster tables and renders through the
    TLAS walk."""
    v, n, uv, f = _box_mesh()
    mats = Materials.create(3).replace(
        base_color=torch.tensor([[0.7, 0.3, 0.3], [0.6, 0.6, 0.6],
                                 [0.9, 0.9, 0.9]]),
        roughness=torch.tensor([0.4, 0.8, 0.5]),
        emissive=torch.tensor([[0.0, 0, 0], [0, 0, 0], [4, 4, 4]]))
    insts = []
    rng = np.random.default_rng(7)
    for i in range(grid):
        for j in range(grid):
            insts.append(MeshInstance(
                positions=v, normals=n, uvs=uv, indices=f,
                material=np.zeros((len(f),), np.int32),
                transform=_instance_xform(
                    i * 1.2 - grid * 0.6, 0.4, j * 1.2 - grid * 0.6,
                    scale=0.6 + 0.3 * rng.random(),
                    yaw=float(rng.random()) * 2.0),
                mesh_key="box"))
    fv = np.array([[-4, 0, -4], [4, 0, -4], [4, 0, 4], [-4, 0, 4]],
                  np.float32)
    ff = np.array([[0, 2, 1], [0, 3, 2]], np.int32)
    fn = np.tile(np.array([[0, 1, 0]], np.float32), (4, 1))
    insts.append(MeshInstance(
        positions=fv, normals=fn, uvs=np.zeros((4, 2), np.float32),
        indices=ff, material=np.ones((2,), np.int32)))
    ev = fv * 0.25 + np.array([[0, 3.0, 0]], np.float32)
    insts.append(MeshInstance(
        positions=ev, normals=-fn, uvs=np.zeros((4, 2), np.float32),
        indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material=np.full((2,), 2, np.int32)))
    return HostScene(instances=insts, materials=mats,
                     analytic_lights=_point_light([0.0, 2.5, 0.0],
                                                  [20.0, 20.0, 18.0]),
                     force_instancing=force)


def instanced_city(grid: int = 3, subdiv: int = 6) -> HostScene:
    """grid x grid towers (12 subdiv^2 triangles each) sharing one
    prototype (mesh_key "tower") on a floor box, lit by one point light
    and no emissive triangle: the scene of tests/test_cluster_instanced.py
    for grid <= 3. A wider grid widens the floor to span it and raises
    the light to the floor's half extent, its intensity scaled with the
    square of the height, so the grid stays lit. grid 8, subdiv 21 holds
    338,688 tower triangles in one 5,292-triangle prototype."""
    pos, nrm, uv, idx, _ = _box_grid([-0.4, 0.0, -0.4], [0.4, 1.6, 0.4],
                                     subdiv, 0)
    mats = Materials.create(2).replace(
        base_color=torch.tensor([[0.7, 0.4, 0.3], [0.6, 0.6, 0.65]]),
        roughness=torch.tensor([0.5, 0.9]))
    rng = np.random.default_rng(11)
    insts = []
    for i in range(grid):
        for j in range(grid):
            insts.append(MeshInstance(
                positions=pos, normals=nrm, uvs=uv, indices=idx,
                material=np.zeros((len(idx),), np.int32),
                transform=_instance_xform(
                    i * 1.6 - grid * 0.8, 0.0, j * 1.6 - grid * 0.8,
                    scale=0.7 + 0.5 * rng.random(),
                    yaw=float(rng.random()) * 2.0),
                mesh_key="tower"))
    half = max(4.0, 0.8 * grid + 1.6)
    fpos, fnrm, fuv, fidx, _ = _box_grid([-half, -0.2, -half],
                                         [half, 0.0, half], 10, 1)
    insts.append(MeshInstance(
        positions=fpos, normals=fnrm, uvs=fuv, indices=fidx,
        material=np.ones((len(fidx),), np.int32)))
    gain = (half / 4.0) ** 2
    return HostScene(
        instances=insts, materials=mats,
        analytic_lights=_point_light([0.0, half, 1.0],
                                     [40.0 * gain, 38.0 * gain, 35.0 * gain]),
        force_instancing=True)


def city_overview(scene: HostScene, height: float = 30.0) -> HostScene:
    """The city with its camera raised to `height`, above the roofs (the
    towers reach 22). city_scene's own camera, the JAX package's, stands
    at height 6 inside the tower of block (2, 6) at seed 0 and the default
    8 blocks: every camera ray ends on an inner wall, and the image is
    black in both packages."""
    p = scene.camera["position"]
    scene.camera = dict(scene.camera, position=[p[0], height, p[2]])
    return scene


def default_camera(scene: HostScene, width: int, height: int, device="cpu"):
    c = scene.camera or dict(position=[0, 1, 3], target=[0, 0, 0],
                             up=[0, 1, 0], fov_y_deg=45.0)
    return look_at(c["position"], c["target"], c["up"], c["fov_y_deg"],
                   width, height, device=device)


def overlap_boxes(priorities, wall: bool = False) -> HostScene:
    """Two overlapping absorbing media in front of an emissive panel: water
    (material 0, box [0, 1] in x, sigma_a OVERLAP_SW) and glass (material
    1, box [0.4, 1.2], sigma_a OVERLAP_SG), both transmissive with IoR 1
    and no specular reflection, so a ray along +x stays straight, and the
    panel (material 2) at x = 2 with radiance OVERLAP_E; `priorities` are
    the materials' nested priorities. The radiance that reaches a camera
    at (-1, 0, 0) looking down +x encodes which medium absorbed each
    segment. With `wall`, a black 40 x 40 quad grid (material 3) off to
    the +y side pushes the triangle count past the fused tier's 2048."""
    parts = [
        _box([0.0, -1.0, -1.0], [1.0, 1.0, 1.0], 0),        # water
        _box([0.4, -0.9, -0.9], [1.2, 0.9, 0.9], 1),        # glass
        _quad([2.0, -1, -1], [2.0, -1, 1], [2.0, 1, 1], [2.0, 1, -1], 2),
    ]
    if wall:
        parts.append(_quad_grid([-3.0, 5.0, -3.0], [4.0, 5.0, -3.0],
                                [4.0, 5.0, 3.0], [-3.0, 5.0, 3.0], 40, 40, 3))
    pos, nrm, uv, idx, mat = _merge(parts)
    m = 4 if wall else 3

    def f32(v):
        return torch.as_tensor(np.asarray(v, np.float32)[:m])

    sw, sg, e = OVERLAP_SW, OVERLAP_SG, OVERLAP_E
    mats = Materials.create(m).replace(
        transmission=f32([1.0, 1.0, 0.0, 0.0]),
        ior=f32([1.0, 1.0, 1.5, 1.5]),
        roughness=f32([0.0, 0.0, 0.0, 1.0]),
        specular_f0_scale=f32([0.0] * 4),
        base_color=f32([[1.0] * 3, [1.0] * 3, [0.0] * 3, [0.0] * 3]),
        emissive=f32([[0.0] * 3, [0.0] * 3, [e] * 3, [0.0] * 3]),
        volume_absorption=f32([[sw] * 3, [sg] * 3, [0.0] * 3, [0.0] * 3]),
        nested_priority=torch.as_tensor(np.asarray(priorities, np.int32)))
    return HostScene(
        instances=[MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                indices=idx, material=mat, name="nest")],
        materials=mats)


def glass_mirror_cornell() -> HostScene:
    """The Cornell box with the tall box (material 4) smooth glass and the
    short box (material 3) a smooth mirror: the JAX package's
    glass-over-mirror stable-planes scene (tests/test_stable_planes.py
    :120-127), whose BUILD pass yields planes 1 and 2."""
    host = cornell_box()
    mats = host.materials
    trans, rough, metal = (mats.transmission.clone(), mats.roughness.clone(),
                           mats.metallic.clone())
    trans[4] = 1.0
    rough[4] = 0.0
    rough[3] = 0.0
    metal[3] = 1.0
    host.materials = mats.replace(transmission=trans, roughness=rough,
                                  metallic=metal)
    return host


def overlap_curtain(priorities, wall: bool = False) -> HostScene:
    """`overlap_boxes` with an alpha-tested curtain across the view of
    OVERLAP_INSIDE_CAMERAS: a quad in the plane y = OVERLAP_CURTAIN_Y
    (x in [-0.2, 1.4], z in [0.3, 0.95]) of the last material, textured
    with curtain_cornell's 8 x 8 alpha checkerboard (cutoff 0.5, thin).
    Its tables take the texture, micromap and priority switches at once:
    rays of the inside cameras meet priority false hits on the boxes and
    alpha-tested hits on the curtain. `priorities` are overlap_boxes'."""
    host = overlap_boxes(priorities, wall)
    old = host.materials
    m = old.base_color.shape[0]
    mats = Materials.create(m + 1)
    mats = mats.replace(**{
        f: torch.cat([getattr(old, f), getattr(mats, f)[m:]])
        for f in mats.__dataclass_fields__})

    def put(field, value):
        arr = getattr(mats, field).clone()
        arr[m] = torch.as_tensor(value, dtype=arr.dtype)
        return arr

    host.materials = mats.replace(
        base_color=put("base_color", [0.9, 0.9, 0.9]),
        roughness=put("roughness", 1.0),
        alpha_cutoff=put("alpha_cutoff", 0.5),
        base_color_tex=put("base_color_tex", 0),
        thin=put("thin", 1.0))
    y = OVERLAP_CURTAIN_Y
    pos, nrm, uv, idx, mat = _quad([-0.2, y, 0.3], [1.4, y, 0.3],
                                   [1.4, y, 0.95], [-0.2, y, 0.95], m)
    host.instances.append(MeshInstance(positions=pos, normals=nrm, uvs=uv,
                                       indices=idx, material=mat,
                                       name="curtain"))
    host.textures = [_alpha_checker(8, True)]
    return host


OVERLAP_SW = 0.9     # overlap_boxes: the water's sigma_a
OVERLAP_SG = 0.4     # the glass's sigma_a
OVERLAP_E = 5.0      # the panel's radiance
OVERLAP_CURTAIN_Y = 0.5   # overlap_curtain: the curtain's plane
# Two cameras inside overlap_boxes whose rays meet false hits from their
# first bounce on: (position, target, up, fov_y_deg, the medium the rays
# start in). Inside the water box with the rays in air, the water's inner
# walls are false exits and the glass's front real entries; inside the
# glass beyond the water with the rays in the glass, the water's outer
# face is a false entry, which the interior list records.
OVERLAP_INSIDE_CAMERAS = (
    ([0.2, 0.0, 0.0], [0.5, 1.0, 0.3], [0.0, 0.0, 1.0], 90.0, -1),
    ([1.1, 0.0, 0.0], [0.0, 0.6, 0.3], [0.0, 1.0, 0.0], 120.0, 1))


def _cylinder(center, r: float, h: float, seg: int, mat: int,
              cap: bool = True, vsub: int = 1):
    """Open / capped cylinder: seg side quads (x vsub vertical) + top fan."""
    cx, cy, cz = center
    ang = np.linspace(0.0, 2.0 * np.pi, seg + 1, dtype=np.float32)
    parts = []
    ys = np.linspace(0.0, h, vsub + 1, dtype=np.float32)
    for i in range(seg):
        x0, z0 = cx + r * np.cos(ang[i]), cz + r * np.sin(ang[i])
        x1, z1 = cx + r * np.cos(ang[i + 1]), cz + r * np.sin(ang[i + 1])
        for j in range(vsub):
            parts.append(_quad([x0, cy + ys[j], z0], [x1, cy + ys[j], z1],
                               [x1, cy + ys[j + 1], z1],
                               [x0, cy + ys[j + 1], z0], mat))
    if cap:
        for i in range(seg):
            x0, z0 = cx + r * np.cos(ang[i]), cz + r * np.sin(ang[i])
            x1, z1 = cx + r * np.cos(ang[i + 1]), cz + r * np.sin(ang[i + 1])
            p = np.asarray([[cx, cy + h, cz], [x1, cy + h, z1],
                            [x0, cy + h, z0], [cx, cy + h, cz]], np.float32)
            n = np.tile(np.asarray([[0, 1, 0]], np.float32), (4, 1))
            u = np.asarray([[0.5, 0.5], [1, 0], [0, 0], [0.5, 0.5]],
                           np.float32)
            parts.append((p, n, u, np.asarray([[0, 1, 2]], np.int32),
                          np.asarray([mat], np.int32)))
    return _merge(parts)


# bistro_scene's material ids
BISTRO_GROUND, BISTRO_FACADE_A, BISTRO_FACADE_B, BISTRO_AWNING = 0, 1, 2, 3
BISTRO_WOOD, BISTRO_TRUNK, BISTRO_FOLIAGE, BISTRO_GLASS = 4, 5, 6, 7
BISTRO_BULB, BISTRO_METAL, BISTRO_SIGN = 8, 9, 10


def bistro_scene(tri_budget: int = 600_000, seed: int = 0,
                 n_bulbs: int = 160, with_env: bool = False,
                 alpha_foliage: bool = True) -> HostScene:
    """The 'Bistro' stress scene (rtxpt_tpu/scene/procedural.py
    bistro_scene, BASELINE.json's 1080p target), a street-corner plaza:
    two facade rows of subdivided buildings (the bulk of the budget),
    cobbled ground with a base-colour texture and a normal map, tables,
    chairs and lamp posts, glass bottles with volume absorption and nested
    priority 1, eight trees whose crowns are alpha-tested foliage cards,
    `n_bulbs` emissive string-light bulbs (more than 128 lights with the
    sun: NEE takes the external route) and a directional sun.
    Deterministic in (tri_budget, seed): the same generator calls as the
    JAX package's, so the host arrays are equal. The triangle count lands
    within ~10% of tri_budget for budgets >= 100k."""
    rng = np.random.default_rng(seed)
    g = _quad_grid
    W, D = 44.0, 30.0                         # plaza extent (x, z)
    parts = []                                # static merged geometry

    # ---- ground (textured + normal-mapped cobbles) ----
    gg = 40
    parts.append(g([0, 0, 0], [W, 0, 0], [W, 0, D], [0, 0, D],
                   gg, gg, BISTRO_GROUND))

    # ---- furniture: round tables + chairs + bottles ----
    for k in range(14):
        tx = rng.uniform(8.0, W - 4.0)
        tz = rng.uniform(8.0, D - 4.0)
        parts.append(_cylinder([tx, 0.68, tz], 0.55, 0.05, 20,
                               BISTRO_WOOD))              # top
        parts.append(_cylinder([tx, 0.0, tz], 0.06, 0.68, 10,
                               BISTRO_METAL, cap=False))  # pedestal
        for c in range(3):
            a = rng.uniform(0, 2 * np.pi)
            cx2, cz2 = tx + 1.0 * np.cos(a), tz + 1.0 * np.sin(a)
            parts.append(_box([cx2 - 0.22, 0.0, cz2 - 0.22],
                              [cx2 + 0.22, 0.45, cz2 + 0.22], BISTRO_WOOD))
        # glass bottle: slim octagonal prism (volume + nested priority)
        parts.append(_cylinder([tx + 0.15, 0.73, tz], 0.05, 0.28, 8,
                               BISTRO_GLASS))

    # ---- lamp posts ----
    for k in range(4):
        lx = 6.0 + k * (W - 10.0) / 3.0
        parts.append(_cylinder([lx, 0.0, D * 0.6], 0.08, 4.2, 8,
                               BISTRO_METAL, cap=False, vsub=2))

    # ---- string lights: emissive bulbs on catenaries between posts ----
    for k in range(max(n_bulbs, 0)):
        tpar = (k % 40) / 39.0
        row = k // 40
        x = 4.0 + tpar * (W - 8.0)
        sag = 0.6 * np.sin(np.pi * tpar)
        y = 4.4 - sag
        z = 4.0 + row * (D - 8.0) / max((n_bulbs + 39) // 40 - 1, 1)
        b = 0.055
        parts.append(_quad([x - b, y, z - b], [x + b, y, z - b],
                           [x + b, y, z + b], [x - b, y, z + b],
                           BISTRO_BULB))

    # ---- facade rows (bulk of the triangle budget) ----
    lots = []
    for x0 in np.arange(2.0, W - 6.0, 7.0):
        lots.append((x0, 0.0))                # back row (z = 0 side)
    for z0 in np.arange(6.0, D - 6.0, 7.5):
        lots.append((0.0, z0))                # left row (x = 0 side)
    # the facade subdivision from the remaining budget (awnings are 36
    # triangles per lot; the trees and the sign below ~410)
    n_now = sum(len(p[3]) for p in parts)
    rem = max(tri_budget - n_now - 36 * len(lots) - 410, 12 * len(lots))
    s = max(2, int(round(np.sqrt(rem / (12 * len(lots))))))
    for i, (x0, z0) in enumerate(lots):
        if z0 == 0.0:
            lo = [x0, 0.0, 0.0]
            hi = [x0 + rng.uniform(5.0, 6.4), rng.uniform(7.0, 14.0),
                  rng.uniform(3.5, 5.0)]
        else:
            lo = [0.0, 0.0, z0]
            hi = [rng.uniform(3.5, 5.0), rng.uniform(7.0, 14.0),
                  z0 + rng.uniform(5.0, 6.8)]
        mat = BISTRO_FACADE_A if i % 2 == 0 else BISTRO_FACADE_B
        parts.append(_box_grid(lo, hi, s, mat))
        # awning over the ground floor
        ax0, ax1 = lo[0] + 0.2, hi[0] + 1.4
        az = hi[2] + 0.02 if z0 == 0.0 else lo[2] + 0.2
        if z0 == 0.0:
            parts.append(g([ax0, 3.4, az], [ax1 - 1.4, 3.4, az],
                           [ax1 - 1.4, 2.7, az + 1.8], [ax0, 2.7, az + 1.8],
                           6, 3, BISTRO_AWNING))
        else:
            parts.append(g([hi[0] + 0.02, 3.4, lo[2] + 0.2],
                           [hi[0] + 0.02, 3.4, hi[2] - 0.2],
                           [hi[0] + 1.8, 2.7, hi[2] - 0.2],
                           [hi[0] + 1.8, 2.7, lo[2] + 0.2],
                           6, 3, BISTRO_AWNING))

    pos, nrm, uv, idx, mat = _merge(parts)
    instances = [MeshInstance(positions=pos, normals=nrm, uvs=uv,
                              indices=idx, material=mat, name="bistro")]

    # ---- trees: a trunk and a crown of foliage cards each ----
    fol_mat = BISTRO_FOLIAGE if alpha_foliage else BISTRO_TRUNK
    for k in range(8):
        txp = 7.0 + (k % 4) * (W - 12.0) / 3.0
        tzp = 10.0 + (k // 4) * (D - 16.0) / 1.0 * 0.45
        tp, tn, tu, ti, tm = _cylinder([txp, 0.0, tzp], 0.22, 2.6, 10,
                                       BISTRO_TRUNK, cap=False, vsub=2)
        instances.append(MeshInstance(positions=tp, normals=tn, uvs=tu,
                                      indices=ti, material=tm,
                                      name=f"trunk_{k}"))
        crown = []
        for q in range(5):
            a = q * np.pi / 5.0
            cdir = np.asarray([np.cos(a), 0.0, np.sin(a)], np.float32)
            c0 = -1.6 * cdir + [0, 2.2, 0]
            c1 = 1.6 * cdir + [0, 2.2, 0]
            c2 = 1.6 * cdir + [0, 5.2, 0]
            c3 = -1.6 * cdir + [0, 5.2, 0]
            crown.append(_quad(c0, c1, c2, c3, fol_mat))
        cp, cn, cu, ci, cm = _merge(crown)
        tf = np.eye(4, dtype=np.float32)
        tf[:3, 3] = [txp, 0.0, tzp]
        instances.append(MeshInstance(positions=cp, normals=cn, uvs=cu,
                                      indices=ci, material=cm, transform=tf,
                                      name=f"foliage_{k}"))

    # ---- hanging sign ----
    sp, sn, su, si, sm = _quad([-0.7, -0.5, 0.0], [0.7, -0.5, 0.0],
                               [0.7, 0.5, 0.0], [-0.7, 0.5, 0.0],
                               BISTRO_SIGN)
    tf = np.eye(4, dtype=np.float32)
    tf[:3, 3] = [W * 0.35, 3.2, 4.3]
    instances.append(MeshInstance(positions=sp, normals=sn, uvs=su,
                                  indices=si, material=sm, transform=tf,
                                  name="sign"))

    mats = _materials([
        dict(base_color=[0.52, 0.50, 0.47], roughness=0.85),  # ground
        dict(base_color=[0.72, 0.62, 0.50], roughness=0.8),   # facade A
        dict(base_color=[0.58, 0.62, 0.68], roughness=0.6),   # facade B
        dict(base_color=[0.70, 0.25, 0.22], roughness=0.7),   # awning
        dict(base_color=[0.45, 0.30, 0.17], roughness=0.6),   # wood
        dict(base_color=[0.32, 0.22, 0.14], roughness=0.9),   # trunk
        dict(base_color=[0.25, 0.45, 0.15], roughness=0.9,
             thin=1.0),                                       # foliage
        dict(base_color=[0.9, 0.95, 0.9], roughness=0.02,
             transmission=1.0, ior=1.5,
             volume_absorption=[0.6, 0.1, 0.5]),              # glass
        dict(base_color=[0.0, 0.0, 0.0],
             emissive=[420.0, 330.0, 180.0]),                 # bulbs
        dict(base_color=[0.6, 0.6, 0.62], metallic=1.0,
             roughness=0.35),                                 # metal
        dict(base_color=[0.85, 0.8, 0.6], roughness=0.5),     # sign
    ])
    textures = [
        checker_texture(64, (0.62, 0.60, 0.56), (0.40, 0.38, 0.36),
                        cells=16),                            # 0 cobbles
        checker_texture(64, (0.9, 0.85, 0.75), (0.6, 0.5, 0.4), cells=8),
        wood_texture(64),                                     # 2 wood
        leaf_texture(64),                                     # 3 leaves
        ripple_normal_texture(64, amp=0.5, waves=8),          # 4 cobble nm
    ]
    bt = np.full((11,), -1, np.int32)
    bt[BISTRO_GROUND] = 0
    bt[BISTRO_FACADE_A] = 1
    bt[BISTRO_WOOD] = 2
    if alpha_foliage:
        bt[BISTRO_FOLIAGE] = 3
    nt = np.full((11,), -1, np.int32)
    nt[BISTRO_GROUND] = 4
    ac = np.full((11,), -1.0, np.float32)
    if alpha_foliage:
        ac[BISTRO_FOLIAGE] = 0.5
    npri = np.zeros((11,), np.int32)
    npri[BISTRO_GLASS] = 1
    mats = mats.replace(base_color_tex=torch.as_tensor(bt),
                        normal_tex=torch.as_tensor(nt),
                        alpha_cutoff=torch.as_tensor(ac),
                        nested_priority=torch.as_tensor(npri))

    sun_d = np.asarray([0.35, -0.8, 0.49], np.float32)
    sun_d /= np.linalg.norm(sun_d)
    sun = AnalyticLights(
        kind=torch.as_tensor([LIGHT_DIRECTIONAL], dtype=torch.int32),
        position=torch.zeros((1, 3)),
        direction=torch.as_tensor(sun_d[None]),
        intensity=torch.as_tensor([[2.4, 2.2, 1.9]]),
        angular_size=torch.zeros((1,)),
        cos_inner=torch.full((1,), -2.0),
        cos_outer=torch.full((1,), -2.0))
    scene = HostScene(instances=instances, materials=mats,
                      textures=textures, analytic_lights=sun)
    if with_env:
        from rtxpt_tpu_torch.lighting.sky import make_sky
        scene.envmap_image = make_sky(128, 64, sun_dir=(0.35, 0.8, -0.49),
                                      sun_intensity=26.0, bake_sun=True)
        scene.envmap_scale = 0.6
    scene.camera = dict(position=[W - 4.0, 3.2, D - 2.5],
                        target=[W * 0.3, 2.2, 6.0],
                        up=[0.0, 1.0, 0.0], fov_y_deg=55.0)
    return scene
