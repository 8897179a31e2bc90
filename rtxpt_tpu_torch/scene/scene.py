"""Scene representation (counterpart of rtxpt_tpu/scene/scene.py):
material, geometry and analytic-light tables, the host scene and its
world-space flatten, the device SceneData and its per-triangle and
per-material gather tables (`build_packs`). Instances that share a
`mesh_key` are one prototype of the two-level BVH (accel/tlas.py).

Tables are frozen dataclasses of tensors. Host scenes hold CPU tensors;
`prepare` moves what the renderer reads to the target device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

# Analytic light kinds (same codes as rtxpt_tpu/scene/scene.py)
LIGHT_POINT = 0
LIGHT_DIRECTIONAL = 1
LIGHT_SPOT = 2
LIGHT_SPHERE = 3


def _tensor(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@dataclass(frozen=True)
class Materials:
    """Material table, SoA over material index [M] (fields as in the JAX
    package's Materials)."""

    base_color: torch.Tensor        # [M,3]
    metallic: torch.Tensor          # [M]
    roughness: torch.Tensor         # [M] perceptual (alpha = r^2)
    ior: torch.Tensor               # [M]
    transmission: torch.Tensor      # [M]
    diffuse_transmission: torch.Tensor
    emissive: torch.Tensor          # [M,3]
    specular_f0_scale: torch.Tensor  # [M]
    thin: torch.Tensor              # [M]
    alpha_cutoff: torch.Tensor      # [M] <0 = opaque
    volume_absorption: torch.Tensor  # [M,3]
    base_color_tex: torch.Tensor    # [M] texture id or -1
    emissive_tex: torch.Tensor
    metal_rough_tex: torch.Tensor
    normal_tex: torch.Tensor
    nested_priority: torch.Tensor   # [M] i32
    anisotropy: torch.Tensor        # [M]

    @staticmethod
    def create(n: int) -> "Materials":
        def z(*s):
            return torch.zeros((n, *s), dtype=torch.float32)

        def full(v):
            return torch.full((n,), v, dtype=torch.float32)

        def no_tex():
            return torch.full((n,), -1, dtype=torch.int32)

        return Materials(
            base_color=torch.full((n, 3), 0.5), metallic=z(),
            roughness=full(0.5), ior=full(1.5), transmission=z(),
            diffuse_transmission=z(), emissive=z(3),
            specular_f0_scale=full(0.5), thin=z(), alpha_cutoff=full(-1.0),
            volume_absorption=z(3), base_color_tex=no_tex(),
            emissive_tex=no_tex(), metal_rough_tex=no_tex(),
            normal_tex=no_tex(),
            nested_priority=torch.zeros((n,), dtype=torch.int32),
            anisotropy=z())

    def replace(self, **kw) -> "Materials":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "Materials":
        """Every field on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class Geometry:
    """World-space flattened triangle soup [V vertices, T triangles]."""

    positions: torch.Tensor       # [V,3] f32
    normals: torch.Tensor         # [V,3] f32
    uvs: torch.Tensor             # [V,2] f32
    indices: torch.Tensor         # [T,3] i32
    tri_material: torch.Tensor    # [T] i32
    tri_subinstance: torch.Tensor  # [T] i32

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]

    def to(self, device) -> "Geometry":
        """Every field on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


@dataclass(frozen=True)
class AnalyticLights:
    """Analytic light SoA [L] (point / directional / spot / sphere)."""

    kind: torch.Tensor        # [L] i32
    position: torch.Tensor    # [L,3]
    direction: torch.Tensor   # [L,3]
    intensity: torch.Tensor   # [L,3]
    angular_size: torch.Tensor  # [L]
    cos_inner: torch.Tensor   # [L]
    cos_outer: torch.Tensor   # [L]

    @staticmethod
    def empty() -> "AnalyticLights":
        def z(*s):
            return torch.zeros((0, *s), dtype=torch.float32)
        return AnalyticLights(kind=torch.zeros((0,), dtype=torch.int32),
                              position=z(3), direction=z(3),
                              intensity=z(3), angular_size=z(),
                              cos_inner=z(), cos_outer=z())


@dataclass(frozen=True)
class SceneData:
    """What the renderer reads, on the render device: `bvh`
    (accel/bvh.py) with `tri_pack` and `mat_pack` (`build_packs`) for the
    general wavefront tier; `bounce_tables` (pt/bounce_fused.py) or, for a
    scene above 2048 triangles, `cluster_tables` (accel/cluster.py); and
    `lights` (lighting/lights_baker.py)."""

    geometry: Optional[Geometry]
    materials: Optional[Materials]
    analytic_lights: Optional[AnalyticLights]
    lights: Optional[object] = None          # lights_baker.LightList
    envmap: Optional[object] = None          # envmap.EnvMap
    bounce_tables: Optional[object] = None   # bounce_fused.BounceTables
    cluster_tables: Optional[object] = None  # cluster.ClusterTables
    bvh: Optional[object] = None             # bvh.ThreadedBVH
    # [T,25] v0v1v2|n0n1n2|uv012|mat (object space on a two-level scene)
    tri_pack: Optional[torch.Tensor] = None
    mat_pack: Optional[torch.Tensor] = None  # [M,18] material scalars
    textures: Optional[object] = None        # textures.TextureAtlas
    # opacity micromaps (scene/omm.py): [T] i64 class of each prepared
    # triangle (OPAQUE / MIXED) and its level-2 micromap word; None without
    # alpha-tested geometry
    tri_opacity: Optional[torch.Tensor] = None
    tri_micromap: Optional[torch.Tensor] = None
    # nested dielectric priorities: some material's nested_priority is not
    # 0; every tier then runs its false-hit rejection
    has_nested_priorities: bool = False
    tlas: Optional[object] = None            # tlas.TLAS (two-level scenes)

    def replace(self, **kw) -> "SceneData":
        return dataclasses.replace(self, **kw)


# mat_pack columns (the JAX package's build_packs)
MP_BASE = 0        # 0:3
MP_METAL = 3
MP_ROUGH = 4
MP_IOR = 5
MP_TRANS = 6
MP_DTRANS = 7
MP_EMISSIVE = 8    # 8:11
MP_SPEC = 11
MP_THIN = 12
MP_ACUT = 13
MP_VOLABS = 14     # 14:17
MP_ANISO = 17
MP_ROWS = 18


def build_packs(geometry: Geometry, materials: Materials):
    """The fused gather tables: tri_pack [T,25] (v0, v1, v2, n0, n1, n2,
    uv0, uv1, uv2, material id as f32) and mat_pack [M,18] (the MP_*
    columns), on the device of the geometry."""
    idx = geometry.indices.long()
    p, nrm, uv = geometry.positions, geometry.normals, geometry.uvs
    tri_pack = torch.cat(
        [p[idx[:, 0]], p[idx[:, 1]], p[idx[:, 2]],
         nrm[idx[:, 0]], nrm[idx[:, 1]], nrm[idx[:, 2]],
         uv[idx[:, 0]], uv[idx[:, 1]], uv[idx[:, 2]],
         geometry.tri_material.to(torch.float32)[:, None]], dim=1)
    m = materials
    mat_pack = torch.cat([
        m.base_color, m.metallic[:, None], m.roughness[:, None],
        m.ior[:, None], m.transmission[:, None],
        m.diffuse_transmission[:, None], m.emissive,
        m.specular_f0_scale[:, None], m.thin[:, None],
        m.alpha_cutoff[:, None], m.volume_absorption,
        m.anisotropy[:, None]], dim=1)
    return tri_pack, mat_pack


@dataclass
class MeshInstance:
    """One mesh with its transform (host arrays)."""

    positions: np.ndarray    # [v,3]
    normals: np.ndarray      # [v,3]
    uvs: np.ndarray          # [v,2]
    indices: np.ndarray      # [t,3]
    material: np.ndarray     # [t]
    transform: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32))
    name: str = ""
    # Instances sharing a mesh_key (or the same positions array) are one
    # prototype of the two-level BVH (accel/tlas.py)
    mesh_key: Optional[str] = None


@dataclass
class HostScene:
    """Host scene: instances + materials + lights; `flatten` gives the
    world-space SceneData (the lights bake and tables come in prepare)."""

    instances: List[MeshInstance] = field(default_factory=list)
    materials: Optional[Materials] = None
    analytic_lights: Optional[AnalyticLights] = None
    envmap_image: Optional[np.ndarray] = None
    envmap_scale: float = 1.0
    envmap_rotation: float = 0.0
    textures: Optional[list] = None
    camera: Optional[dict] = None
    # build the two-level BVH even below the sharing-ratio heuristic
    force_instancing: bool = False
    # > 0: bake the environment as this many kEnvironmentQuad region lights
    # instead of one kEnvironment light (lighting/lights_baker.py)
    env_quad_lights: int = 0

    def flatten(self) -> SceneData:
        """Flatten instances to world space (same numpy ops as the JAX
        package, so the arrays are bit-identical)."""
        pos, nrm, uv, idx, mat, sub = [], [], [], [], [], []
        voff = 0
        for si, inst in enumerate(self.instances):
            m = inst.transform
            p = inst.positions @ m[:3, :3].T + m[:3, 3]
            nmat = np.linalg.inv(m[:3, :3]).T
            n = inst.normals @ nmat.T
            n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
            pos.append(p.astype(np.float32))
            nrm.append(n.astype(np.float32))
            uvs_i = inst.uvs if inst.uvs is not None else np.zeros(
                (len(p), 2), np.float32)
            uv.append(uvs_i.astype(np.float32))
            idx.append(inst.indices.astype(np.int32) + voff)
            mat.append(inst.material.astype(np.int32))
            sub.append(np.full((len(inst.indices),), si, np.int32))
            voff += len(p)
        geometry = Geometry(
            positions=_tensor(np.concatenate(pos)),
            normals=_tensor(np.concatenate(nrm)),
            uvs=_tensor(np.concatenate(uv)),
            indices=_tensor(np.concatenate(idx), torch.int32),
            tri_material=_tensor(np.concatenate(mat), torch.int32),
            tri_subinstance=_tensor(np.concatenate(sub), torch.int32),
        )
        mats = (self.materials if self.materials is not None
                else Materials.create(1))
        lights = (self.analytic_lights if self.analytic_lights is not None
                  else AnalyticLights.empty())
        return SceneData(geometry=geometry, materials=mats,
                         analytic_lights=lights)
