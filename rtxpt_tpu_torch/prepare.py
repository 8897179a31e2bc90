"""Scene preparation (counterpart of rtxpt_tpu/prepare.py): HostScene ->
world-space flatten -> LBVH, gather packs, lights bake -> kernel tables on
the render device, which is the GPU unless the caller asks for the CPU;
or, for a host whose instances share prototypes, the two-level scene.

Every scene gets the threaded LBVH (accel/lbvh.py, built by the C++
code of csrc/lbvh.cpp, which g++ compiles at first use), with the
brute-force operands when it has at most 4096 triangles, and the gather
packs (`scene.build_packs`): the general wavefront tier reads them. A
scene of at most 2048 triangles also gets the fused bounce tables
(pt/bounce_fused.py). A larger one is Morton-ordered first (every
per-triangle array shares the permutation, the BVH's too) and gets
cluster tables (accel/cluster.py) for the clustered tier.

A scene with an environment source bakes its map at the kernels'
64 x 128 (`env_res="auto"`), and the fused and cluster tables carry the
environment table; a scene with sphere or environment-quad lights gets
neither table and renders on the general tier, as in the JAX package. A
scene with textures bakes them into one atlas (scene/textures.py
`bake_textures`), which the general tier samples and which the fused and
cluster tables carry for the kernels' texture switch (unless it is past
their cap); its materials go to the render device with it.

Alpha-tested geometry (a material with an alpha cutoff and a base-colour
texture with alpha) gets opacity micromaps (scene/omm.py): the bake
classifies every triangle, the TRANSPARENT ones are dropped before the
BVH, the packs and the lights, and the MIXED ones carry a level-2
micromap word and an unknown-cell coverage, which the Morton order
permutes with every other per-triangle array; the BVH carries the words
in its leaf order (`tri_micro`, for the walk's test), and the fused and
cluster tables carry words and coverages for the kernels. Such a host is
never made a two-level scene (accel/tlas.py declines it, as the JAX
package's does).

A two-level scene (`_prepare_two_level`) keeps the prototypes' triangles
in object space beside the TLAS (accel/tlas.py), whose walk serves the
general tier; its lights are baked over the expanded (instance x emissive
pool triangle) list. Above 2048 world triangles it also gets instanced
cluster tables (`build_cluster_tables_instanced`) for the clustered tier,
unless a restriction of that build leaves it to the TLAS walk.

`scene_from_numpy` and `cluster_scene_from_numpy` build the port's
SceneData from the JAX package's prepared tables, carried across as
numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.accel import cluster
from rtxpt_tpu_torch.accel.cluster import (
    build_cluster_tables, build_cluster_tables_instanced,
    cluster_tables_from_numpy, morton_permutation)
from rtxpt_tpu_torch.accel.lbvh import build_bvh
from rtxpt_tpu_torch.accel.tlas import build_two_level
from rtxpt_tpu_torch.lighting.envmap import bake_envmap
from rtxpt_tpu_torch.lighting.lights_baker import (
    KIND_ENVQUAD, KIND_SPHERE, bake_lights)
from rtxpt_tpu_torch.pt import bounce_fused
from rtxpt_tpu_torch.pt.bounce_fused import (
    ENV_H, ENV_W, MAX_TRIS, build_bounce_tables, env_table_serves,
    has_priorities, tables_from_numpy)
from rtxpt_tpu_torch.scene.omm import TRANSPARENT, bake_opacity_micromaps
from rtxpt_tpu_torch.scene.scene import (
    AnalyticLights, Geometry, HostScene, Materials, SceneData, build_packs)
from rtxpt_tpu_torch.scene.textures import bake_textures


def scene_radius(positions: np.ndarray) -> float:
    lo = positions.min(0)
    hi = positions.max(0)
    return float(np.linalg.norm(hi - lo) * 0.5 + 1e-6)


def _geometry(positions, normals, uvs, indices, tri_material,
              tri_subinstance) -> Geometry:
    def t(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype)

    i32 = torch.int32
    return Geometry(positions=t(positions), normals=t(normals), uvs=t(uvs),
                    indices=t(indices, i32),
                    tri_material=t(tri_material, i32),
                    tri_subinstance=t(tri_subinstance, i32))


def kernel_tables_serve(lights, envmap) -> bool:
    """Whether the fused and cluster tables can take these lights: no
    sphere or environment-quad light (the general tier samples them), and
    an environment light only with its map at the kernels' 64 x 128."""
    return not ({KIND_SPHERE, KIND_ENVQUAD} & lights.kinds) and \
        env_table_serves(lights, envmap)


def _prepare_two_level(host: HostScene, built: dict, device,
                       env_res) -> SceneData:
    """The two-level scene (rtxpt_tpu/prepare.py _prepare_two_level): the
    object-space prototype pool and its packs beside the TLAS, the lights
    baked over build_two_level's expanded emissive list, and instanced
    cluster tables above 2048 world triangles. `env_res="auto"` keeps the
    environment source's own resolution here, as the JAX package does."""
    b = built
    geometry = _geometry(b["positions"], b["normals"], b["uvs"],
                         b["indices"], b["tri_material"],
                         b["tri_subinstance"])
    mats = (host.materials if host.materials is not None
            else Materials.create(1))
    al = (host.analytic_lights if host.analytic_lights is not None
          else AnalyticLights.empty())
    sd = SceneData(geometry=geometry, materials=mats, analytic_lights=al)
    envmap = bake_envmap(host.envmap_image, host.envmap_scale,
                         host.envmap_rotation,
                         res=None if env_res == "auto" else env_res,
                         device=device)
    tri_pack, mat_pack = build_packs(geometry, mats)
    tl = b["tlas"]
    root = tl.nodes[0].cpu().numpy()
    radius = float(np.linalg.norm(root[3:6] - root[0:3]) * 0.5 + 1e-6)
    lp = b["light_positions"]
    light_geo = _geometry(lp, np.zeros_like(lp),
                          np.zeros((lp.shape[0], 2), np.float32),
                          b["light_indices"], b["light_materials"],
                          b["light_subinstance"])
    lights = bake_lights(sd.replace(geometry=light_geo), envmap, radius,
                         env_quads=host.env_quad_lights, device=device)
    textures = _textures(host, device)
    cluster_tables = None
    refusals = ()
    n_world = sum(len(i.indices) for i in host.instances)
    if n_world > MAX_TRIS:
        cluster_tables = build_cluster_tables_instanced(
            built, host, mats, lights, envmap=envmap, textures=textures,
            device=device)
        if cluster_tables is None:
            refusals = tuple(cluster.unserved(mats, n_world))
    has_prio = has_priorities(mats)
    return sd.replace(tlas=tl, envmap=envmap, tri_pack=tri_pack.to(device),
                      mat_pack=mat_pack.to(device), lights=lights,
                      cluster_tables=cluster_tables, textures=textures,
                      materials=mats.to(device) if textures is not None
                      else mats, has_nested_priorities=has_prio,
                      kernel_refusals=refusals)


def _textures(host: HostScene, device):
    """The host's texture atlas on `device`, or None without textures."""
    if not host.textures:
        return None
    return bake_textures(host.textures, device=device)


def _opacity(host: HostScene, sd: SceneData):
    """The opacity bake of a flattened host (rtxpt_tpu/prepare.py:134-158):
    (sd without its TRANSPARENT triangles, classes, words, coverages),
    the last three None when no triangle is alpha-tested or none is MIXED
    after the drop."""
    if not host.textures:
        return sd, None, None, None
    baked = bake_opacity_micromaps(host, sd.materials, host.textures)
    if baked is None:
        return sd, None, None, None
    classes, words, covers = baked
    keep = classes != TRANSPARENT
    if not keep.all():
        g = sd.geometry
        k = torch.as_tensor(keep)
        sd = sd.replace(geometry=dataclasses.replace(
            g, indices=g.indices[k], tri_material=g.tri_material[k],
            tri_subinstance=g.tri_subinstance[k]))
        classes, words, covers = classes[keep], words[keep], covers[keep]
    if not (classes != 0).any():
        return sd, None, None, None
    return sd, classes, words, covers


def prepare(host: HostScene, device="cuda", instancing: str = "auto",
            env_res="auto") -> SceneData:
    """Flatten + build the LBVH and the packs + bake the environment and
    the lights + build the kernel tables on `device` (the GPU by default;
    raises when there is none).

    env_res: the environment's bake resolution. "auto" bakes an
    environment source at the kernels' (64, 128), so the fused, clustered
    and general tiers share one map (the two-level path keeps the
    source's resolution); None keeps the source's, (h, w) resamples to
    it. A flat scene whose environment is not at (64, 128) gets no fused
    or cluster tables and renders on the general tier.

    instancing: "auto" (the JAX package's default) builds the two-level
    scene when instances share prototypes (at least 1.5 instances per
    prototype, or host.force_instancing); "off" always flattens; "force"
    builds it whenever build_two_level takes the scene and raises
    ValueError otherwise.

    An alpha-tested host gets its opacity micromaps (the module's
    docstring)."""
    device = rtxpt_tpu_torch.device(device)
    if instancing not in ("auto", "off", "force"):
        raise ValueError(f"instancing {instancing!r} is not one of "
                         f"'auto', 'off', 'force'")
    if instancing != "off":
        built = build_two_level(
            host, min_sharing=1.0 if instancing == "force" else 1.5,
            device=device)
        if built is not None:
            return _prepare_two_level(host, built, device, env_res)
        if instancing == "force":
            raise ValueError(
                "instancing='force' but the scene hits a two-level v1 "
                "restriction (alpha-tested textures)")
    sd = host.flatten()
    textures = _textures(host, device)
    sd, classes, words, covers = _opacity(host, sd)
    g = sd.geometry
    pos = g.positions.numpy()
    idx = g.indices.numpy()
    clustered = len(idx) > MAX_TRIS
    if clustered:
        perm_np = morton_permutation(pos, idx)
        perm = torch.as_tensor(perm_np)
        g = dataclasses.replace(g, indices=g.indices[perm],
                                tri_material=g.tri_material[perm],
                                tri_subinstance=g.tri_subinstance[perm])
        sd = sd.replace(geometry=g)
        idx = g.indices.numpy()
        if classes is not None:
            classes, words, covers = (classes[perm_np], words[perm_np],
                                      covers[perm_np])
    if env_res == "auto":
        env_res = (ENV_H, ENV_W) if host.envmap_image is not None else None
    envmap = bake_envmap(host.envmap_image, host.envmap_scale,
                         host.envmap_rotation, res=env_res, device=device)
    lights = bake_lights(sd, envmap, scene_radius(pos),
                         env_quads=host.env_quad_lights, device=device)
    args = (pos, g.normals.numpy(), idx, g.tri_material.numpy(),
            sd.materials, lights)
    has_prio = has_priorities(sd.materials)
    tri_pack, mat_pack = build_packs(g, sd.materials)
    bvh = build_bvh(pos, idx, device=device)
    omm = {}
    if classes is not None:
        # the words as i32 bits; the BVH's in its leaf order; the retrace
        # reads the geometry on the render device
        w32 = words.view(np.int32)
        bvh = bvh.replace(tri_micro=torch.as_tensor(
            w32[bvh.prim_tri.cpu().numpy()]).to(device))
        sd = sd.replace(
            tri_opacity=torch.as_tensor(classes.astype(np.int32)).to(device),
            tri_micromap=torch.as_tensor(w32).to(device),
            geometry=sd.geometry.to(device))
        omm = dict(tri_micromap=words, tri_cover=covers)
    sd = sd.replace(lights=lights, envmap=envmap, textures=textures,
                    has_nested_priorities=has_prio, bvh=bvh,
                    tri_pack=tri_pack.to(device),
                    mat_pack=mat_pack.to(device))
    if textures is not None:
        sd = sd.replace(materials=sd.materials.to(device))
    if not kernel_tables_serve(lights, envmap):
        return sd
    build = build_cluster_tables if clustered else build_bounce_tables
    tables = build(*args, uvs=g.uvs.numpy(), envmap=envmap,
                   textures=textures, device=device, **omm)
    if tables is None:
        # as in the JAX package (rtxpt_tpu/prepare.py:210-239): no kernel
        # tables, and dispatch.resolve takes the general tier
        refusals = (cluster if clustered else bounce_fused).unserved(
            sd.materials, len(idx)) or [
                f"more than {cluster.MAX_CLUSTERS} clusters (the device "
                f"block budget)"]
        return sd.replace(kernel_refusals=tuple(refusals))
    if clustered:
        return sd.replace(cluster_tables=tables)
    return sd.replace(bounce_tables=tables)


def scene_from_numpy(tables: dict, lights=None, device="cuda",
                     envmap=None) -> SceneData:
    """SceneData from the JAX package's prepared bounce tables as numpy
    arrays: keys tri_rows, attr_rows, mat_rows, light_rows, tc, n_chunks,
    n_lights, n_tris, env_rows and tex_ct, tex_meta, tex_maps (the
    BounceTables fields; omm with its 7-group tri_rows, prio), with the
    light list and the environment map (lighting/envmap.py
    envmap_from_numpy) the NEE and the general tier read."""
    device = rtxpt_tpu_torch.device(device)
    tables = dict(tables)
    tables.pop("tr", None)
    bt = tables_from_numpy(device=device, **tables)
    return SceneData(geometry=None, materials=None, analytic_lights=None,
                     lights=lights, envmap=envmap, bounce_tables=bt)


def cluster_scene_from_numpy(tables: dict, lights=None, device="cuda",
                             envmap=None) -> SceneData:
    """SceneData from the JAX package's prepared cluster tables as numpy
    arrays: keys blocks, aabb_lo, aabb_hi, mat_rows, light_rows, offsets,
    n_clusters, n_tris, n_lights, env_rows, and for instanced tables
    instanced, wc_block, wc_inst, xf and inst_post (the ClusterTables
    fields; tex_ct, tex_meta and tex_maps too; omm with its 7-slot
    blocks), with the light list and the environment map."""
    device = rtxpt_tpu_torch.device(device)
    tables = dict(tables)
    tables.pop("tr", None)
    ct = cluster_tables_from_numpy(device=device, **tables)
    return SceneData(geometry=None, materials=None, analytic_lights=None,
                     lights=lights, envmap=envmap, cluster_tables=ct)

