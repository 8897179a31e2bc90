"""Scene preparation (counterpart of rtxpt_tpu/prepare.py), the flat path:
HostScene -> world-space flatten -> LBVH, gather packs, lights bake ->
kernel tables on the render device, which is the GPU unless the caller
asks for the CPU.

Every scene gets the threaded LBVH (accel/lbvh.py, built by the C++
code of csrc/lbvh.cpp, which g++ compiles at first use), with the
brute-force operands when it has at most 4096 triangles, and the gather
packs (`scene.build_packs`): the general wavefront tier reads them. A
scene of at most 2048 triangles also gets the fused bounce tables
(pt/bounce_fused.py). A larger one is Morton-ordered first (every
per-triangle array shares the permutation, the BVH's too) and gets
cluster tables (accel/cluster.py) for the clustered tier.

`scene_from_numpy` and `cluster_scene_from_numpy` build the port's
SceneData from the JAX package's prepared tables, carried across as
numpy arrays.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.accel.cluster import (
    build_cluster_tables, cluster_tables_from_numpy, morton_permutation)
from rtxpt_tpu_torch.accel.lbvh import build_bvh
from rtxpt_tpu_torch.lighting.envmap import bake_envmap
from rtxpt_tpu_torch.lighting.lights_baker import bake_lights
from rtxpt_tpu_torch.pt.bounce_fused import (
    MAX_TRIS, build_bounce_tables, tables_from_numpy)
from rtxpt_tpu_torch.scene.scene import HostScene, SceneData, build_packs


def scene_radius(positions: np.ndarray) -> float:
    lo = positions.min(0)
    hi = positions.max(0)
    return float(np.linalg.norm(hi - lo) * 0.5 + 1e-6)


def prepare(host: HostScene, device="cuda",
            instancing: str = "off") -> SceneData:
    """Flatten + build the LBVH and the packs + bake lights + build the
    kernel tables on `device` (the GPU by default; raises when there is
    none).

    Raises NotImplementedError for textures, instancing (two-level BVH)
    and environment maps, none of which the port serves yet."""
    device = rtxpt_tpu_torch.device(device)
    if host.textures:
        raise NotImplementedError("textures are not ported to "
                                  "rtxpt_tpu_torch yet")
    if instancing != "off":
        raise NotImplementedError("instancing (the two-level BVH) is not "
                                  "ported to rtxpt_tpu_torch yet")
    sd = host.flatten()
    g = sd.geometry
    pos = g.positions.numpy()
    idx = g.indices.numpy()
    clustered = len(idx) > MAX_TRIS
    if clustered:
        perm = torch.as_tensor(morton_permutation(pos, idx))
        g = dataclasses.replace(g, indices=g.indices[perm],
                                tri_material=g.tri_material[perm],
                                tri_subinstance=g.tri_subinstance[perm])
        sd = sd.replace(geometry=g)
        idx = g.indices.numpy()
    envmap = bake_envmap(host.envmap_image, host.envmap_scale,
                         host.envmap_rotation)
    lights = bake_lights(sd, envmap, scene_radius(pos), device=device)
    args = (pos, g.normals.numpy(), idx, g.tri_material.numpy(),
            sd.materials, lights)
    has_prio = bool(torch.any(sd.materials.nested_priority != 0))
    tri_pack, mat_pack = build_packs(g, sd.materials)
    sd = sd.replace(lights=lights, envmap=envmap,
                    has_nested_priorities=has_prio,
                    bvh=build_bvh(pos, idx, device=device),
                    tri_pack=tri_pack.to(device),
                    mat_pack=mat_pack.to(device))
    if clustered:
        return sd.replace(cluster_tables=build_cluster_tables(
            *args, uvs=g.uvs.numpy(), device=device))
    return sd.replace(bounce_tables=build_bounce_tables(
        *args, uvs=g.uvs.numpy(), device=device))


def scene_from_numpy(tables: dict, lights=None, device="cuda") -> SceneData:
    """SceneData from the JAX package's prepared bounce tables as numpy
    arrays: keys tri_rows, attr_rows, mat_rows, light_rows, tc, n_chunks,
    n_lights, n_tris (the BounceTables fields). Table parts the port does
    not serve (env_rows, tex_ct, tex_meta, omm, prio) must be absent,
    None or false."""
    device = rtxpt_tpu_torch.device(device)
    tables = dict(tables)
    _refuse_parts(tables, ("env_rows", "tex_ct", "tex_meta", "omm", "prio"),
                  "bounce")
    for key in ("tr", "tex_maps"):
        tables.pop(key, None)
    bt = tables_from_numpy(device=device, **tables)
    return SceneData(geometry=None, materials=None, analytic_lights=None,
                     lights=lights, bounce_tables=bt)


def cluster_scene_from_numpy(tables: dict, lights=None,
                             device="cuda") -> SceneData:
    """SceneData from the JAX package's prepared cluster tables as numpy
    arrays: keys blocks, aabb_lo, aabb_hi, mat_rows, light_rows, offsets,
    n_clusters, n_tris, n_lights (the ClusterTables fields). Parts the
    port does not serve (env_rows, tex_ct, tex_meta, omm, instanced and
    its tables) must be absent, None or false."""
    device = rtxpt_tpu_torch.device(device)
    tables = dict(tables)
    _refuse_parts(tables, ("env_rows", "tex_ct", "tex_meta", "omm",
                           "instanced", "wc_block", "wc_inst", "xf",
                           "inst_post"), "cluster")
    for key in ("tr", "tex_maps"):
        tables.pop(key, None)
    ct = cluster_tables_from_numpy(device=device, **tables)
    return SceneData(geometry=None, materials=None, analytic_lights=None,
                     lights=lights, cluster_tables=ct)


def _refuse_parts(tables, keys, kind):
    for key in keys:
        value = tables.pop(key, None)
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{kind} table part {key!r} is not ported to "
                f"rtxpt_tpu_torch yet")
