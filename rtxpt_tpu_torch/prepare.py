"""Scene preparation (counterpart of rtxpt_tpu/prepare.py), the flat path:
HostScene -> world-space flatten -> lights bake -> fused bounce tables on
the render device. No BVH: the fused kernel tests every triangle, so the
port takes scenes of at most 2048 triangles until the BVH slice lands.

`scene_from_numpy` builds the port's SceneData from the JAX package's
prepared tables, carried across as numpy arrays.
"""

from __future__ import annotations

import numpy as np
import torch

from rtxpt_tpu_torch.lighting.envmap import bake_envmap
from rtxpt_tpu_torch.lighting.lights_baker import bake_lights
from rtxpt_tpu_torch.pt.bounce_fused import (
    MAX_TRIS, build_bounce_tables, tables_from_numpy)
from rtxpt_tpu_torch.scene.scene import HostScene, SceneData


def scene_radius(positions: np.ndarray) -> float:
    lo = positions.min(0)
    hi = positions.max(0)
    return float(np.linalg.norm(hi - lo) * 0.5 + 1e-6)


def prepare(host: HostScene, device="cpu",
            instancing: str = "off") -> SceneData:
    """Flatten + bake lights + build the fused bounce tables on `device`.

    Raises NotImplementedError for textures, instancing (two-level BVH),
    environment maps and scenes above 2048 triangles, none of which the
    port serves yet."""
    if host.textures:
        raise NotImplementedError("textures are not ported to "
                                  "rtxpt_tpu_torch yet")
    if instancing != "off":
        raise NotImplementedError("instancing (the two-level BVH) is not "
                                  "ported to rtxpt_tpu_torch yet")
    sd = host.flatten()
    pos = sd.geometry.positions.numpy()
    idx = sd.geometry.indices.numpy()
    if len(idx) > MAX_TRIS:
        raise NotImplementedError(
            f"{len(idx)} triangles: the port serves scenes of at most "
            f"{MAX_TRIS} triangles until the BVH slice lands")
    envmap = bake_envmap(host.envmap_image, host.envmap_scale,
                         host.envmap_rotation)
    lights = bake_lights(sd, envmap, scene_radius(pos), device=device)
    tables = build_bounce_tables(
        pos, sd.geometry.normals.numpy(), idx,
        sd.geometry.tri_material.numpy(), sd.materials, lights,
        uvs=sd.geometry.uvs.numpy(), device=device)
    has_prio = bool(torch.any(sd.materials.nested_priority != 0))
    return sd.replace(lights=lights, envmap=envmap, bounce_tables=tables,
                      has_nested_priorities=has_prio)


def scene_from_numpy(tables: dict, lights=None, device="cpu") -> SceneData:
    """SceneData from the JAX package's prepared bounce tables as numpy
    arrays: keys tri_rows, attr_rows, mat_rows, light_rows, tc, n_chunks,
    n_lights, n_tris (the BounceTables fields). Table parts the port does
    not serve (env_rows, tex_ct, tex_meta, omm, prio) must be absent,
    None or false."""
    tables = dict(tables)
    for key in ("env_rows", "tex_ct", "tex_meta", "omm", "prio"):
        value = tables.pop(key, None)
        if value is not None and value is not False:
            raise NotImplementedError(
                f"bounce table part {key!r} is not ported to "
                f"rtxpt_tpu_torch yet")
    for key in ("tr", "tex_maps"):
        tables.pop(key, None)
    bt = tables_from_numpy(device=device, **tables)
    return SceneData(geometry=None, materials=None, analytic_lights=None,
                     lights=lights, bounce_tables=bt)
