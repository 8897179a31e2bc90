"""Kernel-tier resolution (counterpart of rtxpt_tpu/pt/dispatch.py).

Four tiers serve `trace_paths`:

  * "fused" -- a scene with bounce tables (at most 2048 triangles): the
    CUDA bounce kernel K1 (csrc/bounce_fused.cu) through
    `bounce_fused.bounce`; NEE-AT, more than 128 lights and WRS with more
    than one candidate take its external-NEE route (K1's export modes,
    pt/nee_external.py and the shadow kernel K2);
  * "clustered" -- a scene with cluster tables (above 2048 triangles):
    the cull and sorts in PyTorch around K3, K4 and K5
    (csrc/cluster_*.cu) through `bounce_clustered.trace_paths_clustered`;
    instanced cluster tables (a two-level scene above 2048 world
    triangles) run K3's and K5's instanced variants; the same three
    cases take the external-NEE route (K4's export modes, then
    pt/nee_external.py and K5);
  * "torch" -- the name a bounce-table scene on CPU tensors resolves to:
    the fused path with K1's plain PyTorch version;
  * "xla" -- the general BVH wavefront (pt/integrator.py `_wavefront`,
    the JAX package's tier of that name) over the scene's LBVH: the
    brute-force closest hit K8 (csrc/brute_closest.cu) for scenes with
    brute tables (at most 4096 triangles), else the BVH walk K9
    (csrc/bvh_traverse.cu); over a two-level scene's TLAS, the TLAS walk
    in PyTorch (accel/tlas.py). Asked for explicitly, or picked for a
    scene that has a BVH or a TLAS and neither bounce nor cluster tables:
    a two-level scene without cluster tables resolves to it under "auto",
    as in the JAX package. Flat prepared scenes have a BVH and bounce or
    cluster tables, and keep "fused" / "torch" / "clustered" under
    "auto".

An environment (a map with an environment light) is served on every
tier: the fused and cluster tables carry the kernels' environment table.
Textures and normal maps are served on every tier too: the kernels'
texture switch is stochastic texture filtering (one jittered texel per
map), so the fused and clustered tiers serve a textured scene only with
`cfg.stochastic_texture_filtering` and an atlas within the kernels'
tables (`bounce_fused.build_tex_tables`); the general tier samples
bilinearly without it. As in the JAX package, "auto" resolves to "xla" a
scene whose kernel tiers would need what only the general tier serves:
NEE-AT with an environment light, sphere or environment-quad lights
(prepare builds no bounce or cluster tables for the latter), and
textures without stochastic filtering or past the atlas cap; a caller
who pins "fused" or "clustered" for them gets NotImplementedError naming
the feature. Likewise prepare builds no kernel tables, as the JAX
package's builders return None, for anisotropic materials, more than 128
materials or more clusters than the block budget
(`SceneData.kernel_refusals` names them): "auto" takes "xla", a pinned
kernel tier raises naming them.

Alpha-tested geometry (`scene.tri_opacity`, the opacity micromaps of
prepare) is served where the JAX package serves it
(rtxpt_tpu/pt/dispatch.py:93-100, :130-134): on the fused and clustered
tiers only when their tables carry the micromaps and the textures ride
in-kernel with stochastic texture filtering (the kernels' alpha test at
shading time fetches one jittered texel); "auto" otherwise resolves it to
"xla", whose retrace tests the texture bilinearly, and a pinned kernel
tier raises. A two-level scene never carries micromaps from prepare; one
made by hand is refused on the TLAS route, which has no alpha test.

With `bounce_clustered.FLAT` false (the per-row route, K6 and K7) the
clustered tier serves what the JAX package's per-row route serves
(rtxpt_tpu/pt/dispatch.py:129-143): "auto" resolves a scene with opacity
micromaps, nested priorities or instanced cluster tables to "xla", and a
pinned "clustered" refuses them by name; external NEE is refused by name
on that route (the JAX package picks its clustered tier there and fails
an assert).

Nested dielectric priorities (`scene.has_nested_priorities`) are served
on every tier, as in the JAX package (rtxpt_tpu/pt/dispatch.py:109-113,
:140): the fused tier's K1 and the clustered tier's K4 run their priority
variants (the false-hit pass-through), the general tier its bounded
false-hit retrace. Bounce tables made without the priority switch (by
hand) leave such a scene to "xla" under "auto".

The real-time arguments of `trace_paths` (a V-buffer restart `first_hit`,
per-lane `bounce_budget`s, `first_direct=False`) are served on the fused
tier (K1's inject variant) and the general tier. The clustered tier
serves none of them: as in the JAX package (rtxpt_tpu/pt/integrator.py
:99-103, :113), `resolve` hands a call with `first_hit` or
`first_direct=False` on cluster tables (flat, instanced or per-row) to
"xla", and a call with only a budget too (F14: the JAX clustered tier
drops the budget, since trace_paths_clustered is never passed it).

The wrappers pick the kernel for CUDA tensors and its plain version for
CPU tensors, so a clustered scene on the CPU keeps the tier name
"clustered" and the general tier keeps "xla". A scene, config or call
argument that the tiers do not serve raises, naming the feature; nothing
demotes to another tier or to the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from rtxpt_tpu_torch.config import NEEMode, PTMode
from rtxpt_tpu_torch.lighting.lights_baker import KIND_ENVQUAD, KIND_SPHERE
from rtxpt_tpu_torch.pt import bounce_clustered
from rtxpt_tpu_torch.pt.bounce_clustered import DEFAULT_KSLOTS, DEFAULT_PAGES
from rtxpt_tpu_torch.pt.bounce_fused import MAX_LIGHTS

TIERS = ("fused", "clustered", "torch", "xla")


def general_only_features(scene, cfg, tables=None):
    """Names of what only the general tier serves on this scene and
    config with the kernel tier's `tables` (rtxpt_tpu/pt/dispatch.py
    _nee_routing_ok, :102-107, :135-139 and the table builders): sphere or
    environment-quad lights, NEE-AT with an environment light,
    textures without stochastic texture filtering or without the
    kernels' texture tables (an atlas past their cap), and alpha-tested
    geometry without the tables' micromaps or stochastic filtering, and
    nested priorities on bounce tables without their priority switch."""
    out = []
    if getattr(scene, "has_nested_priorities", False) and \
            not getattr(tables, "prio", True):
        out.append("nested dielectric priorities without the bounce "
                   "tables' priority switch")
    if getattr(scene, "tri_opacity", None) is not None and tables is not None:
        if not getattr(tables, "omm", False):
            out.append("alpha-tested textures (opacity micromaps) without "
                       "the kernel tables' micromaps")
        elif getattr(scene, "textures", None) is None or \
                not cfg.stochastic_texture_filtering:
            out.append("alpha-tested textures (opacity micromaps) without "
                       "stochastic texture filtering (the kernels' alpha "
                       "test fetches one jittered texel)")
    if getattr(scene, "textures", None) is not None and tables is not None:
        if getattr(tables, "tex", None) is None:
            out.append("textures past the kernels' atlas cap (64k texels "
                       "with every MIP, 128 textures, 14 MIPs, power-of-two "
                       "sizes)")
        elif not cfg.stochastic_texture_filtering:
            out.append("textures without stochastic texture filtering (the "
                       "kernels fetch one jittered texel; the general tier "
                       "filters bilinearly)")
    lights = getattr(scene, "lights", None)
    if lights is None:
        return out
    if {KIND_SPHERE, KIND_ENVQUAD} & lights.kinds:
        out.append("sphere or environment-quad lights (the general tier "
                   "samples them)")
    if cfg.nee.value == NEEMode.NEEAT.value and lights.env_light >= 0:
        out.append("NEE-AT with an environment light")
    return out


def needs_external_nee(scene, cfg) -> bool:
    """True when NEE must take the external route (rtxpt_tpu/pt/
    dispatch.py:66-75): NEE-AT, more than 128 lights (past the kernel's
    light table), or WRS over more than one candidate."""
    lights = getattr(scene, "lights", None)
    if cfg.nee.value == NEEMode.OFF.value or lights is None:
        return False
    if cfg.nee.value == NEEMode.NEEAT.value:
        return True
    return lights.count > MAX_LIGHTS or int(cfg.nee_candidates) > 1


def _tables(scene, tier="auto"):
    """(the tier's kind, its tables) or (None, None): "xla" and the TLAS
    or BVH when asked for, or for a scene with only those; else the
    cluster or bounce tables."""
    bvh = getattr(scene, "tlas", None)
    if bvh is None:
        bvh = getattr(scene, "bvh", None)
    if tier == "xla":
        return ("xla", bvh) if bvh is not None else (None, None)
    if getattr(scene, "cluster_tables", None) is not None:
        return "clustered", scene.cluster_tables
    if getattr(scene, "bounce_tables", None) is not None:
        return "fused", scene.bounce_tables
    if bvh is not None:
        return "xla", bvh
    return None, None


def unsupported_features(scene, cfg, neeat_state=None, tier="auto"):
    """Names of the scene's and config's features that the tier
    (`tier`, or the one the scene's tables select) does not serve yet;
    empty when it serves them all. Every route but the per-row clustered
    one serves the split channels."""
    out = []
    kind, tables = _tables(scene, tier)
    if tables is None:
        out.append("a scene without bounce, cluster, BVH or TLAS tables "
                   "(prepare it first)")
    lights = getattr(scene, "lights", None)
    neeat = cfg.nee.value == NEEMode.NEEAT.value
    if getattr(scene, "tri_opacity", None) is not None and \
            kind == "xla" and getattr(scene, "tlas", None) is not None:
        out.append("alpha-tested textures (opacity micromaps) on a "
                   "two-level scene (prepare flattens them; the TLAS walk "
                   "has no alpha test)")
    if cfg.mode.value != PTMode.REFERENCE.value:
        out.append(f"render mode {cfg.mode.name}")
    if neeat and neeat_state is None:
        out.append("NEE-AT without a tile state (integrator."
                   "render_adaptive makes one)")
    if kind == "xla" or tables is None:
        return out
    out += general_only_features(scene, cfg, tables)
    if kind == "clustered" and not bounce_clustered.FLAT:
        out += [f"{name} on the per-row route (bounce_clustered.FLAT is "
                f"False)" for name in bounce_clustered.per_row_unserved(
                    scene, tables)]
        if needs_external_nee(scene, cfg):
            # the JAX package takes its clustered tier here and fails an
            # assert (bounce_clustered.py:1562-1564)
            out.append("external NEE (NEE-AT, more than 128 lights, WRS "
                       "K > 1) on the per-row route (bounce_clustered.FLAT "
                       "is False)")
        if cfg.split_channels:
            # likewise (bounce_clustered.py:1560-1561)
            out.append("split diffuse/specular channels on the per-row "
                       "route (bounce_clustered.FLAT is False)")
    if lights is not None and lights.env_light >= 0 and tables.env is None:
        out.append("an environment light without the tables' environment "
                   "table (prepare bakes it)")
    # the external route serves NEE-AT, > 128 lights and WRS K > 1; it
    # samples the light list
    many = tables.n_lights > MAX_LIGHTS
    if lights is None and cfg.nee.value != NEEMode.OFF.value and (
            neeat or many or int(cfg.nee_candidates) > 1):
        out.append("external NEE without a light list")
    return out


def restarts(first_hit=None, bounce_budget=None,
             first_direct: bool = True) -> bool:
    """Whether a trace takes any of the real-time arguments, which only
    the fused and general tiers serve."""
    return first_hit is not None or bounce_budget is not None \
        or not first_direct


def _check_devices(scene, tables, neeat_state):
    """Raise ValueError when the light list or the NEE-AT state lies on
    another device than the scene's tables (the BVH, on the general
    tier)."""
    if tables is None:
        return
    lights = getattr(scene, "lights", None)
    for what, t in (("light list", getattr(lights, "kind", None)),
                    ("NEE-AT state", getattr(neeat_state, "tile_pdf", None))):
        if t is not None and t.device != tables.device:
            raise ValueError(f"the {what} is on {t.device}, the scene's "
                             f"tables on {tables.device}: build them on one "
                             f"device")


def resolve(scene, cfg, device, neeat_state=None, **call):
    """Resolve cfg.kernel_tier for tensors on `device`. Returns a copy of
    cfg with kernel_tier "fused" (bounce tables on CUDA), "torch" (bounce
    tables on the CPU), "clustered" (cluster tables) or "xla" (asked for,
    a scene with only a BVH or TLAS, or under "auto" a scene with
    `general_only_features`); nee_external set where NEE takes the
    external route (`needs_external_nee`, bounce or cluster tables); and the
    clustered tier's kslots and pages: the config's, else the defaults (64
    and 2), with kslots at most the cluster count and pages at most as
    many as the candidate lists of all clusters fill. `call` holds the
    trace's real-time arguments (first_hit, bounce_budget, first_direct):
    with any of them a scene on cluster tables resolves to "xla", pinned
    "clustered" too, as in the JAX package (`restarts`). Raises
    NotImplementedError
    naming any feature the tier does not serve, and ValueError for a tier
    that the scene's tables or the device have no path for, or for a
    light list or NEE-AT state on another device than the tables."""
    device = torch.device(device)
    tier = cfg.kernel_tier
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel tier for device {device}")
    if tier not in ("auto",) + TIERS:
        raise NotImplementedError(
            f"kernel tier {tier!r} is not ported to rtxpt_tpu_torch")
    if device.type == "cuda" and tier == "torch":
        raise ValueError(f"kernel tier {tier!r} has no CUDA path; CUDA "
                         f"tensors run the 'fused', 'clustered' or 'xla' "
                         f"kernels")
    kind, tables = _tables(scene, tier)
    _check_devices(scene, tables, neeat_state)
    if kind == "clustered" and tier in ("auto", "clustered") \
            and restarts(**call):
        tier = "xla"
        kind, tables = _tables(scene, tier)
    if tier == "auto" and kind in ("fused", "clustered") and (
            general_only_features(scene, cfg, tables)
            or (kind == "clustered"
                and bounce_clustered.per_row_unserved(scene, tables))):
        xla = _tables(scene, "xla")
        if xla[0] is not None:
            kind, tables = xla
    if tier == "xla" and kind is None:
        raise ValueError("kernel tier 'xla' needs the scene's BVH or TLAS "
                         "(prepare builds one)")
    if kind is not None:
        if tier == "auto":
            tier = "torch" if kind == "fused" and device.type == "cpu" \
                else kind
        elif tier != "xla" and kind != ("clustered" if tier == "clustered"
                                        else "fused"):
            refused = getattr(scene, "kernel_refusals", ())
            if kind == "xla" and refused:
                raise NotImplementedError(
                    f"the {tier} tier does not serve: " + ", ".join(refused)
                    + " (prepare built no kernel tables)")
            names = dict(clustered="cluster", fused="bounce",
                         xla="BVH or TLAS")
            raise ValueError(f"kernel tier {tier!r} does not run a scene "
                             f"with {names[kind]} tables")
    missing = unsupported_features(scene, cfg, neeat_state, tier)
    if missing:
        raise NotImplementedError(
            f"the {kind or 'port'} tier does not serve: "
            + ", ".join(missing))
    kslots = int(cfg.cluster_kslots) or DEFAULT_KSLOTS
    pages = int(cfg.cluster_pages) or DEFAULT_PAGES
    if kind == "clustered":
        kslots = min(kslots, tables.n_clusters)
        pages = max(1, min(pages, -(-tables.n_clusters // kslots)))
    ext = kind in ("fused", "clustered") and needs_external_nee(scene, cfg)
    return dataclasses.replace(cfg, kernel_tier=tier, cluster_kslots=kslots,
                               cluster_pages=pages, nee_external=ext)
