"""Kernel-tier resolution (counterpart of rtxpt_tpu/pt/dispatch.py).

Three tiers serve `trace_paths`:

  * "fused" -- a scene with bounce tables (at most 2048 triangles): the
    CUDA bounce kernel K1 (csrc/bounce_fused.cu) through
    `bounce_fused.bounce`;
  * "clustered" -- a scene with cluster tables (above 2048 triangles):
    the cull and sorts in PyTorch around K3, K4 and K5
    (csrc/cluster_*.cu) through `bounce_clustered.trace_paths_clustered`;
  * "torch" -- the name a bounce-table scene on CPU tensors resolves to:
    the fused path with K1's plain PyTorch version.

The wrappers pick the kernel for CUDA tensors and its plain version for
CPU tensors, so a clustered scene on the CPU keeps the tier name
"clustered". A scene or config that the tiers do not serve raises,
naming the feature; nothing demotes to another tier or to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtxpt_tpu_torch.config import NEEMode, PTMode
from rtxpt_tpu_torch.pt.bounce_clustered import DEFAULT_KSLOTS, DEFAULT_PAGES
from rtxpt_tpu_torch.pt.bounce_fused import MAX_LIGHTS

TIERS = ("fused", "clustered", "torch")


def _tables(scene):
    """(tier the scene's tables select, the tables) or (None, None)."""
    if getattr(scene, "cluster_tables", None) is not None:
        return "clustered", scene.cluster_tables
    if getattr(scene, "bounce_tables", None) is not None:
        return "fused", scene.bounce_tables
    return None, None


def unsupported_features(scene, cfg) -> list:
    """Names of the scene's and config's features the tiers do not serve
    yet (empty when they serve them all)."""
    out = []
    _, tables = _tables(scene)
    if tables is None:
        out.append("a scene without bounce or cluster tables (prepare it "
                   "first)")
    lights = getattr(scene, "lights", None)
    env = getattr(scene, "envmap", None)
    if (lights is not None and lights.env_light >= 0) or (
            env is not None and np.any(np.asarray(env.mean_radiance) > 0)):
        out.append("environment lighting")
    if getattr(scene, "textures", None) is not None:
        out.append("textures")
    if getattr(scene, "tri_opacity", None) is not None:
        out.append("opacity micromaps")
    if getattr(scene, "has_nested_priorities", False):
        out.append("nested dielectric priorities")
    if tables is not None and tables.n_lights > MAX_LIGHTS:
        out.append(f"more than {MAX_LIGHTS} lights")
    if cfg.mode.value != PTMode.REFERENCE.value:
        out.append(f"render mode {cfg.mode.name}")
    if getattr(cfg, "nee_external", False):
        out.append("external NEE")
    if cfg.split_channels:
        out.append("split diffuse/specular channels")
    if cfg.nee.value == NEEMode.NEEAT.value:
        out.append("NEE-AT")
    if int(cfg.nee_candidates) > 1:
        out.append("WRS NEE with more than one candidate")
    return out


def resolve(scene, cfg, device):
    """Resolve cfg.kernel_tier for tensors on `device`. Returns a copy of
    cfg with kernel_tier "fused" (bounce tables on CUDA), "torch" (bounce
    tables on the CPU) or "clustered" (cluster tables), and the
    clustered tier's kslots and pages: the config's, else the defaults
    (64 and 2), with kslots at most the cluster count and pages at most
    as many as the candidate lists of all clusters fill. Raises
    NotImplementedError naming any feature the tiers do not serve, and
    ValueError for a tier that the scene's tables or the device have no
    path for."""
    device = torch.device(device)
    tier = cfg.kernel_tier
    kind, tables = _tables(scene)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel tier for device {device}")
    if tier not in ("auto",) + TIERS:
        raise NotImplementedError(
            f"kernel tier {tier!r} is not ported to rtxpt_tpu_torch")
    if device.type == "cuda" and tier == "torch":
        raise ValueError(f"kernel tier {tier!r} has no CUDA path; CUDA "
                         f"tensors run the 'fused' or 'clustered' kernels")
    if kind is not None:
        if tier == "auto":
            tier = "torch" if kind == "fused" and device.type == "cpu" \
                else kind
        elif (tier == "clustered") != (kind == "clustered"):
            tables = "cluster" if kind == "clustered" else "bounce"
            raise ValueError(f"kernel tier {tier!r} does not run a scene "
                             f"with {tables} tables")
    missing = unsupported_features(scene, cfg)
    if missing:
        raise NotImplementedError(
            f"the {kind or 'port'} tier does not serve: "
            + ", ".join(missing))
    kslots = int(cfg.cluster_kslots) or DEFAULT_KSLOTS
    pages = int(cfg.cluster_pages) or DEFAULT_PAGES
    if kind == "clustered":
        kslots = min(kslots, tables.n_clusters)
        pages = max(1, min(pages, -(-tables.n_clusters // kslots)))
    return dataclasses.replace(cfg, kernel_tier=tier, cluster_kslots=kslots,
                               cluster_pages=pages)
