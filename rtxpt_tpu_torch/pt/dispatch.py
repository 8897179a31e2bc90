"""Kernel-tier resolution (counterpart of rtxpt_tpu/pt/dispatch.py).

Two tiers serve `trace_paths`:

  * "fused" -- the CUDA bounce kernel (csrc/bounce_fused.cu) through
    `bounce_fused.bounce`; the only tier for CUDA tensors;
  * "torch" -- `bounce_fused.bounce_reference`, the kernel's plain
    PyTorch version, for CPU tensors.

A scene or config that the kernel does not take raises, naming the
feature; nothing demotes to the plain version or to the CPU.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rtxpt_tpu_torch.config import NEEMode, PTMode
from rtxpt_tpu_torch.pt.bounce_fused import MAX_LIGHTS

TIERS = ("fused", "torch")


def unsupported_features(scene, cfg) -> list:
    """Names of the scene's and config's features the fused bounce step
    does not serve yet (empty when it serves them all)."""
    out = []
    if getattr(scene, "bounce_tables", None) is None:
        out.append("a scene without bounce tables (prepare it first)")
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
    tables = getattr(scene, "bounce_tables", None)
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
    cfg with kernel_tier "fused" (CUDA) or "torch" (CPU); raises
    NotImplementedError naming any feature the tiers do not serve, and
    ValueError for a tier or device without a path."""
    device = torch.device(device)
    tier = cfg.kernel_tier
    if device.type == "cuda":
        if tier not in ("auto", "fused"):
            raise ValueError(f"kernel tier {tier!r} has no CUDA path; CUDA "
                             f"tensors run the 'fused' kernel")
        tier = "fused"
    elif device.type == "cpu":
        if tier == "auto":
            tier = "torch"
        elif tier not in TIERS:
            raise NotImplementedError(
                f"kernel tier {tier!r} is not ported to rtxpt_tpu_torch")
    else:
        raise ValueError(f"no kernel tier for device {device}")
    missing = unsupported_features(scene, cfg)
    if missing:
        raise NotImplementedError(
            "the fused bounce kernel does not serve: " + ", ".join(missing))
    return dataclasses.replace(cfg, kernel_tier=tier)
