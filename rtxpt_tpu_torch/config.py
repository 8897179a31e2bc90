"""Path-tracer configuration of the port.

The same fields, defaults and enum values as rtxpt_tpu/config.py's
PTMode, NEEMode, DenoiserMode, PathTracerConfig and RenderConfig
(tests/test_torch_imports.py holds the two equal), kept in the port so that it runs where the JAX package is
not installed. The port reads a config by attribute and compares enums by
value, so either package's PathTracerConfig drives it.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class PTMode(enum.Enum):
    """Top-level render mode."""

    REFERENCE = 0
    BUILD_STABLE_PLANES = 1
    FILL_STABLE_PLANES = 2


class NEEMode(enum.Enum):
    """Next-event-estimation light sampler."""

    OFF = 0
    UNIFORM = 1
    POWER = 2     # power-proportional global CDF
    NEEAT = 3     # feedback-adaptive (the external-NEE route)


class DenoiserMode(enum.Enum):
    """Real-time mode's denoiser (render/denoise.py)."""

    NONE = 0
    RELAX = 1
    REBLUR = 2


@dataclasses.dataclass(frozen=True)
class PathTracerConfig:
    """Per-dispatch path tracing switches (see rtxpt_tpu/config.py for
    each field's reference analog). pt/dispatch.py refuses the fields
    that select a feature the port does not serve yet (mode;
    split_channels on the per-row clustered route) and sets
    nee_external; the Pallas interpret mode is not read."""

    mode: PTMode = PTMode.REFERENCE
    max_bounces: int = 6
    min_bounces_before_rr: int = 2
    enable_russian_roulette: bool = True
    nee: NEEMode = NEEMode.POWER
    nee_candidates: int = 1
    enable_mis: bool = True
    firefly_clamp: float = 0.0
    texture_mips: bool = True
    stochastic_texture_filtering: bool = False
    max_ray_travel: float = 1.0e27
    low_discrepancy: bool = True
    ray_chunk: int = 1 << 16
    sort_rays: bool = True
    cluster_kslots: int = 0
    cluster_pages: int = 0
    split_channels: bool = False
    passthrough_extra_iters: int = 2
    kernel_tier: str = "auto"        # "auto" | "fused" | "torch"
    pallas_interpret: Optional[bool] = None
    nee_external: bool = False
    kernel_energy_comp: bool = True
    cluster_noprune: bool = False


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Frame-level settings of real-time mode (pt/realtime.py; see
    rtxpt_tpu/config.py for each field's reference analog). ReSTIR
    (`restir` other than "none") is not ported: the frames refuse it by
    name; `restir_regir` is read only with it, and `frame_gen`, `spp` and
    `accumulation_limit` are not read by the frames, as in the JAX
    package."""

    width: int = 512
    height: int = 512
    spp: int = 1
    exposure: float = 1.0
    tonemap: str = "aces"            # "aces" | "reinhard" | "linear" | "none"
    denoiser: DenoiserMode = DenoiserMode.NONE
    enable_taa: bool = False
    enable_bloom: bool = False
    accumulation_limit: int = 0
    render_scale: float = 1.0
    split_denoise: bool = False
    restir: str = "none"             # "none" | "di" | "digi"
    restir_regir: bool = False
    frame_gen: int = 0
