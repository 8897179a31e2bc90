"""Fused per-bounce step: intersect + shade + NEE + scatter, one launch per
bounce (counterpart of rtxpt_tpu/pt/bounce_pallas.py).

The JAX package runs this step as the Pallas TPU kernel `_bounce_kernel`
(bounce_pallas.py:1389, launched by `_bounce_call`). Here it is
`csrc/bounce_fused.cu`, written by hand for Hopper (sm_90a), with
`bounce_reference` below as its plain PyTorch version. `bounce` is the
wrapper: the CUDA kernel for CUDA tensors, the plain version for CPU
tensors, and an exception for anything else.

What is ported is the reference-mode configuration of the kernel:
scenes of at most 2048 triangles, NEE off / uniform / power with one
candidate inside the kernel (nee slots 0-2, at most 128 lights), or the
external-NEE slots 3-5 (NEE-AT, uniform, power), in which the kernel
exports the shaded surface (the SF_* rows), pt/nee_external.py selects
and evaluates the light, and the shadow kernel K2 (`occlusion`,
csrc/shadow_occlusion.cu, the TPU kernel `_shadow_kernel`) resolves the
shadow rays; that route takes any number of lights. With an environment
light the tables carry the environment table (`build_env_table`, the
JAX package's env_rows without the TPU layout): a miss gathers the
environment with its MIS weight, the environment light is
importance-sampled from the table's two-level CDF, and
`trace_paths_fused` closes each path with the final environment-only
launch (`final_env`). With a texture atlas (`build_tex_tables`) and
stochastic texture filtering on (`KernelConfig.stf`, the JAX package's
rule), the `has_tex` variant fetches the materials' base-colour,
metal-rough, emissive and normal maps at the ray cone's MIP, one jittered
texel each (`tex_fetch`), and perturbs the shading normal in the
triangle's UV tangent frame. With opacity micromaps (`BounceTables.omm`,
scene/omm.py) the `omm` variant rejects micro-TRANSPARENT candidates in
the closest-hit loop, lets a hit on an UNKNOWN micro-cell whose base
alpha at MIP 0 fails its material's cutoff pass through (the lane keeps
its path state and logical bounce and continues the same ray on the next
iteration, for which `trace_paths_fused` runs
`cfg.passthrough_extra_iters` more iterations), and resolves UNKNOWN
cells in shadow rays stochastically against the baked coverage; K2 does
the same for the external route's shadow rays. With nested dielectric
priorities (`BounceTables.prio`: some material's MT_PRIO row is not 0)
the `prio` variant treats a hit on a lower-priority medium's boundary
while inside a higher one (a false entry), or on the back of a medium
the ray is not in (a false exit), as a false hit: the interior list's
lower slot (IS_MED1) is updated and the lane passes through, as on an
alpha test. With `cfg.split_channels` the split variant carries NRD's
diffuse/specular partition in the split rows fs2 (F2_*), and
`trace_paths_fused` returns L_diff and L_spec beside L, and with
`want_aux` the first hit's guide buffers (`first_hit_aux`). For
real-time mode's stable-planes fill `trace_paths_fused` takes a V-buffer
restart: bounce 0 runs K1's restart instantiations
(`csrc/bounce_fused_restart.cu`, the TPU kernel's `inject`) on the
injected rows (`pack_injection`) instead of the intersection loop, with
per-lane bounce budgets in IS_BUDGET, and `first_direct=False` leaves the
first vertex's direct light out. Sphere and environment-quad lights are
the general tier's (`build_bounce_tables` raises NotImplementedError for
them).

Layouts are the JAX package's, minus the TPU tiling: the wavefront state
is fs [NF, N] f32 and is_ [NI, N] i32 (one column per ray; rows FS_* and
IS_*), and the scene tables keep the AT_* / MT_* / LROW_* rows, so tables
and state compare entry by entry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from rtxpt_tpu_torch import kernels
from rtxpt_tpu_torch.lighting.envmap import count_le
from rtxpt_tpu_torch.pt import wide as W
from rtxpt_tpu_torch.pt.surface import ray_offset
from rtxpt_tpu_torch.scene.omm import micro_index, micro_state
from rtxpt_tpu_torch.utils import rng

# Geometry / table capacities
MAX_TRIS = 2048
MAX_LIGHTS = 128
MAX_MATERIALS = 128
_BIG = 1e30

# fs (f32 state) rows
FS_O = 0                # 0:3 ray origin
FS_D = 3                # 3:6 ray direction
FS_THP = 6              # 6:9 throughput
FS_L = 9                # 9:12 accumulated radiance
FS_PREVPDF = 12
FS_CONE = 13            # ray-cone width accumulated so far
FS_SPREAD = 14          # ray-cone spread angle
NF = 15

# is_ (i32 state) rows
IS_ACTIVE = 0
IS_PREVDELTA = 1
IS_MED0 = 2
IS_MED1 = 3
IS_PX = 4
IS_PY = 5
IS_BUDGET = 6           # per-lane remaining-bounce budget
IS_LBOUNCE = 7          # per-lane logical bounce index
NI = 8

# hit_out rows: t (0 on a miss), prim (-1 on a miss), u, v, front, do_nee
NH = 6
# Split-channel rows fs2 [NF2, N] (cfg.split_channels; bounce_pallas.py
# fs2): the diffuse and specular radiance, and whether the first scatter
# took a specular lobe (1.0) or not (0.0)
F2_LD = 0               # 0:3 L_diff
F2_LS = 3               # 3:6 L_spec
F2_FSPEC = 6
NF2 = 7

_NO_BUDGET = 0x3FFFFFFF
# The injected V-buffer rows inj [NINJ, N] of a restart (bounce_pallas.py
# :1813-1822): hit distance, triangle (-1 = miss), barycentrics, front face
INJ_T = 0
INJ_PRIM = 1
INJ_U = 2
INJ_V = 3
INJ_FRONT = 4
NINJ = 5

# attr table rows (one column per triangle)
AT_N0 = 0
AT_N1 = 3
AT_N2 = 6
AT_GN = 9
AT_MID = 12
AT_LPDF = 13
AT_LAREA = 14
AT_ISLIGHT = 15
AT_UV0 = 16
AT_UV1 = 18
AT_UV2 = 20
AT_LODB = 22
AT_LID = 23
AT_TANG = 24
AT_TSGN = 27
AT_ROWS = 28

# material table rows (one column per material)
MT_BASE = 0
MT_METAL = 3
MT_ROUGH = 4
MT_IOR = 5
MT_TRANS = 6
MT_DTRANS = 7
MT_EMISSIVE = 8
MT_SPEC = 11
MT_THIN = 12
MT_VOLABS = 13
MT_EPOLY = 16           # 16:22 Kulla-Conty E(mu) polynomial
MT_EAVG = 22
MT_BTEX = 23
MT_MRTEX = 24
MT_ETEX = 25
MT_NTEX = 26
MT_ACUT = 27
MT_PRIO = 28
MT_ROWS = 29

# Compact per-triangle intersection coefficients (tri_coef [Tpad, TC_ROWS]),
# the tri_rows coefficients regrouped per triangle for the CUDA kernel:
# det = TC_DET.d; u = TC_U.[d, oxd]; v = TC_V.[d, oxd]; t = TC_T.[o, 1]
TC_DET = 0              # 0:3
TC_U = 3                # 3:9
TC_V = 9                # 9:15
TC_T = 15               # 15:19
TC_ROWS = 20            # one pad column (80-byte rows)

# External-NEE surface export rows (surf [SF_ROWS, N]; the kernel's
# external modes write them, pt/nee_external.py reads them)
SF_POS = 0              # 0:3 shading position
SF_SHN = 3              # 3:6 shading normal
SF_GN = 6               # 6:9 geometric normal (ray-facing)
SF_MID = 9              # material id
SF_BASE = 10            # 10:13 base color
SF_METAL = 13
SF_ROUGH = 14
SF_ETA = 15             # relative IoR at this crossing
SF_THP = 16             # 16:19 throughput at the surface (post-volume)
SF_EMIT = 19            # 19:22 unweighted emission thp * Le (NEE-AT only)
SF_PGEO = 22            # area -> solid angle jacobian of a light hit
SF_LID = 23             # the hit triangle's light id (-1 none)
SF_ROWS = 24

# Shadow-request rows of the shadow kernel K2 (sh [SR_ROWS, N])
SR_O = 0                # 0:3 origin
SR_D = 3                # 3:6 direction
SR_DIST = 6             # occluders count in (0, dist)
SR_DO = 7               # 1 = a request; a lane without one reads occluded
SR_UA = 8               # the stochastic alpha uniform (opacity micromaps)
SR_ROWS = 9

EXTERNAL_MODES = (3, 4, 5)

# Environment table (env [ET_SIZE] f32, flat): the JAX package's
# [EV_ROWS,128] env_rows (bounce_pallas.build_env_rows) without the TPU
# layout: texels row-major, y (polar) then x (azimuth), as float4
ENV_H = 64
ENV_W = 128
ET_TEX = 0                          # [ENV_H, ENV_W, 4] r, g, b, texel pdf
ET_COND = ET_TEX + ENV_H * ENV_W * 4    # [ENV_H, ENV_W] conditional CDFs
ET_ROWCDF = ET_COND + ENV_H * ENV_W     # [ENV_H] row-marginal CDF
ET_COSB = ET_ROWCDF + ENV_H         # [ENV_H] cos(pi i / ENV_H); [0] = -2
ET_SA = ET_COSB + ENV_H             # [ENV_H] texel solid angle per row
ET_COS = ET_SA + ENV_H              # cos(rotation)
ET_SIN = ET_COS + 1                 # sin(rotation)
ET_SELPDF = ET_COS + 2              # power-mode selection pmf of the env
ET_SIZE = ET_COS + 64
# the JAX layout's row offsets (bounce_pallas.py EV_* / EVA_*)
_EV_CT, _EV_CONDT, _EV_COSB, _EV_AUX = 0, 512, 768, 896

# Texture tables: the atlas as one flat [texels, 4] f32 RGBA array (the
# JAX package's TextureAtlas.data, padded like its tex_ct to a multiple of
# 1024 texels) and one int32 meta row per texture: base width, height,
# MIP count and the 14 MIP start texels. The JAX kernel's transposed
# [4*128, TR] atlas exists for its one-hot matmul gather; a thread reads
# a texel as one float4.
TX_W = 0
TX_H = 1
TX_NMIPS = 2
TX_OFF = 3                 # 3:17 start texel of MIP k
TX_COLS = 17
TEX_MAX_TEXELS = 512 * 128  # the JAX package's cap: 64k texels, all MIPs
TEX_MAX_COUNT = 128
TEX_MAX_MIPS = 14

# Effect seeds (same as rtxpt_tpu/pt/integrator.py)
EFFECT_SCATTER = 29
EFFECT_NEE = 31
EFFECT_RR = 37
EFFECT_STF = 41
EFFECT_ALPHA = 43

# Opacity micromaps (scene/omm.py): the states of a level-2 micro-triangle
MICRO_OPAQUE, MICRO_UNKNOWN, MICRO_TRANSPARENT = 0, 1, 2


@dataclass(frozen=True)
class BounceTables:
    """Scene tables of the fused bounce step (built at scene prep)."""

    tri_rows: torch.Tensor    # [G*Tpad, 128] the JAX package's operand rows
    #                           (G = 4 groups per chunk, 7 with micromaps)
    attr_rows: torch.Tensor   # [AT_ROWS, Tpad]
    mat_rows: torch.Tensor    # [MT_ROWS, 128]
    light_rows: torch.Tensor  # [W.LROWS, 128]
    tri_coef: torch.Tensor    # [Tpad, TC_ROWS] what the kernel reads
    env: Optional[torch.Tensor] = None   # [ET_SIZE] (an environment light)
    tex: Optional[torch.Tensor] = None       # [texels, 4] texture atlas
    tex_meta: Optional[torch.Tensor] = None  # [T, TX_COLS] i32
    # which maps any material binds: (base, metal_rough, emissive, normal)
    tex_maps: tuple = (0, 0, 0, 0)
    tc: int = 128
    n_chunks: int = 1
    n_lights: int = 0
    n_tris: int = 0
    # opacity micromaps: the kernels reject micro-TRANSPARENT hits in the
    # intersection loop, test UNKNOWN ones against the texture at shading
    # time and in shadow rays against the coverage; per triangle one u32
    # word (stored as i32) and one f32 coverage, [Tpad] each (the JAX
    # package's tri_rows carry them as 16-bit halves for its matrix unit)
    omm: bool = False
    tri_micro: Optional[torch.Tensor] = None
    tri_cover: Optional[torch.Tensor] = None
    # nested dielectric priorities: some material's MT_PRIO row is not 0,
    # and the shading kernels run the false-hit pass-through
    # (bounce_pallas.py:231-233)
    prio: bool = False

    @property
    def device(self):
        return self.attr_rows.device


@dataclass(frozen=True)
class KernelConfig:
    """The bounce step's static switches (bounce_pallas._cfg_key, plus the
    logical-bounce limit)."""

    nee_mode: int = 2          # 0 off | 1 uniform | 2 power | 3 NEE-AT |
    #                            4 uniform-external | 5 power-external
    enable_mis: bool = True
    firefly: float = 0.0
    rr_enable: bool = True
    min_rr: int = 2
    max_travel: float = 1.0e27
    low_discrepancy: bool = True
    energy_comp: bool = True
    maxb: int = 6
    stf: bool = False          # stochastic texture filtering: the texture
    #                            switch runs only with it (use_tex)

    @property
    def external(self) -> bool:
        return self.nee_mode in EXTERNAL_MODES

    @staticmethod
    def from_cfg(cfg) -> "KernelConfig":
        mode = int(cfg.nee.value)
        if getattr(cfg, "nee_external", False) and mode in (1, 2):
            mode += 3
        return KernelConfig(
            nee_mode=mode, enable_mis=bool(cfg.enable_mis),
            firefly=float(cfg.firefly_clamp),
            rr_enable=bool(cfg.enable_russian_roulette),
            min_rr=int(cfg.min_bounces_before_rr),
            max_travel=float(cfg.max_ray_travel),
            low_discrepancy=bool(cfg.low_discrepancy),
            energy_comp=bool(cfg.kernel_energy_comp),
            maxb=int(cfg.max_bounces),
            stf=bool(cfg.stochastic_texture_filtering))


def use_tex(tables, kcfg: KernelConfig) -> bool:
    """Whether a shading kernel runs its texture switch: the tables carry
    the texture atlas and stochastic texture filtering is on
    (bounce_pallas.py:1827-1829, bounce_clustered.py:1569-1571)."""
    return tables.tex is not None and kcfg.stf


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def pack_materials(materials) -> np.ndarray:
    """[MT_ROWS, 128] lane table: one column per material."""
    base = _np(materials.base_color)
    n = len(base)
    mat = np.zeros((MT_ROWS, 128), np.float32)
    mat[MT_BASE:MT_BASE + 3, :n] = base.T
    mat[MT_METAL, :n] = _np(materials.metallic)
    mat[MT_ROUGH, :n] = _np(materials.roughness)
    mat[MT_IOR, :n] = _np(materials.ior)
    mat[MT_TRANS, :n] = _np(materials.transmission)
    mat[MT_DTRANS, :n] = _np(materials.diffuse_transmission)
    mat[MT_EMISSIVE:MT_EMISSIVE + 3, :n] = _np(materials.emissive).T
    mat[MT_SPEC, :n] = _np(materials.specular_f0_scale)
    mat[MT_THIN, :n] = _np(materials.thin)
    mat[MT_VOLABS:MT_VOLABS + 3, :n] = _np(materials.volume_absorption).T
    from rtxpt_tpu_torch.pt.bsdf import bake_e_poly_np
    r = _np(materials.roughness).astype(np.float64)
    e_poly, e_avg = bake_e_poly_np(np.clip(r * r, 0.0, 1.0))
    mat[MT_EPOLY:MT_EPOLY + 6, :n] = e_poly
    mat[MT_EAVG, :n] = e_avg
    mat[MT_BTEX:MT_ACUT + 1, :] = -1.0
    mat[MT_ACUT, :n] = _np(materials.alpha_cutoff)
    mat[MT_PRIO, :n] = _np(materials.nested_priority)
    for row, arr in ((MT_BTEX, materials.base_color_tex),
                     (MT_MRTEX, materials.metal_rough_tex),
                     (MT_ETEX, materials.emissive_tex),
                     (MT_NTEX, materials.normal_tex)):
        mat[row, :n] = _np(arr)
    return mat


def pack_lights(lights) -> np.ndarray:
    """[W.LROWS, 128] lane table: one column per light, the first 128 (a
    scene with more takes the external-NEE route, which never selects
    from this table; the per-triangle AT_LPDF / AT_LID rows cover every
    light)."""
    n = min(int(lights.num), MAX_LIGHTS)
    lt = np.zeros((W.LROWS, 128), np.float32)
    lt[W.LROW_CDF, :] = 1.0
    lt[W.LROW_KIND, :n] = _np(lights.kind)[:n]
    for row, field in ((W.LROW_P0, lights.p0), (W.LROW_P1, lights.p1),
                       (W.LROW_P2, lights.p2), (W.LROW_EM, lights.emission),
                       (W.LROW_NORMAL, lights.normal)):
        lt[row:row + 3, :n] = _np(field)[:n].T
    lt[W.LROW_EXTRA:W.LROW_EXTRA + 4, :n] = _np(lights.extra)[:n].T
    lt[W.LROW_POWER, :n] = _np(lights.power)[:n]
    lt[W.LROW_CDF, :n] = _np(lights.cdf)[:n]
    return lt


def compact_coefficients(tri_rows: np.ndarray, tc: int, n_chunks: int,
                         omm: bool = False):
    """tri_rows [G*Tpad, 128] -> tri_coef [Tpad, TC_ROWS]: the same
    coefficients, one contiguous row per triangle; with `omm` (G = 7: the
    micromap word's 16-bit halves and the coverage ride groups 4-6 at the
    constant-1 column 9) also (tri_micro [Tpad] i32, the u32 word's bits,
    tri_cover [Tpad] f32)."""
    tri_rows = np.asarray(tri_rows, np.float32)
    ng = 7 if omm else 4
    coef = np.zeros((tc * n_chunks, TC_ROWS), np.float32)
    words = np.zeros((tc * n_chunks,), np.int64)
    cover = np.zeros((tc * n_chunks,), np.float32)
    for c in range(n_chunks):
        g = tri_rows[ng * c * tc:ng * (c + 1) * tc].reshape(ng, tc, 128)
        rows = slice(c * tc, (c + 1) * tc)
        coef[rows, TC_DET:TC_DET + 3] = g[0, :, 0:3]
        coef[rows, TC_U:TC_U + 6] = g[1, :, 0:6]
        coef[rows, TC_V:TC_V + 6] = g[2, :, 0:6]
        coef[rows, TC_T:TC_T + 4] = g[3, :, 6:10]
        if omm:
            words[rows] = g[4, :, 9].astype(np.int64) \
                | (g[5, :, 9].astype(np.int64) << 16)
            cover[rows] = g[6, :, 9]
    if not omm:
        return coef
    return coef, words.astype(np.uint32).view(np.int32), cover


def tables_from_numpy(tri_rows, attr_rows, mat_rows, light_rows, tc,
                      n_chunks, n_lights, n_tris, device="cuda",
                      env_rows=None, tex_ct=None, tex_meta=None,
                      tex_maps=(0, 0, 0, 0), omm=False,
                      prio=False) -> BounceTables:
    """BounceTables on `device` (the GPU by default; raises without one)
    from the JAX layout's numpy arrays; `env_rows` is the JAX package's
    [EV_ROWS, 128] environment table or the port's [ET_SIZE] one;
    `tex_ct` / `tex_meta` the JAX package's texture tables ([4*128, TR]
    and [TXM_ROWS, 128]) or the port's (`build_tex_tables`), with
    `tex_maps` the materials' map flags; `omm`: tri_rows carry the
    micromap groups (7 per chunk); `prio`: the materials declare nested
    priorities (the JAX BounceTables.prio)."""
    import rtxpt_tpu_torch

    device = rtxpt_tpu_torch.device(device)

    def t(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    tex = meta = None
    if (tex_ct is None) != (tex_meta is None):
        raise ValueError("texture tables need both tex_ct and tex_meta")
    if tex_ct is not None:
        tex, meta = tex_tables(tex_ct, tex_meta)
        tex, meta = t(tex), torch.tensor(meta, device=device)
    omm = bool(omm)
    ng = 7 if omm else 4
    if np.shape(tri_rows) != (ng * int(tc) * int(n_chunks), 128):
        raise ValueError(f"tri_rows: expected {ng} row groups per chunk "
                         f"({'with' if omm else 'without'} omm), got shape "
                         f"{list(np.shape(tri_rows))}")
    coef = compact_coefficients(tri_rows, int(tc), int(n_chunks), omm)
    micro = cover = None
    if omm:
        coef, micro, cover = coef
        micro = torch.tensor(micro, device=device)
        cover = t(cover)
    return BounceTables(
        tri_rows=t(tri_rows), attr_rows=t(attr_rows), mat_rows=t(mat_rows),
        light_rows=t(light_rows), tri_coef=t(coef),
        omm=omm, tri_micro=micro, tri_cover=cover, prio=bool(prio),
        env=None if env_rows is None else t(env_table(env_rows)),
        tex=tex, tex_meta=meta,
        tex_maps=tuple(int(x) for x in tex_maps) if tex is not None
        else (0, 0, 0, 0),
        tc=int(tc), n_chunks=int(n_chunks), n_lights=int(n_lights),
        n_tris=int(n_tris))


def tex_maps_of(materials) -> tuple:
    """(base, metal_rough, emissive, normal): 1 where some material binds
    that map (bounce_pallas._tex_maps_of)."""
    def has(arr):
        return int(arr is not None and int(np.max(_np(arr))) >= 0)
    return (has(materials.base_color_tex), has(materials.metal_rough_tex),
            has(materials.emissive_tex), has(materials.normal_tex))


def build_tex_tables(atlas):
    """(tex [texels, 4] f32, meta [T, TX_COLS] i32) of a TextureAtlas for
    the kernels' texture switch, or None where the JAX package's
    build_tex_tables refuses the atlas: more than 64k texels (all MIPs),
    more than 128 textures, more than 14 MIPs, or a width or height that
    is not a power of two (the kernels halve each MIP exactly)."""
    if atlas is None:
        return None
    data = _np(atlas.data).astype(np.float32)
    texels = data.shape[0]
    padded = _round_up(_round_up(max(texels, 128), 128) // 128, 8) * 128
    widths, heights = _np(atlas.width), _np(atlas.height)
    nmips = _np(atlas.n_mips)
    if padded > TEX_MAX_TEXELS or atlas.count > TEX_MAX_COUNT or \
            int(nmips.max(initial=0)) > TEX_MAX_MIPS:
        return None
    if np.any(widths & (widths - 1)) or np.any(heights & (heights - 1)):
        return None
    tex = np.zeros((padded, 4), np.float32)
    tex[:texels] = data
    meta = np.zeros((atlas.count, TX_COLS), np.int32)
    meta[:, TX_W], meta[:, TX_H], meta[:, TX_NMIPS] = widths, heights, nmips
    meta[:, TX_OFF:TX_OFF + TEX_MAX_MIPS] = \
        _np(atlas.mip_offset)[:, :TEX_MAX_MIPS]
    return tex, meta


def tex_tables(tex_ct, tex_meta):
    """The port's (tex, meta) from the JAX package's texture tables
    (tex_ct [4*128, TR]: tex_ct[c*128 + l, q] = texel q*128 + l, channel c;
    tex_meta [TXM_ROWS, 128], lane = texture), or port tables as they
    are."""
    tex_ct, tex_meta = np.asarray(tex_ct), np.asarray(tex_meta)
    if tex_ct.ndim == 2 and tex_ct.shape[1] == 4 and \
            tex_meta.shape[-1] == TX_COLS:
        return tex_ct.astype(np.float32), tex_meta.astype(np.int32)
    tr = tex_ct.shape[1]
    tex = tex_ct.reshape(4, 128, tr).transpose(2, 1, 0).reshape(tr * 128, 4)
    count = int((tex_meta[TX_W] > 0).sum())
    meta = tex_meta[:TX_COLS, :count].T      # TXM_W, H, NMIPS, OFF rows
    return np.ascontiguousarray(tex, np.float32), \
        np.rint(meta).astype(np.int32)


def build_env_table(envmap, sel_pdf: float) -> Optional[np.ndarray]:
    """The kernels' environment table [ET_SIZE] from an EnvMap baked at
    exactly (ENV_H, ENV_W), with `sel_pdf` the environment light's power
    selection pmf; None for another resolution (bounce_pallas.
    build_env_rows, whose values it holds)."""
    img = _np(envmap.image)
    if img.shape[:2] != (ENV_H, ENV_W):
        return None
    tab = np.zeros((ET_SIZE,), np.float32)
    tex = np.concatenate([img, _np(envmap.texel_pdf)[..., None]], -1)
    tab[ET_TEX:ET_COND] = tex.reshape(-1)
    tab[ET_COND:ET_ROWCDF] = _np(envmap.cond_cdf).reshape(-1)
    tab[ET_ROWCDF:ET_COSB] = _np(envmap.row_cdf)
    tab[ET_COSB] = -2.0
    for i in range(1, ENV_H):
        tab[ET_COSB + i] = np.cos(np.pi * i / ENV_H)
    theta = (np.arange(ENV_H) + 0.5) / ENV_H * np.pi
    tab[ET_SA:ET_COS] = (2.0 * np.pi / ENV_W) * (np.pi / ENV_H) * \
        np.maximum(np.sin(theta), 1e-6)
    tab[ET_COS] = float(envmap.cos_rot)
    tab[ET_SIN] = float(envmap.sin_rot)
    tab[ET_SELPDF] = sel_pdf
    return tab


def env_table(rows) -> np.ndarray:
    """The port's environment table [ET_SIZE] from the JAX package's
    env_rows [EV_ROWS, 128] (or a port table, returned as it is)."""
    rows = np.asarray(rows, np.float32)
    if rows.shape == (ET_SIZE,):
        return rows
    tab = np.zeros((ET_SIZE,), np.float32)
    planes = rows[_EV_CT:_EV_CT + 512, :ENV_H].reshape(4, ENV_W, ENV_H)
    tab[ET_TEX:ET_COND] = planes.transpose(2, 1, 0).reshape(-1)
    tab[ET_COND:ET_ROWCDF] = rows[_EV_CONDT:_EV_CONDT + ENV_W, :ENV_H] \
        .T.reshape(-1)
    tab[ET_ROWCDF:ET_COSB] = rows[_EV_AUX, :ENV_H]
    tab[ET_COSB:ET_SA] = rows[_EV_COSB:_EV_COSB + ENV_H, 0]
    tab[ET_SA:ET_COS] = rows[_EV_AUX + 1, :ENV_H]
    tab[ET_COS:ET_SELPDF + 1] = rows[_EV_AUX + 2:_EV_AUX + 5, 0]
    return tab


def env_table_serves(lights, envmap) -> bool:
    """Whether the kernels' environment table can hold the lights'
    environment: there is none, or its map is at (ENV_H, ENV_W)."""
    return lights.env_light < 0 or (
        envmap is not None and tuple(envmap.shape) == (ENV_H, ENV_W))


def lights_env_table(lights, envmap) -> Optional[np.ndarray]:
    """The environment table of a light list with an environment light
    (its selection pmf folded in), None without one; raises ValueError for
    an environment map that is not at the kernels' 64 x 128."""
    if not env_table_serves(lights, envmap):
        raise ValueError(f"the kernels' environment table needs the "
                         f"environment baked at ({ENV_H}, {ENV_W}); "
                         f"prepare(env_res='auto') does so")
    if lights.env_light < 0:
        return None
    return build_env_table(envmap, float(_np(lights.power)[lights.env_light]))


def build_bounce_tables(positions, normals, indices, tri_material,
                        materials, lights, uvs=None, envmap=None,
                        textures=None, device="cuda", tri_micromap=None,
                        tri_cover=None):
    """Host-side table bake (bounce_pallas.build_bounce_tables) onto
    `device` (the GPU by default; raises without one),
    with the environment table when the lights hold an environment light
    (`envmap` baked at 64 x 128) and the texture tables of `textures` (a
    TextureAtlas) when `build_tex_tables` takes it; an atlas it refuses
    leaves the tables without textures, and dispatch then names the cap.
    `tri_micromap` ([T] u32 level-2 micromap words, scene/omm.py, the
    TRANSPARENT triangles already dropped) and `tri_cover` ([T] f32) add
    the micromap row groups (7 per chunk, the JAX layout).
    Raises
    NotImplementedError, naming the feature, for a scene it does not
    take: sphere and environment-quad lights (the JAX package leaves them
    to the general tier), anisotropic materials, too many triangles or
    materials."""
    if float(np.max(_np(materials.anisotropy), initial=0.0)) > 0.0:
        raise NotImplementedError("anisotropic materials are not ported "
                                  "to the fused bounce kernel")
    from rtxpt_tpu_torch.lighting.lights_baker import (
        KIND_ENVQUAD, KIND_SPHERE)
    if np.any(np.isin(_np(lights.kind), [KIND_SPHERE, KIND_ENVQUAD])):
        raise NotImplementedError("sphere and environment-quad lights: "
                                  "the general tier samples them")
    env = lights_env_table(lights, envmap)
    positions = np.asarray(positions, np.float32)
    normals = np.asarray(normals, np.float32)
    indices = np.asarray(indices, np.int32)
    tri_material = np.asarray(tri_material, np.int32)
    t = len(indices)
    n_mats = len(_np(materials.base_color))
    if t == 0 or t > MAX_TRIS:
        raise NotImplementedError(
            f"{t} triangles: the fused bounce kernel takes 1..{MAX_TRIS}")
    if n_mats > MAX_MATERIALS:
        raise NotImplementedError(
            f"{n_mats} materials: the fused bounce kernel takes at most "
            f"{MAX_MATERIALS}")

    v0 = positions[indices[:, 0]]
    v1 = positions[indices[:, 1]]
    v2 = positions[indices[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)

    mat = pack_materials(materials)
    lt = pack_lights(lights)

    # chunk depth rounds to 8 triangles (bounce_pallas.py:471-477)
    tc = min(512, _round_up(t, 8))
    tpad = _round_up(t, tc)
    n_chunks = tpad // tc

    # per chunk c, row groups [det|u|v|t] x tc against the ray column
    # [d | oxd | o | 1]; with micromaps three more, [wlo|whi|cover], whose
    # only coefficient sits at the constant-1 column 9
    omm = tri_micromap is not None
    ng = 7 if omm else 4
    tri_rows = np.zeros((ng * tpad, 128), np.float32)
    v0xe2 = np.cross(v0, e2)
    v0xe1 = np.cross(v0, e1)
    v0n = np.einsum("tj,tj->t", v0, n)
    if omm:
        mm_w = np.asarray(tri_micromap).astype(np.uint32)
        mm_lo = (mm_w & np.uint32(0xFFFF)).astype(np.float32)
        mm_hi = (mm_w >> np.uint32(16)).astype(np.float32)
        mm_cov = (np.asarray(tri_cover, np.float32) if tri_cover is not None
                  else np.ones((t,), np.float32))
    for c in range(n_chunks):
        lo = c * tc
        hi = min(lo + tc, t)
        w = hi - lo
        if w <= 0:
            continue
        base = ng * c * tc
        tri_rows[base:base + w, 0:3] = -n[lo:hi]
        tri_rows[base + tc:base + tc + w, 0:3] = v0xe2[lo:hi]
        tri_rows[base + tc:base + tc + w, 3:6] = e2[lo:hi]
        tri_rows[base + 2 * tc:base + 2 * tc + w, 0:3] = -v0xe1[lo:hi]
        tri_rows[base + 2 * tc:base + 2 * tc + w, 3:6] = -e1[lo:hi]
        tri_rows[base + 3 * tc:base + 3 * tc + w, 6:9] = n[lo:hi]
        tri_rows[base + 3 * tc:base + 3 * tc + w, 9] = -v0n[lo:hi]
        if omm:
            tri_rows[base + 4 * tc:base + 4 * tc + w, 9] = mm_lo[lo:hi]
            tri_rows[base + 5 * tc:base + 5 * tc + w, 9] = mm_hi[lo:hi]
            tri_rows[base + 6 * tc:base + 6 * tc + w, 9] = mm_cov[lo:hi]

    gn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)
    attr = np.zeros((AT_ROWS, tpad), np.float32)
    attr[AT_N0:AT_N0 + 3, :t] = normals[indices[:, 0]].T
    attr[AT_N1:AT_N1 + 3, :t] = normals[indices[:, 1]].T
    attr[AT_N2:AT_N2 + 3, :t] = normals[indices[:, 2]].T
    attr[AT_GN:AT_GN + 3, :t] = gn.T
    attr[AT_MID, :t] = tri_material.astype(np.float32)
    tri_light = _np(lights.tri_light)
    has_l = tri_light[:t] >= 0
    li = np.maximum(tri_light[:t], 0)
    attr[AT_LPDF, :t] = np.where(has_l, _np(lights.power)[li], 0.0)
    attr[AT_LAREA, :t] = np.where(has_l, _np(lights.extra)[li, 0], 1.0)
    attr[AT_ISLIGHT, :t] = has_l.astype(np.float32)
    attr[AT_LID, :t] = tri_light[:t].astype(np.float32)
    if uvs is not None:
        # texture coordinates, and the UV tangent frame of normal mapping
        uvs = np.asarray(uvs, np.float32)
        attr[AT_UV0:AT_UV0 + 2, :t] = uvs[indices[:, 0]].T
        attr[AT_UV1:AT_UV1 + 2, :t] = uvs[indices[:, 1]].T
        attr[AT_UV2:AT_UV2 + 2, :t] = uvs[indices[:, 2]].T
        attr[AT_TANG:AT_TSGN + 1, :t] = _tangent_rows(uvs, indices, e1, e2)
    tri_area2 = np.linalg.norm(n, axis=-1)
    attr[AT_LODB, :t] = -0.5 * np.log2(np.maximum(tri_area2, 1e-20))

    tex = build_tex_tables(textures)
    return tables_from_numpy(tri_rows, attr, mat, lt, tc, n_chunks,
                             int(lights.num), t, device=device, env_rows=env,
                             tex_ct=None if tex is None else tex[0],
                             tex_meta=None if tex is None else tex[1],
                             tex_maps=tex_maps_of(materials), omm=omm,
                             prio=has_priorities(materials))


def has_priorities(materials) -> bool:
    """Whether some material has a nested priority other than 0
    (bounce_pallas.py:554-555): the tables' `prio` switch."""
    prio = getattr(materials, "nested_priority", None)
    return prio is not None and bool(np.any(_np(prio) != 0))


def _tangent_rows(uvs, indices, e1, e2):
    """[4, T]: UV tangent premultiplied by 1/det_uv, and sign(det_uv)."""
    t0 = uvs[indices[:, 0]]
    t1 = uvs[indices[:, 1]]
    t2 = uvs[indices[:, 2]]
    duv1 = t1 - t0
    duv2 = t2 - t0
    det_uv = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    ok = np.abs(det_uv) > 1e-12
    r = np.where(ok, 1.0 / np.where(ok, det_uv, 1.0), 0.0)
    tang = (duv2[:, 1:2] * e1 - duv1[:, 1:2] * e2) * r[:, None]
    tsgn = np.where(ok, np.sign(det_uv), 0.0)
    return np.concatenate([tang.T, tsgn[None]], 0).astype(np.float32)


# ---------------------------------------------------------------------------
# Plain PyTorch version of the kernel
# ---------------------------------------------------------------------------

_TRI_BLOCK = 64     # triangles per vectorized step of the plain intersect


def _coef_dot(c, k, xs):
    """sum_j c[:, k+j] * xs[j], summed left to right ([C,1] x [N])."""
    acc = c[:, k:k + 1] * xs[0]
    for j in range(1, len(xs)):
        acc = acc + c[:, k + j:k + j + 1] * xs[j]
    return acc


def _tri_params(c, o, d, oxd):
    """(ok, u, v, t) [C, N] of C triangles against N rays."""
    det = _coef_dot(c, TC_DET, (d[0], d[1], d[2]))
    u_num = _coef_dot(c, TC_U, (d[0], d[1], d[2], oxd[0], oxd[1], oxd[2]))
    v_num = _coef_dot(c, TC_V, (d[0], d[1], d[2], oxd[0], oxd[1], oxd[2]))
    t_num = _coef_dot(c, TC_T, (o[0], o[1], o[2])) + c[:, TC_T + 3:TC_T + 4]
    ok = torch.abs(det) > 1e-12
    inv = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    return ok, u_num * inv, v_num * inv, t_num * inv, det


def micro_states(tables: BounceTables, lo: int, hi: int, u, v):
    """The micromap states [C, N] of triangles lo..hi-1 at the candidate
    barycentrics u, v [C, N] (bounce_pallas._micro_state)."""
    return micro_state(tables.tri_micro[lo:hi, None], micro_index(u, v))


def _intersect(tables: BounceTables, o, d, tmax: float, omm: bool = False):
    """Closest hit over all triangles (bounce_pallas._intersect_group):
    strict `<` keeps the lowest triangle index on ties. With `omm`,
    micro-TRANSPARENT candidates are rejected in the loop. Returns
    (t, prim, u, v, det, unk), t = _BIG and prim = -1 on a miss, unk
    whether the winner's micro state is UNKNOWN."""
    n = o.shape[1]
    dev = o.device
    oxd = W.cross3(o, d)
    best_t = torch.full((n,), _BIG, dtype=torch.float32, device=dev)
    best_prim = torch.full((n,), -1, dtype=torch.int64, device=dev)
    best_u = torch.zeros((n,), dtype=torch.float32, device=dev)
    best_v = torch.zeros_like(best_u)
    best_det = torch.zeros_like(best_u)
    best_unk = torch.zeros((n,), dtype=torch.bool, device=dev)
    for lo in range(0, tables.n_tris, _TRI_BLOCK):
        hi = min(lo + _TRI_BLOCK, tables.n_tris)
        c = tables.tri_coef[lo:hi]
        ok, u, v, t, det = _tri_params(c, o, d, oxd)
        valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t > 0.0) & (t < tmax) & (t < best_t))
        if omm:
            st = micro_states(tables, lo, hi, u, v)
            valid = valid & (st != MICRO_TRANSPARENT)
            unk = st == MICRO_UNKNOWN
        t_m = torch.where(valid, t, _BIG)
        t_c = torch.amin(t_m, dim=0)
        iota = torch.arange(c.shape[0], device=dev)[:, None]
        j = torch.amin(torch.where(t_m <= t_c, iota, c.shape[0]), dim=0)
        hit_c = t_c < best_t
        jj = j.clamp(max=c.shape[0] - 1)[None]

        def pick(x):
            return torch.gather(x, 0, jj)[0]

        best_u = torch.where(hit_c, pick(u), best_u)
        best_v = torch.where(hit_c, pick(v), best_v)
        best_det = torch.where(hit_c, pick(det), best_det)
        best_prim = torch.where(hit_c, j + lo, best_prim)
        if omm:
            best_unk = torch.where(hit_c, pick(unk), best_unk)
        best_t = torch.where(hit_c, t_c, best_t)
    return best_t, best_prim, best_u, best_v, best_det, best_unk


def _occluded(tables: BounceTables, o, d, tmax, stats: bool = False,
              u_alpha=None):
    """Any hit in (0, tmax) per ray (bounce_pallas._occluded_group). On
    tables with micromaps (`u_alpha` [N], the per-ray alpha uniform)
    micro-TRANSPARENT candidates never occlude and UNKNOWN ones occlude
    where u_alpha < the triangle's coverage. With `stats`, also the
    ray-triangle pairs a ray tests in triangle order up to and including
    its first occluder (int64 [N])."""
    oxd = W.cross3(o, d)
    n = o.shape[1]
    occ = torch.zeros(n, dtype=torch.bool, device=o.device)
    tested = torch.full((n,), tables.n_tris, dtype=torch.int64,
                        device=o.device)
    for lo in range(0, tables.n_tris, _TRI_BLOCK):
        hi = min(lo + _TRI_BLOCK, tables.n_tris)
        c = tables.tri_coef[lo:hi]
        ok, u, v, t, _ = _tri_params(c, o, d, oxd)
        valid = (ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                 & (t > 0.0) & (t < tmax))
        if u_alpha is not None:
            st = micro_states(tables, lo, hi, u, v)
            valid = valid & (st != MICRO_TRANSPARENT) & (
                (st != MICRO_UNKNOWN)
                | (u_alpha < tables.tri_cover[lo:hi, None]))
        if stats:
            iota = torch.arange(c.shape[0], device=o.device)[:, None]
            first = torch.amin(torch.where(valid, iota, c.shape[0]), dim=0)
            tested = torch.where(~occ & (first < c.shape[0]),
                                 lo + first + 1, tested)
        occ = occ | valid.any(dim=0)
    return (occ, tested) if stats else occ


def _searchsorted128(cdf_row, u):
    """First index with cdf[i] >= u over the 128-lane CDF (pads are 1.0)."""
    lo = torch.zeros(u.shape, dtype=torch.int64, device=u.device)
    for bit in (64, 32, 16, 8, 4, 2, 1):
        c = cdf_row[torch.clamp(lo + bit - 1, 0, 127)]
        lo = lo + bit * (c < u).to(torch.int64)
    return torch.clamp(lo, 0, 127)


def _ray_offset(pos, gn, direction):
    """surface.ray_offset on [3, N] stacks."""
    return ray_offset(pos.T, gn.T, direction.T).T


# ----- the kernels' environment (bounce_pallas.py:721-875) -----


def atan2_poly(z, x):
    """atan2(z, x) in (-pi, pi] by the JAX kernels' minimax polynomial
    (bounce_pallas._atan2_w, |err| < 2e-5 rad): the texel column of a
    direction in K1 and K4; same coefficients, same order."""
    ax = torch.abs(x)
    az = torch.abs(z)
    mx = torch.maximum(ax, az)
    mn = torch.minimum(ax, az)
    t = mn / torch.clamp(mx, min=1e-30)
    t2 = t * t
    p = t * (0.99997726 + t2 * (-0.33262347 + t2 * (
        0.19354346 + t2 * (-0.11643287 + t2 * (
            0.05265332 - t2 * 0.01172120)))))
    p = torch.where(az > ax, 0.5 * math.pi - p, p)
    p = torch.where(x < 0.0, math.pi - p, p)
    return torch.where(z < 0.0, -p, p)


def env_texel_of_dir(env, d):
    """Directions d [3, N] -> texel (yi, xi) [N] int64: yi counts the
    row boundaries cos(pi i / 64) at or above d_y (no acos), xi is the
    polynomial atan2's column (bounce_pallas._env_idx_of_dir)."""
    cosb = env[ET_COSB + 1:ET_COSB + ENV_H]
    yi = torch.clamp((d[1][:, None] <= cosb[None]).sum(1), 0, ENV_H - 1)
    c, s = env[ET_COS], env[ET_SIN]
    xr = c * d[0] + s * d[2]
    zr = -s * d[0] + c * d[2]
    u = atan2_poly(zr, xr) * (1.0 / (2.0 * math.pi))
    u = u - torch.floor(u)
    xi = torch.clamp((u * ENV_W).to(torch.int64), 0, ENV_W - 1)
    return yi, xi


def _env_texel(env, yi, xi):
    """(radiance [3, N], texel pdf [N]) of texels (yi, xi)."""
    tex = env[ET_TEX:ET_COND].view(ENV_H * ENV_W, 4)[yi * ENV_W + xi]
    return tex[:, :3].T, tex[:, 3]


def env_eval_pdf(env, d, nee_uniform: bool, n_lights: int):
    """Radiance [3, N] of directions d [3, N] and the NEE pdf of sampling
    them (selection pmf, 1 / n_lights when uniform, times the texel pdf
    over its solid angle): bounce_pallas._env_eval_pdf."""
    yi, xi = env_texel_of_dir(env, d)
    rgb, pt = _env_texel(env, yi, xi)
    sa = env[ET_SA:ET_COS][yi]
    if nee_uniform:
        sel = torch.full_like(pt, 1.0 / float(max(n_lights, 1)))
    else:
        sel = env[ET_SELPDF].expand_as(pt)
    return rgb, sel * pt / sa


def env_sample_k(env, u1, u2):
    """The kernels' environment importance sample from uniforms [N]: the
    two-level CDF inversion of envmap.env_sample (the same texel and
    jitter from the same uniforms), bounce_pallas._env_sample_w. Returns
    (wi [3, N], radiance [3, N], source pdf [N])."""
    u1 = torch.clamp(u1, 0.0, 1.0 - 1e-7)
    u2 = torch.clamp(u2, 0.0, 1.0 - 1e-7)
    rowcdf = env[ET_ROWCDF:ET_COSB]
    yi = torch.clamp(count_le(rowcdf, u1), 0, ENV_H - 1)
    c_lo = torch.where(yi > 0, rowcdf[torch.clamp(yi - 1, min=0)], 0.0)
    c_hi = rowcdf[yi]
    jv = torch.clamp((u1 - c_lo) / torch.clamp(c_hi - c_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    cond = env[ET_COND:ET_ROWCDF].view(ENV_H, ENV_W)[yi]       # [N, W]
    xi = torch.clamp(count_le(cond, u2), 0, ENV_W - 1)
    d_lo = torch.where(xi > 0, torch.gather(
        cond, 1, torch.clamp(xi - 1, min=0)[:, None])[:, 0], 0.0)
    d_hi = torch.gather(cond, 1, xi[:, None])[:, 0]
    ju = torch.clamp((u2 - d_lo) / torch.clamp(d_hi - d_lo, min=1e-12),
                     0.0, 1.0 - 1e-6)
    u = (xi.to(torch.float32) + ju) * (1.0 / ENV_W)
    v = (yi.to(torch.float32) + jv) * (1.0 / ENV_H)
    phi = u * (2.0 * math.pi)
    theta = v * math.pi
    st = torch.sin(theta)
    x = st * torch.cos(phi)
    z = st * torch.sin(phi)
    y = torch.cos(theta)
    c, s = env[ET_COS], env[ET_SIN]
    wi = torch.stack([c * x - s * z, y, s * x + c * z])
    rgb, pt = _env_texel(env, yi, xi)
    return wi, rgb, pt / env[ET_SA:ET_COS][yi]


def tex_fetch(tex, meta, tid, uv_u, uv_v, mip, ju0, ju1):
    """The kernels' stochastic texel fetch per lane (bounce_pallas.
    _tex_fetch_w, whose arithmetic differs from scene/textures.py
    sample_texture_stochastic): level floor(mip + ju0) clipped to the
    texture's MIPs, the level's size as max(floor(w * 2^-level + 0.5), 1),
    the uv jittered by (ju - 0.5) / size and wrapped by u - floor(u), one
    texel. tid [N] i64 (-1: white), uv_u, uv_v, mip, ju0, ju1 [N] ->
    rgba [4, N]."""
    row = meta[torch.clamp(tid, 0, meta.shape[0] - 1)]          # [N, 17]
    level = torch.minimum(
        torch.clamp(torch.floor(mip + ju0).to(torch.int32), min=0),
        row[:, TX_NMIPS] - 1).long()
    p2 = 1.0 / (1 << level).to(torch.float32)          # 2^-level, exact
    wl = torch.clamp(torch.floor(row[:, TX_W].float() * p2 + 0.5), min=1.0)
    hl = torch.clamp(torch.floor(row[:, TX_H].float() * p2 + 0.5), min=1.0)
    off = row.gather(1, TX_OFF + level[:, None])[:, 0].long()
    u = uv_u + (ju0 - 0.5) / wl
    v = uv_v + (ju1 - 0.5) / hl
    u = u - torch.floor(u)
    v = v - torch.floor(v)
    wi, hi = wl.to(torch.int32), hl.to(torch.int32)
    xi = torch.minimum(torch.clamp((u * wl).to(torch.int32), min=0), wi - 1)
    yi = torch.minimum(torch.clamp((v * hl).to(torch.int32), min=0), hi - 1)
    rgba = tex[off + (yi * wi + xi).long()]
    return torch.where((tid >= 0)[:, None], rgba, 1.0).T


def surface_and_shade(*, o, d, t, hit, front, bu, bv, attr, thp, L,
                      prev_pdf, cone, spread, active, prev_delta, med0, med1,
                      px, py, budget, lb, tables: BounceTables,
                      kcfg: KernelConfig, sample_idx: int,
                      omm_unknown=None, prio: bool = False, ld=None,
                      ls=None, fspec=None, first_direct: bool = True):
    """Post-intersection bounce body (bounce_pallas.surface_and_shade): the
    environment of a
    miss with its MIS weight (when the tables carry the environment
    table), surface fetch, the texture switch (`use_tex`: base colour,
    metal-rough, emissive and normal maps, one stochastic texel each at
    the ray cone's MIP), volume absorption, emissive-hit MIS, one NEE
    light sample (the environment light included) + BSDF eval, BSDF
    scatter, medium stack, Russian roulette.
    With micromaps (`omm_unknown` [N] bool, whether the hit's micro state
    is UNKNOWN) the alpha uniform u_alpha (EFFECT_ALPHA) is drawn for the
    shadow test, and with the base-colour map on, an UNKNOWN hit whose
    base alpha at MIP 0 is under its material's cutoff passes through:
    the lane is not shaded, keeps its path state and logical bounce, and
    continues the same ray from just past the surface on the next
    wavefront iteration.
    With `prio` (nested dielectric priorities, bounce_pallas.py:1138-1156)
    a hit on the boundary of a non-thin transmissive material is false
    when it enters a medium of lower priority than the current one (med0)
    or leaves a medium other than the current one: the lower slot of the
    interior list (med1) takes the entered medium if it outranks med1's,
    or drops the left one if it is med1's, and the lane passes through as
    above (Beer-Lambert over the skipped segment still applies).
    `attr(i, k=1)` fetches the winner's attribute rows. Returns the next
    state, whether the lane was shaded, and the pending shadow ray
    (do_nee, shadow_o, shadow_d, sdist, contrib); the caller resolves
    occlusion. In the external modes (3-5) there is no shadow ray: the
    surface rows `surf` [SF_ROWS, N] go out instead, and in mode 3
    (NEE-AT) the emission with them, unweighted. csrc/bounce_fused.cuh
    holds the same function per ray.
    With the split channels (`ld`, `ls` [3, N] the diffuse and specular
    radiance so far, `fspec` [N] the first scatter's specular flag;
    bounce_pallas.py:987-1008, :1211-1215, :1281-1287, :1309-1313) the
    environment and the emission after the first vertex go to the lobe of
    the first scatter, the NEE contribution's diffuse part `cdiff` is its
    exact lobe share at logical bounce 0 and follows the first scatter
    after, and the scatter at logical bounce 0 of a shaded lane sets
    `fspec`; the result then holds ld, ls, fspec and cdiff.
    With `first_direct=False` (the stable-planes fill under an external
    direct-light pass, bounce_pallas.py:980-986, :1267-1268) the first
    vertex's direct light is left to the caller, per lane on the logical
    bounce: the environment and the emission that a ray gathers at logical
    bounce 1 are dropped, and NEE runs only past logical bounce 0."""
    split = ld is not None
    n_lights = tables.n_lights
    mode = kcfg.nee_mode
    use_nee = mode in (1, 2) and n_lights > 0
    ext_nee = mode in EXTERNAL_MODES and n_lights > 0
    nee_uniform = mode in (1, 4)
    # emissive-hit MIS with the baked per-triangle selection pdf: every
    # mode but NEE-AT, whose mixture pmf lives in the external tile state
    em_mis = mode in (1, 2, 4, 5) and n_lights > 0
    mat = tables.mat_rows
    lrows = tables.light_rows

    def lds(seed, dims):
        if kcfg.low_discrepancy:
            return rng.ld_samples(sample_idx, seed, dims)
        return tuple(rng.uniform_sample(seed, rng.hash_combine(sample_idx,
                                                               dd))
                     for dd in dims)

    seed_base = rng.hash_combine(rng.hash_combine(px, py), lb)

    def eff_seed(effect):
        return rng.hash_combine(seed_base, effect)

    hit_mask = active & hit
    # the lanes whose emission and environment count: all of them, or
    # without the first vertex's direct light not those at logical bounce 1
    em_gate = torch.ones_like(hit) if first_direct else lb != 1
    env = tables.env
    if env is not None:
        # HandleMiss: the environment, weighted against its NEE pdf
        mis_env = (use_nee or ext_nee) and kcfg.enable_mis
        env_L, p_env = env_eval_pdf(env, d, nee_uniform, n_lights)
        if mis_env:
            w_env = torch.where(prev_delta | (lb == 0), 1.0,
                                W.power_heuristic(prev_pdf, p_env))
        else:
            w_env = torch.ones_like(t)
        c_env = torch.where(active & ~hit & em_gate, thp * env_L * w_env,
                            0.0)
        L = L + c_env
        if split:
            cd = torch.where(fspec > 0.5, 0.0, c_env)
            ld = ld + cd
            ls = ls + (c_env - cd)
    active = active & hit                      # miss terminates
    not_expired = (lb < budget) & (lb < kcfg.maxb)
    active = active & not_expired
    hit_mask = hit_mask & not_expired

    pos = o + t * d
    gn = attr(AT_GN, 3)
    gn = torch.where(front, gn, -gn)
    n0 = attr(AT_N0, 3)
    n1 = attr(AT_N1, 3)
    n2 = attr(AT_N2, 3)
    bw = 1.0 - bu - bv
    sh_n = W.normalize3(bw * n0 + bu * n1 + bv * n2)
    sh_n = torch.where(W.dot3(sh_n, gn) > 0.0, sh_n, -sh_n)
    mid = torch.clamp(attr(AT_MID).to(torch.int64), 0, 127)

    def mrow(i):
        return mat[i][mid]

    def mrow3(i):
        return mat[i:i + 3][:, mid]

    base_color = mrow3(MT_BASE)
    metallic = mrow(MT_METAL)
    roughness = mrow(MT_ROUGH)
    transmission = mrow(MT_TRANS)
    dtrans = mrow(MT_DTRANS)
    emissive = mrow3(MT_EMISSIVE)
    spec_scale = mrow(MT_SPEC)
    thin = mrow(MT_THIN) > 0.5
    ior = mrow(MT_IOR)

    cone = cone + spread * torch.where(hit, t, 0.0)
    if use_tex(tables, kcfg):
        maps = tables.tex_maps
        uv_u = bw * attr(AT_UV0) + bu * attr(AT_UV1) + bv * attr(AT_UV2)
        uv_v = bw * attr(AT_UV0 + 1) + bu * attr(AT_UV1 + 1) \
            + bv * attr(AT_UV2 + 1)
        mip = 0.5 * torch.log2(torch.clamp(cone * cone, min=1e-30)) \
            + attr(AT_LODB)
        ju0, ju1 = lds(eff_seed(EFFECT_STF), (0, 1))

        def tfetch(row):
            tid = mrow(row).to(torch.int64)
            return tid >= 0, tex_fetch(tables.tex, tables.tex_meta, tid,
                                       uv_u, uv_v, mip, ju0, ju1)

        if maps[0]:
            has_b, brgba = tfetch(MT_BTEX)
            base_color = torch.where(has_b, base_color * brgba[:3],
                                     base_color)
            if omm_unknown is not None:
                # the alpha test reads MIP 0, as the bake does
                a0 = tex_fetch(tables.tex, tables.tex_meta,
                               mrow(MT_BTEX).to(torch.int64), uv_u, uv_v,
                               torch.full_like(uv_u, -100.0), ju0, ju1)[3]
                base_alpha0 = torch.where(has_b, a0, 1.0)
        if maps[1]:
            # glTF: B = metallic, G = roughness
            has_m, mrgba = tfetch(MT_MRTEX)
            metallic = torch.where(has_m, metallic * mrgba[2], metallic)
            roughness = torch.where(has_m, roughness * mrgba[1], roughness)
        if maps[2]:
            has_e, ergba = tfetch(MT_ETEX)
            emissive = torch.where(has_e, emissive * ergba[:3], emissive)
        if maps[3]:
            # tangent-space normal map: the baked UV tangent (AT_TANG,
            # AT_TSGN), Gram-Schmidt against the shading normal, the
            # perturbed normal kept in the geometric hemisphere
            has_n, nrgba = tfetch(MT_NTEX)
            n_ts = nrgba[:3] * 2.0 - 1.0
            tang_raw = attr(AT_TANG, 3)
            tsgn = attr(AT_TSGN)
            t_gs = tang_raw - sh_n * W.dot3(tang_raw, sh_n)
            tlen = torch.sqrt(W.dot3(t_gs, t_gs))
            ok_t = (tsgn != 0.0) & (tlen > 1e-8)
            tang = t_gs / torch.clamp(tlen, min=1e-8)
            bitan = W.cross3(sh_n, tang) * tsgn
            n_pert = W.normalize3(n_ts[0] * tang + n_ts[1] * bitan
                                  + torch.clamp(n_ts[2], min=0.05) * sh_n)
            n_pert = torch.where(W.dot3(n_pert, gn) > 0.0, n_pert, sh_n)
            sh_n = torch.where(has_n & ok_t, n_pert, sh_n)
    # pass-through: an UNKNOWN micro-cell whose MIP-0 alpha fails the cutoff
    has_pass = omm_unknown is not None and use_tex(tables, kcfg) \
        and bool(tables.tex_maps[0])
    passthru = torch.zeros_like(hit_mask)
    if has_pass:
        acut = mrow(MT_ACUT)
        passthru = hit_mask & omm_unknown & (acut >= 0.0) \
            & (base_alpha0 < acut)
    if prio:
        def prow(med):
            v = mat[MT_PRIO][torch.clamp(med, 0, 127)]
            return torch.where(med >= 0, v, -1.0)

        p_hit = mrow(MT_PRIO)
        boundary = ~thin & (transmission > 0.0)
        false_enter = boundary & front & (p_hit < prow(med0))
        false_exit = boundary & ~front & (mid != med0)
        prio_fh = hit_mask & (false_enter | false_exit)
        # the interior list's bookkeeping for the skipped boundary
        med1 = torch.where(
            prio_fh & false_enter & ((med1 < 0) | (p_hit > prow(med1))),
            mid, torch.where(prio_fh & false_exit & (mid == med1), -1, med1))
        passthru = passthru | prio_fh
        has_pass = True
    hit_shade = hit_mask & ~passthru
    u_alpha = None
    if omm_unknown is not None:
        (u_alpha,) = lds(eff_seed(EFFECT_ALPHA), (0,))

    def med_ior(med):
        v = mat[MT_IOR][torch.clamp(med, 0, 127)]
        return torch.where(med >= 0, v, 1.0)

    cur_ior = med_ior(med0)
    below_ior = med_ior(med1)
    in_medium = med0 >= 0
    sigma = mat[MT_VOLABS:MT_VOLABS + 3][:, torch.clamp(med0, 0, 127)]
    thp = thp * torch.where(in_medium, torch.exp(-sigma * t), 1.0)

    e_poly = mat[MT_EPOLY:MT_EPOLY + 6][:, mid] if kcfg.energy_comp else None
    e_avg = mrow(MT_EAVG) if kcfg.energy_comp else None
    bsdf = W.make_bsdf_w(base_color, metallic, roughness, ior, transmission,
                         dtrans, spec_scale, front, cur_ior, below_ior,
                         e_poly=e_poly, e_avg=e_avg)
    emissive = torch.where(front, emissive, 0.0)

    # ----- emissive hit + MIS (baked per-triangle light pdf / area) -----
    cos_l = torch.abs(W.dot3(-d, gn))
    area = torch.clamp(attr(AT_LAREA), min=1e-12)
    p_geo = t * t / torch.clamp(area * torch.clamp(cos_l, min=1e-9),
                                min=1e-12)
    if em_mis and kcfg.enable_mis:
        if nee_uniform:
            sel_pdf_hit = attr(AT_ISLIGHT) / float(max(n_lights, 1))
        else:
            sel_pdf_hit = attr(AT_LPDF)
        p_light = torch.where(attr(AT_ISLIGHT) > 0.5, sel_pdf_hit * p_geo,
                              0.0)
        w_em = torch.where(prev_delta | (lb == 0), 1.0,
                           W.power_heuristic(prev_pdf, p_light))
    else:
        w_em = torch.ones_like(t)
    if mode == 3:
        em3 = torch.where(hit_shade & em_gate, thp * emissive, 0.0)
    else:
        em_c = torch.where(hit_shade & em_gate, thp * emissive * w_em, 0.0)
        L = L + em_c
        if split:
            # the primary vertex's emission goes to neither channel
            em_c = torch.where(lb > 0, em_c, 0.0)
            cd = torch.where(fspec > 0.5, 0.0, em_c)
            ld = ld + cd
            ls = ls + (em_c - cd)
        em3 = torch.zeros_like(thp)
    surf = None
    if ext_nee:
        surf = torch.cat([
            pos, sh_n, gn, mid.to(torch.float32)[None], base_color,
            metallic[None], roughness[None], bsdf.eta[None], thp, em3,
            torch.where(attr(AT_ISLIGHT) > 0.5, p_geo, 0.0)[None],
            attr(AT_LID)[None]], dim=0)

    wo = W.to_local3(-d, sh_n)

    # ----- NEE (one candidate) -----
    if use_nee:
        u_sel, u1, u2 = lds(eff_seed(EFFECT_NEE), (0, 2, 3))
        u_sel = torch.clamp(u_sel, 0.0, 1.0 - 1e-7)
        if nee_uniform:
            li = torch.clamp((u_sel * float(n_lights)).to(torch.int64),
                             0, n_lights - 1)
            sel_pdf = torch.full_like(u_sel, 1.0 / float(n_lights))
        else:
            li = torch.clamp(_searchsorted128(lrows[W.LROW_CDF], u_sel),
                             0, n_lights - 1)
            sel_pdf = lrows[W.LROW_POWER][li]

        def lrow3(i):
            return lrows[i:i + 3][:, li]

        lf = W.LightFieldsW(
            kind=lrows[W.LROW_KIND][li].to(torch.int64),
            p0=lrow3(W.LROW_P0), p1=lrow3(W.LROW_P1), p2=lrow3(W.LROW_P2),
            em=lrow3(W.LROW_EM),
            extra=lrows[W.LROW_EXTRA:W.LROW_EXTRA + 4][:, li],
            normal=lrow3(W.LROW_NORMAL), power=sel_pdf)
        lsmp = W.sample_light_fields_w(
            lf, sel_pdf, pos, u1, u2,
            env=None if env is None else env_sample_k(env, u1, u2))
        wi_l = W.to_local3(lsmp["wi"], sh_n)
        f_l = W.bsdf_eval_w(bsdf, wo, wi_l)
        pdf_b = W.bsdf_pdf_w(bsdf, wo, wi_l)
        do_nee = hit_shade & lsmp["valid"] & (W.luminance3(f_l) > 0.0)
        if not first_direct:
            do_nee = do_nee & (lb > 0)
        shadow_o = _ray_offset(pos, gn, lsmp["wi"])
        if kcfg.enable_mis:
            w_nee = torch.where(lsmp["is_delta"], 1.0,
                                W.power_heuristic(lsmp["pdf"], pdf_b))
        else:
            w_nee = torch.ones_like(t)
        contrib = thp * f_l * lsmp["Li"] * (
            w_nee / torch.clamp(lsmp["pdf"], min=1e-12))
        if kcfg.firefly > 0.0:
            lum = W.luminance3(contrib)
            contrib = contrib * torch.clamp(
                kcfg.firefly / torch.clamp(lum, min=1e-12), max=1.0)
        if split:
            f_dp, _ = W.bsdf_eval_split_w(bsdf, wo, wi_l)
            ratio = f_dp / torch.clamp(f_l, min=1e-12)
            cdiff = torch.where(lb == 0, contrib * ratio,
                                torch.where(fspec > 0.5, 0.0, contrib))
        else:
            cdiff = torch.zeros_like(thp)
        dist_eff = lsmp["dist"] - W.dot3(shadow_o - pos, lsmp["wi"])
        sdist = torch.where(do_nee, dist_eff * (1.0 - 1e-4), 0.0)
        shadow_d = lsmp["wi"]
    else:
        do_nee = torch.zeros_like(hit)
        shadow_o, shadow_d = pos, d
        sdist = torch.zeros_like(t)
        contrib = torch.zeros_like(thp)
        cdiff = torch.zeros_like(thp)

    # ----- scatter -----
    # the state a pass-through lane keeps
    thp_ns, pdf_ns, delta_ns = thp, prev_pdf, prev_delta
    med0_ns, med1_ns, spread_ns = med0, med1, spread
    u_lobe, su1, su2 = lds(eff_seed(EFFECT_SCATTER), (0, 2, 3))
    bs = W.bsdf_sample_w(bsdf, wo, u_lobe, su1, su2)
    wi_world = W.to_world3(bs["wi"], sh_n)
    if split:
        is_spec = (bs["lobe"] == W.LOBE_SPECULAR_REFL) \
            | (bs["lobe"] == W.LOBE_SPECULAR_TRANS)
        fspec = torch.where((lb == 0) & hit_shade, is_spec.to(torch.float32),
                            fspec)
    leak = (bs["wi"][2] > 0.0) != (W.dot3(wi_world, gn) > 0.0)
    active = active & (passthru | (bs["valid"] & ~leak
                                   & (W.luminance3(bs["weight"]) > 0.0)))
    thp = thp * bs["weight"]
    prev_pdf = bs["pdf"]
    prev_delta = bs["is_delta"]

    transmitted = bs["wi"][2] < 0.0
    entering = transmitted & front & ~thin
    exiting = transmitted & ~front & ~thin
    new_med0 = torch.where(entering, mid, torch.where(exiting, med1, med0))
    new_med1 = torch.where(entering, med0,
                           torch.where(exiting, -1, med1))
    med0, med1 = new_med0, new_med1

    if kcfg.rr_enable:
        (u_rr,) = lds(eff_seed(EFFECT_RR), (0,))
        p_cont = torch.clamp(torch.maximum(torch.maximum(thp[0], thp[1]),
                                           thp[2]), 0.05, 1.0)
        rr_on = (lb >= kcfg.min_rr) & ~passthru
        active = active & ~(rr_on & (u_rr >= p_cont))
        thp = thp / torch.where(rr_on, p_cont, 1.0)

    o_new = _ray_offset(pos, gn, wi_world)
    spread = spread + torch.sqrt(bsdf.alpha) * 0.25 \
        * (1.0 - prev_delta.to(torch.float32))
    lb_out = lb + hit_shade.to(torch.int64)
    if has_pass:
        # a pass-through lane continues the same ray from just past the
        # rejected surface; its scatter state does not advance
        t_adv = t * (1.0 + 1e-4) + 1e-5
        o_new = torch.where(passthru, o + d * t_adv, o_new)
        wi_world = torch.where(passthru, d, wi_world)
        thp = torch.where(passthru, thp_ns, thp)
        prev_pdf = torch.where(passthru, pdf_ns, prev_pdf)
        prev_delta = torch.where(passthru, delta_ns, prev_delta)
        med0 = torch.where(passthru, med0_ns, med0)
        med1 = torch.where(passthru, med1_ns, med1)
        spread = torch.where(passthru, spread_ns, spread)

    return dict(o_new=o_new, wi_world=wi_world, thp=thp, L=L,
                prev_pdf=prev_pdf, cone=cone, spread=spread, active=active,
                prev_delta=prev_delta, med0=med0, med1=med1,
                lbounce=lb_out, do_nee=do_nee, shadow_o=shadow_o,
                shadow_d=shadow_d, sdist=sdist, contrib=contrib,
                shaded=hit_shade, surf=surf, u_alpha=u_alpha,
                passthru=passthru, ld=ld, ls=ls, fspec=fspec, cdiff=cdiff)


def split_add(fs2, cd, tot):
    """fs2 with `cd` [3, N] added to the diffuse channel and tot - cd to
    the specular one: the wavefront loops' merge of a contribution whose
    diffuse part is cd (bounce_pallas.py:1911-1925)."""
    return torch.cat([fs2[F2_LD:F2_LD + 3] + cd,
                      fs2[F2_LS:F2_LS + 3] + (tot - cd),
                      fs2[F2_FSPEC:F2_FSPEC + 1]])


def final_env_state(fs, is_, hit, env, kcfg: KernelConfig, n_lights: int,
                    nee_modes, fs2=None):
    """The final environment-only round after the last bounce (the JAX
    package's `final_env` kernel branch, which mirrors its general tier's
    last HandleMiss): each active lane that misses adds thp x the
    environment, weighted against the environment's NEE pdf when its NEE
    mode is in `nee_modes` (K1: 1, 2, 4, 5; K4: 1, 2) and MIS is on; every
    lane ends inactive. Returns (fs_out, is_out), and with the split rows
    `fs2` [NF2, N] also fs2_out, the environment in the first scatter's
    channel (bounce_pallas.py:1501-1504)."""
    use_nee = kcfg.nee_mode in nee_modes and n_lights > 0
    miss = (is_[IS_ACTIVE] > 0) & ~hit
    env_L, p_env = env_eval_pdf(env, fs[FS_D:FS_D + 3], kcfg.nee_mode == 1,
                                n_lights)
    if use_nee and kcfg.enable_mis:
        w_env = torch.where(is_[IS_PREVDELTA] > 0, 1.0,
                            W.power_heuristic(fs[FS_PREVPDF], p_env))
    else:
        w_env = torch.ones_like(p_env)
    c_env = torch.where(miss, fs[FS_THP:FS_THP + 3] * env_L * w_env, 0.0)
    fs_out = fs.clone()
    fs_out[FS_L:FS_L + 3] = fs[FS_L:FS_L + 3] + c_env
    is_out = is_.clone()
    is_out[IS_ACTIVE] = 0
    if fs2 is None:
        return fs_out, is_out
    cd = torch.where(fs2[F2_FSPEC] > 0.5, 0.0, c_env)
    return fs_out, is_out, split_add(fs2, cd, c_env)


def bounce_reference(fs, is_, tables: BounceTables, kcfg: KernelConfig,
                     sample_idx: int, final_env: bool = False, fs2=None,
                     inj=None, first_direct: bool = True):
    """One bounce of the whole wavefront in plain PyTorch: the function
    the CUDA kernel computes per ray (_intersect_group, surface_and_shade,
    _occluded_group). fs [NF,N] f32, is_ [NI,N] i32 -> (fs_out [NF,N],
    is_out [NI,N], hit_out [NH,N]), plus surf_out [SF_ROWS,N] in the
    external modes with lights, where hit row 5 is the shading flag (0 not
    shaded, 1 shaded at logical bounce 0, 2 shaded later) instead of
    do_nee. `final_env` (tables with an environment): the closest hit and
    `final_env_state` only, hit row 5 zero; as in the JAX package, that
    round's closest hit ignores the micromaps (its `_bounce_call` passes
    no omm). On tables with micromaps the closest hit rejects
    micro-TRANSPARENT candidates, surface_and_shade gets the winner's
    UNKNOWN flag, and the shadow ray takes the stochastic alpha test. On
    tables with priorities (`tables.prio`) surface_and_shade runs the
    false-hit pass-through. With the split rows `fs2` [NF2, N] (the split
    variant, bounce_pallas.py:1401-1422, :1501-1504, :1543-1545,
    :1568-1570) fs2_out [NF2, N] comes last: the unoccluded NEE
    contribution adds its diffuse part to L_diff and the rest to L_spec;
    in the external modes trace_paths_fused does that merge.
    With the injected rows `inj` [NINJ, N] (the V-buffer restart,
    bounce_pallas.py:1427-1442) the closest hit is not traced: each lane
    takes the hit (t, prim, u, v, front) its row holds, a miss where prim
    is negative, and the winner is never UNKNOWN (the pass that built the
    V-buffer resolved the alpha test). `first_direct=False`: see
    surface_and_shade."""
    o = fs[FS_O:FS_O + 3]
    d = fs[FS_D:FS_D + 3]

    # ----- closest hit -----
    omm = tables.omm and not final_env
    if inj is not None:
        t, prim, bu, bv, det_pick, unk = injected_hit(inj)
    else:
        t, prim, bu, bv, det_pick, unk = _intersect(tables, o, d,
                                                    kcfg.max_travel, omm)
    hit = t < _BIG
    front = det_pick > 0.0
    if final_env:
        outs = final_env_state(fs, is_, hit, tables.env, kcfg,
                               tables.n_lights, (1, 2, 4, 5), fs2)
        hit_out = torch.stack([torch.where(hit, t, 0.0),
                               prim.to(torch.float32), bu, bv,
                               front.to(torch.float32), torch.zeros_like(t)])
        return outs[:2] + (hit_out,) + outs[2:]
    attr_all = tables.attr_rows[:, prim.clamp(min=0)]
    attr_all = torch.where(prim >= 0, attr_all, 0.0)

    def attr(i, k=1):
        return attr_all[i] if k == 1 else attr_all[i:i + k]

    s = surface_and_shade(
        o=o, d=d, t=t, hit=hit, front=front, bu=bu, bv=bv, attr=attr,
        thp=fs[FS_THP:FS_THP + 3], L=fs[FS_L:FS_L + 3],
        prev_pdf=fs[FS_PREVPDF], cone=fs[FS_CONE], spread=fs[FS_SPREAD],
        active=is_[IS_ACTIVE] > 0, prev_delta=is_[IS_PREVDELTA] > 0,
        med0=is_[IS_MED0].to(torch.int64), med1=is_[IS_MED1].to(torch.int64),
        px=is_[IS_PX], py=is_[IS_PY], budget=is_[IS_BUDGET],
        lb=is_[IS_LBOUNCE].to(torch.int64), tables=tables, kcfg=kcfg,
        sample_idx=sample_idx, omm_unknown=unk if omm else None,
        prio=tables.prio, first_direct=first_direct, **split_args(fs2))

    # ----- NEE shadow ray -----
    ext = s["surf"] is not None
    ld, ls = s["ld"], s["ls"]
    if ext:
        L = s["L"]
        flag = s["shaded"].to(torch.float32) \
            * (1.0 + (is_[IS_LBOUNCE] > 0).to(torch.float32))
    else:
        occluded = _occluded(tables, s["shadow_o"], s["shadow_d"],
                             s["sdist"], u_alpha=s["u_alpha"])
        ok = s["do_nee"] & ~occluded
        L = s["L"] + torch.where(ok, s["contrib"], 0.0)
        flag = s["do_nee"].to(torch.float32)
        if fs2 is not None:
            cd = torch.where(ok, s["cdiff"], 0.0)
            ld = ld + cd
            ls = ls + torch.where(ok, s["contrib"], 0.0) - cd

    fs_out = torch.cat([s["o_new"], s["wi_world"], s["thp"], L,
                        s["prev_pdf"][None], s["cone"][None],
                        s["spread"][None]], dim=0)
    i32 = torch.int32
    is_out = torch.stack([s["active"].to(i32), s["prev_delta"].to(i32),
                          s["med0"].to(i32), s["med1"].to(i32), is_[IS_PX],
                          is_[IS_PY], is_[IS_BUDGET],
                          s["lbounce"].to(i32)], dim=0)
    hit_out = torch.stack([torch.where(hit, t, 0.0), prim.to(torch.float32),
                           bu, bv, front.to(torch.float32), flag], dim=0)
    outs = (fs_out, is_out, hit_out) + ((s["surf"],) if ext else ())
    if fs2 is not None:
        outs += (torch.cat([ld, ls, s["fspec"][None]]),)
    return outs


def injected_hit(inj):
    """The closest-hit tuple (t, prim, u, v, det, unk) of the injected rows
    inj [NINJ, N] (bounce_pallas.py:1433-1442): t = _BIG and prim = -1
    where the row's prim is negative, det's sign from the front row, unk
    never."""
    prim = inj[INJ_PRIM]
    miss = prim < 0.0
    t = torch.where(miss, _BIG, inj[INJ_T])
    det = torch.where(inj[INJ_FRONT] > 0.5, 1.0, -1.0)
    return (t, torch.where(miss, -1, prim.to(torch.int64)), inj[INJ_U],
            inj[INJ_V], det, torch.zeros_like(miss))


def pack_injection(first_hit):
    """The injected rows [NINJ, N] f32 of a V-buffer `first_hit`
    (`accel.traverse.Hit`), packed as the JAX package packs them
    (bounce_pallas.py:1813-1822): t, prim, u, v, front."""
    f32 = torch.float32
    return torch.stack([first_hit.t.to(f32), first_hit.prim.to(f32),
                        first_hit.bary[:, 0].to(f32),
                        first_hit.bary[:, 1].to(f32),
                        first_hit.front.to(f32)]).contiguous()


def split_args(fs2):
    """surface_and_shade's split-channel arguments from the split rows
    fs2 [NF2, N] (none without them)."""
    if fs2 is None:
        return {}
    return dict(ld=fs2[F2_LD:F2_LD + 3], ls=fs2[F2_LS:F2_LS + 3],
                fspec=fs2[F2_FSPEC])


def occlusion_reference(tables: BounceTables, sh, stats: bool = False):
    """The shadow kernel K2 in plain PyTorch: sh [SR_ROWS, N] f32 shadow
    requests -> occ [N] f32, 1 where occluded or where a lane has no
    request (bounce_pallas._shadow_kernel; on tables with micromaps the
    stochastic alpha test against row SR_UA). With `stats`, also the pairs
    each lane tested up to its first occluder, [N] i32 (0 without a
    request)."""
    req = sh[SR_DO] > 0.5
    res = _occluded(tables, sh[SR_O:SR_O + 3], sh[SR_D:SR_D + 3],
                    sh[SR_DIST], stats=stats,
                    u_alpha=sh[SR_UA] if tables.omm else None)
    occ = res[0] if stats else res
    out = torch.where(req, occ.to(torch.float32), 1.0)
    if stats:
        return out, torch.where(req, res[1], 0).to(torch.int32)
    return out


def shadow_requests(shadow_o, shadow_d, sdist, do_nee, u_alpha=None):
    """sh [SR_ROWS, N] from [N, 3] origins and directions, [N] distances,
    [N] request flags and the [N] alpha uniforms (zero without)."""
    ua = torch.zeros_like(sdist) if u_alpha is None else u_alpha
    return torch.cat([shadow_o.T, shadow_d.T, sdist[None],
                      do_nee.to(torch.float32)[None], ua[None]],
                     dim=0).contiguous()


# ---------------------------------------------------------------------------
# The wrappers
# ---------------------------------------------------------------------------


_check = kernels.check_tensor


def variant_name(base: str, has_env: bool, final_env: bool,
                 has_tex: bool = False, omm: bool = False,
                 prio: bool = False, split: bool = False,
                 restart: str = "") -> str:
    """The launch-count name of a shading kernel's variant: `base`, then
    K1's restart switch ("_inj" with the injected V-buffer rows,
    "_nodirect" for first_direct=False without them), "_omm" with the
    micromap switch, "_tex" with the texture switch,
    "_prio" with the priority switch, "_split" with the split channels,
    then "_env" with the environment switches; base + "_final" (+ "_split")
    for the final environment-only round (which shades nothing, so it runs
    without textures, micromaps or priorities)."""
    tail = "_split" if split else ""
    if final_env:
        return base + "_final" + tail
    return base + restart + ("_omm" if omm else "") \
        + ("_tex" if has_tex else "") \
        + ("_prio" if prio else "") + tail + ("_env" if has_env else "")


def check_omm_tables(tables, n_rows: int, dev):
    """Raise unless the micromap words and coverages are what the kernels
    read: [n_rows] i32 and f32."""
    _check("tri_micro", tables.tri_micro, torch.int32, (n_rows,), dev)
    _check("tri_cover", tables.tri_cover, torch.float32, (n_rows,), dev)


def bounce(fs, is_, tables: BounceTables, kcfg: KernelConfig,
           sample_idx: int, final_env: bool = False, fs2=None, inj=None,
           first_direct: bool = True):
    """One bounce of the wavefront: the CUDA kernel (csrc/bounce_fused.cu)
    for CUDA tensors, `bounce_reference` for CPU tensors, with its return
    (surf_out too in the external modes with lights; `final_env` runs the
    final environment-only round of tables with an environment; with the
    split rows `fs2` the split variant, fs2_out last; with the injected
    rows `inj` [NINJ, N] the V-buffer restart; `first_direct=False`
    leaves the first vertex's direct light out). Build and launch errors
    raise; nothing falls back."""
    if final_env and tables.env is None:
        raise ValueError("bounce: final_env needs the tables' environment")
    if final_env and inj is not None:
        raise ValueError("bounce: the final environment round takes no "
                         "injected hits")
    if fs.device.type == "cpu":
        return bounce_reference(fs, is_, tables, kcfg, sample_idx, final_env,
                                fs2, inj, first_direct)
    if fs.device.type != "cuda":
        raise ValueError(f"bounce: no kernel for device {fs.device}")
    n = fs.shape[1]
    dev = fs.device
    _check("fs", fs, torch.float32, (NF, n), dev)
    _check("is_", is_, torch.int32, (NI, n), dev)
    split = fs2 is not None
    if split:
        _check("fs2", fs2, torch.float32, (NF2, n), dev)
    if inj is not None:
        _check("inj", inj, torch.float32, (NINJ, n), dev)
    tpad = tables.tc * tables.n_chunks
    _check("tri_coef", tables.tri_coef, torch.float32, (tpad, TC_ROWS), dev)
    _check("attr_rows", tables.attr_rows, torch.float32, (AT_ROWS, tpad),
           dev)
    _check("mat_rows", tables.mat_rows, torch.float32, (MT_ROWS, 128), dev)
    _check("light_rows", tables.light_rows, torch.float32, (W.LROWS, 128),
           dev)
    if tables.env is not None:
        _check("env", tables.env, torch.float32, (ET_SIZE,), dev)
    tex = use_tex(tables, kcfg) and not final_env
    if tex:
        check_tex_tables(tables, dev)
    omm = tables.omm and not final_env
    if omm:
        check_omm_tables(tables, tpad, dev)
    prio = tables.prio and not final_env
    if kcfg.nee_mode not in range(6):
        raise ValueError(f"bounce: nee_mode {kcfg.nee_mode} not in 0..5")
    if not 0 < tables.n_tris <= MAX_TRIS or (
            kcfg.nee_mode in (1, 2) and tables.n_lights > MAX_LIGHTS):
        raise ValueError("bounce: table sizes outside the kernel's limits")
    fs_out = torch.empty_like(fs)
    is_out = torch.empty_like(is_)
    hit_out = torch.empty((NH, n), dtype=torch.float32, device=dev)
    outs = (fs_out, is_out, hit_out)
    surf_out = None
    if kcfg.external and tables.n_lights > 0 and not final_env:
        surf_out = torch.empty((SF_ROWS, n), dtype=torch.float32, device=dev)
        outs += (surf_out,)
    fs2_out = torch.empty_like(fs2) if split else None
    if split:
        outs += (fs2_out,)
    if n == 0:
        return outs
    # the real-time fill runs K1's restart library
    restart = inj is not None or not first_direct
    lib, entry = ((kernels.BOUNCE_FUSED_RESTART, "rtxpt_bounce_fused_restart")
                  if restart else (kernels.BOUNCE_FUSED, "rtxpt_bounce_fused"))
    tail = ((int(prio), None if inj is None else inj.data_ptr(),
             int(first_direct)) if restart else (int(final_env), int(prio)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.launch(
            entry,
            fs.data_ptr(), is_.data_ptr(), fs_out.data_ptr(),
            is_out.data_ptr(), hit_out.data_ptr(),
            None if surf_out is None else surf_out.data_ptr(),
            fs2.data_ptr() if split else None,
            fs2_out.data_ptr() if split else None,
            tables.tri_coef.data_ptr(), tables.attr_rows.data_ptr(),
            tables.mat_rows.data_ptr(), tables.light_rows.data_ptr(),
            None if tables.env is None else tables.env.data_ptr(),
            *tex_args(tables, tex),
            tables.tri_micro.data_ptr() if omm else None,
            tables.tri_cover.data_ptr() if omm else None,
            n, tables.n_tris, tpad, tables.n_lights,
            int(sample_idx) & rng.M32, kcfg.nee_mode, int(kcfg.enable_mis),
            kcfg.firefly, int(kcfg.rr_enable), kcfg.min_rr, kcfg.max_travel,
            int(kcfg.low_discrepancy), int(kcfg.energy_comp), kcfg.maxb,
            *tail, stream)
    kernels.launches[variant_name("bounce_fused", tables.env is not None,
                                  final_env, tex, omm, prio, split,
                                  "_inj" if inj is not None else
                                  "" if first_direct else "_nodirect")] += 1
    return outs


def check_tex_tables(tables, dev):
    """Raise unless the texture tables are what the kernels read."""
    _check("tex", tables.tex, torch.float32, (tables.tex.shape[0], 4), dev)
    _check("tex_meta", tables.tex_meta, torch.int32,
           (tables.tex_meta.shape[0], TX_COLS), dev)
    if not 0 < tables.tex_meta.shape[0] <= TEX_MAX_COUNT:
        raise ValueError("texture tables: 1..128 textures")


def tex_args(tables, tex: bool):
    """The C interface's texture arguments: atlas, meta (NULL for the
    untextured variant), texture count and the tex_maps bits (base 1,
    metal-rough 2, emissive 4, normal 8)."""
    if not tex:
        return None, None, 0, 0
    bits = sum(int(b) << k for k, b in enumerate(tables.tex_maps))
    return (tables.tex.data_ptr(), tables.tex_meta.data_ptr(),
            tables.tex_meta.shape[0], bits)


def occlusion(tables: BounceTables, sh, stats: bool = False):
    """Shadow requests sh [SR_ROWS, N] -> occ [N] f32 (1 = occluded or no
    request), and with `stats` the pairs each lane tested, [N] i32: the
    shadow kernel K2 (csrc/shadow_occlusion.cu; its micromap variant,
    counted as "shadow_occlusion_omm", on tables with micromaps) for CUDA
    tensors, `occlusion_reference` for CPU tensors. Nothing falls back."""
    if sh.device.type == "cpu":
        return occlusion_reference(tables, sh, stats)
    if sh.device.type != "cuda":
        raise ValueError(f"occlusion: no kernel for device {sh.device}")
    n = sh.shape[1]
    dev = sh.device
    _check("sh", sh, torch.float32, (SR_ROWS, n), dev)
    tpad = tables.tc * tables.n_chunks
    _check("tri_coef", tables.tri_coef, torch.float32, (tpad, TC_ROWS), dev)
    if tables.omm:
        check_omm_tables(tables, tpad, dev)
    if not 0 < tables.n_tris <= MAX_TRIS:
        raise ValueError("occlusion: table sizes outside the kernel's limits")
    occ = torch.empty((n,), dtype=torch.float32, device=dev)
    tests = torch.empty((n,), dtype=torch.int32, device=dev) if stats \
        else None
    if n > 0:
        with torch.cuda.device(dev):
            kernels.SHADOW_OCCLUSION.launch(
                "rtxpt_shadow_occlusion", sh.data_ptr(), occ.data_ptr(),
                tests.data_ptr() if stats else None,
                tables.tri_coef.data_ptr(),
                tables.tri_micro.data_ptr() if tables.omm else None,
                tables.tri_cover.data_ptr() if tables.omm else None,
                n, tables.n_tris,
                torch.cuda.current_stream(dev).cuda_stream)
        kernels.launches["shadow_occlusion_omm" if tables.omm
                         else "shadow_occlusion"] += 1
    return (occ, tests) if stats else occ


# ---------------------------------------------------------------------------
# Wavefront loop
# ---------------------------------------------------------------------------


def initial_state(o, d, cone_spread, px, py):
    """Wavefront state of camera rays before bounce 0: (fs [NF,N] f32,
    is_ [NI,N] i32), as trace_paths_pallas builds it (thp 1, L 0, every
    lane active, camera counts as a delta vertex, no medium, no budget)."""
    n = o.shape[0]
    dev = o.device
    f32 = torch.float32
    fs = torch.cat([
        o.T, d.T,
        torch.ones((3, n), dtype=f32, device=dev),       # thp
        torch.zeros((3, n), dtype=f32, device=dev),      # L
        torch.zeros((2, n), dtype=f32, device=dev),      # prev_pdf, cone
        cone_spread.to(f32)[None],
    ], dim=0).contiguous()
    i32 = torch.int32
    is_ = torch.cat([
        torch.ones((2, n), dtype=i32, device=dev),       # active, prev_delta
        torch.full((2, n), -1, dtype=i32, device=dev),   # med0, med1
        px.to(i32)[None], py.to(i32)[None],
        torch.full((1, n), _NO_BUDGET, dtype=i32, device=dev),
        torch.zeros((1, n), dtype=i32, device=dev),      # logical bounce
    ], dim=0).contiguous()
    return fs, is_


def alpha_uniform(cfg, px, py, lb, sample_idx):
    """[N] the alpha uniform of the lanes' shadow rays on the external
    route: K1's u_alpha, dimension 0 of pixel_seed(px, py, lb,
    EFFECT_ALPHA) (bounce_pallas.py:1884-1894)."""
    seed = rng.pixel_seed(px, py, lb, EFFECT_ALPHA)
    if cfg.low_discrepancy:
        return rng.ld_samples(sample_idx, seed, (0,))[0]
    return rng.uniform_sample(seed, rng.hash_combine(sample_idx, 0))


def first_hit_aux(scene, cfg, hit0, o, d, cone_spread, split: bool):
    """The aux guide buffers of the camera rays from their bounce-0 hit rows
    hit0 [NH, N] (bounce_pallas.py:1960-1985): `surface.guide_buffers` of
    the surfaces `surface.load_surface` gives those hits. A seventh row,
    on instanced cluster tables, holds each hit's instance: the surface
    is then taken to world space. Returns a dict of [N, 3] / [N]
    tensors."""
    from rtxpt_tpu_torch.accel.traverse import Hit
    from rtxpt_tpu_torch.pt.surface import guide_buffers, load_surface
    t0 = hit0[0]
    prim0 = hit0[1].to(torch.int32)
    hm = prim0 >= 0
    hit_s = Hit(t=torch.where(hm, t0, float(cfg.max_ray_travel)), prim=prim0,
                bary=torch.stack([hit0[2], hit0[3]], dim=-1),
                front=hit0[4] > 0.5,
                inst=hit0[NH].to(torch.int32) if hit0.shape[0] > NH
                else None)
    surf = load_surface(scene, hit_s, o, d, cone_width=cone_spread
                        * torch.clamp(t0, min=0.0))
    return guide_buffers(surf, t0, hm, split)


def external_split(fs2, res, ok, lb0, neeat: bool):
    """fs2 after an external-NEE bounce (bounce_pallas.py:1911-1925): the
    unoccluded NEE contribution with its diffuse part `cdiff`, and under
    NEE-AT the deferred emission (em_add) of the lanes shaded after the
    first vertex (`lb0` [N] bool: shaded at logical bounce 0, or not at
    all), in the first scatter's channel."""
    em_s = res["em_add"] if neeat else torch.zeros_like(res["em_add"])
    em_s = torch.where(lb0[:, None], 0.0, em_s)
    nee_s = torch.where(ok[:, None], res["contrib"], 0.0)
    cd = torch.where(ok[:, None], res["cdiff"], 0.0) \
        + torch.where((fs2[F2_FSPEC] > 0.5)[:, None], 0.0, em_s)
    return split_add(fs2, cd.T, (nee_s + em_s).T)


def trace_paths_fused(scene, cfg, o, d, cone_spread, px, py, sample_idx,
                      neeat_state=None, want_aux: bool = False,
                      first_hit=None, bounce_budget=None,
                      first_direct: bool = True):
    """Trace a wavefront of camera rays to completion, one `bounce` per
    bounce (bounce_pallas.trace_paths_pallas): the kernels for CUDA
    tensors, their plain versions for CPU tensors.

    The real-time arguments (bounce_pallas.py:1764-1822, :1865): with
    `first_hit` (an `accel.traverse.Hit` per lane, the V-buffer of a
    stable plane) bounce 0 runs K1 on the injected rows (`pack_injection`)
    instead of its intersection loop; `bounce_budget` [N] int fills the
    IS_BUDGET row, and a lane stops shading once its logical bounce
    reaches it; `first_direct=False` leaves the first vertex's direct
    light out (K1's gates, and external_nee's on the external route).

    With `cfg.split_channels` every bounce runs K1's split variant on the
    split rows fs2 (zero at bounce 0), and the result holds L_diff and
    L_spec [N,3] (keyed on the config alone, as in the JAX package); on
    the external route the NEE contribution and NEE-AT's deferred
    emission are split here (`external_split`). With `want_aux` it holds
    the aux guide buffers of the bounce-0 hits (`first_hit_aux`).

    In the external-NEE modes (`cfg.nee_external`, or NEE-AT) each bounce
    is three steps: K1 exports the shaded surface, `external_nee` selects
    and evaluates the light, and K2 (`occlusion`) resolves the shadow
    rays; with `neeat_state`, each bounce's NEE luminance is accumulated
    into the frame's NEE-AT feedback histogram. The NEE block and the
    feedback run inside `torch.profiler.record_function` ranges named
    "rtxpt.nee" and "rtxpt.feedback".

    On tables with micromaps or priorities, a lane that passes through an
    alpha-tested surface or a priority false hit does not advance its
    logical bounce, so the chain runs `cfg.passthrough_extra_iters` (2 by
    default) more iterations, each lane stopping at its own max_bounces;
    on the external route each lane's logical bounce keys external_nee's
    seeds, and with micromaps the shadow rays carry the lane's alpha
    uniform (EFFECT_ALPHA) for K2.

    o, d [N,3]; cone_spread [N]; px, py [N] int. Returns dict(L [N,3],
    ray_count [] int64 tensor, occupancy [B+1] int64 tensor), plus
    neeat_hist (neeat.zero_hist's shape) on the NEE-AT route, and the
    split and aux buffers above."""
    tbl: BounceTables = scene.bounce_tables
    dev = o.device
    fs, is_ = initial_state(o, d, cone_spread, px, py)
    if bounce_budget is not None:
        is_[IS_BUDGET] = bounce_budget.to(torch.int32)
    inj = None if first_hit is None else pack_injection(first_hit)
    kcfg = KernelConfig.from_cfg(cfg)
    ext = kcfg.external and tbl.n_lights > 0
    split = bool(cfg.split_channels)
    fs2 = torch.zeros((NF2, o.shape[0]), dtype=torch.float32, device=dev) \
        if split else None
    hit0 = None
    hist = None
    if ext:
        from rtxpt_tpu_torch.lighting import neeat as na
        from rtxpt_tpu_torch.pt.nee_external import external_nee
        if kcfg.nee_mode == 3 and neeat_state is not None:
            hist = na.zero_hist(neeat_state)
    ray_count = torch.zeros((), dtype=torch.int64, device=dev)
    occupancy = []
    passes = tbl.omm or tbl.prio
    extra = int(getattr(cfg, "passthrough_extra_iters", 2)) if passes \
        else 0
    for b in range(cfg.max_bounces + extra):
        active_in = is_[IS_ACTIVE].sum(dtype=torch.int64)
        occupancy.append(active_in)
        d_in = fs[FS_D:FS_D + 3]
        prev_pdf_in = fs[FS_PREVPDF]
        prev_delta_in = is_[IS_PREVDELTA] > 0
        lb_in = is_[IS_LBOUNCE]
        out = bounce(fs, is_, tbl, kcfg, sample_idx, fs2=fs2,
                     inj=inj if b == 0 else None, first_direct=first_direct)
        fs, is_, hit = out[:3]
        if split:
            fs2 = out[-1]
        if b == 0:
            hit0 = hit
        ray_count = ray_count + active_in
        if not ext:
            ray_count = ray_count + (hit[5] > 0.5).sum()
            continue
        # hit[5]: 0 = not shaded, 1 = shaded at lb == 0, 2 = at lb > 0
        with record_function("rtxpt.nee"):
            res = external_nee(scene, cfg, neeat_state, out[3], d_in,
                               hit[5] > 0.5, prev_pdf_in, prev_delta_in,
                               is_[IS_PX], is_[IS_PY], sample_idx, b,
                               first_spec=(fs2[F2_FSPEC] > 0.5) if split
                               else None,
                               lb=lb_in if passes else None,
                               first_direct=first_direct)
            ua = alpha_uniform(cfg, is_[IS_PX], is_[IS_PY], lb_in,
                               sample_idx) if tbl.omm else None
            sh = shadow_requests(res["shadow_o"], res["shadow_d"],
                                 res["sdist"], res["do_nee"], ua)
        occ = occlusion(tbl, sh)
        ok = res["do_nee"] & (occ < 0.5)
        add = res["em_add"] + torch.where(ok[:, None], res["contrib"], 0.0)
        fs[FS_L:FS_L + 3] += add.T          # the kernel's fresh output
        if split:
            fs2 = external_split(fs2, res, ok, hit[5] < 1.5,
                                 kcfg.nee_mode == 3)
        ray_count = ray_count + res["do_nee"].sum()
        if hist is not None:
            with record_function("rtxpt.feedback"):
                c = res["contrib"]
                lum = c[:, 0] * 0.2126 + c[:, 1] * 0.7152 + c[:, 2] * 0.0722
                hist = na.accumulate_feedback(
                    neeat_state, hist, res["tile"], res["li"],
                    torch.clamp(lum, min=0.0), ok)
    if tbl.env is not None:
        # the final environment-only round for the rays still active
        active_in = is_[IS_ACTIVE].sum(dtype=torch.int64)
        out = bounce(fs, is_, tbl, kcfg, sample_idx, final_env=True, fs2=fs2)
        fs, is_ = out[:2]
        if split:
            fs2 = out[-1]
        ray_count = ray_count + active_in
    occupancy.append(is_[IS_ACTIVE].sum(dtype=torch.int64))
    result = dict(L=fs[FS_L:FS_L + 3].T, ray_count=ray_count,
                  occupancy=torch.stack(occupancy))
    if split:
        result.update(L_diff=fs2[F2_LD:F2_LD + 3].T,
                      L_spec=fs2[F2_LS:F2_LS + 3].T)
    if hist is not None:
        result["neeat_hist"] = hist
    if want_aux:
        result.update(first_hit_aux(scene, cfg, hit0, o, d, cone_spread,
                                    split))
    return result
