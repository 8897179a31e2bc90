"""NEE-AT: feedback-adaptive per-tile light importance sampling
(counterpart of rtxpt_tpu/lighting/neeat.py).

Each 8x8-pixel tile keeps a light-selection pmf learned from the
luminance its NEE samples delivered, and samples from the defensive
mixture alpha * global power pmf + (1 - alpha) * tile pmf. Two capacity
tiers, both exact in their pmf:

  * dense (n_lights <= MAX_DENSE_LIGHTS): a [tiles, lights] EMA
    histogram;
  * top-K (beyond): K hashed slots per tile of (light id, EMA weight).

`update` runs once per sample (`integrator.render_adaptive`), optionally
reprojecting the tile history by per-pixel motion first.

The JAX package's uint32 slot hash runs here in int64 with masks, as in
utils/rng.py. A scatter that sets a slot keeps the last lane that writes
it, as XLA's scatter does on the CPU; the port makes that choice
explicitly (scatter of the largest lane index), so it holds on the card
too. The dense feedback adds with `index_put(accumulate=True)`, whose
order on the card is the atomics' and varies between runs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

import rtxpt_tpu_torch
from rtxpt_tpu_torch.lighting.lights_baker import (
    KIND_DIRECTIONAL, KIND_POINT, KIND_SPOT, LightList, sample_light,
)
from rtxpt_tpu_torch.utils import rng

TILE = 8                 # pixels per tile side
ALPHA_GLOBAL = 0.5       # defensive mixture weight of zero-history tiles
ALPHA_MIN = 0.2          # dense-tier floor once the tile history saturates
#                          (the top-K tier does not anneal)
EMA = 0.9                # temporal feedback smoothing
MAX_DENSE_LIGHTS = 2048  # dense-histogram capacity
TOPK = 128               # local slots per tile
# lanes x lights of the tile-CDF comparison that one pass holds
_GATHER_ELEMS = 1 << 25


@dataclass(frozen=True)
class NEEATState:
    """dense tier: [T, L] rows; top-K tier: [T, K] rows and idx_k ids."""

    tile_pdf: torch.Tensor
    tile_cdf: torch.Tensor
    ema: torch.Tensor
    idx_k: Optional[torch.Tensor] = None   # [T, K] i32; None = dense tier
    frame: int = 0                         # hash salt / frame index (u32)
    conf: Optional[torch.Tensor] = None    # [T] feedback confidence
    trust: Optional[torch.Tensor] = None   # [T] mixture trust
    power: Optional[torch.Tensor] = None   # [L] global pmf (dense tier)
    n_tiles_x: int = 0
    n_tiles_y: int = 0
    n_lights: int = 0

    @property
    def topk(self) -> bool:
        return self.idx_k is not None

    def replace(self, **kw) -> "NEEATState":
        return dataclasses.replace(self, **kw)


def init_state(width: int, height: int, n_lights: int, lights_power=None,
               device="cuda") -> NEEATState:
    """A uniform NEE-AT state for a width x height frame on `device` (the
    GPU by default; raises when there is none)."""
    device = rtxpt_tpu_torch.device(device)
    ntx = (width + TILE - 1) // TILE
    nty = (height + TILE - 1) // TILE
    t = ntx * nty
    f32 = torch.float32
    conf = torch.zeros((t,), dtype=f32, device=device)
    if n_lights <= MAX_DENSE_LIGHTS:
        uniform = torch.full((t, n_lights), 1.0 / n_lights, dtype=f32,
                             device=device)
        power = (torch.as_tensor(lights_power, dtype=f32, device=device)
                 if lights_power is not None else None)
        return NEEATState(tile_pdf=uniform, tile_cdf=torch.cumsum(uniform, -1),
                          ema=torch.zeros_like(uniform), conf=conf,
                          trust=torch.zeros_like(conf), power=power,
                          n_tiles_x=ntx, n_tiles_y=nty, n_lights=n_lights)
    k = TOPK
    return NEEATState(
        tile_pdf=torch.zeros((t, k), dtype=f32, device=device),
        tile_cdf=torch.ones((t, k), dtype=f32, device=device),
        ema=torch.zeros((t, k), dtype=f32, device=device),
        idx_k=torch.full((t, k), -1, dtype=torch.int32, device=device),
        conf=conf, trust=torch.zeros_like(conf), n_tiles_x=ntx,
        n_tiles_y=nty, n_lights=n_lights)


def state_from_numpy(fields: dict, device="cuda") -> NEEATState:
    """NEEATState on `device` (the GPU by default; raises when there is
    none) from the JAX package's NEEATState fields as numpy arrays and ints
    (tile_pdf, tile_cdf, ema, idx_k, frame, conf, trust, power, n_tiles_x,
    n_tiles_y, n_lights); idx_k, conf, trust and power may be None."""
    device = rtxpt_tpu_torch.device(device)

    def t(key, dtype=np.float32):
        v = fields.get(key)
        if v is None:
            return None
        return torch.tensor(np.asarray(v, dtype), device=device)

    return NEEATState(
        tile_pdf=t("tile_pdf"), tile_cdf=t("tile_cdf"), ema=t("ema"),
        idx_k=t("idx_k", np.int32), frame=int(fields.get("frame") or 0),
        conf=t("conf"), trust=t("trust"), power=t("power"),
        n_tiles_x=int(fields["n_tiles_x"]), n_tiles_y=int(fields["n_tiles_y"]),
        n_lights=int(fields["n_lights"]))


def tile_of(state: NEEATState, px, py):
    tx = torch.clamp(px.to(torch.int64) // TILE, 0, state.n_tiles_x - 1)
    ty = torch.clamp(py.to(torch.int64) // TILE, 0, state.n_tiles_y - 1)
    return ty * state.n_tiles_x + tx


def _slot_of(li, salt: Optional[int] = None):
    """Hash slot of light li: a stable primary slot, or with `salt` (the
    frame) the secondary probe of lanes that lost the primary claim."""
    h = rng._mul32(rng._u32(li), 2654435761)
    if salt is not None:
        h = (h + (((salt & rng.M32) * 0x9E3779B9 + 0x85EBCA6B) & rng.M32)) \
            & rng.M32
    return h % TOPK


def _local_pmf(state: NEEATState, lights: LightList, tile, li):
    """Tile-local selection pmf of light li; a top-K tile without feedback
    yet samples the global power pmf."""
    if not state.topk:
        return state.tile_pdf[tile, li]
    ids = state.idx_k[tile]                            # [N, K]
    pdf = state.tile_pdf[tile]
    stored = torch.sum(torch.where(ids == li[..., None], pdf, 0.0), dim=-1)
    empty = torch.sum(pdf, dim=-1) < 0.5
    return torch.where(empty, lights.power[li], stored)


def tile_alpha(state: NEEATState, tile):
    """Per-tile weight of the global pmf in the mixture."""
    if state.trust is None or state.topk:
        return torch.full(tile.shape, ALPHA_GLOBAL, dtype=torch.float32,
                          device=tile.device)
    return ALPHA_GLOBAL - (ALPHA_GLOBAL - ALPHA_MIN) * state.trust[tile]


def select_pdf(state: NEEATState, lights: LightList, tile, li):
    """Mixture selection pmf of light li at tile `tile` (for MIS)."""
    li = li.to(torch.int64)
    local = _local_pmf(state, lights, tile, li)
    a = tile_alpha(state, tile)
    return a * lights.power[li] + (1.0 - a) * local


def _tile_cdf_select(state: NEEATState, tile, u):
    """Entries of each lane's tile CDF below u (the searchsorted of the
    local branch), in passes of at most _GATHER_ELEMS gathered entries."""
    n = tile.shape[0]
    step = max(1, _GATHER_ELEMS // max(state.tile_cdf.shape[1], 1))
    parts = []
    for lo in range(0, n, step):
        rows = state.tile_cdf[tile[lo:lo + step]]
        parts.append(torch.sum(rows < u[lo:lo + step, None], dim=-1))
    return torch.cat(parts) if parts else torch.zeros_like(tile)


def sample_adaptive(state: NEEATState, lights: LightList, envmap, shade_pos,
                    px, py, u_mix, u_sel, u1, u2):
    """NEE-AT light sample: the defensive mixture of the tile CDF and the
    power CDF. Same contract as lights_baker.sample_light (plus `tile`);
    pdf is the exact mixture pmf times the light's solid-angle density."""
    from rtxpt_tpu_torch.pt.restir import eval_light_sample

    tile = tile_of(state, px, py)
    use_global = u_mix < tile_alpha(state, tile)
    gs = sample_light(lights, envmap, shade_pos, u_sel, u1, u2)

    u = torch.clamp(u_sel, 0.0, 1.0 - 1e-7)
    sel = _tile_cdf_select(state, tile, u)
    if state.topk:
        slot = torch.clamp(sel, 0, TOPK - 1)
        li_local = torch.gather(state.idx_k[tile], 1, slot[:, None])[:, 0]
        li_local = torch.where(li_local >= 0, li_local, gs["light_index"])
    else:
        li_local = torch.clamp(sel, 0, lights.count - 1)
    li = torch.where(use_global, gs["light_index"].to(torch.int64),
                     li_local.to(torch.int64))
    wi, dist, Li, src_pdf = eval_light_sample(
        lights, envmap, li, torch.stack([u1, u2], -1), shade_pos)
    sel_global = lights.power[li]
    sel_mix = select_pdf(state, lights, tile, li)
    pdf = src_pdf * sel_mix / torch.clamp(sel_global, min=1e-12)
    kind = lights.kind[li]
    is_delta = (kind == KIND_POINT) | (kind == KIND_SPOT) \
        | (kind == KIND_DIRECTIONAL)
    valid = (pdf > 1e-12) & (torch.amax(torch.abs(Li), -1) >= 0.0)
    return dict(wi=wi, dist=dist, Li=Li, pdf=pdf, is_delta=is_delta,
                valid=valid, light_index=li.to(torch.int32),
                tile=tile.to(torch.int32))


def zero_hist(state: NEEATState):
    """Fresh per-frame feedback accumulator."""
    if not state.topk:
        return torch.zeros_like(state.ema)
    return torch.zeros_like(state.ema), torch.full_like(state.idx_k, -1)


def accumulate_feedback(state: NEEATState, hist, tile, li, weight, valid):
    """Merge one bounce's contribution luminances (weight [N] at tile [N],
    light li [N], where valid) into the frame accumulator; returns the new
    accumulator."""
    tile = tile.to(torch.int64)
    li = li.to(torch.int64)
    w = torch.where(valid, weight, 0.0)
    if not state.topk:
        return hist.index_put((tile, li), w, accumulate=True)
    t, k = state.ema.shape
    lanes_idx = torch.arange(tile.shape[0], device=tile.device)

    def claim(slot, lanes):
        # lanes off the claim write to the dropped entry t*k
        key = torch.where(lanes, tile * k + slot, t * k)
        last = torch.full((t * k + 1,), -1, dtype=torch.int64,
                          device=tile.device).scatter_reduce(
            0, key, torch.where(lanes, lanes_idx, -1), "amax")
        idx_b = torch.where(last >= 0, li[last.clamp(min=0)], -1)
        owner = lanes & (idx_b[key] == li)
        h_b = torch.zeros((t * k + 1,), dtype=torch.float32,
                          device=tile.device).index_put(
            (key,), torch.where(owner, w, 0.0), accumulate=True)
        return ((h_b[:-1].view(t, k), idx_b[:-1].view(t, k).to(torch.int32)),
                owner)

    tab0, owner0 = claim(_slot_of(li), valid)
    tab1, _ = claim(_slot_of(li, state.frame), valid & ~owner0)
    return _merge_sparse(hist, _merge_sparse(tab0, tab1))


def _merge_sparse(a, b):
    """Merge two (weights, ids) slot tables: the same id adds, an empty
    slot fills, a conflict keeps the heavier entry."""
    ha, ia = a
    hb, ib = b
    same = (ia == ib) & (ia >= 0)
    a_empty = ia < 0
    b_empty = ib < 0
    conflict = ~same & ~a_empty & ~b_empty
    take_b = a_empty | (conflict & (hb > ha))
    h = torch.where(same, ha + hb, torch.where(take_b, hb, ha))
    idx = torch.where(same, ia, torch.where(take_b, ib, ia))
    return h, idx


def _reproject_rows(state: NEEATState, arrs, motion):
    """Each tile's history gathered from its motion-reprojected source
    tile (nearest tile, clamped); motion [H, W, 2] in pixels."""
    ntx, nty = state.n_tiles_x, state.n_tiles_y
    h, w = motion.shape[:2]
    pad = torch.zeros((nty * TILE, ntx * TILE, 2), dtype=motion.dtype,
                      device=motion.device)
    pad[:h, :w] = motion
    mt = pad.reshape(nty, TILE, ntx, TILE, 2).mean(dim=(1, 3))
    tx = torch.arange(ntx, device=motion.device)[None, :]
    ty = torch.arange(nty, device=motion.device)[:, None]
    sx = torch.clamp(torch.round(tx + mt[..., 0] / TILE), 0, ntx - 1)
    sy = torch.clamp(torch.round(ty + mt[..., 1] / TILE), 0, nty - 1)
    src = (sy.to(torch.int64) * ntx + sx.to(torch.int64)).reshape(-1)
    return [a[src] for a in arrs]


def update(state: NEEATState, frame_hist, motion=None) -> NEEATState:
    """Reprojection (optional), temporal EMA and the per-tile CDF rebuild."""
    frame = (state.frame + 1) & rng.M32
    conf = state.conf
    if conf is not None:
        fh = frame_hist if not state.topk else frame_hist[0]
        got = (torch.sum(fh, -1) > 1e-9).to(torch.float32)
        if motion is not None:
            (conf,) = _reproject_rows(state, [conf], motion)
        conf = conf * EMA + got * (1.0 - EMA)
    trust = state.trust
    if not state.topk:
        ema = state.ema
        if motion is not None:
            (ema,) = _reproject_rows(state, [ema], motion)
        ema = ema * EMA + frame_hist * (1.0 - EMA)
        total = torch.sum(ema, -1, keepdim=True)
        n = ema.shape[-1]
        pdf = torch.where(total > 1e-9, ema / torch.clamp(total, min=1e-9),
                          torch.full_like(ema, 1.0 / n))
        cdf = torch.cumsum(pdf, -1)
        cdf = cdf / torch.clamp(cdf[..., -1:], min=1e-9)
        if trust is not None and state.power is not None:
            # anneal only where the learned pmf diverges from the power
            # pmf, stays stable between frames and has history
            tv = 0.5 * torch.sum(torch.abs(pdf - state.power[None, :]), -1)
            churn = 0.5 * torch.sum(torch.abs(pdf - state.tile_pdf), -1)
            trust = (torch.clamp(conf / 0.85, 0.0, 1.0)
                     * torch.clamp(tv / 0.4, 0.0, 1.0)
                     * torch.clamp(1.0 - churn / 0.1, 0.0, 1.0))
        return state.replace(tile_pdf=pdf, tile_cdf=cdf, ema=ema,
                             frame=frame, conf=conf, trust=trust)

    hist_k, idx_f = frame_hist
    ema, idx_k = state.ema, state.idx_k
    if motion is not None:
        ema, idx_k = _reproject_rows(state, [ema, idx_k], motion)
    # a slot keeps its EMA when the frame claimed the same light; a slot
    # claimed by a new light restarts from the fresh weight
    same = (idx_f == idx_k) & (idx_f >= 0)
    fresh = (idx_f >= 0) & ~same
    ema = torch.where(same, ema * EMA + hist_k * (1.0 - EMA),
                      torch.where(fresh, hist_k * (1.0 - EMA), ema * EMA))
    idx_k = torch.where(idx_f >= 0, idx_f, idx_k)
    w = torch.where(idx_k >= 0, ema, 0.0)
    total = torch.sum(w, -1, keepdim=True)
    pdf = torch.where(total > 1e-9, w / torch.clamp(total, min=1e-9), 0.0)
    cdf = torch.cumsum(pdf, -1)
    cdf = torch.where(total > 1e-9,
                      cdf / torch.clamp(cdf[..., -1:], min=1e-9),
                      torch.ones_like(cdf))
    return state.replace(tile_pdf=pdf, tile_cdf=cdf, ema=ema, idx_k=idx_k,
                         frame=frame, conf=conf, trust=trust)


def merge_hists(state: NEEATState, hists):
    """Merge a sequence of per-chunk frame accumulators."""
    hists = list(hists)
    if not state.topk:
        return torch.sum(torch.stack(hists), dim=0)
    acc = hists[0]
    for h in hists[1:]:
        acc = _merge_sparse(acc, h)
    return acc
