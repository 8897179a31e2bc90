"""External NEE (counterpart of rtxpt_tpu/pt/nee_external.py): light
selection, light sampling, BSDF evaluation and MIS for a wavefront whose
shaded surfaces the fused bounce kernel K1 exported (its external modes,
the SF_* rows of pt/bounce_fused.py).

This route serves what the kernel's 128-column light table cannot:
NEE-AT (the per-tile state of lighting/neeat.py), more than 128 lights,
and weighted reservoir sampling over K > 1 candidates, on the fused tier
(K1's export) and on the clustered tier (K4's export, the same rows).
The kernel keeps the intersection, the surface, the scatter and Russian
roulette; the shadow rays built here go back to the shadow kernel, K2
(`bounce_fused.occlusion`) or K5 (`bounce_clustered.occlusion`).

The JAX package runs this block as a `lax.map` over lane chunks to bound
the [lanes, lights] gather of the NEE-AT tile CDF; here the wavefront
runs in one pass and `neeat.sample_adaptive` bounds that gather itself.
The clustered tier passes each lane's logical bounce (`lb`), which
keys the NEE seed and the emissive MIS per lane, as in the JAX package.
With the split channels (`first_spec`) the result also holds the NEE
contribution's diffuse part. Without the first vertex's direct light
(`first_direct=False`, the real-time fill under an external direct-light
pass) no lane draws a NEE sample at logical bounce 0.
"""

from __future__ import annotations

import torch

from rtxpt_tpu_torch.config import NEEMode
from rtxpt_tpu_torch.lighting import neeat as na
from rtxpt_tpu_torch.lighting.lights_baker import sample_light
from rtxpt_tpu_torch.pt import bsdf as B
from rtxpt_tpu_torch.pt.bounce_fused import (
    EFFECT_NEE, MT_DTRANS, MT_SPEC, MT_TRANS, SF_BASE, SF_EMIT, SF_ETA,
    SF_GN, SF_LID, SF_METAL, SF_MID, SF_PGEO, SF_POS, SF_ROUGH, SF_SHN,
    SF_THP,
)
from rtxpt_tpu_torch.pt.surface import ray_offset
from rtxpt_tpu_torch.utils import math as m
from rtxpt_tpu_torch.utils import rng


def _rebuild_bsdf(mat_rows, surf):
    """BSDFData from the exported surface rows (make_bsdf_data with the
    kernel's eta). The material scalars the rows do not carry come from
    the bounce tables' material rows (MT_*), indexed by the exported
    material id, which the kernel clamped to the table."""
    mid = torch.clamp(surf[SF_MID].to(torch.int64), 0, mat_rows.shape[1] - 1)
    base = surf[SF_BASE:SF_BASE + 3].T
    metal = surf[SF_METAL]
    rough = surf[SF_ROUGH]
    spec_scale = mat_rows[MT_SPEC][mid]
    trans = mat_rows[MT_TRANS][mid]
    dtrans = mat_rows[MT_DTRANS][mid]
    f0_dielec = (0.08 * spec_scale * (1.0 - metal))[..., None]
    diffuse = base * (1.0 - metal[..., None])
    return B.BSDFData(
        diffuse=diffuse, specular_f0=f0_dielec + base * metal[..., None],
        alpha=torch.clamp(rough * rough, 0.0, 1.0),
        transmission=trans * (1.0 - metal),
        diffuse_transmission=dtrans * (1.0 - metal),
        eta=surf[SF_ETA], transmission_color=torch.ones_like(diffuse))


def _where(cond, a, b):
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def external_nee(scene, cfg, neeat_state, surf, d_in, hit_mask,
                 prev_pdf_in, prev_delta_in, px, py, sample_idx, bounce,
                 first_spec=None, lb=None, first_direct: bool = True):
    """NEE selection, evaluation and MIS for a kernel-exported wavefront.

    surf [SF_ROWS, N] f32; d_in [3, N] incident ray directions; hit_mask
    [N] bool (the lanes K1 shaded); prev_pdf_in, prev_delta_in [N]: the
    incoming ray's MIS state, for the emissive MIS that K1 defers in the
    NEE-AT mode; px, py [N] int; `bounce` the wavefront's bounce index,
    or with `lb` ([N] int, the lanes' logical bounces before this one)
    the per-lane bounce instead.

    Returns dict(em_add [N,3], shadow_o [N,3], shadow_d [N,3], sdist [N],
    contrib [N,3] (zero where not do_nee), do_nee [N] bool, li [N] i32,
    tile [N] i32). The caller resolves the shadow rays, adds contrib where
    unoccluded, and feeds (tile, li, luminance, ok) to
    neeat.accumulate_feedback. With `first_spec` ([N] bool, the split
    channels' first-scatter flag) it also holds cdiff [N,3] (zero where not
    do_nee): contrib's diffuse part, its exact lobe share (bsdf_eval_split
    over bsdf_eval) at logical bounce 0, and after that all of contrib or
    none of it by the first scatter's lobe (nee_external.py:241-253).
    `first_direct=False` keeps do_nee off at logical bounce 0: per lane
    with `lb`, else where `bounce` is 0 (nee_external.py:215-219)."""
    lights = scene.lights
    envmap = scene.envmap
    n = surf.shape[1]
    dev = surf.device
    use_neeat = cfg.nee.value == NEEMode.NEEAT.value \
        and neeat_state is not None
    nee_uniform = cfg.nee.value == NEEMode.UNIFORM.value
    k_cand = max(int(cfg.nee_candidates), 1)

    pos = surf[SF_POS:SF_POS + 3].T
    sh_n = surf[SF_SHN:SF_SHN + 3].T
    gn = surf[SF_GN:SF_GN + 3].T
    thp = surf[SF_THP:SF_THP + 3].T
    tables = scene.bounce_tables if scene.bounce_tables is not None \
        else scene.cluster_tables
    bsdf = _rebuild_bsdf(tables.mat_rows, surf)
    wo = m.to_local(-d_in.T, sh_n)

    # --- deferred emissive MIS (the NEE-AT mixture selection pmf) ---
    em3 = surf[SF_EMIT:SF_EMIT + 3].T
    lid = surf[SF_LID].to(torch.int64)
    p_geo = surf[SF_PGEO]
    if use_neeat and cfg.enable_mis:
        tile0 = na.tile_of(neeat_state, px, py)
        sel_mix = na.select_pdf(neeat_state, lights, tile0,
                                torch.clamp(lid, min=0))
        p_light = torch.where(lid >= 0, sel_mix * p_geo, 0.0)
        lb0 = (lb == 0) if lb is not None else bounce == 0
        w_em = torch.where(prev_delta_in | lb0, 1.0,
                           m.power_heuristic(prev_pdf_in, p_light))
    else:
        w_em = torch.ones((n,), dtype=torch.float32, device=dev)
    em_add = em3 * w_em[..., None]

    # --- candidate selection (WRS over k_cand candidates) ---
    seed_nee = rng.pixel_seed(px, py, bounce if lb is None else lb,
                              EFFECT_NEE)

    def lds(dims):
        if cfg.low_discrepancy:
            return rng.ld_samples(sample_idx, seed_nee, dims)
        return tuple(rng.uniform_sample(seed_nee,
                                        rng.hash_combine(sample_idx, dd))
                     for dd in dims)

    def candidate(ci):
        base = 8 * ci
        u_sel, u1, u2, u_mix = lds((base, base + 2, base + 3, base + 4))
        if use_neeat:
            lsc = na.sample_adaptive(neeat_state, lights, envmap, pos, px, py,
                                     u_mix, u_sel, u1, u2)
        else:
            lsc = sample_light(lights, envmap, pos, u_sel, u1, u2,
                               uniform=nee_uniform)
            lsc["tile"] = torch.zeros((n,), dtype=torch.int32, device=dev)
        wi_lc = m.to_local(lsc["wi"], sh_n)
        return lsc, wi_lc, B.bsdf_eval(bsdf, wo, wi_lc)

    ls, wi_l, f_l = candidate(0)
    if k_cand > 1:
        def target(lsc, f_lc):
            p_hat = m.luminance(f_lc * lsc["Li"]) \
                / torch.clamp(lsc["pdf"], min=1e-12)
            return torch.where(lsc["valid"], p_hat, 0.0)

        p_hat_sel = target(ls, f_l)
        w_sum = p_hat_sel
        for ci in range(1, k_cand):
            lsc, wi_lc, f_lc = candidate(ci)
            p_hat = target(lsc, f_lc)
            w_sum = w_sum + p_hat
            (u_acc,) = lds((8 * ci + 5,))
            accept = (u_acc * torch.clamp(w_sum, min=1e-20)) < p_hat
            ls = {k: _where(accept, lsc[k], v) for k, v in ls.items()}
            wi_l = _where(accept, wi_lc, wi_l)
            f_l = _where(accept, f_lc, f_l)
            p_hat_sel = torch.where(accept, p_hat, p_hat_sel)
        eff = torch.where(p_hat_sel > 1e-12,
                          k_cand * p_hat_sel / torch.clamp(w_sum, min=1e-12),
                          0.0)
        ls["pdf"] = ls["pdf"] * eff
        ls["valid"] = ls["valid"] & (eff > 0.0)
    pdf_b = B.bsdf_pdf(bsdf, wo, wi_l)

    do_nee = hit_mask & ls["valid"] & (m.luminance(f_l) > 0.0)
    if not first_direct:
        # the first vertex's direct light is shaded by the caller
        do_nee = do_nee & ((lb > 0) if lb is not None else bounce > 0)
    shadow_o = ray_offset(pos, gn, ls["wi"])
    if cfg.enable_mis:
        w_nee = torch.where(ls["is_delta"], 1.0,
                            m.power_heuristic(ls["pdf"], pdf_b))
    else:
        w_nee = torch.ones((n,), dtype=torch.float32, device=dev)
    contrib = thp * f_l * ls["Li"] * (
        w_nee / torch.clamp(ls["pdf"], min=1e-12))[..., None]
    if cfg.firefly_clamp > 0.0:
        lum = m.luminance(contrib)
        contrib = contrib * torch.clamp(
            cfg.firefly_clamp / torch.clamp(lum, min=1e-12), max=1.0
        )[..., None]
    sdist_eff = ls["dist"] - m.dot(shadow_o - pos, ls["wi"], False)
    sdist = torch.where(do_nee, sdist_eff * (1.0 - 1e-4), 0.0)
    out = dict(em_add=em_add, shadow_o=shadow_o, shadow_d=ls["wi"],
               sdist=sdist, contrib=torch.where(do_nee[..., None], contrib,
                                                0.0),
               do_nee=do_nee, li=ls["light_index"].to(torch.int32),
               tile=ls["tile"].to(torch.int32))
    if first_spec is not None:
        f_dp, _ = B.bsdf_eval_split(bsdf, wo, wi_l)
        ratio = f_dp / torch.clamp(f_l, min=1e-12)
        lb0 = (lb == 0) if lb is not None else torch.full_like(
            do_nee, bounce == 0)
        cdiff = torch.where(lb0[:, None], contrib * ratio,
                            torch.where(first_spec[:, None], 0.0, contrib))
        out["cdiff"] = torch.where(do_nee[..., None], cdiff, 0.0)
    return out
