"""Wavefront path tracing of whole frames, reference mode (counterpart of
rtxpt_tpu/pt/integrator.py): the camera rays of a frame go, in chunks of
`cfg.ray_chunk`, through the tier `pt/dispatch.resolve` picks: the fused
bounce step (pt/bounce_fused.py), the clustered tier
(pt/bounce_clustered.py), or the general BVH wavefront of this module
(the JAX package's "xla" tier, `_wavefront`). Samples accumulate
progressively (`render`), or with NEE-AT, whose per-tile sampler learns
from each sample before the next (`render_adaptive`)."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.profiler import record_function

from rtxpt_tpu_torch.accel.traverse import scene_any, scene_closest
from rtxpt_tpu_torch.config import NEEMode
from rtxpt_tpu_torch.lighting import neeat as na
from rtxpt_tpu_torch.lighting.envmap import _dir_to_uv, env_eval
from rtxpt_tpu_torch.lighting.lights_baker import (
    emissive_prim_index, env_dir_pdf, env_quad_of_dir, light_pdf_for_tri_hit,
    sample_light, tri_light_of)
from rtxpt_tpu_torch.pt import bounce_clustered, bounce_fused, dispatch
from rtxpt_tpu_torch.pt import bsdf as B
from rtxpt_tpu_torch.pt.surface import guide_buffers, load_surface, ray_offset
from rtxpt_tpu_torch.scene import scene as S
from rtxpt_tpu_torch.scene.camera import Camera, camera_ray
from rtxpt_tpu_torch.utils import math as m
from rtxpt_tpu_torch.utils import rng

# Effect seeds (SampleGenerators effect decorrelation)
EFFECT_LENS = 17
EFFECT_SCATTER = 29
EFFECT_NEE = 31
EFFECT_RR = 37
EFFECT_STF = 41
# The aux guide buffers that `render` averages over its samples (the JAX
# package's render, integrator.py:727-733); trace_paths also returns the
# split albedos with the split channels
AUX_KEYS = ("albedo", "normal", "depth", "wpos", "emission")
# Per-pixel results of a trace (everything else is a count)
PIXEL_KEYS = ("L", "L_diff", "L_spec", "albedo_diff",
              "albedo_spec") + AUX_KEYS
# Bounded false-hit skips per bounce for nested dielectric priorities
# (rtxpt_tpu/pt/integrator.py:47-50: two cover a medium inside another
# whose two boundaries both overlap the segment)
MAX_FALSE_HIT_SKIPS = 2


def _ld(cfg, sample_idx, seed, dim: int):
    if cfg.low_discrepancy:
        return rng.ld_sample(sample_idx, seed, dim)
    return rng.uniform_sample(seed, rng.hash_combine(sample_idx, dim))


def _lds(cfg, sample_idx, seed, dims):
    if cfg.low_discrepancy:
        return rng.ld_samples(sample_idx, seed, dims)
    return tuple(rng.uniform_sample(seed, rng.hash_combine(sample_idx, d))
                 for d in dims)


def _pixel_grid(width: int, height: int, device="cpu"):
    px = torch.arange(width, dtype=torch.int32, device=device)
    py = torch.arange(height, dtype=torch.int32, device=device)
    return (px[None, :].expand(height, width).reshape(-1),
            py[:, None].expand(height, width).reshape(-1))


def camera_rays(cam: Camera, cfg, px, py, sample_idx):
    """Jittered primary rays of pixels (px, py) for one sample:
    (o [N,3], d [N,3], cone spread [N])."""
    seed_lens = rng.pixel_seed(px, py, 0, EFFECT_LENS)
    u1, u2 = _lds(cfg, sample_idx, seed_lens, (0, 1))
    return camera_ray(cam, px, py, u1, u2)


def trace_paths(scene, cfg, o, d, cone_spread, px, py, sample_idx,
                neeat_state=None, want_aux: bool = False,
                first_emissive: bool = True, first_hit=None,
                bounce_budget=None, first_direct: bool = True):
    """Trace a wavefront of camera rays to completion on the tier
    `dispatch.resolve` picks for the scene and the rays' device. Returns
    dict(L [N,3], ray_count [], occupancy [max_bounces+1]), plus
    cull_overflow [] on the clustered tier and neeat_hist with NEE-AT.
    With `want_aux` the first hit's guide buffers: albedo, normal, wpos,
    emission [N,3] and depth [N] (1 in the albedo and 0 elsewhere on a
    miss). With `cfg.split_channels` NRD's diffuse/specular partition
    L_diff, L_spec [N,3] (L_diff + L_spec = L less the primary vertex's
    emission) and the aux buffers' albedo_diff and albedo_spec: on the
    fused and clustered tiers keyed on the config alone, on the general
    tier only with want_aux too, as in the JAX package.
    `first_emissive=False` drops the emission seen by the camera rays
    (general tier only).

    The real-time arguments (rtxpt_tpu/pt/integrator.py:66-86): `first_hit`
    (an `accel.traverse.Hit` per lane, a stable plane's V-buffer) restarts
    the paths from those hits, bounce 0 tracing nothing;
    `bounce_budget` [N] int stops each lane's scattering once its bounce
    reaches it; `first_direct=False` leaves the first vertex's direct light
    (NEE at bounce 0, the emission and environment gathered at bounce 1)
    to the caller. The fused tier serves them in K1 (its inject variant at
    bounce 0); the clustered tier hands such a call to the general tier,
    as the JAX package does for `first_hit` and `first_direct=False`, and
    for a budget without them too (F14: the JAX clustered tier drops it)."""
    cfg = dispatch.resolve(scene, cfg, o.device, neeat_state,
                           first_hit=first_hit,
                           bounce_budget=bounce_budget,
                           first_direct=first_direct)
    if cfg.kernel_tier == "xla":
        return _wavefront(scene, cfg, o, d, px, py, sample_idx, neeat_state,
                          first_emissive, cone_spread, want_aux, first_hit,
                          bounce_budget, first_direct)
    if not first_emissive:
        raise NotImplementedError(f"first_emissive=False on the "
                                  f"{cfg.kernel_tier} tier is not ported")
    if cfg.kernel_tier == "clustered":
        return bounce_clustered.trace_paths_clustered(
            scene, cfg, o, d, cone_spread, px, py, sample_idx, neeat_state,
            want_aux)
    return bounce_fused.trace_paths_fused(
        scene, cfg, o, d, cone_spread, px, py, sample_idx, neeat_state,
        want_aux, first_hit, bounce_budget, first_direct)


def _skip_false_hits(scene, prio, closest_fn, o, d, hit, active, med0, med1,
                     t_far):
    """The nested-priority false-hit rejection after a closest hit
    (rtxpt_tpu/pt/integrator.py:233-268; PathTracerNestedDielectrics'
    semantics): a hit on the boundary of a non-thin transmissive material
    is false when it enters a medium of lower priority than the current
    one (med0) or leaves a medium other than the current one. The
    interior list's lower slot med1 takes the entered medium if it
    outranks med1's, or drops the left one if it is med1's, and the ray
    is traced again from just past the surface, at most
    MAX_FALSE_HIT_SKIPS times (every lane takes part in each query, as in
    the JAX package). `prio` [M] i64: the materials' priorities on the
    rays' device. Returns (hit, med1)."""
    mp = scene.mat_pack
    tri_mat = scene.tri_pack[:, -1].long()

    def prio_of(med):
        return torch.where(med >= 0, prio[torch.clamp(med, min=0)], -1)

    for _ in range(MAX_FALSE_HIT_SKIPS):
        mh = tri_mat[torch.clamp(hit.prim, min=0).long()]
        boundary = (mp[mh, S.MP_THIN] < 0.5) & (mp[mh, S.MP_TRANS] > 0.0)
        p_hit = prio[mh]
        false_enter = boundary & hit.front & (p_hit < prio_of(med0))
        false_exit = boundary & ~hit.front & (mh != med0)
        fh = active & ~hit.miss & (false_enter | false_exit)
        med1 = torch.where(
            fh & false_enter & ((med1 < 0) | (p_hit > prio_of(med1))), mh,
            torch.where(fh & false_exit & (mh == med1), -1, med1))
        tmin = torch.where(fh, hit.t * (1.0 + 1e-4) + 1e-5, 0.0)
        hit = hit.where(fh, closest_fn(o, d, tmin,
                                       torch.where(fh, t_far, 0.0)))
    return hit, med1


def _where(cond, a, b):
    return torch.where(cond.reshape(cond.shape + (1,) * (a.ndim - 1)), a, b)


def _wavefront(scene, cfg, o, d, px, py, sample_idx, neeat_state=None,
               first_emissive: bool = True, cone_spread=None,
               want_aux: bool = False, first_hit=None, bounce_budget=None,
               first_direct: bool = True):
    """The general BVH wavefront (rtxpt_tpu/pt/integrator.py trace_paths on
    the "xla" tier), with the real-time arguments of `trace_paths`: bounce
    0 takes `first_hit` instead of a query (on a scene with nested
    priorities the false-hit retrace still runs on it, as in the JAX
    package), the budget masks the lanes after the bounce's environment
    (integrator.py:326-327), and `first_direct=False` gates the emission,
    the environment and NEE of the first vertex (:275, :378, :407).
    Every lane is traced at every bounce, inactive ones too, as in the JAX
    package.

    Per bounce: the closest hit (`accel.traverse.scene_closest`: K8 for
    scenes with brute tables, else the BVH walk K9, or their plain
    versions on CPU tensors; the TLAS walk of accel/tlas.py on a
    two-level scene), the environment of the rays that miss (HandleMiss,
    with the MIS weight against the power / uniform environment pdf, or
    under NEE-AT against the tile mixture's uniform-uv strategy), the
    medium's Beer-Lambert transmittance, the surface (its texture maps at
    the ray cone's MIP: bilinear, or with `cfg.stochastic_texture_filtering`
    one jittered texel each, the uniforms from the EFFECT_STF seed), the
    emission with
    its deferred MIS, NEE (uniform, power or NEE-AT over every light kind,
    WRS over `cfg.nee_candidates`), the BSDF scatter with the two-slot
    medium stack, and Russian roulette. With brute tables and
    NEE on, bounce k's shadow rays ride in bounce k+1's closest-hit query
    (one 2N-wide query; a hit within the shadow distance occludes);
    otherwise each NEE bounce makes an any-hit query (K9's any-hit
    variant). On an alpha-tested scene every query, the shadow rays'
    too, is the alpha-tested closest hit (scene/omm.py
    intersect_closest_alpha: the walk rejects micro-TRANSPARENT hits, the
    texture test and the retrace resolve the rest; K8 has no micromaps,
    so on the brute path the retrace resolves every MIXED hit). On a scene
    with nested priorities each closest hit is followed by the bounded
    false-hit retrace (`_skip_false_hits`) through the same query.
    With `want_aux` the bounce-0 surface fills the aux guide buffers, and
    with `cfg.split_channels` too the radiance is partitioned as NRD's
    diffuse/specular channels (integrator.py:144-151): the primary
    vertex's NEE by exact lobe evaluation (bsdf_eval_split over
    bsdf_eval), every later contribution by the lobe of the first
    scatter, the primary vertex's emission in neither."""
    n = o.shape[0]
    dev = o.device
    if scene.tri_opacity is not None and scene.textures is not None:
        from rtxpt_tpu_torch.scene.omm import (
            intersect_any_alpha, intersect_closest_alpha)

        def closest_fn(*q):
            return intersect_closest_alpha(scene, *q)

        def any_fn(*q):
            return intersect_any_alpha(scene, *q)
    else:
        def closest_fn(*q):
            return scene_closest(scene, *q)

        def any_fn(*q):
            return scene_any(scene, *q)
    f32 = torch.float32
    o, d = o.contiguous(), d.contiguous()   # camera origins are broadcast
    mp = scene.mat_pack
    lights = scene.lights

    def zeros(*shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    L = zeros(n, 3)
    thp = torch.ones((n, 3), dtype=f32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    prev_pdf = zeros(n)                 # BSDF pdf of the previous scatter
    prev_delta = torch.ones_like(active)  # previous vertex delta (or camera)
    # two-slot medium stack of material ids (-1 = air)
    med0 = torch.full((n,), -1, dtype=torch.int64, device=dev)
    med1 = med0.clone()
    ray_count = zeros(dtype=torch.int64)
    occupancy = []
    t_zero = zeros(n)
    t_far = torch.full((n,), float(cfg.max_ray_travel), dtype=f32,
                       device=dev)

    use_nee = cfg.nee.value != NEEMode.OFF.value and lights is not None
    nee_uniform = cfg.nee.value == NEEMode.UNIFORM.value
    use_neeat = (cfg.nee.value == NEEMode.NEEAT.value
                 and neeat_state is not None and lights is not None)
    hist = na.zero_hist(neeat_state) if use_neeat else None
    fuse_shadows = (scene.bvh is not None and scene.bvh.brute is not None
                    and use_nee)
    has_env = scene.envmap is not None and scene.envmap.has_radiance
    pend_contrib = zeros(n, 3)
    pend_o = zeros(n, 3)
    pend_d = torch.ones((n, 3), dtype=f32, device=dev)
    pend_dist = zeros(n)
    pend_mask = zeros(n, dtype=torch.bool)
    pend_tile = pend_li = None
    # the ray cone: its width at the hit sets the texture MIP, its spread
    # grows with each scatter lobe's roughness
    cone_width = zeros(n)
    if cone_spread is None:
        cone_spread = zeros(n)
    stf = cfg.stochastic_texture_filtering and scene.textures is not None
    prio = scene.materials.nested_priority.to(device=dev, dtype=torch.int64) \
        if scene.has_nested_priorities else None
    aux = {}
    split = bool(cfg.split_channels) and want_aux
    L_diff, L_spec = zeros(n, 3), zeros(n, 3)
    first_spec = zeros(n, dtype=torch.bool)
    pend_cdiff = zeros(n, 3)

    for bounce in range(cfg.max_bounces + 1):
        # ----- closest hit (+ the previous bounce's shadow rays) -----
        occupancy.append(active.sum(dtype=torch.int64))
        ray_count = ray_count + active.sum() + pend_mask.sum()
        if fuse_shadows and bounce > 0:
            hit2 = closest_fn(torch.cat([o, pend_o]),
                                 torch.cat([d, pend_d]), zeros(2 * n),
                                 torch.cat([t_far, pend_dist]))
            hit = hit2.take(slice(0, n))
            ok = pend_mask & hit2.miss[n:]
            L = L + torch.where(ok[:, None], pend_contrib, 0.0)
            if split:
                L_diff = L_diff + torch.where(ok[:, None], pend_cdiff, 0.0)
                L_spec = L_spec + torch.where(ok[:, None],
                                              pend_contrib - pend_cdiff, 0.0)
            if use_neeat:
                hist = na.accumulate_feedback(
                    neeat_state, hist, pend_tile, pend_li,
                    m.luminance(pend_contrib), ok)
            pend_mask = zeros(n, dtype=torch.bool)
        elif bounce == 0 and first_hit is not None:
            hit = first_hit          # the V-buffer restart: no query
        else:
            hit = closest_fn(o, d, t_zero, t_far)
        if prio is not None:
            hit, med1 = _skip_false_hits(scene, prio, closest_fn, o, d, hit,
                                         active, med0, med1, t_far)
        hit_mask = active & ~hit.miss
        # the first vertex's direct light: its NEE, and the emission and
        # environment the next bounce gathers
        direct = first_direct or bounce != 1
        if has_env and (first_emissive or bounce > 0) and direct:
            c_env = _handle_miss(scene, cfg, d, thp, active & hit.miss,
                                 prev_pdf, prev_delta, px, py, neeat_state,
                                 use_nee, use_neeat, nee_uniform)
            L = L + c_env
            if split:
                cd = torch.where(first_spec[:, None], 0.0, c_env)
                L_diff = L_diff + cd
                L_spec = L_spec + (c_env - cd)
        active = hit_mask
        if bounce == cfg.max_bounces:
            break
        if bounce_budget is not None:
            active = active & (bounce < bounce_budget)
            hit_mask = hit_mask & active

        # ----- surface and the medium's transmittance (Beer-Lambert) -----
        in_medium = med0 >= 0
        m0 = torch.clamp(med0, min=0)
        cur_ior = torch.where(in_medium, mp[m0, S.MP_IOR], 1.0)
        below_ior = torch.where(med1 >= 0,
                                mp[torch.clamp(med1, min=0), S.MP_IOR], 1.0)
        cone_width = cone_width + cone_spread * hit.t
        stf_u = None
        if stf:
            seed_tx = rng.pixel_seed(px, py, bounce, EFFECT_STF)
            stf_u = torch.stack(_lds(cfg, sample_idx, seed_tx, (0, 1)), -1)
        surf = load_surface(scene, hit, o, d, cur_ior=cur_ior,
                            below_ior=below_ior, cone_width=cone_width,
                            stf_u=stf_u)
        sigma = mp[m0, S.MP_VOLABS:S.MP_VOLABS + 3]
        thp = thp * torch.where(in_medium[:, None],
                                torch.exp(-sigma * hit.t[:, None]), 1.0)

        # ----- emissive hit with its MIS weight -----
        if cfg.enable_mis and use_nee and bounce > 0:
            cos_l = torch.abs(m.dot(-d, surf.geo_n, False))
            eprim = emissive_prim_index(scene, hit.prim, hit.inst)
            p_light = light_pdf_for_tri_hit(lights, eprim, hit.t, cos_l,
                                            nee_uniform)
            if use_neeat:
                # rescale the selection part to the NEE-AT mixture
                li_hit = torch.clamp(tri_light_of(lights, eprim),
                                     min=0).long()
                sel_mix = na.select_pdf(neeat_state, lights,
                                        na.tile_of(neeat_state, px, py),
                                        li_hit)
                p_light = p_light * sel_mix / torch.clamp(
                    lights.power[li_hit], min=1e-12)
            w_em = torch.where(prev_delta, 1.0,
                               m.power_heuristic(prev_pdf, p_light))
        else:
            w_em = torch.ones((n,), dtype=f32, device=dev)
        if (first_emissive or bounce > 0) and direct:
            L = L + torch.where(hit_mask[:, None],
                                thp * surf.emissive * w_em[:, None], 0.0)
            if split and bounce > 0:
                em_c = thp * surf.emissive * w_em[:, None]
                cd = torch.where(first_spec[:, None], 0.0, em_c)
                L_diff = L_diff + torch.where(hit_mask[:, None], cd, 0.0)
                L_spec = L_spec + torch.where(hit_mask[:, None], em_c - cd,
                                              0.0)
        if want_aux and bounce == 0:
            aux = guide_buffers(surf, hit.t, hit_mask, split)
        wo = m.to_local(-d, surf.sh_n)

        # ----- NEE (WRS over cfg.nee_candidates light samples) -----
        if use_nee and (first_direct or bounce > 0):
            seed_nee = rng.pixel_seed(px, py, bounce, EFFECT_NEE)

            def candidate(ci):
                base = 8 * ci
                u_sel, u1, u2, u_mix = _lds(
                    cfg, sample_idx, seed_nee,
                    (base, base + 2, base + 3, base + 4))
                if use_neeat:
                    lsc = na.sample_adaptive(neeat_state, lights,
                                             scene.envmap, surf.pos, px, py,
                                             u_mix, u_sel, u1, u2)
                else:
                    lsc = sample_light(lights, scene.envmap, surf.pos, u_sel,
                                       u1, u2, uniform=nee_uniform)
                wi_lc = m.to_local(lsc["wi"], surf.sh_n)
                return lsc, wi_lc, B.bsdf_eval(surf.bsdf, wo, wi_lc)

            k_cand = max(int(cfg.nee_candidates), 1)
            ls, wi_l, f_l = candidate(0)
            if k_cand > 1:
                def target(lsc, f_lc):
                    p_hat = m.luminance(f_lc * lsc["Li"]) \
                        / torch.clamp(lsc["pdf"], min=1e-12)
                    return torch.where(lsc["valid"], p_hat, 0.0)

                p_hat_sel = w_sum = target(ls, f_l)
                for ci in range(1, k_cand):
                    lsc, wi_lc, f_lc = candidate(ci)
                    p_hat = target(lsc, f_lc)
                    w_sum = w_sum + p_hat
                    u_acc = _ld(cfg, sample_idx, seed_nee, 8 * ci + 5)
                    accept = (u_acc * torch.clamp(w_sum, min=1e-20)) < p_hat
                    ls = {k: _where(accept, lsc[k], v) for k, v in ls.items()}
                    wi_l = _where(accept, wi_lc, wi_l)
                    f_l = _where(accept, f_lc, f_l)
                    p_hat_sel = torch.where(accept, p_hat, p_hat_sel)
                # RIS: W = w_sum / (K p_hat_sel), folded into the pdf
                eff = torch.where(p_hat_sel > 1e-12, k_cand * p_hat_sel
                                  / torch.clamp(w_sum, min=1e-12), 0.0)
                ls["pdf"] = ls["pdf"] * eff
                ls["valid"] = ls["valid"] & (eff > 0.0)
            pdf_b = B.bsdf_pdf(surf.bsdf, wo, wi_l)
            do_nee = hit_mask & ls["valid"] & (m.luminance(f_l) > 0.0)
            shadow_o = ray_offset(surf.pos, surf.geo_n, ls["wi"])
            if cfg.enable_mis:
                w_nee = torch.where(ls["is_delta"], 1.0,
                                    m.power_heuristic(ls["pdf"], pdf_b))
            else:
                w_nee = torch.ones((n,), dtype=f32, device=dev)
            contrib = thp * f_l * ls["Li"] * (
                w_nee / torch.clamp(ls["pdf"], min=1e-12))[:, None]
            if cfg.firefly_clamp > 0.0:
                lum = m.luminance(contrib)
                contrib = contrib * torch.clamp(
                    cfg.firefly_clamp / torch.clamp(lum, min=1e-12),
                    max=1.0)[:, None]
            if split and bounce == 0:
                f_dp, _ = B.bsdf_eval_split(
                    surf.bsdf, wo, m.to_local(ls["wi"], surf.sh_n))
                cdiff = contrib * f_dp / torch.clamp(f_l, min=1e-12)
            elif split:
                cdiff = torch.where(first_spec[:, None], 0.0, contrib)
            # the occlusion distance from the offset origin
            sdist = ls["dist"] - m.dot(shadow_o - surf.pos, ls["wi"], False)
            sdist = torch.where(do_nee, sdist * (1.0 - 1e-4), 0.0)
            if fuse_shadows:
                pend_contrib = torch.where(do_nee[:, None], contrib, 0.0)
                if split:
                    pend_cdiff = torch.where(do_nee[:, None], cdiff, 0.0)
                pend_o, pend_d, pend_dist = shadow_o, ls["wi"], sdist
                pend_mask = do_nee
                if use_neeat:
                    pend_tile, pend_li = ls["tile"], ls["light_index"]
            else:
                ray_count = ray_count + do_nee.sum()
                occluded = any_fn(shadow_o, ls["wi"], t_zero, sdist)
                nee_ok = do_nee & ~occluded
                L = L + torch.where(nee_ok[:, None], contrib, 0.0)
                if split:
                    L_diff = L_diff + torch.where(nee_ok[:, None], cdiff, 0.0)
                    L_spec = L_spec + torch.where(nee_ok[:, None],
                                                  contrib - cdiff, 0.0)
                if use_neeat:
                    hist = na.accumulate_feedback(
                        neeat_state, hist, ls["tile"], ls["light_index"],
                        m.luminance(contrib), nee_ok)

        # ----- scatter -----
        seed_sc = rng.pixel_seed(px, py, bounce, EFFECT_SCATTER)
        u_lobe, su1, su2 = _lds(cfg, sample_idx, seed_sc, (0, 2, 3))
        bs = B.bsdf_sample(surf.bsdf, wo, u_lobe, su1, su2)
        wi_world = m.to_world(bs["wi"], surf.sh_n)
        if split and bounce == 0:
            first_spec = (bs["lobe"] == B.LOBE_SPECULAR_REFL) \
                | (bs["lobe"] == B.LOBE_SPECULAR_TRANS)
        # reject samples that leak through the geometric surface
        leak = (bs["wi"][:, 2] > 0.0) \
            != (m.dot(wi_world, surf.geo_n, False) > 0.0)
        active = active & bs["valid"] & ~leak \
            & (m.luminance(bs["weight"]) > 0.0)
        thp = thp * bs["weight"]
        prev_pdf = bs["pdf"]
        prev_delta = bs["is_delta"]
        # medium stack: push on entering, pop on exiting
        transmitted = bs["wi"][:, 2] < 0.0
        mid = surf.mat_id
        thin = mp[mid, S.MP_THIN] > 0.5
        entering = transmitted & surf.front & ~thin
        exiting = transmitted & ~surf.front & ~thin
        med0, med1 = (torch.where(entering, mid,
                                  torch.where(exiting, med1, med0)),
                      torch.where(entering, med0,
                                  torch.where(exiting, -1, med1)))

        # ----- Russian roulette -----
        if cfg.enable_russian_roulette \
                and bounce >= cfg.min_bounces_before_rr:
            seed_rr = rng.pixel_seed(px, py, bounce, EFFECT_RR)
            u_rr = _ld(cfg, sample_idx, seed_rr, 0)
            p_cont = torch.clamp(torch.amax(thp, dim=-1), 0.05, 1.0)
            active = active & ~(u_rr >= p_cont)
            thp = thp / p_cont[:, None]

        cone_spread = cone_spread + torch.sqrt(surf.bsdf.alpha) * 0.25 \
            * (~bs["is_delta"]).to(f32)
        o = ray_offset(surf.pos, surf.geo_n, wi_world)
        d = wi_world

    out = dict(L=L, ray_count=ray_count, occupancy=torch.stack(occupancy))
    if split:
        out.update(L_diff=L_diff, L_spec=L_spec)
    if use_neeat:
        out["neeat_hist"] = hist
    if want_aux:
        # with max_bounces 0 no surface is loaded: zeros, as in the JAX
        # package
        out.update(aux or dict(albedo=zeros(n, 3), normal=zeros(n, 3),
                               depth=zeros(n), wpos=zeros(n, 3),
                               emission=zeros(n, 3)))
    return out


def _handle_miss(scene, cfg, d, thp, miss, prev_pdf, prev_delta, px, py,
                 neeat_state, use_nee, use_neeat, nee_uniform):
    """HandleMiss (rtxpt_tpu/pt/integrator.py:273-316): the environment
    radiance [N,3] that the lanes `miss` gather, thp x L_env, weighted
    against the NEE strategy that samples the environment: the power or
    uniform selection pmf times the texel-CDF pdf (or, with environment
    quads, the holding quad's pmf times the uniform-rect jacobian); under
    NEE-AT the tile mixture's pmf times the uniform-uv jacobian
    1 / (2 pi^2 sin theta), the strategy `eval_light_sample` draws."""
    lights = scene.lights
    env_L = env_eval(scene.envmap, d)
    if cfg.enable_mis and use_nee:
        if use_neeat:
            tile0 = na.tile_of(neeat_state, px, py)
            if lights.env_quad_grid is not None:
                li_e, area_e, sin_t = env_quad_of_dir(lights, scene.envmap,
                                                      d)
                sel_mix = na.select_pdf(neeat_state, lights, tile0, li_e)
                p_env = sel_mix / (area_e * 2.0 * math.pi * math.pi * sin_t)
            elif lights.env_light >= 0:
                env_li = torch.full_like(tile0, lights.env_light,
                                         dtype=torch.int64)
                sel_mix = na.select_pdf(neeat_state, lights, tile0, env_li)
                _, v_env = _dir_to_uv(scene.envmap, d)
                sin_t = torch.clamp(torch.sin(v_env * math.pi), min=1e-4)
                p_env = sel_mix / (2.0 * math.pi * math.pi * sin_t)
            else:
                p_env = torch.zeros_like(d[:, 0])
        else:
            p_env = env_dir_pdf(lights, scene.envmap, d, nee_uniform)
        w_env = torch.where(prev_delta, 1.0,
                            m.power_heuristic(prev_pdf, p_env))
    else:
        w_env = torch.ones_like(d[:, 0])
    return torch.where(miss[:, None], thp * env_L * w_env[:, None], 0.0)


def _device(scene):
    """The device of the scene's tables (cluster, bounce, BVH or TLAS)."""
    for tables in (scene.cluster_tables, scene.bounce_tables, scene.bvh,
                   scene.tlas):
        if tables is not None:
            return tables.device
    raise ValueError("the scene has no bounce, cluster, BVH or TLAS tables "
                     "(prepare it first)")


def render_sample(scene, cam: Camera, cfg, width: int, height: int,
                  sample_idx: int, want_aux: bool = False,
                  chunk: Optional[int] = None, neeat_state=None):
    """One sample per pixel over the full frame, in chunks of
    `cfg.ray_chunk` rays; the last chunk is padded with pixel (0, 0) as in
    the JAX package, so `ray_count` matches it. Returns dict(L [H,W,3],
    ray_count [] tensor, occupancy, kernel_tier), plus cull_overflow []
    (summed over chunks) on the clustered tier and, with NEE-AT's
    `neeat_state`, neeat_hist (the chunks' feedback merged), and the split
    channels and aux buffers that `trace_paths` returns (`want_aux`), as
    [H,W,3] / [H,W] images. Runs on the device of the scene's tables."""
    device = _device(scene)
    cfg = dispatch.resolve(scene, cfg, device, neeat_state)
    cam = cam.to(device)
    px, py = _pixel_grid(width, height, device)
    npix = px.shape[0]
    chunk = min(chunk or cfg.ray_chunk, npix)
    if npix % chunk:
        pad = chunk - npix % chunk
        zeros = torch.zeros((pad,), dtype=torch.int32, device=device)
        px = torch.cat([px, zeros])
        py = torch.cat([py, zeros])
    pixels, sums, hists = {}, {}, []
    for lo in range(0, px.shape[0], chunk):
        px_c = px[lo:lo + chunk]
        py_c = py[lo:lo + chunk]
        with record_function("rtxpt.camera"):
            o, d, spread = camera_rays(cam, cfg, px_c, py_c, sample_idx)
        out = trace_paths(scene, cfg, o, d, spread, px_c, py_c, sample_idx,
                          neeat_state, want_aux=want_aux)
        if "neeat_hist" in out:
            hists.append(out.pop("neeat_hist"))
        for key, value in out.items():
            if key in PIXEL_KEYS:
                pixels.setdefault(key, []).append(value)
            else:
                sums[key] = sums[key] + value if key in sums else value
    images = {k: torch.cat(v)[:npix].reshape(height, width, *v[0].shape[1:])
              for k, v in pixels.items()}
    if hists:
        sums["neeat_hist"] = na.merge_hists(neeat_state, hists)
    return dict(images, kernel_tier=cfg.kernel_tier, **sums)


def _check_sample_range(first_sample: int, spp: int):
    if first_sample < 0 or first_sample + spp > 1 << rng.INDEX_BITS:
        raise ValueError(
            f"sample indices [{first_sample}, {first_sample + spp}) leave "
            f"the sampler's 2^{rng.INDEX_BITS} index space (they would "
            f"repeat earlier samples)")


def render(scene, cam: Camera, cfg, width: int, height: int, spp: int,
           first_sample: int = 0, want_aux: bool = False):
    """Progressive accumulation over `spp` samples (weight 1/spp).

    Returns (hdr [H,W,3] tensor, aux dict, total ray count); with
    `want_aux` the aux dict holds the AUX_KEYS buffers averaged over the
    samples, as the JAX package's render does, else it is empty."""
    _check_sample_range(first_sample, spp)
    acc = None
    aux = {}
    total_rays = 0
    for s in range(first_sample, first_sample + spp):
        out = render_sample(scene, cam, cfg, width, height, s,
                            want_aux=want_aux)
        total_rays += int(out["ray_count"])
        acc = out["L"] if acc is None else acc + out["L"]
        if want_aux:
            for k in AUX_KEYS:
                aux[k] = out[k] if k not in aux else aux[k] + out[k]
    return acc / spp, {k: v / spp for k, v in aux.items()}, total_rays


def render_adaptive(scene, cam: Camera, cfg, width: int, height: int,
                    spp: int, first_sample: int = 0):
    """Progressive render with the NEE-AT feedback loop: each sample's
    light-contribution histogram updates the per-tile sampler before the
    next sample. cfg.nee must be NEE-AT. The state starts uniform and
    without the global power pmf, as in the JAX package, so its trust
    stays 0 and every tile mixes the global pmf in at weight 0.5.

    Returns (hdr [H,W,3] tensor, final neeat.NEEATState, total ray
    count)."""
    if cfg.nee.value != NEEMode.NEEAT.value:
        raise ValueError(f"render_adaptive needs nee=NEEAT, not {cfg.nee}")
    _check_sample_range(first_sample, spp)
    state = na.init_state(width, height, int(scene.lights.count),
                          device=_device(scene))
    acc = None
    total_rays = 0
    for s in range(first_sample, first_sample + spp):
        out = render_sample(scene, cam, cfg, width, height, s,
                            neeat_state=state)
        total_rays += int(out["ray_count"])
        acc = out["L"] if acc is None else acc + out["L"]
        state = na.update(state, out["neeat_hist"])
    return acc / spp, state, total_rays
