"""Wavefront path tracing of whole frames, reference mode (counterpart of
rtxpt_tpu/pt/integrator.py): the camera rays of a frame go, in chunks of
`cfg.ray_chunk`, through the fused bounce step (pt/bounce_fused.py) or,
for a scene with cluster tables, the clustered tier
(pt/bounce_clustered.py); samples accumulate progressively
(`render`), or with NEE-AT, whose per-tile sampler learns from each
sample before the next (`render_adaptive`). The general BVH wavefront
(the JAX package's "xla" tier) is not ported yet."""

from __future__ import annotations

from typing import Optional

import torch
from torch.profiler import record_function

from rtxpt_tpu_torch.config import NEEMode
from rtxpt_tpu_torch.lighting import neeat as na
from rtxpt_tpu_torch.pt import bounce_clustered, bounce_fused, dispatch
from rtxpt_tpu_torch.scene.camera import Camera, camera_ray
from rtxpt_tpu_torch.utils import rng

# Effect seeds (SampleGenerators effect decorrelation)
EFFECT_LENS = 17
EFFECT_SCATTER = 29
EFFECT_NEE = 31
EFFECT_RR = 37
EFFECT_STF = 41


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
                neeat_state=None):
    """Trace a wavefront of camera rays to completion on the tier
    `dispatch.resolve` picks for the scene and the rays' device. Returns
    dict(L [N,3], ray_count [], occupancy [max_bounces+1]), plus
    cull_overflow [] on the clustered tier and neeat_hist with NEE-AT."""
    cfg = dispatch.resolve(scene, cfg, o.device, neeat_state)
    if cfg.kernel_tier == "clustered":
        return bounce_clustered.trace_paths_clustered(
            scene, cfg, o, d, cone_spread, px, py, sample_idx)
    return bounce_fused.trace_paths_fused(
        scene, cfg, o, d, cone_spread, px, py, sample_idx, neeat_state)


def _device(scene):
    tables = scene.cluster_tables if scene.cluster_tables is not None \
        else scene.bounce_tables
    return tables.device


def render_sample(scene, cam: Camera, cfg, width: int, height: int,
                  sample_idx: int, chunk: Optional[int] = None,
                  neeat_state=None):
    """One sample per pixel over the full frame, in chunks of
    `cfg.ray_chunk` rays; the last chunk is padded with pixel (0, 0) as in
    the JAX package, so `ray_count` matches it. Returns dict(L [H,W,3],
    ray_count [] tensor, occupancy, kernel_tier), plus cull_overflow []
    (summed over chunks) on the clustered tier and, with NEE-AT's
    `neeat_state`, neeat_hist (the chunks' feedback merged). Runs on the
    device of the scene's tables."""
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
    Ls, sums, hists = [], {}, []
    for lo in range(0, px.shape[0], chunk):
        px_c = px[lo:lo + chunk]
        py_c = py[lo:lo + chunk]
        with record_function("rtxpt.camera"):
            o, d, spread = camera_rays(cam, cfg, px_c, py_c, sample_idx)
        out = trace_paths(scene, cfg, o, d, spread, px_c, py_c, sample_idx,
                          neeat_state)
        Ls.append(out.pop("L"))
        if "neeat_hist" in out:
            hists.append(out.pop("neeat_hist"))
        for key, value in out.items():
            sums[key] = sums[key] + value if key in sums else value
    L = torch.cat(Ls)[:npix].reshape(height, width, 3)
    if hists:
        sums["neeat_hist"] = na.merge_hists(neeat_state, hists)
    return dict(L=L, kernel_tier=cfg.kernel_tier, **sums)


def _check_sample_range(first_sample: int, spp: int):
    if first_sample < 0 or first_sample + spp > 1 << rng.INDEX_BITS:
        raise ValueError(
            f"sample indices [{first_sample}, {first_sample + spp}) leave "
            f"the sampler's 2^{rng.INDEX_BITS} index space (they would "
            f"repeat earlier samples)")


def render(scene, cam: Camera, cfg, width: int, height: int, spp: int,
           first_sample: int = 0, want_aux: bool = False):
    """Progressive accumulation over `spp` samples (weight 1/spp).

    Returns (hdr [H,W,3] tensor, aux dict, total ray count)."""
    if want_aux:
        raise NotImplementedError(
            "aux buffers are not ported to rtxpt_tpu_torch yet")
    _check_sample_range(first_sample, spp)
    acc = None
    total_rays = 0
    for s in range(first_sample, first_sample + spp):
        out = render_sample(scene, cam, cfg, width, height, s)
        total_rays += int(out["ray_count"])
        acc = out["L"] if acc is None else acc + out["L"]
    return acc / spp, {}, total_rays


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
