"""Real-time mode: one sample per pixel, path traced, denoised, resolved
by TAA (counterpart of rtxpt_tpu/pt/realtime.py; SURVEY section 3.3).

Per frame (`render_frame`):
  1. trace one sample per pixel with the guide buffers (albedo, normal,
     depth, world position, emission) through `integrator.render_sample`,
     on the tier `pt/dispatch.resolve` picks (K1 on the fused tier);
  2. motion vectors from the previous camera (static geometry);
  3. with NEE-AT, the tile state learns from the frame's feedback,
     reprojected by the motion;
  4. denoise the illumination (render/denoise.py: ReLAX or REBLUR; the
     diffuse and specular channels apart with `split_denoise`), remodulate
     the albedo, add the primary emission back;
  5. upscale to the display size when `render_scale` < 1;
  6. TAA, bloom, tonemap.

`render_frame_stable_planes` decomposes the camera rays into up to three
stable planes (pt/stable_planes.py, the BUILD pass through
`accel.traverse.scene_closest`), fills each plane by restarting the paths
from its V-buffer (`integrator.trace_paths(first_hit=...)`: K1's inject
variant at bounce 0 on the fused tier), denoises each plane with its own
denoiser and composites them by throughput.

Both run on the device of the scene's tables. ReSTIR DI / GI and ReGIR
(`RenderConfig.restir`) are not ported: the frames refuse them by name.
Each step runs in a `torch.profiler.record_function` range: "rtxpt.build"
(the BUILD pass), "rtxpt.fill" (the traces), "rtxpt.denoise", "rtxpt.taa"
(upscale, TAA, bloom and tonemap).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from rtxpt_tpu_torch.config import DenoiserMode, NEEMode
from rtxpt_tpu_torch.lighting import neeat as na
from rtxpt_tpu_torch.lighting.envmap import env_eval
from rtxpt_tpu_torch.pt.integrator import (
    _device, _pixel_grid, camera_rays, render_sample, trace_paths)
from rtxpt_tpu_torch.pt.stable_planes import decompose
from rtxpt_tpu_torch.render import denoise as dn
from rtxpt_tpu_torch.render.postprocess import tonemap
from rtxpt_tpu_torch.render.taa import bloom, taa_resolve
from rtxpt_tpu_torch.scene.camera import Camera, project
from rtxpt_tpu_torch.utils.rng import M32

# the per-plane sample-index offset that decorrelates the planes' fills
# (rtxpt_tpu/pt/realtime.py:318; wraps in 32 bits)
PLANE_SEED = 0x632BE59B


class RealtimeState(NamedTuple):
    denoiser: dn.DenoiserState
    denoiser_p1: Optional[dn.DenoiserState]    # stable plane 1
    taa_history: Optional[torch.Tensor]
    prev_camera: Optional[Camera]
    frame_index: int
    neeat: Optional[object] = None             # lighting.neeat.NEEATState
    denoiser_p2: Optional[dn.DenoiserState] = None   # stable plane 2
    denoiser_spec: Optional[dn.DenoiserState] = None  # the split specular
    motion: Optional[torch.Tensor] = None      # display-size motion of the
    #                                            last frame


def init_state(height: int, width: int, scene=None, pt_cfg=None,
               device="cuda") -> RealtimeState:
    """An empty state on the device of the scene's tables (on `device`
    without a scene), with NEE-AT's uniform tile state when `pt_cfg` asks
    for NEE-AT and the scene has lights."""
    if scene is not None:
        device = _device(scene)
    neeat = None
    if (scene is not None and pt_cfg is not None
            and pt_cfg.nee.value == NEEMode.NEEAT.value
            and scene.lights is not None):
        neeat = na.init_state(width, height, int(scene.lights.count),
                              lights_power=scene.lights.power, device=device)

    def ds():
        return dn.init_state(height, width, device)

    return RealtimeState(denoiser=ds(), denoiser_p1=ds(), denoiser_p2=ds(),
                         denoiser_spec=ds(), taa_history=None,
                         prev_camera=None, frame_index=0, neeat=neeat)


_NEEAT_FIELDS = ("tile_pdf", "tile_cdf", "ema", "idx_k", "frame", "conf",
                 "trust", "power", "n_tiles_x", "n_tiles_y", "n_lights")


def state_from_numpy(state, device="cuda") -> RealtimeState:
    """A RealtimeState on `device` from the JAX package's RealtimeState with
    numpy leaves (or a mapping of its fields): the denoiser states, the TAA
    history, the previous camera, the frame index, the NEE-AT state and
    the motion. Its ReSTIR states must be None (not ported)."""
    f = state if isinstance(state, dict) else state._asdict()
    for key in ("restir_di", "restir_gi", "regir"):
        if f.get(key) is not None:
            raise NotImplementedError(f"{key}: ReSTIR is not ported")

    def arr(x):
        return None if x is None else torch.tensor(
            np.asarray(x, np.float32), device=device)

    def den(x):
        return None if x is None else dn.state_from_numpy(x, device)

    cam = f.get("prev_camera")
    if cam is not None:
        cam = Camera(**{k.name: arr(getattr(cam, k.name))
                        for k in dataclasses.fields(Camera)})
    neeat = f.get("neeat")
    if neeat is not None:
        neeat = na.state_from_numpy(
            {k: getattr(neeat, k, None) for k in _NEEAT_FIELDS}, device)
    return RealtimeState(
        denoiser=den(f["denoiser"]), denoiser_p1=den(f.get("denoiser_p1")),
        denoiser_p2=den(f.get("denoiser_p2")),
        denoiser_spec=den(f.get("denoiser_spec")),
        taa_history=arr(f.get("taa_history")), prev_camera=cam,
        frame_index=int(f["frame_index"]), neeat=neeat,
        motion=arr(f.get("motion")))


def motion_vectors(prev_cam: Optional[Camera], wpos, depth, width, height):
    """Pixel-space motion [H,W,2] (prev = cur + motion) of the surfaces
    wpos [H,W,3] (depth [H,W], 0 on a miss) from the previous camera,
    geometry static. Zero without a previous camera, on misses and behind
    it. `width` and `height` are not read (the JAX package's signature)."""
    if prev_cam is None:
        return torch.zeros((*depth.shape, 2), dtype=torch.float32,
                           device=depth.device)
    px_prev, py_prev, behind = project(prev_cam, wpos)
    h, w = depth.shape
    cur_x = torch.arange(w, dtype=torch.float32, device=depth.device)[None, :]
    cur_y = torch.arange(h, dtype=torch.float32, device=depth.device)[:, None]
    valid = (depth > 0.0) & ~behind
    return torch.where(valid[..., None],
                       torch.stack([px_prev - cur_x, py_prev - cur_y], -1),
                       0.0)


def _upscale_bilinear(img, height: int, width: int):
    """Bilinear resize [h,w(,C)] -> [height,width(,C)] (the upscaler's
    base; TAA at display size adds the temporal part)."""
    h, w = img.shape[:2]
    dev = img.device
    f32 = torch.float32
    yy = (torch.arange(height, dtype=f32, device=dev) + 0.5) * h / height \
        - 0.5
    xx = (torch.arange(width, dtype=f32, device=dev) + 0.5) * w / width - 0.5
    yg = yy[:, None].expand(height, width)
    xg = xx[None, :].expand(height, width)
    if img.ndim == 2:
        return dn._bilinear_sample(img[..., None], yg, xg)[..., 0]
    return dn._bilinear_sample(img, yg, xg)


def _halton(i: int, base: int) -> float:
    f, r = 1.0, 0.0
    while i > 0:
        f /= base
        r += f * (i % base)
        i //= base
    return r


def _refuse_restir(rc):
    if rc.restir != "none":
        raise NotImplementedError(
            f"ReSTIR (RenderConfig.restir={rc.restir!r}) and its ReGIR "
            f"candidates are not ported to rtxpt_tpu_torch")


def _denoiser_fn(rc):
    return dn.denoise_reblur if rc.denoiser.value == \
        DenoiserMode.REBLUR.value else dn.denoise


def _display(hdr, motion, state, rc):
    """TAA, bloom and tonemap of hdr [H,W,3]: (image, hdr, TAA history)."""
    if rc.enable_taa:
        hdr, taa_hist = taa_resolve(hdr, motion, state.taa_history)
    else:
        taa_hist = state.taa_history
    if rc.enable_bloom:
        hdr = bloom(hdr)
    return tonemap(hdr, rc.exposure, rc.tonemap), hdr, taa_hist


def render_frame(scene, cam: Camera, pt_cfg, rc, state: RealtimeState):
    """One real-time frame. Returns (display image, hdr, new state).

    With rc.render_scale < 1 the wavefront runs at the reduced render
    size and the frame is upscaled to the display size before TAA; the
    state keeps the render-size camera, in whose pixels the next frame's
    motion vectors are measured (rtxpt_tpu/pt/realtime.py:250-253)."""
    _refuse_restir(rc)
    rw = max(int(rc.width * rc.render_scale), 8)
    rh = max(int(rc.height * rc.render_scale), 8)
    denoise_on = rc.denoiser.value != DenoiserMode.NONE.value
    split = rc.split_denoise and denoise_on
    if split and not pt_cfg.split_channels:
        pt_cfg = dataclasses.replace(pt_cfg, split_channels=True)
    dev = _device(scene)
    cam = cam.to(dev)
    render_cam = cam
    if (rw, rh) != (rc.width, rc.height):
        render_cam = dataclasses.replace(
            cam, width=torch.tensor(float(rw), device=dev),
            height=torch.tensor(float(rh), device=dev))
    with record_function("rtxpt.fill"):
        out = render_sample(scene, render_cam, pt_cfg, rw, rh,
                            state.frame_index, want_aux=True,
                            neeat_state=state.neeat)
    emission = out["emission"]
    motion = motion_vectors(state.prev_camera, out["wpos"], out["depth"],
                            rc.width, rc.height)
    new_neeat = state.neeat
    if state.neeat is not None and "neeat_hist" in out:
        # the feedback history follows the surfaces it was learned on
        new_neeat = na.update(state.neeat, out["neeat_hist"], motion=motion)

    with record_function("rtxpt.denoise"):
        den_fn = _denoiser_fn(rc)
        dstate_spec = state.denoiser_spec
        if split:
            # the diffuse and specular channels denoised apart
            den_d, dstate = den_fn(out["L_diff"], out["albedo_diff"],
                                   out["normal"], out["depth"], motion,
                                   state.denoiser)
            den_s, dstate_spec = den_fn(out["L_spec"], out["albedo_spec"],
                                        out["normal"], out["depth"], motion,
                                        state.denoiser_spec)
            hdr = den_d + den_s + emission
        elif denoise_on:
            # the illumination denoised, the primary emission added back
            den, dstate = den_fn(out["L"] - emission, out["albedo"],
                                 out["normal"], out["depth"], motion,
                                 state.denoiser)
            hdr = den + emission
        else:
            hdr, dstate = out["L"], state.denoiser

    with record_function("rtxpt.taa"):
        if (rw, rh) != (rc.width, rc.height):
            scale = torch.tensor([rc.width / rw, rc.height / rh],
                                 dtype=torch.float32, device=dev)
            hdr = _upscale_bilinear(hdr, rc.height, rc.width)
            motion = _upscale_bilinear(motion, rc.height, rc.width) * scale
        img, hdr, taa_hist = _display(hdr, motion, state, rc)
    return img, hdr, RealtimeState(
        denoiser=dstate, denoiser_p1=state.denoiser_p1,
        denoiser_p2=state.denoiser_p2, denoiser_spec=dstate_spec,
        taa_history=taa_hist, prev_camera=render_cam,
        frame_index=state.frame_index + 1, neeat=new_neeat, motion=motion)


def render_frame_stable_planes(scene, cam: Camera, pt_cfg, rc,
                               state: RealtimeState):
    """A real-time frame with the path-space decomposition: the BUILD pass
    resolves the delta chains deterministically (pt/stable_planes.py), each
    plane's one-sample fill restarts from its V-buffer with the bounces
    its chain has left (`trace_paths(first_hit=, bounce_budget=)`), is
    denoised by its own denoiser, and the planes composite by throughput
    (rtxpt_tpu/pt/realtime.py:266-376). Plane i's fill draws sample index
    frame_index + i * PLANE_SEED, wrapped to 32 bits: the samplers alias it
    as the JAX package's do (the Owen shuffle keeps 16 bits, the hashes 32).
    Returns (display image, hdr, new state); the state keeps no NEE-AT or
    split-channel denoiser state, as in the JAX package."""
    _refuse_restir(rc)
    w, h = rc.width, rc.height
    dev = _device(scene)
    cam = cam.to(dev)
    px, py = _pixel_grid(w, h, dev)
    n = px.shape[0]
    sidx = state.frame_index
    with record_function("rtxpt.build"):
        o, d, spread = camera_rays(cam, pt_cfg, px, py, sidx)
        planes, background = decompose(scene, o, d)

    hdr = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    dstates = [state.denoiser, state.denoiser_p1, state.denoiser_p2]
    new_dstates = []
    mv0 = None
    for i, plane in enumerate(planes):
        budget = torch.where(plane.valid, torch.clamp(
            pt_cfg.max_bounces - plane.nverts, min=0), 0)
        with record_function("rtxpt.fill"):
            out = trace_paths(scene, pt_cfg, plane.o, plane.d, spread, px,
                              py, (sidx + i * PLANE_SEED) & M32,
                              want_aux=True,
                              first_hit=plane.vbuffer(pt_cfg.max_ray_travel),
                              bounce_budget=budget)
        if rc.denoiser.value:
            with record_function("rtxpt.denoise"):
                # the plane's motion, from its own base surface
                motion = motion_vectors(
                    state.prev_camera, out["wpos"].reshape(h, w, 3),
                    out["depth"].reshape(h, w), w, h)
                if i == 0:
                    mv0 = motion
                den, ds = dn.denoise(
                    (out["L"] - out["emission"]).reshape(h, w, 3),
                    out["albedo"].reshape(h, w, 3),
                    out["normal"].reshape(h, w, 3),
                    out["depth"].reshape(h, w), motion, dstates[i])
                plane_l = den.reshape(n, 3) + out["emission"]
        else:
            plane_l, ds = out["L"], dstates[i]
        new_dstates.append(ds)
        hdr = hdr + torch.where(plane.valid[:, None], plane.thp * plane_l,
                                0.0)

    if scene.envmap is not None and scene.envmap.has_radiance:
        # background pixels see the environment directly
        hdr = hdr + torch.where(background[:, None],
                                env_eval(scene.envmap, d), 0.0)

    with record_function("rtxpt.taa"):
        # the dominant plane's motion drives the display reprojection
        mv = mv0 if mv0 is not None else torch.zeros(
            (h, w, 2), dtype=torch.float32, device=dev)
        img, hdr, taa_hist = _display(hdr.reshape(h, w, 3), mv, state, rc)
    return img, hdr, RealtimeState(
        denoiser=new_dstates[0], denoiser_p1=new_dstates[1],
        denoiser_p2=new_dstates[2], taa_history=taa_hist, prev_camera=cam,
        frame_index=state.frame_index + 1, motion=mv0)
