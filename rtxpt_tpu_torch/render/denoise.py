"""The real-time denoisers (counterpart of rtxpt_tpu/render/denoise.py):
a ReLAX-class spatiotemporal filter (SVGF family) and a REBLUR-class
recurrent blur, in plain PyTorch on [H, W, ...] images.

  1. temporal accumulation: the history reprojected by the motion vectors
     (bilinear), rejected on disocclusion (depth and normal tests),
     blended by an exponential moving average, with the luminance
     moments for the variance;
  2. ReLAX (`denoise`): variance-guided edge-aware a-trous wavelet
     iterations with normal, depth and luminance stopping weights;
     REBLUR (`denoise_reblur`): two rotated Poisson-disk blurs whose
     radius shrinks with the accumulated history;
  3. albedo demodulation and remodulation around both.

In the JAX package these are XLA code, not Pallas kernels; the port keeps
them as torch operations on the device of the inputs. The image-edge rules
(clamped shifts, floor-rounded bilinear taps clamped to the frame) are the
JAX package's, since they decide the history. `row_bounds` (the sharded
denoiser's global row window) is not ported: it must be None.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rtxpt_tpu_torch.utils import math as m


class DenoiserState(NamedTuple):
    color: torch.Tensor        # [H,W,3] accumulated illumination
    moments: torch.Tensor      # [H,W,2] first and second luminance moments
    depth: torch.Tensor        # [H,W]
    normal: torch.Tensor       # [H,W,3]
    history_len: torch.Tensor  # [H,W] frames accumulated


def init_state(height: int, width: int, device="cuda") -> DenoiserState:
    """An empty history on `device`."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return DenoiserState(color=z(height, width, 3),
                         moments=z(height, width, 2),
                         depth=z(height, width), normal=z(height, width, 3),
                         history_len=z(height, width))


def state_from_numpy(fields, device="cuda") -> DenoiserState:
    """A DenoiserState on `device` from the JAX package's DenoiserState
    (or any mapping or named tuple with its fields) as numpy arrays."""
    if not isinstance(fields, dict):
        fields = fields._asdict()
    return DenoiserState(**{
        k: torch.tensor(np.asarray(fields[k], np.float32), device=device)
        for k in DenoiserState._fields})


def _no_row_bounds(row_bounds):
    if row_bounds is not None:
        raise NotImplementedError("row_bounds (the sharded denoiser's row "
                                  "window) is not ported")


def _bilinear_sample(img, y, x):
    """Bilinear fetch of img [H,W,C] at float coordinates (y, x) [H,W]: the
    four taps around floor(y), floor(x), each clamped to the frame."""
    h, w = img.shape[:2]
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    fy = (y - y0)[..., None]
    fx = (x - x0)[..., None]

    def at(yy, xx):
        # clamped before the integer conversion, which then saturates as
        # the JAX package's does
        yy = torch.clamp(yy, -1.0, float(h)).to(torch.int64).clamp(0, h - 1)
        xx = torch.clamp(xx, -1.0, float(w)).to(torch.int64).clamp(0, w - 1)
        return img[yy, xx]

    c00 = at(y0, x0)
    c01 = at(y0, x0 + 1)
    c10 = at(y0 + 1, x0)
    c11 = at(y0 + 1, x0 + 1)
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _grid(h: int, w: int, motion):
    """The previous frame's coordinates of each pixel: (y, x) [H,W]."""
    dev = motion.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] \
        + motion[..., 1]
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] \
        + motion[..., 0]
    return yy, xx


def temporal_accumulate(radiance, depth, normal, motion,
                        state: DenoiserState, max_history: float = 32.0,
                        depth_tol: float = 0.05, normal_tol: float = 0.8):
    """Reproject the history by `motion` [H,W,2] (pixels, prev = cur +
    motion) and blend. Returns (illum, moments, history_len, new_state)."""
    h, w = depth.shape
    yy, xx = _grid(h, w, motion)
    prev_color = _bilinear_sample(state.color, yy, xx)
    prev_moments = _bilinear_sample(state.moments, yy, xx)
    prev_depth = _bilinear_sample(state.depth[..., None], yy, xx)[..., 0]
    prev_normal = _bilinear_sample(state.normal, yy, xx)
    prev_hist = _bilinear_sample(state.history_len[..., None], yy,
                                 xx)[..., 0]

    inside = (yy >= 0) & (yy <= h - 1) & (xx >= 0) & (xx <= w - 1)
    depth_ok = torch.abs(prev_depth - depth) <= depth_tol * torch.clamp(
        depth, min=1e-3)
    normal_ok = m.dot(prev_normal, normal, False) >= normal_tol
    valid = inside & depth_ok & normal_ok & (depth > 0.0)

    hist = torch.where(valid, torch.clamp(prev_hist + 1.0, max=max_history),
                       1.0)
    alpha = (1.0 / hist)[..., None]
    lum = m.luminance(radiance)
    new_moments = torch.stack([lum, lum * lum], -1)
    v = valid[..., None]
    illum = (1.0 - alpha) * torch.where(v, prev_color, 0.0) \
        + alpha * radiance
    moments = (1.0 - alpha) * torch.where(v, prev_moments, 0.0) \
        + alpha * new_moments
    new_state = DenoiserState(color=illum, moments=moments, depth=depth,
                              normal=normal, history_len=hist)
    return illum, moments, hist, new_state


def _shift2d(x, dy: int, dx: int, row_bounds=None):
    """x [H,W,...] shifted by (dy, dx) pixels with the edge clamped."""
    _no_row_bounds(row_bounds)
    h, w = x.shape[:2]
    ys = torch.clamp(torch.arange(h, device=x.device) + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, device=x.device) + dx, 0, w - 1)
    return x.index_select(0, ys).index_select(1, xs)


_ATROUS_W = [1.0 / 16, 1.0 / 4, 3.0 / 8, 1.0 / 4, 1.0 / 16]


def estimate_variance(moments, hist, illum, depth, row_bounds=None):
    """Temporal variance; a 3x3 spatial estimate for pixels younger than 4
    frames (SVGF section 4.2)."""
    var_t = torch.clamp(moments[..., 1] - moments[..., 0] ** 2, min=0.0)
    lum = m.luminance(illum)
    s1 = torch.zeros_like(lum)
    s2 = torch.zeros_like(lum)
    cnt = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            q = _shift2d(lum, dy, dx, row_bounds)
            s1 = s1 + q
            s2 = s2 + q * q
            cnt += 1.0
    var_s = torch.clamp(s2 / cnt - (s1 / cnt) ** 2, min=0.0)
    return torch.where(hist >= 4.0, var_t, var_s)


def atrous_iteration(illum, variance, normal, depth, step: int,
                     sigma_z: float = 1.0, sigma_n: float = 128.0,
                     sigma_l: float = 4.0, row_bounds=None):
    """One edge-aware a-trous sweep with dilation 2^step (5x5 taps).
    Returns (filtered illum, filtered variance)."""
    lum = m.luminance(illum)
    # 3x3 gaussian prefilter of the variance for the luminance weight
    gvar = torch.zeros_like(variance)
    gw = 0.0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            wgt = [[1, 2, 1], [2, 4, 2], [1, 2, 1]][dy + 1][dx + 1] / 16.0
            gvar = gvar + wgt * _shift2d(variance, dy, dx, row_bounds)
            gw += wgt
    gvar = gvar / gw
    denom_l = sigma_l * torch.sqrt(torch.clamp(gvar, min=1e-10)) + 1e-6

    # the depth gradient for the adaptive depth weight
    dzdx = (_shift2d(depth, 0, 1, row_bounds)
            - _shift2d(depth, 0, -1, row_bounds)) * 0.5
    dzdy = (_shift2d(depth, 1, 0, row_bounds)
            - _shift2d(depth, -1, 0, row_bounds)) * 0.5

    dil = 1 << step
    sum_c = torch.zeros_like(illum)
    sum_v = torch.zeros_like(variance)
    sum_w = torch.zeros_like(variance)
    for iy, wy in enumerate(_ATROUS_W):
        for ix, wx in enumerate(_ATROUS_W):
            dy = (iy - 2) * dil
            dx = (ix - 2) * dil
            h_k = wy * wx
            c_q = _shift2d(illum, dy, dx, row_bounds)
            v_q = _shift2d(variance, dy, dx, row_bounds)
            l_q = _shift2d(lum, dy, dx, row_bounds)
            n_q = _shift2d(normal, dy, dx, row_bounds)
            z_q = _shift2d(depth, dy, dx, row_bounds)

            w_n = torch.pow(torch.clamp(m.dot(normal, n_q, False), min=0.0),
                            sigma_n)
            z_grad = torch.abs(dzdx * dx + dzdy * dy) + 1e-6
            w_z = torch.exp(-torch.abs(depth - z_q) / (sigma_z * z_grad))
            w_l = torch.exp(-torch.abs(lum - l_q) / denom_l)
            wt = h_k * w_n * w_z * w_l
            if dy == 0 and dx == 0:
                wt = torch.clamp(wt, min=h_k)   # keep the centre tap
            sum_c = sum_c + wt[..., None] * c_q
            sum_v = sum_v + wt * wt * v_q
            sum_w = sum_w + wt
    inv = 1.0 / torch.clamp(sum_w, min=1e-8)
    return sum_c * inv[..., None], sum_v * inv * inv


def denoise(radiance, albedo, normal, depth, motion,
            state: Optional[DenoiserState] = None, iterations: int = 4,
            row_bounds=None):
    """ReLAX-class pipeline: demodulate the albedo, accumulate temporally,
    a-trous filter, remodulate. radiance, albedo, normal [H,W,3], depth
    [H,W], motion [H,W,2]. Returns (denoised [H,W,3], new_state)."""
    _no_row_bounds(row_bounds)
    h, w = depth.shape
    if state is None:
        state = init_state(h, w, depth.device)
    safe_albedo = torch.clamp(albedo, min=1e-3)
    illum = radiance / safe_albedo
    illum, moments, hist, new_state = temporal_accumulate(
        illum, depth, normal, motion, state)
    variance = estimate_variance(moments, hist, illum, depth)
    out = illum
    for it in range(iterations):
        out, variance = atrous_iteration(out, variance, normal, depth, it)
        if it == 0:
            # the first filtered result is the temporal colour history
            # (ReLAX "fast history")
            new_state = new_state._replace(color=out)
    return out * safe_albedo, new_state


# Poisson-disk offsets (unit disk, 8 taps) of the recurrent blur
_POISSON8 = [
    (-0.4706069, -0.4427112), (-0.9057375, +0.3003471),
    (-0.3487388, +0.4037880), (+0.1023042, +0.9231500),
    (+0.3451990, -0.1186735), (+0.5337331, +0.3813070),
    (+0.8642891, -0.3302780), (+0.1564815, -0.8280689),
]


def _reblur_pass(illum, normal, depth, radius_px, base_rot: float,
                 row_bounds=None):
    """One rotated Poisson-disk blur with a per-pixel radius and normal /
    depth edge weights (REBLUR's blur / post-blur). The rotation and the
    offsets are float32, as in the JAX package."""
    _no_row_bounds(row_bounds)
    h, w = depth.shape
    dev = depth.device
    f32 = torch.float32
    yy = torch.arange(h, dtype=f32, device=dev)[:, None] \
        * torch.ones((1, w), dtype=f32, device=dev)
    xx = torch.arange(w, dtype=f32, device=dev)[None, :] \
        * torch.ones((h, 1), dtype=f32, device=dev)
    rot = torch.tensor(base_rot, dtype=f32, device=dev)
    ca, sa = torch.cos(rot), torch.sin(rot)

    sum_c = illum
    sum_w = torch.ones_like(depth)
    for ox, oy in _POISSON8:
        ox = torch.tensor(ox, dtype=f32, device=dev)
        oy = torch.tensor(oy, dtype=f32, device=dev)
        dx = (ca * ox - sa * oy) * radius_px
        dy = (sa * ox + ca * oy) * radius_px
        sy = torch.clamp(yy + dy, 0.0, h - 1.0)
        sx = torch.clamp(xx + dx, 0.0, w - 1.0)
        c_q = _bilinear_sample(illum, sy, sx)
        n_q = _bilinear_sample(normal, sy, sx)
        z_q = _bilinear_sample(depth[..., None], sy, sx)[..., 0]
        w_n = torch.pow(torch.clamp(m.dot(normal, n_q, False), min=0.0),
                        16.0)
        w_z = torch.exp(-3.0 * torch.abs(depth - z_q)
                        / torch.clamp(depth, min=1e-3))
        wgt = w_n * w_z
        sum_c = sum_c + wgt[..., None] * c_q
        sum_w = sum_w + wgt
    return sum_c / torch.clamp(sum_w, min=1e-6)[..., None]


def denoise_reblur(radiance, albedo, normal, depth, motion,
                   state: Optional[DenoiserState] = None,
                   base_radius: float = 16.0, row_bounds=None):
    """REBLUR-class recurrent blur: temporal accumulation, then two rotated
    Poisson-disk blurs whose per-pixel radius shrinks with the accumulated
    history (new and disoccluded pixels blur wide, converged ones keep
    detail). Same contract as `denoise`."""
    _no_row_bounds(row_bounds)
    h, w = depth.shape
    if state is None:
        state = init_state(h, w, depth.device)
    safe_albedo = torch.clamp(albedo, min=1e-3)
    illum = radiance / safe_albedo
    illum, moments, hist, new_state = temporal_accumulate(
        illum, depth, normal, motion, state)
    radius = base_radius / (1.0 + hist)
    out = _reblur_pass(illum, normal, depth, radius, 0.0)
    new_state = new_state._replace(color=out)      # recurrent feedback
    out = _reblur_pass(out, normal, depth, radius * 0.5, 0.7853982)
    return out * safe_albedo, new_state
