"""Pinhole camera (counterpart of rtxpt_tpu/scene/camera.py: Camera,
look_at, camera_ray, project). Thin-lens depth of field comes with a later
slice."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from rtxpt_tpu_torch.utils import math as m


@dataclass(frozen=True)
class Camera:
    position: torch.Tensor      # [3]
    # Pre-scaled pixel basis: dir(px,py) = normalize(forward + sx*right + sy*up)
    forward: torch.Tensor       # [3]
    right: torch.Tensor         # [3] unit right * tan(fovx/2)
    up: torch.Tensor            # [3] unit up * tan(fovy/2)
    width: torch.Tensor         # [] f32
    height: torch.Tensor        # [] f32
    aperture_radius: torch.Tensor  # [] f32 (0 = pinhole)
    focal_distance: torch.Tensor   # [] f32

    def to(self, device) -> "Camera":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)})


def look_at(position, target, up, fov_y_deg: float, width: int, height: int,
            aperture_radius: float = 0.0, focal_distance: float = 1.0,
            device="cpu") -> Camera:
    position = np.asarray(position, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    fwd = target - position
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    cup = np.cross(right, fwd)
    tan_y = np.tan(np.deg2rad(fov_y_deg) * 0.5)
    tan_x = tan_y * (width / height)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(position=t(position), forward=t(fwd),
                  right=t(right * tan_x), up=t(cup * tan_y),
                  width=t(width), height=t(height),
                  aperture_radius=t(aperture_radius),
                  focal_distance=t(focal_distance))


def camera_ray(cam: Camera, px, py, u1, u2):
    """Primary ray for pixel (px, py) with subpixel jitter (u1, u2).

    Returns (origin [N,3], direction [N,3], cone spread angle [N])."""
    sx = ((px.to(torch.float32) + u1) / cam.width) * 2.0 - 1.0
    sy = 1.0 - ((py.to(torch.float32) + u2) / cam.height) * 2.0
    d = cam.forward + sx[..., None] * cam.right + sy[..., None] * cam.up
    d = m.normalize(d)
    o = cam.position.expand(d.shape)
    spread = 2.0 * torch.abs(m.length(cam.up, False)) / cam.height
    return o, d, spread.expand(px.shape)


def project(cam: Camera, world_pos):
    """World position [..., 3] -> (px, py, behind) pixel coordinates: the
    inverse of camera_ray for a pinhole camera, used for motion vectors
    (rtxpt_tpu/scene/camera.py:85)."""
    rel = world_pos - cam.position
    rlen2 = m.dot(cam.right, cam.right, False)
    ulen2 = m.dot(cam.up, cam.up, False)
    z = m.dot(rel, cam.forward.expand(rel.shape), False)
    behind = z <= 1e-6
    zs = torch.where(behind, 1.0, z)
    sx = m.dot(rel, cam.right.expand(rel.shape), False) / (rlen2 * zs)
    sy = m.dot(rel, cam.up.expand(rel.shape), False) / (ulen2 * zs)
    px = (sx + 1.0) * 0.5 * cam.width - 0.5
    py = (1.0 - sy) * 0.5 * cam.height - 0.5
    return px, py, behind
