"""Pinhole perspective camera (counterpart of core_tpu/cameras.py).

Reference perspectiveCam_t (src/cameras/perspectiveCamera.cc:28-70): a
camera is a small container of [3] tensors; `shoot_ray` maps continuous
image coordinates (px, py) in [0,resx)x[0,resy) to world rays for the whole
wavefront at once.  Scope: the pinhole perspective camera.  The thin lens
(aperture > 0) and the architect, angular and orthographic cameras raise
NotImplementedError until ported.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.mathutils import normalize
from core_tpu_torch.types import Rays


class CamType(enum.IntEnum):
    PERSPECTIVE = 0
    ARCHITECT = 1
    ANGULAR = 2
    ORTHOGRAPHIC = 3


@dataclass(frozen=True)
class Camera:
    pos: torch.Tensor            # [3]
    cam_x: torch.Tensor          # [3] camera axes
    cam_y: torch.Tensor
    cam_z: torch.Tensor
    vto: torch.Tensor            # [3] image-plane origin dir
    vup: torch.Tensor            # [3] per-pixel y step
    vright: torch.Tensor         # [3] per-pixel x step
    cam_type: int = int(CamType.PERSPECTIVE)
    resx: int = 320
    resy: int = 240
    aspect_ratio: float = 1.0
    focal: float = 1.0
    aperture: float = 0.0


def _axes(pos, look, up):
    pos = np.asarray(pos, np.float64)
    cam_y = np.asarray(up, np.float64) - pos
    cam_z = np.asarray(look, np.float64) - pos
    cam_x = np.cross(cam_z, cam_y)
    cam_y = np.cross(cam_z, cam_x)
    cam_x /= np.linalg.norm(cam_x)
    cam_y /= np.linalg.norm(cam_y)
    cam_z /= np.linalg.norm(cam_z)
    return pos, cam_x, cam_y, cam_z


def make_perspective(pos, look, up, resx, resy, aspect=1.0, focal=1.0, *,
                     device) -> Camera:
    """Pinhole camera (same float64 host math as core_tpu's
    make_perspective, stored as float32)."""
    pos, cam_x, cam_y, cam_z = _axes(pos, look, up)
    aspect_ratio = aspect * resy / float(resx)
    vright = cam_x.copy()
    vup = aspect_ratio * cam_y
    vto = cam_z * focal - 0.5 * (vup + vright)
    vup /= resy
    vright /= resx

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return Camera(pos=f(pos), cam_x=f(cam_x), cam_y=f(cam_y),
                  cam_z=f(cam_z), vto=f(vto), vup=f(vup), vright=f(vright),
                  cam_type=int(CamType.PERSPECTIVE), resx=int(resx),
                  resy=int(resy), aspect_ratio=float(aspect_ratio),
                  focal=float(focal), aperture=0.0)


def check_supported(cam: Camera):
    if cam.cam_type != int(CamType.PERSPECTIVE) or cam.aperture != 0.0:
        raise NotImplementedError(
            f"camera {CamType(cam.cam_type).name} with aperture "
            f"{cam.aperture} is not ported to core_tpu_torch yet (only the "
            "pinhole perspective camera is)")


def shoot_ray(cam: Camera, px, py):
    """Camera rays for continuous pixel coords px, py [N].
    Returns (rays [N,3] AoS, weight [N]); the pinhole weight is 1."""
    check_supported(cam)
    n = px.shape
    d = cam.vright[None] * px[..., None] + cam.vup[None] * py[..., None] \
        + cam.vto[None]
    d = normalize(d)
    o = cam.pos.expand(d.shape)
    f32 = dict(dtype=torch.float32, device=px.device)
    return (Rays(o, d, torch.zeros(n, **f32), torch.full(n, -1.0, **f32)),
            torch.ones(n, **f32))
