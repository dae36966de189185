"""Camera models, batched over pixel wavefronts (counterpart of
core_tpu/cameras.py; reference src/cameras/).

Perspective with a thin lens and bokeh shapes (perspectiveCamera.cc),
architect (architectCamera.cc), angular / fisheye (angularCamera.cc) and
orthographic (orthoCamera.cc).  A camera is a small container of [3]
tensors; `shoot_ray` maps continuous image coordinates (px, py) in
[0,resx)x[0,resy), and for a lens camera the lens samples (lu, lv), to
world rays for the whole wavefront at once.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.mathutils import dot, normalize
from core_tpu_torch.sampling.utils import shirley_disk
from core_tpu_torch.types import Rays


class CamType(enum.IntEnum):
    PERSPECTIVE = 0
    ARCHITECT = 1
    ANGULAR = 2
    ORTHOGRAPHIC = 3


class BokehType(enum.IntEnum):
    DISK1 = 0
    DISK2 = 1
    TRIANGLE = 3
    SQUARE = 4
    PENTAGON = 5
    HEXAGON = 6
    RING = 7


class BokehBias(enum.IntEnum):
    NONE = 0
    CENTER = 1
    EDGE = 2


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
    dof_distance: float = 0.0
    bokeh_type: int = int(BokehType.DISK1)
    bokeh_bias: int = int(BokehBias.NONE)
    bokeh_rot: float = 0.0
    angle_deg: float = 0.0       # angular camera: the angle at radius 1
    circular: bool = False       # angular camera: circular mask
    max_r: float = 1.0           # angular camera: mask radius


# the settings a Camera carries besides its tensors, in field order
STATIC_FIELDS = ("cam_type", "resx", "resy", "aspect_ratio", "focal",
                 "aperture", "dof_distance", "bokeh_type", "bokeh_bias",
                 "bokeh_rot", "angle_deg", "circular", "max_r")


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


def _f32(device):
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return f


def make_perspective(pos, look, up, resx, resy, aspect=1.0, focal=1.0,
                     aperture=0.0, dof_distance=0.0,
                     bokeh_type=BokehType.DISK1, bokeh_bias=BokehBias.NONE,
                     bokeh_rot=0.0, architect=False, *, device) -> Camera:
    """Pinhole or thin-lens camera (perspectiveCam_t ctor + setAxis,
    perspectiveCamera.cc:28-70), the architect camera with architect=True;
    the same float64 host math as core_tpu's make_perspective, stored as
    float32."""
    pos, cam_x, cam_y, cam_z = _axes(pos, look, up)
    aspect_ratio = aspect * resy / float(resx)
    vright = cam_x.copy()
    if architect:
        # vertical lines stay vertical: the per-pixel vertical step is the
        # world's up axis (-Z in the reference's Blender-style world), not
        # the tilted camera Y (architectCamera.cc:53-66)
        vup = aspect_ratio * np.array([0.0, 0.0, -1.0])
    else:
        vup = aspect_ratio * cam_y
    vto = cam_z * focal - 0.5 * (vup + vright)
    vup /= resy
    vright /= resx
    f = _f32(device)
    return Camera(
        pos=f(pos), cam_x=f(cam_x), cam_y=f(cam_y), cam_z=f(cam_z),
        vto=f(vto), vup=f(vup), vright=f(vright),
        cam_type=int(CamType.ARCHITECT if architect
                     else CamType.PERSPECTIVE),
        resx=int(resx), resy=int(resy), aspect_ratio=float(aspect_ratio),
        focal=float(focal), aperture=float(aperture),
        dof_distance=float(dof_distance), bokeh_type=int(bokeh_type),
        bokeh_bias=int(bokeh_bias), bokeh_rot=float(bokeh_rot))


def make_architect(*args, **kw) -> Camera:
    """The vertical-line-preserving perspective (architectCam_t)."""
    return make_perspective(*args, architect=True, **kw)


def make_angular(pos, look, up, resx, resy, aspect=1.0, angle=90.0,
                 max_angle=None, circular=True, *, device) -> Camera:
    """Angular / fisheye camera (angularCamera.cc)."""
    pos, cam_x, cam_y, cam_z = _axes(pos, look, up)
    max_angle = angle if max_angle is None else max_angle
    f = _f32(device)
    return Camera(
        pos=f(pos), cam_x=f(cam_x), cam_y=f(cam_y), cam_z=f(cam_z),
        vto=f(cam_z), vup=f(cam_y), vright=f(cam_x),
        cam_type=int(CamType.ANGULAR), resx=int(resx), resy=int(resy),
        aspect_ratio=float(aspect * resy / resx), angle_deg=float(angle),
        circular=bool(circular), max_r=float(max_angle) / float(angle))


def make_orthographic(pos, look, up, resx, resy, aspect=1.0, scale=1.0, *,
                      device) -> Camera:
    """Parallel projection (orthoCamera.cc): pos holds the image plane's
    corner."""
    pos, cam_x, cam_y, cam_z = _axes(pos, look, up)
    aspect_ratio = aspect * resy / float(resx)
    vright = cam_x * scale
    vup = aspect_ratio * cam_y * scale
    p0 = pos - 0.5 * (vup + vright)
    vup /= resy
    vright /= resx
    f = _f32(device)
    return Camera(
        pos=f(p0), cam_x=f(cam_x), cam_y=f(cam_y), cam_z=f(cam_z),
        vto=f(cam_z), vup=f(vup), vright=f(vright),
        cam_type=int(CamType.ORTHOGRAPHIC), resx=int(resx), resy=int(resy),
        aspect_ratio=float(aspect_ratio), focal=float(scale))


def check_supported(cam: Camera):
    """Every camera type is ported; an unknown type or bokeh raises."""
    CamType(cam.cam_type)
    BokehType(cam.bokeh_type)
    BokehBias(cam.bokeh_bias)


def _bias_dist(r, bias):
    if bias == BokehBias.CENTER:
        return torch.sqrt(torch.sqrt(r) * r)
    if bias == BokehBias.EDGE:
        return torch.sqrt(1.0 - r * r)
    return torch.sqrt(r)


def _lens_uv(cam: Camera, r1, r2):
    """Bokeh sampling (perspectiveCam_t::getLensUV,
    perspectiveCamera.cc:100-123): (u, v) on the lens of radius 1."""
    bt = cam.bokeh_type
    if bt in (BokehType.TRIANGLE, BokehType.SQUARE, BokehType.PENTAGON,
              BokehType.HEXAGON):
        ns = int(bt)
        w0 = np.radians(cam.bokeh_rot)
        wi = 2.0 * np.pi / ns
        angles = w0 + wi * np.arange(ns + 2)
        ls = torch.as_tensor(np.stack([np.cos(angles), np.sin(angles)],
                                      axis=1).astype(np.float32),
                             device=r1.device)
        fn = float(ns)
        idx = (r1 * fn).to(torch.int32).clamp(0, ns - 1).long()
        r1f = (r1 - idx.to(torch.float32) / fn) * fn
        r1f = _bias_dist(r1f, cam.bokeh_bias)
        b1 = r1f * r2
        b0 = r1f - b1
        u = ls[idx, 0] * b0 + ls[idx + 1, 0] * b1
        v = ls[idx, 1] * b0 + ls[idx + 1, 1] * b1
        return u, v
    if bt in (BokehType.DISK2, BokehType.RING):
        w = 2.0 * np.pi * r2
        if bt == BokehType.RING:
            r = torch.full_like(r1, np.sqrt(0.707106781 + 0.292893218))
        else:
            r = _bias_dist(r1, cam.bokeh_bias)
        return r * torch.cos(w), r * torch.sin(w)
    return shirley_disk(r1, r2)


def project(cam: Camera, d):
    """World directions d [N,3] (from the camera position) to continuous
    pixel coordinates, the inverse of shoot_ray's image-plane mapping
    (perspectiveCam_t::project, perspectiveCamera.cc:168-187), for the
    perspective family.  Returns (px, py, cos_to_axis, ok); ok is False
    behind the camera or outside the image."""
    dx = dot(d, cam.cam_x)
    dy = dot(d, cam.cam_y)
    dz = dot(d, cam.cam_z)
    front = dz > 1e-6
    dz_safe = torch.where(front, dz, 1.0)
    u = dx * cam.focal / dz_safe
    v = dy * cam.focal / (dz_safe * cam.aspect_ratio)
    ok = front & (u >= -0.5) & (u <= 0.5) & (v >= -0.5) & (v <= 0.5)
    return (u + 0.5) * cam.resx, (v + 0.5) * cam.resy, dz, ok


def shoot_ray(cam: Camera, px, py, lu=None, lv=None):
    """Camera rays for continuous pixel coords px, py [N] and, for a lens
    camera, lens samples lu, lv [N].  Returns (rays [N,3] AoS, weight [N]);
    weight 0 marks rays outside the image mapping (the angular camera's
    circular mask)."""
    check_supported(cam)
    n = px.shape
    f32 = dict(dtype=torch.float32, device=px.device)
    wt = torch.ones(n, **f32)
    if cam.cam_type in (CamType.PERSPECTIVE, CamType.ARCHITECT):
        d = normalize(cam.vright[None] * px[..., None]
                      + cam.vup[None] * py[..., None] + cam.vto[None])
        o = cam.pos.expand(d.shape)
        if cam.aperture != 0.0:
            u, v = _lens_uv(cam, lu, lv)
            li = cam.aperture * (cam.cam_x[None] * u[..., None]
                                 + cam.cam_y[None] * v[..., None])
            o = o + li
            d = normalize(d * cam.dof_distance - li)
    elif cam.cam_type == CamType.ANGULAR:
        # angularCamera.cc shootRay: u, v in [-1, 1]
        u = 2.0 * px / cam.resx - 1.0
        v = 2.0 * py / cam.resy - 1.0
        r = torch.sqrt(u * u + v * v)
        theta = r * np.radians(cam.angle_deg)
        phi = torch.atan2(v, torch.where(u.abs() < 1e-12, 1e-12, u))
        sin_t = torch.sin(theta)
        d = normalize(cam.cam_z[None] * torch.cos(theta)[..., None]
                      + (cam.cam_x[None] * torch.cos(phi)[..., None]
                         + cam.cam_y[None] * torch.sin(phi)[..., None])
                      * sin_t[..., None])
        if cam.circular:
            wt = torch.where(r > cam.max_r, 0.0, wt)
        o = cam.pos.expand(d.shape)
    else:   # orthographic
        o = cam.pos[None] + cam.vright[None] * px[..., None] \
            + cam.vup[None] * py[..., None]
        d = cam.cam_z.expand(o.shape)
    return (Rays(o, d, torch.zeros(n, **f32), torch.full(n, -1.0, **f32)),
            wt)
