"""Parallelogram area light (counterpart of core_tpu/lights/area.py;
reference src/lights/arealight.cc).

Conventions copied from the reference so MIS weights and radiance match:
- stored color = user color * power * pi               (arealight.cc:37)
- illumSample pdf = dist^2 * pi / (area * cos_angle)   (arealight.cc:86)
- intersect ipdf  = area * cos_angle / (t^2 * pi)      (arealight.cc:151)
- single-sided: emits only on the fnormal = toY x toX side.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.vec import V3, dot3, splat3

DIRAC = False


@dataclass(frozen=True)
class AreaLight:
    corner: torch.Tensor      # [3]
    to_x: torch.Tensor        # [3]
    to_y: torch.Tensor        # [3]
    color: torch.Tensor       # [3] radiance * pi
    area: torch.Tensor        # [] scalar
    fnormal: torch.Tensor     # [3] emission-side normal
    samples: int = 4
    obj_id: int = -1


def make_area_light(corner, point1, point2, color, power, samples=4,
                    obj_id=-1, *, device) -> AreaLight:
    """Same float32 host math as core_tpu's make_area_light."""
    corner = np.asarray(corner, np.float32)
    to_x = np.asarray(point1, np.float32) - corner
    to_y = np.asarray(point2, np.float32) - corner
    fnormal = np.cross(to_y, to_x)
    area = float(np.linalg.norm(fnormal))
    fnormal = fnormal / max(area, 1e-20)
    col = np.asarray(color, np.float32) * power * np.pi

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return AreaLight(corner=f(corner), to_x=f(to_x), to_y=f(to_y),
                     color=f(col), area=f(area), fnormal=f(fnormal),
                     samples=int(samples), obj_id=int(obj_id))


def can_intersect(light: AreaLight) -> bool:
    return True


def get_n_samples(light: AreaLight) -> int:
    return light.samples


def _sum_sq(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def illum_sample_s(light: AreaLight, sp, s1, s2) -> LightSampleS:
    """Sample the point corner + s1*to_x + s2*to_y as seen from sp.p."""
    c = light.corner
    tx = light.to_x
    ty = light.to_y
    p = V3(c[0] + s1 * tx[0] + s2 * ty[0],
           c[1] + s1 * tx[1] + s2 * ty[1],
           c[2] + s1 * tx[2] + s2 * ty[2])
    ldir = p - sp.p
    dist2 = dot3(ldir, ldir)
    # double-where: shading points ON the quad (emitter self-lighting,
    # masked by valid below) keep finite light-geometry gradients
    ok = dist2 > 1e-12
    safe2 = torch.where(ok, dist2, 1.0)
    dist = torch.where(ok, torch.sqrt(safe2), 0.0)
    wi = ldir * torch.where(ok, 1.0 / torch.sqrt(safe2), 0.0)
    cos_angle = dot3(wi, splat3(light.fnormal))
    valid = ok & (cos_angle > 0.0)
    pdf = dist2 * np.pi / (light.area * cos_angle).clamp_min(1e-12)
    col = splat3(light.color, like=dist)
    return LightSampleS(valid=valid, wi=wi, dist=dist, col=col, pdf=pdf)


def intersect_light_s(light: AreaLight, rays) -> LightHitS:
    """Ray-parallelogram intersection for MIS BSDF samples
    (arealight.cc:139-155)."""
    fn = splat3(light.fnormal)
    cos_angle = dot3(rays.d, fn)
    # double-where against near-parallel backward overflow
    okp = cos_angle.abs() > 1e-9
    denom = torch.where(okp, cos_angle, 1.0)
    corner = splat3(light.corner)
    t = torch.where(okp, dot3(corner - rays.o, fn) / denom, -1.0)
    p = rays.o + rays.d * t
    rel = p - corner
    xx = _sum_sq(light.to_x, light.to_x)
    yy = _sum_sq(light.to_y, light.to_y)
    xy = _sum_sq(light.to_x, light.to_y)
    rx = dot3(rel, splat3(light.to_x))
    ry = dot3(rel, splat3(light.to_y))
    det = xx * yy - xy * xy
    a = (rx * yy - ry * xy) / det.clamp_min(1e-20)
    b = (ry * xx - rx * xy) / det.clamp_min(1e-20)
    inside = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0)
    # absolute t floor of 1e-4, copied from core_tpu for parity
    # (lights/area.py:172): emitter-surface self-hits stay finite
    tok = t > 1e-4
    t_safe = torch.where(tok, t, 1.0)
    valid = okp & (cos_angle > 0.0) & inside & tok
    ipdf = torch.where(valid,
                       light.area * cos_angle / (t_safe * t_safe) / np.pi,
                       0.0)
    col = splat3(light.color, like=t)
    return LightHitS(valid=valid, t=torch.where(valid, t, -1.0), col=col,
                     ipdf=ipdf)


def illum_pdf_s(light: AreaLight, sp, p_light: V3):
    """Solid-angle pdf of illum_sample_s choosing p_light from sp.p
    (core_tpu lights/area.py:183-189); 0 behind the emitting side."""
    wi = p_light - sp.p
    r2 = dot3(wi, wi)
    dm = torch.sqrt(r2).clamp_min(1e-12)
    wi = V3(wi.x / dm, wi.y / dm, wi.z / dm)
    cos_n = dot3(wi, splat3(light.fnormal))
    return torch.where(cos_n > 0, r2 * np.pi
                       / (light.area * cos_n).clamp_min(1e-12), 0.0)
