"""Isotropic point light (counterpart of core_tpu/lights/point.py;
reference src/lights/pointlight.cc).

A dirac light: one sample per shading point, col / dist^2 falloff, never
hit by a ray (can_intersect False), so no MIS.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightSampleS
from core_tpu_torch.vec import V3, dot3, splat3

DIRAC = True


@dataclass(frozen=True)
class PointLight:
    pos: torch.Tensor     # [3]
    color: torch.Tensor   # [3] color * power
    samples: int = 1


def make_point_light(pos, color, power, *, device) -> PointLight:
    """Same float32 host math as core_tpu's make_point_light."""
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return PointLight(pos=f(pos), color=f(np.asarray(color, np.float32)
                                           * power))


def can_intersect(light: PointLight) -> bool:
    return False


def get_n_samples(light: PointLight) -> int:
    return 1


def to_light(light, p: V3):
    """(direction to the light [V3], dist, dist^2) from the points p."""
    ldir = splat3(light.pos) - p
    dist2 = dot3(ldir, ldir)
    dist = torch.sqrt(dist2)
    dm = dist.clamp_min(1e-12)
    return V3(ldir.x / dm, ldir.y / dm, ldir.z / dm), dist, dist2


def illuminate_s(light: PointLight, sp) -> LightSampleS:
    """pointLight_t::illuminate: col / dist^2."""
    wi, dist, dist2 = to_light(light, sp.p)
    d2 = dist2.clamp_min(1e-12)
    col = V3(light.color[0] / d2, light.color[1] / d2, light.color[2] / d2)
    return LightSampleS(valid=dist > 0, wi=wi, dist=dist, col=col,
                        pdf=torch.ones_like(dist))


def illum_pdf_s(light: PointLight, sp, p_light: V3):
    """A dirac position is never sampled by area: 0."""
    return torch.zeros_like(sp.p.x)
