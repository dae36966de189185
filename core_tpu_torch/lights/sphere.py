"""Sphere light with solid-angle cone sampling (counterpart of
core_tpu/lights/sphere.py; reference src/lights/spherelight.cc).

illum_sample draws a uniform cone subtending the sphere and intersects it
with the sphere enlarged by 1.000003815 in r^2 (so cone-edge directions
still hit); pdf = 1 / (2 (1 - cos_alpha)), the 2 pi folded into the
reference's conventions (spherelight.cc:101-110).  can_intersect is False,
as in core_tpu: cone sampling alone carries the light.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.sampling.utils import sample_cone_s
from core_tpu_torch.vec import V3, create_cs3, dot3, splat3

DIRAC = False


@dataclass(frozen=True)
class SphereLight:
    center: torch.Tensor   # [3]
    radius: torch.Tensor   # []
    color: torch.Tensor    # [3] color * power
    samples: int = 4


def make_sphere_light(center, radius, color, power, samples=4, *,
                      device) -> SphereLight:
    """Same float32 host math as core_tpu's make_sphere_light."""
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SphereLight(center=f(center), radius=f(radius),
                       color=f(np.asarray(color, np.float32) * power),
                       samples=int(samples))


def can_intersect(light: SphereLight) -> bool:
    return False


def get_n_samples(light: SphereLight) -> int:
    return light.samples


def _sphere_intersect(o: V3, d: V3, c, r2):
    """(hit, d1): the nearer root of |o + t d - c|^2 = r2
    (spherelight.cc:66)."""
    vf = o - splat3(c)
    ea = dot3(d, d)
    eb = 2.0 * dot3(vf, d)
    ec = dot3(vf, vf) - r2
    osc = eb * eb - 4.0 * ea * ec
    sq = torch.sqrt(osc.clamp_min(0.0))
    return osc >= 0.0, (-eb - sq) / (2.0 * ea)


def _cone(light: SphereLight, p: V3):
    """(centre direction, dist2, r2, cos_alpha) seen from p."""
    cdir = splat3(light.center) - p
    dist2 = dot3(cdir, cdir)
    r2 = light.radius * light.radius
    cos_alpha = torch.sqrt((1.0 - r2 / dist2.clamp_min(1e-12))
                           .clamp_min(1e-12))
    return cdir, dist2, r2, cos_alpha


def illum_sample_s(light: SphereLight, sp, s1, s2) -> LightSampleS:
    cdir, dist2, r2, cos_alpha = _cone(light, sp.p)
    dm = torch.sqrt(dist2).clamp_min(1e-12)
    cdir_n = V3(cdir.x / dm, cdir.y / dm, cdir.z / dm)
    du, dv = create_cs3(cdir_n)
    wi = sample_cone_s(cdir_n, du, dv, cos_alpha, s1, s2)
    hit, d1 = _sphere_intersect(sp.p, wi, light.center, r2 * 1.000003815)
    pdf = 1.0 / (2.0 * (1.0 - cos_alpha).clamp_min(1e-9))
    return LightSampleS(valid=(dist2 > r2) & hit & (d1 > 0.0), wi=wi,
                        dist=torch.where(hit, d1, 1.0),
                        col=splat3(light.color, like=s1), pdf=pdf)


def intersect_light_s(light: SphereLight, rays) -> LightHitS:
    cdir, dist2, r2, cos_alpha = _cone(light, rays.o)
    hit, d1 = _sphere_intersect(rays.o, rays.d, light.center, r2)
    valid = hit & (dist2 > r2)
    return LightHitS(valid=valid, t=torch.where(valid, d1, -1.0),
                     col=splat3(light.color, like=d1),
                     ipdf=torch.where(valid, 2.0 * (1.0 - cos_alpha), 0.0))


def illum_pdf_s(light: SphereLight, sp, p_light: V3):
    _, dist2, r2, cos_alpha = _cone(light, sp.p)
    return torch.where(dist2 > r2,
                       1.0 / (2.0 * (1.0 - cos_alpha).clamp_min(1e-9)), 0.0)
