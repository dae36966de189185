"""Directional and sun lights (counterpart of core_tpu/lights/sun.py;
reference src/lights/directional.cc, src/lights/sunlight.cc:34-76).

directional: a dirac parallel light, infinite or bounded to a cylinder of
`radius` around `pos` (directional.cc:59-78); its functions are the static
methods of _DirectionalOps, as in core_tpu.  sun: an angular disc around
`direction`, sampled as a uniform cone with pdf = 1 / (2 pi (1 -
cos_angle)); intersectable for MIS, not dirac; its functions are this
module's.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.sampling.utils import sample_cone_s
from core_tpu_torch.vec import V3, cross3, dot3, splat3

DIRAC = False


@dataclass(frozen=True)
class DirectionalLight:
    direction: torch.Tensor  # [3] unit, toward the light (wi)
    color: torch.Tensor      # [3] color * power
    pos: torch.Tensor        # [3] cylinder anchor (bounded form only)
    radius: torch.Tensor     # [] cylinder radius
    infinite: bool = True
    samples: int = 1


def make_directional_light(direction, color, power, infinite=True,
                           pos=(0, 0, 0), radius=1.0, *,
                           device) -> DirectionalLight:
    """Same host math as core_tpu's make_directional_light."""
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-20)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return DirectionalLight(direction=f(d),
                            color=f(np.asarray(color, np.float32) * power),
                            pos=f(pos), radius=f(radius),
                            infinite=bool(infinite))


class _DirectionalOps:
    """The directional light's functions (core_tpu sun._DirectionalOps)."""
    DIRAC = True

    @staticmethod
    def can_intersect(light):
        return False

    @staticmethod
    def get_n_samples(light):
        return 1

    @staticmethod
    def illuminate_s(light: DirectionalLight, sp) -> LightSampleS:
        like = sp.p.x
        wi = splat3(light.direction, like=like)
        if light.infinite:
            valid = torch.ones_like(like, dtype=torch.bool)
            dist = torch.full_like(like, -1.0)    # unbounded shadow ray
        else:
            vec = splat3(light.pos) - sp.p
            c = cross3(wi, vec)
            perp = torch.sqrt(dot3(c, c))
            dist = dot3(vec, splat3(light.direction))
            valid = (perp <= light.radius) & (dist > 0.0)
        return LightSampleS(valid=valid, wi=wi, dist=dist,
                            col=splat3(light.color, like=like),
                            pdf=torch.ones_like(like))


@dataclass(frozen=True)
class SunLight:
    direction: torch.Tensor  # [3] toward the sun, unit
    col_pdf: torch.Tensor    # [3] color * power * pdf
    cos_angle: torch.Tensor  # []
    pdf: torch.Tensor        # [] 1 / (2pi (1-cosAngle))
    du: torch.Tensor         # [3]
    dv: torch.Tensor         # [3]
    samples: int = 4


def make_sun_light(direction, color, power, angle=0.27, samples=4, *,
                   device) -> SunLight:
    """Same float64 host math as core_tpu's make_sun_light."""
    d = np.asarray(direction, np.float64)
    d = d / max(np.linalg.norm(d), 1e-20)
    angle = min(float(angle), 80.0)
    cos_angle = np.cos(np.radians(angle))
    pdf = 1.0 / max(2.0 * np.pi * (1.0 - cos_angle), 1e-12)
    # host-side createCS
    if abs(d[0]) < 1e-6 and abs(d[1]) < 1e-6:
        du = np.array([1.0 if d[2] >= 0 else -1.0, 0.0, 0.0])
    else:
        il = 1.0 / np.sqrt(d[0] * d[0] + d[1] * d[1])
        du = np.array([d[1] * il, -d[0] * il, 0.0])
    dv = np.cross(d, du)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SunLight(direction=f(d),
                    col_pdf=f(np.asarray(color, np.float32) * power * pdf),
                    cos_angle=f(cos_angle), pdf=f(pdf), du=f(du), dv=f(dv),
                    samples=int(samples))


def can_intersect(light: SunLight) -> bool:
    return True


def get_n_samples(light: SunLight) -> int:
    return light.samples


def illum_sample_s(light: SunLight, sp, s1, s2) -> LightSampleS:
    wi = sample_cone_s(splat3(light.direction), splat3(light.du),
                       splat3(light.dv), light.cos_angle, s1, s2)
    return LightSampleS(valid=torch.ones_like(s1, dtype=torch.bool), wi=wi,
                        dist=torch.full_like(s1, -1.0),
                        col=splat3(light.col_pdf, like=s1),
                        pdf=light.pdf.expand_as(s1))


def illum_pdf_s(light: SunLight, sp, p_light: V3):
    """The cone's constant solid-angle pdf."""
    return light.pdf.expand_as(p_light.x)


def intersect_light_s(light: SunLight, rays) -> LightHitS:
    valid = dot3(rays.d, splat3(light.direction)) >= light.cos_angle
    return LightHitS(valid=valid, t=torch.full_like(rays.d.x, -1.0),
                     col=splat3(light.col_pdf, like=rays.d.x),
                     ipdf=torch.where(valid, 1.0 / light.pdf, 0.0))
