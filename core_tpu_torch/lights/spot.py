"""Spot light with smoothstep falloff, hard-shadow form (counterpart of
core_tpu/lights/spot.py; reference src/lights/spotlight.cc).

A dirac light: between the inner cone (cos_start) and the outer cone
(cos_end) the intensity follows v^2 (3 - 2v) with
v = (cos a - cos_end) / (cos_start - cos_end) (spotlight.cc:108-127).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightSampleS
from core_tpu_torch.lights.point import to_light
from core_tpu_torch.vec import V3, dot3, splat3

DIRAC = True


@dataclass(frozen=True)
class SpotLight:
    pos: torch.Tensor        # [3]
    ndir: torch.Tensor       # [3] unit, from `to` toward the light
    color: torch.Tensor      # [3] color * power
    cos_start: torch.Tensor  # [] inner cone cosine
    cos_end: torch.Tensor    # [] outer cone cosine
    samples: int = 1
    photon_only: bool = False


def make_spot_light(pos, to, color, power, cone_angle=45.0, falloff=0.15,
                    photon_only=False, samples=1, *, device) -> SpotLight:
    """Same float64 host math as core_tpu's make_spot_light."""
    pos = np.asarray(pos, np.float64)
    ndir = pos - np.asarray(to, np.float64)
    ndir = ndir / max(np.linalg.norm(ndir), 1e-20)
    rad = np.radians(cone_angle)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return SpotLight(pos=f(pos), ndir=f(ndir),
                     color=f(np.asarray(color, np.float32) * power),
                     cos_start=f(np.cos(rad * (1.0 - falloff))),
                     cos_end=f(np.cos(rad)), samples=int(samples),
                     photon_only=bool(photon_only))


def can_intersect(light: SpotLight) -> bool:
    return False


def get_n_samples(light: SpotLight) -> int:
    return 1


def illuminate_s(light: SpotLight, sp) -> LightSampleS:
    wi, dist, dist2 = to_light(light, sp.p)
    cosa = dot3(splat3(light.ndir), wi)
    icos_diff = 1.0 / (light.cos_start - light.cos_end).clamp_min(1e-9)
    v = ((cosa - light.cos_end) * icos_diff).clamp(0.0, 1.0)
    fall = torch.where(cosa >= light.cos_start, 1.0, v * v * (3.0 - 2.0 * v))
    k = fall / dist2.clamp_min(1e-12)
    col = V3(light.color[0] * k, light.color[1] * k, light.color[2] * k)
    valid = (dist > 0.0) & (cosa >= light.cos_end)
    if light.photon_only:
        valid = torch.zeros_like(valid)
    return LightSampleS(valid=valid, wi=wi, dist=dist, col=col,
                        pdf=torch.ones_like(dist))


def illum_pdf_s(light: SpotLight, sp, p_light: V3):
    """A dirac position is never sampled by area: 0."""
    return torch.zeros_like(sp.p.x)
