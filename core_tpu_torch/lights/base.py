"""Light interface: typed containers + function dispatch on Python type
(counterpart of core_tpu/lights/base.py, its SoA half).

Reference contract: light_t (include/core_api/light.h:52-113).  Lights are
few, so the integrator unrolls a Python loop over the scene's light list.
Ported: the area, sun and background (IBL) lights; any other light type
raises NotImplementedError by name.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from core_tpu_torch.vec import V3


class LightSampleS(NamedTuple):
    """SoA light sample: wi/col are V3 of [N]."""
    valid: torch.Tensor
    wi: V3
    dist: torch.Tensor
    col: V3               # radiance (reference convention: *pi baked in)
    pdf: torch.Tensor


class LightHitS(NamedTuple):
    valid: torch.Tensor
    t: torch.Tensor
    col: V3
    ipdf: torch.Tensor    # inverse pdf as returned by reference intersect()


def _mod(light):
    """The module implementing a light's functions."""
    from core_tpu_torch.lights import area, bg, sun
    for mod, cls in ((area, area.AreaLight), (sun, sun.SunLight),
                     (bg, bg.BgLight)):
        if isinstance(light, cls):
            return mod
    raise NotImplementedError(
        f"light type {type(light).__name__} is not ported to core_tpu_torch "
        "yet")


def dirac(light) -> bool:
    return _mod(light).DIRAC


def can_intersect(light) -> bool:
    return _mod(light).can_intersect(light)


def n_samples(light) -> int:
    return _mod(light).get_n_samples(light)


def illum_sample_s(light, sps, s1, s2) -> LightSampleS:
    return _mod(light).illum_sample_s(light, sps, s1, s2)


def intersect_light_s(light, rays_s) -> LightHitS:
    return _mod(light).intersect_light_s(light, rays_s)


def illum_pdf_s(light, sps, p_light: V3):
    """pdf of illum_sample_s choosing p_light from sps.p (sun and bg)."""
    return _mod(light).illum_pdf_s(light, sps, p_light)
