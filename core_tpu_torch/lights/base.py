"""Light interface: typed containers + function dispatch on Python type
(counterpart of core_tpu/lights/base.py, its SoA half).

Reference contract: light_t (include/core_api/light.h:52-113).  Lights are
few, so the integrator unrolls a Python loop over the scene's light list.
Ported: every light type of core_tpu: area, sphere, mesh, background (IBL)
and background portal, sun, and the dirac point, spot, directional and IES
lights (illuminate_s); a light class registered in lights.extra dispatches
to its own module, any other raises NotImplementedError by name.
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
    """The module implementing a light's functions, in core_tpu's order
    (lights/base.py:33-62)."""
    from core_tpu_torch.lights import (area, bg, extra, ies, mesh, point,
                                       portal, sphere, spot, sun)
    for mod, cls in ((area, area.AreaLight), (point, point.PointLight),
                     (spot, spot.SpotLight),
                     (sun._DirectionalOps, sun.DirectionalLight),
                     (sun, sun.SunLight), (sphere, sphere.SphereLight),
                     (mesh, mesh.MeshLight), (bg, bg.BgLight),
                     (ies, ies.IesLight), (portal, portal.BgPortalLight)):
        if isinstance(light, cls):
            return mod
    return extra.module_for(light)


def dirac(light) -> bool:
    return _mod(light).DIRAC


def can_intersect(light) -> bool:
    return _mod(light).can_intersect(light)


def n_samples(light) -> int:
    return _mod(light).get_n_samples(light)


def illum_sample_s(light, sps, s1, s2) -> LightSampleS:
    return _mod(light).illum_sample_s(light, sps, s1, s2)


def illuminate_s(light, sps) -> LightSampleS:
    """The one sample of a dirac light at the shading points."""
    return _mod(light).illuminate_s(light, sps)


def intersect_light_s(light, rays_s) -> LightHitS:
    return _mod(light).intersect_light_s(light, rays_s)


def illum_pdf_s(light, sps, p_light: V3):
    """pdf of illum_sample_s choosing p_light from sps.p."""
    return _mod(light).illum_pdf_s(light, sps, p_light)
