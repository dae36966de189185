"""Photon emission from lights (counterpart of core_tpu/photon/emit.py;
the light-side light_t::emitPhoton API).

emit_photon returns (origin V3, direction V3, colour V3, ipdf [N]) for
every light type of the port; photon power is colour * ipdf, scaled by the
light-pick pdf and the photon count by the caller (mcintegrator.cc
createCausticMap :197-383).  Each branch computes in core_tpu's order of
operations, so the two packages agree to the ulp on the same samples.
"""
from __future__ import annotations

import math

import torch

from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.lights import bg as bg_mod
from core_tpu_torch.lights import ies as ies_mod
from core_tpu_torch.lights import mesh as mesh_mod
from core_tpu_torch.lights.area import AreaLight
from core_tpu_torch.lights.point import PointLight
from core_tpu_torch.lights.portal import BgPortalLight, _bg_col
from core_tpu_torch.lights.sphere import SphereLight
from core_tpu_torch.lights.spot import SpotLight
from core_tpu_torch.lights.sun import DirectionalLight, SunLight
from core_tpu_torch.sampling.utils import (min_rot, sample_cone_s,
                                           sample_cos_hemisphere_s,
                                           sample_sphere, shirley_disk)
from core_tpu_torch.vec import V3, create_cs3, dot3, splat3


def _full(like, value):
    return torch.full_like(like, float(value)) \
        if not isinstance(value, torch.Tensor) else value.expand_as(like)


def _cos_hemisphere(n: V3, s1, s2) -> V3:
    du, dv = create_cs3(n)
    return sample_cos_hemisphere_s(n, du, dv, s1, s2)


def _world_disk(center, radius: float, u, v, du: V3, dv: V3, d: V3) -> V3:
    """center + radius * (u du + v dv + d): a point of the world bound's
    disk facing d (the sun and background lights)."""
    return splat3(center) + (du * u + dv * v + d) * radius


def emit_photon(light, s1, s2, s3, s4, scene_center=None,
                scene_radius=None):
    """One photon per lane from `light` on the samples s1-s4 ([N] float32).
    scene_center ([3] tensor) and scene_radius (a float) bound the world;
    the sun, directional and background lights shoot from its disk."""
    if isinstance(light, AreaLight):
        # arealight.cc emitPhoton: the point by (s3, s4), a cosine
        # direction around the emission normal -fnormal
        o = splat3(light.corner) + splat3(light.to_x) * s3 \
            + splat3(light.to_y) * s4
        d = _cos_hemisphere(splat3(-light.fnormal, like=s1), s1, s2)
        return o, d, splat3(light.color, like=s1), _full(s1, light.area)
    if isinstance(light, PointLight):
        return (splat3(light.pos, like=s1), sample_sphere(s1, s2),
                splat3(light.color, like=s1), _full(s1, 4.0 * math.pi))
    if isinstance(light, SpotLight):
        # a uniform cone over the full angle, the falloff weight on the
        # colour (core_tpu's simplification of spotlight.cc emitPhoton)
        dirn = splat3(-light.ndir, like=s1)
        du, dv = create_cs3(dirn)
        d = sample_cone_s(dirn, du, dv, light.cos_end, s1, s2)
        cosa = dot3(d, dirn)
        icos_diff = 1.0 / (light.cos_start - light.cos_end).clamp_min(1e-9)
        v = ((cosa - light.cos_end) * icos_diff).clamp(0.0, 1.0)
        fall = torch.where(cosa >= light.cos_start, 1.0,
                           v * v * (3.0 - 2.0 * v))
        ipdf = 2.0 * math.pi * (1.0 - light.cos_end)
        return (splat3(light.pos, like=s1), d, splat3(light.color) * fall,
                _full(s1, ipdf))
    if isinstance(light, SunLight):
        # sunlight.cc emitPhoton: a disk at the world bound, direction -ldir
        ldir_c = splat3(light.direction, like=s1)
        du_c = splat3(light.du, like=s1)
        ldir = sample_cone_s(ldir_c, du_c, splat3(light.dv, like=s1),
                             light.cos_angle, s3, s4)
        u, v = shirley_disk(s1, s2)
        du2, dv2 = min_rot(ldir_c, du_c, ldir)
        o = _world_disk(scene_center, scene_radius, u, v, du2, dv2, ldir)
        e_pdf = math.pi * float(scene_radius) ** 2
        return (o, -ldir, splat3(light.col_pdf * e_pdf, like=s1),
                _full(s1, 1.0 / light.pdf))
    if isinstance(light, DirectionalLight):
        # directional.cc emitPhoton: a disk of the world radius
        dirn = splat3(light.direction, like=s1)
        du, dv = create_cs3(dirn)
        u, v = shirley_disk(s1, s2)
        r = scene_radius
        o = splat3(scene_center) + (du * u + dv * v) * r + dirn * r
        return (o, -dirn, splat3(light.color, like=s1),
                _full(s1, math.pi * float(scene_radius) ** 2))
    if isinstance(light, SphereLight):
        # spherelight.cc emitPhoton: a surface point, a cosine direction
        sdir = sample_sphere(s3, s4)
        o = splat3(light.center) + sdir * light.radius
        area = 4.0 * math.pi * light.radius * light.radius
        return (o, _cos_hemisphere(sdir, s1, s2),
                splat3(light.color, like=s1), _full(s1, area))
    if isinstance(light, mesh_mod.MeshLight):
        p, nrm = mesh_mod._sample_surface(light, s3, s4)
        return (p, _cos_hemisphere(nrm, s1, s2), splat3(light.color, like=s1),
                _full(s1, light.area))
    if isinstance(light, bg_mod.BgLight):
        # bglight.cc emitPhoton: an environment direction, shot inward from
        # the world bound's disk
        u, v, pu, pv = bg_mod._sample_uv(light, s1, s2)
        d_out = bg_mod._inv_spheremap(u, v)
        col = eval_background_s(light.background, d_out)
        sin_t = torch.sin(math.pi * v).clamp_min(1e-9)
        ipdf = 2.0 * math.pi * math.pi * sin_t / (pu * pv).clamp_min(1e-6)
        du, dv = create_cs3(-d_out)
        ux, vy = shirley_disk(s3, s4)
        o = _world_disk(scene_center, scene_radius, ux, vy, du, dv, d_out)
        e_pdf = math.pi * scene_radius ** 2
        return o, -d_out, col * e_pdf, ipdf
    if isinstance(light, ies_mod.IesLight):
        # iesLight.cc emitPhoton: sphere directions weighted by the profile
        d = sample_sphere(s1, s2)
        inten = ies_mod._intensity(light, -d)
        return (splat3(light.pos, like=s1), d, splat3(light.color) * inten,
                _full(s1, 4.0 * math.pi))
    if isinstance(light, BgPortalLight):
        # bgportallight.cc emitPhoton: a portal point, a cosine direction,
        # the background's radiance in it
        p, nrm = mesh_mod._sample_surface(light.mesh, s3, s4)
        d = _cos_hemisphere(nrm, s1, s2)
        return p, d, _bg_col(light, d), _full(s1, light.mesh.area)
    raise TypeError(f"emit_photon: unsupported light {type(light)}")
