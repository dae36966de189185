"""Light interface: typed containers + function dispatch on Python type
(counterpart of core_tpu/lights/base.py, its SoA half).

Reference contract: light_t (include/core_api/light.h:52-113).  Lights are
few, so the integrator unrolls a Python loop over the scene's light list.
Ported: every light type of core_tpu: area, sphere, mesh, background (IBL)
and background portal, sun, and the dirac point, spot, directional and IES
lights (illuminate_s); a light class registered in lights.extra dispatches
to its own module, any other raises NotImplementedError by name.  emit_pdf
(the emission pdfs of the bidirectional integrator's path weights) covers
every type in one function, as in core_tpu.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from core_tpu_torch.vec import V3, RaysS, dot3, splat3


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


FACE_COS_BLOCK = 1 << 22   # lanes x triangles per block of _mesh_face_cos


def _mesh_face_cos(mlight, p_light: V3, d_out: V3):
    """|cos| between d_out and the face normal of the mesh-light triangle
    that holds p_light (core_tpu lights/base.py:140-172): the nearest plane
    among the triangles whose barycentric test (1e-4 slack) passes.  One
    batched test over [N, T] in blocks of triangles, where core_tpu loops
    over them one at a time; argmin returns the first of equal minima and
    a block's minimum replaces the best only when strictly smaller, so as
    with core_tpu's strict `score < best` the first triangle in list order
    wins a tie.  1 where no triangle holds the point."""
    va, vb, vc, nrm = mlight.va, mlight.vb, mlight.vc, mlight.normals
    n = p_light.x.shape[0]
    T = va.shape[0]
    p = V3(*(c[:, None] for c in p_light))
    d = V3(*(c[:, None] for c in d_out))
    best = torch.full_like(p_light.x, torch.inf)
    cos = torch.ones_like(p_light.x)
    step = max(1, FACE_COS_BLOCK // max(n, 1))
    for lo in range(0, T, step):
        hi = min(T, lo + step)

        def cols(m):
            m = m[lo:hi]
            return V3(m[None, :, 0], m[None, :, 1], m[None, :, 2])

        a, nb = cols(va), cols(nrm)
        e1 = cols(vb) - a
        e2 = cols(vc) - a
        rel = p - a
        d00, d01, d11 = dot3(e1, e1), dot3(e1, e2), dot3(e2, e2)
        d20, d21 = dot3(rel, e1), dot3(rel, e2)
        den = (d00 * d11 - d01 * d01).clamp_min(1e-20)
        v = (d11 * d20 - d01 * d21) / den
        w = (d00 * d21 - d01 * d20) / den
        inside = (v >= -1e-4) & (w >= -1e-4) & (v + w <= 1.0 + 1e-4)
        score = torch.where(inside, dot3(rel, nb).abs(), torch.inf)
        k = score.argmin(dim=1, keepdim=True)
        sb = score.gather(1, k)[:, 0]
        take = sb < best
        best = torch.where(take, sb, best)
        cos = torch.where(take, dot3(d, nb).abs().gather(1, k)[:, 0], cos)
    return cos


def emit_pdf(light, p_light: V3, d_out: V3, scene_radius=None):
    """The reference's light_t::emitPdf (core_tpu lights/base.py:175-249):
    the pdfs of emitting from p_light in the direction d_out (pointing away
    from the light), V3 of [N] each.  Returns (area_pdf [N], dir_pdf [N],
    cos_wo [N], singular, dirac_dir): area_pdf the area-measure pdf of the
    position (1 at a dirac position), dir_pdf the solid-angle pdf of the
    direction, cos_wo the |cos| to the emitting surface's normal (1 where
    there is none), singular (a dirac position) and dirac_dir (a dirac
    direction) static bools.  The sun, directional and background lights
    emit from the world bound's disk of radius scene_radius (1 if None);
    the background light's direction pdf comes through its
    intersect_light_s.  A light type the registry knows gets core_tpu's
    neutral pdfs."""
    from core_tpu_torch.lights import (area, bg, ies, mesh, point, portal,
                                       sphere, spot, sun)
    ones = torch.ones_like(p_light.x)
    inv_pi = 1.0 / math.pi
    r = 1.0 if scene_radius is None else scene_radius

    if isinstance(light, area.AreaLight):
        cos = dot3(d_out, splat3(-light.fnormal)).abs()
        return ((1.0 / light.area).expand_as(ones), cos * inv_pi, cos,
                False, False)
    if isinstance(light, mesh.MeshLight):
        cos = _mesh_face_cos(light, p_light, d_out)
        return ((1.0 / light.area).expand_as(ones), cos * inv_pi, cos,
                False, False)
    if isinstance(light, portal.BgPortalLight):
        cos = _mesh_face_cos(light.mesh, p_light, d_out)
        return ((1.0 / light.mesh.area).expand_as(ones), cos * inv_pi, cos,
                False, False)
    if isinstance(light, sphere.SphereLight):
        rad = light.radius.clamp_min(1e-9)
        c = light.center
        nrm = V3((p_light.x - c[0]) / rad, (p_light.y - c[1]) / rad,
                 (p_light.z - c[2]) / rad)
        cos = dot3(d_out, nrm).abs()
        area_ = 4.0 * math.pi * light.radius * light.radius
        return ((1.0 / area_).expand_as(ones), cos * inv_pi, cos, False,
                False)
    if isinstance(light, (point.PointLight, ies.IesLight)):
        return ones, ones / (4.0 * math.pi), ones, True, False
    if isinstance(light, spot.SpotLight):
        cone = 2.0 * math.pi * (1.0 - light.cos_end)
        return ones, ones / cone.clamp_min(1e-9), ones, True, False
    if isinstance(light, sun.SunLight):
        return ones / (math.pi * r * r), light.pdf.expand_as(ones), ones, \
            True, False
    if isinstance(light, sun.DirectionalLight):
        return ones / (math.pi * r * r), ones, ones, True, True
    if isinstance(light, bg.BgLight):
        lh = bg.intersect_light_s(light, RaysS(
            o=p_light, d=-d_out, tmin=torch.zeros_like(ones),
            tmax=torch.full_like(ones, -1.0)))
        return ones / (math.pi * r * r), 1.0 / lh.ipdf.clamp_min(1e-9), \
            ones, True, False
    _mod(light)      # a type neither ported nor registered raises here
    return ones, ones, ones, True, False
