"""Photon-mapping integrator, SoA wavefront form: the classic two maps and
final gathering (counterpart of core_tpu/integrators/photonmap.py).

Reference: src/integrators/photonintegr.cc -- preprocess shoots the
diffuse and caustic photon maps (:126-640); integrate() adds emission,
direct light, the caustic map's radiance and the indirect light of final
gathering (:647-860).  The maps are built by one wavefront shoot each into
a sorted uniform grid (photon/map.py); final gathering casts fg_samples
cosine-distributed rays per shading point, whose hits read the diffuse
map's radiance cache (or estimate its density without the cache).
Camera-visible specular and glossy chains go through the shared
recursiveRaytrace, each chain hit shaded like a camera hit.

Photon shooting, final gathering and the chains trace through
scene.closest_hit_s, direct light through common's NEE: kernels 1 and 2 on
a brute scene, 4 and 6 on a flat one, 7 and 8 on a grouped one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.differentials import texture_lod
from core_tpu_torch.integrators import common, raytrace
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.photon import map as pmap_mod
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import V3, RaysS, rays_to_soa, where3, zeros3


@dataclass(frozen=True)
class PhotonOptions:
    """core_tpu's PhotonOptions (core_tpu/integrators/photonmap.py:29-44)."""
    photons: int = 100000          # diffuse photons shot
    c_photons: int = 50000         # caustic photons shot
    diffuse_radius: float = 1.0    # gather radius (reference diffuseRadius)
    caustic_radius: float = 0.1    # (reference causticRadius)
    bounces: int = 5               # photon bounce depth
    final_gather: bool = True
    fg_samples: int = 16
    # radiance cache (photonintegr.cc:42-107,574): irradiance pre-gathered
    # at the deposits at preprocess, one cell read per final-gather ray
    fg_cache: bool = True
    raydepth: int = 5
    use_diffuse: bool = True
    use_caustics: bool = True
    transp_background: bool = False


def scene_bound(scene):
    """Host-side world AABB (scene_t::getSceneBound): numpy float32
    (bmin, bmax), one read of the vertices."""
    v = scene.geom.verts.detach().cpu().numpy()
    return v.min(axis=0), v.max(axis=0)


def scene_center_radius(scene):
    """World bounding sphere on the device: ([3] centre, [] radius)."""
    v = scene.geom.verts
    bmin, bmax = v.min(dim=0).values, v.max(dim=0).values
    return 0.5 * (bmin + bmax), 0.5 * torch.sqrt(((bmax - bmin) ** 2).sum())


def world_sphere(scene, bmin, bmax):
    """The host bound's centre ([3] float32 tensor on the scene's device)
    and radius (a float), as core_tpu's preprocess computes them."""
    center = torch.tensor(0.5 * (bmin + bmax), dtype=torch.float32,
                          device=scene.device)
    return center, float(0.5 * np.linalg.norm(bmax - bmin))


def preprocess(scene, types_present, opts: PhotonOptions) -> dict:
    """Shoot both photon maps (photonintegr.cc preprocess): "diffuse" (with
    its "fg_cache" under final_gather and fg_cache) and, on a scene with
    specular materials, "caustic"."""
    bmin, bmax = scene_bound(scene)
    center, radius = world_sphere(scene, bmin, bmax)
    aux = {}
    with_cache = opts.final_gather and opts.fg_cache
    if opts.use_diffuse:
        out = pmap_mod.shoot_photons(
            scene, types_present, opts.photons, opts.bounces, seed=1,
            mode="diffuse", scene_center=center, scene_radius=radius,
            with_surface=with_cache)
        grid = pmap_mod.build_photon_grid(*out[:4], opts.diffuse_radius,
                                          bmin, bmax)
        aux["diffuse"] = grid
        if with_cache:
            aux["fg_cache"] = pmap_mod.build_radiance_cache(
                grid, out[4], out[5], opts.diffuse_radius)
    if opts.use_caustics and scene.has_specular:
        out = pmap_mod.shoot_photons(
            scene, types_present, opts.c_photons, opts.bounces, seed=2,
            mode="caustic", scene_center=center, scene_radius=radius)
        aux["caustic"] = pmap_mod.build_photon_grid(
            *out, opts.caustic_radius, bmin, bmax)
    return aux


def _over_pi(c: V3) -> V3:
    """c / pi, componentwise (core_tpu's `... / np.pi`)."""
    return V3(*(x / math.pi for x in c))


def _caustic_radiance(pmap, p, sp, wo, types_present, radius) -> V3:
    """The caustic map's kernel estimate times the BSDF
    (mcintegrator.cc estimateCausticPhotons :384)."""
    irr = pmap_mod.estimate_irradiance(pmap, sp.p, sp.n, radius)
    surf = dispatch.eval_bsdf_s(types_present, p, sp, wo, sp.n, BSDF.ALL)
    return _over_pi(surf * irr)


def _final_gather(scene, types_present, dmap, p, sp, wo, pixel_sample,
                  sampling_offs, active, opts: PhotonOptions,
                  cache=None) -> V3:
    """fg_samples cosine-sampled gather rays per shading point, the diffuse
    map's radiance at each one's hit (photonintegr.cc finalGathering
    :647): one cell read of the radiance cache, or albedo / pi times the
    density estimate there without it."""
    n = max(1, opts.fg_samples)
    offs = (n * pixel_sample + sampling_offs) & qmc.MASK32
    acc = zeros3(wo.x)
    tmin = torch.full_like(wo.x, MIN_RAYDIST)
    tmax = torch.full_like(wo.x, -1.0)
    for i in range(n):
        idx = (offs + i) & qmc.MASK32
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, p, sp, wo, qmc.ri_vdc(idx), qmc.scr_halton(2, idx),
            BSDF.DIFFUSE | BSDF.REFLECT))
        rays = RaysS(o=sp.p, d=sres.wi, tmin=tmin, tmax=tmax)
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=sp.prim)
        gsp = scene_mod.surface_points_s(scene, rays, hits)
        if cache is not None:
            li = pmap_mod.lookup_radiance(cache, gsp.p)
        else:
            gp = scene_mod.material_params_s(scene, gsp)
            irr = pmap_mod.estimate_irradiance(dmap, gsp.p, gsp.n,
                                               opts.diffuse_radius)
            alb = dispatch.eval_bsdf_s(types_present, gp, gsp, -sres.wi,
                                       gsp.n, BSDF.ALL)
            li = _over_pi(alb * irr)
        ok = active & hits.valid & (sres.pdf > 1e-6)
        acc = acc + where3(ok, sres.col * li * sres.w, 0.0)
    return V3(*(c / n for c in acc))


def _shade_hit(scene, types_present, rays_s, hits, pixel_sample,
               sampling_offs, include_lights, opts: PhotonOptions, aux,
               diff=None):
    """Photon-map shading at the hits: emission, direct light, the caustic
    map and the indirect light (final gathering, or the diffuse map's
    estimate); the body shared by the camera hits and the chains.
    Returns (col, sp, p)."""
    sp = scene_mod.surface_points_s(scene, rays_s, hits)
    lod = None if diff is None else texture_lod(scene, sp, rays_s, *diff)
    p = scene_mod.material_params_s(scene, sp, lod=lod)
    wo = -rays_s.d
    active = hits.valid
    col = where3(active & include_lights, dispatch.emit_ss(types_present, p),
                 0.0)
    diffuse = active & ((p.flags & BSDF.DIFFUSE) != 0)
    col = col + common.estimate_all_direct_s(
        scene, types_present, p, sp, wo, pixel_sample, sampling_offs, active)
    if "caustic" in aux:
        col = col + where3(diffuse, _caustic_radiance(
            aux["caustic"], p, sp, wo, types_present, opts.caustic_radius),
            0.0)
    if "diffuse" in aux:
        if opts.final_gather:
            ind = _final_gather(scene, types_present, aux["diffuse"], p, sp,
                                wo, pixel_sample, sampling_offs, diffuse,
                                opts, cache=aux.get("fg_cache"))
        else:
            irr = pmap_mod.estimate_irradiance(aux["diffuse"], sp.p, sp.n,
                                               opts.diffuse_radius)
            alb = dispatch.eval_bsdf_s(types_present, p, sp, wo, sp.n,
                                       BSDF.ALL)
            ind = _over_pi(alb * irr)
        col = col + where3(diffuse, ind, 0.0)
    return col, sp, p


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: PhotonOptions, aux=None, diff=None):
    """photonmapping integrate() for a camera wavefront -> rgba [N, 4]
    (photonintegr.cc:791-860): emission, direct light, caustic photons and
    final-gathered indirect light, then the specular and glossy chains.
    aux: preprocess()'s maps.  diff: the camera rays' neighbour directions
    (image-texture mip levels at the camera hits)."""
    if aux is None:
        raise ValueError("photonmapping needs preprocess()'s photon maps "
                         "(aux)")
    rs = rays_to_soa(rays)
    hits = scene_mod.closest_hit_s(scene, rs)
    primary_valid = hits.valid
    col, sp, p = _shade_hit(scene, types_present, rs, hits, pixel_sample,
                            sampling_offs, torch.ones_like(primary_valid),
                            opts, aux, diff)
    chain = scene.has_specular or raytrace.has_glossy(types_present)
    if chain and opts.raydepth > 0:
        def shade_fn(nrays, nhits, include_lights, active):
            return _shade_hit(scene, types_present, nrays, nhits,
                              pixel_sample, sampling_offs, include_lights,
                              opts, aux)

        col = col + raytrace.recursive_raytrace(
            scene, types_present, rs, hits, sp, p, shade_fn, pixel_sample,
            sampling_offs, opts.raydepth)
    col = where3(primary_valid, col,
                 eval_background_s(scene.background, rs.d))
    alpha = torch.where(primary_valid, 1.0,
                        0.0 if opts.transp_background else 1.0)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1)
