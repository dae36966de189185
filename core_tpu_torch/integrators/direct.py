"""Direct-lighting integrator, SoA wavefront form
(counterpart of core_tpu/integrators/direct.py; reference
src/integrators/directlight.cc:44-263).

Emitted light + MIS direct lighting from every light (+ optional ambient
occlusion) at the primary hit, the background where the camera ray misses
(alpha 0 there under transp_background), then the specular and glossy
chains of raytrace.recursive_raytrace up to `raydepth` (mirror, glass and
rough-glass branches, dispersion, glossy indirect), each chain hit shaded
like the primary one.  Transparent shadows (transp_shad) walk shadow rays
through FILTER materials (common.transparent_shadow).  Under use_sss every
shaded hit (camera and chain) adds sss_scale times the dipole estimate of
the SSS map that render.integrator_preprocess built (integrators/sss.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.differentials import texture_lod
from core_tpu_torch.integrators import common, raytrace, sss
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (V3, RaysS, dot3, rays_to_soa, where3,
                                zeros3)


@dataclass(frozen=True)
class DirectOptions:
    """core_tpu's DirectOptions (core_tpu/integrators/direct.py:34-49)."""
    raydepth: int = 5
    # transparent shadows (reference transpShad/shadowDepth): shadow rays
    # walk through FILTER materials accumulating their filter colour
    transp_shad: bool = False
    shadow_depth: int = 5
    use_ao: bool = False
    ao_samples: int = 32
    ao_dist: float = 1.0
    ao_color: tuple = (1.0, 1.0, 1.0)
    transp_background: bool = False
    # TheBounty SSS: the dipole estimate of the SSS map at translucent
    # hits (mcintegrator.cc useSSS / sss_maps wiring)
    use_sss: bool = False
    sss_photons: int = 8192
    sss_steps: int = 4
    sss_scale: float = 1.0


def _shade_hit(scene, types_present, rays_s, hits, pixel_sample,
               sampling_offs, include_lights, opts: DirectOptions,
               diff=None, aux=None):
    """Emission + direct lighting (+ ambient occlusion) at the hits; returns
    (col, sp, p).  A cross-family blend picks its sub-material with the
    seed 9781 * pixel_sample + sampling_offs, at camera and chain hits
    alike (core_tpu direct.py:62-64).  diff: the camera rays' neighbour
    directions (dxd, dyd), given at the camera hits only, whose footprint
    selects image-texture mip levels (core_tpu direct.py:58-61).  aux: the
    SSS map under use_sss (core_tpu direct.py:78-81)."""
    sp = scene_mod.surface_points_s(scene, rays_s, hits)
    lod = None if diff is None else texture_lod(scene, sp, rays_s, *diff)
    p = scene_mod.material_params_s(
        scene, sp, pick_seed=(9781 * pixel_sample + sampling_offs)
        & qmc.MASK32, lod=lod)
    wo = -rays_s.d
    active = hits.valid
    col = where3(active & include_lights, dispatch.emit_ss(types_present, p),
                 0.0)
    col = col + common.estimate_all_direct_s(
        scene, types_present, p, sp, wo, pixel_sample, sampling_offs, active,
        opts.transp_shad, opts.shadow_depth)
    if opts.use_ao:
        col = col + _ambient_occlusion(scene, types_present, p, sp, wo,
                                       pixel_sample, sampling_offs, active,
                                       opts)
    if opts.use_sss and aux is not None:
        col = col + sss.estimate_sss(aux, sp, p, wo, active) \
            * opts.sss_scale
    return col, sp, p


def _ambient_occlusion(scene, types_present, p, sp, wo, pixel_sample,
                       sampling_offs, active, opts: DirectOptions):
    """mcIntegrator_t::sampleAmbientOcclusion (core_tpu direct.py:85-106;
    mcintegrator.cc:629-707): ao_samples BSDF samples per hit, each one
    occlusion ray of length ao_dist through scene.any_hit_s (kernel 3, 5
    or 8), one wavefront per sample.  Inactive lanes get dead caps."""
    n = max(1, opts.ao_samples)
    offs = (n * pixel_sample + sampling_offs) & qmc.MASK32
    ao_col = V3(*(float(c) for c in opts.ao_color))
    tmin = torch.full(offs.shape, MIN_RAYDIST, dtype=torch.float32,
                      device=offs.device)
    tcap = torch.where(active, float(opts.ao_dist), 0.5 * MIN_RAYDIST)
    acc = zeros3(wo.x)
    for i in range(n):
        idx = (offs + i) & qmc.MASK32
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, p, sp, wo, qmc.ri_vdc(idx),
            qmc.scr_halton(2, idx), BSDF.GLOSSY | BSDF.DIFFUSE
            | BSDF.REFLECT))
        shadowed = scene_mod.any_hit_s(
            scene, RaysS(o=sp.p, d=sres.wi, tmin=tmin, tmax=tcap),
            exclude_prim=sp.prim)
        cos = dot3(sp.n, sres.wi).abs()
        ok = active & ~shadowed & (sres.pdf > 1e-6)
        acc = acc + where3(ok, sres.col * ao_col * (cos * sres.w), 0.0)
    return V3(*(c / n for c in acc))


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: DirectOptions, stats=None, diff=None, aux=None):
    """directlight integrate() for a camera wavefront -> rgba [N, 4].

    rays: types.Rays ([N, 3] o, d); pixel_sample, sampling_offs: [N] int64
    tensors holding uint32 values.  stats: optional dict that collects the
    chain's live lanes per depth (raytrace.recursive_raytrace).  diff:
    optional (dxd, dyd) neighbour directions of the camera rays
    (differentials.camera_diff_dirs).  aux: the SSS map
    (sss.build_sss_map) under use_sss."""
    rs = rays_to_soa(rays)
    hits = scene_mod.closest_hit_s(scene, rs)
    primary_valid = hits.valid
    col, sp, p = _shade_hit(scene, types_present, rs, hits, pixel_sample,
                            sampling_offs, torch.ones_like(primary_valid),
                            opts, diff, aux)
    col = where3(primary_valid, col,
                 eval_background_s(scene.background, rs.d))
    alpha = torch.where(primary_valid, 1.0,
                        0.0 if opts.transp_background else 1.0)

    # specular + glossy indirect chains (mcintegrator.cc recursiveRaytrace)
    chain = scene.has_specular or raytrace.has_glossy(types_present)
    if chain and opts.raydepth > 0:
        def shade_fn(nrays, nhits, include_lights, active):
            # every chain hit is shaded as core_tpu's direct.py:127-136
            # shades it; `active` is the recursion's mask of live lanes
            return _shade_hit(scene, types_present, nrays, nhits,
                              pixel_sample, sampling_offs, include_lights,
                              opts, aux=aux)

        col = col + raytrace.recursive_raytrace(
            scene, types_present, rs, hits, sp, p, shade_fn, pixel_sample,
            sampling_offs, opts.raydepth, stats=stats)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1)
