"""The shared recursiveRaytrace of the integrators, wavefront form
(counterpart of core_tpu/integrators/raytrace.py; reference
mcintegrator.cc:421-628).

The reference follows three branch families at every hit: the dispersive
step (one sampled wavelength), the glossy branch (glossy indirect
reflection, mcintegrator.cc:487-527) and the perfect specular reflect /
refract recursion.  A static-shape wavefront cannot fork, so each lane picks
ONE continuation among {specular reflect, specular refract, glossy lobe}
with probability proportional to the branch energy and divides its
throughput by that probability: the expectation of the full branching, with
more variance on multi-branch materials at equal sample counts, as in
core_tpu.

Emission and background rules:
- specular-branch hits include emission (specular directions are excluded
  from NEE MIS, so nothing else counts them);
- glossy-branch hits do not (the BSDF-MIS side of the NEE at the glossy
  vertex already counts BSDF-sampled light);
- a glossy-branch miss sees no background when the scene has a background
  light, for the same reason.

The glossy lobe is requested as GLOSSY|REFLECT|TRANSMIT, without DIFFUSE:
an `as_diffuse` glossy material declines it (glossy.py).
"""
from __future__ import annotations

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, MatType, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST, luminance
from core_tpu_torch.sampling import qmc, spectrum
from core_tpu_torch.vec import V3, RaysS, where3, zeros3

GLOSSY_FAMILIES = (int(MatType.GLOSSY), int(MatType.COATED_GLOSSY),
                   int(MatType.ROUGH_GLASS))


def has_glossy(types_present) -> bool:
    """The scene needs the glossy indirect branch at all."""
    return any(int(t) in GLOSSY_FAMILIES for t in types_present)


def scene_has_bg_light(scene) -> bool:
    from core_tpu_torch.lights.bg import BgLight
    return any(isinstance(light, BgLight) for light in scene.lights)


def apply_dispersion(cur_p, chromatic, wl, throughput: V3):
    """Spectral dispersion on specular chains: where a path first enters a
    DISPERSIVE row it turns monochromatic at the camera sample's wavelength
    wl: its throughput is weighted by wl2rgb(wl) once, and the row's IOR
    becomes the Cauchy n(wl) (core_tpu raytrace.py:54-72).  Returns
    (params, chromatic, throughput)."""
    disp = cur_p.dispersion > 0.0
    newly = disp & ~chromatic
    a, b = spectrum.cauchy_coefficients(cur_p.ior, cur_p.dispersion)
    ior = torch.where(disp, spectrum.cauchy_ior(wl, a, b), cur_p.ior)
    throughput = where3(newly, throughput * spectrum.wl2rgb(wl), throughput)
    return cur_p._replace(ior=ior), chromatic | disp, throughput


def recursive_raytrace(scene, types_present, rays_s: RaysS, hits, sp, p,
                       shade_fn, pixel_sample, sampling_offs, raydepth: int,
                       stats=None) -> V3:
    """Specular and glossy indirect chains from already-shaded camera hits.

    shade_fn(nrays, nhits, include_lights, active) -> (col V3, sp, p): the
    integrator's shading of a chain hit, its emission gated by the
    include_lights mask.  Returns the chain radiance to add to the camera
    hits' shading.  pixel_sample, sampling_offs: [N] int64 tensors holding
    uint32 values.  stats: optional dict; each depth appends to its
    "chain_live" list the count of lanes live in that depth's closest-hit
    wavefront (a device tensor; every one of the N lanes is traced)."""
    glossy = has_glossy(types_present)
    col = zeros3(rays_s.tmin)
    throughput = V3(*(torch.ones_like(rays_s.tmin),) * 3)
    cur_sp, cur_p = sp, p
    cur_wo = -rays_s.d
    active = hits.valid
    exclude = sp.prim
    chromatic = torch.zeros_like(active)
    u32 = (pixel_sample + sampling_offs) & qmc.MASK32
    wl = qmc.scr_halton(29, u32)
    bg_is_light = scene_has_bg_light(scene)

    for depth in range(raydepth):
        cur_p, chromatic, throughput = apply_dispersion(
            cur_p, chromatic, wl, throughput)
        spec = dispatch.get_specular_s(types_present, cur_p, cur_sp, cur_wo)
        lum_refl = luminance(spec.refl_col) * spec.refl_valid
        lum_refr = luminance(spec.refr_col) * spec.refr_valid
        if glossy:
            gres = detach_sample(dispatch.sample_bsdf_s(
                types_present, cur_p, cur_sp, cur_wo,
                qmc.scr_halton(3 * depth + 13, u32),
                qmc.scr_halton(3 * depth + 14, u32),
                BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT))
            g_col3 = gres.col * gres.w
            g_ok = (gres.pdf > 1e-6) & ((gres.flags & BSDF.GLOSSY) != 0)
            lum_g = torch.where(g_ok, luminance(g_col3), 0.0)
        else:
            lum_g = torch.zeros_like(lum_refl)

        total = lum_refl + lum_refr + lum_g
        cont = active & (total > 1e-7)
        r = qmc.scr_halton(2 * depth + 5, u32)
        inv_total = 1.0 / total.clamp_min(1e-20)
        p_refl = lum_refl * inv_total
        p_refr = lum_refr * inv_total
        take_refl = (r < p_refl) & spec.refl_valid
        take_refr = ~take_refl & (r < p_refl + p_refr) & spec.refr_valid
        take_gloss = cont & ~take_refl & ~take_refr & (lum_g > 0.0)

        branch_dir = where3(take_refl, spec.refl_dir, spec.refr_dir)
        branch_col = where3(take_refl, spec.refl_col, spec.refr_col)
        if glossy:
            branch_dir = where3(take_gloss, gres.wi, branch_dir)
            branch_col = where3(take_gloss, g_col3, branch_col)
        # the branch pick is part of the sampling, so its probability is
        # held constant in the backward pass (core_tpu raytrace.py:136)
        branch_p = torch.where(
            take_refl, p_refl, torch.where(
                take_refr, p_refr, (lum_g * inv_total).clamp_min(0.0)))
        den = branch_p.detach().clamp_min(1e-6)
        cont = cont & (take_refl | take_refr | take_gloss)
        if stats is not None:
            stats.setdefault("chain_live", []).append(cont.sum())
        # a lane that takes no branch keeps core_tpu's throughput (the
        # refract branch's colour) and is masked out by `cont`
        tb = throughput * branch_col
        throughput_new = V3(tb.x / den, tb.y / den, tb.z / den)

        nrays = RaysS(o=cur_sp.p, d=branch_dir,
                      tmin=torch.full_like(total, MIN_RAYDIST),
                      tmax=torch.full_like(total, -1.0))
        nhits = scene_mod.closest_hit_s(scene, nrays, exclude_prim=exclude)
        hit_ok = nhits.valid & cont
        if scene.background is not None:
            bg_take = take_refl | take_refr
            if not bg_is_light:
                bg_take = bg_take | take_gloss
            col = col + where3(cont & bg_take & ~nhits.valid,
                               throughput_new
                               * eval_background_s(scene.background,
                                                   branch_dir), 0.0)
        scol, nsp, np_ = shade_fn(nrays, nhits, take_refl | take_refr,
                                  hit_ok)
        col = col + where3(hit_ok, throughput_new * scol, 0.0)
        throughput = throughput_new
        cur_sp, cur_p = nsp, np_
        cur_wo = -branch_dir
        exclude = nsp.prim
        active = hit_ok
    return col
