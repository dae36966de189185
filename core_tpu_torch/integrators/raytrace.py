"""The glossy branch of recursiveRaytrace, wavefront form
(counterpart of core_tpu/integrators/raytrace.py; reference
mcintegrator.cc:421-628).

core_tpu's recursive_raytrace lets each lane pick one continuation among
{specular reflect, specular refract, glossy lobe} with probability
proportional to the branch energy.  Scope here: scenes without perfect
specular materials (Scene.has_specular False), where every getSpecular
branch is invalid, so the continuation is the glossy lobe or nothing; the
ray of a lane that takes no branch keeps core_tpu's direction (-wo, the
invalid refraction direction) and is masked out.  Specular chains and
dispersion raise NotImplementedError by name.

Glossy-branch hits add no emission and, when the scene has a background
light, no background on a miss (the BSDF-MIS side of the NEE at the glossy
vertex already counts them).
"""
from __future__ import annotations

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, MatType, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import V3, RaysS, luminance3, where3, zeros3

GLOSSY_FAMILIES = (int(MatType.GLOSSY), int(MatType.COATED_GLOSSY),
                   int(MatType.ROUGH_GLASS))


def has_glossy(types_present) -> bool:
    """The scene needs the glossy indirect branch at all."""
    return any(int(t) in GLOSSY_FAMILIES for t in types_present)


def scene_has_bg_light(scene) -> bool:
    from core_tpu_torch.lights.bg import BgLight
    return any(isinstance(light, BgLight) for light in scene.lights)


def recursive_raytrace(scene, types_present, rays_s: RaysS, hits, sp, p,
                       shade_fn, pixel_sample, sampling_offs,
                       raydepth: int) -> V3:
    """Glossy indirect chains from already-shaded primary hits.

    shade_fn(nrays, nhits, include_lights) -> (col V3, sp, p): the
    integrator's shading of a chain hit.  Returns the chain radiance to add
    to the primary shading."""
    if scene.has_specular:
        raise NotImplementedError("perfect specular chains (mirror, glass) "
                                  "and dispersion are not ported to "
                                  "core_tpu_torch yet")
    col = zeros3(rays_s.tmin)
    throughput = None
    cur_sp, cur_p = sp, p
    cur_wo = -rays_s.d
    active = hits.valid
    exclude = sp.prim
    u32 = (pixel_sample + sampling_offs) & qmc.MASK32
    bg_is_light = scene_has_bg_light(scene)
    if not has_glossy(types_present):
        return col

    for depth in range(raydepth):
        g1 = qmc.scr_halton(3 * depth + 13, u32)
        g2 = qmc.scr_halton(3 * depth + 14, u32)
        gres = detach_sample(dispatch.sample_bsdf_s(
            types_present, cur_p, cur_sp, cur_wo, g1, g2,
            BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT))
        g_col3 = gres.col * gres.w
        g_ok = (gres.pdf > 1e-6) & ((gres.flags & BSDF.GLOSSY) != 0)
        lum_g = torch.where(g_ok, luminance3(g_col3), 0.0)
        # the reflect and refract energies are 0 without specular
        # materials, so the total is the glossy lobe's
        total = lum_g
        take_gloss = active & (total > 1e-7) & (lum_g > 0.0)
        branch_p = (lum_g * (1.0 / total.clamp_min(1e-20))).clamp_min(0.0)
        branch_dir = where3(take_gloss, gres.wi, -cur_wo)
        tb = g_col3 if throughput is None else throughput * g_col3
        den = branch_p.clamp_min(1e-6)
        throughput_new = where3(take_gloss,
                                V3(tb.x / den, tb.y / den, tb.z / den), 0.0)

        n = lum_g.shape[0]
        nrays = RaysS(o=cur_sp.p, d=branch_dir,
                      tmin=torch.full_like(lum_g, MIN_RAYDIST),
                      tmax=torch.full_like(lum_g, -1.0))
        nhits = scene_mod.closest_hit_s(scene, nrays, exclude_prim=exclude)
        hit_ok = nhits.valid & take_gloss
        if scene.background is not None and not bg_is_light:
            bg2 = eval_background_s(scene.background, branch_dir)
            col = col + where3(take_gloss & ~nhits.valid,
                               throughput_new * bg2, 0.0)
        scol, nsp, np_ = shade_fn(nrays, nhits,
                                  torch.zeros(n, dtype=torch.bool,
                                              device=lum_g.device))
        col = col + where3(hit_ok, throughput_new * scol, 0.0)
        throughput = throughput_new
        cur_sp, cur_p = nsp, np_
        cur_wo = -branch_dir
        exclude = nsp.prim
        active = hit_ok
    return col
