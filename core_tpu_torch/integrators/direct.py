"""Direct-lighting integrator, SoA wavefront form
(counterpart of core_tpu/integrators/direct.py; reference
src/integrators/directlight.cc:44-263).

Emitted light + MIS direct lighting from every light at the primary hit,
the background where the camera ray misses, then the specular and glossy
chains of raytrace.recursive_raytrace up to `raydepth` (mirror, glass and
rough-glass branches, dispersion, glossy indirect).  Transparent shadows,
a transparent background, ambient occlusion and SSS are not ported:
DirectOptions has no fields for them yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.integrators import common, raytrace
from core_tpu_torch.materials import dispatch
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import rays_to_soa, where3


@dataclass(frozen=True)
class DirectOptions:
    """The fields of core_tpu's DirectOptions that are ported."""
    raydepth: int = 5


def _shade_hit(scene, types_present, rays_s, hits, pixel_sample,
               sampling_offs, include_lights):
    """Emission + direct lighting at the hits; returns (col, sp, p).  A
    cross-family blend picks its sub-material with the seed
    9781 * pixel_sample + sampling_offs, at camera and chain hits alike
    (core_tpu direct.py:62-64)."""
    sp = scene_mod.surface_points_s(scene, rays_s, hits)
    p = scene_mod.material_params_s(
        scene, sp, pick_seed=(9781 * pixel_sample + sampling_offs)
        & qmc.MASK32)
    wo = -rays_s.d
    active = hits.valid
    col = where3(active & include_lights, dispatch.emit_ss(types_present, p),
                 0.0)
    col = col + common.estimate_all_direct_s(scene, types_present, p, sp, wo,
                                             pixel_sample, sampling_offs,
                                             active)
    return col, sp, p


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: DirectOptions, stats=None):
    """directlight integrate() for a camera wavefront -> rgba [N, 4].

    rays: types.Rays ([N, 3] o, d); pixel_sample, sampling_offs: [N] int64
    tensors holding uint32 values.  stats: optional dict that collects the
    chain's live lanes per depth (raytrace.recursive_raytrace)."""
    rs = rays_to_soa(rays)
    hits = scene_mod.closest_hit_s(scene, rs)
    primary_valid = hits.valid
    col, sp, p = _shade_hit(scene, types_present, rs, hits, pixel_sample,
                            sampling_offs, torch.ones_like(primary_valid))
    col = where3(primary_valid, col,
                 eval_background_s(scene.background, rs.d))
    alpha = torch.ones_like(col.x)

    # specular + glossy indirect chains (mcintegrator.cc recursiveRaytrace)
    chain = scene.has_specular or raytrace.has_glossy(types_present)
    if chain and opts.raydepth > 0:
        def shade_fn(nrays, nhits, include_lights, active):
            # every chain hit is shaded as core_tpu's direct.py:127-136
            # shades it; `active` is the recursion's mask of live lanes
            return _shade_hit(scene, types_present, nrays, nhits,
                              pixel_sample, sampling_offs, include_lights)

        col = col + raytrace.recursive_raytrace(
            scene, types_present, rs, hits, sp, p, shade_fn, pixel_sample,
            sampling_offs, opts.raydepth, stats=stats)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1)
