"""Unidirectional path tracer, wavefront form
(counterpart of core_tpu/integrators/path.py).

Reference: src/integrators/pathtracer.cc:134-333 — per camera hit:
emission + MIS direct lighting, then `path_samples` independent paths of up
to `bounces` vertices; each bounce does next-event estimation with one
Halton-chosen light and adds emission only on caustic (specular/glossy/
filter) bounces; the background contributes on a primary miss and on a
miss after a caustic bounce.  All `path_samples` paths are batched into one
(path_samples x N)-lane SoA wavefront, so each bounce costs one BSDF
sample, one closest-hit launch and one batched NEE.  QMC dimensions match
the reference: path sample i uses
  offs = n_paths * pixel_sample + sampling_offs + i
  first bounce: s1 = RI_vdC(offs), s2 = scrHalton(2, offs)
  depth d >= 1: s1 = scrHalton(4d+3, offs), s2 = scrHalton(4d+4, offs).

Scope: scenes without specular chains, caustic_type "path" or "none", no
wavefront folding; the rest raises NotImplementedError.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.integrators import common
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, MatType, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (RaysS, luminance3, rays_to_soa, tile1, tile3,
                                untile_sum3, where3, zeros3)


@dataclass(frozen=True)
class PathOptions:
    path_samples: int = 32        # reference "path_samples" (nPaths)
    bounces: int = 5              # reference "bounces" (maxBounces)
    raydepth: int = 5             # specular recursion depth
    no_recursive: bool = False
    caustic_type: str = "path"    # none|path (photon|both not ported)
    transp_background: bool = False
    # wavefront folding (core_tpu PathOptions.fold_interval): 0 = off, the
    # only value ported so far
    fold_interval: int = 0


def _check_supported(scene, types_present, opts: PathOptions):
    if opts.fold_interval != 0:
        raise NotImplementedError("wavefront folding (fold_interval > 0) is "
                                  "not ported to core_tpu_torch yet")
    if opts.caustic_type not in ("path", "none"):
        raise NotImplementedError(f"caustic_type {opts.caustic_type!r} "
                                  "(photon caustics) is not ported yet")
    glossy = {int(MatType.GLOSSY), int(MatType.COATED_GLOSSY),
              int(MatType.ROUGH_GLASS)}
    chain = (scene.has_specular or bool(glossy & set(types_present))) \
        and opts.raydepth > 0 and not opts.no_recursive
    if chain:
        raise NotImplementedError("specular/glossy chains (raytrace.py) are "
                                  "not ported to core_tpu_torch yet")


def _paths_batched(scene, types_present, sp0, p0, wo0, active0, n_paths,
                   pixel_sample, sampling_offs, opts: PathOptions):
    """All indirect paths as one (n_paths*N)-lane wavefront; returns V3 [N]
    (already averaged over n_paths).  Lane layout matches vec.tile*: path i
    occupies lanes [i*N, (i+1)*N)."""
    trace_caustics = opts.caustic_type == "path"
    base = (n_paths * pixel_sample + sampling_offs) & qmc.MASK32
    offs = ((torch.arange(n_paths, dtype=torch.int64,
                          device=base.device)[:, None]
             + base[None, :]) & qmc.MASK32).reshape(-1)

    sp = common._tile_sp(sp0, n_paths)
    p = common._tile_params(p0, n_paths)
    wo = tile3(wo0, n_paths)
    active = tile1(active0, n_paths)
    pixel_sample_b = tile1(pixel_sample, n_paths)
    sampling_offs_b = tile1(sampling_offs, n_paths)

    path_col = zeros3(offs)
    throughput = None
    for depth in range(opts.bounces):
        if depth == 0:
            s1 = qmc.ri_vdc(offs)
            s2 = qmc.scr_halton(2, offs)
            flags = BSDF.DIFFUSE | BSDF.REFLECT | BSDF.TRANSMIT
        else:
            d4 = 4 * depth
            s1 = qmc.scr_halton(d4 + 3, offs)
            s2 = qmc.scr_halton(d4 + 4, offs)
            flags = BSDF.ALL
        sres = detach_sample(
            dispatch.sample_bsdf_s(types_present, p, sp, wo, s1, s2, flags))
        scol = sres.col * sres.w
        if depth == 0:
            throughput = scol
            active = active & (sres.pdf > 0.0)
            caustic_mask = torch.zeros_like(active)
        else:
            alive = active & (luminance3(scol) > 0.0)
            throughput = throughput * scol
            caustic_mask = (sres.flags & (BSDF.SPECULAR | BSDF.GLOSSY
                                          | BSDF.FILTER)) != 0
            if not trace_caustics:
                caustic_mask = torch.zeros_like(alive)
            active = alive

        rays = RaysS(o=sp.p, d=sres.wi,
                     tmin=torch.full_like(s1, MIN_RAYDIST),
                     tmax=torch.full_like(s1, -1.0))
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=sp.prim)
        # an escape after a caustic bounce sees the background
        # (core_tpu/integrators/path.py:243-246)
        if depth > 0 and scene.background is not None:
            bg = eval_background_s(scene.background, sres.wi)
            path_col = path_col + where3(active & ~hits.valid & caustic_mask,
                                         throughput * bg, 0.0)
        active = active & hits.valid

        sp = scene_mod.surface_points_s(scene, rays, hits)
        p = scene_mod.material_params_s(scene, sp)
        wo = -sres.wi
        has_diffuse = (p.flags & BSDF.DIFFUSE) != 0
        nee_active = active & has_diffuse if depth > 0 else active
        lcol = common.estimate_one_direct_s(scene, types_present, p, sp, wo,
                                            offs, pixel_sample_b,
                                            sampling_offs_b, nee_active)
        # Emission pickup at path vertices (pathtracer.cc:240,295): only
        # through caustic chains onto SPECULAR|EMIT materials (see core_tpu)
        if depth > 0:
            emit_c = dispatch.emit_ss(types_present, p)
            emit_mask = ((p.flags & BSDF.EMIT) != 0) & caustic_mask \
                & ((p.flags & BSDF.SPECULAR) != 0)
            lcol = lcol + where3(emit_mask, emit_c, 0.0)
        path_col = path_col + where3(active, lcol * throughput, 0.0)

    return untile_sum3(path_col, n_paths) * (1.0 / float(n_paths))


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: PathOptions):
    """Path-tracer integrate() for a camera wavefront -> rgba [N, 4].

    rays: types.Rays ([N, 3] o, d); pixel_sample, sampling_offs: [N] int64
    tensors holding uint32 values."""
    _check_supported(scene, types_present, opts)
    rs = rays_to_soa(rays)
    hits = scene_mod.closest_hit_s(scene, rs)
    primary_valid = hits.valid

    sp = scene_mod.surface_points_s(scene, rs, hits)
    p = scene_mod.material_params_s(scene, sp)
    wo = -rs.d

    col = where3(primary_valid, dispatch.emit_ss(types_present, p), 0.0)
    nee0 = primary_valid & ((p.flags & BSDF.DIFFUSE) != 0)
    col = col + common.estimate_all_direct_s(scene, types_present, p, sp, wo,
                                             pixel_sample, sampling_offs,
                                             nee0)
    n_paths = max(1, opts.path_samples)
    col = col + _paths_batched(scene, types_present, sp, p, wo, nee0,
                               n_paths, pixel_sample, sampling_offs, opts)

    col = where3(primary_valid, col,
                 eval_background_s(scene.background, rs.d))
    alpha = torch.where(primary_valid, 1.0,
                        0.0 if opts.transp_background else 1.0)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1)
