"""Stochastic progressive photon mapping, SoA wavefront form
(counterpart of core_tpu/integrators/sppm.py).

Reference: src/integrators/sppm.cc -- per-pixel HitPoint state (radius^2,
accumulated photon count N, accumulated flux tau; sppm.h:41-48), a pass
loop alternating photon shooting (prePass :231-509) with eye-path
gathering (traceGatherRay :511-870), and the refinement
    g = (N + alpha*M) / (N + M);  R'^2 = R^2 * g;  tau' = (tau + phi) * g
(sppm.cc:185-200).  Every pass is one eye wavefront over all pixels
(through specular and glossy chains to the first diffuse hit), a fresh
photon population in a sorted uniform grid of cells the initial radius
wide, and a 27-cell flat gather at each pixel's shrinking radius.

Eye rays, photons and the direct light trace through scene.closest_hit_s
and common's NEE (kernels 1 and 2 on a brute scene).  render_sppm's
checkpoint_path saves and resumes the hit points (checkpoint.py).  Not
ported: device-sharded photon work (one_pass_block's photon_shard), which
raises NotImplementedError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.integrators import common
from core_tpu_torch.integrators.photonmap import scene_bound, world_sphere
from core_tpu_torch.integrators.raytrace import has_glossy
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST, luminance
from core_tpu_torch.photon import map as pmap_mod
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import V3, RaysS, rays_to_soa, where3, zeros3


@dataclass(frozen=True)
class SPPMOptions:
    """core_tpu's SPPMOptions (core_tpu/integrators/sppm.py:41-56)."""
    passes: int = 8
    photons: int = 100000          # photons per pass
    bounces: int = 5               # photon depth
    search_radius: float = 1.0     # initial gather radius
    alpha: float = 0.7             # SPPM radius-shrink alpha
    raydepth: int = 4              # eye specular chain depth
    spp: int = 1                   # eye samples per pixel per pass
    # PM_IRE (sppm.cc:554-572): on the first pass each pixel's radius
    # shrinks to hold ~search_count photons at the measured density
    pm_ire: bool = False
    search_count: int = 64         # reference "searchNum"


class HitPoints(NamedTuple):
    """Per-pixel SPPM state (reference HitPoint, sppm.h:41-48)."""
    r2: torch.Tensor       # [N] current radius^2
    acc_n: torch.Tensor    # [N] accumulated photon count N
    tau: V3                # [N] accumulated (kernel-free) flux
    direct: V3             # [N] accumulated direct + emitted radiance


def _where_tree(m, a, b):
    """torch.where(m, a, b) over matching records (SPS, MatParamsS, V3)."""
    if isinstance(a, torch.Tensor):
        return torch.where(m, a, b)
    return type(a)(*(_where_tree(m, x, y) for x, y in zip(a, b)))


def _eye_pass(scene, types_present, rays_s: RaysS, pixel_sample,
              sampling_offs, opts: SPPMOptions):
    """Eye rays through specular and glossy chains to the first diffuse
    hit (traceGatherRay; one stochastic branch per lane where the reference
    forks, the same expectation).  Emission at a continuation hit counts
    only after specular branches.  Returns (pos, normal, wo, sp, params,
    valid, throughput, direct) of the settled hits."""
    glossy = has_glossy(types_present)
    like = rays_s.tmin
    one = torch.ones_like(like)
    throughput = V3(one, one, one)
    direct = zeros3(like)
    cur = rays_s
    exclude = None
    done = torch.zeros_like(like, dtype=torch.bool)
    include_lights = torch.ones_like(done)
    out_p = out_n = out_wo = zeros3(like)
    out_sp = out_pr = None
    u32 = (pixel_sample + sampling_offs) & qmc.MASK32
    tmin = torch.full_like(like, MIN_RAYDIST)
    tmax = torch.full_like(like, -1.0)

    for depth in range(opts.raydepth + 1):
        hits = scene_mod.closest_hit_s(scene, cur, exclude_prim=exclude)
        sp = scene_mod.surface_points_s(scene, cur, hits)
        p = scene_mod.material_params_s(scene, sp)
        wo = -cur.d
        if out_sp is None:
            out_sp, out_pr = sp, p
        live = ~done & hits.valid
        direct = direct + where3(~done & ~hits.valid & include_lights,
                                 throughput * eval_background_s(
                                     scene.background, cur.d), 0.0)
        done = done | ~hits.valid
        direct = direct + where3(live & include_lights,
                                 throughput * dispatch.emit_ss(types_present,
                                                               p), 0.0)
        lcol = common.estimate_all_direct_s(scene, types_present, p, sp, wo,
                                            pixel_sample, sampling_offs,
                                            live)
        direct = direct + where3(live, throughput * lcol, 0.0)

        is_diffuse = (p.flags & BSDF.DIFFUSE) != 0
        settle = live & is_diffuse
        out_p = where3(settle, sp.p, out_p)
        out_n = where3(settle, sp.n, out_n)
        out_wo = where3(settle, wo, out_wo)
        out_sp = _where_tree(settle, sp, out_sp)
        out_pr = _where_tree(settle, p, out_pr)
        done = done | settle
        if depth == opts.raydepth:
            break

        # continue through one specular or glossy branch, its throughput
        # divided by the branch's probability
        spec = dispatch.get_specular_s(types_present, p, sp, wo)
        lum_refl = luminance(spec.refl_col) * spec.refl_valid
        lum_refr = luminance(spec.refr_col) * spec.refr_valid
        if glossy:
            gres = detach_sample(dispatch.sample_bsdf_s(
                types_present, p, sp, wo,
                qmc.scr_halton(3 * depth + 13, u32),
                qmc.scr_halton(3 * depth + 14, u32),
                BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT))
            g_col3 = gres.col * gres.w
            g_ok = (gres.pdf > 1e-6) & ((gres.flags & BSDF.GLOSSY) != 0)
            lum_g = torch.where(g_ok, luminance(g_col3), 0.0)
        else:
            lum_g = torch.zeros_like(like)
        total = lum_refl + lum_refr + lum_g
        cont = live & ~is_diffuse & (total > 1e-7)
        r = qmc.scr_halton(2 * depth + 5, u32)
        inv_total = 1.0 / total.clamp_min(1e-20)
        p_refl = lum_refl * inv_total
        p_refr = lum_refr * inv_total
        take_refl = (r < p_refl) & spec.refl_valid
        take_refr = ~take_refl & (r < p_refl + p_refr) & spec.refr_valid
        take_gloss = cont & ~take_refl & ~take_refr & (lum_g > 0.0)
        bcol = where3(take_refl, spec.refl_col, spec.refr_col)
        bdir = where3(take_refl, spec.refl_dir, spec.refr_dir)
        bp = torch.where(take_refl, p_refl, torch.where(
            take_refr, p_refr, (lum_g * inv_total).clamp_min(0.0)))
        if glossy:
            bdir = where3(take_gloss, gres.wi, bdir)
            bcol = where3(take_gloss, g_col3, bcol)
        cont = cont & (take_refl | take_refr | take_gloss)
        tb = throughput * bcol
        den = bp.clamp_min(1e-6)
        throughput = where3(cont, V3(*(c / den for c in tb)), throughput)
        include_lights = torch.where(cont, take_refl | take_refr,
                                     include_lights)
        done = done | (live & ~is_diffuse & ~cont)
        cur = RaysS(o=sp.p, d=bdir, tmin=tmin, tmax=tmax)
        exclude = sp.prim

    valid = (out_n.x != 0.0) | (out_n.y != 0.0) | (out_n.z != 0.0)
    return out_p, out_n, out_wo, out_sp, out_pr, valid, throughput, direct


def _gather_flat(pmap, q: V3, qn: V3, radius, r_max: float):
    """Radius gather at per-query radii [N] with no kernel weight (the flat
    SPPM estimator), in cells r_max >= radius wide so 27 cells suffice.
    Cells denser than MAX_PER_CELL are subsampled with k/m compensation
    (photon/map.py gather_photons); count is the compensated float
    estimate, so the radius refinement sees the true local density.
    Returns (flux V3, count [N] float)."""
    del r_max
    return pmap_mod._gather(pmap, q, qn, radius * radius,
                            pmap_mod.MAX_PER_CELL)


def _pixel_grid(rows: int, w: int, y0: int, device):
    """(y, x)-ordered pixel coordinates of the row block [y0, y0 + rows)."""
    ys, xs = torch.meshgrid(
        torch.arange(rows, dtype=torch.int64, device=device),
        torch.arange(w, dtype=torch.int64, device=device), indexing="ij")
    return xs.reshape(-1), (ys + y0).reshape(-1)


def one_pass_block(scene, types_present, state: HitPoints, pass_idx: int,
                   y0: int, rows: int, w: int, opts: SPPMOptions, cam,
                   center, world_r: float, bmin, bmax, r0: float,
                   photon_shard=None, photon_axis=None) -> HitPoints:
    """One SPPM pass over the pixel rows [y0, y0 + rows): the eye pass, a
    fresh photon population, the flat gather and the radius / flux
    refinement.  QMC streams key off global pixel coordinates."""
    if photon_shard is not None or photon_axis is not None:
        raise NotImplementedError("device-sharded SPPM photon work "
                                  "(photon_shard) is not ported to "
                                  "core_tpu_torch yet")
    x, y = _pixel_grid(rows, w, y0, scene.device)
    sampling_offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    pixel_sample = torch.full_like(x, pass_idx & qmc.MASK32)
    dx = qmc.ri_vdc(pixel_sample, sampling_offs)
    dy = qmc.ri_s(pixel_sample, sampling_offs)
    rays, _ = shoot_ray(cam, x.to(torch.float32) + dx,
                        y.to(torch.float32) + dy, None, None)
    rs = rays_to_soa(rays)
    pos, nrm, wo, sp, pr, valid, thr, direct = _eye_pass(
        scene, types_present, rs, pixel_sample, sampling_offs, opts)

    # a fresh photon population every pass (sppm.cc prePass): the pass
    # index shifts the photon QMC stream
    seed = (7 + pass_idx * 9176) & qmc.MASK32
    photons = pmap_mod.shoot_photons(
        scene, types_present, opts.photons, opts.bounces, seed=seed,
        mode="sppm", scene_center=center, scene_radius=world_r)
    grid = pmap_mod.build_photon_grid(*photons, r0, bmin, bmax)

    if opts.pm_ire and pass_idx == 0:
        # PM_IRE: the first pass sets each pixel's radius from the photon
        # density around its hit
        _, c0 = _gather_flat(grid, pos, nrm, torch.full_like(state.r2, r0),
                             r0)
        r2_ire = (r0 * r0 * opts.search_count / c0.clamp_min(1.0)).clamp(
            r0 * r0 * 1e-4, r0 * r0)
        state = state._replace(r2=torch.where(valid, r2_ire, state.r2))

    # raw flux within each pixel's radius (the flat pi r^2 estimator,
    # sppm.cc:780-800), times the BSDF at the hit; eval() omits the
    # Lambert 1/pi, so it is divided in here
    flux, count = _gather_flat(grid, pos, nrm, torch.sqrt(state.r2), r0)
    f = dispatch.eval_bsdf_s(types_present, pr, sp, wo, nrm, BSDF.ALL)
    phi = V3(*(c / math.pi for c in flux * f * thr))
    m = count * valid
    tot = state.acc_n + m
    g = torch.where(tot > 0, (state.acc_n + opts.alpha * m)
                    / tot.clamp_min(1e-9), 1.0)
    return HitPoints(r2=state.r2 * g, acc_n=state.acc_n + opts.alpha * m,
                     tau=(state.tau + phi) * g,
                     direct=state.direct + direct)


def finalize_sppm(state: HitPoints, passes: int, photons: int):
    """HitPoints -> rgba rows [N, 4].  Photon powers are already divided by
    the per-pass photon count at emission, so each pass's flux / (pi r^2)
    is a radiance estimate and the accumulator divides by the pass count
    only (the reference divides by r^2 pi totalnPhotons, sppm.cc:200)."""
    del photons
    den = math.pi * state.r2 * passes
    img = [d / passes + t / den for d, t in zip(state.direct, state.tau)]
    return torch.stack(img + [torch.ones_like(state.r2)], dim=-1)


def render_sppm(scene, opts: SPPMOptions, verbose=False,
                checkpoint_path=None):
    """The progressive pass loop (replaces the tiled render, sppm.cc:
    62-109).  Returns the image [H, W, 4].

    checkpoint_path: the hit points and the pass counter are saved after
    every pass, and an existing checkpoint (written by this package or by
    core_tpu) is resumed from; the photon streams are a function of the
    pass index, so the resumed render equals an uninterrupted one
    (core_tpu sppm.py:205-217)."""
    from core_tpu_torch import checkpoint as ck
    from core_tpu_torch.render import scene_material_types
    types_present = scene_material_types(scene)
    cam = scene.camera
    h, w = cam.resy, cam.resx
    bmin, bmax = scene_bound(scene)
    center, world_r = world_sphere(scene, bmin, bmax)
    r0 = float(opts.search_radius)
    zero = torch.zeros(h * w, dtype=torch.float32, device=scene.device)
    state = HitPoints(r2=torch.full_like(zero, r0 * r0), acc_n=zero,
                      tau=zeros3(zero), direct=zeros3(zero))
    start_pass = 0
    if checkpoint_path:
        saved = ck.load_sppm_checkpoint(checkpoint_path, device=scene.device)
        if saved is not None:
            state, start_pass = saved
            if verbose:
                print(f"SPPM resumed at pass {start_pass}")
    for k in range(start_pass, opts.passes):
        state = one_pass_block(scene, types_present, state, k, 0, h, w, opts,
                               cam, center, world_r, bmin, bmax, r0)
        if checkpoint_path:
            ck.save_sppm_checkpoint(checkpoint_path, state, k + 1)
        if verbose:
            print(f"SPPM pass {k + 1}/{opts.passes}")
    return finalize_sppm(state, opts.passes, opts.photons).reshape(h, w, 4)
