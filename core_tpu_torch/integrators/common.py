"""Direct lighting with MIS, wavefront form
(counterpart of core_tpu/integrators/common.py, its SoA area-light path).

Reference mcIntegrator_t (src/yafraycore/mcintegrator.cc:45-196): per-light
Halton-sampled area sampling with shadow rays and two-sided MIS (power
heuristic).  The per-light sample loop is batched into one wide wavefront
(n_samples x N lanes), so each light costs one illum_sample, one BSDF eval
and ONE shadow-kernel launch for all its samples: the light-side and
BSDF-side shadow rays of a lane share its origin and go to the NEE bundle
kernel together.

Dirac lights (point, spot, directional) take one sample per shading point
and one occlusion ray each, through scene.any_hit_s (kernel 3 on a brute
scene, 5 on a flat one, 8 on a grouped one).

Transparent shadows (transp_shad, on a scene with transparency) replace
those occlusion queries with transparent_shadow's walks of closest hits
(kernel 1, 4 or 7); the light-side and BSDF-side walks of an area light's
samples share one wavefront.

Volumes: every light sample is attenuated by the scene volumes'
transmittance toward the light (the reference's mcintegrator.cc:96,131,
181), a march of NEE_VOL_STEPS per volume; an area light's two MIS sides
march as one wavefront.  A scene without volumes skips it, so its renders
do not change.
"""
from __future__ import annotations

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.integrators import volume as vol_mod
from core_tpu_torch.lights import base as light_base
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST, SHADOW_BIAS
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (V3, RaysS, dot3, map_lanes, tile1, tile3,
                                untile_sum3, where3, zeros3)

_DEAD_TCAP = 0.5 * SHADOW_BIAS   # 0 < tcap <= tmin: an empty t interval

LOFFS_DELTA = 4567  # reference mcintegrator.cc:42


def _shadow_tcap(valid, dist):
    """Shadow-ray t cap from a light-sample distance.

    dist <= 0 is the 'unbounded shadow ray' sentinel (tcap -1.0 = open).
    Invalid lanes and valid-but-sub-bias distances get a dead cap
    (0 < tcap <= tmin -> empty t interval), so they never report occlusion.
    """
    bounded = torch.where(dist > SHADOW_BIAS, dist - SHADOW_BIAS, _DEAD_TCAP)
    return torch.where(valid, torch.where(dist > 0, bounded, -1.0),
                       _DEAD_TCAP)


def _apply_vol_transmittance(scene, o: V3, wi: V3, dist, contrib: V3) -> V3:
    """contrib attenuated through the scene volumes along wi up to dist
    (<= 0: unbounded), core_tpu common.py:51-59; unchanged without
    volumes."""
    if not scene.volumes:
        return contrib
    return contrib * vol_mod.transmittance_nee_s(scene, o, wi, dist)


def _walk_tcap(valid, dist):
    """A transparent-shadow walk's t cap, as core_tpu gives it
    (common.py:125-131): dist - SHADOW_BIAS, or -1 (open) where dist <= 0,
    so a valid sample nearer than the bias walks an open ray.  Lanes that
    are not valid get a dead cap: their attenuation is masked out after."""
    return torch.where(valid, torch.where(dist > 0, dist - SHADOW_BIAS, -1.0),
                       _DEAD_TCAP)


def _cat3(a: V3, b: V3) -> V3:
    return V3(*(torch.cat([p, q]) for p, q in zip(a, b)))


def transparent_shadow(scene, types_present, o: V3, d: V3, tcap,
                       exclude_prim, depth: int) -> V3:
    """Transparent-shadow attenuation (core_tpu common.py:62-92; reference
    scene_t::isShadowed TS variant, scene.cc:904): walk max(1, depth)
    closest hits along each shadow segment (tcap <= 0 = open); a hit on a
    FILTER material multiplies its transparency colour in, any other hit
    blocks (attenuation 0).  After a hit the walk goes on from just past
    it, with that hit's triangle excluded.  It always runs its full depth:
    whether every lane is done is never read back to the host.  Returns
    the attenuation, V3 [N]."""
    ones = torch.ones_like(tcap)
    att = V3(ones, ones, ones)
    tmin = torch.full_like(tcap, SHADOW_BIAS)
    tmax = torch.where(tcap > 0, tcap, -1.0)
    excl = exclude_prim
    wo = -d
    for _ in range(max(1, depth)):
        rays = RaysS(o=o, d=d, tmin=tmin, tmax=tmax)
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=excl)
        hit_in = hits.valid & ((tcap <= 0) | (hits.t < tcap))
        sp = scene_mod.surface_points_s(scene, rays, hits)
        p = scene_mod.material_params_s(scene, sp)       # no pick seed
        tr = dispatch.transparency_ss(types_present, p, sp, wo)
        tr = where3((p.flags & BSDF.FILTER) != 0, tr, 0.0)
        att = where3(hit_in, att * tr, att)
        tmin = torch.where(hit_in, hits.t + SHADOW_BIAS, tmin)
        excl = torch.where(hit_in, hits.prim, excl)
    return att


def do_light_estimation_s(scene, types_present, p, sps, wo: V3, light,
                          loffs, pixel_sample, sampling_offs, active,
                          transp_shad=False, shadow_depth=5):
    """One light's direct contribution (mcintegrator.cc:73-196), SoA.

    pixel_sample, sampling_offs: [N] int64 tensors holding uint32 values.
    active: [N] bool — lanes whose shading is meaningful.  transp_shad:
    shadow rays walk through FILTER materials (transparent_shadow, up to
    shadow_depth hits) on a scene with transparency.  Returns V3 [N].
    """
    walk = transp_shad and scene.has_transparency
    if light_base.dirac(light):
        ls = light_base.illuminate_s(light, sps)
        surf = dispatch.eval_bsdf_s(types_present, p, sps, wo, ls.wi,
                                    BSDF.ALL)
        contrib = surf * ls.col * dot3(sps.n, ls.wi).abs()
        contrib = _apply_vol_transmittance(scene, sps.p, ls.wi, ls.dist,
                                           contrib)
        ok = active & ls.valid
        if walk:
            att = transparent_shadow(
                scene, types_present, sps.p, ls.wi,
                _walk_tcap(ok, ls.dist), sps.prim, shadow_depth)
            return where3(ok, contrib * att, 0.0)
        # dead caps on inactive lanes; an infinite directional light's
        # dist -1 gives an open ray
        ray = RaysS(o=sps.p, d=ls.wi,
                    tmin=torch.full_like(ls.dist, SHADOW_BIAS),
                    tmax=_shadow_tcap(ok, ls.dist))
        shadowed = scene_mod.any_hit_s(scene, ray, exclude_prim=sps.prim)
        return where3(ok & ~shadowed, contrib, 0.0)
    l_offs = (loffs * LOFFS_DELTA) & qmc.MASK32

    # batch the light's n samples into one (n*N)-lane wavefront
    n = max(1, light_base.n_samples(light))
    inv_n = 1.0 / n
    offs = (n * pixel_sample + sampling_offs + l_offs) & qmc.MASK32
    N = offs.shape[0]
    idx = ((torch.arange(n, dtype=torch.int64, device=offs.device)[:, None]
            + offs[None, :]) & qmc.MASK32).reshape(-1)
    s1 = qmc.ri_vdc(idx)
    s2 = qmc.radical_inverse(3, idx)
    spb, pb = map_lanes(lambda t: tile1(t, n), (sps, p))
    wob = tile3(wo, n)
    activeb = tile1(active, n)

    def slices3(v):
        return [V3(v.x[k * N:(k + 1) * N], v.y[k * N:(k + 1) * N],
                   v.z[k * N:(k + 1) * N]) for k in range(n)]

    def slices1(a):
        return [a[k * N:(k + 1) * N] for k in range(n)]

    tmin_nee = torch.full((N,), SHADOW_BIAS, dtype=torch.float32,
                          device=offs.device)

    # --- light-side sampling ---
    ls = light_base.illum_sample_s(light, spb, s1, s2)
    surf = dispatch.eval_bsdf_s(types_present, pb, spb, wob, ls.wi, BSDF.ALL)
    cos_term = dot3(spb.n, ls.wi).abs()

    if light_base.can_intersect(light):
        mpdf = dispatch.pdf_bsdf_s(types_present, pb, spb, wob, ls.wi,
                                   BSDF.INTERSECT)
        l2 = ls.pdf * ls.pdf
        m2 = mpdf * mpdf
        w = torch.where(mpdf > 1e-6, l2 / (l2 + m2).clamp_min(1e-20), 1.0)

        # --- BSDF-sampling side of MIS (mcintegrator.cc:152-190) ---
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, pb, spb, wob, s1, s2, BSDF.INTERSECT))
        lh = light_base.intersect_light_s(
            light, RaysS(o=spb.p, d=sres.wi,
                         tmin=torch.full_like(s1, MIN_RAYDIST),
                         tmax=torch.full_like(s1, -1.0)))
        lcontrib = surf * ls.col * (cos_term * w / ls.pdf.clamp_min(1e-12))
        if scene.volumes:
            # both MIS sides' volume attenuation in one march over their
            # 2nN lanes (core_tpu marches them one after the other)
            tr = vol_mod.transmittance_nee_s(
                scene, _cat3(spb.p, spb.p), _cat3(ls.wi, sres.wi),
                torch.cat([ls.dist, lh.t]))
            lcontrib = lcontrib * V3(*(c[:n * N] for c in tr))
            b_tr = V3(*(c[n * N:] for c in tr))
        if walk:
            # both MIS sides walk as one wavefront (core_tpu walks them
            # one after the other; every lane is independent)
            att = transparent_shadow(
                scene, types_present, _cat3(spb.p, spb.p),
                _cat3(ls.wi, sres.wi),
                torch.cat([_walk_tcap(activeb & ls.valid, ls.dist),
                           _walk_tcap(activeb & lh.valid, lh.t)]),
                torch.cat([spb.prim, spb.prim]), shadow_depth)
            lcontrib = lcontrib * V3(*(c[:n * N] for c in att))
            b_att = V3(*(c[n * N:] for c in att))
            l_shadowed = b_shadowed = torch.zeros_like(ls.valid)
        else:
            # ONE shadow launch for both MIS sides; lanes whose MIS side
            # is invalid (or inactive) get dead caps
            l_tcap = _shadow_tcap(activeb & ls.valid, ls.dist)
            b_tcap = _shadow_tcap(activeb & lh.valid, lh.t)
            shad = scene_mod.any_hit_nee_s(
                scene, sps.p, tmin_nee, slices3(ls.wi) + slices3(sres.wi),
                slices1(l_tcap) + slices1(b_tcap), exclude_prim=sps.prim)
            l_shadowed = shad[:n * N]
            b_shadowed = shad[n * N:]
        l_ok = activeb & ls.valid & (~l_shadowed) & (ls.pdf > 1e-6)

        lpdf = 1.0 / lh.ipdf.clamp_min(1e-12)
        l2b = lpdf * lpdf
        m2b = sres.pdf * sres.pdf
        wb = m2b / (l2b + m2b).clamp_min(1e-20)
        bcontrib = sres.col * lh.col * (wb * sres.w)
        if scene.volumes:
            bcontrib = bcontrib * b_tr
        if walk:
            bcontrib = bcontrib * b_att
        b_ok = activeb & lh.valid & (~b_shadowed) & (sres.pdf > 1e-6) \
            & (lh.ipdf > 1e-6)
        total = where3(l_ok, lcontrib, 0.0) + where3(b_ok, bcontrib, 0.0)
    else:
        contrib = surf * ls.col * (cos_term / ls.pdf.clamp_min(1e-12))
        contrib = _apply_vol_transmittance(scene, spb.p, ls.wi, ls.dist,
                                           contrib)
        if walk:
            contrib = contrib * transparent_shadow(
                scene, types_present, spb.p, ls.wi,
                _walk_tcap(activeb & ls.valid, ls.dist), spb.prim,
                shadow_depth)
            shadowed = torch.zeros_like(ls.valid)
        else:
            l_tcap = _shadow_tcap(activeb & ls.valid, ls.dist)
            shadowed = scene_mod.any_hit_nee_s(
                scene, sps.p, tmin_nee, slices3(ls.wi), slices1(l_tcap),
                exclude_prim=sps.prim)
        ok = activeb & ls.valid & (~shadowed) & (ls.pdf > 1e-6)
        total = where3(ok, contrib, 0.0)
    return untile_sum3(total, n) * inv_n


def estimate_all_direct_s(scene, types_present, p, sps, wo, pixel_sample,
                          sampling_offs, active, transp_shad=False,
                          shadow_depth=5) -> V3:
    """Sum over all scene lights (mcintegrator.cc estimateAllDirectLight)."""
    col = zeros3(active)
    for loffs, light in enumerate(scene.lights):
        col = col + do_light_estimation_s(scene, types_present, p, sps, wo,
                                          light, loffs, pixel_sample,
                                          sampling_offs, active, transp_shad,
                                          shadow_depth)
    return col


def estimate_one_direct_s(scene, types_present, p, sps, wo, n_index,
                          pixel_sample, sampling_offs, active,
                          transp_shad=False, shadow_depth=5) -> V3:
    """Pick one light by Halton CDF and weight by light count
    (mcintegrator.cc estimateOneDirectLight) — used at path bounces."""
    num = len(scene.lights)
    if num == 0:
        return zeros3(active)
    if num == 1:
        return do_light_estimation_s(scene, types_present, p, sps, wo,
                                     scene.lights[0], 0, pixel_sample,
                                     sampling_offs, active, transp_shad,
                                     shadow_depth)
    pick = (qmc.ri_vdc(n_index) * num).to(torch.int32).clamp_max(num - 1)
    col = zeros3(active)
    for lnum, light in enumerate(scene.lights):
        col = col + do_light_estimation_s(scene, types_present, p, sps, wo,
                                          light, lnum, pixel_sample,
                                          sampling_offs,
                                          active & (pick == lnum),
                                          transp_shad, shadow_depth)
    return col * float(num)
