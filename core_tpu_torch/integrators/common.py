"""Direct lighting with MIS, wavefront form
(counterpart of core_tpu/integrators/common.py, its SoA area-light path).

Reference mcIntegrator_t (src/yafraycore/mcintegrator.cc:45-196): per-light
Halton-sampled area sampling with shadow rays and two-sided MIS (power
heuristic).  The per-light sample loop is batched into one wide wavefront
(n_samples x N lanes), so each light costs one illum_sample, one BSDF eval
and ONE shadow-kernel launch for all its samples: the light-side and
BSDF-side shadow rays of a lane share its origin and go to the NEE bundle
kernel together.

Scope: the area, sun and background (IBL) lights with opaque shadow rays
(the scenes the port renders have no transparency); dirac lights raise
NotImplementedError.
"""
from __future__ import annotations

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.lights import base as light_base
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST, SHADOW_BIAS
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (SPS, V3, RaysS, dot3, tile1, tile3,
                                untile_sum3, where3, zeros3)

LOFFS_DELTA = 4567  # reference mcintegrator.cc:42


def _shadow_tcap(valid, dist):
    """Shadow-ray t cap from a light-sample distance.

    dist <= 0 is the 'unbounded shadow ray' sentinel (tcap -1.0 = open).
    Invalid lanes and valid-but-sub-bias distances get a dead cap
    (0 < tcap <= tmin -> empty t interval), so they never report occlusion.
    """
    dead = 0.5 * SHADOW_BIAS
    bounded = torch.where(dist > SHADOW_BIAS, dist - SHADOW_BIAS, dead)
    return torch.where(valid, torch.where(dist > 0, bounded, -1.0), dead)


def _tile_sp(sps: SPS, n: int) -> SPS:
    return SPS(p=tile3(sps.p, n), n=tile3(sps.n, n), ng=tile3(sps.ng, n),
               nu=tile3(sps.nu, n), nv=tile3(sps.nv, n),
               u=tile1(sps.u, n), v=tile1(sps.v, n),
               mat=tile1(sps.mat, n), light=tile1(sps.light, n),
               prim=tile1(sps.prim, n), obj=tile1(sps.obj, n))


def _tile_params(p, n: int):
    return type(p)(*[tile3(a, n) if isinstance(a, V3) else tile1(a, n)
                     for a in p])


def do_light_estimation_s(scene, types_present, p, sps, wo: V3, light,
                          loffs, pixel_sample, sampling_offs, active):
    """One area light's direct contribution (mcintegrator.cc:73-196), SoA.

    pixel_sample, sampling_offs: [N] int64 tensors holding uint32 values.
    active: [N] bool — lanes whose shading is meaningful.  Returns V3 [N].
    """
    if light_base.dirac(light):
        raise NotImplementedError("dirac lights are not ported to "
                                  "core_tpu_torch yet")
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
    spb = _tile_sp(sps, n)
    pb = _tile_params(p, n)
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
        # ONE shadow launch for both MIS sides; lanes whose MIS side is
        # invalid (or inactive) get dead caps
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
        b_ok = activeb & lh.valid & (~b_shadowed) & (sres.pdf > 1e-6) \
            & (lh.ipdf > 1e-6)
        total = where3(l_ok, lcontrib, 0.0) + where3(b_ok, bcontrib, 0.0)
    else:
        contrib = surf * ls.col * (cos_term / ls.pdf.clamp_min(1e-12))
        l_tcap = _shadow_tcap(activeb & ls.valid, ls.dist)
        shadowed = scene_mod.any_hit_nee_s(
            scene, sps.p, tmin_nee, slices3(ls.wi), slices1(l_tcap),
            exclude_prim=sps.prim)
        ok = activeb & ls.valid & (~shadowed) & (ls.pdf > 1e-6)
        total = where3(ok, contrib, 0.0)
    return untile_sum3(total, n) * inv_n


def estimate_all_direct_s(scene, types_present, p, sps, wo, pixel_sample,
                          sampling_offs, active) -> V3:
    """Sum over all scene lights (mcintegrator.cc estimateAllDirectLight)."""
    col = zeros3(active)
    for loffs, light in enumerate(scene.lights):
        col = col + do_light_estimation_s(scene, types_present, p, sps, wo,
                                          light, loffs, pixel_sample,
                                          sampling_offs, active)
    return col


def estimate_one_direct_s(scene, types_present, p, sps, wo, n_index,
                          pixel_sample, sampling_offs, active) -> V3:
    """Pick one light by Halton CDF and weight by light count
    (mcintegrator.cc estimateOneDirectLight) — used at path bounces."""
    num = len(scene.lights)
    if num == 0:
        return zeros3(active)
    if num == 1:
        return do_light_estimation_s(scene, types_present, p, sps, wo,
                                     scene.lights[0], 0, pixel_sample,
                                     sampling_offs, active)
    pick = (qmc.ri_vdc(n_index) * num).to(torch.int32).clamp_max(num - 1)
    col = zeros3(active)
    for lnum, light in enumerate(scene.lights):
        col = col + do_light_estimation_s(scene, types_present, p, sps, wo,
                                          light, lnum, pixel_sample,
                                          sampling_offs,
                                          active & (pick == lnum))
    return col * float(num)
