"""Subsurface scattering: volumetric photon tracing + dipole diffusion
(counterpart of core_tpu/integrators/sss.py).

TheBounty's addition to YafaRay (src/yafraycore/mcintegrator.cc):
createSSSMapsByPhotonTracing (:936) traces photons from the lights,
refracts them into `translucent` objects and stores the interior scatter
events per object; estimateSSSMaps (:1457) sums Jensen's dipole diffusion
profile RdQdRm (:1257) over the stored photons at each camera hit on a
translucent surface.

- build_sss_map is a fixed-depth wavefront walk, as core_tpu's: surface
  bounces through scene.closest_hit_s (kernel 1, 4 or 7), and at a
  translucent hit an interior random walk of interior_steps steps whose
  exit tests are closest hits too; a deposit at every interior scatter.
- estimate_sss is an exact sum of the dipole over every stored photon of
  the hit's object (no k-NN).  core_tpu evaluates every lane against every
  deposit, in chunks of 256 deposits, with the distances from one matmul
  (r^2 = |x|^2 + |xi|^2 - 2 x.xi).  Here only the translucent-hit lanes
  and the valid deposits are evaluated, in blocks of at most SSS_PAIRS
  pairs, and r^2 is formed from the differences x - xi directly: no
  matmul (so no TF32 question on the card) and no cancellation, where
  core_tpu's expansion loses about an ulp of |x|^2.  The masked terms are
  exact zeros in core_tpu, so the compaction changes only the order of
  the sum; the direct differences change r^2 by core_tpu's rounding.

Deviations of core_tpu from the reference, kept: a photon that leaves the
medium ends instead of continuing outside; the single-scattering term
(estimateSSSSingleSImportantSampling, :1622) is approximated by the dipole.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.integrators.photonmap import scene_center_radius
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, MatType, detach_sample
from core_tpu_torch.mathutils import (MIN_RAYDIST, fresnel_dielectric,
                                      refract_dir)
from core_tpu_torch.photon.emit import emit_photon
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (V3, RaysS, create_cs3, dot3, normalize3,
                                where3)

SSS_PAIRS = 1 << 23      # lane x deposit pairs per block of estimate_sss


class SSSMap(NamedTuple):
    """Interior photon deposits: pos [P, 3], power [P, 3], obj [P] i32,
    valid [P] bool (core_tpu's SSSMap)."""
    pos: torch.Tensor
    power: torch.Tensor
    obj: torch.Tensor
    valid: torch.Tensor


def _sample_hg(d: V3, g, s1, s2) -> V3:
    """A Henyey-Greenstein direction around d (the reference's
    samplePhaseFunc; core_tpu sss.py:51-64)."""
    g = g.clamp(-0.999, 0.999)
    iso = g.abs() < 1e-3
    cos_t_iso = 1.0 - 2.0 * s1
    sq = (1.0 - g * g) / (1.0 - g + 2.0 * g * s1).clamp_min(1e-6)
    cos_t_hg = (1.0 + g * g - sq * sq) / (2.0 * g).clamp_min(1e-6)
    cos_t = torch.where(iso, cos_t_iso, cos_t_hg).clamp(-1.0, 1.0)
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    phi = 2.0 * math.pi * s2
    u, v = create_cs3(d)
    return normalize3(u * (sin_t * torch.cos(phi))
                      + v * (sin_t * torch.sin(phi)) + d * cos_t)


def build_sss_map(scene, types_present, n_photons: int = 8192,
                  surface_bounces: int = 2, interior_steps: int = 4,
                  seed: int = 0) -> SSSMap:
    """Trace photons into the translucent objects and return the interior
    deposits, bounce-major then step-major as core_tpu concatenates them
    (createSSSMapsByPhotonTracing, mcintegrator.cc:936): a uniform light
    pick (1/k compensated), Fresnel-weighted refraction into TRANSLUCENT
    surfaces, exponential free flights at sigma_t, a deposit at each
    interior scatter with albedo-attenuated power, HG redirection."""
    n_lights = len(scene.lights)
    if n_lights == 0:
        raise ValueError("build_sss_map needs a light")
    dev = scene.device
    base = (torch.arange(n_photons, dtype=torch.int64, device=dev)
            + ((int(seed) * 77771) & qmc.MASK32)) & qmc.MASK32
    s1 = qmc.ri_vdc(base)
    s2, s3, s4 = (qmc.scr_halton(dim, base) for dim in (2, 3, 4))
    pick = (qmc.scr_halton(5, base) * n_lights).to(torch.int32) \
        .clamp_max(n_lights - 1)
    zero = torch.zeros(n_photons, dtype=torch.float32, device=dev)
    o = d = col = V3(zero, zero, zero)
    ipdf = zero
    center, radius = scene_center_radius(scene)
    for li, light in enumerate(scene.lights):
        lo, ld, lc, lip = emit_photon(light, s1, s2, s3, s4, center, radius)
        m = pick == li
        o, d, col = where3(m, lo, o), where3(m, ld, d), where3(m, lc, col)
        ipdf = torch.where(m, lip, ipdf)
    power = col * (ipdf * n_lights / n_photons)
    alive = torch.ones_like(zero, dtype=torch.bool)

    def rays_from(org: V3, dirn: V3) -> RaysS:
        return RaysS(o=org, d=dirn, tmin=torch.full_like(zero, MIN_RAYDIST),
                     tmax=torch.full_like(zero, -1.0))

    dep_pos, dep_pow, dep_obj, dep_ok = [], [], [], []
    rays = rays_from(o, d)
    exclude = None
    dim = 6
    for _ in range(surface_bounces):
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=exclude)
        alive = alive & hits.valid
        sp = scene_mod.surface_points_s(scene, rays, hits)
        p = scene_mod.material_params_s(scene, sp)
        wo = -rays.d
        is_sss = alive & (p.mtype == int(MatType.TRANSLUCENT))

        # the interior walk of the translucent lanes: refract in, weighted
        # by the Fresnel transmission (mcintegrator.cc:1050)
        kr = fresnel_dielectric(dot3(sp.n, wo).abs(), p.ior)
        rvalid, rdir = refract_dir(sp.n, wo, p.ior)
        in_dir = where3(rvalid, rdir, -wo)
        in_pos = sp.p
        in_pow = power * (1.0 - kr)
        in_alive = is_sss
        ext = p.absorption + p.sigma_s
        sigma_t = ((ext.x + ext.y + ext.z) / 3.0).clamp_min(1e-4)
        albedo = V3(*(s / e.clamp_min(1e-6) for s, e in zip(p.sigma_s,
                                                            ext)))
        for _ in range(interior_steps):
            u, u2, u3 = (qmc.scr_halton(dim + k, base) for k in range(3))
            dim += 3
            dist = -torch.log((1.0 - u).clamp_min(1e-7)) / sigma_t
            # the exit test: the photon leaves before the scatter point
            ihits = scene_mod.closest_hit_s(scene, rays_from(in_pos, in_dir))
            exits = ihits.valid & (ihits.t < dist)
            in_alive = in_alive & ~exits & ihits.valid
            in_pos = in_pos + in_dir * dist
            in_pow = in_pow * albedo
            dep_pos.append(in_pos)
            dep_pow.append(in_pow)
            dep_obj.append(sp.obj)
            dep_ok.append(in_alive)
            in_dir = _sample_hg(in_dir, p.sss_g, u2, u3)

        # the other lanes scatter and go on
        bs1 = qmc.scr_halton(dim, base)
        bs2 = qmc.scr_halton(dim + 1, base)
        dim += 2
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, p, sp, wo, bs1, bs2, BSDF.ALL))
        power = power * sres.col * sres.w
        alive = alive & ~is_sss & (sres.pdf > 0)
        rays = rays_from(sp.p, sres.wi)
        exclude = sp.prim

    def aos(vs):
        return torch.cat([torch.stack(list(v), dim=-1) for v in vs])

    return SSSMap(pos=aos(dep_pos), power=aos(dep_pow),
                  obj=torch.cat(dep_obj), valid=torch.cat(dep_ok))


def dipole_rd_1ch(r2, sigma_a, sigma_s, g, ior):
    """Jensen et al. 2001's dipole diffusion profile Rd(r) of one colour
    channel (the reference's RdQdRm, mcintegrator.cc:1257); every argument
    broadcasts against r2."""
    sigma_sp = sigma_s * (1.0 - g)
    sigma_tp = (sigma_a + sigma_sp).clamp_min(1e-6)
    alpha_p = sigma_sp / sigma_tp
    sigma_tr = torch.sqrt(3.0 * sigma_a * sigma_tp)
    fdr = -1.440 / (ior * ior) + 0.710 / ior + 0.668 + 0.0636 * ior
    a_coef = (1.0 + fdr) / (1.0 - fdr).clamp_min(1e-6)
    zr = 1.0 / sigma_tp
    zv = zr * (1.0 + 4.0 / 3.0 * a_coef)
    dr = torch.sqrt(r2 + zr * zr)
    dv = torch.sqrt(r2 + zv * zv)
    c1 = zr * (sigma_tr * dr + 1.0) * torch.exp(-sigma_tr * dr) \
        / (sigma_tp * dr ** 3)
    c2 = zv * (sigma_tr * dv + 1.0) * torch.exp(-sigma_tr * dv) \
        / (sigma_tp * dv ** 3)
    return (alpha_p / (4.0 * math.pi) * (c1 + c2)).clamp_min(0.0)


def estimate_sss(sss_map: SSSMap, sps, p, wo: V3, active) -> V3:
    """Dipole-diffusion radiance at the translucent hits -> V3 [N], 0
    elsewhere (estimateSSSMaps, mcintegrator.cc:1457): photons couple to
    the hits of their own object only, and the sum leaves through the
    surface's Fresnel transmission (:1530).  The translucent lanes and the
    valid deposits are gathered first and evaluated in blocks of at most
    SSS_PAIRS pairs; each lane's sum runs over the deposits in map order,
    block by block."""
    is_sss = active & (p.mtype == int(MatType.TRANSLUCENT))
    lanes = torch.nonzero(is_sss).flatten()
    keep = torch.nonzero(sss_map.valid).flatten()
    out = torch.zeros((is_sss.shape[0], 3), dtype=torch.float32,
                      device=is_sss.device)
    if lanes.numel() and keep.numel():
        xi = sss_map.pos.index_select(0, keep)
        pw = sss_map.power.index_select(0, keep)
        obj = sss_map.obj.index_select(0, keep)

        def rows(v):
            return v.index_select(0, lanes)[:, None]

        x = [rows(c) for c in sps.p]
        sa = [rows(c) for c in p.absorption]
        ss = [rows(c) for c in p.sigma_s]
        g, ior, lobj = rows(p.sss_g), rows(p.ior), rows(sps.obj)
        m, q = lanes.numel(), keep.numel()
        qb = min(q, max(1, SSS_PAIRS // m))
        mb = min(m, max(1, SSS_PAIRS // qb))
        total = torch.zeros((m, 3), dtype=torch.float32, device=out.device)
        for lo in range(0, m, mb):
            hi = min(m, lo + mb)
            acc = [torch.zeros(hi - lo, device=out.device)
                   for _ in range(3)]
            for c0 in range(0, q, qb):
                c1 = min(q, c0 + qb)
                r2 = sum((x[a][lo:hi] - xi[None, c0:c1, a]) ** 2
                         for a in range(3))
                w = (obj[None, c0:c1] == lobj[lo:hi]).to(torch.float32)
                for k in range(3):
                    rd = dipole_rd_1ch(r2, sa[k][lo:hi], ss[k][lo:hi],
                                       g[lo:hi], ior[lo:hi])
                    acc[k] = acc[k] + (rd * w * pw[None, c0:c1, k]).sum(1)
            total[lo:hi] = torch.stack(acc, dim=-1)
        ft = 1.0 - fresnel_dielectric(
            dot3(sps.n, wo).abs().index_select(0, lanes),
            p.ior.index_select(0, lanes))
        out = out.index_put((lanes,), total * ft[:, None] / math.pi)
    return V3(out[:, 0], out[:, 1], out[:, 2])
