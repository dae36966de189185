"""Volume integrators: emission-only and single-scatter ray marching, and
the sky's exponential atmosphere (counterpart of
core_tpu/integrators/volume.py).

Reference: src/integrators/EmissionIntegrator.cc (emission and tau
transmittance), SingleScatterIntegrator.cc (a fixed-step march with one
light sample per step, a geometric shadow test and the volume's own
attenuation toward the light) and SkyIntegrator.cc (Rayleigh + Mie
in-scatter of the background).  The march count is static (`steps`; the
scene file's world-space stepSize becomes it in
environment.volume_march_steps).

Conventions copied from core_tpu, where they look odd:
- integrate samples each step at its START, t0 + i*dt, and multiplies the
  step's extinction into the transmittance before adding the step's
  in-scatter (SingleScatterIntegrator.cc:415-460); tau samples midpoints.
- single scattering applies no phase function, and the in-scatter is
  clamped to [0, 1] (SingleScatterIntegrator.cc:152-280, 484); the
  volume golden encodes both.
- each step takes one deterministic light sample: s = 0.5 for an area-type
  light, illuminate for a dirac one, at a stand-in surface point whose
  normal is (0, 0, 1) whatever the scene's up axis (_point_sp).
The shadow test of each step is scene.any_hit_s (kernel 3, 5 or 8), so a
single-scatter march launches one any-hit wavefront per step and light.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.lights import base as light_base
from core_tpu_torch.mathutils import SHADOW_BIAS
from core_tpu_torch.vec import SPS, V3, RaysS, where3
from core_tpu_torch.volumes import regions as vr


@dataclass(frozen=True)
class VolumeOptions:
    integrator: str = "none"      # none | emission | singlescatter | sky
    steps: int = 16               # march steps per volume
    step_size: float = 1.0        # the scene file's stepSize (world units)
    # SkyIntegrator's parameters (SkyIntegrator.cc:264-272)
    sky_alpha: float = 0.5        # exponential density steepness
    sky_scale: float = 0.1        # the reference's "sigma_t" (world scale)
    sky_turbidity: float = 3.0
    # single-scatter "optimize": per-light attenuation precomputed on a
    # grid over each volume and looked up trilinearly during the march
    # (SingleScatterIntegrator.cc:16, 494-496)
    optimize: bool = False
    att_grid_res: int = 16


INTEGRATORS = ("none", "emission", "singlescatter", "sky")

# march steps of the volume attenuation of surface-NEE shadow rays
NEE_VOL_STEPS = 8


def check_supported(opts: VolumeOptions):
    if opts.integrator not in INTEGRATORS:
        raise ValueError(f"unknown volume integrator {opts.integrator!r}; "
                         f"expected one of {INTEGRATORS}")


def _ones3(like) -> V3:
    o = torch.ones_like(like, dtype=torch.float32)
    return V3(o, o, o)


def transmittance(scene, rays: RaysS, steps: int = 16) -> V3:
    """exp(-sum of tau) over the scene's volumes, V3 of [N]."""
    if not scene.volumes:
        return _ones3(rays.tmax)
    acc = None
    for vol in scene.volumes:
        t = vr.tau(vol, rays, n_steps=steps)
        acc = t if acc is None else acc + t
    return V3(*(torch.exp(-c) for c in acc))


def transmittance_nee_s(scene, o: V3, wi: V3, dist,
                        steps: int = NEE_VOL_STEPS) -> V3:
    """The volume attenuation of surface-NEE light samples (the reference
    multiplies every light sample by it, mcintegrator.cc:96,131,181): o,
    wi V3 of [N]; dist <= 0 is unbounded (a background or sun sample)."""
    tmax = torch.where(dist > 0, dist, 3.0e38)
    rays = RaysS(o=o, d=wi, tmin=torch.full_like(dist, SHADOW_BIAS),
                 tmax=tmax)
    return transmittance(scene, rays, steps=steps)


def _point_sp(p: V3) -> SPS:
    """A stand-in surface point at volume points p for light sampling:
    normal (0, 0, 1), material 0, no light, primitive and object 0."""
    z = torch.zeros_like(p.x)
    one = torch.ones_like(p.x)
    up = V3(z, z, one)
    zi = torch.zeros_like(p.x, dtype=torch.int32)
    return SPS(p=p, n=up, ng=up, nu=up, nv=up, u=z, v=z, mat=zi,
               light=torch.full_like(zi, -1), prim=zi, obj=zi)


def _light_sample(light, sp: SPS):
    """One deterministic light sample per point (s = 0.5 for area-type
    lights)."""
    if light_base.dirac(light):
        return light_base.illuminate_s(light, sp)
    s = torch.full_like(sp.p.x, 0.5)
    return light_base.illum_sample_s(light, sp, s, s)


def precompute_attenuation(scene, opts: VolumeOptions):
    """Per-(volume, light) attenuation grids of single-scatter's optimize
    mode (the reference's attenuationGridMap): a tuple with one
    [L, R, R, R, 3] transmittance grid per volume, or None when the mode
    is off.  Runs once per render."""
    if opts.integrator != "singlescatter" or not opts.optimize \
            or not scene.volumes or not scene.lights:
        return None
    r = opts.att_grid_res
    fr = (torch.arange(r, dtype=torch.float32, device=scene.device) + 0.5) / r
    grids = []
    for vol in scene.volumes:
        axes = [vol.bmin[k] + fr * (vol.bmax[k] - vol.bmin[k])
                for k in range(3)]
        X, Y, Z = torch.meshgrid(*axes, indexing="ij")
        pts = V3(X.reshape(-1), Y.reshape(-1), Z.reshape(-1))
        sp = _point_sp(pts)
        per_light = []
        for light in scene.lights:
            ls = _light_sample(light, sp)
            sray = RaysS(o=pts, d=ls.wi,
                         tmin=torch.full_like(ls.dist, SHADOW_BIAS),
                         tmax=torch.where(ls.dist > 0,
                                          ls.dist - SHADOW_BIAS, -1.0))
            tr = transmittance(scene, sray, steps=opts.steps)
            per_light.append(torch.stack(list(tr), -1).reshape(r, r, r, 3))
        grids.append(torch.stack(per_light))
    return tuple(grids)


def _att_lookup(grid, bmin, bmax, p: V3) -> V3:
    """Trilinear lookup of an [R, R, R, 3] attenuation grid at p."""
    r = grid.shape[0]
    ext = (bmax - bmin).clamp_min(1e-9)
    i0, i1, w = [], [], []
    for k, c in enumerate(p):
        f = ((c - bmin[k]) / ext[k] * r - 0.5).clamp(0.0, r - 1.0)
        lo = torch.floor(f).to(torch.int64)
        i0.append(lo)
        i1.append((lo + 1).clamp_max(r - 1))
        w.append(f - lo.to(torch.float32))
    flat = grid.reshape(-1, 3)
    out = None
    for dx_ in (0, 1):
        for dy_ in (0, 1):
            for dz_ in (0, 1):
                ix = i1[0] if dx_ else i0[0]
                iy = i1[1] if dy_ else i0[1]
                iz = i1[2] if dz_ else i0[2]
                wt = (w[0] if dx_ else 1 - w[0]) \
                    * (w[1] if dy_ else 1 - w[1]) \
                    * (w[2] if dz_ else 1 - w[2])
                g = flat.index_select(0, (ix * r + iy) * r + iz)
                term = V3(g[:, 0] * wt, g[:, 1] * wt, g[:, 2] * wt)
                out = term if out is None else out + term
    return out


def integrate(scene, rays: RaysS, hits_t, pixel_sample, sampling_offs,
              opts: VolumeOptions, vol_aux=None) -> V3:
    """In-scattered (and emitted) radiance along camera rays, V3 of [N],
    clamped to [0, 1].  hits_t: [N] surface-hit distance (<= 0: none)
    caps the march; vol_aux: precompute_attenuation's grids.  The march
    is deterministic: pixel_sample and sampling_offs are taken, as
    core_tpu takes them, and not read."""
    zero = torch.zeros_like(rays.tmax)
    if not scene.volumes or opts.integrator == "none":
        return V3(zero, zero, zero)
    capped = rays._replace(tmax=torch.where(hits_t > 0, hits_t, rays.tmax))
    col = V3(zero, zero, zero)
    for vol_idx, vol in enumerate(scene.volumes):
        hit, t0, t1 = vr.cross_bb(vol, capped)
        dt = (t1 - t0) / opts.steps
        trans = _ones3(dt)
        vcol = V3(zero, zero, zero)
        for i in range(opts.steps):
            p = rays.o + rays.d * (t0 + i * dt)
            st, ss, em = vr.media(vol, p)
            trans = trans * V3(*(torch.exp(-c * dt) for c in st))
            vcol = vcol + trans * em * dt
            if opts.integrator != "singlescatter":
                continue
            sp = _point_sp(p)
            for li, light in enumerate(scene.lights):
                ls = _light_sample(light, sp)
                sray = RaysS(o=p, d=ls.wi,
                             tmin=torch.full_like(dt, SHADOW_BIAS),
                             tmax=ls.dist - SHADOW_BIAS)
                shadowed = scene_mod.any_hit_s(scene, sray)
                if vol_aux is not None:
                    ltr = _att_lookup(vol_aux[vol_idx][li], vol.bmin,
                                      vol.bmax, p)
                else:
                    ltr = transmittance(scene, sray,
                                        steps=max(4, opts.steps // 4))
                pdf = ls.pdf.clamp_min(1e-12)
                contrib = V3(*(c / pdf for c in ss * ls.col * ltr))
                ok = ls.valid & ~shadowed & hit
                vcol = vcol + where3(ok, trans * contrib * dt, 0.0)
        col = col + where3(hit, vcol, 0.0)
    return V3(*(c.clamp(0.0, 1.0) for c in col))


# ---------------------------------------------------------------------------
# SkyIntegrator (SkyIntegrator.cc:55-272)
# ---------------------------------------------------------------------------

# the piecewise-linear Mie angular table (SkyIntegrator.cc mieScatter)
_MIE_DEG = np.array([0.0, 1.0, 4.0, 7.0, 10.0, 30.0, 60.0, 80.0, 180.0],
                    np.float32)
_MIE_VAL = np.array([4.192, 4.192, 3.311, 2.860, 2.518, 1.122, 0.3324,
                     0.1644, 0.1], np.float32)


def sky_constants(alpha: float, turbidity: float):
    """(b_r, b_m, alpha_r, alpha_m): the Rayleigh and Mie extinction
    coefficients and falloffs (SkyIntegrator.cc's constructor)."""
    alpha_r = 0.1136 * alpha
    alpha_m = 0.8333 * alpha
    N, n, p_n, l = 2.545e25, 1.0003, 0.035, 500e-9
    b_r = (8 * np.pi ** 3 * (n * n - 1) ** 2 / (3 * N * l ** 4)
           * (6 + 3 * p_n) / (6 - 7 * p_n))
    c = (0.6544 * turbidity - 0.651) * 1e-16
    v, K = 4.0, 0.67
    b_m = 0.434 * c * np.pi * (2 * np.pi / l) ** (v - 2) * K * 0.01
    return float(b_r), float(b_m), float(alpha_r), float(alpha_m)


def _sky_tau(beta, alpha, h0, cos_theta, s):
    """The exponential atmosphere's optical depth over [0, s]
    (SkyIntegrator.cc skyTau): beta exp(-a h0) (1 - exp(-a cos s)) /
    (a cos)."""
    denom = alpha * torch.where(cos_theta.abs() < 1e-5,
                                torch.where(cos_theta < 0, -1e-5, 1e-5),
                                cos_theta)
    return beta * torch.exp(-alpha * h0) * (1.0 - torch.exp(-denom * s)) \
        / denom


def sky_transmittance(rays: RaysS, opts: VolumeOptions) -> V3:
    """exp(-(tau_mie + tau_rayleigh)) along the rays, grey (the
    reference's colorA_t(exp(-energy))); tmax <= 0 transmits fully."""
    b_r, b_m, a_r, a_m = sky_constants(opts.sky_alpha, opts.sky_turbidity)
    bounded = rays.tmax > 0
    s = torch.where(bounded, rays.tmax, 0.0) * opts.sky_scale
    h0 = rays.o.z * opts.sky_scale
    cos_t = rays.d.z
    tau = _sky_tau(b_m, a_m, h0, cos_t, s) + _sky_tau(b_r, a_r, h0, cos_t, s)
    tr = torch.exp(-torch.where(bounded, tau, 0.0))
    return V3(tr, tr, tr)


def interp(x, xp, fp):
    """np.interp / jnp.interp: piecewise-linear fp(xp) at x, held at the
    end values outside [xp[0], xp[-1]]."""
    i = torch.searchsorted(xp, x.contiguous(), right=True) \
        .clamp(1, xp.shape[0] - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    f = f0 + ((x - x0) / (x1 - x0)) * (f1 - f0)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def sky_integrate(scene, rays: RaysS, hits_t, opts: VolumeOptions,
                  n_dirs_theta: int = 3, n_dirs_phi: int = 8) -> V3:
    """In-scattered sky radiance along the rays, V3 of [N]
    (SkyIntegrator.cc integrate :185-260): S0, the hemisphere's sum of
    background radiance times the angular Rayleigh and Mie coefficients,
    then a march of the exponential atmosphere accumulating
    Tr * density * step up to the surface hit (hits_t > 0; 0 elsewhere)."""
    zero = torch.zeros_like(rays.tmax)
    if scene.background is None:
        return V3(zero, zero, zero)
    b_r, b_m, a_r, a_m = sky_constants(opts.sky_alpha, opts.sky_turbidity)
    K = 0.67
    dev = rays.tmax.device
    mie_deg = torch.as_tensor(_MIE_DEG, device=dev)
    mie_val = torch.as_tensor(_MIE_VAL, device=dev)
    s0_r = V3(zero, zero, zero)
    s0_m = V3(zero, zero, zero)
    one = torch.ones(1, dtype=torch.float32, device=dev)
    for v in range(n_dirs_theta):
        theta = (v * 0.3 + 0.2) * 0.5 * np.pi
        for u in range(n_dirs_phi):
            phi = u * 2.0 * np.pi / n_dirs_phi
            w = np.asarray([np.sin(theta) * np.cos(phi),
                            np.sin(theta) * np.sin(phi), np.cos(theta)],
                           np.float32)
            L_s = eval_background_s(scene.background,
                                    V3(*(one * float(c) for c in w)))
            cos_wd = float(w[0]) * rays.d.x + float(w[1]) * rays.d.y \
                + float(w[2]) * rays.d.z
            b_r_ang = b_r * 3.0 / (2.0 * np.pi * 8.0) * (1.0 + cos_wd ** 2)
            ang_deg = torch.rad2deg(torch.arccos(cos_wd.clamp(-1.0, 1.0)))
            b_m_ang = b_m / (2.0 * K * np.pi) * interp(ang_deg, mie_deg,
                                                       mie_val)
            s0_m = s0_m + L_s * b_m_ang
            s0_r = s0_r + L_s * b_r_ang
    inv_uv = 1.0 / (n_dirs_theta * n_dirs_phi)
    s0_r = s0_r * inv_uv
    s0_m = s0_m * inv_uv

    bounded = hits_t > 0
    s = torch.where(bounded, hits_t, 0.0) * opts.sky_scale
    h0 = rays.o.z * opts.sky_scale
    cos_t = rays.d.z
    step = s / opts.steps
    i_r = torch.zeros_like(s)
    i_m = torch.zeros_like(s)
    for i in range(opts.steps):
        pos = (i + 0.5) * step
        u_r = torch.exp(-a_r * (h0 + pos * cos_t))
        u_m = torch.exp(-a_m * (h0 + pos * cos_t))
        tr_r = torch.exp(-_sky_tau(b_r, a_r, h0, cos_t, pos))
        tr_m = torch.exp(-_sky_tau(b_m, a_m, h0, cos_t, pos))
        i_r = i_r + tr_r * u_r * step
        i_m = i_m + tr_m * u_m * step
    return where3(bounded, s0_r * i_r + s0_m * i_m, 0.0)
