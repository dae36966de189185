"""Glass (perfect specular dielectric) and rough glass (GGX microfacet),
SoA wavefront form (counterpart of core_tpu/materials/glass.py; reference
src/materials/glass.cc, src/materials/roughglass.cc and the microfacet
helpers of include/materials/microfacet.h).

Conventions, as core_tpu matches them:
- glass sample: refract with probability pKt = 0.01 + 0.99 Kt, else
  reflect; W = 1; colour filterCol (refract) or mirrorCol (reflect), white
  on total internal reflection (glass.cc:84-190)
- glass getSpecular: refract Kt * filterCol, reflect Kr * mirrorCol, white
  reflection under TIR; every smooth row has its reflect branch
  (glass.cc:205-250)
- getTransparency (fake shadows): Kt * filterCol (glass.cc:192-198)
- rough glass sample: GGX half vector, Walter-style refraction Jacobian
  (roughglass.cc:55-146); rough glass has no perfect-specular branch
- both are sample-only: eval and pdf return 0
Beer absorption (the `absorption` column) is applied by the photon shoot
(photon/map.py), not here.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.materials.base import BSDF, MatParamsS, MatType
from core_tpu_torch.materials.shinydiffuse import (SampleResultS,
                                                   SpecularResultS,
                                                   face_forward_s)
from core_tpu_torch.mathutils import (fresnel_dielectric, reflect_dir,
                                      refract_dir)
from core_tpu_torch.vec import V3, dot3, normalize3, where3, zeros3


def _fresnel_kr_kt(wo: V3, n: V3, ior):
    """Reference fresnel() (vector3d.h): the g/c form on |cos|."""
    kr = fresnel_dielectric(dot3(wo, n), ior)
    return kr, 1.0 - kr


def _glass_normal(sp, wo: V3):
    """glass.cc sample(): sp.N, pushed to wo's hemisphere where the
    interpolated normal disagrees with Ng."""
    outside = dot3(sp.ng, wo) > 0.0
    cos_wo_n = dot3(sp.n, wo)
    bad = torch.where(outside, cos_wo_n < 0.0, cos_wo_n > 0.0)
    fixed = normalize3(sp.n - wo * (1.00001 * cos_wo_n))
    return where3(bad, fixed, sp.n)


def _is_rough(p: MatParamsS):
    return p.mtype == int(MatType.ROUGH_GLASS)


# ---------------- perfect specular glass ----------------

def _glass_sample(p: MatParamsS, sp, wo: V3, s1, req_flags):
    n = _glass_normal(sp, wo)
    can_refract, refdir = refract_dir(n, wo, p.ior)
    kr, kt = _fresnel_kr_kt(wo, n, p.ior)
    p_kr = 0.01 + 0.99 * kr
    p_kt = 0.01 + 0.99 * kt

    want_trans = bool(req_flags & BSDF.TRANSMIT)
    want_refl = bool(req_flags & (BSDF.SPECULAR | BSDF.REFLECT))
    take_refract = can_refract & (s1 < p_kt) & want_trans
    tir = ~can_refract

    wi = where3(take_refract, refdir, reflect_dir(n, wo))
    col = where3(take_refract, p.filter_color,
                 where3(tir, V3(*(torch.ones_like(kr),) * 3),
                        p.mirror_color))
    pdf = torch.where(take_refract, p_kt, torch.where(tir, 1.0, p_kr))
    valid = take_refract | want_refl
    # the refract sample's flags (glass.cc:147): FILTER|TRANSMIT with
    # fake_shadows, else SPECULAR|TRANSMIT
    fake = (p.flags & BSDF.FILTER) != 0
    refr_flags = torch.where(fake, BSDF.FILTER | BSDF.TRANSMIT,
                             BSDF.SPECULAR | BSDF.TRANSMIT)
    flags = torch.where(take_refract, refr_flags,
                        BSDF.SPECULAR | BSDF.REFLECT)
    return SampleResultS(wi=wi, col=where3(valid, col, 0.0),
                         pdf=torch.where(valid, pdf, 0.0),
                         flags=torch.where(valid, flags, BSDF.NONE).to(
                             torch.int32),
                         w=torch.ones_like(pdf))   # glass.cc: W = 1


# ---------------- rough glass (GGX) ----------------

def _ggx_sample_h(alpha2, s1, s2):
    """GGX_Sample (microfacet.h:119): the local half vector."""
    tan2 = alpha2 * (s1 / (1.00001 - s1))
    cos_t = 1.0 / torch.sqrt(1.0 + tan2)
    sin_t = torch.sqrt((1.00001 - cos_t * cos_t).clamp_min(0.0))
    phi = 2.0 * np.pi * s2
    return sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t


def _ggx_d(alpha2, cos_t2, tan_t2):
    cos_t4 = cos_t2 * cos_t2
    a_tan = alpha2 + tan_t2
    return alpha2 / (np.pi * cos_t4 * a_tan * a_tan)


def _ggx_g(alpha2, wo_n, wi_n):
    def g1(c):
        c2 = (c * c).clamp_min(1e-12)
        return 2.0 / (1.0 + torch.sqrt(1.0 + alpha2 * (1.0 - c2) / c2))
    return g1(wo_n) * g1(wi_n)


def _refract_micro(eta, wo: V3, h: V3, wo_h):
    """refractMicrofacet (microfacet.h:173): Walter-style refraction of
    -wo through the microfacet normal h -> (ok, wi, kr, kt)."""
    c = -wo_h
    sign = torch.where(c > 0.0, 1.0, -1.0)
    t1 = 1.0 - eta * eta * (1.0 - c * c)
    ok = t1 >= 0.0
    wi = -(wo * eta + h * (eta * c - sign * torch.sqrt(t1.clamp_min(0.0))))
    kr = fresnel_dielectric(wo_h, 1.0 / eta.clamp_min(1e-8))
    return ok & (kr < 1.0), wi, kr, 1.0 - kr


def _rough_sample(p: MatParamsS, sp, wo: V3, s1, s2, req_flags):
    n = face_forward_s(sp.ng, sp.n, wo)
    outside = dot3(sp.ng, wo) > 0.0
    alpha2 = p.alpha_rough * p.alpha_rough

    hx, hy, hz = _ggx_sample_h(alpha2, s1, s2)
    h = normalize3(sp.nu * hx + sp.nv * hy + n * hz)
    cos_t = dot3(h, n)
    # the NaN-safe guards of core_tpu glass.py:138-139,157
    steep = cos_t > 1e-6
    cos_t2 = torch.where(steep, cos_t * cos_t, 1.0)
    tan_t2 = (1.0 - cos_t2) / (cos_t2 * 0.99 + 0.01)
    d = torch.where(steep, _ggx_d(alpha2, cos_t2, tan_t2), 0.0)

    wo_h = dot3(wo, h)
    wo_n = dot3(wo, n)
    eta = torch.where(outside, 1.0 / p.ior, p.ior)
    ok_refr, wi_t, kr, kt = _refract_micro(eta, wo, h, wo_h)

    # transmission
    wi_t_n = dot3(wi_t, n)
    wi_t_h = dot3(wi_t, h)
    g_t = torch.where((wi_t_h * wi_t_n > 0.0) & (wo_h * wo_n > 0.0),
                      _ggx_g(alpha2, wi_t_n, wo_n), 0.0)
    ior_wi = torch.where(outside, p.ior, 1.0)
    ior_wo = torch.where(outside, 1.0, p.ior)
    ht = ior_wo * wo_h + ior_wi * wi_t_h
    jac_t = (ior_wi * ior_wi) / (ht * ht).clamp_min(1e-8)
    tn_denom = wi_t_n * wo_n
    tn_safe = torch.where(tn_denom.abs() > 1e-8, tn_denom, 1.0)
    glossy_t = (wo_h * wi_t_h / tn_safe).abs() * kt * g_t * d * jac_t
    pdf_t = d * cos_t * jac_t * wi_t_h.abs()

    # reflection (reflectMicrofacet: wo reflected about h)
    wi_r = reflect_dir(h, wo)
    wi_r_n = dot3(wi_r, n)
    wi_r_h = dot3(wi_r, h)
    g_r = _ggx_g(alpha2, wi_r_n, wo_n)
    jac_r = 1.0 / (4.0 * wi_r_h.abs() * 0.99 + 0.01)
    glossy_r = (kr * g_r * d) / (4.0 * (wo_n * wi_r_n).abs() * 0.99 + 0.01)
    pdf_r = d * cos_t * jac_r

    want_trans = bool(req_flags & BSDF.TRANSMIT)
    want_refl = bool(req_flags & BSDF.REFLECT)
    take_trans = ok_refr & (s1 < kt) & want_trans
    tir = ~ok_refr

    wi = where3(take_trans, wi_t, wi_r)
    col = where3(take_trans, p.filter_color * glossy_t,
                 where3(tir, V3(*(torch.ones_like(kr),) * 3),
                        p.mirror_color * glossy_r))
    pdf = torch.where(take_trans, pdf_t, torch.where(tir, 1.0, pdf_r))
    valid = take_trans | (ok_refr | tir) if want_refl else take_trans
    # hemisphere rejection (core_tpu glass.py:184-191): a reflection that
    # leaves below the surface, or a refraction that stays above, is void
    cos_wi_n = dot3(wi, n)
    valid = valid & torch.where(take_trans, cos_wi_n * wo_n < 0.0,
                                cos_wi_n * wo_n > 0.0)
    flags = torch.where(take_trans, BSDF.GLOSSY | BSDF.TRANSMIT,
                        BSDF.GLOSSY | BSDF.REFLECT)
    pdf = torch.where(valid, pdf, 0.0)
    w = torch.where(tir, 1.0, dot3(wi, n).abs() / (pdf * 0.99 + 0.01))
    return SampleResultS(wi=wi, col=where3(valid, col, 0.0), pdf=pdf,
                         flags=torch.where(valid, flags, BSDF.NONE).to(
                             torch.int32), w=w)


# ---------------- family entry points (GLASS | ROUGH_GLASS) ----------------

def eval_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
                req_flags: int = BSDF.ALL) -> V3:
    """Both glasses are sample-only in the reference: 0."""
    return zeros3(wo.x)


def pdf_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
               req_flags: int = BSDF.ALL):
    return torch.zeros_like(wo.x)


def sample_bsdf_s(p: MatParamsS, sp, wo: V3, s1, s2,
                  req_flags: int = BSDF.ALL) -> SampleResultS:
    rough = _rough_sample(p, sp, wo, s1, s2, req_flags)
    smooth = _glass_sample(p, sp, wo, s1, req_flags)
    m = _is_rough(p)
    return SampleResultS(*[where3(m, a, b) if isinstance(a, V3)
                           else torch.where(m, a, b)
                           for a, b in zip(rough, smooth)])


def get_specular_s(p: MatParamsS, sp, wo: V3) -> SpecularResultS:
    """glass.cc getSpecular; rough rows have no perfect-specular branch."""
    n = _glass_normal(sp, wo)
    can_refract, refdir = refract_dir(n, wo, p.ior)
    kr, kt = _fresnel_kr_kt(wo, n, p.ior)
    refl_col = where3(can_refract, p.mirror_color * kr,
                      V3(*(torch.ones_like(kr),) * 3))   # TIR -> white
    smooth = ~_is_rough(p)
    return SpecularResultS(smooth, reflect_dir(n, wo), refl_col,
                           smooth & can_refract, refdir,
                           p.filter_color * kt)


def transparency_s(p: MatParamsS, sp, wo: V3) -> V3:
    """Fake-shadow transmittance Kt * filterCol (glass.cc
    getTransparency)."""
    _, kt = _fresnel_kr_kt(wo, face_forward_s(sp.ng, sp.n, wo), p.ior)
    return p.filter_color * kt
