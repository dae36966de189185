"""Glossy material family, SoA wavefront form
(counterpart of core_tpu/materials/glossy.py; reference
src/materials/glossy2.cc with the microfacet formulas of
include/materials/microfacet.h).

Scope: the plain glossy material with the isotropic Blinn distribution
(exp_u == exp_v; anisotropic exponents raise at MaterialDef.bsdf_flags) and
Lambert or Oren-Nayar diffuse.  The coated-glossy family raises at dispatch.

- Blinn_D(cos_h, e) = (e+1) * cos_h^e                        (microfacet.h:99)
- ASDivisor(c, cI, cO) = 8*pi*(c*max(cI,cO)*0.99 + 0.04)     (microfacet.h:40)
- SchlickFresnel(cos, R) = R + (1-R)(1-cos)^5                (microfacet.h:200)
- pDiffuse = min(0.6, 1 - mGlossy/(mGlossy+(1-mGlossy)*mDiffuse))
                                                             (glossy2.cc:97)
"""
from __future__ import annotations

import math

import torch

from core_tpu_torch.materials.base import BSDF, MatParamsS
from core_tpu_torch.materials.shinydiffuse import (SampleResultS,
                                                   SpecularResultS,
                                                   _on_factor,
                                                   face_forward_s)
from core_tpu_torch.mathutils import reflect_dir
from core_tpu_torch.sampling.utils import sample_cos_hemisphere_s
from core_tpu_torch.vec import V3, dot3, normalize3, where3, zeros3

DIFFUSE_RATIO = 0.387507688  # microfacet.h:29


def _as_divisor(cos1, cos_i, cos_o):
    return 8.0 * math.pi * (cos1 * torch.maximum(cos_i, cos_o) * 0.99 + 0.04)


def _pdf_divisor(cos):
    return 8.0 * math.pi * (cos * 0.99 + 0.04)


def _schlick(cos, r):
    c1 = 1.0 - cos
    c2 = c1 * c1
    return r + (1.0 - r) * c1 * c2 * c2


def _blinn_d(cos_h, e):
    return (e + 1.0) * torch.pow(cos_h.clamp_min(0.0), e)


def _diffuse_components(p: MatParamsS):
    """(mDiffuse, mGlossy, pDiffuse) per hit (glossy2.cc initBSDF)."""
    m_diffuse = p.c_diff
    m_glossy = p.glossy_reflect
    denom = m_glossy + (1.0 - m_glossy) * m_diffuse
    ok = denom > 1e-12
    denom_safe = torch.where(ok, denom, 1.0)
    p_diffuse = (1.0 - torch.where(ok, m_glossy / denom_safe, 0.0)) \
        .clamp_max(0.6)
    return m_diffuse, m_glossy, p_diffuse


def _diffuse_reflect(wi_n, wo_n, m_glossy, m_diffuse, diff_col: V3) -> V3:
    """Coupled diffuse term (microfacet.h diffuseReflect)."""
    f_wi = 1.0 - 0.5 * wi_n
    f_wi = (f_wi * f_wi) * (f_wi * f_wi) * f_wi
    f_wo = 1.0 - 0.5 * wo_n
    f_wo = (f_wo * f_wo) * (f_wo * f_wo) * f_wo
    k = DIFFUSE_RATIO * m_diffuse * (1.0 - m_glossy) \
        * (1.0 - f_wi) * (1.0 - f_wo)
    return diff_col * k


def _use_glossy(p: MatParamsS, req_flags: int):
    """as_diffuse lobes answer DIFFUSE requests, the others GLOSSY ones."""
    return torch.where(p.as_diffuse, bool(req_flags & BSDF.DIFFUSE),
                       bool(req_flags & BSDF.GLOSSY))


def eval_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
                req_flags: int = BSDF.ALL) -> V3:
    """glossy2.cc eval: glossy lobe + uncoupled diffuse."""
    same_side = (dot3(sp.ng, wi) * dot3(sp.ng, wo)) >= 0.0
    n = face_forward_s(sp.ng, sp.n, wo)
    wi_n = dot3(wi, n).abs()
    wo_n = dot3(wo, n).abs()
    m_diffuse, m_glossy, _ = _diffuse_components(p)

    h = normalize3(wo + wi)
    cos_wi_h = dot3(wi, h).clamp_min(0.0)
    glossy = _blinn_d(dot3(h, n), p.exp_u) * _schlick(cos_wi_h, m_glossy) \
        / _as_divisor(cos_wi_h, wo_n, wi_n)
    col = p.glossy_color * glossy if req_flags & (BSDF.GLOSSY | BSDF.DIFFUSE) \
        else zeros3(glossy)
    if req_flags & BSDF.DIFFUSE:
        dcol = p.diffuse_color * (m_diffuse * (1.0 - m_glossy)
                                  * _on_factor(p, wi, wo, n))
        col = col + where3(m_diffuse > 0.0, dcol, 0.0)
    return where3(same_side, col, 0.0)


def _sample_blinn_h(e, s1, s2):
    """Blinn_Sample (microfacet.h:107): local half vector from exponent."""
    cos_t = torch.pow(1.0 - s2, 1.0 / (e + 1.0))
    sin_t = torch.sqrt((1.0 - cos_t * cos_t).clamp_min(0.0))
    phi = s1 * 2.0 * math.pi
    return sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t


def sample_bsdf_s(p: MatParamsS, sp, wo: V3, s1, s2,
                  req_flags: int = BSDF.ALL) -> SampleResultS:
    """glossy2.cc sample(): pick diffuse (prob pDiffuse) or glossy lobe."""
    n = face_forward_s(sp.ng, sp.n, wo)
    cos_ng_wo = dot3(sp.ng, wo)
    wo_n = dot3(wo, n).abs()
    m_diffuse, m_glossy, p_diffuse = _diffuse_components(p)
    with_diffuse = m_diffuse > 0.0
    diffuse_on = with_diffuse & bool(req_flags & BSDF.DIFFUSE)
    use_glossy = _use_glossy(p, req_flags) \
        if req_flags & (BSDF.GLOSSY | BSDF.DIFFUSE) \
        else torch.zeros_like(with_diffuse)

    p_diff_eff = torch.where(use_glossy, p_diffuse, 1.0) * diffuse_on
    take_diffuse = s1 < p_diff_eff
    pd_safe = torch.where(p_diff_eff > 1e-12, p_diff_eff, 1.0)
    pg_safe = torch.where(p_diff_eff < 1.0 - 1e-12, 1.0 - p_diff_eff, 1.0)
    s1d = s1 / pd_safe
    s1g = (s1 - p_diff_eff) / pg_safe

    # diffuse branch: cosine hemisphere
    wi_d = sample_cos_hemisphere_s(n, sp.nu, sp.nv, s1d.clamp(0.0, 1.0), s2)
    # glossy branch: sample a half vector, flip it to wo's side, reflect
    hx, hy, hz = _sample_blinn_h(p.exp_u, s1g.clamp(0.0, 1.0), s2)
    h = sp.nu * hx + sp.nv * hy + n * hz
    h = where3(dot3(wo, h) < 0.0, n * (2.0 * dot3(n, h)) - h, h)
    wi_g = reflect_dir(h, wo)

    wi = where3(take_diffuse, wi_d, wi_g)
    same_side = (dot3(sp.ng, wi) * cos_ng_wo) >= 0.0
    wi_n = dot3(wi, n).abs()

    hh = normalize3(wo + wi)
    cos_wo_hh = dot3(wo, hh).abs()
    cos_wi_hh = dot3(wi, hh).abs()
    d_val = _blinn_d(dot3(hh, n), p.exp_u)
    glossy_val = d_val * _schlick(cos_wi_hh, m_glossy) \
        / _as_divisor(cos_wi_hh, wo_n, wi_n)
    micro_pdf = d_val / _pdf_divisor(cos_wo_hh)

    mixed = wi_n * p_diff_eff + micro_pdf * (1.0 - p_diff_eff)
    pdf = torch.where(take_diffuse, torch.where(use_glossy, mixed, wi_n),
                      torch.where(diffuse_on, mixed, micro_pdf))

    col = where3(use_glossy, p.glossy_color * glossy_val, 0.0)
    dcol = _diffuse_reflect(wi_n, wo_n, m_glossy, m_diffuse,
                            p.diffuse_color) * _on_factor(p, wi, wo, n)
    col = col + where3(diffuse_on, dcol, 0.0)

    ok = same_side & (pdf > 1e-8)
    col = where3(ok, col, 0.0)
    pdf = torch.where(ok, pdf, 0.0)
    dr = BSDF.DIFFUSE | BSDF.REFLECT
    flags = torch.where(take_diffuse | p.as_diffuse, dr,
                        BSDF.GLOSSY | BSDF.REFLECT).to(torch.int32)
    w = wi_n / (pdf * 0.99 + 0.01)
    return SampleResultS(wi=wi, col=col, pdf=pdf, flags=flags, w=w)


def pdf_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
               req_flags: int = BSDF.ALL):
    """glossy2.cc pdf(): mix cosine + half-vector pdfs by pDiffuse."""
    same_side = (dot3(sp.ng, wi) * dot3(sp.ng, wo)) >= 0.0
    n = face_forward_s(sp.ng, sp.n, wo)
    wi_n = dot3(wi, n).abs()
    m_diffuse, _, p_diffuse = _diffuse_components(p)
    diffuse_on = (m_diffuse > 0.0) & bool(req_flags & BSDF.DIFFUSE)
    use_glossy = _use_glossy(p, req_flags)

    h = normalize3(wo + wi)
    micro_pdf = _blinn_d(dot3(h, n), p.exp_u) \
        / _pdf_divisor(dot3(wo, h).abs())
    pdf = torch.where(
        diffuse_on,
        torch.where(use_glossy,
                    wi_n * p_diffuse + micro_pdf * (1.0 - p_diffuse), wi_n),
        torch.where(use_glossy, micro_pdf, 0.0))
    return torch.where(same_side, pdf, 0.0)


def get_specular_s(p: MatParamsS, sp, wo: V3) -> SpecularResultS:
    """Plain glossy has no specular branch (glossy2.cc): both invalid.
    core_tpu's invalid reflect branch carries kr * mirror_color where this
    one carries 0; a lane never takes an invalid branch, so the chain's
    radiance and gradients are the same (core_tpu glossy.py:297-307)."""
    none = torch.zeros_like(p.as_diffuse)
    z = zeros3(wo.x)
    return SpecularResultS(
        none, reflect_dir(face_forward_s(sp.ng, sp.n, wo), wo), z, none, -wo,
        z)


def transparency_s(p: MatParamsS, sp, wo: V3) -> V3:
    """Glossy surfaces are opaque to shadow rays (core_tpu glossy.py)."""
    return zeros3(wo.x)
