"""Shiny-diffuse material family, SoA wavefront form
(counterpart of core_tpu/materials/shinydiffuse.py, its `*_s` functions).

The reference's layered stack (src/materials/shinydiffuse.cc): specular
mirror, specular transmit, diffuse translucency, diffuse (Lambert or
Oren-Nayar), with optional Fresnel weighting.  Conventions are the
reference's, copied as they are:

- eval() omits the 1/pi Lambert factor; lights bake a *pi into their
  radiance (lights/area.py).
- sample() pdf is |wi.N| * component_width (again without 1/pi).
- W = |wi.N| / (pdf*0.99 + 0.01)  (shinydiffuse.cc sample tail).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from core_tpu_torch.materials.base import BSDF, MatParamsS
from core_tpu_torch.mathutils import fresnel_dielectric, reflect_dir
from core_tpu_torch.sampling.utils import sample_cos_hemisphere_s
from core_tpu_torch.vec import V3, dot3, normalize3, where3, zeros3

# per-component BSDF flags in reference cFlags order (shinydiffuse config())
_COMP_FLAGS = (
    BSDF.SPECULAR | BSDF.REFLECT,   # 0 mirror
    BSDF.TRANSMIT | BSDF.FILTER,    # 1 transparency
    BSDF.DIFFUSE | BSDF.TRANSMIT,   # 2 translucency
    BSDF.DIFFUSE | BSDF.REFLECT,    # 3 diffuse
)


def face_forward_s(ng: V3, n: V3, wo: V3) -> V3:
    """FACE_FORWARD(Ng, N, wo): flip n when wo is behind the geometric normal."""
    return n * torch.where(dot3(ng, wo) < 0.0, -1.0, 1.0)


def kr_fresnel_s(p: MatParamsS, wo: V3, n: V3):
    """Mirror weight Kr: Fresnel if enabled else 1 (getFresnel)."""
    return torch.where(p.fresnel, fresnel_dielectric(dot3(wo, n), p.ior),
                       1.0)


def accumulate_s(p: MatParamsS, kr):
    """Layer energy cascade (shinydiffuse.cc accumulate()) -> 4 [N] tensors."""
    a0 = p.c_mirror * kr
    acc = 1.0 - a0
    a1 = p.c_transp * acc
    acc = acc * (1.0 - p.c_transp)
    a2 = p.c_transl * acc
    acc = acc * (1.0 - p.c_transl)
    a3 = p.c_diff * acc
    return a0, a1, a2, a3


def _oren_nayar_s(p: MatParamsS, wi: V3, wo: V3, n: V3):
    cos_ti = dot3(n, wi).clamp(1e-8, 1.0)
    cos_to = dot3(n, wo).clamp(1e-8, 1.0)
    v1 = normalize3(wi - n * cos_ti)
    v2 = normalize3(wo - n * cos_to)
    maxcos = torch.where((cos_ti < 0.9999) & (cos_to < 0.9999),
                         dot3(v1, v2).clamp_min(0.0), 0.0)
    ge = cos_to >= cos_ti
    sin_alpha = torch.sqrt(
        (1.0 - torch.where(ge, cos_ti, cos_to) ** 2).clamp_min(1e-12))
    cos_b = torch.where(ge, cos_to, cos_ti)
    tan_beta = torch.sqrt((1.0 - cos_b * cos_b).clamp_min(1e-12)) / cos_b
    return p.on_a + p.on_b * maxcos * sin_alpha * tan_beta


def _on_factor(p: MatParamsS, wi: V3, wo: V3, n: V3):
    return torch.where(p.on_b != 0.0, _oren_nayar_s(p, wi, wo, n), 1.0)


def eval_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
                req_flags: int = BSDF.ALL) -> V3:
    """Diffuse-side eval (shinydiffuse.cc eval)."""
    if not (req_flags & BSDF.DIFFUSE):
        return zeros3(p.c_diff)
    cos_ng_wo = dot3(sp.ng, wo)
    cos_ng_wi = dot3(sp.ng, wi)
    n = face_forward_s(sp.ng, sp.n, wo)
    kr = kr_fresnel_s(p, wo, n)
    m_t = (1.0 - kr * p.c_mirror) * (1.0 - p.c_transp)

    transmit = (cos_ng_wo * cos_ng_wi) < 0.0
    transl_col = p.diffuse_color * (p.c_transl * m_t)

    m_d = m_t * (1.0 - p.c_transl) * p.c_diff
    m_d = m_d * _on_factor(p, wi, wo, n)
    diff_col = p.diffuse_color * m_d
    diff_col = where3(dot3(n, wi) < 0.0, zeros3(m_d), diff_col)

    out = where3(transmit, transl_col, diff_col)
    has_diffuse = (p.flags & BSDF.DIFFUSE) != 0
    return where3(has_diffuse, out, 0.0)


def emit_s(p: MatParamsS) -> V3:
    return p.diffuse_color * p.emit_strength


class SampleResultS(NamedTuple):
    wi: V3
    col: V3                # BSDF value for the sampled direction
    pdf: torch.Tensor      # [N]
    flags: torch.Tensor    # [N] i32 sampled component flags
    w: torch.Tensor        # [N] reference's W throughput factor


class SpecularResultS(NamedTuple):
    """Perfect specular reflect/refract branches (getSpecular)."""
    refl_valid: torch.Tensor
    refl_dir: V3
    refl_col: V3
    refr_valid: torch.Tensor
    refr_dir: V3
    refr_col: V3


def _component_widths(p: MatParamsS, accum, req_flags: int, exact: bool):
    """CDF widths of the 4 layers under requested flags.
    exact=True uses sample()'s full-subset match, else pdf()'s any-overlap."""
    comps = (p.c_mirror, p.c_transp, p.c_transl, p.c_diff)
    ws = []
    for i in range(4):
        f = int(_COMP_FLAGS[i])
        m = ((req_flags & f) == f) if exact else ((req_flags & f) != 0)
        if m:
            ws.append(accum[i] * (comps[i] > 1e-5))
        else:
            ws.append(torch.zeros_like(accum[i]))
    return ws


def sample_bsdf_s(p: MatParamsS, sp, wo: V3, s1, s2,
                  req_flags: int = BSDF.ALL) -> SampleResultS:
    """Pick a layer by energy CDF and sample it (shinydiffuse.cc sample)."""
    n = face_forward_s(sp.ng, sp.n, wo)
    cos_ng_wo = dot3(sp.ng, wo)
    kr = kr_fresnel_s(p, wo, n)
    accum = accumulate_s(p, kr)
    w0, w1, w2, w3 = _component_widths(p, accum, req_flags, exact=True)
    total = w0 + w1 + w2 + w3
    ok = total > 1e-5
    # safe-denominator double-where (finite gradients on masked lanes)
    total_safe = torch.where(ok, total, 1.0)
    inv_total = torch.where(ok, 1.0 / total_safe, 0.0)
    wn0, wn1, wn2, wn3 = (w0 * inv_total, w1 * inv_total,
                          w2 * inv_total, w3 * inv_total)
    c0 = wn0
    c1 = c0 + wn1
    c2 = c1 + wn2
    pick = torch.where(s1 <= c0, 0, torch.where(
        s1 <= c1, 1, torch.where(s1 <= c2, 2, 3)))
    is0 = pick == 0
    is1 = pick == 1
    is2 = pick == 2
    width = torch.where(is0, wn0, torch.where(is1, wn1,
                        torch.where(is2, wn2, wn3)))
    cdf_prev = torch.where(is0, 0.0, torch.where(is1, c0,
                           torch.where(is2, c1, c2)))
    width_safe = torch.where(width > 1e-12, width, 1.0)
    s1r = ((s1 - cdf_prev) / width_safe).clamp(0.0, 1.0)

    # candidate 0: specular mirror reflect
    wi0 = reflect_dir(n, wo)
    col0 = p.mirror_color * (accum[0] / dot3(sp.n, wi0).abs().clamp_min(1e-6))
    pdf0 = width

    # candidate 1: specular transmit (straight through)
    wi1 = -wo
    tcol = p.diffuse_color * p.transmit_filter + (1.0 - p.transmit_filter)
    col1 = tcol * accum[1]
    pdf1 = torch.where(dot3(wi1, n).abs() < 1e-6, 0.0, width)

    # candidate 2: diffuse translucency (cosine hemisphere on far side)
    wi2 = sample_cos_hemisphere_s(-n, sp.nu, sp.nv, s1r, s2)
    opposite2 = (cos_ng_wo * dot3(sp.ng, wi2)) < 0.0
    col2 = where3(opposite2, p.diffuse_color * accum[2], 0.0)
    pdf2 = dot3(wi2, n).abs() * width

    # candidate 3: diffuse reflect (cosine hemisphere)
    wi3 = sample_cos_hemisphere_s(n, sp.nu, sp.nv, s1r, s2)
    same3 = (cos_ng_wo * dot3(sp.ng, wi3)) > 0.0
    on = _on_factor(p, wi3, wo, n)
    col3 = where3(same3, p.diffuse_color * (accum[3] * on), 0.0)
    pdf3 = dot3(wi3, n).abs() * width

    wi = where3(is0, wi0, where3(is1, wi1, where3(is2, wi2, wi3)))
    col = where3(is0, col0, where3(is1, col1, where3(is2, col2, col3)))
    pdf = torch.where(is0, pdf0, torch.where(is1, pdf1,
                      torch.where(is2, pdf2, pdf3)))
    flags = torch.where(is0, _COMP_FLAGS[0], torch.where(
        is1, _COMP_FLAGS[1], torch.where(is2, _COMP_FLAGS[2],
                                         _COMP_FLAGS[3])))

    pdf = torch.where(ok, pdf, 0.0)
    col = where3(ok, col, 1.0)
    flags = torch.where(ok, flags, BSDF.NONE).to(torch.int32)
    # W only for valid samples: the no-match branch (e.g. the emit-only light
    # material) terminates paths like lightMat_t::sample (W=0 pdf=0)
    w_factor = torch.where(ok, dot3(wi, sp.n).abs() / (pdf * 0.99 + 0.01),
                           0.0)
    return SampleResultS(wi=wi, col=col, pdf=pdf, flags=flags, w=w_factor)


def pdf_bsdf_s(p: MatParamsS, sp, wo: V3, wi: V3,
               req_flags: int = BSDF.ALL):
    """Solid-angle pdf of eval-able components (shinydiffuse.cc pdf)."""
    n = face_forward_s(sp.ng, sp.n, wo)
    cos_ng_wo = dot3(sp.ng, wo)
    cos_ng_wi = dot3(sp.ng, wi)
    kr = kr_fresnel_s(p, wo, n)
    accum = accumulate_s(p, kr)
    # reference pdf() matches with (bsdfs & cFlags[i]) -- any overlap
    w = _component_widths(p, accum, req_flags, exact=False)
    total = w[0] + w[1] + w[2] + w[3]

    cos_wi_n = dot3(wi, n).abs()
    pdf = torch.where((cos_ng_wo * cos_ng_wi) < 0.0, cos_wi_n * w[2], 0.0)
    pdf = pdf + cos_wi_n * w[3]
    ok = total > 1e-5
    total_safe = torch.where(ok, total, 1.0)
    return torch.where(ok, pdf / total_safe, 0.0)


def get_specular_s(p: MatParamsS, sp, wo: V3) -> SpecularResultS:
    """Perfect specular branches (shinydiffuse.cc getSpecular): the mirror
    reflect about the wo-side normal, and the transparent layer's straight
    refraction (-wo) filtered by the diffuse colour."""
    backface = dot3(wo, sp.ng) < 0.0
    n = where3(backface, -sp.n, sp.n)
    kr = kr_fresnel_s(p, wo, n)

    refr_valid = (p.flags & BSDF.FILTER) != 0
    tcol = p.diffuse_color * p.transmit_filter + (1.0 - p.transmit_filter)
    refr_col = tcol * ((1.0 - p.c_mirror * kr) * p.c_transp)

    refl_valid = (p.c_mirror * kr) > 1e-7
    refl_col = p.mirror_color * (p.c_mirror * kr)
    return SpecularResultS(refl_valid, reflect_dir(n, wo), refl_col,
                           refr_valid & (p.c_transp > 1e-7), -wo, refr_col)


def transparency_s(p: MatParamsS, sp, wo: V3) -> V3:
    """Attenuation of a transparent shadow ray (shinydiffuse.cc
    getTransparency)."""
    n = face_forward_s(sp.ng, sp.n, wo)
    kr = kr_fresnel_s(p, wo, n)
    tcol = p.diffuse_color * p.transmit_filter + (1.0 - p.transmit_filter)
    att = tcol * ((1.0 - p.c_mirror * kr) * p.c_transp)
    return where3((p.flags & BSDF.FILTER) != 0, att, 0.0)
