"""Type-dispatched BSDF calls over the wavefront
(counterpart of core_tpu/materials/dispatch.py, its SoA half).

Each material family present in the scene is evaluated on the whole
wavefront and its results are selected by type mask.  `types_present` is a
static tuple of MatType values.  Every family is ported: shiny-diffuse,
glossy (plain and coated), glass and rough glass, and translucent, whose
surface is the glossy family's BSDF (its subsurface transport lives in
integrators/sss.py, keyed on the TRANSLUCENT type).  Blend and mask rows
never reach dispatch: scene.material_params_s resolves them to a
sub-material's row.
"""
from __future__ import annotations

import torch

from core_tpu_torch.materials import glass, glossy, shinydiffuse
from core_tpu_torch.materials.base import BSDF, MatType
from core_tpu_torch.vec import V3, where3, zeros3

_FAMILIES = {int(MatType.SHINY_DIFFUSE): shinydiffuse,
             int(MatType.GLOSSY): glossy,
             int(MatType.COATED_GLOSSY): glossy,
             int(MatType.GLASS): glass,
             int(MatType.ROUGH_GLASS): glass,
             int(MatType.TRANSLUCENT): glossy}


def _modules(types_present):
    seen = []
    for t in types_present:
        m = _FAMILIES.get(int(t))
        if m is None:
            raise NotImplementedError(
                f"material family {MatType(int(t)).name} is not ported to "
                "core_tpu_torch yet")
        if m not in [x[1] for x in seen]:
            seen.append((int(t), m))
    return seen


def _mask_for(p, module, types_present):
    mask = torch.zeros(p.mtype.shape, dtype=torch.bool,
                       device=p.mtype.device)
    for t in types_present:
        if _FAMILIES.get(int(t)) is module:
            mask = mask | (p.mtype == int(t))
    return mask


def _where_mask_s(mask, a, b):
    if isinstance(a, V3):
        return where3(mask, a, b)
    if hasattr(a, "_fields"):
        return type(a)(*[_where_mask_s(mask, x, y) for x, y in zip(a, b)])
    return torch.where(mask, a, b)


def eval_bsdf_s(types_present, p, sps, wo, wi, req_flags: int = BSDF.ALL):
    out = zeros3(p.c_diff)
    for _, m in _modules(types_present):
        mask = _mask_for(p, m, types_present)
        out = _where_mask_s(mask, m.eval_bsdf_s(p, sps, wo, wi, req_flags),
                            out)
    return out


def sample_bsdf_s(types_present, p, sps, wo, s1, s2,
                  req_flags: int = BSDF.ALL):
    out = None
    for _, m in _modules(types_present):
        r = m.sample_bsdf_s(p, sps, wo, s1, s2, req_flags)
        out = r if out is None else _where_mask_s(
            _mask_for(p, m, types_present), r, out)
    return out


def pdf_bsdf_s(types_present, p, sps, wo, wi, req_flags: int = BSDF.ALL):
    out = torch.zeros_like(p.c_diff)
    for _, m in _modules(types_present):
        mask = _mask_for(p, m, types_present)
        out = torch.where(mask, m.pdf_bsdf_s(p, sps, wo, wi, req_flags), out)
    return out


def emit_ss(types_present, p):
    # every family shares the emit convention (emit_strength * diffuse_color)
    return shinydiffuse.emit_s(p)


def get_specular_s(types_present, p, sps, wo):
    """Perfect specular reflect/refract branches (getSpecular) of each
    lane's family."""
    out = None
    for _, m in _modules(types_present):
        r = m.get_specular_s(p, sps, wo)
        out = r if out is None else _where_mask_s(
            _mask_for(p, m, types_present), r, out)
    return out


def transparency_ss(types_present, p, sps, wo):
    """Shadow-ray transmittance (getTransparency) of each lane's family."""
    out = zeros3(p.c_diff)
    for _, m in _modules(types_present):
        out = _where_mask_s(_mask_for(p, m, types_present),
                            m.transparency_s(p, sps, wo), out)
    return out
