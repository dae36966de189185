"""Material system: parameter tables + per-hit rows
(counterpart of core_tpu/materials/base.py).

All materials live in one table of parameter columns (MaterialTable, the
same columns as core_tpu's); per-hit rows are fetched with an index gather
by material id.  Each BSDF family is a set of functions over the whole
wavefront, selected by type mask in dispatch.py.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from core_tpu_torch.vec import V3


class BSDF:
    """Bitfield matching the reference's BSDF_t flags (material.h:49-65)."""
    NONE = 0
    SPECULAR = 1 << 0
    GLOSSY = 1 << 1
    DIFFUSE = 1 << 2
    DISPERSIVE = 1 << 3
    REFLECT = 1 << 4
    TRANSMIT = 1 << 5
    FILTER = 1 << 6
    EMIT = 1 << 7
    VOLUMETRIC = 1 << 8
    TRANSLUCENT = 1 << 9
    ALL_SPECULAR = SPECULAR | REFLECT | TRANSMIT
    ALL = SPECULAR | GLOSSY | DIFFUSE | DISPERSIVE | REFLECT | TRANSMIT | FILTER
    # the reference's allBSDFIntersect (mcintegrator.cc:41)
    INTERSECT = GLOSSY | DIFFUSE | DISPERSIVE | REFLECT | TRANSMIT


class MatType(enum.IntEnum):
    """Material families (one per reference plugin, src/materials/)."""
    SHINY_DIFFUSE = 0
    GLOSSY = 1
    COATED_GLOSSY = 2
    GLASS = 3
    ROUGH_GLASS = 4
    BLEND = 5
    MASK = 6
    TRANSLUCENT = 7


class MaterialTable(NamedTuple):
    """Stacked per-material parameter columns, [M, ...] each."""
    mtype: torch.Tensor           # [M] i32
    diffuse_color: torch.Tensor   # [M,3]
    mirror_color: torch.Tensor    # [M,3]
    strengths: torch.Tensor       # [M,4] mirror, transparency, translucency, diffuse
    emit_strength: torch.Tensor   # [M]
    transmit_filter: torch.Tensor  # [M]
    ior: torch.Tensor             # [M]
    fresnel: torch.Tensor         # [M] bool
    oren_nayar: torch.Tensor      # [M,2] A,B coefficients (A=1,B=0 => Lambert)
    glossy_color: torch.Tensor    # [M,3]
    glossy_reflect: torch.Tensor  # [M]
    exponent: torch.Tensor        # [M,2]
    as_diffuse: torch.Tensor      # [M] bool
    filter_color: torch.Tensor    # [M,3]
    absorption: torch.Tensor      # [M,3]
    dispersion: torch.Tensor      # [M]
    alpha_rough: torch.Tensor     # [M]
    sub_mat: torch.Tensor         # [M,2] i32
    blend_val: torch.Tensor       # [M]
    flags: torch.Tensor           # [M] i32 BSDF flags
    diffuse_tex: torch.Tensor     # [M] i32
    blend_tex: torch.Tensor       # [M] i32
    sigma_s: torch.Tensor         # [M,3]
    sss_g: torch.Tensor           # [M]


@dataclass
class MaterialDef:
    """Host-side material description; compiled into MaterialTable rows.
    Same fields and defaults as core_tpu's MaterialDef."""
    mtype: MatType = MatType.SHINY_DIFFUSE
    diffuse_color: tuple = (0.8, 0.8, 0.8)
    mirror_color: tuple = (1.0, 1.0, 1.0)
    mirror_strength: float = 0.0
    transparency: float = 0.0
    translucency: float = 0.0
    diffuse_strength: float = 1.0
    emit_strength: float = 0.0
    transmit_filter: float = 1.0
    ior: float = 1.33
    fresnel: bool = False
    oren_nayar_sigma: Optional[float] = None
    glossy_color: tuple = (1.0, 1.0, 1.0)
    glossy_reflect: float = 0.0
    exp_u: float = 50.0
    exp_v: float = 50.0
    as_diffuse: bool = True
    filter_color: tuple = (1.0, 1.0, 1.0)
    absorption: tuple = (0.0, 0.0, 0.0)
    dispersion: float = 0.0
    alpha_rough: float = 0.1
    sub_mat0: int = -1
    sub_mat1: int = -1
    blend_val: float = 0.5
    diffuse_tex: int = -1
    blend_tex: int = -1
    sigma_s: tuple = (0.0, 0.0, 0.0)
    sss_g: float = 0.0
    fake_shadows: bool = False
    name: str = ""

    def bsdf_flags(self) -> int:
        """shinyDiffuseMat_t::config flag accumulation
        (shinydiffuse.cc:28-99) and the other families' constructors, as
        core_tpu's MaterialDef.bsdf_flags gives them."""
        if self.mtype == MatType.GLASS:
            # FILTER only with fake_shadows (glass.cc:60-62)
            f = BSDF.ALL_SPECULAR
            if self.fake_shadows:
                f |= BSDF.FILTER
            if self.dispersion > 0.0:
                f |= BSDF.DISPERSIVE
            return f
        if self.mtype == MatType.ROUGH_GLASS:
            f = BSDF.GLOSSY | BSDF.REFLECT | BSDF.TRANSMIT
            if self.fake_shadows:
                f |= BSDF.FILTER    # roughglass.cc:34-35
            return f
        if self.mtype in (MatType.BLEND, MatType.MASK):
            return BSDF.ALL         # the picked row's flags apply per hit
        if self.mtype == MatType.TRANSLUCENT:
            # a glossy + diffuse surface over the SSS medium
            # (core_tpu materials/base.py:156-157)
            return BSDF.DIFFUSE | BSDF.GLOSSY | BSDF.REFLECT \
                | BSDF.TRANSLUCENT
        if self.mtype in (MatType.GLOSSY, MatType.COATED_GLOSSY):
            f = BSDF.GLOSSY | BSDF.REFLECT
            if self.diffuse_strength > 0.0:
                f |= BSDF.DIFFUSE
            if self.mtype == MatType.COATED_GLOSSY:
                f |= BSDF.SPECULAR
            return f
        if self.mtype != MatType.SHINY_DIFFUSE:
            raise NotImplementedError(
                f"material family {MatType(self.mtype).name} is not ported "
                "to core_tpu_torch yet")
        f = 0
        acc = 1.0
        if self.mirror_strength > 1e-5:
            f |= BSDF.SPECULAR | BSDF.REFLECT
            if not self.fresnel:
                acc = 1.0 - self.mirror_strength
        if self.transparency * acc > 1e-5:
            f |= BSDF.TRANSMIT | BSDF.FILTER
            acc *= 1.0 - self.transparency
        if self.translucency * acc > 1e-5:
            f |= BSDF.DIFFUSE | BSDF.TRANSMIT
            acc *= 1.0 - self.translucency
        if self.diffuse_strength * acc > 1e-5:
            f |= BSDF.DIFFUSE | BSDF.REFLECT
        if self.emit_strength > 0.0:
            f |= BSDF.EMIT
        return f


def build_material_table(defs: list[MaterialDef], device) -> MaterialTable:
    if not defs:
        defs = [MaterialDef()]
    n = len(defs)

    def col(fn, shape=(), dtype=np.float32):
        a = np.zeros((n,) + shape, dtype)
        for i, d in enumerate(defs):
            a[i] = fn(d)
        return torch.from_numpy(a).to(device)

    def on_ab(d: MaterialDef):
        if d.oren_nayar_sigma is None:
            return (1.0, 0.0)
        s2 = d.oren_nayar_sigma ** 2
        return (1.0 - 0.5 * s2 / (s2 + 0.33), 0.45 * s2 / (s2 + 0.09))

    return MaterialTable(
        mtype=col(lambda d: int(d.mtype), dtype=np.int32),
        diffuse_color=col(lambda d: d.diffuse_color, (3,)),
        mirror_color=col(lambda d: d.mirror_color, (3,)),
        strengths=col(lambda d: (d.mirror_strength, d.transparency,
                                 d.translucency, d.diffuse_strength), (4,)),
        emit_strength=col(lambda d: d.emit_strength),
        transmit_filter=col(lambda d: d.transmit_filter),
        ior=col(lambda d: d.ior),
        fresnel=col(lambda d: d.fresnel, dtype=bool),
        oren_nayar=col(on_ab, (2,)),
        glossy_color=col(lambda d: d.glossy_color, (3,)),
        glossy_reflect=col(lambda d: d.glossy_reflect),
        exponent=col(lambda d: (d.exp_u, d.exp_v), (2,)),
        as_diffuse=col(lambda d: d.as_diffuse, dtype=bool),
        filter_color=col(lambda d: d.filter_color, (3,)),
        absorption=col(lambda d: d.absorption, (3,)),
        dispersion=col(lambda d: d.dispersion),
        alpha_rough=col(lambda d: d.alpha_rough),
        sub_mat=col(lambda d: (d.sub_mat0, d.sub_mat1), (2,), np.int32),
        blend_val=col(lambda d: d.blend_val),
        flags=col(lambda d: d.bsdf_flags(), dtype=np.int32),
        diffuse_tex=col(lambda d: d.diffuse_tex, dtype=np.int32),
        blend_tex=col(lambda d: d.blend_tex, dtype=np.int32),
        sigma_s=col(lambda d: d.sigma_s, (3,)),
        sss_g=col(lambda d: d.sss_g),
    )


class MatParamsS(NamedTuple):
    """Per-hit material parameters in SoA layout: the columns the ported
    families read (shiny-diffuse, glossy, glass, translucent), named as in
    core_tpu's MatParamsS.  The blend and mask composites are resolved
    before these rows leave scene.material_params_s, so their columns are
    not carried.  Beer absorption is read by the photon shoot
    (photon/map.py) and, with sigma_s and sss_g, by the SSS medium
    (integrators/sss.py), as in core_tpu."""
    mtype: torch.Tensor
    flags: torch.Tensor
    c_mirror: torch.Tensor
    c_transp: torch.Tensor
    c_transl: torch.Tensor
    c_diff: torch.Tensor
    emit_strength: torch.Tensor
    transmit_filter: torch.Tensor
    ior: torch.Tensor
    fresnel: torch.Tensor
    on_a: torch.Tensor
    on_b: torch.Tensor
    diffuse_color: V3
    mirror_color: V3
    glossy_color: V3
    filter_color: V3
    absorption: V3
    glossy_reflect: torch.Tensor
    exp_u: torch.Tensor
    exp_v: torch.Tensor
    as_diffuse: torch.Tensor
    dispersion: torch.Tensor
    alpha_rough: torch.Tensor
    sigma_s: V3
    sss_g: torch.Tensor


def gather_params_s(table: MaterialTable, mat_idx) -> MatParamsS:
    """SoA per-hit rows by index gather ([M, ...] -> [N] columns)."""
    idx = mat_idx.clamp(0, table.mtype.shape[0] - 1).long()

    def g(col):
        return col.index_select(0, idx)

    def g3(col):
        rows = col.index_select(0, idx)
        return V3(rows[:, 0].contiguous(), rows[:, 1].contiguous(),
                  rows[:, 2].contiguous())

    s = table.strengths.index_select(0, idx)
    on = table.oren_nayar.index_select(0, idx)
    ex = table.exponent.index_select(0, idx)
    return MatParamsS(
        mtype=g(table.mtype), flags=g(table.flags),
        c_mirror=s[:, 0].contiguous(), c_transp=s[:, 1].contiguous(),
        c_transl=s[:, 2].contiguous(), c_diff=s[:, 3].contiguous(),
        emit_strength=g(table.emit_strength),
        transmit_filter=g(table.transmit_filter), ior=g(table.ior),
        fresnel=g(table.fresnel), on_a=on[:, 0].contiguous(),
        on_b=on[:, 1].contiguous(),
        diffuse_color=g3(table.diffuse_color),
        mirror_color=g3(table.mirror_color),
        glossy_color=g3(table.glossy_color),
        filter_color=g3(table.filter_color),
        absorption=g3(table.absorption),
        glossy_reflect=g(table.glossy_reflect),
        exp_u=ex[:, 0].contiguous(), exp_v=ex[:, 1].contiguous(),
        as_diffuse=g(table.as_diffuse), dispersion=g(table.dispersion),
        alpha_rough=g(table.alpha_rough), sigma_s=g3(table.sigma_s),
        sss_g=g(table.sss_g))


def detach_sample(sres):
    """Detached-sampling gradient estimator: the sampled direction, its pdf
    and the 1/pdf throughput factor are constants w.r.t. scene parameters;
    only the BSDF value (col) carries gradients (core_tpu's AD contract)."""
    return sres._replace(wi=sres.wi.detach(), pdf=sres.pdf.detach(),
                         w=sres.w.detach())
