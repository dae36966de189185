"""Texture table and its evaluation over the wavefront
(counterpart of core_tpu/textures/base.py).

Scope: the procedural marble, voronoi (intensity modes) and clouds
textures, with core_tpu's TextureDef fields.  Image, wood, musgrave,
distorted-noise, rgb-cube and blend textures, and voronoi colour modes,
raise NotImplementedError by name.

eval_texture(ctex, tex_id, p) -> (rgb V3 [N], alpha [N]); lanes whose
tex_id is -1 get white with alpha 1, so callers can select unconditionally.
The procedural textures read only the 3-D point, so no uv is taken.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, fields

import torch

from core_tpu_torch.textures import noise as nz
from core_tpu_torch.vec import V3, where3


class TexType(enum.IntEnum):
    CLOUDS = 0        # basictex.cc textureClouds_t
    MARBLE = 1        # textureMarble_t
    WOOD = 2          # textureWood_t
    VORONOI = 3       # textureVoronoi_t
    MUSGRAVE = 4      # textureMusgrave_t
    DISTORTED = 5     # textureDistortedNoise_t
    RGB_CUBE = 6      # rgbCube_t
    BLEND = 7         # textureBlend_t
    IMAGE = 8         # imagetex.cc textureImage_t


PORTED = (TexType.CLOUDS, TexType.MARBLE, TexType.VORONOI)


@dataclass(eq=False)
class TextureDef:
    """Host-side texture description: core_tpu's TextureDef fields for the
    ported types (procedural only, so no image fields)."""
    ttype: TexType = TexType.CLOUDS
    color1: tuple = (0.0, 0.0, 0.0)
    color2: tuple = (1.0, 1.0, 1.0)
    size: float = 1.0
    depth: int = 2                 # clouds depth / turbulence octaves
    hard: bool = False
    bias: int = 0                  # clouds: 0 none, 1 positive, 2 negative
    noise_type: str = "newperlin"
    turb: float = 1.0              # marble turbulence strength
    sharpness: float = 1.0         # marble
    shape: str = "sin"             # sin | saw | tri
    vor_type: int = nz.V_F1
    vor_metric: int = nz.DIST_REAL
    vor_mk_exp: float = 2.5
    vor_color_mode: int = 0        # 0 = intensity (the only mode ported)
    vor_weights: tuple = (1.0, 0.0, 0.0, 0.0)
    vor_iscale: float = 1.0
    name: str = ""


FIELDS = tuple(f.name for f in fields(TextureDef))


class CompiledTextures:
    """The scene's texture defs (procedural textures carry no arrays)."""

    def __init__(self, defs: list):
        for d in defs:
            check_supported(d)
        self.defs = list(defs)


def check_supported(d: TextureDef):
    if int(d.ttype) not in [int(t) for t in PORTED]:
        raise NotImplementedError(f"{TexType(int(d.ttype)).name} textures "
                                  "are not ported to core_tpu_torch yet")
    if d.ttype == TexType.VORONOI and d.vor_color_mode > 0:
        raise NotImplementedError("voronoi colour modes are not ported to "
                                  "core_tpu_torch yet")


def build_texture_set(defs: list) -> CompiledTextures:
    return CompiledTextures(defs)


def _shape_fn(shape: str, w):
    """Marble wave shapes (basictex.cc:110-128)."""
    if shape == "saw":
        w = w * (0.5 / math.pi)
        return w - torch.floor(w)
    if shape == "tri":
        w = w * (0.5 / math.pi)
        return (2.0 * (w - torch.floor(w)) - 1.0).abs()
    return 0.5 + 0.5 * torch.sin(w)


def _eval_one_float(d: TextureDef, p: V3):
    """Float intensity of one texture def at points p."""
    if d.ttype == TexType.CLOUDS:
        v = nz.turbulence(nz.generator(d.noise_type), p, d.depth, d.size,
                          d.hard)
        if d.bias:
            v = v * v
            if d.bias == 1:
                v = -v
        return v
    if d.ttype == TexType.MARBLE:
        w = (p.x + p.y + p.z) * 5.0
        if d.turb != 0.0:
            w = w + d.turb * nz.turbulence(nz.generator(d.noise_type), p,
                                           d.depth, d.size, d.hard)
        return torch.pow(_shape_fn(d.shape, w).clamp_min(1e-12), d.sharpness)
    # VORONOI (check_supported admitted nothing else)
    return d.vor_iscale * nz.voronoi(p * d.size, d.vor_type, d.vor_metric,
                                     d.vor_weights)


def eval_texture_def(d: TextureDef, p: V3):
    """(rgb, alpha) of one def: colour1 -> colour2 by the clipped value."""
    val = _eval_one_float(d, p)
    c1 = torch.tensor(d.color1, dtype=torch.float32, device=val.device)
    c2 = torch.tensor(d.color2, dtype=torch.float32, device=val.device)
    dc = c2 - c1
    vc = val.clamp(0.0, 1.0)
    return V3(c1[0] + vc * dc[0], c1[1] + vc * dc[1],
              c1[2] + vc * dc[2]), vc


def eval_texture(ctex, tex_id, p: V3):
    """(rgb V3, alpha) of per-lane texture tex_id [N] at points p; -1 lanes
    are white."""
    one = torch.ones_like(p.x)
    rgb, alpha = V3(one, one, one), one
    if ctex is None:
        return rgb, alpha
    for i, d in enumerate(ctex.defs):
        mask = tex_id == i
        if not bool(mask.any()):
            continue
        c, a = eval_texture_def(d, p)
        rgb = where3(mask, c, rgb)
        alpha = torch.where(mask, a, alpha)
    return rgb, alpha
