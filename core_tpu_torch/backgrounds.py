"""Backgrounds (counterpart of core_tpu/backgrounds.py).

Scope: the texture-mapped environment (reference
src/backgrounds/textureback.cc:30-160) with the sphere projection and a
Z-axis rotation, over image and procedural textures.  Constant, gradient,
sunsky and darksky backgrounds, and the angular projection, raise
NotImplementedError by name.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from core_tpu_torch.textures.base import eval_texture
from core_tpu_torch.vec import V3, zeros3


@dataclass(frozen=True)
class TextureBackground:
    ctex: Any                 # textures.base.CompiledTextures
    tex_id: int
    power: torch.Tensor       # []
    rot_cos: torch.Tensor     # [] cos(rotation)
    rot_sin: torch.Tensor     # []
    projection: str = "sphere"
    ibl: bool = False
    ibl_samples: int = 8


def make_texture_background(ctex, tex_id=0, power=1.0, rotation=0.0,
                            projection="sphere", ibl=False, ibl_samples=8,
                            *, device) -> TextureBackground:
    if projection != "sphere":
        raise NotImplementedError(f"the {projection!r} background projection "
                                  "is not ported to core_tpu_torch yet")
    rot = np.radians(float(rotation))

    def f(a):
        return torch.tensor(np.float32(a), device=device)

    return TextureBackground(ctex=ctex, tex_id=int(tex_id), power=f(power),
                             rot_cos=f(np.cos(rot)), rot_sin=f(np.sin(rot)),
                             projection=projection, ibl=bool(ibl),
                             ibl_samples=int(ibl_samples))


def eval_background_s(bg, d: V3) -> V3:
    """Radiance of the environment in directions d (V3 of [N])."""
    if bg is None:
        return zeros3(d.x)
    if not isinstance(bg, TextureBackground):
        raise NotImplementedError(f"background {type(bg).__name__} is not "
                                  "ported to core_tpu_torch yet")
    # rotate around Z (textureback.cc:141-147)
    x = bg.rot_cos * d.x + bg.rot_sin * d.y
    y = -bg.rot_sin * d.x + bg.rot_cos * d.y
    # spheremap (texture.h:63-85): u from the azimuth, v from the polar
    # angle; image textures read (u, v), procedural ones the direction
    u = torch.remainder(torch.atan2(y, x) / (2.0 * math.pi), 1.0)
    v = 1.0 - torch.acos(d.z.clamp(-1.0, 1.0)) / math.pi
    tid = torch.full(x.shape, bg.tex_id, dtype=torch.int32, device=x.device)
    rgb, _ = eval_texture(bg.ctex, tid, V3(x, y, d.z), (u, v))
    return rgb * bg.power
