"""Texture table and its evaluation over the wavefront
(counterpart of core_tpu/textures/base.py).

Scope: image textures (reference imagetex.cc: an atlas of every image of a
set, the V flip, the repeat / checker / extend / clip wraps, point,
bilinear and bicubic lookups and trilinear mip filtering under a
ray-differential footprint) and the procedural marble, voronoi (intensity
modes) and clouds textures, with core_tpu's TextureDef fields.  Wood,
musgrave, distorted-noise, rgb-cube and blend textures, and voronoi colour
modes, raise NotImplementedError by name.

eval_texture(ctex, tex_id, p, uv, lod=None) -> (rgb V3 [N], alpha [N]);
lanes whose tex_id is -1 get white with alpha 1, so callers can select
unconditionally.  p is the 3-D point the procedural textures read, uv a
(u, v) pair of [N] tensors the image textures read, lod an optional [N]
UV-space footprint (differentials.texture_lod) that selects mip levels.
"""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, fields
from typing import Optional

import numpy as np
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


PORTED = (TexType.CLOUDS, TexType.MARBLE, TexType.VORONOI, TexType.IMAGE)
INTERPOLATE = ("none", "bilinear", "bicubic")
CLIP_MODES = ("repeat", "checker", "extend", "clip", "clipcube")


@dataclass(eq=False)
class TextureDef:
    """Host-side texture description: core_tpu's TextureDef fields for the
    ported types."""
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
    image: Optional[np.ndarray] = None   # [H,W,3/4] float, linear
    interpolate: str = "bilinear"  # none | bilinear | bicubic
    clip_mode: str = "repeat"      # repeat | checker | extend | clip(cube)
    xrepeat: int = 1
    yrepeat: int = 1
    gamma: float = 1.0
    use_alpha: bool = True
    name: str = ""


# the plain settings of a def (the image array is not one of them)
FIELDS = tuple(f.name for f in fields(TextureDef) if f.name != "image")
MAX_MIP_LEVELS = 8


class CompiledTextures:
    """The scene's texture defs and, where any is an image, the device
    arrays of their images: `atlas` [K, H, W, 4] (each image zero-padded
    to the largest), and `mips`, one [K, H >> l, W >> l, 4] array per level
    l = 1..n, each level a 2x2 box downsample of the one before, per true
    image size so that padding never bleeds in.  `slots[i]` is def i's
    atlas slot (-1 for a procedural def), `hw[l][k]` the true (h, w) of
    slot k at level l (level 0 the atlas).  The slot is kept here, per
    def index of this set, and not on the def: core_tpu stamps it on the
    shared TextureDef, so a def in two sets (a textureback's own and the
    scene's) carries the slot of whichever set was built last."""

    def __init__(self, defs: list, atlas=None, mips=(), slots=(), hw=()):
        self.defs = list(defs)
        self.atlas = atlas
        self.mips = tuple(mips)
        self.slots = tuple(slots)
        self.hw = tuple(hw)


def check_supported(d: TextureDef):
    if int(d.ttype) not in [int(t) for t in PORTED]:
        raise NotImplementedError(f"{TexType(int(d.ttype)).name} textures "
                                  "are not ported to core_tpu_torch yet")
    if d.ttype == TexType.VORONOI and d.vor_color_mode > 0:
        raise NotImplementedError("voronoi colour modes are not ported to "
                                  "core_tpu_torch yet")
    if d.ttype == TexType.IMAGE:
        if d.image is None:
            raise ValueError(f"image texture {d.name!r} has no image")
        if d.interpolate not in INTERPOLATE:
            raise ValueError(f"image texture {d.name!r}: interpolate "
                             f"{d.interpolate!r} is not one of {INTERPOLATE}")
        if d.clip_mode not in CLIP_MODES:
            raise ValueError(f"image texture {d.name!r}: clipping "
                             f"{d.clip_mode!r} is not one of {CLIP_MODES}")


def _downsample2(im):
    """2x2 box average; an odd trailing row or column is dropped, and a
    1-pixel-thin image keeps its first pixel (core_tpu's _downsample2)."""
    h, w = im.shape[:2]
    h2, w2 = max(1, h // 2), max(1, w // 2)
    if h >= 2 and w >= 2:
        im = im[:h2 * 2, :w2 * 2]
        return 0.25 * (im[0::2, 0::2] + im[1::2, 0::2]
                       + im[0::2, 1::2] + im[1::2, 1::2])
    return im[:h2, :w2]


def _prep_image(d: TextureDef) -> np.ndarray:
    """[H, W, 4] float32: grey to RGB, alpha 1 appended to RGB, the gamma
    pre-power on RGB (core_tpu's build_texture_set, in the same numpy)."""
    im = np.asarray(d.image, np.float32)
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    if im.shape[-1] == 3:
        im = np.concatenate([im, np.ones_like(im[..., :1])], -1)
    if d.gamma != 1.0:
        im = im.copy()
        im[..., :3] = np.power(np.maximum(im[..., :3], 0.0), d.gamma)
    return im


def _pad_stack(imgs, h, w) -> np.ndarray:
    out = np.zeros((len(imgs), h, w, 4), np.float32)
    for k, im in enumerate(imgs):
        out[k, :im.shape[0], :im.shape[1]] = im
    return out


def build_texture_set(defs: list, device) -> CompiledTextures:
    """The compiled set of `defs` on `device`: the image atlas and its mip
    chain (host-side numpy, as core_tpu builds them), levels down to the
    largest image's 1-pixel side or MAX_MIP_LEVELS."""
    for d in defs:
        check_supported(d)
    prepped, slots = [], []
    for d in defs:
        if d.ttype == TexType.IMAGE:
            slots.append(len(prepped))
            prepped.append(_prep_image(d))
        else:
            slots.append(-1)
    if not prepped:
        return CompiledTextures(defs, slots=slots)
    mh = max(im.shape[0] for im in prepped)
    mw = max(im.shape[1] for im in prepped)

    def dev(a):
        return torch.from_numpy(a).to(device)

    atlas = dev(_pad_stack(prepped, mh, mw))
    hw = [[im.shape[:2] for im in prepped]]
    mips, level = [], prepped
    while min(mh, mw) >= 2 and len(mips) < MAX_MIP_LEVELS:
        mh, mw = max(1, mh // 2), max(1, mw // 2)
        level = [_downsample2(im) for im in level]
        mips.append(dev(_pad_stack(level, mh, mw)))
        hw.append([im.shape[:2] for im in level])
    return CompiledTextures(defs, atlas, mips, slots, hw)


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
    # VORONOI, the last procedural type check_supported admits
    return d.vor_iscale * nz.voronoi(p * d.size, d.vor_type, d.vor_metric,
                                     d.vor_weights)


def _fetch(img, y, x):
    """[N, 4] texels (y, x) of one [H, W, 4] level of one slot."""
    return img[y.long(), x.long()]


def _bilinear_tap(img, h: int, w: int, u, v):
    """One bilinear fetch from a [H, W, 4] level, as the reference's
    interpolateImage (imagetex.cc:48-92) and core_tpu's _bilinear_tap do
    it: the frac() wrap, pixel centres at (i + 0.5) / res (the -0.5
    shift), the C (int) truncation toward zero at the low border, and
    +1-clamped neighbour taps."""
    xf = float(w) * (u - torch.floor(u)) - 0.5
    yf = float(h) * (v - torch.floor(v)) - 0.5
    x0 = xf.to(torch.int32).clamp(0, w - 1)
    y0 = yf.to(torch.int32).clamp(0, h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    y1 = (y0 + 1).clamp_max(h - 1)
    tx = (xf - torch.floor(xf))[:, None]
    ty = (yf - torch.floor(yf))[:, None]
    return (_fetch(img, y0, x0) * (1 - tx) * (1 - ty)
            + _fetch(img, y0, x1) * tx * (1 - ty)
            + _fetch(img, y1, x0) * (1 - tx) * ty
            + _fetch(img, y1, x1) * tx * ty)


def _cubic(y0, y1, y2, y3, mu):
    """utilities/interpolation.h CubicInterpolate."""
    a0 = y3 - y2 - y0 + y1
    a1 = y0 - y1 - a0
    a2 = y2 - y0
    return a0 * mu * mu * mu + a1 * mu * mu + a2 * mu + y1


def _bicubic(img, h: int, w: int, u, v):
    """4x4 cubic lookup (imagetex.cc INTP_BICUBIC), centres and truncation
    as in _bilinear_tap."""
    xf = float(w) * (u - torch.floor(u)) - 0.5
    yf = float(h) * (v - torch.floor(v)) - 0.5
    x1 = xf.to(torch.int32).clamp(0, w - 1)
    y1 = yf.to(torch.int32).clamp(0, h - 1)
    tx = (xf - torch.floor(xf))[:, None]
    ty = (yf - torch.floor(yf))[:, None]
    rows = []
    for dy in (-1, 0, 1, 2):
        yy = (y1 + dy).clamp(0, h - 1)
        taps = [_fetch(img, yy, (x1 + dx).clamp(0, w - 1))
                for dx in (-1, 0, 1, 2)]
        rows.append(_cubic(*taps, tx))
    return _cubic(*rows, ty)


def _eval_image(d: TextureDef, ctex: CompiledTextures, slot: int, uv,
                lod=None):
    """[N, 4] RGBA of image def d (atlas slot `slot`) at uv, as core_tpu's
    _eval_image (imagetex.cc doMapping / interpolateImage): V flipped
    (image row 0 is the top of the picture, v = 0 its bottom), then the
    clip mode, then a point, bicubic, trilinear-mip (where lod is given
    and the set has mips) or bilinear lookup; alpha and colour are 0
    outside [0, 1]^2 in the clip modes."""
    h, w = ctex.hw[0][slot]
    u = uv[0] * d.xrepeat
    v = (1.0 - uv[1]) * d.yrepeat
    inside = None
    if d.clip_mode == "extend":
        u = u.clamp(0.0, 0.99999)
        v = v.clamp(0.0, 0.99999)
    elif d.clip_mode in ("clip", "clipcube"):
        inside = (u >= 0) & (u <= 1) & (v >= 0) & (v <= 1)
        u = u.clamp(0.0, 1.0)
        v = v.clamp(0.0, 1.0)
    # repeat and checker wrap inside the taps' frac() (imagetex.cc:55-56)
    img = ctex.atlas[slot]
    if d.interpolate == "none":
        # no -0.5 shift in the point-sampled path (imagetex.cc:55-64)
        xi = (float(w) * (u - torch.floor(u))).to(torch.int32) \
            .clamp(0, w - 1)
        yi = (float(h) * (v - torch.floor(v))).to(torch.int32) \
            .clamp(0, h - 1)
        out = _fetch(img, yi, xi)
    elif d.interpolate == "bicubic":
        out = _bicubic(img, h, w, u, v)
    elif lod is not None and ctex.mips:
        # trilinear mip filtering driven by the differential footprint
        n_levels = len(ctex.mips)
        fp_texels = lod * float(max(w * d.xrepeat, h * d.yrepeat))
        lvl = torch.log2(fp_texels.clamp_min(1e-9)).clamp(0.0,
                                                          float(n_levels))
        l0 = torch.floor(lvl).to(torch.int32)
        frac = (lvl - l0.to(torch.float32))[:, None]
        taps = [_bilinear_tap(img, h, w, u, v)]
        for li, level in enumerate(ctex.mips, start=1):
            lh, lw = ctex.hw[li][slot]
            taps.append(_bilinear_tap(level[slot], lh, lw, u, v))
        c0, c1 = taps[0], taps[min(1, n_levels)]
        for li in range(1, n_levels + 1):
            sel = (l0 == li)[:, None]
            c0 = torch.where(sel, taps[li], c0)
            c1 = torch.where(sel, taps[min(li + 1, n_levels)], c1)
        out = c0 * (1.0 - frac) + c1 * frac
    else:
        out = _bilinear_tap(img, h, w, u, v)
    if inside is not None:
        out = torch.where(inside[:, None], out, 0.0)
    return out


def eval_texture_def(ctex: CompiledTextures, i: int, p: V3, uv, lod=None):
    """(rgb, alpha) of def i of the set at points p / uv coordinates uv;
    a procedural def goes colour1 -> colour2 by its clipped value."""
    d = ctex.defs[i]
    if d.ttype == TexType.IMAGE:
        rgba = _eval_image(d, ctex, ctex.slots[i], uv, lod)
        return V3(rgba[:, 0], rgba[:, 1], rgba[:, 2]), rgba[:, 3]
    val = _eval_one_float(d, p)
    c1 = torch.tensor(d.color1, dtype=torch.float32, device=val.device)
    c2 = torch.tensor(d.color2, dtype=torch.float32, device=val.device)
    dc = c2 - c1
    vc = val.clamp(0.0, 1.0)
    return V3(c1[0] + vc * dc[0], c1[1] + vc * dc[1],
              c1[2] + vc * dc[2]), vc


def eval_texture(ctex, tex_id, p: V3, uv, lod=None):
    """(rgb V3, alpha) of per-lane texture tex_id [N] at points p and uv
    coordinates uv ((u, v), [N] each); -1 lanes are white."""
    one = torch.ones_like(p.x)
    rgb, alpha = V3(one, one, one), one
    if ctex is None:
        return rgb, alpha
    for i in range(len(ctex.defs)):
        mask = tex_id == i
        if not bool(mask.any()):
            continue
        c, a = eval_texture_def(ctex, i, p, uv, lod)
        rgb = where3(mask, c, rgb)
        alpha = torch.where(mask, a, alpha)
    return rgb, alpha
