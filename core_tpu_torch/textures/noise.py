"""Procedural noise, wavefront form
(counterpart of core_tpu/textures/noise.py).

Scope: what the marble, voronoi and clouds textures call: improved Perlin
("newperlin"; "stdperlin" aliases it, as in core_tpu), Worley/voronoi
features with the real (Euclidean) metric, and `turbulence`.  Other
generators and metrics raise NotImplementedError by name.

core_tpu replaces the reference's permutation tables with a computable
corner hash on uint32; here the uint32 arithmetic is emulated in int64 with
`& 0xFFFFFFFF`, as sampling/qmc.py does, so every hash equals core_tpu's.
Points arrive as vec.V3 of [N] tensors.
"""
from __future__ import annotations

import torch

from core_tpu_torch.vec import V3

MASK32 = 0xFFFFFFFF
_INV32 = float(2.0 ** -32)

V_F1, V_F2, V_F3, V_F4, V_F2F1, V_CRACKLE = 0, 1, 2, 3, 4, 5
DIST_REAL = 0


def _mul32(a, c: int):
    """(a * c) mod 2**32 for a in [0, 2**32) and a constant c, with every
    partial product below 2**48 so int64 never overflows."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def _corner_hash(xi, yi, zi):
    """core_tpu's Wang-style corner hash of integer cell coords (uint32)."""
    h = (_mul32(xi & MASK32, 0x8DA6B343) ^ _mul32(yi & MASK32, 0xD8163841)
         ^ _mul32(zi & MASK32, 0xCB1AB31F))
    h = h ^ (h >> 13)
    h = _mul32(h, 0x9E3779B1)
    return h ^ (h >> 16)


def _fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _grad(h, x, y, z):
    """Improved-Perlin gradient (noise.cc grad)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def new_perlin(p: V3):
    """Improved Perlin noise -> [0,1] (noise.cc newPerlin_t)."""
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    xi, yi, zi = fx.long(), fy.long(), fz.long()
    x = p.x - fx
    y = p.y - fy
    z = p.z - fz
    u = _fade(x)
    v = _fade(y)
    w = _fade(z)

    def g(dx, dy, dz):
        return _grad(_corner_hash(xi + dx, yi + dy, zi + dz),
                     x - dx, y - dy, z - dz)

    def lerp(t, a, b):
        return a + t * (b - a)

    nv = lerp(w,
              lerp(v, lerp(u, g(0, 0, 0), g(1, 0, 0)),
                   lerp(u, g(0, 1, 0), g(1, 1, 0))),
              lerp(v, lerp(u, g(0, 0, 1), g(1, 0, 1)),
                   lerp(u, g(0, 1, 1), g(1, 1, 1))))
    return 0.5 + 0.5 * nv


std_perlin = new_perlin


def _hashpnt(xx, yy, zz):
    """Feature point of cell (xx,yy,zz) in [0,1)^3 (core_tpu _hashpnt)."""
    h1 = _corner_hash(xx, yy, zz)
    h2 = (_mul32(h1, 0x85EBCA6B) + 0xC2B2AE35) & MASK32
    h2 = h2 ^ (h2 >> 15)
    h3 = (_mul32(h2, 0x27D4EB2F) + 0x165667B1) & MASK32
    h3 = h3 ^ (h3 >> 15)
    return (h1.to(torch.float32) * _INV32, h2.to(torch.float32) * _INV32,
            h3.to(torch.float32) * _INV32)


def voronoi_features(p: V3, metric: int = DIST_REAL):
    """The 4 smallest feature distances [N, 4], ascending
    (voronoi_t::getFeatures over the 27 neighbouring cells)."""
    if metric != DIST_REAL:
        raise NotImplementedError(f"voronoi distance metric {metric} is not "
                                  "ported to core_tpu_torch yet")
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    xi, yi, zi = fx.long(), fy.long(), fz.long()
    ds = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                xx, yy, zz = xi + dx, yi + dy, zi + dz
                hx, hy, hz = _hashpnt(xx, yy, zz)
                xd = p.x - (hx + xx.to(torch.float32))
                yd = p.y - (hy + yy.to(torch.float32))
                zd = p.z - (hz + zz.to(torch.float32))
                ds.append(torch.sqrt(xd * xd + yd * yd + zd * zd))
    return torch.sort(torch.stack(ds, dim=-1), dim=-1).values[..., :4]


def voronoi(p: V3, vtype: int = V_F1, metric: int = DIST_REAL,
            w=(1.0, 0.0, 0.0, 0.0)):
    """voronoi_t::operator() — weighted combination of F1..F4."""
    da = voronoi_features(p, metric)
    if vtype in (V_F1, V_F2, V_F3, V_F4):
        return da[..., vtype]
    if vtype == V_F2F1:
        return da[..., 1] - da[..., 0]
    if vtype == V_CRACKLE:
        return (da[..., 1] - da[..., 0]).clamp(0.0, 1.0)
    aw = [abs(x) for x in w]
    return aw[0] * da[..., 0] + aw[1] * da[..., 1] + aw[2] * da[..., 2] \
        + aw[3] * da[..., 3]


def generator(name: str):
    """Noise generator by reference type name (basictex.cc newNoise)."""
    name = (name or "newperlin").lower()
    if name in ("newperlin", "new_perlin"):
        return new_perlin
    if name in ("stdperlin", "std_perlin"):
        return std_perlin
    raise NotImplementedError(f"noise generator {name!r} is not ported to "
                              "core_tpu_torch yet")


def turbulence(ngen, p: V3, octaves: int, size: float, hard: bool):
    """Half-amplitude double-frequency turbulence (noise.cc turbulence)."""
    tp = p * size
    amp = 1.0
    total = None
    for _ in range(int(octaves) + 1):
        val = ngen(tp)
        if hard:
            val = (2.0 * val - 1.0).abs()
        total = val * amp if total is None else total + amp * val
        amp *= 0.5
        tp = tp * 2.0
    oct_ = int(octaves)
    return total * ((1 << oct_) / float((1 << (oct_ + 1)) - 1))
