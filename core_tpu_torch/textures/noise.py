"""Procedural noise, wavefront form
(counterpart of core_tpu/textures/noise.py).

The generators of the reference's zoo as core_tpu writes them: improved
Perlin ("newperlin"; "stdperlin" and "blender" alias it, the latter on the
point offset by (1, 1, 1)), integer-hash cell noise, Worley/voronoi
features F1..F4, F2-F1 and crackle under seven distance metrics, the
musgrave family (fBm, multifractal, heteroterrain, hybridMF, ridgedMF, with
fractional octaves) and `turbulence`.  A generator name core_tpu does not
know gives improved Perlin, as in core_tpu (basictex.cc newNoise).

core_tpu replaces the reference's permutation tables with a computable
corner hash on uint32; here the uint32 arithmetic is emulated in int64 with
`& 0xFFFFFFFF`, as sampling/qmc.py does, so every hash equals core_tpu's.
Points arrive as vec.V3 of [N] tensors.
"""
from __future__ import annotations

import math

import torch

from core_tpu_torch.vec import V3

MASK32 = 0xFFFFFFFF
_INV32 = float(2.0 ** -32)

V_F1, V_F2, V_F3, V_F4, V_F2F1, V_CRACKLE = 0, 1, 2, 3, 4, 5
DIST_REAL = 0
DIST_SQUARED = 1
DIST_MANHATTAN = 2
DIST_CHEBYCHEV = 3
DIST_MINKOVSKY_HALF = 4
DIST_MINKOVSKY_FOUR = 5
DIST_MINKOVSKY = 6


def _mul32(a, c):
    """(a * c) mod 2**32 for a in [0, 2**32) and c a constant or a tensor
    in [0, 2**32), with every partial product below 2**48 so int64 never
    overflows."""
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


def _cells(p: V3):
    """(floor components, their int64 cell coordinates)."""
    fx, fy, fz = torch.floor(p.x), torch.floor(p.y), torch.floor(p.z)
    return (fx, fy, fz), (fx.long(), fy.long(), fz.long())


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
    (fx, fy, fz), (xi, yi, zi) = _cells(p)
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


def blender_noise(p: V3):
    """blenderNoise_t: improved Perlin on the point offset by (1, 1, 1)."""
    return new_perlin(p + 1.0)


def cell_noise(p: V3):
    """Integer-hash cell noise (noise.cc cellNoise_t), exact formula: the
    int32 sum wraps like core_tpu's, then the uint32 polynomial."""
    _, (xi, yi, zi) = _cells(p)
    n = (xi + yi * 1301 + zi * 314159) & MASK32
    n = n ^ ((n << 13) & MASK32)
    n = (_mul32(n, (_mul32(_mul32(n, n), 15731) + 789221) & MASK32)
         + 1376312589) & MASK32
    return n.to(torch.float32) * _INV32


def _hashpnt(xx, yy, zz):
    """Feature point of cell (xx,yy,zz) in [0,1)^3 (core_tpu _hashpnt)."""
    h1 = _corner_hash(xx, yy, zz)
    h2 = (_mul32(h1, 0x85EBCA6B) + 0xC2B2AE35) & MASK32
    h2 = h2 ^ (h2 >> 15)
    h3 = (_mul32(h2, 0x27D4EB2F) + 0x165667B1) & MASK32
    h3 = h3 ^ (h3 >> 15)
    return (h1.to(torch.float32) * _INV32, h2.to(torch.float32) * _INV32,
            h3.to(torch.float32) * _INV32)


def cell_noise_color(p: V3) -> V3:
    """cellNoiseColor (noise.cc): rgb from the cell's feature point."""
    _, cells = _cells(p)
    return V3(*_hashpnt(*cells))


def _vdist(xd, yd, zd, metric: int, mk_exp: float):
    """Distance of a feature point under one of the reference's metrics
    (core_tpu's _vdist, term for term)."""
    if metric == DIST_SQUARED:
        return xd * xd + yd * yd + zd * zd
    ax, ay, az = xd.abs(), yd.abs(), zd.abs()
    if metric == DIST_MANHATTAN:
        return ax + ay + az
    if metric == DIST_CHEBYCHEV:
        return torch.maximum(ax, torch.maximum(ay, az))
    if metric == DIST_MINKOVSKY_HALF:
        d = torch.sqrt(ax) + torch.sqrt(ay) + torch.sqrt(az)
        return d * d
    if metric == DIST_MINKOVSKY_FOUR:
        # x ** 4 as XLA's integer power computes it: (x * x) squared
        def p4(a):
            a2 = a * a
            return a2 * a2
        return torch.sqrt(torch.sqrt(p4(ax) + p4(ay) + p4(az)))
    if metric == DIST_MINKOVSKY:
        return (ax.pow(mk_exp) + ay.pow(mk_exp) + az.pow(mk_exp)) \
            .pow(1.0 / mk_exp)
    return torch.sqrt(xd * xd + yd * yd + zd * zd)     # DIST_REAL


def voronoi_features(p: V3, metric: int = DIST_REAL, mk_exp: float = 2.5,
                     points: bool = False):
    """The 4 smallest feature distances [N, 4], ascending
    (voronoi_t::getFeatures over the 27 neighbouring cells); with
    `points`, also their feature points as a V3 of [N, 4] tensors.  The
    sort is stable, as core_tpu's argsort, so ties keep cell order."""
    _, (xi, yi, zi) = _cells(p)
    ds, pts = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                xx, yy, zz = xi + dx, yi + dy, zi + dz
                hx, hy, hz = _hashpnt(xx, yy, zz)
                fp = (hx + xx.to(torch.float32), hy + yy.to(torch.float32),
                      hz + zz.to(torch.float32))
                ds.append(_vdist(p.x - fp[0], p.y - fp[1], p.z - fp[2],
                                 metric, mk_exp))
                pts.append(fp)
    dall = torch.stack(ds, dim=-1)                        # [N, 27]
    if not points:
        return torch.sort(dall, dim=-1).values[..., :4]
    da, order = torch.sort(dall, dim=-1, stable=True)
    order = order[..., :4]
    pa = V3(*(torch.gather(torch.stack([q[c] for q in pts], dim=-1), -1,
                           order) for c in range(3)))
    return da[..., :4], pa


def voronoi(p: V3, vtype: int = V_F1, metric: int = DIST_REAL,
            mk_exp: float = 2.5, w=(1.0, 0.0, 0.0, 0.0)):
    """voronoi_t::operator() — weighted combination of F1..F4."""
    da = voronoi_features(p, metric, mk_exp)
    if vtype in (V_F1, V_F2, V_F3, V_F4):
        return da[..., vtype]
    if vtype == V_F2F1:
        return da[..., 1] - da[..., 0]
    if vtype == V_CRACKLE:
        return (da[..., 1] - da[..., 0]).clamp(0.0, 1.0)
    aw = [abs(x) for x in w]
    return aw[0] * da[..., 0] + aw[1] * da[..., 1] + aw[2] * da[..., 2] \
        + aw[3] * da[..., 3]


def _voronoi_gen(vtype: int):
    return lambda p: voronoi(p, vtype)


def generator(name: str):
    """Noise generator by reference type name (basictex.cc newNoise)."""
    name = (name or "newperlin").lower()
    if name in ("stdperlin", "std_perlin"):
        return std_perlin
    if name in ("blender", "blendernoise"):
        return blender_noise
    if name == "cellnoise":
        return cell_noise
    # the longer prefix first: voronoi_f2f1 also starts with voronoi_f2
    for prefix, vtype in (("voronoi_f1", V_F1), ("voronoi_f2f1", V_F2F1),
                          ("voronoi_f2", V_F2), ("voronoi_f3", V_F3),
                          ("voronoi_f4", V_F4),
                          ("voronoi_crackle", V_CRACKLE)):
        if name.startswith(prefix):
            return _voronoi_gen(vtype)
    return new_perlin


def signed(ngen, p: V3):
    """getSignedNoise (noise.h:259)."""
    return 2.0 * ngen(p) - 1.0


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


# ---- musgrave family (noise.cc fBm_t etc.), as core_tpu writes them: the
# octave weights are Python floats, a fractional last octave is added with
# weight octaves - floor(octaves) ----

def _rmd(octaves: float) -> float:
    return octaves - math.floor(octaves)


def fbm(ngen, p: V3, h: float, lacunarity: float, octaves: float):
    value = None
    pwr = 1.0
    pw_hl = lacunarity ** (-h)
    tp = p
    for _ in range(int(octaves)):
        term = signed(ngen, tp) * pwr
        value = term if value is None else value + term
        pwr *= pw_hl
        tp = tp * lacunarity
    if value is None:
        value = torch.zeros_like(p.x)
    rmd = _rmd(octaves)
    if rmd != 0.0:
        value = value + rmd * signed(ngen, tp) * pwr
    return value


def multifractal(ngen, p: V3, h: float, lacunarity: float, octaves: float):
    value = None
    pwr = 1.0
    pw_hl = lacunarity ** (-h)
    tp = p
    for _ in range(int(octaves)):
        term = pwr * signed(ngen, tp) + 1.0
        value = term if value is None else value * term
        pwr *= pw_hl
        tp = tp * lacunarity
    if value is None:
        value = torch.ones_like(p.x)
    rmd = _rmd(octaves)
    if rmd != 0.0:
        value = value * (rmd * signed(ngen, tp) * pwr + 1.0)
    return value


def hetero_terrain(ngen, p: V3, h: float, lacunarity: float,
                   octaves: float, offset: float):
    pw_hl = lacunarity ** (-h)
    pwr = pw_hl
    tp = p
    value = offset + signed(ngen, tp)
    tp = tp * lacunarity
    for _ in range(1, int(octaves)):
        value = value + (signed(ngen, tp) + offset) * pwr * value
        pwr *= pw_hl
        tp = tp * lacunarity
    rmd = _rmd(octaves)
    if rmd != 0.0:
        value = value + rmd * (signed(ngen, tp) + offset) * pwr * value
    return value


def hybrid_mfractal(ngen, p: V3, h: float, lacunarity: float,
                    octaves: float, offset: float, gain: float):
    pw_hl = lacunarity ** (-h)
    pwr = pw_hl
    tp = p
    result = signed(ngen, tp) + offset
    weight = gain * result
    tp = tp * lacunarity
    for _ in range(1, int(octaves)):
        w = weight.clamp_max(1.0)
        sig = (signed(ngen, tp) + offset) * pwr
        pwr *= pw_hl
        result = result + w * sig
        weight = w * gain * sig
        tp = tp * lacunarity
    rmd = _rmd(octaves)
    if rmd != 0.0:
        result = result + rmd * (signed(ngen, tp) + offset) * pwr
    return result


def ridged_mfractal(ngen, p: V3, h: float, lacunarity: float,
                    octaves: float, offset: float, gain: float):
    pw_hl = lacunarity ** (-h)
    pwr = pw_hl
    tp = p
    sig = offset - signed(ngen, tp).abs()
    sig = sig * sig
    result = sig
    for _ in range(1, int(octaves)):
        tp = tp * lacunarity
        weight = (sig * gain).clamp(0.0, 1.0)
        sig = offset - signed(ngen, tp).abs()
        sig = sig * sig * weight
        result = result + sig * pwr
        pwr *= pw_hl
    return result
