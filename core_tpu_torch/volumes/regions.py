"""Volume regions, participating media (counterpart of
core_tpu/volumes/regions.py; reference src/volumes/ and the region API of
include/core_api/volume.h:41-95).

Five region types, each an axis-aligned box with per-point sigma_a,
sigma_s and emission scaled by a density:
  UniformVolume     density 1
  ExpDensityVolume  a * exp(-b * height)
  NoiseVolume       newperlin turbulence^sharpness, covered and scaled
  GridVolume        a voxel grid, trilinear (df3 or .npy, load_density_grid)
  SkyVolume         exp(-height / scale), Rayleigh + Mie weights
Height is p.z - bmin.z in every scene, as core_tpu takes it
(regions.py:198,201).  The phase function is Schlick's
    p = (1 - k^2) / (4 pi (1 - k cos)^2),  k = 1.55 g - 0.55 g^3
(volume.h:70-74), blended with Rayleigh's for the sky.  tau is the optical
depth along rays: analytic for a uniform region, a midpoint march
((i + offset) * dt) for the others.

Everything here is SoA: points and directions are V3 of [N] tensors,
colours come back as V3.  Dispatch is on the Python type, as in core_tpu.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.textures import noise as nz
from core_tpu_torch.vec import V3, RaysS, dot3


@dataclass(frozen=True)
class UniformVolume:
    s_a: torch.Tensor     # [3]
    s_s: torch.Tensor     # [3]
    l_e: torch.Tensor     # [3]
    g: torch.Tensor       # []
    bmin: torch.Tensor    # [3]
    bmax: torch.Tensor    # [3]


@dataclass(frozen=True)
class ExpDensityVolume:
    """Density a * exp(-b * height) (ExpDensityVolume.cc)."""
    s_a: torch.Tensor
    s_s: torch.Tensor
    l_e: torch.Tensor
    g: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    a: torch.Tensor       # []
    b: torch.Tensor       # []


@dataclass(frozen=True)
class NoiseVolume:
    """Turbulence-noise density (NoiseVolume.cc)."""
    s_a: torch.Tensor
    s_s: torch.Tensor
    l_e: torch.Tensor
    g: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    sharpness: torch.Tensor
    cover: torch.Tensor
    density: torch.Tensor


@dataclass(frozen=True)
class GridVolume:
    """Voxel-grid density, trilinear (GridVolume.cc)."""
    s_a: torch.Tensor
    s_s: torch.Tensor
    l_e: torch.Tensor
    g: torch.Tensor
    bmin: torch.Tensor
    bmax: torch.Tensor
    grid: torch.Tensor    # [X, Y, Z] densities


@dataclass(frozen=True)
class SkyVolume:
    """Atmosphere-style region (SkyVolume.cc): Rayleigh + Mie scattering
    falling off with height; s_a is zero (pure scattering)."""
    s_a: torch.Tensor
    s_s: torch.Tensor     # [3] Rayleigh per channel + Mie
    l_e: torch.Tensor
    g: torch.Tensor       # Mie anisotropy
    bmin: torch.Tensor
    bmax: torch.Tensor
    s_ray: torch.Tensor   # [] Rayleigh scale
    s_mie: torch.Tensor   # [] Mie scale
    scale: torch.Tensor   # [] height falloff scale


REGIONS = (UniformVolume, ExpDensityVolume, NoiseVolume, GridVolume,
           SkyVolume)


def _mk(cls, sigma_a, sigma_s, l_e, g, bmin, bmax, device, **kw):
    def f(x, shape=None):
        a = np.array(x, np.float32)
        return torch.as_tensor(a if shape is None else a.reshape(shape),
                               device=device)

    return cls(s_a=f(sigma_a, 3), s_s=f(sigma_s, 3), l_e=f(l_e, 3), g=f(g),
               bmin=f(bmin, 3), bmax=f(bmax, 3),
               **{k: f(v) for k, v in kw.items()})


def _rgb(x):
    return np.broadcast_to(np.asarray(x, np.float32), (3,))


def make_uniform_volume(sigma_a=0.1, sigma_s=0.1, l_e=0.0, g=0.0,
                        bmin=(0, 0, 0), bmax=(1, 1, 1), *, device):
    return _mk(UniformVolume, _rgb(sigma_a), _rgb(sigma_s), _rgb(l_e), g,
               bmin, bmax, device)


def make_expdensity_volume(sigma_a=0.1, sigma_s=0.1, l_e=0.0, g=0.0,
                           bmin=(0, 0, 0), bmax=(1, 1, 1), a=1.0, b=1.0, *,
                           device):
    return _mk(ExpDensityVolume, _rgb(sigma_a), _rgb(sigma_s), _rgb(l_e), g,
               bmin, bmax, device, a=a, b=b)


def make_noise_volume(sigma_a=0.1, sigma_s=0.1, l_e=0.0, g=0.0,
                      bmin=(0, 0, 0), bmax=(1, 1, 1), sharpness=1.0,
                      cover=1.0, density=1.0, *, device):
    return _mk(NoiseVolume, _rgb(sigma_a), _rgb(sigma_s), _rgb(l_e), g,
               bmin, bmax, device, sharpness=max(sharpness, 1e-3),
               cover=cover, density=density)


def make_grid_volume(grid, sigma_a=0.1, sigma_s=0.1, l_e=0.0, g=0.0,
                     bmin=(0, 0, 0), bmax=(1, 1, 1), *, device):
    return _mk(GridVolume, _rgb(sigma_a), _rgb(sigma_s), _rgb(l_e), g,
               bmin, bmax, device, grid=np.asarray(grid, np.float32))


def make_sky_volume(s_ray=0.05, s_mie=0.01, l_e=0.0, g=0.8,
                    bmin=(0, 0, 0), bmax=(1, 1, 1), scale=None, *, device):
    """Rayleigh's 1/lambda^4 channel weights (normalised to green) times
    s_ray, plus s_mie; scale defaults to half the box's height."""
    lam = np.array([0.685, 0.535, 0.475], np.float32)
    ray_rgb = (0.535 / lam) ** 4
    total = np.float32(s_ray) * ray_rgb + np.float32(s_mie)
    if scale is None:
        scale = 0.5 * (np.asarray(bmax)[2] - np.asarray(bmin)[2] + 1e-6)
    return _mk(SkyVolume, total * 0.0, total, _rgb(l_e), g, bmin, bmax,
               device, s_ray=s_ray, s_mie=s_mie,
               scale=max(float(scale), 1e-6))


def load_density_grid(path: str) -> np.ndarray:
    """A voxel density grid [X, Y, Z] in [0, 1] (core_tpu's reader).

    POV-Ray df3 (GridVolume.cc:40-125): three big-endian uint16
    dimensions, then the voxels with x fastest, then y, then z; 1-, 2- and
    4-byte unsigned voxels are divided by their largest value.  A '.npy'
    array loads as it is."""
    if path.endswith(".npy"):
        return np.asarray(np.load(path), np.float32)
    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 6:
        raise ValueError(f"df3 file too short: {path}")
    nx, ny, nz = (int.from_bytes(raw[2 * i:2 * i + 2], "big")
                  for i in range(3))
    n_vox = nx * ny * nz
    body = raw[6:]
    if n_vox <= 0 or len(body) % n_vox != 0:
        raise ValueError(f"df3 {path}: {len(body)} bytes for "
                         f"{[nx, ny, nz]} voxels")
    bpv = len(body) // n_vox
    if bpv not in (1, 2, 4):
        raise ValueError(f"df3 {path}: unsupported {bpv} bytes/voxel")
    vals = np.frombuffer(body, dtype=f">u{bpv}").astype(np.float64)
    vals /= float(2 ** (8 * bpv) - 1)
    return np.ascontiguousarray(
        vals.reshape(nz, ny, nx).transpose(2, 1, 0).astype(np.float32))


def _inside(vol, p: V3):
    return ((p.x >= vol.bmin[0]) & (p.x <= vol.bmax[0])
            & (p.y >= vol.bmin[1]) & (p.y <= vol.bmax[1])
            & (p.z >= vol.bmin[2]) & (p.z <= vol.bmax[2]))


def _grid_density(vol: GridVolume, p: V3):
    gx, gy, gz = vol.grid.shape
    ext = (vol.bmax - vol.bmin).clamp_min(1e-9)

    def axis(c, k, n):
        f = ((c - vol.bmin[k]) / ext[k]).clamp(0, 1) * (n - 1)
        i0 = torch.floor(f).to(torch.int64)
        return i0, (i0 + 1).clamp_max(n - 1), f - i0
    x0, x1, tx = axis(p.x, 0, gx)
    y0, y1, ty = axis(p.y, 1, gy)
    z0, z1, tz = axis(p.z, 2, gz)
    flat = vol.grid.reshape(-1)

    def g(x, y, z):
        return flat.index_select(0, ((x * gy + y) * gz + z).reshape(-1)) \
            .reshape(x.shape)
    return ((g(x0, y0, z0) * (1 - tx) + g(x1, y0, z0) * tx) * (1 - ty)
            + (g(x0, y1, z0) * (1 - tx) + g(x1, y1, z0) * tx) * ty) \
        * (1 - tz) \
        + ((g(x0, y0, z1) * (1 - tx) + g(x1, y0, z1) * tx) * (1 - ty)
           + (g(x0, y1, z1) * (1 - tx) + g(x1, y1, z1) * tx) * ty) * tz


def density(vol, p: V3):
    """Density in [0, inf) at p (DensityVolume::Density); [N]."""
    if isinstance(vol, UniformVolume):
        return torch.ones_like(p.x)
    if isinstance(vol, ExpDensityVolume):
        return vol.a * torch.exp(-vol.b * (p.z - vol.bmin[2]))
    if isinstance(vol, SkyVolume):
        return torch.exp(-(p.z - vol.bmin[2]).clamp_min(0.0) / vol.scale)
    if isinstance(vol, NoiseVolume):
        t = nz.turbulence(nz.generator("newperlin"), p, 3, 1.0, False)
        d = torch.pow(t.clamp_min(1e-6), vol.sharpness)
        return vol.density * (d + vol.cover - 1.0).clamp_min(0.0)
    if isinstance(vol, GridVolume):
        return _grid_density(vol, p)
    raise NotImplementedError(f"volume region {type(vol).__name__} is not "
                              "ported to core_tpu_torch")


def _scaled(coef, vol, p: V3) -> V3:
    d = density(vol, p) * _inside(vol, p)
    return V3(coef[0] * d, coef[1] * d, coef[2] * d)


def sigma_a(vol, p: V3) -> V3:
    return _scaled(vol.s_a, vol, p)


def sigma_s(vol, p: V3) -> V3:
    return _scaled(vol.s_s, vol, p)


def sigma_t(vol, p: V3) -> V3:
    return _scaled(vol.s_a + vol.s_s, vol, p)


def emission(vol, p: V3) -> V3:
    return _scaled(vol.l_e, vol, p)


def media(vol, p: V3):
    """(sigma_t, sigma_s, emission) at p from one density evaluation, each
    equal to its own function's value (a march step needs all three)."""
    d = density(vol, p) * _inside(vol, p)

    def scale(coef):
        return V3(coef[0] * d, coef[1] * d, coef[2] * d)
    return scale(vol.s_a + vol.s_s), scale(vol.s_s), scale(vol.l_e)


def phase_hg(vol, w_l: V3, w_s: V3):
    """Schlick's phase function (volume.h:70-74); a SkyVolume blends
    Rayleigh's 3/(16 pi) (1 + cos^2) in by its scattering weights."""
    cos = dot3(w_l, w_s)
    g = vol.g
    k = 1.55 * g - 0.55 * g * g * g
    schlick = (1.0 / (4.0 * math.pi)) * (1.0 - k * k) \
        / ((1.0 - k * cos) ** 2).clamp_min(1e-9)
    if isinstance(vol, SkyVolume):
        ray_ph = 3.0 / (16.0 * math.pi) * (1.0 + cos * cos)
        wr = vol.s_ray / (vol.s_ray + vol.s_mie).clamp_min(1e-9)
        return wr * ray_ph + (1.0 - wr) * schlick
    return schlick


def cross_bb(vol, rays: RaysS):
    """The rays' interval in the box, clipped to [0, tmax] (tmax <= 0 =
    unbounded, 3e38); (hit, t0, t1), hit = t1 > t0."""
    tmax_cap = torch.where(rays.tmax > 0, rays.tmax, 3.0e38)
    tn, tf = [], []
    for k, (o, d) in enumerate(zip(rays.o, rays.d)):
        inv_d = 1.0 / torch.where(d.abs() < 1e-20,
                                  torch.where(d < 0, -1e-20, 1e-20), d)
        a = (vol.bmin[k] - o) * inv_d
        b = (vol.bmax[k] - o) * inv_d
        tn.append(torch.minimum(a, b))
        tf.append(torch.maximum(a, b))
    # one reduction over the axes and a maximum with 0, as core_tpu's
    # (regions.py:276-279): their gradients split evenly between equal
    # values (a shading point on the box's face starts its rays at t = 0)
    t0 = torch.maximum(torch.stack(tn).amax(0), torch.zeros_like(tn[0]))
    t1 = torch.minimum(torch.stack(tf).amin(0), tmax_cap)
    return t1 > t0, t0, t1


def tau(vol, rays: RaysS, offset: float = 0.5, n_steps: int = 32) -> V3:
    """Optical depth along the rays (V3 of [N]): dist * (s_a + s_s) in a
    uniform region (UniformVolume::tau), else n_steps midpoints
    t0 + (i + offset) * dt of the clipped interval (DensityVolume::tau)."""
    hit, t0, t1 = cross_bb(vol, rays)
    if isinstance(vol, UniformVolume):
        dist = torch.where(hit, t1 - t0, 0.0)
        st = vol.s_a + vol.s_s
        return V3(dist * st[0], dist * st[1], dist * st[2])
    dt = (t1 - t0) / n_steps
    acc = V3(*(torch.zeros_like(dt) for _ in range(3)))
    for i in range(n_steps):
        t = t0 + (i + offset) * dt
        acc = acc + sigma_t(vol, rays.o + rays.d * t) * dt
    return V3(*(torch.where(hit, c, 0.0) for c in acc))
