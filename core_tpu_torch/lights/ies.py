"""Photometric IES profile light (counterpart of core_tpu/lights/ies.py;
reference src/lights/iesLight.cc and the IESNA LM-63 parser in
include/utilities/iesUtils.h).

A dirac point light whose intensity follows a measured candela
distribution over the vertical angle, averaged over azimuth.  The profile
is parsed and resampled on the host onto a uniform 181-entry grid (one
entry per degree); a lookup is an index gather and a lerp (core_tpu decodes
the two rows with a one-hot matmul, a TPU workaround).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.vec import V3, dot3, splat3

DIRAC = True
PROFILE_RES = 181   # one entry per degree, 0..180


def parse_ies(text: str):
    """Minimal IESNA LM-63 parser (iesUtils.h IESData_t::parseIESFile):
    (v_angles [nv], candela [nv]) averaged over azimuth, normalised to a
    maximum of 1."""
    lines = text.splitlines()
    i = 0
    while i < len(lines) and not lines[i].upper().startswith("TILT"):
        i += 1
    if i == len(lines):
        raise ValueError("not an IES file (no TILT line)")
    if "INCLUDE" in lines[i].upper():
        i += 4  # tilt block: angles-count, angles, factors
    nums: list[float] = []
    for ln in lines[i + 1:]:
        nums.extend(float(t) for t in ln.replace(",", " ").split())
    # header: nlamps, lumens/lamp, multiplier, n_v, n_h, photometric type,
    # units, width, length, height, ballast, future, input watts
    n_v = int(nums[3])
    n_h = int(nums[4])
    mult = nums[2]
    idx = 13
    v_angles = np.asarray(nums[idx:idx + n_v])
    idx += n_v + n_h          # the horizontal angles are averaged over
    candela = np.asarray(nums[idx:idx + n_v * n_h]).reshape(n_h, n_v)
    profile = candela.mean(axis=0) * mult
    peak = profile.max()
    if peak > 0:
        profile = profile / peak
    return v_angles, profile


def resample_profile(v_angles, profile, res: int = PROFILE_RES):
    """Uniform 0..180-degree grid (linear interpolation; the first value
    below the data, zero above it)."""
    grid = np.linspace(0.0, 180.0, res)
    return np.interp(grid, v_angles, profile, left=profile[0], right=0.0)


@dataclass(frozen=True)
class IesLight:
    pos: torch.Tensor          # [3]
    ndir: torch.Tensor         # [3] unit axis (the 0-degree direction)
    color: torch.Tensor        # [3] color * power
    profile: torch.Tensor      # [PROFILE_RES] normalised candela vs angle
    samples: int = 1


def make_ies_light(pos, to, color, power, ies_text: str, samples: int = 1,
                   *, device) -> IesLight:
    """Same host math as core_tpu's make_ies_light."""
    v, prof = parse_ies(ies_text)
    table = resample_profile(v, prof)
    ndir = np.asarray(to, np.float64) - np.asarray(pos, np.float64)
    ndir = ndir / max(np.linalg.norm(ndir), 1e-12)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return IesLight(pos=f(pos), ndir=f(ndir),
                    color=f(np.asarray(color, np.float32) * power),
                    profile=f(table), samples=samples)


def can_intersect(light: IesLight) -> bool:
    return False


def get_n_samples(light: IesLight) -> int:
    return light.samples


def _intensity(light: IesLight, wi: V3):
    """The profile at the angle between -wi (light -> surface) and the
    light's axis."""
    cosang = dot3(-wi, splat3(light.ndir)).clamp(-1.0, 1.0)
    f = torch.rad2deg(torch.acos(cosang)).clamp(0.0, 180.0)
    i0 = f.to(torch.int64).clamp(0, PROFILE_RES - 2)
    frac = f - i0.to(torch.float32)
    return light.profile[i0] * (1.0 - frac) + light.profile[i0 + 1] * frac


def illuminate_s(light: IesLight, sp) -> LightSampleS:
    ldir = splat3(light.pos) - sp.p
    dist2 = dot3(ldir, ldir)
    dist = torch.sqrt(dist2)
    dm = dist.clamp_min(1e-12)
    wi = V3(ldir.x / dm, ldir.y / dm, ldir.z / dm)
    inten = _intensity(light, wi)
    scale = inten / dist2.clamp_min(1e-12)
    col = V3(light.color[0] * scale, light.color[1] * scale,
             light.color[2] * scale)
    return LightSampleS(valid=(dist > 0.0) & (inten > 0.0), wi=wi,
                        dist=dist, col=col, pdf=torch.ones_like(dist))


def illum_sample_s(light: IesLight, sp, s1, s2) -> LightSampleS:
    return illuminate_s(light, sp)


def intersect_light_s(light: IesLight, rays) -> LightHitS:
    """A point is never hit."""
    z = torch.zeros_like(rays.d.x)
    return LightHitS(valid=torch.zeros_like(z, dtype=torch.bool), t=z - 1.0,
                     col=V3(z, z, z), ipdf=z)


def illum_pdf_s(light: IesLight, sp, p_light: V3):
    return torch.ones_like(sp.p.x)
