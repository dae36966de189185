"""Background importance light (counterpart of core_tpu/lights/bg.py;
reference src/lights/bglight.cc).

A fixed NV x NU spheremap grid of the background's sin-weighted luminance
gives per-row U CDFs and a V CDF (bglight.cc init, :47-96); directions are
sampled by 2-D CDF inversion, and
  pdf = pu * pv / (2 pi^2 sin(pi v))                         (bglight.cc:41)
The CDFs are built with torch on the scene's device, in float64 as
core_tpu's numpy build is, and stored as float32.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import torch

from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.vec import V3

DIRAC = False
SIGMA = 1e-6


@dataclass(frozen=True)
class BgLight:
    background: Any           # evaluated through eval_background_s
    u_pdf: torch.Tensor       # [NV,NU] row-conditional density
    u_cdf: torch.Tensor       # [NV,NU] row-conditional CDF
    v_pdf: torch.Tensor       # [NV] marginal density
    v_cdf: torch.Tensor       # [NV] marginal CDF
    samples: int = 8
    abs_intersect: bool = False


def _inv_spheremap(u, v) -> V3:
    """texture.h invSpheremap: (u,v) in [0,1]^2 -> direction."""
    theta = v * math.pi
    phi = -(u * 2.0 * math.pi)
    st = torch.sin(theta)
    return V3(st * torch.cos(phi), st * torch.sin(phi), -torch.cos(theta))


def make_bg_light(background, samples=8, nv=128, nu=256,
                  abs_intersect=False, *, device) -> BgLight:
    """Rasterize the background onto the spheremap grid and build the CDFs
    (mirrors bglight.cc init)."""
    f64 = dict(dtype=torch.float64, device=device)
    vs = (torch.arange(nv, **f64) + 0.5) / nv
    us = (torch.arange(nu, **f64) + 0.5) / nu
    vv, uu = torch.meshgrid(vs, us, indexing="ij")          # [NV,NU]
    dirs = _inv_spheremap(uu.reshape(-1), vv.reshape(-1))
    rad = eval_background_s(background, V3(*[c.float() for c in dirs]))
    # color_t::energy, the float32 mean of the three channels
    energy = ((rad.x + rad.y + rad.z) / 3.0).reshape(nv, nu)
    sin_t = torch.sin(math.pi * vs)[:, None]
    f = (energy.double() * sin_t).clamp_min(0.0) + 1e-10

    row_int = f.mean(dim=1)
    u_pdf = f / row_int[:, None]
    u_cdf = torch.cumsum(f, dim=1) / f.sum(dim=1, keepdim=True)
    v_pdf = row_int / row_int.mean()
    v_cdf = torch.cumsum(row_int, dim=0) / row_int.sum()
    return BgLight(background=background, u_pdf=u_pdf.float(),
                   u_cdf=u_cdf.float(), v_pdf=v_pdf.float(),
                   v_cdf=v_cdf.float(), samples=int(samples),
                   abs_intersect=bool(abs_intersect))


def can_intersect(light: BgLight) -> bool:
    return True


def get_n_samples(light: BgLight) -> int:
    return light.samples


def _spheremap(d: V3):
    """Exact inverse of _inv_spheremap: direction -> (u,v) in [0,1]^2."""
    u = torch.remainder(-torch.atan2(d.y, d.x) / (2.0 * math.pi), 1.0)
    v = torch.acos((-d.z).clamp(-1.0, 1.0)) / math.pi
    return u, v


def _pdf_uv(pu, pv, v):
    sin_t = torch.sin(math.pi * v).clamp_min(1e-9)
    return (pu * pv / (2.0 * math.pi * math.pi * sin_t)).clamp_min(SIGMA)


def _sample_uv(light: BgLight, s1, s2):
    """2-D CDF inversion; returns (u, v, pu, pv).  Each search counts the
    CDF entries below the sample (the searchsorted 'left' contract)."""
    nv, nu = light.u_cdf.shape
    iv = torch.searchsorted(light.v_cdf, s2).clamp(0, nv - 1)
    v_prev = torch.cat([light.v_cdf.new_zeros(1), light.v_cdf[:-1]])
    cdf_lo = v_prev[iv]
    dv = (light.v_cdf[iv] - cdf_lo).clamp_min(1e-12)
    v = (iv.float() + ((s2 - cdf_lo) / dv).clamp(0.0, 1.0)) / nv
    pv = light.v_pdf[iv]

    # row iv's search in one flat searchsorted: row r is shifted by 2r in
    # float64, which keeps the rows apart and every comparison exact
    shift = 2.0 * torch.arange(nv, dtype=torch.float64, device=iv.device)
    flat = (light.u_cdf.double() + shift[:, None]).reshape(-1)
    row0 = iv * nu
    iu = (torch.searchsorted(flat, 2.0 * iv.double() + s1.double())
          - row0).clamp(0, nu - 1)
    ucdf = light.u_cdf.reshape(-1)
    cdf_lo_u = torch.where(iu > 0, ucdf[row0 + (iu - 1).clamp_min(0)], 0.0)
    du = (ucdf[row0 + iu] - cdf_lo_u).clamp_min(1e-12)
    u = (iu.float() + ((s1 - cdf_lo_u) / du).clamp(0.0, 1.0)) / nu
    pu = light.u_pdf.reshape(-1)[row0 + iu]
    return u, v, pu, pv


def _pdf_from_dir(light: BgLight, d: V3):
    u, v = _spheremap(d)
    nv, nu = light.u_cdf.shape
    iv = (v * nv).long().clamp(0, nv - 1)
    iu = (u * nu).long().clamp(0, nu - 1)
    return _pdf_uv(light.u_pdf[iv, iu], light.v_pdf[iv], v)


def illum_sample_s(light: BgLight, sp, s1, s2) -> LightSampleS:
    u, v, pu, pv = _sample_uv(light, s1, s2)
    wi = _inv_spheremap(u, v)
    return LightSampleS(valid=torch.ones_like(s1, dtype=torch.bool), wi=wi,
                        dist=torch.full_like(s1, -1.0),
                        col=eval_background_s(light.background, wi),
                        pdf=_pdf_uv(pu, pv, v))


def illum_pdf_s(light: BgLight, sp, p_light: V3):
    """Solid-angle pdf of sampling the direction from sp.p to p_light."""
    d = p_light - sp.p
    norm = torch.sqrt(d.x * d.x + d.y * d.y + d.z * d.z).clamp_min(1e-12)
    return _pdf_from_dir(light, d * (1.0 / norm))


def intersect_light_s(light: BgLight, rays) -> LightHitS:
    d = -rays.d if light.abs_intersect else rays.d
    ipdf = 1.0 / _pdf_from_dir(light, d)
    return LightHitS(valid=torch.ones_like(ipdf, dtype=torch.bool),
                     t=torch.full_like(ipdf, -1.0),
                     col=eval_background_s(light.background, rays.d),
                     ipdf=ipdf)
