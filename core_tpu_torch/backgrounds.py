"""Backgrounds, the environment emitters (counterpart of
core_tpu/backgrounds.py; reference src/backgrounds/).

- constant (textureback.cc:213-246) and gradient (gradientback.cc, with
  its ground colours);
- sunsky: the Preetham-Shirley-Smits analytic daylight (sunsky.cc:40-170),
  Perez luminance and chromaticity, xyY -> linear RGB;
- darksky: TheBounty's spectral daylight (darksky.cc): Perez terms
  normalised at the zenith, the altitude shift, a colour space, exposure,
  gamma encode and clamp, night mode; darksky_sun_color is its attenuated
  spectral sun (sampling/sunspectrum.py);
- the texture-mapped environment (textureback.cc:30-160): sphere or angular
  (light probe) projection, a Z rotation, image or procedural textures.

Each is built on the host in numpy as core_tpu builds it and stored as
float32 tensors; eval_background_s evaluates any of them on a wavefront of
directions (V3 of [N]).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from core_tpu_torch.textures.base import eval_texture
from core_tpu_torch.utils.colorconv import (XYZ_TO_RGB, xyy_to_xyz_s,
                                            xyz_to_rgb, xyz_to_rgb_s)
from core_tpu_torch.vec import V3, splat3, zeros3


def _f32(device):
    def f(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)
    return f


@dataclass(frozen=True)
class ConstantBackground:
    color: torch.Tensor   # [3], already * power
    ibl: bool = False
    ibl_samples: int = 8


def make_constant_background(color, power=1.0, ibl=False, ibl_samples=8, *,
                             device) -> ConstantBackground:
    return ConstantBackground(
        color=_f32(device)(np.asarray(color, np.float32) * power),
        ibl=bool(ibl), ibl_samples=int(ibl_samples))


@dataclass(frozen=True)
class GradientBackground:
    horizon: torch.Tensor          # [3]
    zenith: torch.Tensor           # [3]
    horizon_ground: torch.Tensor   # [3]
    zenith_ground: torch.Tensor    # [3]
    ibl: bool = False
    ibl_samples: int = 8


def make_gradient_background(horizon, zenith, horizon_ground=None,
                             zenith_ground=None, power=1.0, ibl=False,
                             ibl_samples=8, *, device) -> GradientBackground:
    h = np.asarray(horizon, np.float32) * power
    z = np.asarray(zenith, np.float32) * power
    hg = h if horizon_ground is None \
        else np.asarray(horizon_ground, np.float32) * power
    zg = z if zenith_ground is None \
        else np.asarray(zenith_ground, np.float32) * power
    f = _f32(device)
    return GradientBackground(f(h), f(z), f(hg), f(zg), bool(ibl),
                              int(ibl_samples))


@dataclass(frozen=True)
class SunSkyBackground:
    """Preetham-Shirley-Smits daylight (sunsky.cc:40-170)."""
    sun_dir: torch.Tensor       # [3] unit, toward the sun
    theta_s: torch.Tensor       # [] sun zenith angle
    phi_s: torch.Tensor         # []
    zenith: torch.Tensor        # [3] (Y, x, y) zenith values
    perez_y_lum: torch.Tensor   # [5]
    perez_x: torch.Tensor       # [5]
    perez_y: torch.Tensor       # [5]
    power: torch.Tensor         # []
    ibl: bool = False
    ibl_samples: int = 8


def make_sunsky_background(sun_dir, turbidity=4.0, a_var=1.0, b_var=1.0,
                           c_var=1.0, d_var=1.0, e_var=1.0, power=1.0,
                           ibl=False, ibl_samples=8, *,
                           device) -> SunSkyBackground:
    """Same float64 host math as core_tpu's make_sunsky_background."""
    d = np.asarray(sun_dir, np.float64)
    d = d / max(np.linalg.norm(d), 1e-20)
    theta_s = float(np.arccos(np.clip(d[2], -1.0, 1.0)))
    phi_s = float(np.arctan2(d[1], d[0]))
    t2, t3 = theta_s ** 2, theta_s ** 3
    T = float(turbidity)
    T2 = T * T
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    zen_y_lum = ((4.0453 * T - 4.9710) * np.tan(chi)
                 - 0.2155 * T + 2.4192) * 1000.0
    zen_x = ((0.00165 * t3 - 0.00375 * t2 + 0.00209 * theta_s) * T2
             + (-0.02903 * t3 + 0.06377 * t2 - 0.03202 * theta_s + 0.00394)
             * T
             + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25886))
    zen_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00317 * theta_s) * T2
             + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s + 0.00516)
             * T
             + (0.15346 * t3 - 0.26756 * t2 + 0.06670 * theta_s + 0.26688))
    perez_y_lum = np.array([(0.17872 * T - 1.46303) * a_var,
                            (-0.35540 * T + 0.42749) * b_var,
                            (-0.02266 * T + 5.32505) * c_var,
                            (0.12064 * T - 2.57705) * d_var,
                            (-0.06696 * T + 0.37027) * e_var])
    perez_x = np.array([(-0.01925 * T - 0.25922) * a_var,
                        (-0.06651 * T + 0.00081) * b_var,
                        (-0.00041 * T + 0.21247) * c_var,
                        (-0.06409 * T - 0.89887) * d_var,
                        (-0.00325 * T + 0.04517) * e_var])
    perez_y = np.array([(-0.01669 * T - 0.26078) * a_var,
                        (-0.09495 * T + 0.00921) * b_var,
                        (-0.00792 * T + 0.21023) * c_var,
                        (-0.04405 * T - 1.65369) * d_var,
                        (-0.01092 * T + 0.05291) * e_var])
    f = _f32(device)
    return SunSkyBackground(
        sun_dir=f(d), theta_s=f(theta_s), phi_s=f(phi_s),
        zenith=f([zen_y_lum, zen_x, zen_y]), perez_y_lum=f(perez_y_lum),
        perez_x=f(perez_x), perez_y=f(perez_y), power=f(power),
        ibl=bool(ibl), ibl_samples=int(ibl_samples))


def _perez(lam, theta_s, theta, gamma, lvz):
    """PerezFunction (sunsky.cc:87-110) with exp-overflow clamps."""
    def safe_exp(x):
        return torch.exp(x.clamp_max(230.0))
    cs = torch.cos(theta_s)
    cg = torch.cos(gamma)
    den = (1.0 + lam[0] * safe_exp(lam[1])) \
        * (1.0 + lam[2] * safe_exp(lam[3] * theta_s) + lam[4] * cs * cs)
    num = (1.0 + lam[0] * safe_exp(lam[1] / torch.cos(theta))) \
        * (1.0 + lam[2] * safe_exp(lam[3] * gamma) + lam[4] * cg * cg)
    return lvz * num / den


def _eval_sunsky(bg: SunSkyBackground, d: V3) -> V3:
    theta = torch.acos(d.z.clamp(-1.0, 1.0))
    # horizon stretch and fade below the horizon (sunsky.cc:125-131)
    hfade_lin = (1.0 - (theta / np.pi - 0.5) * 2.0).clamp(0.0, 1.0)
    hfade = torch.where(theta > 0.5 * np.pi,
                        hfade_lin * hfade_lin * (3.0 - 2.0 * hfade_lin), 1.0)
    theta = theta.clamp_max(0.5 * np.pi - 1e-4)
    # night-time fade (sunsky.cc:134-140)
    nlin = (1.0 - (0.5 - theta / np.pi) * 2.0).clamp(0.0, 1.0) \
        * (1.0 - (bg.theta_s / np.pi - 0.5) * 2.0).clamp(0.0, 1.0)
    nfade = torch.where(bg.theta_s > 0.5 * np.pi,
                        nlin * nlin * (3.0 - 2.0 * nlin), 1.0)
    phi = torch.where((d.x.abs() < 1e-12) & (d.y.abs() < 1e-12),
                      0.5 * np.pi, torch.atan2(d.y, d.x))
    cospsi = torch.sin(theta) * torch.sin(bg.theta_s) \
        * torch.cos(bg.phi_s - phi) + torch.cos(theta) * torch.cos(bg.theta_s)
    gamma = torch.acos(cospsi.clamp(-1.0, 1.0))
    x = _perez(bg.perez_x, bg.theta_s, theta, gamma, bg.zenith[1])
    y = _perez(bg.perez_y, bg.theta_s, theta, gamma, bg.zenith[2])
    Y = 6.666666667e-5 * nfade * hfade * _perez(
        bg.perez_y_lum, bg.theta_s, theta, gamma, bg.zenith[0])
    y_ok = y.abs() > 1e-9
    y_safe = torch.where(y_ok, y, 1.0)
    X = (x / y_safe) * Y
    Z = ((1.0 - x - y) / y_safe) * Y
    r = 3.240479 * X - 1.537150 * Y - 0.498535 * Z
    g = -0.969256 * X + 1.875992 * Y + 0.041556 * Z
    b = 0.055648 * X - 0.204043 * Y + 1.057311 * Z
    return V3(*(torch.where(y_ok, c.clamp(0.0, 1.0), 0.0) * bg.power
                for c in (r, g, b)))


@dataclass(frozen=True)
class DarkSkyBackground:
    """TheBounty's spectral daylight (darksky.cc): Preetham Perez sky with
    the zenith normaliser baked into each coefficient vector (prePerez),
    the altitude shift applied to the sun and to every direction, a colour
    space's xyY -> RGB with exposure and the simple gamma encode
    (ColorConv.h), and night mode (darksky.cc getSkyCol)."""
    sun_dir: torch.Tensor      # [3] unit, altitude-shifted
    zenith: torch.Tensor       # [3] (Y, x, y)
    perez_lum: torch.Tensor    # [6] coefficients + 1/prePerez normaliser
    perez_x: torch.Tensor      # [6]
    perez_y: torch.Tensor      # [6]
    conv_mat: torch.Tensor     # [3,3] XYZ -> RGB of the colour space
    bright: torch.Tensor       # [] skyBrightness
    power: torch.Tensor        # [] bgLight power scale
    altitude: torch.Tensor     # []
    exposure: float = 1.0
    night: bool = False
    clamp_rgb: bool = True
    gamma_enc: bool = True
    ibl: bool = False
    ibl_samples: int = 8


def _darksky_pre_perez(lam, theta_s, cos2_theta_s):
    """Normaliser making the Perez function 1 at the zenith
    (darksky.cc prePerez)."""
    p = ((1.0 + lam[0] * np.exp(lam[1]))
         * (1.0 + lam[2] * np.exp(lam[3] * theta_s)
            + lam[4] * cos2_theta_s))
    return 0.0 if p == 0.0 else 1.0 / p


def make_darksky_background(sun_dir, turbidity=4.0, a_var=1.0, b_var=1.0,
                            c_var=1.0, d_var=1.0, e_var=1.0, power=1.0,
                            bright=1.0, altitude=0.0, night=False,
                            exposure=1.0, clamp_rgb=True, gamma_enc=True,
                            color_space="CIE (E)", ibl=False,
                            ibl_samples=8, *, device) -> DarkSkyBackground:
    """Same float64 host math as core_tpu's make_darksky_background."""
    d = np.asarray(sun_dir, np.float64).copy()
    d[2] += altitude
    d = d / max(np.linalg.norm(d), 1e-20)
    theta_s = float(np.arccos(np.clip(d[2], -1.0, 1.0)))
    cos2 = d[2] * d[2]
    t2, t3 = theta_s ** 2, theta_s ** 3
    T = float(turbidity)
    T2 = T * T
    chi = (4.0 / 9.0 - T / 120.0) * (np.pi - 2.0 * theta_s)
    zen_lum = ((4.0453 * T - 4.9710) * np.tan(chi)
               - 0.2155 * T + 2.4192) * 1000.0
    zen_x = ((0.00165 * t3 - 0.00374 * t2 + 0.00209 * theta_s) * T2
             + (-0.02902 * t3 + 0.06377 * t2 - 0.03202 * theta_s + 0.00394)
             * T
             + (0.11693 * t3 - 0.21196 * t2 + 0.06052 * theta_s + 0.25885))
    zen_y = ((0.00275 * t3 - 0.00610 * t2 + 0.00316 * theta_s) * T2
             + (-0.04214 * t3 + 0.08970 * t2 - 0.04153 * theta_s + 0.00515)
             * T
             + (0.15346 * t3 - 0.26756 * t2 + 0.06669 * theta_s + 0.26688))
    # darksky applies the a..e user scales to the luminance only
    # (darksky.cc:108-127)
    p_lum = np.array([(0.17872 * T - 1.46303) * a_var,
                      (-0.35540 * T + 0.42749) * b_var,
                      (-0.02266 * T + 5.32505) * c_var,
                      (0.12064 * T - 2.57705) * d_var,
                      (-0.06696 * T + 0.37027) * e_var, 0.0])
    p_x = np.array([-0.01925 * T - 0.25922, -0.06651 * T + 0.00081,
                    -0.00041 * T + 0.21247, -0.06409 * T - 0.89887,
                    -0.00325 * T + 0.04517, 0.0])
    p_y = np.array([-0.01669 * T - 0.26078, -0.09495 * T + 0.00921,
                    -0.00792 * T + 0.21023, -0.04405 * T - 1.65369,
                    -0.01092 * T + 0.05291, 0.0])
    for p in (p_lum, p_x, p_y):
        p[5] = _darksky_pre_perez(p, theta_s, cos2)
    f = _f32(device)
    return DarkSkyBackground(
        sun_dir=f(d), zenith=f([zen_lum, zen_x, zen_y]), perez_lum=f(p_lum),
        perez_x=f(p_x), perez_y=f(p_y), conv_mat=f(XYZ_TO_RGB[color_space]),
        bright=f(bright), power=f(power), altitude=f(altitude),
        exposure=float(exposure), night=bool(night),
        clamp_rgb=bool(clamp_rgb), gamma_enc=bool(gamma_enc), ibl=bool(ibl),
        ibl_samples=int(ibl_samples))


def darksky_sun_color(bg: DarkSkyBackground, turbidity: float):
    """The attenuated spectral sun colour of darksky's 'Real Sun'
    (darksky.cc getAttenuatedSunColor), numpy float32 [3]."""
    from core_tpu_torch.sampling.sunspectrum import attenuated_sun_xyz
    cos_ts = float(bg.sun_dir[2].cpu())
    xyz = attenuated_sun_xyz(cos_ts, turbidity)
    rgb = xyz_to_rgb(xyz[None], bg.conv_mat.cpu().numpy(),
                     clamp=bg.clamp_rgb, gamma_encode=True)[0]
    if bg.night:
        rgb = rgb * np.array([0.8, 0.8, 1.0])
    return np.asarray(rgb, np.float32)


def _darksky_perez(lam, cos_theta, gamma, cos_gamma2):
    """darksky.cc PerezFunction: the numerator times the normaliser."""
    num = ((1.0 + lam[0] * torch.exp(lam[1] / cos_theta))
           * (1.0 + lam[2] * torch.exp(lam[3] * gamma) + lam[4] * cos_gamma2))
    return num * lam[5]


def _eval_darksky(bg: DarkSkyBackground, d: V3) -> V3:
    # altitude-shift the direction as the sun was (darksky.cc getSkyCol)
    w = V3(d.x, d.y, d.z + bg.altitude)
    norm = torch.sqrt(w.x * w.x + w.y * w.y + w.z * w.z).clamp_min(1e-20)
    w = V3(w.x / norm, w.y / norm, w.z / norm)
    cos_theta = w.z.clamp_min(1e-6)
    s = splat3(bg.sun_dir)
    cos_gamma = (w.x * s.x + w.y * s.y + w.z * s.z).clamp(-1.0, 1.0)
    gamma = torch.acos(cos_gamma)
    cg2 = cos_gamma * cos_gamma
    x = _darksky_perez(bg.perez_x, cos_theta, gamma, cg2) * bg.zenith[1]
    y = _darksky_perez(bg.perez_y, cos_theta, gamma, cg2) * bg.zenith[2]
    Y = _darksky_perez(bg.perez_lum, cos_theta, gamma, cg2) \
        * bg.zenith[0] * 6.66666667e-5
    rgb = xyz_to_rgb_s(xyy_to_xyz_s(x, y, Y, exposure=bg.exposure),
                       bg.conv_mat, clamp=bg.clamp_rgb,
                       gamma_encode=bg.gamma_enc)
    if bg.night:
        rgb = V3(rgb.x * 0.05, rgb.y * 0.05, rgb.z * 0.08)
    return rgb * (bg.bright * bg.power)


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


PROJECTIONS = ("sphere", "angular")


def make_texture_background(ctex, tex_id=0, power=1.0, rotation=0.0,
                            projection="sphere", ibl=False, ibl_samples=8,
                            *, device) -> TextureBackground:
    if projection not in PROJECTIONS:
        raise ValueError(f"unknown background projection {projection!r}")
    rot = np.radians(float(rotation))

    def f(a):
        return torch.tensor(np.float32(a), device=device)

    return TextureBackground(ctex=ctex, tex_id=int(tex_id), power=f(power),
                             rot_cos=f(np.cos(rot)), rot_sin=f(np.sin(rot)),
                             projection=projection, ibl=bool(ibl),
                             ibl_samples=int(ibl_samples))


def _eval_texture_bg(bg: TextureBackground, d: V3) -> V3:
    # rotate around Z (textureback.cc:141-147)
    x = bg.rot_cos * d.x + bg.rot_sin * d.y
    y = -bg.rot_sin * d.x + bg.rot_cos * d.y
    theta = torch.acos(d.z.clamp(-1.0, 1.0))
    if bg.projection == "angular":
        # angmap (texture.h:46-60)
        r = torch.sqrt((x * x + y * y).clamp_min(1e-20))
        u = 0.5 + 0.5 * (theta / math.pi) * (x / r)
        v = 0.5 + 0.5 * (theta / math.pi) * (-y / r)
    else:
        # spheremap (texture.h:63-85): u from the azimuth, v from the
        # polar angle; image textures read (u, v), procedural ones the
        # direction
        u = torch.remainder(torch.atan2(y, x) / (2.0 * math.pi), 1.0)
        v = 1.0 - theta / math.pi
    tid = torch.full(x.shape, bg.tex_id, dtype=torch.int32, device=x.device)
    rgb, _ = eval_texture(bg.ctex, tid, V3(x, y, d.z), (u, v))
    return rgb * bg.power


def eval_background_s(bg, d: V3) -> V3:
    """Radiance of the environment in directions d (V3 of [N])."""
    if bg is None:
        return zeros3(d.x)
    if isinstance(bg, ConstantBackground):
        return splat3(bg.color, like=d.x)
    if isinstance(bg, SunSkyBackground):
        return _eval_sunsky(bg, d)
    if isinstance(bg, DarkSkyBackground):
        return _eval_darksky(bg, d)
    if isinstance(bg, TextureBackground):
        return _eval_texture_bg(bg, d)
    if isinstance(bg, GradientBackground):
        # gradientback.cc: blend on z, the ground colours below the horizon
        up = d.z.clamp(0.0, 1.0)
        dn = (-d.z).clamp(0.0, 1.0)
        above = d.z >= 0.0
        return V3(*(torch.where(above, zc * up + hc * (1.0 - up),
                                zg * dn + hg * (1.0 - dn))
                    for zc, hc, zg, hg in zip(
                        bg.zenith, bg.horizon, bg.zenith_ground,
                        bg.horizon_ground)))
    raise TypeError(f"unknown background {type(bg).__name__}")
