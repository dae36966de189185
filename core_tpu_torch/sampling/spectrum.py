"""Spectral dispersion support: wavelength -> RGB and the Cauchy IOR
(counterpart of core_tpu/sampling/spectrum.py; reference
src/yafraycore/spectrum.cc and include/yafraycore/spectrum.h:24-40).

The RGB curve is core_tpu's piecewise-linear CIE-like response, normalized
so that its average over the visible band is (1, 1, 1): a dispersive path
sampled with a uniform wavelength prior stays energy-neutral.  A sample w in
[0, 1] stands for the wavelength WL_MIN + (WL_MAX - WL_MIN) * w.
"""
from __future__ import annotations

import numpy as np

from core_tpu_torch.vec import V3

WL_MIN = 0.380   # microns
WL_MAX = 0.780


def wavelength(w):
    """Normalized sample w in [0, 1] -> wavelength in microns."""
    return WL_MIN + (WL_MAX - WL_MIN) * w


def cauchy_coefficients(ior, dispersion_power):
    """n(lambda) = A + B / lambda^2 with n(0.5893 um) = ior and
    n(380 nm) - n(780 nm) = dispersion_power (the reference's
    CauchyCoefficients: zero power, no spread)."""
    spread = 1.0 / (WL_MIN * WL_MIN) - 1.0 / (WL_MAX * WL_MAX)
    b = dispersion_power / spread
    a = ior - b / (0.5893 * 0.5893)
    return a, b


def cauchy_ior(w, a, b):
    """IOR at normalized wavelength w (reference getIOR)."""
    lam = wavelength(w)
    return a + b / (lam * lam)


def _ramp(x, lo, hi):
    return ((x - lo) / (hi - lo)).clip(0.0, 1.0)


def _response(lam, ramp, below440):
    r = ramp(lam, 540.0, 600.0) \
        + 0.25 * ramp(440.0 - (lam - 380.0), 380.0, 440.0) * below440
    g = ramp(lam, 470.0, 530.0) * (1.0 - ramp(lam, 590.0, 680.0))
    b = 1.0 - ramp(lam, 450.0, 510.0)
    return r, g, b


# the channel means of the response on a 256-point grid of the band, once
_LAM_GRID = (WL_MIN + (WL_MAX - WL_MIN) * np.linspace(0.0, 1.0, 256)) * 1000.0
_NORM = np.maximum(np.array(
    [c.mean() for c in _response(_LAM_GRID, _ramp,
                                 (_LAM_GRID < 440.0).astype(np.float64))],
    np.float32), 1e-6)


def wl2rgb(w) -> V3:
    """Normalized wavelength w [N] -> linear RGB weight, V3 of [N]."""
    lam = wavelength(w) * 1000.0   # nm
    r, g, b = _response(lam, _ramp, (lam < 440.0).to(lam.dtype))
    return V3(r / float(_NORM[0]), g / float(_NORM[1]), b / float(_NORM[2]))
