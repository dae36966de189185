"""CIE XYZ -> RGB colour conversion with selectable working colour spaces
(counterpart of core_tpu/utils/colorconv.py; the reference's ColorConv,
include/utilities/ColorConv.h:23-168).

Four target spaces (CIE RGB with E or D50 white, sRGB with D65 or D50
white), xyY -> XYZ with an optional exponential exposure curve on Y, a
simple 1/2.2 gamma encode and RGB clamping.  xyz_to_rgb and xyy_to_xyz take
numpy arrays (scene build: the darksky sun colour); the sky's per-ray
evaluation uses their SoA forms on tensors, xyz_to_rgb_s and
xyy_to_xyz_s.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.vec import V3

# XYZ -> RGB matrices, rows = (R, G, B) output channels.
XYZ_TO_RGB = {
    # CIE RGB primaries, equal-energy (E) white
    "CIE (E)": np.array([[2.3706743, -0.9000405, -0.4706338],
                         [-0.5138850, 1.4253036, 0.0885814],
                         [0.0052982, -0.0146949, 1.0093968]], np.float32),
    # CIE RGB primaries adapted to D50
    "CIE (D50)": np.array([[2.3638081, -0.8676030, -0.4988161],
                           [-0.5005940, 1.3962369, 0.1047562],
                           [0.0141712, -0.0306400, 1.2323842]], np.float32),
    # sRGB primaries, native D65 white
    "sRGB (D65)": np.array([[3.2404542, -1.5371385, -0.4985314],
                            [-0.9692660, 1.8760108, 0.0415560],
                            [0.0556434, -0.2040259, 1.0572252]], np.float32),
    # sRGB primaries adapted to D50
    "sRGB (D50)": np.array([[3.1338561, -1.6168667, -0.4906146],
                            [-0.9787684, 1.9161415, 0.0334540],
                            [0.0719453, -0.2289914, 1.4052427]], np.float32),
}
GAMMA_ENC = np.float32(1.0 / 2.2)


def xyz_to_rgb(xyz, matrix, clamp=False, gamma_encode=False):
    """[..., 3] XYZ -> [..., 3] RGB (numpy) through a 3x3 matrix, with the
    optional 1/2.2 gamma encode and [0, 1] clamp of ColorConv::fromXYZ
    (ColorConv.h:101-125)."""
    m = np.asarray(matrix, getattr(xyz, "dtype", None))
    rgb = xyz @ m.T
    if gamma_encode:
        rgb = np.power(np.maximum(rgb, 0.0), GAMMA_ENC)
    return np.clip(rgb, 0.0, 1.0) if clamp else rgb


def xyy_to_xyz(x, y, Y, exposure=0.0):
    """Chromaticity (x, y) and luminance Y -> XYZ [..., 3] (numpy);
    exposure > 0 applies Y' = exp(Y exposure) - 1 (ColorConv.h:137-158);
    y == 0 maps to black."""
    if exposure > 0.0:
        Y = np.exp(Y * exposure) - 1.0
    y_ok = np.abs(y) > 1e-12
    ratio = Y / np.where(y_ok, y, 1.0)
    xyz = np.stack([x * ratio, Y, (1.0 - x - y) * ratio], -1)
    return np.where(y_ok[..., None], xyz, 0.0)


def xyy_to_xyz_s(x, y, Y, exposure=0.0) -> V3:
    """xyy_to_xyz on [N] tensors, as V3."""
    if exposure > 0.0:
        Y = torch.exp(Y * exposure) - 1.0
    y_ok = y.abs() > 1e-12
    ratio = Y / torch.where(y_ok, y, 1.0)
    return V3(torch.where(y_ok, x * ratio, 0.0), torch.where(y_ok, Y, 0.0),
              torch.where(y_ok, (1.0 - x - y) * ratio, 0.0))


def xyz_to_rgb_s(xyz: V3, m: torch.Tensor, clamp=False,
                 gamma_encode=False) -> V3:
    """xyz_to_rgb on V3 with the matrix m [3, 3] as a tensor."""
    rgb = [m[i, 0] * xyz.x + m[i, 1] * xyz.y + m[i, 2] * xyz.z
           for i in range(3)]
    if gamma_encode:
        rgb = [torch.pow(c.clamp_min(0.0), float(GAMMA_ENC)) for c in rgb]
    if clamp:
        rgb = [c.clamp(0.0, 1.0) for c in rgb]
    return V3(*rgb)
