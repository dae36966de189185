"""[..., 3] ("AoS") vector helpers and the ray-distance constants
(counterpart of core_tpu/mathutils.py).

Only what the slice calls: the camera builds its rays in [N, 3] form and
normalizes them here; everything on the wavefront after that is SoA (vec.py).
Dot products are written out as (x + y) + z so the summation order does not
depend on a reduction kernel.
"""
from __future__ import annotations

import torch

# Match the reference's compile-time constants (core_tpu/mathutils.py:14-15).
MIN_RAYDIST = 5.0e-5
SHADOW_BIAS = 5.0e-4


def dot(a, b):
    """Batched 3-vector dot product [..., 3] x [..., 3] -> [...]."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def normalize(a, eps: float = 1e-20):
    """Safe normalize; zero vectors stay (near) zero instead of NaN."""
    n2 = dot(a, a)[..., None]
    return a * torch.where(n2 > eps, torch.rsqrt(n2.clamp_min(eps)), 0.0)
