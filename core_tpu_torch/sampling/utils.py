"""Direction sampling (counterpart of core_tpu/sampling/utils.py).

The cosine-weighted hemisphere and the uniform cone in SoA form (core_tpu
keeps the hemisphere's SoA variant inside materials/shinydiffuse.py; it
lives here beside its AoS counterpart's home), the concentric disk of the
thin-lens camera, and the uniform sphere and minimum-rotation frame of
photon emission.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.vec import V3, cross3, dot3

M_2PI = 2.0 * np.pi


def sample_cos_hemisphere_s(n: V3, ru: V3, rv: V3, s1, s2) -> V3:
    """Cosine-weighted hemisphere around unit n with frame (ru, rv)
    (reference sample_utils.h:41-52):
    dir = (ru cos(2pi s2) + rv sin(2pi s2)) sqrt(1-s1) + n sqrt(s1)."""
    z1 = s1.clamp(0.0, 1.0)
    a = M_2PI * s2
    r = torch.sqrt((1.0 - z1).clamp_min(1e-12))
    return (ru * (torch.cos(a) * r) + rv * (torch.sin(a) * r)
            + n * torch.sqrt(z1.clamp_min(1e-12)))


def sample_cone_s(d: V3, u: V3, v: V3, max_cos_ang, s1, s2) -> V3:
    """Uniform cone around unit d with frame (u, v) (sample_utils.h:80-86)."""
    cos_ang = 1.0 - (1.0 - max_cos_ang) * s2
    sin_ang = torch.sqrt((1.0 - cos_ang * cos_ang).clamp_min(1e-12))
    t1 = M_2PI * s1
    return (u * torch.cos(t1) + v * torch.sin(t1)) * sin_ang + d * cos_ang


def shirley_disk(r1, r2):
    """Concentric disk mapping (reference ShirleyDisk): (u, v) in the unit
    disk."""
    a = 2.0 * r1 - 1.0
    b = 2.0 * r2 - 1.0
    use_a = a.abs() > b.abs()
    r = torch.where(use_a, a, b)
    safe_a = torch.where(a.abs() > 1e-12, a, 1e-12)
    safe_b = torch.where(b.abs() > 1e-12, b, 1e-12)
    phi = torch.where(use_a, (np.pi / 4.0) * (b / safe_a),
                      (np.pi / 2.0) - (np.pi / 4.0) * (a / safe_b))
    both_zero = (a.abs() < 1e-12) & (b.abs() < 1e-12)
    r = torch.where(both_zero, 0.0, r)
    phi = torch.where(both_zero, 0.0, phi)
    return r * torch.cos(phi), r * torch.sin(phi)


def sample_sphere(s1, s2) -> V3:
    """Uniform sphere (reference sample_utils.h:56-76)."""
    z = 1.0 - 2.0 * s1
    r = torch.sqrt((1.0 - z * z).clamp_min(1e-12))
    a = M_2PI * s2
    return V3(torch.cos(a) * r, torch.sin(a) * r, z)


def min_rot(d: V3, u: V3, d2: V3):
    """The frame (d, u) turned onto the direction d2 (reference minRot,
    sample_utils.h:158-167), as core_tpu computes it: the (1 - cos) term
    adds the scalar (v . u) to every component.  Returns (u2, v2)."""
    cos_alpha = dot3(d, d2)
    sin_alpha = torch.sqrt((1.0 - cos_alpha * cos_alpha).clamp_min(1e-12))
    v = cross3(d, d2)
    u2 = u * cos_alpha + (1.0 - cos_alpha) * dot3(v, u) \
        + cross3(v, u) * sin_alpha
    return u2, cross3(d2, u2)
