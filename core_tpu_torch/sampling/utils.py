"""Direction sampling (counterpart of core_tpu/sampling/utils.py).

Only what the slice's shiny-diffuse material calls: the cosine-weighted
hemisphere in SoA form.  core_tpu keeps this SoA variant inside
materials/shinydiffuse.py; it lives here beside its AoS counterpart's home.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.vec import V3

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
