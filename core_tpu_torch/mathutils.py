"""Vector helpers and the ray-distance constants
(counterpart of core_tpu/mathutils.py).

`dot` and `normalize` work on [..., 3] ("AoS") tensors: the camera builds
its rays in that form.  Everything on the wavefront after that is SoA
(vec.V3), and so are the specular helpers here: reflect_dir, refract_dir
and fresnel_dielectric.  Dot products are written out as (x + y) + z so the
summation order does not depend on a reduction kernel.
"""
from __future__ import annotations

import torch

from core_tpu_torch.vec import V3, dot3, normalize3, where3

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


def reflect_dir(n: V3, w: V3) -> V3:
    """Mirror reflection of w about n, 2*(n.w)*n - w (both unit, w pointing
    away from the surface; reference vector3d.h reflect_plane)."""
    return n * (2.0 * dot3(n, w)) - w


def refract_dir(n: V3, wi: V3, ior):
    """Refraction of wi (pointing away from the surface) through a surface
    of normal n and relative IOR ior (reference vector3d.h refract) ->
    (valid [N] bool, unit direction V3).  Total internal reflection gives
    valid False; k is zeroed on those lanes before the sqrt, so the
    backward pass sees no NaN there (core_tpu/mathutils.py:60-76)."""
    cos_i = dot3(n, wi)
    entering = cos_i > 0.0
    eta = torch.where(entering, 1.0 / ior, ior)
    n_eff = where3(entering, n, -n)
    c = cos_i.abs()
    k = 1.0 - eta * eta * (1.0 - c * c)
    valid = k > 0.0
    k_safe = torch.where(valid, k, 0.0)
    t = wi * (-eta) + n_eff * (eta * c - torch.sqrt(k_safe))
    return valid, normalize3(t)


def fresnel_dielectric(cos_i, ior):
    """Unpolarized dielectric Fresnel reflectance on |cos_i| (the g/c form
    of the reference's vector3d.h `fresnel`)."""
    c = cos_i.abs()
    g2 = ior * ior + c * c - 1.0
    tir = g2 <= 0.0
    g = torch.sqrt(g2.clamp_min(0.0))
    aux = c * (g + c)
    num = (g - c) / (g + c).clamp_min(1e-12)
    frac = (aux - 1.0) / (aux + 1.0).clamp_min(1e-12)
    kr = 0.5 * num * num * (1.0 + frac * frac)
    return torch.where(tir, 1.0, kr.clamp(0.0, 1.0))


def luminance(c: V3):
    """Colour energy (r+g+b)/3 as core_tpu/mathutils.py computes it, a mean:
    the sum divided by 3 (vec.luminance3 multiplies by 1/3, as core_tpu's
    vec.luminance3 does; the two can differ by an ulp, and the specular
    chain picks its branch on this one)."""
    return (c.x + c.y + c.z) / 3.0
