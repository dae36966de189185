"""SoA 3-vector math (counterpart of core_tpu/vec.py).

V3 keeps the three components of a vector or RGB colour as separate dense
[N] tensors.  The port keeps this layout because it is the public layout the
two packages are compared in, and because it gives unit-stride elementwise
kernels on the GPU as well.

Lane layout of the batching helpers: tile*(a, reps) puts copy i of lane j at
lane i*N + j ("sample-major"), and untile_sum3 sums those copies back.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class V3(NamedTuple):
    """Three same-shaped tensors; represents vectors or RGB colours."""
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    # -- arithmetic (V3 op V3 elementwise; V3 op tensor/scalar broadcasts) --
    def __add__(self, o):
        if isinstance(o, V3):
            return V3(self.x + o.x, self.y + o.y, self.z + o.z)
        return V3(self.x + o, self.y + o, self.z + o)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, V3):
            return V3(self.x - o.x, self.y - o.y, self.z - o.z)
        return V3(self.x - o, self.y - o, self.z - o)

    def __rsub__(self, o):
        return V3(o - self.x, o - self.y, o - self.z)

    def __mul__(self, o):
        if isinstance(o, V3):
            return V3(self.x * o.x, self.y * o.y, self.z * o.z)
        return V3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __neg__(self):
        return V3(-self.x, -self.y, -self.z)

    def detach(self) -> "V3":
        return V3(self.x.detach(), self.y.detach(), self.z.detach())


def v3(a) -> V3:
    """[..., 3] AoS tensor -> V3 (contiguous components)."""
    return V3(a[..., 0].contiguous(), a[..., 1].contiguous(),
              a[..., 2].contiguous())


def splat3(row, like=None) -> V3:
    """[3] tensor -> V3 of 0-d tensors (or broadcast to like's shape)."""
    if like is None:
        return V3(row[0], row[1], row[2])
    return V3(row[0].expand_as(like), row[1].expand_as(like),
              row[2].expand_as(like))


def zeros3(like) -> V3:
    z = torch.zeros_like(like, dtype=torch.float32)
    return V3(z, z, z)


def dot3(a: V3, b: V3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross3(a: V3, b: V3) -> V3:
    return V3(a.y * b.z - a.z * b.y,
              a.z * b.x - a.x * b.z,
              a.x * b.y - a.y * b.x)


def normalize3(a: V3, eps: float = 1e-20) -> V3:
    n2 = dot3(a, a)
    inv = torch.where(n2 > eps, torch.rsqrt(n2.clamp_min(eps)), 0.0)
    return a * inv


def where3(m, a: V3, b) -> V3:
    """Select with a [N] bool mask; b may be V3 or scalar."""
    if not isinstance(b, V3):
        return V3(torch.where(m, a.x, b), torch.where(m, a.y, b),
                  torch.where(m, a.z, b))
    return V3(torch.where(m, a.x, b.x), torch.where(m, a.y, b.y),
              torch.where(m, a.z, b.z))


def luminance3(c: V3):
    """Reference color_t::energy: (r+g+b)/3."""
    return (c.x + c.y + c.z) * (1.0 / 3.0)


def create_cs3(n: V3):
    """Orthonormal frame around unit n (reference createCS, vector3d.h)."""
    degenerate = (n.x.abs() < 1e-6) & (n.y.abs() < 1e-6)
    d = torch.sqrt((n.y * n.y + n.x * n.x).clamp_min(1e-20))
    inv_d = 1.0 / d
    sign = torch.where(n.z < 0.0, -1.0, 1.0)
    u = V3(torch.where(degenerate, sign, n.y * inv_d),
           torch.where(degenerate, 0.0, -n.x * inv_d),
           torch.zeros_like(n.z))
    v = cross3(n, u)
    return u, v


def tile1(c, reps: int):
    """[N] -> [reps*N]: copy i of lane j lands at lane i*N + j."""
    return c.repeat(reps)


def tile3(a: V3, reps: int) -> V3:
    return V3(tile1(a.x, reps), tile1(a.y, reps), tile1(a.z, reps))


def map_lanes(fn, x):
    """fn applied to every per-lane tensor of x: a tensor, or a V3, SPS,
    MatParamsS (any NamedTuple of them) or plain tuple of them."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    out = (map_lanes(fn, a) for a in x)
    return tuple(out) if type(x) is tuple else type(x)(*out)


def untile_sum3(a: V3, reps: int) -> V3:
    """Inverse of tile3 + sum over the sample axis: [reps*N] -> [N]."""
    def u(c):
        c = c.reshape(reps, -1)
        acc = c[0]
        for k in range(1, reps):
            acc = acc + c[k]
        return acc
    return V3(u(a.x), u(a.y), u(a.z))


# ---------------------------------------------------------------------------
# SoA wavefront records
# ---------------------------------------------------------------------------

class RaysS(NamedTuple):
    """SoA ray wavefront. o,d: V3 of [N]; tmin,tmax: [N] (tmax<0 unbounded)."""
    o: V3
    d: V3
    tmin: torch.Tensor
    tmax: torch.Tensor


class SPS(NamedTuple):
    """SoA surface points (reference surfacePoint_t, surface.h:63-101)."""
    p: V3
    n: V3
    ng: V3
    nu: V3
    nv: V3
    u: torch.Tensor        # [N] texture u
    v: torch.Tensor        # [N] texture v
    mat: torch.Tensor      # [N] i32
    light: torch.Tensor    # [N] i32 bound area-light id (-1 none)
    prim: torch.Tensor     # [N] i32
    obj: torch.Tensor      # [N] i32


def rays_to_soa(rays) -> RaysS:
    return RaysS(o=v3(rays.o), d=v3(rays.d), tmin=rays.tmin, tmax=rays.tmax)
