"""Core wavefront record types (counterpart of core_tpu/types.py).

A whole wavefront is a NamedTuple of tensors: one leaf per field, leading
axis = ray index.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Rays(NamedTuple):
    """A wavefront of rays. o,d: [N,3]; tmin,tmax: [N] (tmax<0 => unbounded)."""
    o: torch.Tensor
    d: torch.Tensor
    tmin: torch.Tensor
    tmax: torch.Tensor


class Hits(NamedTuple):
    """Closest-hit record per ray.  prim == -1 means miss (t == -1 then)."""
    t: torch.Tensor       # [N] f32 hit distance
    prim: torch.Tensor    # [N] i32 triangle index (-1 miss)
    u: torch.Tensor       # [N] f32 barycentric u
    v: torch.Tensor       # [N] f32 barycentric v

    @property
    def valid(self):
        return self.prim >= 0
