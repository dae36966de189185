"""Debug integrator: shading-geometry quantities as colours
(counterpart of core_tpu/integrators/debug.py; reference
src/integrators/DebugIntegrator.cc:34-131).

N, NU and NV are the shading frame; dPdU / dPdV the parametric position
derivatives of the hit triangle's uvs (differentials.surface_dpduv, the
shading frame where the uvs are degenerate), normalised; dSdU / dSdV the
corner-normal deltas along the parametric directions (zero where the uvs
are degenerate).  Colours are remapped to 0.5 v + 0.5 unless show_pn.
Only the camera rays are traced (scene.closest_hit_s: kernel 1, 4 or 7).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.differentials import surface_dpduv
from core_tpu_torch.vec import V3, normalize3, rays_to_soa, where3

DEBUG_TYPES = ("N", "dPdU", "dPdV", "NU", "NV", "dSdU", "dSdV")


@dataclass(frozen=True)
class DebugOptions:
    """core_tpu's DebugOptions (core_tpu/integrators/debug.py:22-25)."""
    debug_type: str = "N"      # N | dPdU | dPdV | NU | NV | dSdU | dSdV
    show_pn: bool = False      # pShowPN: the raw value, not remapped


def _dsduv(scene, sps):
    """The smoothed normal's derivatives along the parametric directions:
    the corner-normal deltas solved through the triangle's uv map (the
    geometry's corner_n and uvs, as scene.tri_rows holds them)."""
    rows = scene.tri_rows.index_select(1, sps.prim.long())
    cn0 = V3(rows[9], rows[10], rows[11])
    dn1 = V3(rows[12], rows[13], rows[14]) - cn0
    dn2 = V3(rows[15], rows[16], rows[17]) - cn0
    du1, dv1 = rows[20] - rows[18], rows[21] - rows[19]
    du2, dv2 = rows[22] - rows[18], rows[23] - rows[19]
    det = du1 * dv2 - dv1 * du2
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    dsdu = (dn1 * dv2 - dn2 * dv1) * inv
    dsdv = (dn1 * -du2 + dn2 * du1) * inv
    return where3(ok, dsdu, 0.0), where3(ok, dsdv, 0.0)


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: DebugOptions):
    """Debug integrate() for a camera wavefront -> rgba [N, 4]; alpha 1 on
    hits, 0 (and black) on misses."""
    if opts.debug_type not in DEBUG_TYPES:
        raise ValueError(f"debug_type {opts.debug_type!r} is not one of "
                         f"{DEBUG_TYPES}")
    rs = rays_to_soa(rays)
    hits = scene_mod.closest_hit_s(scene, rs)
    sps = scene_mod.surface_points_s(scene, rs, hits)
    if opts.debug_type in ("dPdU", "dPdV"):
        dpdu, dpdv = surface_dpduv(scene, sps)
        vec = normalize3(dpdu if opts.debug_type == "dPdU" else dpdv)
    elif opts.debug_type in ("dSdU", "dSdV"):
        dsdu, dsdv = _dsduv(scene, sps)
        vec = dsdu if opts.debug_type == "dSdU" else dsdv
    else:
        vec = {"N": sps.n, "NU": sps.nu, "NV": sps.nv}[opts.debug_type]
    col = vec if opts.show_pn else vec * 0.5 + 0.5
    col = where3(hits.valid, col, 0.0)
    return torch.stack([col.x, col.y, col.z,
                        hits.valid.to(torch.float32)], dim=-1)
