"""Ray differentials and parametric surface derivatives
(counterpart of core_tpu/differentials.py).

Reference: include/core_api/ray.h:38-57 (diffRay_t: the +1-pixel x and y
neighbour rays shot beside every camera ray, integrator.cc:299-304) and
include/core_api/surface.h:105-118 + src/yafraycore/surface.cc
(spDifferentials_t: the neighbours projected onto the hit's tangent plane,
dPdx / dPdy, solved against the parametric dPdU / dPdV for the UV-space
footprint).  The footprint selects image-texture mip levels.

Everything is over the SoA wavefront (vec.V3 / vec.SPS); dPdU / dPdV come
from the hit triangle's corners and uvs, falling back to the shading frame
(nu, nv) where a triangle's uvs are degenerate.
"""
from __future__ import annotations

import torch

from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.vec import SPS, V3, RaysS, dot3, v3, where3


def surface_dpduv(scene, sps: SPS):
    """(dPdU, dPdV): the parametric position derivatives (V3 [N]) at the
    hit triangles; the shading frame (nu, nv) where the uvs are
    degenerate."""
    rows = scene.tri_rows.index_select(1, sps.prim.long())
    a = V3(rows[0], rows[1], rows[2])
    e1 = V3(rows[3], rows[4], rows[5]) - a
    e2 = V3(rows[6], rows[7], rows[8]) - a
    du1, dv1 = rows[20] - rows[18], rows[21] - rows[19]
    du2, dv2 = rows[22] - rows[18], rows[23] - rows[19]
    det = du1 * dv2 - dv1 * du2
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)
    dpdu = (e1 * dv2 - e2 * dv1) * inv
    dpdv = (e1 * -du2 + e2 * du1) * inv
    return where3(ok, dpdu, sps.nu), where3(ok, dpdv, sps.nv)


def camera_diff_dirs(cam, px, py, lu=None, lv=None):
    """Directions (V3 [N]) of the +1-pixel x and y neighbour rays of the
    camera rays through (px, py), shot with the same lens sample (lu, lv)
    (integrator.cc:299-304)."""
    rx, _ = shoot_ray(cam, px + 1.0, py, lu, lv)
    ry, _ = shoot_ray(cam, px, py + 1.0, lu, lv)
    return v3(rx.d), v3(ry.d)


def sp_differentials(p: V3, n: V3, o: V3, dxd: V3, dyd: V3):
    """dPdx, dPdy: where the neighbour rays from the shared origin o meet
    the plane through p with normal n, less p (spDifferentials_t ctor)."""
    dist = dot3(p - o, n)

    def offset(d):
        denom = dot3(d, n)
        t = dist / torch.where(denom.abs() < 1e-9,
                               torch.where(denom < 0, -1e-9, 1e-9), denom)
        return o + d * t - p

    return offset(dxd), offset(dyd)


def uv_differentials(dpdx: V3, dpdy: V3, dpdu: V3, dpdv: V3, n: V3):
    """(dudx, dvdx, dudy, dvdy) [N]: dPdx = dudx dPdU + dvdx dPdV (and so
    for y) solved on the two axes the normal leaves
    (spDifferentials_t::getUVdifferentials); 0 where singular."""
    ax, ay, az = n.x.abs(), n.y.abs(), n.z.abs()
    drop_x = (ax >= ay) & (ax >= az)
    drop_y = ~drop_x & (ay >= az)

    def pick2(w: V3):
        return (torch.where(drop_x, w.y, w.x),
                torch.where(drop_x | drop_y, w.z, w.y))

    a00, a10 = pick2(dpdu)
    a01, a11 = pick2(dpdv)
    det = a00 * a11 - a01 * a10
    ok = det.abs() > 1e-12
    inv = 1.0 / torch.where(ok, det, 1.0)

    def solve(rhs):
        b0, b1 = pick2(rhs)
        du = (b0 * a11 - b1 * a01) * inv
        dv = (b1 * a00 - b0 * a10) * inv
        return torch.where(ok, du, 0.0), torch.where(ok, dv, 0.0)

    dudx, dvdx = solve(dpdx)
    dudy, dvdy = solve(dpdy)
    return dudx, dvdx, dudy, dvdy


def texture_lod(scene, sps: SPS, rays_s: RaysS, dxd: V3, dyd: V3):
    """[N] UV-space footprint of the camera hits (the larger of the x and
    y neighbours' uv steps); the texture lookup scales it by its own
    resolution and repeats before the log2.  0 where none is
    recoverable."""
    dpdu, dpdv = surface_dpduv(scene, sps)
    dpdx, dpdy = sp_differentials(sps.p, sps.ng, rays_s.o, dxd, dyd)
    dudx, dvdx, dudy, dvdy = uv_differentials(dpdx, dpdy, dpdu, dpdv,
                                              sps.ng)
    w2 = torch.maximum(dudx * dudx + dvdx * dvdx, dudy * dudy + dvdy * dvdy)
    return torch.sqrt(w2.clamp_min(0.0))
