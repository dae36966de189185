"""Mesh light: any triangle set as an emitter (counterpart of
core_tpu/lights/mesh.py; reference src/lights/meshlight.cc).

Build time: the per-triangle area CDF in float64, stored as float32
(meshlight.cc initIS).  illum_sample_s picks a triangle by CDF inversion
and samples its surface with the sqrt warp (triangle_t::sample),
pdf = dist^2 pi / (area cos), the area light's convention.
intersect_light_s tests the light's own triangles for the BSDF side of
MIS (meshlight.cc:160-186): one batched test over [N, T] (in blocks of
triangles when N * T is large) where core_tpu loops over the triangles in
Python.  It keeps core_tpu's strict t < best_t, so among equal t the first
triangle in list order wins, the absolute t > 1e-5, the |det| > 1e-12
guard and the face-cosine gate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from core_tpu_torch.lights.base import LightHitS, LightSampleS
from core_tpu_torch.vec import V3, dot3, splat3

DIRAC = False
BLOCK_ELEMS = 1 << 22   # lanes x triangles per block of intersect_light_s


@dataclass(frozen=True)
class MeshLight:
    va: torch.Tensor       # [T,3] triangle corner A
    vb: torch.Tensor       # [T,3]
    vc: torch.Tensor       # [T,3]
    normals: torch.Tensor  # [T,3] geometric normals
    cdf: torch.Tensor      # [T] inclusive area CDF (last = 1)
    color: torch.Tensor    # [3] color * power * pi
    area: torch.Tensor     # [] total area
    samples: int = 4
    double_sided: bool = False
    obj_id: int = -1


def make_mesh_light(verts, tri_vidx, color, power, samples=4,
                    double_sided=False, obj_id=-1, *, device) -> MeshLight:
    """Same float64 host math as core_tpu's make_mesh_light."""
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tri_vidx, np.int64)
    a = verts[tris[:, 0]]
    b = verts[tris[:, 1]]
    c = verts[tris[:, 2]]
    n = np.cross(b - a, c - a)
    areas = 0.5 * np.linalg.norm(n, axis=1)
    n = n / np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    total = float(areas.sum())
    cdf = np.cumsum(areas) / max(total, 1e-20)

    def f(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return MeshLight(va=f(a), vb=f(b), vc=f(c), normals=f(n), cdf=f(cdf),
                     color=f(np.asarray(color, np.float32) * power * np.pi),
                     area=f(total), samples=int(samples),
                     double_sided=bool(double_sided), obj_id=int(obj_id))


def can_intersect(light: MeshLight) -> bool:
    return True


def get_n_samples(light: MeshLight) -> int:
    return light.samples


def _rows(m: torch.Tensor, t) -> V3:
    r = m[t]
    return V3(r[:, 0], r[:, 1], r[:, 2])


def _sample_surface(light: MeshLight, s1, s2):
    """CDF triangle pick (searchsorted 'left') + sqrt warp
    (triangle_t::sample): (point, face normal), V3 of [N]."""
    t = torch.searchsorted(light.cdf, s1).clamp(0, light.cdf.shape[0] - 1)
    lo = torch.where(t > 0, light.cdf[(t - 1).clamp_min(0)], 0.0)
    delta = (light.cdf[t] - lo).clamp_min(1e-12)
    ss1 = ((s1 - lo) / delta).clamp(0.0, 1.0)
    su = torch.sqrt(ss1.clamp_min(1e-12))
    a = _rows(light.va, t)
    b = _rows(light.vb, t)
    c = _rows(light.vc, t)
    p = a + (b - a) * (su * (1.0 - s2)) + (c - a) * (su * s2)
    return p, _rows(light.normals, t)


def illum_sample_s(light: MeshLight, sp, s1, s2) -> LightSampleS:
    p, n = _sample_surface(light, s1, s2)
    ldir = p - sp.p
    dist2 = dot3(ldir, ldir)
    dist = torch.sqrt(dist2)
    dm = dist.clamp_min(1e-12)
    wi = V3(ldir.x / dm, ldir.y / dm, ldir.z / dm)
    cos_angle = -dot3(wi, n)
    if light.double_sided:
        valid = dist > 0.0
        cos_angle = cos_angle.abs()
    else:
        valid = (dist > 0.0) & (cos_angle > 0.0)
    denom = light.area * cos_angle.clamp_min(0.0)
    pdf = dist2 * np.pi / denom.clamp_min(1e-8)
    return LightSampleS(valid=valid, wi=wi, dist=dist,
                        col=splat3(light.color, like=s1), pdf=pdf)


def _cols(m: torch.Tensor) -> V3:
    """[T,3] -> V3 of [1, T] rows, broadcasting against [N, 1] lanes."""
    return V3(m[None, :, 0], m[None, :, 1], m[None, :, 2])


def _block_hits(light: MeshLight, o: V3, d: V3, lo: int, hi: int):
    """Möller-Trumbore of every lane against triangles lo..hi-1 at once:
    the gated t [N, T'] (inf where missed) and the face cosines."""
    a = _cols(light.va[lo:hi])
    e1 = _cols(light.vb[lo:hi] - light.va[lo:hi])
    e2 = _cols(light.vc[lo:hi] - light.va[lo:hi])
    pvec = V3(d.y * e2.z - d.z * e2.y, d.z * e2.x - d.x * e2.z,
              d.x * e2.y - d.y * e2.x)
    det = dot3(e1, pvec)
    okd = det.abs() > 1e-12
    inv_det = torch.where(okd, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - a
    u = dot3(tvec, pvec) * inv_det
    qvec = V3(tvec.y * e1.z - tvec.z * e1.y, tvec.z * e1.x - tvec.x * e1.z,
              tvec.x * e1.y - tvec.y * e1.x)
    v = dot3(d, qvec) * inv_det
    t = dot3(e2, qvec) * inv_det
    cosa = -dot3(d, _cols(light.normals[lo:hi]))
    ok = okd & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-5) \
        & (t < 3.0e38)
    if light.double_sided:
        cosa = cosa.abs()
    else:
        ok = ok & (cosa > 0.0)
    return torch.where(ok, t, torch.inf), cosa


def intersect_light_s(light: MeshLight, rays) -> LightHitS:
    """Closest hit on the light's triangles (core_tpu's per-triangle loop
    with its strict t < best_t: of equal t the first triangle wins)."""
    o = V3(*(c[:, None] for c in rays.o))
    d = V3(*(c[:, None] for c in rays.d))
    n = rays.d.x.shape[0]
    T = light.va.shape[0]
    step = max(1, BLOCK_ELEMS // max(n, 1))
    best_t = torch.full_like(rays.d.x, torch.inf)
    best_cos = torch.zeros_like(rays.d.x)
    for lo in range(0, T, step):
        t, cosa = _block_hits(light, o, d, lo, min(T, lo + step))
        # argmin returns the first of equal minima: list order breaks ties
        k = t.argmin(dim=1, keepdim=True)
        tb = t.gather(1, k)[:, 0]
        take = tb < best_t
        best_t = torch.where(take, tb, best_t)
        best_cos = torch.where(take, cosa.gather(1, k)[:, 0], best_cos)
    hit = torch.isfinite(best_t)
    t_safe = torch.where(hit, best_t, 1.0)
    ipdf = torch.where(hit, light.area * best_cos
                       / (t_safe * t_safe).clamp_min(1e-12) / np.pi, 0.0)
    return LightHitS(valid=hit, t=torch.where(hit, best_t, -1.0),
                     col=splat3(light.color, like=rays.d.x), ipdf=ipdf)


def illum_pdf_s(light: MeshLight, sp, p_light: V3):
    wi = sp.p - p_light     # from the light surface toward the shaded point
    return dot3(wi, wi) * np.pi / light.area.clamp_min(1e-12)
