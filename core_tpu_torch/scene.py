"""Scene container and the scene-level entry points of the wavefront
(counterpart of core_tpu/scene.py).

Every integrator reaches geometry through these module functions
(closest_hit_s, any_hit_nee_s, surface_points_s, material_params_s), so a
caller can count or wrap them in one place.

Intersection backend: "cuda" runs the hand-written kernels
(geometry/cuda_intersect.py), "torch" their plain PyTorch versions
(geometry/intersect.py).  resolve_intersector picks "cuda" for a scene on a
CUDA device and "torch" for one on the CPU; nothing else changes the path,
and a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from core_tpu_torch.cameras import Camera
from core_tpu_torch.geometry import cuda_intersect
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.materials.base import (MaterialTable, MatParamsS,
                                           MatType, gather_params_s)
from core_tpu_torch.types import Hits
from core_tpu_torch.vec import (SPS, V3, RaysS, create_cs3, cross3, dot3,
                                normalize3, where3)

INTERSECTORS = ("cuda", "torch")


@dataclass(frozen=True)
class Scene:
    geom: GeomData
    materials: MaterialTable
    lights: tuple                   # tuple of light containers
    camera: Camera
    # static capability flags from the material defs at build time
    has_specular: bool = True
    has_transparency: bool = False
    mat_types: tuple = ()           # MatType values present in the table
    intersector: str = "torch"      # "cuda" | "torch", see resolve_intersector

    @property
    def device(self) -> torch.device:
        return self.geom.verts.device

    @functools.cached_property
    def tri(self) -> torch.Tensor:
        """[T, 9] v0/e1/e2 rows the intersectors read, packed once per
        scene (a changed geometry is a new Scene, so the cache never goes
        stale)."""
        return isect.pack_tris(self.geom.verts, self.geom.tri_vidx)


def resolve_intersector(requested: str, device) -> str:
    """'auto' -> 'cuda' for a scene on a CUDA device, 'torch' on the CPU."""
    if requested == "auto":
        return "cuda" if torch.device(device).type == "cuda" else "torch"
    if requested not in INTERSECTORS:
        raise ValueError(f"unknown intersector {requested!r}; "
                         f"expected 'auto' or one of {INTERSECTORS}")
    return requested


def _detach_rays(rays_s: RaysS) -> RaysS:
    """Intersection is not a gradient path (core_tpu/scene.py:81-95)."""
    return RaysS(o=rays_s.o.detach(), d=rays_s.d.detach(),
                 tmin=rays_s.tmin.detach(), tmax=rays_s.tmax.detach())


def closest_hit_s(scene: Scene, rays_s: RaysS, exclude_prim=None) -> Hits:
    """SoA closest hit (vec.RaysS in, Hits out)."""
    fn = (cuda_intersect.closest_hit_cuda if scene.intersector == "cuda"
          else isect.closest_hit_torch)
    return fn(scene.tri, _detach_rays(rays_s), exclude_prim=exclude_prim)


def any_hit_nee_s(scene: Scene, origin: V3, tmin, dirs, tcaps,
                  exclude_prim=None, exclude_prim2=None):
    """Occlusion for K shadow rays per lane sharing one origin (the NEE
    bundle).  origin: V3 [N]; dirs: list of K V3 [N]; tcaps: list of K [N].
    Returns [K*N] bool, sample-major."""
    fn = (cuda_intersect.any_hit_nee_cuda if scene.intersector == "cuda"
          else isect.any_hit_nee_torch)
    return fn(scene.tri, origin.detach(), tmin.detach(),
              [d.detach() for d in dirs], [t.detach() for t in tcaps],
              exclude_prim=exclude_prim, exclude_prim2=exclude_prim2)


def _triangle_rows(g: GeomData):
    """[28, T] per-triangle attribute table: corner positions (9), corner
    normals (9), corner uvs (6), smooth, mat, light, obj — the column order
    of core_tpu's one-hot decode table, read here with an index gather."""
    T = g.n_tris
    f32 = torch.float32
    tv = g.verts[g.tri_vidx.long()]                       # [T, 3, 3]
    ids = torch.stack([g.smooth.to(f32), g.tri_mat.to(f32),
                       g.tri_light.to(f32), g.tri_obj.to(f32)], dim=1)
    return torch.cat([tv.reshape(T, 9), g.corner_n.reshape(T, 9),
                      g.uvs.reshape(T, 6), ids], dim=1).t()


def surface_points_s(scene: Scene, rays_s: RaysS, hits: Hits) -> SPS:
    """SoA shading records at the hits (reference triangle_t::getSurface).
    Misses yield rows of triangle 0 that callers mask out."""
    g = scene.geom
    prim = hits.prim.clamp(0, g.n_tris - 1)
    rows = _triangle_rows(g).index_select(1, prim.long())   # [28, N]
    a = V3(rows[0], rows[1], rows[2])
    b = V3(rows[3], rows[4], rows[5])
    c = V3(rows[6], rows[7], rows[8])
    cn0 = V3(rows[9], rows[10], rows[11])
    cn1 = V3(rows[12], rows[13], rows[14])
    cn2 = V3(rows[15], rows[16], rows[17])
    uv00, uv01 = rows[18], rows[19]
    uv10, uv11 = rows[20], rows[21]
    uv20, uv21 = rows[22], rows[23]
    smooth = rows[24] > 0.5
    mat = rows[25].to(torch.int32)
    light = rows[26].to(torch.int32)
    obj = rows[27].to(torch.int32)

    t = torch.where(hits.prim >= 0, hits.t, 0.0)
    u = hits.u
    v = hits.v
    if torch.is_grad_enabled():
        # straight-through differentiable hit coordinates: re-derive
        # (t, u, v) from the hit triangle's corners and add only the AD
        # delta, so forward values stay bit-identical to the kernel's while
        # the backward pass sees d(hit)/d(vertex) (core_tpu/scene.py:322-348).
        # In a forward-only render the delta is exactly 0, so it is skipped.
        e1 = b - a
        e2 = c - a
        pv = cross3(rays_s.d, e2)
        det = dot3(e1, pv)
        safe = det.abs() > 1e-12
        inv = 1.0 / torch.where(safe, det, 1.0)
        tv = rays_s.o - a
        qv = cross3(tv, e1)
        u_d = dot3(tv, pv) * inv
        v_d = dot3(rays_s.d, qv) * inv
        t_d = dot3(e2, qv) * inv
        live = (hits.prim >= 0) & safe
        t = torch.where(live, t + (t_d - t_d.detach()), t)
        u = torch.where(live, u + (u_d - u_d.detach()), u)
        v = torch.where(live, v + (v_d - v_d.detach()), v)
    w0 = 1.0 - u - v
    p = rays_s.o + rays_s.d * t
    uu = uv00 * w0 + uv10 * u + uv20 * v
    vv = uv01 * w0 + uv11 * u + uv21 * v

    ng = normalize3(cross3(b - a, c - a))
    n_smooth = normalize3(cn0 * w0 + cn1 * u + cn2 * v)
    n = where3(smooth, n_smooth, ng)
    nu, nv = create_cs3(n)
    return SPS(p=p, n=n, ng=ng, nu=nu, nv=nv, u=uu, v=vv,
               mat=mat, light=light, prim=prim, obj=obj)


def material_params_s(scene: Scene, sps: SPS) -> MatParamsS:
    """SoA material rows for the hits: the plain-table branch (no blend or
    mask composites, no textures, no shader nodes)."""
    composite = {int(MatType.BLEND), int(MatType.MASK)} & set(scene.mat_types)
    if composite:
        raise NotImplementedError(
            "blend/mask materials are not ported to core_tpu_torch yet")
    return gather_params_s(scene.materials, sps.mat)
