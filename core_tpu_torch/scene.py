"""Scene container and the scene-level entry points of the wavefront
(counterpart of core_tpu/scene.py).

Every integrator reaches geometry through these module functions
(closest_hit_s, any_hit_s, any_hit_nee_s, surface_points_s,
material_params_s), so a caller can count or wrap them in one place.

Intersection: `_backend` is the one dispatch point.  It picks by the
scene's accel (None = the brute kernels 1 and 2 over the packed triangle
table; a cluster_intersect.GroupedAccel = the grouped kernels 7 and 8) and
by its intersector ("cuda" = the hand-written kernels, "torch" = their plain
PyTorch versions).  resolve_intersector picks "cuda" for a scene on a CUDA
device and "torch" for one on the CPU; nothing else changes the path, and a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import torch

from core_tpu_torch.cameras import Camera
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster, cuda_intersect
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.materials.base import (MaterialTable, MatParamsS,
                                           MatType, gather_params_s)
from core_tpu_torch.textures.base import eval_texture
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
    background: Any = None          # backgrounds.TextureBackground or None
    accel: Any = None               # cluster_intersect.GroupedAccel or None
    textures: Any = None            # textures.base.CompiledTextures or None
    # static capability flags from the material defs at build time
    has_specular: bool = True
    has_transparency: bool = False
    mat_types: tuple = ()           # MatType values present in the table
    intersector: str = "torch"      # "cuda" | "torch", see resolve_intersector

    @property
    def device(self) -> torch.device:
        return self.geom.verts.device

    # a changed geometry is a new Scene, so neither cache goes stale
    @functools.cached_property
    def tri(self) -> torch.Tensor:
        """[T, 9] v0/e1/e2 rows the brute intersectors read."""
        return isect.pack_tris(self.geom.verts, self.geom.tri_vidx)

    @functools.cached_property
    def tri_rows(self) -> torch.Tensor:
        """[28, T] per-triangle attribute table of surface_points_s."""
        return _triangle_rows(self.geom)


def check_device(device) -> torch.device:
    """The device a scene is built on; a CUDA device without a card raises
    (entry points default to the card and never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device for a scene on {device}: pass "
                           "device='cpu' to build it on the CPU")
    return device


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


def _nee_rebucketed(any_hit):
    def nee(acc, o3, tmin, dirs, tcaps, exclude_prim=None,
            exclude_prim2=None):
        return ci.any_hit_nee_clusters_s(acc, o3, tmin, dirs, tcaps,
                                         exclude_prim, exclude_prim2, any_hit)
    return nee


# (accel kind, intersector) -> query -> function(data, ...)
_ROUTES = {
    ("brute", "cuda"): {"closest": cuda_intersect.closest_hit_cuda,
                        "nee": cuda_intersect.any_hit_nee_cuda},
    ("brute", "torch"): {"closest": isect.closest_hit_torch,
                         "nee": isect.any_hit_nee_torch},
    ("grouped", "cuda"): {
        "closest": cuda_cluster.closest_hit_grouped_cuda,
        "any": cuda_cluster.any_hit_grouped_cuda,
        "nee": _nee_rebucketed(cuda_cluster.any_hit_grouped_cuda)},
    ("grouped", "torch"): {
        "closest": ci.closest_hit_grouped_torch,
        "any": ci.any_hit_grouped_torch,
        "nee": _nee_rebucketed(ci.any_hit_grouped_torch)},
}


def _backend(scene: Scene, query: str):
    """(data, function) answering `query` ("closest", "any" or "nee") for
    the scene's accel and intersector."""
    kind = "brute" if scene.accel is None else "grouped"
    fn = _ROUTES[kind, scene.intersector].get(query)
    if fn is None:
        raise NotImplementedError(
            "one-ray-per-lane any-hit on the brute path needs kernel 3 "
            "(pallas_intersect._any_hit_kernel), not ported to "
            "core_tpu_torch yet")
    return (scene.tri if scene.accel is None else scene.accel), fn


def closest_hit_s(scene: Scene, rays_s: RaysS, exclude_prim=None) -> Hits:
    """SoA closest hit (vec.RaysS in, Hits out)."""
    data, fn = _backend(scene, "closest")
    return fn(data, _detach_rays(rays_s), exclude_prim=exclude_prim)


def any_hit_s(scene: Scene, rays_s: RaysS, exclude_prim=None,
              exclude_prim2=None):
    """Occlusion of one ray per lane (tmax <= 0 = open); [N] bool."""
    data, fn = _backend(scene, "any")
    return fn(data, _detach_rays(rays_s), exclude_prim=exclude_prim,
              exclude_prim2=exclude_prim2)


def any_hit_nee_s(scene: Scene, origin: V3, tmin, dirs, tcaps,
                  exclude_prim=None, exclude_prim2=None):
    """Occlusion for K shadow rays per lane sharing one origin (the NEE
    bundle).  origin: V3 [N]; dirs: list of K V3 [N]; tcaps: list of K [N].
    Returns [K*N] bool, sample-major."""
    data, fn = _backend(scene, "nee")
    return fn(data, origin.detach(), tmin.detach(),
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
    rows = scene.tri_rows.index_select(1, prim.long())      # [28, N]
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
    """SoA material rows for the hits: the table rows, with a mapped
    diffuse texture replacing the diffuse colour per hit (core_tpu
    material_params, the reference's shader-node substitution in initBSDF,
    glossy2.cc:88-96).  Blend and mask composites raise by name."""
    composite = {int(MatType.BLEND), int(MatType.MASK)} & set(scene.mat_types)
    if composite:
        raise NotImplementedError(
            "blend/mask materials are not ported to core_tpu_torch yet")
    p = gather_params_s(scene.materials, sps.mat)
    if scene.textures is None:
        return p
    idx = sps.mat.clamp(0, scene.materials.mtype.shape[0] - 1).long()
    tex = scene.materials.diffuse_tex.index_select(0, idx)
    rgb, _ = eval_texture(scene.textures, tex, sps.p)
    return p._replace(diffuse_color=where3(tex >= 0, rgb, p.diffuse_color))
