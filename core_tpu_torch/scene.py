"""Scene container and the scene-level entry points of the wavefront
(counterpart of core_tpu/scene.py).

Every integrator reaches geometry through these module functions
(closest_hit_s, any_hit_s, any_hit_nee_s, surface_points_s,
material_params_s), so a caller can count or wrap them in one place.

Intersection: `_backend` is the one dispatch point.  It picks by the
scene's accel (None = the brute kernels 1-3 over the packed triangle
table; a cluster_intersect.ClusterAccel = the flat cluster kernels 4-6; a
cluster_intersect.GroupedAccel = the grouped kernels 7 and 8) and by its
intersector ("cuda" = the hand-written kernels, "torch" = their plain
PyTorch versions).  resolve_intersector picks "cuda" for a scene on a CUDA
device and "torch" for one on the CPU; nothing else changes the path, and a
kernel that fails to build or launch raises.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from core_tpu_torch.cameras import Camera
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster, cuda_intersect
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.materials.base import (MaterialTable, MatParamsS,
                                           MatType, gather_params_s)
from core_tpu_torch.sampling import qmc
from core_tpu_torch.textures.base import eval_texture
from core_tpu_torch.textures.nodes import eval_graph
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
    accel: Any = None               # cluster_intersect accel, None = brute
    textures: Any = None            # textures.base.CompiledTextures or None
    volumes: tuple = ()             # volumes.regions region containers
    n_objects: int = 0              # core_tpu's static object count
    # static capability flags from the material defs at build time
    has_specular: bool = True
    has_transparency: bool = False
    mat_types: tuple = ()           # MatType values present in the table
    # shader-node programs: (mat_index, slot, node defs, out node name)
    node_programs: tuple = ()
    texture_name_map: tuple = ()    # sorted (texture name, index) pairs
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

    @functools.cached_property
    def table_textures(self) -> tuple:
        """The texture defs the material table names (diffuse and blend
        textures), read once per Scene so that texture evaluation needs no
        host synchronisation per call."""
        ids = torch.cat([self.materials.diffuse_tex,
                         self.materials.blend_tex]).unique().tolist()
        return tuple(i for i in ids if i >= 0)


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


def _detached(a: torch.Tensor) -> torch.Tensor:
    """Intersection is not a gradient path (core_tpu/scene.py:81-95), and
    the kernels read every component as one contiguous array (a dirac
    light's direction, for one, arrives broadcast)."""
    return a.detach().contiguous()


def _detach_v3(v: V3) -> V3:
    return V3(_detached(v.x), _detached(v.y), _detached(v.z))


def _detach_rays(rays_s: RaysS) -> RaysS:
    return RaysS(o=_detach_v3(rays_s.o), d=_detach_v3(rays_s.d),
                 tmin=_detached(rays_s.tmin), tmax=_detached(rays_s.tmax))


def _nee_rebucketed(any_hit):
    def nee(acc, o3, tmin, dirs, tcaps, exclude_prim=None,
            exclude_prim2=None):
        return ci.any_hit_nee_clusters_s(acc, o3, tmin, dirs, tcaps,
                                         exclude_prim, exclude_prim2, any_hit)
    return nee


# (accel kind, intersector) -> query -> function(data, ...)
_ROUTES = {
    ("brute", "cuda"): {"closest": cuda_intersect.closest_hit_cuda,
                        "any": cuda_intersect.any_hit_cuda,
                        "nee": cuda_intersect.any_hit_nee_cuda},
    ("brute", "torch"): {"closest": isect.closest_hit_torch,
                         "any": isect.any_hit_torch,
                         "nee": isect.any_hit_nee_torch},
    ("flat", "cuda"): {"closest": cuda_cluster.closest_hit_flat_cuda,
                       "any": cuda_cluster.any_hit_flat_cuda,
                       "nee": cuda_cluster.any_hit_nee_flat_cuda},
    ("flat", "torch"): {"closest": ci.closest_hit_flat_torch,
                        "any": ci.any_hit_flat_torch,
                        "nee": ci.any_hit_nee_flat_torch},
    ("grouped", "cuda"): {
        "closest": cuda_cluster.closest_hit_grouped_cuda,
        "any": cuda_cluster.any_hit_grouped_cuda,
        "nee": _nee_rebucketed(cuda_cluster.any_hit_grouped_cuda)},
    ("grouped", "torch"): {
        "closest": ci.closest_hit_grouped_torch,
        "any": ci.any_hit_grouped_torch,
        "nee": _nee_rebucketed(ci.any_hit_grouped_torch)},
}


def accel_kind(accel) -> str:
    """'brute' (no accel), 'flat' or 'grouped'."""
    if accel is None:
        return "brute"
    return "flat" if isinstance(accel, ci.ClusterAccel) else "grouped"


def _backend(scene: Scene, query: str):
    """(data, function) answering `query` ("closest", "any" or "nee") for
    the scene's accel and intersector."""
    fn = _ROUTES[accel_kind(scene.accel), scene.intersector][query]
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
    return fn(data, _detach_v3(origin), _detached(tmin),
              [_detach_v3(d) for d in dirs], [_detached(t) for t in tcaps],
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
    sps = SPS(p=p, n=n, ng=ng, nu=nu, nv=nv, u=uu, v=vv,
              mat=mat, light=light, prim=prim, obj=obj)
    if any(slot == "bump_shader" for _, slot, _, _ in scene.node_programs):
        sps = apply_bump_s(scene, sps)
    return sps


BUMP_STEP = 2e-4


def apply_bump_s(scene: Scene, sps: SPS) -> SPS:
    """Bump mapping by node-value differences (core_tpu/scene.py:374-405;
    the reference's textureMapper_t::evalDerivative procedural branch,
    basicnodes.cc:227-240, and material_t::applyBump, material.cc:68-75):
    per bump_shader program, the program's scalar at p -/+ BUMP_STEP along
    nu and along nv, each difference divided by the step (not by twice
    it) and scaled by the output node's bump_strength over the norm of its
    scale; nu and nv tilt by those slopes along n, and the frame is
    rebuilt, on the program's material only.  Autograd runs through the
    four evaluations like any other shading."""
    tex_names = dict(scene.texture_name_map)
    for mat_idx, slot, ndefs, out in scene.node_programs:
        if slot != "bump_shader":
            continue
        node = next(nd for nd in ndefs if nd.name == out)
        scale = float(np.linalg.norm(np.asarray(
            node.get("scale", (1.0, 1.0, 1.0)), np.float64)))
        strength = float(node.get("bump_strength", 1.0)) / max(scale, 1e-9)

        def value(pp: V3):
            ctx = {"p": pp, "uv": (sps.u, sps.v), "n": sps.n,
                   "texture_names": tex_names}
            return eval_graph(list(ndefs), out, ctx, scene.textures)[2]

        def slope(axis: V3):
            return (value(sps.p - axis * BUMP_STEP)
                    - value(sps.p + axis * BUMP_STEP)) / BUMP_STEP * strength

        nu = sps.nu + sps.n * slope(sps.nu)
        nv = sps.nv + sps.n * slope(sps.nv)
        n = normalize3(cross3(nu, nv))
        nu = normalize3(nu)
        nv = normalize3(cross3(n, nu))
        mask = sps.mat == mat_idx
        sps = sps._replace(n=where3(mask, n, sps.n),
                           nu=where3(mask, nu, sps.nu),
                           nv=where3(mask, nv, sps.nv))
    return sps


def _mul32(a, c: int):
    """(a * c) mod 2**32 for a in [0, 2**32) held in int64, in two 16-bit
    halves so that no product leaves int64 (the uint32 multiply of
    core_tpu's hash)."""
    lo = (a & 0xFFFF) * c
    hi = (((a >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & qmc.MASK32


def _u32_of_f32(x):
    """float32 -> int32 (truncating) -> uint32 (wrapping), as core_tpu's
    .astype(jnp.int32).astype(jnp.uint32)."""
    return x.to(torch.int32).to(torch.int64) & qmc.MASK32


def composite_pick(sps: SPS, val, pick_seed=None):
    """The cross-family blend's one-sample sub-material pick
    (core_tpu/scene.py:480-492): True where the lane takes sub-material 1,
    fnv32a(prim ^ qu*2654435761 ^ qv*911382323 ^ seed*2246822519) / 2**32
    < val, with (qu, qv) the uv quantized to 1/8192 and seed the caller's
    per-lane QMC offset (0 when there is none)."""
    qu = _u32_of_f32(sps.u * 8192.0)
    qv = _u32_of_f32(sps.v * 8192.0)
    key = (sps.prim.to(torch.int64) & qmc.MASK32) ^ _mul32(qu, 2654435761) \
        ^ _mul32(qv, 911382323)
    if pick_seed is not None:
        key = key ^ _mul32(pick_seed & qmc.MASK32, 2246822519)
    r01 = qmc.fnv32a(key).to(torch.float32) * (1.0 / 4294967296.0)
    return r01 < val


def _resolve_composites(scene: Scene, sps: SPS, p: MatParamsS, pick_seed,
                        lod):
    """BLEND / MASK rows -> a sub-material's row per hit (core_tpu
    material_params, scene.py:456-516; reference blend.cc, mask.cc): a mask
    takes sub-material 1 where its texture's mean exceeds blend_val, else
    0; a same-family blend lerps the two rows' float columns by its factor
    (blend_val, or its texture's mean) and takes its integer and bool
    columns from sub-material 0 (from 1 where a blend texture's mean
    exceeds blend_val, as core_tpu does); a cross-family blend takes one
    whole sub-material by composite_pick.  Returns (params, the resolved
    diffuse_tex)."""
    table = scene.materials
    m = table.mtype.shape[0]
    idx = sps.mat.clamp(0, m - 1).long()
    sub = table.sub_mat.index_select(0, idx).clamp(0, m - 1).long()
    i0, i1 = sub[:, 0], sub[:, 1]
    val = table.blend_val.index_select(0, idx)
    btex = table.blend_tex.index_select(0, idx)
    sub0 = gather_params_s(table, i0)
    sub1 = gather_params_s(table, i1)
    is_mask = p.mtype == int(MatType.MASK)
    is_blend = p.mtype == int(MatType.BLEND)
    if scene.textures is not None:
        rgb, _ = eval_texture(scene.textures, btex, sps.p, (sps.u, sps.v),
                              lod, scene.table_textures)
        tval = (rgb.x + rgb.y + rgb.z) / 3.0
        has_btex = btex >= 0
        mask_pick = has_btex & (tval > val)
        val = torch.where(has_btex & is_blend, tval, val)
    else:
        mask_pick = torch.zeros_like(is_mask)
    cross = is_blend & (sub0.mtype != sub1.mtype)
    pick1 = cross & composite_pick(sps, val, pick_seed)

    def resolve(l0, l1, orig):
        picked = torch.where(mask_pick, l1, l0)
        if l0.is_floating_point():
            blended = l0 * (1.0 - val) + l1 * val
        else:
            blended = picked
        blended = torch.where(cross, torch.where(pick1, l1, l0), blended)
        return torch.where(is_mask, picked,
                           torch.where(is_blend, blended, orig))

    def resolve_field(l0, l1, orig):
        if isinstance(orig, V3):
            return V3(*(resolve(a, b, o) for a, b, o in zip(l0, l1, orig)))
        return resolve(l0, l1, orig)

    p = MatParamsS(*(resolve_field(a, b, o)
                     for a, b, o in zip(sub0, sub1, p)))
    dtex = table.diffuse_tex
    return p, resolve(dtex.index_select(0, i0), dtex.index_select(0, i1),
                      dtex.index_select(0, idx))


def material_params_s(scene: Scene, sps: SPS, pick_seed=None,
                      lod=None) -> MatParamsS:
    """SoA material rows for the hits: the table rows, blend and mask rows
    resolved to a sub-material's row (_resolve_composites), then a mapped
    diffuse texture replacing the diffuse colour per hit, then the
    node-mapped slots (_apply_node_programs) (core_tpu material_params;
    the reference's shader-node substitution in initBSDF,
    glossy2.cc:88-96).

    pick_seed: [N] int64 tensor of uint32 values, the per-lane QMC offset
    that decorrelates a cross-family blend's pick (None = seed 0).
    lod: optional [N] UV-space footprint of camera hits
    (differentials.texture_lod) for mip-filtered image lookups."""
    p = gather_params_s(scene.materials, sps.mat)
    tex = None
    if {int(MatType.BLEND), int(MatType.MASK)} & set(scene.mat_types):
        p, tex = _resolve_composites(scene, sps, p, pick_seed, lod)
    if scene.textures is not None:
        if tex is None:
            idx = sps.mat.clamp(0, scene.materials.mtype.shape[0] - 1).long()
            tex = scene.materials.diffuse_tex.index_select(0, idx)
        rgb, _ = eval_texture(scene.textures, tex, sps.p, (sps.u, sps.v),
                              lod, scene.table_textures)
        p = p._replace(diffuse_color=where3(tex >= 0, rgb, p.diffuse_color))
    if scene.node_programs:
        p = _apply_node_programs(scene, p, sps)
    return p


# node-mapped scalar slot -> MatParamsS column (core_tpu's strengths
# layout: mirror, transparency, translucency, diffuse)
_SCALAR_SLOTS = {"mirror_shader": "c_mirror",
                 "transparency_shader": "c_transp",
                 "translucency_shader": "c_transl",
                 "glossy_reflect_shader": "glossy_reflect"}
_COLOR_SLOTS = {"diffuse_shader": "diffuse_color",
                "mirror_color_shader": "mirror_color",
                "glossy_shader": "glossy_color"}


def _apply_node_programs(scene: Scene, p: MatParamsS, sps: SPS):
    """Node-mapped material slots substituted per hit (core_tpu/scene.py:
    536-565; the reference's initBSDF shader evaluation,
    shinydiffuse.cc:496-556): a colour slot takes the program's colour, a
    scalar slot its scalar, on the hits of the program's material.  A
    sigma_oren_shader is accepted and, as in core_tpu, not applied; a
    bump_shader tilts the frame in surface_points_s (apply_bump_s)."""
    ctx = {"p": sps.p, "uv": (sps.u, sps.v), "n": sps.n,
           "texture_names": dict(scene.texture_name_map)}
    for mat_idx, slot, ndefs, out in scene.node_programs:
        if slot not in _COLOR_SLOTS and slot not in _SCALAR_SLOTS:
            continue
        rgb, _, sval = eval_graph(list(ndefs), out, ctx, scene.textures)
        mask = sps.mat == mat_idx
        if slot in _COLOR_SLOTS:
            col = _COLOR_SLOTS[slot]
            p = p._replace(**{col: where3(mask, rgb, getattr(p, col))})
        else:
            col = _SCALAR_SLOTS[slot]
            p = p._replace(**{col: torch.where(mask, sval,
                                               getattr(p, col))})
    return p
