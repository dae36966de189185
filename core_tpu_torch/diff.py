"""Differentiable rendering: scene-parameter dicts, render loss, gradients
(counterpart of core_tpu/diff.py).

`extract_params` pulls the differentiable leaves of a Scene (material
colour columns, light emission and, with geometry=True, light geometry and
a per-object translation) into a flat dict; `apply_params` writes them back
into a new Scene.  Gradients are taken with torch.autograd.grad over leaf
copies of that dict only, so integer topology never enters autograd.

Estimator contract, as in core_tpu: detached-sampling path replay.  Sample
directions come from the same QMC streams forward and backward and carry
no parameter dependence (materials.base.detach_sample), and visibility is
not differentiable: the triangle table and the cluster accel the
intersection kernels read, and every ray they are given, are detached
(scene._detach_rays, geometry.intersect.pack_tris).  Vertex positions reach
the loss through scene.surface_points_s's straight-through (t, u, v)
recompute from the rebuilt `Scene.tri_rows`; light geometry through the
light samples.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from core_tpu_torch import film as film_mod
from core_tpu_torch.render import (RenderOptions, render_chunk,
                                   scene_material_types)

# Differentiable material columns (the rest are topology, flags, bools).
MATERIAL_PARAM_COLS = (
    "diffuse_color", "mirror_color", "strengths", "emit_strength",
    "transmit_filter", "glossy_color", "glossy_reflect", "filter_color",
)
# Differentiable per-light fields by attribute name (missing ones skipped).
LIGHT_PARAM_FIELDS = ("color",)
# Light geometry: an area-light sample is corner + s1*to_x + s2*to_y, a
# point or spot sample is an offset from pos, so d(sample)/d(leaf) flows
# through the interior term.
LIGHT_GEOM_FIELDS = {
    "AreaLight": ("corner", "to_x", "to_y"),
    "PointLight": ("pos",),
    "SphereLight": ("center",),
    "SpotLight": ("pos",),
    "MeshLight": (),
    "BgPortalLight": (),
}


def extract_params(scene, geometry: bool = True) -> dict:
    """The differentiable leaves of a Scene as a flat dict of tensors.

    geometry=True adds the light-geometry leaves (LIGHT_GEOM_FIELDS) and a
    per-object translation 'geom.obj_offset' [n_objects, 3] of zeros, so
    extract/apply round-trips exactly."""
    p = {}
    for col in MATERIAL_PARAM_COLS:
        p["mat." + col] = getattr(scene.materials, col)
    for i, light in enumerate(scene.lights):
        fields = LIGHT_PARAM_FIELDS
        if geometry:
            fields = fields + LIGHT_GEOM_FIELDS.get(type(light).__name__, ())
        for f in fields:
            if hasattr(light, f):
                p[f"light{i}.{f}"] = getattr(light, f)
    if geometry:
        n_obj = int(scene.geom.tri_obj.max()) + 1
        p["geom.obj_offset"] = torch.zeros((max(n_obj, 1), 3),
                                           dtype=torch.float32,
                                           device=scene.device)
    return p


def _vertex_object_map(scene) -> torch.Tensor:
    """[V] object id of each vertex (host-side, static topology)."""
    tri_vidx = scene.geom.tri_vidx.cpu().numpy()
    tri_obj = scene.geom.tri_obj.cpu().numpy()
    vert_obj = np.zeros(scene.geom.verts.shape[0], np.int64)
    vert_obj[tri_vidx.reshape(-1)] = np.repeat(tri_obj, 3)
    return torch.from_numpy(vert_obj).to(scene.device)


def apply_params(scene, params: dict):
    """A new Scene with the leaves of `params` written in.

    An area light whose geometry moves gets its fnormal and area recomputed
    from to_x and to_y, differentiably.  'geom.obj_offset' translates each
    object's vertices: the new Scene rebuilds its cached tri_rows from the
    moved vertices, so shading sees them, while the intersection kernels
    read the detached triangle table (at a nonzero offset the caller must
    rebuild the accel for a consistent forward render)."""
    mat_kw = {col: params["mat." + col] for col in MATERIAL_PARAM_COLS
              if "mat." + col in params}
    mats = scene.materials._replace(**mat_kw)
    lights = []
    for i, light in enumerate(scene.lights):
        fields = LIGHT_PARAM_FIELDS + LIGHT_GEOM_FIELDS.get(
            type(light).__name__, ())
        kw = {f: params[f"light{i}.{f}"] for f in fields
              if f"light{i}.{f}" in params}
        if kw:
            light = dataclasses.replace(light, **kw)
            if type(light).__name__ == "AreaLight" \
                    and kw.keys() & {"corner", "to_x", "to_y"}:
                fn_raw = torch.linalg.cross(light.to_y, light.to_x)
                area = torch.linalg.vector_norm(fn_raw)
                light = dataclasses.replace(
                    light, fnormal=fn_raw / area.clamp_min(1e-20), area=area)
        lights.append(light)
    geom = scene.geom
    off = params.get("geom.obj_offset")
    if off is not None:
        geom = geom._replace(verts=geom.verts + off[_vertex_object_map(scene)])
    return dataclasses.replace(scene, geom=geom, materials=mats,
                               lights=tuple(lights))


def render_flat(scene, opts: RenderOptions, spp: int, types_present=None):
    """One differentiable chunk of spp samples -> [H, W, 4] normalized
    image (no adaptive AA, no flush)."""
    if types_present is None:
        types_present = scene_material_types(scene)
    cam = scene.camera
    film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
    film = render_chunk(scene, types_present, opts, film, 0, spp, 0)
    return film_mod.normalized(film)


def make_loss_fn(scene, opts: RenderOptions, spp: int, target,
                 types_present=None, region=None):
    """loss(params) = mean squared error of the RGB against target [H,W,4].

    region: optional (y0, y1, x0, x1) window the loss sees (to stay clear
    of silhouette and shadow edges, whose visibility term is not
    differentiated)."""
    if types_present is None:
        types_present = scene_material_types(scene)

    def loss_fn(params):
        img = render_flat(apply_params(scene, params), opts, spp,
                          types_present)
        diff = img[..., :3] - target[..., :3]
        if region is not None:
            y0, y1, x0, x1 = region
            diff = diff[y0:y1, x0:x1]
        return torch.mean(diff * diff)

    return loss_fn


def value_and_grad(loss_fn):
    """vg(params) -> (loss, grads): grads is keyed like params; each leaf
    is differentiated through a copy of it that requires grad."""

    def vg(params):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves)
            gs = torch.autograd.grad(loss, list(leaves.values()),
                                     allow_unused=True)
        grads = {k: torch.zeros_like(v) if g is None else g
                 for (k, v), g in zip(leaves.items(), gs)}
        return loss.detach(), grads

    return vg


def value_and_grad_fn(scene, opts: RenderOptions, spp: int, target,
                      types_present=None):
    """(loss, grads) of make_loss_fn's loss, as a function of params."""
    return value_and_grad(make_loss_fn(scene, opts, spp, target,
                                       types_present))
