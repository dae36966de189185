"""Carrying scene state across packages as numpy arrays.

scene_to_numpy flattens a scene into (leaves, static): `leaves` maps dotted
field paths ("geom.verts", "materials.diffuse_color", "lights.0.corner",
"accel.tris", "textures.0.image", ...) to numpy arrays, and `static` holds
the plain Python settings (texture defs but their images, shader-node
programs, light kinds and sample counts, camera sizes).  It
reads fields by name only, so it accepts this package's Scene and any scene
object with the same field names, such as core_tpu's (whose arrays
np.asarray converts).  scene_from_numpy rebuilds this package's Scene on a
device from the two, so both packages compute on identical inputs.

The flat cluster accel crosses as core_tpu's ClusterData (aabb, and the
triangle block [C, L, 10]: v0, e1, e2, id), the grouped one as its
GroupedData with the same triangle block (core_tpu's field-major
[C, 16, L] block is transposed on the way).  A scene without an accel gets
one by environment.accel_for's triangle-count rule.  This module imports
no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.backgrounds import TextureBackground
from core_tpu_torch.cameras import Camera, check_supported
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.lights.area import AreaLight
from core_tpu_torch.lights.bg import BgLight
from core_tpu_torch.lights.point import PointLight
from core_tpu_torch.lights.spot import SpotLight
from core_tpu_torch.lights.sun import DirectionalLight, SunLight
from core_tpu_torch.materials.base import MaterialTable
from core_tpu_torch.scene import Scene, check_device, resolve_intersector
from core_tpu_torch.textures import base as tex_base
from core_tpu_torch.textures.nodes import NodeDef

_LIGHTS = {  # type name -> (class, array fields, static fields)
    "AreaLight": (AreaLight, ("corner", "to_x", "to_y", "color", "area",
                              "fnormal"), ("samples", "obj_id")),
    "SunLight": (SunLight, ("direction", "col_pdf", "cos_angle", "pdf",
                            "du", "dv"), ("samples",)),
    "BgLight": (BgLight, ("u_pdf", "u_cdf", "v_pdf", "v_cdf"),
                ("samples", "abs_intersect")),
    "PointLight": (PointLight, ("pos", "color"), ("samples",)),
    "SpotLight": (SpotLight, ("pos", "ndir", "color", "cos_start",
                              "cos_end"), ("samples", "photon_only")),
    "DirectionalLight": (DirectionalLight, ("direction", "color", "pos",
                                            "radius"),
                         ("infinite", "samples")),
}
_CAMERA_ARRAYS = ("pos", "cam_x", "cam_y", "cam_z", "vto", "vup", "vright")
_CAMERA_STATIC = ("cam_type", "resx", "resy", "aspect_ratio", "focal",
                  "aperture")
_BG_ARRAYS = ("power", "rot_cos", "rot_sin")
# scene features this package does not port yet: must be absent
_ABSENT = ("volumes",)


def _np(a) -> np.ndarray:
    """A leaf as numpy, from a torch tensor on any device or an array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _texture_numpy(ctex, prefix: str, leaves: dict) -> list:
    """The texture defs as plain dicts of their settings; each image goes
    into `leaves` as "<prefix>.<def index>.image"."""
    out = []
    for i, d in enumerate(ctex.defs):
        if getattr(d, "image", None) is not None:
            leaves[f"{prefix}.{i}.image"] = _np(d.image)
        rec = {f: getattr(d, f) for f in tex_base.FIELDS}
        rec["ttype"] = int(rec["ttype"])
        rec["mus_type"] = int(rec["mus_type"])
        out.append(rec)
    return out


def _textures(recs, leaves, prefix, device):
    return tex_base.build_texture_set(
        [tex_base.TextureDef(**{**r, "ttype": tex_base.TexType(r["ttype"]),
                                "mus_type": tex_base.MusgraveType(
                                    r["mus_type"])},
                             image=leaves.get(f"{prefix}.{i}.image"))
         for i, r in enumerate(recs)], device)


def _node_programs_static(programs) -> tuple:
    """(mat_idx, slot, ((name, ntype, params), ...), out) per program, the
    node defs read by field name (a core_tpu NodeDef converts)."""
    return tuple((int(m), str(slot),
                  tuple((nd.name, nd.ntype, tuple(nd.params)) for nd in nds),
                  str(out)) for m, slot, nds, out in programs)


def _accel_numpy(acc):
    """("flat", ClusterData) or ("grouped", GroupedData), with the triangle
    block [C, L, 10], of this package's accel or of core_tpu's
    ClusterData."""
    if isinstance(acc, (ci.ClusterAccel, ci.GroupedAccel)):
        tris = _np(torch.cat([acc.tris, acc.tri_id[..., None].float()],
                             dim=-1))
        if isinstance(acc, ci.ClusterAccel):
            return "flat", ci.ClusterData(aabb=_np(acc.aabb), tris=tris)
        return "grouped", ci.GroupedData(*[_np(a) for a in (
            acc.g_aabb, acc.c_aabb, acc.o_aabb)], tris=tris)
    if not hasattr(acc, "aabb"):
        raise NotImplementedError(f"a {type(acc).__name__} accel is not "
                                  "ported to core_tpu_torch yet")
    gd = getattr(acc, "grouped", None)
    if gd is None:
        return "flat", ci.ClusterData(aabb=np.asarray(acc.aabb),
                                      tris=np.asarray(acc.tris))
    return "grouped", ci.GroupedData(
        g_aabb=np.asarray(gd.g_aabb), c_aabb=np.asarray(gd.c_aabb),
        o_aabb=np.asarray(gd.o_aabb),
        tris=np.ascontiguousarray(np.swapaxes(np.asarray(gd.tris), 1, 2)
                                  [:, :, :10]))


def scene_to_numpy(scene) -> tuple[dict, dict]:
    """(leaves, static) of a scene; raises for features not ported."""
    for name in _ABSENT:
        if getattr(scene, name, None):
            raise NotImplementedError(f"scene.{name} is not ported to "
                                      "core_tpu_torch yet")
    leaves = {}
    for f in GeomData._fields:
        leaves[f"geom.{f}"] = _np(getattr(scene.geom, f))
    for f in MaterialTable._fields:
        leaves[f"materials.{f}"] = _np(getattr(scene.materials, f))
    lights = []
    for i, light in enumerate(scene.lights):
        kind = type(light).__name__
        if kind not in _LIGHTS:
            raise NotImplementedError(f"light type {kind} is not ported to "
                                      "core_tpu_torch yet")
        _, arrays, statics = _LIGHTS[kind]
        for f in arrays:
            leaves[f"lights.{i}.{f}"] = _np(getattr(light, f))
        lights.append({"type": kind,
                       **{f: getattr(light, f) for f in statics}})
    for f in _CAMERA_ARRAYS:
        leaves[f"camera.{f}"] = _np(getattr(scene.camera, f))
    bg = getattr(scene, "background", None)
    bg_static = None
    if bg is not None:
        if type(bg).__name__ != "TextureBackground":
            raise NotImplementedError(f"background {type(bg).__name__} is "
                                      "not ported to core_tpu_torch yet")
        for f in _BG_ARRAYS:
            leaves[f"background.{f}"] = _np(getattr(bg, f))
        bg_static = {"textures": _texture_numpy(bg.ctex, "background.textures",
                                                leaves),
                     "tex_id": int(bg.tex_id), "projection": bg.projection,
                     "ibl": bool(bg.ibl), "ibl_samples": int(bg.ibl_samples)}
    acc = getattr(scene, "accel", None)
    kind = None
    if acc is not None:
        kind, data = _accel_numpy(acc)
        for f, a in zip(data._fields, data):
            leaves[f"accel.{f}"] = a
    tex = getattr(scene, "textures", None)
    static = {
        "lights": lights,
        "camera": {f: getattr(scene.camera, f) for f in _CAMERA_STATIC},
        "background": bg_static,
        "textures": None if tex is None
        else _texture_numpy(tex, "textures", leaves),
        "node_programs": _node_programs_static(
            getattr(scene, "node_programs", ())),
        "texture_name_map": tuple((str(k), int(v)) for k, v in getattr(
            scene, "texture_name_map", ())),
        "accel": kind,
        "has_specular": bool(scene.has_specular),
        "has_transparency": bool(scene.has_transparency),
        "mat_types": tuple(int(t) for t in scene.mat_types),
    }
    return leaves, static


def scene_from_numpy(leaves: dict, static: dict, *, device="cuda",
                     intersector: str = "auto") -> Scene:
    """This package's Scene on `device` from scene_to_numpy's output."""
    device = check_device(device)

    def t(key):
        return torch.tensor(np.asarray(leaves[key]), device=device)

    geom = GeomData(*[t(f"geom.{f}") for f in GeomData._fields])
    materials = MaterialTable(*[t(f"materials.{f}")
                                for f in MaterialTable._fields])
    bs = static["background"]
    background = None if bs is None else TextureBackground(
        ctex=_textures(bs["textures"], leaves, "background.textures",
                       device), tex_id=bs["tex_id"],
        **{f: t(f"background.{f}") for f in _BG_ARRAYS},
        projection=bs["projection"], ibl=bs["ibl"],
        ibl_samples=bs["ibl_samples"])
    lights = []
    for i, ls in enumerate(static["lights"]):
        cls, arrays, statics = _LIGHTS[ls["type"]]
        extra = {"background": background} if cls is BgLight else {}
        lights.append(cls(**{f: t(f"lights.{i}.{f}") for f in arrays},
                          **{f: ls[f] for f in statics}, **extra))
    cs = static["camera"]
    camera = Camera(**{f: t(f"camera.{f}") for f in _CAMERA_ARRAYS},
                    cam_type=int(cs["cam_type"]), resx=int(cs["resx"]),
                    resy=int(cs["resy"]),
                    aspect_ratio=float(cs["aspect_ratio"]),
                    focal=float(cs["focal"]), aperture=float(cs["aperture"]))
    check_supported(camera)
    if static["accel"]:
        cls = ci.ClusterData if static["accel"] == "flat" else ci.GroupedData
        accel = ci.to_device(cls(*[np.asarray(leaves[f"accel.{f}"])
                                   for f in cls._fields]), device)
    else:
        from core_tpu_torch.environment import accel_for
        accel = accel_for(leaves["geom.verts"], leaves["geom.tri_vidx"],
                          leaves["camera.pos"], device)
    # an empty mat_types means "derive from the table" (core_tpu/scene.py)
    mat_types = tuple(static["mat_types"]) or tuple(
        sorted(set(materials.mtype.tolist())))
    return Scene(geom=geom, materials=materials, lights=tuple(lights),
                 camera=camera, background=background, accel=accel,
                 textures=None if static["textures"] is None
                 else _textures(static["textures"], leaves, "textures",
                                device),
                 has_specular=bool(static["has_specular"]),
                 has_transparency=bool(static["has_transparency"]),
                 mat_types=mat_types,
                 node_programs=tuple(
                     (m, slot, tuple(NodeDef(*nd) for nd in nds), out)
                     for m, slot, nds, out in static["node_programs"]),
                 texture_name_map=static["texture_name_map"],
                 intersector=resolve_intersector(intersector, device))
