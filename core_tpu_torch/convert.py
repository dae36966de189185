"""Carrying scene state across packages as numpy arrays.

scene_to_numpy flattens a scene into (leaves, static): `leaves` maps dotted
field paths ("geom.verts", "materials.diffuse_color", "lights.0.corner",
"accel.tris", "textures.0.image", ...) to numpy arrays, and `static` holds
the plain Python settings (texture defs but their images, shader-node
programs, light and background kinds and their settings, the camera's
settings, the volume regions' type names).  Every light, background,
camera and volume region type of core_tpu crosses, a region's arrays as
"volumes.<i>.<field>".  It
reads fields by name only, so it accepts this package's Scene and any scene
object with the same field names, such as core_tpu's (whose arrays
np.asarray converts).  scene_from_numpy rebuilds this package's Scene on a
device from the two, so both packages compute on identical inputs.

The flat cluster accel crosses as core_tpu's ClusterData (aabb, and the
triangle block [C, L, 10]: v0, e1, e2, id), the grouped one as its
GroupedData with the same triangle block (core_tpu's field-major
[C, 16, L] block is transposed on the way), a BVH as its five node and
order arrays (geometry/bvh.py BVHData).  A scene without an accel gets
one by environment.accel_for's triangle-count rule.
photon_map_from_numpy grids a numpy photon deposit set into this package's
PhotonMap, so both packages can gather from the same photons.  This module
imports no jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from core_tpu_torch import backgrounds as bgs
from core_tpu_torch.cameras import STATIC_FIELDS, Camera, check_supported
from core_tpu_torch.geometry import bvh as bvh_mod
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.lights.area import AreaLight
from core_tpu_torch.lights.bg import BgLight
from core_tpu_torch.lights.ies import IesLight
from core_tpu_torch.lights.mesh import MeshLight
from core_tpu_torch.lights.point import PointLight
from core_tpu_torch.lights.portal import BgPortalLight
from core_tpu_torch.lights.sphere import SphereLight
from core_tpu_torch.lights.spot import SpotLight
from core_tpu_torch.lights.sun import DirectionalLight, SunLight
from core_tpu_torch.materials.base import MaterialTable
from core_tpu_torch.scene import Scene, check_device, resolve_intersector
from core_tpu_torch.textures import base as tex_base
from core_tpu_torch.textures.nodes import NodeDef
from core_tpu_torch.volumes import regions as vr

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
    "SphereLight": (SphereLight, ("center", "radius", "color"),
                    ("samples",)),
    "MeshLight": (MeshLight, ("va", "vb", "vc", "normals", "cdf", "color",
                              "area"),
                  ("samples", "double_sided", "obj_id")),
    "IesLight": (IesLight, ("pos", "ndir", "color", "profile"),
                 ("samples",)),
    # its MeshLight's fields cross as "mesh.<field>"
    "BgPortalLight": (BgPortalLight, ("power",), ("samples",)),
}
_CAMERA_ARRAYS = ("pos", "cam_x", "cam_y", "cam_z", "vto", "vup", "vright")
_BACKGROUNDS = {  # type name -> (class, array fields, static fields)
    "TextureBackground": (bgs.TextureBackground,
                          ("power", "rot_cos", "rot_sin"),
                          ("tex_id", "projection", "ibl", "ibl_samples")),
    "ConstantBackground": (bgs.ConstantBackground, ("color",),
                           ("ibl", "ibl_samples")),
    "GradientBackground": (bgs.GradientBackground,
                           ("horizon", "zenith", "horizon_ground",
                            "zenith_ground"), ("ibl", "ibl_samples")),
    "SunSkyBackground": (bgs.SunSkyBackground,
                         ("sun_dir", "theta_s", "phi_s", "zenith",
                          "perez_y_lum", "perez_x", "perez_y", "power"),
                         ("ibl", "ibl_samples")),
    "DarkSkyBackground": (bgs.DarkSkyBackground,
                          ("sun_dir", "zenith", "perez_lum", "perez_x",
                           "perez_y", "conv_mat", "bright", "power",
                           "altitude"),
                          ("exposure", "night", "clamp_rgb", "gamma_enc",
                           "ibl", "ibl_samples")),
}
_MESH_LIGHT = _LIGHTS["MeshLight"]
# volume region type name -> (class, its array fields, all of them)
_VOLUMES = {cls.__name__: (cls, tuple(f.name for f in dataclasses.fields(cls)))
            for cls in vr.REGIONS}


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
    ClusterData; ("bvh", BVHData of numpy arrays) of either package's
    BVH."""
    if hasattr(acc, "node_min"):
        return "bvh", bvh_mod.BVHData(*[_np(a) for a in acc])
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
    leaves = {}
    volumes = []
    for i, vol in enumerate(getattr(scene, "volumes", ())):
        kind = type(vol).__name__
        if kind not in _VOLUMES:
            raise NotImplementedError(f"volume region {kind} is not ported "
                                      "to core_tpu_torch yet")
        for f in _VOLUMES[kind][1]:
            leaves[f"volumes.{i}.{f}"] = _np(getattr(vol, f))
        volumes.append(kind)
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
        rec = {"type": kind, **{f: getattr(light, f) for f in statics}}
        if kind == "BgPortalLight":
            for f in _MESH_LIGHT[1]:
                leaves[f"lights.{i}.mesh.{f}"] = _np(getattr(light.mesh, f))
            rec["mesh"] = {f: getattr(light.mesh, f) for f in _MESH_LIGHT[2]}
        lights.append(rec)
    for f in _CAMERA_ARRAYS:
        leaves[f"camera.{f}"] = _np(getattr(scene.camera, f))
    bg = getattr(scene, "background", None)
    bg_static = None
    if bg is not None:
        kind = type(bg).__name__
        if kind not in _BACKGROUNDS:
            raise NotImplementedError(f"background {kind} is not ported to "
                                      "core_tpu_torch yet")
        _, arrays, statics = _BACKGROUNDS[kind]
        for f in arrays:
            leaves[f"background.{f}"] = _np(getattr(bg, f))
        bg_static = {"type": kind, **{f: getattr(bg, f) for f in statics}}
        if kind == "TextureBackground":
            bg_static["tex_id"] = int(bg.tex_id)
            bg_static["textures"] = _texture_numpy(
                bg.ctex, "background.textures", leaves)
    acc = getattr(scene, "accel", None)
    kind = None
    if acc is not None:
        kind, data = _accel_numpy(acc)
        for f, a in zip(data._fields, data):
            leaves[f"accel.{f}"] = a
    tex = getattr(scene, "textures", None)
    static = {
        "lights": lights,
        "camera": {f: getattr(scene.camera, f) for f in STATIC_FIELDS},
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
        "volumes": volumes,
        "n_objects": int(getattr(scene, "n_objects", 0)),
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
    background = None
    if bs is not None:
        cls, arrays, statics = _BACKGROUNDS[bs["type"]]
        extra = {"ctex": _textures(bs["textures"], leaves,
                                   "background.textures", device)} \
            if cls is bgs.TextureBackground else {}
        background = cls(**{f: t(f"background.{f}") for f in arrays},
                         **{f: bs[f] for f in statics}, **extra)
    lights = []
    for i, ls in enumerate(static["lights"]):
        cls, arrays, statics = _LIGHTS[ls["type"]]
        extra = {"background": background} \
            if cls in (BgLight, BgPortalLight) else {}
        if cls is BgPortalLight:
            extra["mesh"] = MeshLight(
                **{f: t(f"lights.{i}.mesh.{f}") for f in _MESH_LIGHT[1]},
                **ls["mesh"])
        lights.append(cls(**{f: t(f"lights.{i}.{f}") for f in arrays},
                          **{f: ls[f] for f in statics}, **extra))
    cs = static["camera"]
    camera = Camera(**{f: t(f"camera.{f}") for f in _CAMERA_ARRAYS},
                    **{f: type(getattr(Camera, f))(cs[f])
                       for f in STATIC_FIELDS})
    check_supported(camera)
    if static["accel"] == "bvh":
        accel = bvh_mod.to_device([leaves[f"accel.{f}"]
                                   for f in bvh_mod.BVHData._fields], device)
    elif static["accel"]:
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
    volumes = tuple(
        _VOLUMES[kind][0](**{f: t(f"volumes.{i}.{f}")
                             for f in _VOLUMES[kind][1]})
        for i, kind in enumerate(static.get("volumes", ())))
    return Scene(geom=geom, materials=materials, lights=tuple(lights),
                 camera=camera, background=background, accel=accel,
                 volumes=volumes, n_objects=int(static.get("n_objects", 0)),
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


def photon_map_from_numpy(pos, power, dirn, valid, radius: float, bmin,
                          bmax, *, device="cuda"):
    """This package's PhotonMap on `device` from a numpy deposit set
    ([P, 3] pos, power, dirn and [P] valid, as either package's
    shoot_photons returns them), gridded at `radius` over the host bound
    (bmin, bmax): both packages then gather from the same photons."""
    from core_tpu_torch.photon.map import build_photon_grid
    device = check_device(device)

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    return build_photon_grid(t(pos, torch.float32), t(power, torch.float32),
                             t(dirn, torch.float32), t(valid, torch.bool),
                             radius, bmin, bmax)
