"""Carrying scene state across packages as numpy arrays.

scene_to_numpy flattens a scene into (leaves, static): `leaves` maps dotted
field paths ("geom.verts", "materials.diffuse_color", "lights.0.corner",
"camera.vto", ...) to numpy arrays, and `static` holds the plain Python
settings.  It reads fields by name only, so it accepts this package's Scene
and any scene object with the same field names, such as core_tpu's (whose
arrays np.asarray converts).  scene_from_numpy rebuilds this package's
Scene on a device from the two.  Both packages then compute on identical
inputs.  This module imports no jax.
"""
from __future__ import annotations

import numpy as np
import torch

from core_tpu_torch.cameras import Camera, check_supported
from core_tpu_torch.geometry.mesh import GeomData
from core_tpu_torch.lights.area import AreaLight
from core_tpu_torch.materials.base import MaterialTable
from core_tpu_torch.scene import Scene, resolve_intersector

_LIGHT_ARRAYS = ("corner", "to_x", "to_y", "color", "area", "fnormal")
_CAMERA_ARRAYS = ("pos", "cam_x", "cam_y", "cam_z", "vto", "vup", "vright")
_CAMERA_STATIC = ("cam_type", "resx", "resy", "aspect_ratio", "focal",
                  "aperture")
# scene features this package does not port yet: must be absent
_ABSENT = ("background", "accel", "textures", "volumes", "node_programs")


def scene_to_numpy(scene) -> tuple[dict, dict]:
    """(leaves, static) of a scene; raises for features not ported."""
    for name in _ABSENT:
        if getattr(scene, name, None):
            raise NotImplementedError(f"scene.{name} is not ported to "
                                      "core_tpu_torch yet")
    leaves = {}
    for f in GeomData._fields:
        leaves[f"geom.{f}"] = np.asarray(getattr(scene.geom, f))
    for f in MaterialTable._fields:
        leaves[f"materials.{f}"] = np.asarray(getattr(scene.materials, f))
    lights = []
    for i, light in enumerate(scene.lights):
        if type(light).__name__ != "AreaLight":
            raise NotImplementedError(f"light type {type(light).__name__} "
                                      "is not ported to core_tpu_torch yet")
        for f in _LIGHT_ARRAYS:
            leaves[f"lights.{i}.{f}"] = np.asarray(getattr(light, f))
        lights.append({"samples": int(light.samples),
                       "obj_id": int(light.obj_id)})
    for f in _CAMERA_ARRAYS:
        leaves[f"camera.{f}"] = np.asarray(getattr(scene.camera, f))
    static = {
        "lights": lights,
        "camera": {f: getattr(scene.camera, f) for f in _CAMERA_STATIC},
        "has_specular": bool(scene.has_specular),
        "has_transparency": bool(scene.has_transparency),
        "mat_types": tuple(int(t) for t in scene.mat_types),
    }
    return leaves, static


def scene_from_numpy(leaves: dict, static: dict, *, device="cpu",
                     intersector: str = "auto") -> Scene:
    """This package's Scene on `device` from scene_to_numpy's output."""
    def t(key):
        return torch.tensor(np.asarray(leaves[key]), device=device)

    geom = GeomData(*[t(f"geom.{f}") for f in GeomData._fields])
    materials = MaterialTable(*[t(f"materials.{f}")
                                for f in MaterialTable._fields])
    lights = tuple(
        AreaLight(**{f: t(f"lights.{i}.{f}") for f in _LIGHT_ARRAYS},
                  samples=int(ls["samples"]), obj_id=int(ls["obj_id"]))
        for i, ls in enumerate(static["lights"]))
    cs = static["camera"]
    camera = Camera(**{f: t(f"camera.{f}") for f in _CAMERA_ARRAYS},
                    cam_type=int(cs["cam_type"]), resx=int(cs["resx"]),
                    resy=int(cs["resy"]),
                    aspect_ratio=float(cs["aspect_ratio"]),
                    focal=float(cs["focal"]), aperture=float(cs["aperture"]))
    check_supported(camera)
    # an empty mat_types means "derive from the table" (core_tpu/scene.py)
    mat_types = tuple(static["mat_types"]) or tuple(
        sorted(set(materials.mtype.tolist())))
    return Scene(geom=geom, materials=materials, lights=lights,
                 camera=camera,
                 has_specular=bool(static["has_specular"]),
                 has_transparency=bool(static["has_transparency"]),
                 mat_types=mat_types,
                 intersector=resolve_intersector(intersector, device))
