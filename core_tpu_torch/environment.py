"""Scene assembly by element factories (counterpart of the part of
core_tpu/environment.py that mesh_scene uses; reference renderEnvironment_t).

SceneBuilder collects created elements and geometry, then compile_scene
builds the Scene on a device.  Element types keep the reference's names:
  texture     clouds, marble, voronoi, image (a .tga or .npy file)
  material    shinydiffusemat, glossy (each may carry a list of shader
              nodes, `extra`, that its <slot>_shader parameters name)
  background  textureback (its ibl=True adds the importance-sampled
              background light at compile time)
  light       sunlight, pointlight, spotlight, directional
Any other type raises NotImplementedError by name.

compile_scene picks the intersection path by core_tpu's rule
(scene.py:57,78 and cluster_intersect.py:139-141,179): at most 4,096
triangles go to the brute kernels 1-3 (no accel); above that the clusters
are built, and 1,024 clusters or more (every scene of 131,584 triangles or
more: the median split into <= 256-tri leaves gives 1,024) go to the
grouped cluster kernels 7 and 8, fewer to the flat cluster kernels 4-6.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry.mesh import MeshAssembler
from core_tpu_torch.materials.base import (MaterialDef, MatType,
                                           build_material_table)
from core_tpu_torch.params import ParamMap
from core_tpu_torch.scene import Scene, resolve_intersector
from core_tpu_torch.textures import noise as nz
from core_tpu_torch.textures import nodes
from core_tpu_torch.textures.base import (TexType, TextureDef,
                                          build_texture_set)

BRUTE_MAX_TRIS = 4096                                  # kernels 1-3


def accel_for(verts, tri_vidx, sort_origin, device):
    """None (brute), the flat or the grouped accel: by the triangle count,
    then by the cluster count, as core_tpu decides."""
    if int(tri_vidx.shape[0]) <= BRUTE_MAX_TRIS:
        return None
    cl = ci.build_clusters(verts, tri_vidx)
    if cl.aabb.shape[0] >= ci.GROUPED_MIN_CLUSTERS:
        cl = ci.group_clusters(cl, sort_origin=sort_origin)
    return ci.to_device(cl, device)


class SceneBuilder:
    """Accumulates created elements + geometry, then compiles a Scene on
    `device`."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.assembler = MeshAssembler()
        self.materials: list[MaterialDef] = []
        self.material_names: dict[str, int] = {}
        self.textures: list[TextureDef] = []
        self.texture_names: dict[str, int] = {}
        self.lights: list = []
        self.camera = None
        self.background = None
        # makers of the lights created at compile time (the IBL light)
        self._deferred_lights: list = []
        # shader-node programs: (mat_index, slot, node_defs, out_node_name)
        self.node_programs: list = []

    def create(self, kind: str, name: str, params: ParamMap, extra=None):
        """Create one element; `extra` is a material's list of shader-node
        ParamMaps (the reference's paramsStartList / PushList)."""
        tname = params.get_str("type")
        fn = _FACTORIES.get(kind, {}).get(tname)
        if fn is None:
            raise NotImplementedError(f"{kind} type {tname!r} is not ported "
                                      "to core_tpu_torch yet")
        out = fn(self, name, params)
        if kind == "material":
            self.collect_node_programs(out, params, extra or [])
        return out

    # shader-node slots every reference material can map
    # (shinydiffuse.cc:496-556, glossy2.cc:88-96)
    NODE_SLOTS = ("diffuse_shader", "mirror_color_shader", "glossy_shader",
                  "glossy_reflect_shader", "transparency_shader",
                  "translucency_shader", "mirror_shader", "sigma_oren_shader",
                  "bump_shader")

    def collect_node_programs(self, mat_idx: int, p: ParamMap, extra):
        """Parse a material's shader-node list and record which of its
        slots are node-mapped (nodematerial.cc loadNodes, and the material
        factories reading their '<slot>_shader' parameters).  A mapped
        bump_shader, and a node type not ported, raise."""
        ndefs = tuple(nd for nd in (nodes.parse_node(pm) for pm in extra)
                      if nd is not None)
        if not ndefs:
            return
        nodes.check_supported(ndefs)
        names = {nd.name for nd in ndefs}
        for slot in self.NODE_SLOTS:
            ref = p.get_str(slot, "")
            if ref and ref in names:
                if slot == "bump_shader":
                    raise NotImplementedError("bump_shader (bump mapping) is "
                                              "not ported to core_tpu_torch "
                                              "yet")
                self.node_programs.append((mat_idx, slot, ndefs, ref))

    def material_index(self, name: str) -> int:
        return self.material_names.get(name, 0)

    def add_material(self, name: str, mdef: MaterialDef) -> int:
        mdef.name = name
        self.materials.append(mdef)
        if name:
            self.material_names[name] = len(self.materials) - 1
        return len(self.materials) - 1

    def add_texture(self, name: str, tdef: TextureDef) -> int:
        tdef.name = name
        self.textures.append(tdef)
        if name:
            self.texture_names[name] = len(self.textures) - 1
        return len(self.textures) - 1

    def compile_scene(self) -> Scene:
        if not self.materials:
            self.add_material("default", MaterialDef())
        if self.camera is None:
            raise ValueError("compile_scene needs a camera")
        device = self.device
        geom = self.assembler.build(device)
        mats = build_material_table(self.materials, device)
        has_spec = any(
            d.mirror_strength > 0 or d.transparency > 0
            or d.mtype in (MatType.GLASS, MatType.COATED_GLOSSY)
            for d in self.materials)
        has_transp = any(d.transparency > 0 or d.mtype == MatType.GLASS
                         for d in self.materials)
        accel = accel_for(geom.verts.cpu().numpy(),
                          geom.tri_vidx.cpu().numpy(),
                          self.camera.pos.cpu().numpy(), device)
        scene = Scene(
            geom=geom, materials=mats, lights=tuple(self.lights),
            camera=self.camera, background=self.background, accel=accel,
            textures=build_texture_set(self.textures, device)
            if self.textures else None,
            has_specular=has_spec, has_transparency=has_transp,
            mat_types=tuple(sorted({int(d.mtype) for d in self.materials})),
            node_programs=tuple(self.node_programs),
            texture_name_map=tuple(sorted(self.texture_names.items())),
            intersector=resolve_intersector("auto", device))
        extra = tuple(make() for make in self._deferred_lights)
        return dataclasses.replace(scene, lights=scene.lights + extra)


# =====================  element factories  =====================

def _maybe_diffuse_tex(b: SceneBuilder, d: MaterialDef, p: ParamMap):
    tname = p.get_str("diffuse_shader", "")
    if tname and tname in b.texture_names:
        d.diffuse_tex = b.texture_names[tname]


def _mat_shinydiffuse(b: SceneBuilder, name, p: ParamMap):
    if p.get_str("diffuse_brdf", "") == "oren_nayar":
        sigma = p.get_float("sigma", 0.1)
    else:
        sigma = None
    d = MaterialDef(
        mtype=MatType.SHINY_DIFFUSE,
        diffuse_color=p.get_color("color", (1.0, 1.0, 1.0)),
        mirror_color=p.get_color("mirror_color", (1.0, 1.0, 1.0)),
        mirror_strength=p.get_float("specular_reflect", 0.0),
        transparency=p.get_float("transparency", 0.0),
        translucency=p.get_float("translucency", 0.0),
        diffuse_strength=p.get_float("diffuse_reflect", 1.0),
        emit_strength=p.get_float("emit", 0.0),
        transmit_filter=p.get_float("transmit_filter", 1.0),
        ior=p.get_float("IOR", 1.33),
        fresnel=p.get_bool("fresnel_effect", False),
        oren_nayar_sigma=sigma)
    _maybe_diffuse_tex(b, d, p)
    return b.add_material(name, d)


def _mat_glossy(b: SceneBuilder, name, p: ParamMap):
    aniso = p.get_bool("anisotropic", False)
    exp = p.get_float("exponent", 50.0)
    d = MaterialDef(
        mtype=MatType.GLOSSY,
        diffuse_color=p.get_color("diffuse_color", (1.0, 1.0, 1.0)),
        glossy_color=p.get_color("color", (1.0, 1.0, 1.0)),
        glossy_reflect=p.get_float("glossy_reflect", 1.0),
        diffuse_strength=p.get_float("diffuse_reflect", 1.0),
        exp_u=p.get_float("exp_u", exp) if aniso else exp,
        exp_v=p.get_float("exp_v", exp) if aniso else exp,
        as_diffuse=p.get_bool("as_diffuse", False),
        ior=p.get_float("IOR", 1.4),
        mirror_color=p.get_color("mirror_color", (1.0, 1.0, 1.0)))
    _maybe_diffuse_tex(b, d, p)
    return b.add_material(name, d)


def _texture(b: SceneBuilder, name, p: ParamMap):
    t = p.get_str("type")
    if t == "image":
        from core_tpu_torch.io.image import read_image
        return b.add_texture(name, TextureDef(
            ttype=TexType.IMAGE, image=read_image(p.get_str("filename")),
            interpolate=p.get_str("interpolate", "bilinear"),
            clip_mode=p.get_str("clipping", "repeat"),
            xrepeat=p.get_int("xrepeat", 1), yrepeat=p.get_int("yrepeat", 1),
            gamma=p.get_float("gamma", 1.0),
            use_alpha=p.get_bool("use_alpha", True)))
    kw = dict(color1=p.get_color("color1", (0, 0, 0)),
              color2=p.get_color("color2", (1, 1, 1)),
              size=p.get_float("size", 1.0),
              noise_type=p.get_str("noise_type", "newperlin"),
              hard=p.get_bool("hard", False))
    if t == "clouds":
        d = TextureDef(ttype=TexType.CLOUDS, depth=p.get_int("depth", 2),
                       bias={"none": 0, "positive": 1,
                             "negative": 2}.get(p.get_str("bias", "none"), 0),
                       **kw)
    elif t == "marble":
        d = TextureDef(ttype=TexType.MARBLE, depth=p.get_int("depth", 2),
                       turb=p.get_float("turbulence", 1.0),
                       sharpness=p.get_float("sharpness", 1.0),
                       shape=p.get_str("shape", "sin"), **kw)
    else:  # voronoi
        vt = {"f1": nz.V_F1, "f2": nz.V_F2, "f3": nz.V_F3, "f4": nz.V_F4,
              "f2f1": nz.V_F2F1, "crackle": nz.V_CRACKLE}.get(
            p.get_str("pattern", "f1"), nz.V_F1)
        d = TextureDef(ttype=TexType.VORONOI, vor_type=vt,
                       vor_mk_exp=p.get_float("exponent", 2.5),
                       vor_iscale=p.get_float("intensity", 1.0),
                       vor_weights=(p.get_float("weight1", 1.0),
                                    p.get_float("weight2", 0.0),
                                    p.get_float("weight3", 0.0),
                                    p.get_float("weight4", 0.0)), **kw)
    return b.add_texture(name, d)


def _bg_texture(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.backgrounds import make_texture_background
    tid = b.texture_names.get(p.get_str("texture"), 0)
    # the background owns its texture set (scene textures may grow later),
    # in which its texture is def 0 at atlas slot 0
    bg = make_texture_background(
        build_texture_set([b.textures[tid]], b.device), tex_id=0,
        power=p.get_float("power", 1.0),
        rotation=p.get_float("rotation", 0.0),
        projection="angular" if p.get_str("mapping", "") == "probe"
        else "sphere", ibl=p.get_bool("ibl", False),
        device=b.device)
    b.background = bg
    if p.get_bool("ibl", False):
        # textureback.cc:140-160: an importance-sampled background light
        def make():
            from core_tpu_torch.lights.bg import make_bg_light
            return make_bg_light(bg, samples=p.get_int("ibl_samples", 8),
                                 device=b.device)
        b._deferred_lights.append(make)
    return bg


def _light_sun(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.sun import make_sun_light
    light = make_sun_light(direction=p.get_point("direction", (0, 0, 1)),
                           color=p.get_color("color", (1, 1, 1)),
                           power=p.get_float("power", 1.0),
                           angle=p.get_float("angle", 0.27),
                           samples=p.get_int("samples", 4), device=b.device)
    b.lights.append(light)
    return light


def _light_point(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.point import make_point_light
    light = make_point_light(pos=p.get_point("from"),
                             color=p.get_color("color", (1, 1, 1)),
                             power=p.get_float("power", 1.0),
                             device=b.device)
    b.lights.append(light)
    return light


def _light_spot(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.spot import make_spot_light
    light = make_spot_light(pos=p.get_point("from"), to=p.get_point("to"),
                            color=p.get_color("color", (1, 1, 1)),
                            power=p.get_float("power", 1.0),
                            cone_angle=p.get_float("cone_angle", 45.0),
                            falloff=p.get_float("blend", 0.15),
                            photon_only=p.get_bool("photon_only", False),
                            device=b.device)
    b.lights.append(light)
    return light


def _light_directional(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.sun import make_directional_light
    light = make_directional_light(
        direction=p.get_point("direction", (0, 0, 1)),
        color=p.get_color("color", (1, 1, 1)),
        power=p.get_float("power", 1.0),
        infinite=p.get_bool("infinite", True),
        pos=p.get_point("from"), radius=p.get_float("radius", 1.0),
        device=b.device)
    b.lights.append(light)
    return light


_FACTORIES: dict[str, dict[str, Callable]] = {
    "material": {"shinydiffusemat": _mat_shinydiffuse, "glossy": _mat_glossy},
    "texture": {"clouds": _texture, "marble": _texture, "voronoi": _texture,
                "image": _texture},
    "background": {"textureback": _bg_texture},
    "light": {"sunlight": _light_sun, "pointlight": _light_point,
              "spotlight": _light_spot, "directional": _light_directional},
}
