"""Scene assembly by element factories (counterpart of
core_tpu/environment.py; reference renderEnvironment_t).

SceneBuilder collects created elements and geometry, then compile_scene
builds the Scene on a device.  Element types keep the reference's names:
  texture     clouds, marble, wood, voronoi, musgrave, distorted_noise,
              rgb_cube, blend, image (a .tga, .png, .hdr / .pic, .exr or
              .npy file)
  material    shinydiffusemat, glossy, coated_glossy (each may carry a list
              of shader nodes, `extra`, that its <slot>_shader parameters
              name, bump_shader included; glossy and coated_glossy take
              anisotropic with exp_u / exp_v), glass, rough_glass,
              blend_mat, mask_mat, mirror, null, light_mat, translucent
  background  constant, gradientback, sunsky, darksky, textureback (ibl /
              background_light add the importance-sampled background light
              at compile time; add_sun a sun light)
  light       arealight, spherelight, ieslight, meshlight, bgPortalLight,
              bglight, sunlight, pointlight, spotlight, directional
  camera      perspective, architect, angular, orthographic / ortho
  integrator  directlighting, pathtracing, photonmapping, SPPM,
              bidirectional, DebugIntegrator (the parameters are recorded
              as integrator_params, as core_tpu records them)
Any other type raises NotImplementedError by name.
A light that needs the compiled scene (the mesh lights and portals, which
read an object's triangles; the background lights, which read the
background) is made at the end of compile_scene by a deferred maker that
takes the scene, in creation order; one that finds nothing (an object with
no triangles, no background) makes no light.

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

import numpy as np
import torch

from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry.mesh import MeshAssembler
from core_tpu_torch.materials.base import (MaterialDef, MatType,
                                           build_material_table)
from core_tpu_torch.params import ParamMap
from core_tpu_torch.scene import Scene, resolve_intersector
from core_tpu_torch.textures import noise as nz
from core_tpu_torch.textures import nodes
from core_tpu_torch.textures.base import (MusgraveType, TexType, TextureDef,
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
        # makers of the lights created at compile time from the compiled
        # scene (mesh lights, portals, background lights): maker(scene)
        self._deferred_lights: list = []
        # shader-node programs: (mat_index, slot, node_defs, out_node_name)
        self.node_programs: list = []
        # the integrator element's parameters (the integrator factory)
        self.integrator_params = None

    def create(self, kind: str, name: str, params: ParamMap, extra=None):
        """Create one element; `extra` is a material's list of shader-node
        ParamMaps (the reference's paramsStartList / PushList)."""
        tname = params.get_str("type")
        fn = _FACTORIES.get(kind, {}).get(tname)
        if fn is None:
            raise NotImplementedError(f"{kind} type {tname!r} is not ported "
                                      "to core_tpu_torch yet")
        out = fn(self, name, params)
        if kind == "material" and tname in _NODE_MATERIALS:
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
        factories reading their '<slot>_shader' parameters).  A node type
        core_tpu does not know raises (core_tpu substitutes white)."""
        ndefs = tuple(nd for nd in (nodes.parse_node(pm) for pm in extra)
                      if nd is not None)
        if not ndefs:
            return
        nodes.check_supported(ndefs)
        names = {nd.name for nd in ndefs}
        for slot in self.NODE_SLOTS:
            ref = p.get_str(slot, "")
            if ref and ref in names:
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
        for make in self._deferred_lights:
            light = make(scene)
            if light is not None:
                scene = dataclasses.replace(scene,
                                            lights=scene.lights + (light,))
        return scene


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
    coated = p.get_str("type") == "coated_glossy"
    aniso = p.get_bool("anisotropic", False)
    exp = p.get_float("exponent", 50.0)
    d = MaterialDef(
        mtype=MatType.COATED_GLOSSY if coated else MatType.GLOSSY,
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
    elif t == "wood":
        d = TextureDef(ttype=TexType.WOOD, depth=p.get_int("depth", 2),
                       turb=p.get_float("turbulence", 1.0),
                       rings=p.get_str("wood_type", "bands") == "rings",
                       shape=p.get_str("shape", "sin"), **kw)
    elif t == "voronoi":
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
    elif t == "musgrave":
        mt = {"fBm": MusgraveType.FBM,
              "multifractal": MusgraveType.MULTIFRACTAL,
              "heteroterrain": MusgraveType.HETERO_TERRAIN,
              "hybridmf": MusgraveType.HYBRID_MF,
              "ridgedmf": MusgraveType.RIDGED_MF}.get(
            p.get_str("musgrave_type", "fBm"), MusgraveType.FBM)
        d = TextureDef(ttype=TexType.MUSGRAVE, mus_type=mt,
                       mus_h=p.get_float("H", 1.0),
                       mus_lacunarity=p.get_float("lacunarity", 2.0),
                       mus_octaves=p.get_float("octaves", 2.0),
                       mus_offset=p.get_float("offset", 1.0),
                       mus_gain=p.get_float("gain", 1.0),
                       mus_iscale=p.get_float("intensity", 1.0), **kw)
    elif t == "distorted_noise":
        d = TextureDef(ttype=TexType.DISTORTED,
                       distort=p.get_float("distort", 1.0),
                       noise_type2=p.get_str("noise_type2", "newperlin"),
                       **kw)
    elif t == "rgb_cube":
        d = TextureDef(ttype=TexType.RGB_CUBE)
    else:  # blend
        d = TextureDef(ttype=TexType.BLEND,
                       blend_type=p.get_str("stype", "lin"))
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
    _auto_ibl(b, bg, p)
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


def _mat_glass(b: SceneBuilder, name, p: ParamMap):
    rough = p.get_str("type") == "rough_glass"
    return b.add_material(name, MaterialDef(
        mtype=MatType.ROUGH_GLASS if rough else MatType.GLASS,
        ior=p.get_float("IOR", 1.4),
        filter_color=p.get_color("filter_color", (1.0, 1.0, 1.0)),
        mirror_color=p.get_color("mirror_color", (1.0, 1.0, 1.0)),
        transmit_filter=p.get_float("transmit_filter", 1.0),
        absorption=p.get_color("absorption", (0.0, 0.0, 0.0)),
        dispersion=p.get_float("dispersion_power", 0.0),
        fake_shadows=p.get_bool("fake_shadows", False),
        alpha_rough=p.get_float("alpha", 0.5) if rough else 0.0))


def _mat_blend(b: SceneBuilder, name, p: ParamMap):
    return b.add_material(name, MaterialDef(
        mtype=MatType.BLEND,
        sub_mat0=b.material_index(p.get_str("material1", "")),
        sub_mat1=b.material_index(p.get_str("material2", "")),
        blend_val=p.get_float("blend_value", 0.5)))


def _mat_mask(b: SceneBuilder, name, p: ParamMap):
    d = MaterialDef(
        mtype=MatType.MASK,
        sub_mat0=b.material_index(p.get_str("material1", "")),
        sub_mat1=b.material_index(p.get_str("material2", "")),
        blend_val=p.get_float("threshold", 0.5))
    tname = p.get_str("mask", "")
    if tname in b.texture_names:
        d.blend_tex = b.texture_names[tname]
    return b.add_material(name, d)


def _mat_mirror(b: SceneBuilder, name, p: ParamMap):
    return b.add_material(name, MaterialDef(
        mirror_strength=p.get_float("reflect", 1.0),
        mirror_color=p.get_color("color", (1.0, 1.0, 1.0)),
        diffuse_strength=0.0))


def _mat_null(b: SceneBuilder, name, p: ParamMap):
    return b.add_material(name, MaterialDef(diffuse_strength=0.0))


def _mat_translucent(b: SceneBuilder, name, p: ParamMap):
    """TheBounty's SSS material (src/materials/translucent.cc; core_tpu
    environment.py:501-518): a glossy + diffuse surface whose sigmaA /
    sigmaS / g drive the SSS map (integrators/sss.py) under use_sss."""
    return b.add_material(name, MaterialDef(
        mtype=MatType.TRANSLUCENT,
        diffuse_color=p.get_color("color", (1.0, 1.0, 1.0)),
        glossy_color=p.get_color("glossy_color", (1.0, 1.0, 1.0)),
        glossy_reflect=p.get_float("glossy_reflect", 0.2),
        diffuse_strength=p.get_float("diffuse_reflect", 1.0),
        exp_u=p.get_float("exponent", 50.0),
        exp_v=p.get_float("exponent", 50.0),
        ior=p.get_float("IOR", 1.3),
        absorption=p.get_color("sigmaA", (0.01, 0.01, 0.01)),
        sigma_s=p.get_color("sigmaS", (1.0, 1.0, 1.0)),
        sss_g=p.get_float("g", 0.0)))


def _integrator(b: SceneBuilder, name, p: ParamMap):
    """core_tpu environment.py:912-916: the parameters are kept for the
    render options."""
    b.integrator_params = p
    return p


def _mat_light(b: SceneBuilder, name, p: ParamMap):
    """What an emitter's geometry wears (a mesh light's object)."""
    return b.add_material(name, MaterialDef(
        diffuse_color=p.get_color("color", (1.0, 1.0, 1.0)),
        diffuse_strength=0.0, emit_strength=p.get_float("power", 1.0)))


def _light_area(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.area import make_area_light
    light = make_area_light(corner=p.get_point("corner"),
                            point1=p.get_point("point1"),
                            point2=p.get_point("point2"),
                            color=p.get_color("color", (1, 1, 1)),
                            power=p.get_float("power", 1.0),
                            samples=p.get_int("samples", 4), device=b.device)
    b.lights.append(light)
    return light


def _light_sphere(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.sphere import make_sphere_light
    light = make_sphere_light(center=p.get_point("from"),
                              radius=p.get_float("radius", 1.0),
                              color=p.get_color("color", (1, 1, 1)),
                              power=p.get_float("power", 1.0),
                              samples=p.get_int("samples", 4),
                              device=b.device)
    b.lights.append(light)
    return light


def _light_ies(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.lights.ies import make_ies_light
    with open(p.get_str("file", "")) as f:
        text = f.read()
    light = make_ies_light(pos=p.get_point("from"), to=p.get_point("to"),
                           color=p.get_color("color", (1.0, 1.0, 1.0))[:3],
                           power=p.get_float("power", 1.0), ies_text=text,
                           samples=p.get_int("samples", 1), device=b.device)
    b.lights.append(light)
    return light


def _object_tris(scene, obj_id: int):
    """(verts, the object's triangles) as numpy, or None when the object
    has no triangles."""
    sel = scene.geom.tri_obj.cpu().numpy() == obj_id
    if not sel.any():
        return None
    return (scene.geom.verts.cpu().numpy(),
            scene.geom.tri_vidx.cpu().numpy()[sel])


def _light_mesh(b: SceneBuilder, name, p: ParamMap):
    obj_id = p.get_int("object", 0)

    def make(scene):
        from core_tpu_torch.lights.mesh import make_mesh_light
        got = _object_tris(scene, obj_id)
        return None if got is None else make_mesh_light(
            *got, color=p.get_color("color", (1, 1, 1)),
            power=p.get_float("power", 1.0), samples=p.get_int("samples", 4),
            double_sided=p.get_bool("double_sided", False), obj_id=obj_id,
            device=b.device)

    b._deferred_lights.append(make)


def _light_portal(b: SceneBuilder, name, p: ParamMap):
    # bgportallight.cc binds a portal object and the scene background, both
    # known at compile time only
    obj_id = p.get_int("object", 0)

    def make(scene):
        from core_tpu_torch.lights.portal import make_bg_portal_light
        got = _object_tris(scene, obj_id)
        return None if got is None else make_bg_portal_light(
            *got, background=scene.background,
            power=p.get_float("power", 1.0), samples=p.get_int("samples", 4),
            obj_id=obj_id, device=b.device)

    b._deferred_lights.append(make)


def _light_bg(b: SceneBuilder, name, p: ParamMap):
    def make(scene):
        from core_tpu_torch.lights.bg import make_bg_light
        if scene.background is None:
            return None
        return make_bg_light(scene.background,
                             samples=p.get_int("samples", 8),
                             abs_intersect=p.get_bool("abs_intersect", False),
                             device=b.device)

    b._deferred_lights.append(make)


def _deferred_bg_light(b: SceneBuilder, bg, samples: int):
    def make(scene):
        from core_tpu_torch.lights.bg import make_bg_light
        return make_bg_light(bg, samples=samples, device=b.device)
    b._deferred_lights.append(make)


def _auto_ibl(b: SceneBuilder, bg, p: ParamMap):
    """ibl=True: an importance-sampled background light
    (textureback.cc:140-160)."""
    if p.get_bool("ibl", False):
        _deferred_bg_light(b, bg, p.get_int("ibl_samples", 8))


def _bg_constant(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.backgrounds import make_constant_background
    bg = make_constant_background(color=p.get_color("color", (1, 1, 1)),
                                  power=p.get_float("power", 1.0),
                                  ibl=p.get_bool("ibl", False),
                                  ibl_samples=p.get_int("ibl_samples", 8),
                                  device=b.device)
    b.background = bg
    _auto_ibl(b, bg, p)
    return bg


def _bg_gradient(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.backgrounds import make_gradient_background
    bg = make_gradient_background(
        horizon=p.get_color("horizon_color", (1, 1, 1)),
        zenith=p.get_color("zenith_color", (0.4, 0.5, 1.0)),
        horizon_ground=p.get_color("horizon_ground_color", None)
        if "horizon_ground_color" in p else None,
        zenith_ground=p.get_color("zenith_ground_color", None)
        if "zenith_ground_color" in p else None,
        power=p.get_float("power", 1.0), ibl=p.get_bool("ibl", False),
        device=b.device)
    b.background = bg
    _auto_ibl(b, bg, p)
    return bg


def _bg_darksky(b: SceneBuilder, name, p: ParamMap):
    """darksky.cc's factory: spectral daylight with a colour space, night
    mode, the attenuated 'Real Sun' (add_sun) and its background light
    (background_light, light_samples)."""
    from core_tpu_torch.backgrounds import (darksky_sun_color,
                                            make_darksky_background)
    from core_tpu_torch.lights.sun import make_sun_light
    turb = p.get_float("turbidity", 4.0)
    night = p.get_bool("night", False)
    bright = p.get_float("bright", 1.0)
    sun_power = p.get_float("sun_power", 1.0)
    if night:
        bright *= 0.5
        sun_power *= 0.5
    bg = make_darksky_background(
        sun_dir=p.get_point("from", (1, 1, 1)), turbidity=turb,
        a_var=p.get_float("a_var", 1.0), b_var=p.get_float("b_var", 1.0),
        c_var=p.get_float("c_var", 1.0), d_var=p.get_float("d_var", 1.0),
        e_var=p.get_float("e_var", 1.0), power=p.get_float("power", 1.0),
        bright=bright, altitude=p.get_float("altitude", 0.0), night=night,
        exposure=p.get_float("exposure", 1.0),
        color_space=p.get_str("color_space", "CIE (E)"),
        ibl=p.get_bool("background_light", False),
        ibl_samples=p.get_int("light_samples", 8), device=b.device)
    b.background = bg
    d = np.asarray(p.get_point("from", (1, 1, 1)), np.float64)
    dn = d / max(np.linalg.norm(d), 1e-20)
    if p.get_bool("add_sun", False) and \
            np.degrees(np.arccos(np.clip(d[2], -1.0, 1.0))) < 100.0:
        b.lights.append(make_sun_light(
            direction=dn, color=darksky_sun_color(bg, turb), power=sun_power,
            angle=float(0.5 * (2.0 - dn[2])),
            samples=p.get_int("light_samples", 8), device=b.device))
    if p.get_bool("background_light", False):
        _deferred_bg_light(b, bg, p.get_int("light_samples", 8))
    return bg


def _bg_sunsky(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.backgrounds import make_sunsky_background
    from core_tpu_torch.lights.sun import make_sun_light
    bg = make_sunsky_background(
        sun_dir=p.get_point("from", (1, 1, 1)),
        turbidity=p.get_float("turbidity", 4.0),
        a_var=p.get_float("a_var", 1.0), b_var=p.get_float("b_var", 1.0),
        c_var=p.get_float("c_var", 1.0), d_var=p.get_float("d_var", 1.0),
        e_var=p.get_float("e_var", 1.0), power=p.get_float("power", 1.0),
        device=b.device)
    b.background = bg
    if p.get_bool("add_sun", False):
        b.lights.append(make_sun_light(
            direction=p.get_point("from", (1, 1, 1)), color=(1, 1, 1),
            power=p.get_float("sun_power", 1.0), device=b.device))
    _auto_ibl(b, bg, p)
    return bg


_BOKEH = {"disk1": "DISK1", "disk2": "DISK2", "triangle": "TRIANGLE",
          "square": "SQUARE", "pentagon": "PENTAGON", "hexagon": "HEXAGON",
          "ring": "RING"}
_BIAS = {"uniform": "NONE", "center": "CENTER", "edge": "EDGE"}


def _cam_perspective(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.cameras import BokehBias, BokehType, make_perspective
    cam = make_perspective(
        pos=p.get_point("from"), look=p.get_point("to"),
        up=p.get_point("up"), resx=p.get_int("resx", 320),
        resy=p.get_int("resy", 240), aspect=p.get_float("aspect_ratio", 1.0),
        focal=p.get_float("focal", 1.0),
        aperture=p.get_float("aperture", 0.0),
        dof_distance=p.get_float("dof_distance", 0.0),
        bokeh_type=BokehType[_BOKEH.get(p.get_str("bokeh_type", "disk1"),
                                        "DISK1")],
        bokeh_bias=BokehBias[_BIAS.get(p.get_str("bokeh_bias", "uniform"),
                                       "NONE")],
        bokeh_rot=p.get_float("bokeh_rotation", 0.0),
        architect=p.get_str("type") == "architect", device=b.device)
    b.camera = cam
    return cam


def _cam_angular(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.cameras import make_angular
    cam = make_angular(pos=p.get_point("from"), look=p.get_point("to"),
                       up=p.get_point("up"), resx=p.get_int("resx", 320),
                       resy=p.get_int("resy", 240),
                       angle=p.get_float("angle", 90.0),
                       max_angle=p.get_float("max_angle")
                       if "max_angle" in p else None,
                       circular=p.get_bool("circular", True),
                       device=b.device)
    b.camera = cam
    return cam


def _cam_ortho(b: SceneBuilder, name, p: ParamMap):
    from core_tpu_torch.cameras import make_orthographic
    cam = make_orthographic(pos=p.get_point("from"), look=p.get_point("to"),
                            up=p.get_point("up"),
                            resx=p.get_int("resx", 320),
                            resy=p.get_int("resy", 240),
                            scale=p.get_float("scale", 1.0), device=b.device)
    b.camera = cam
    return cam


# the material types whose factories read shader nodes (core_tpu's
# shinydiffusemat and glossy factories)
_NODE_MATERIALS = ("shinydiffusemat", "glossy", "coated_glossy")


_FACTORIES: dict[str, dict[str, Callable]] = {
    "material": {"shinydiffusemat": _mat_shinydiffuse, "glossy": _mat_glossy,
                 "coated_glossy": _mat_glossy, "glass": _mat_glass,
                 "rough_glass": _mat_glass, "blend_mat": _mat_blend,
                 "mask_mat": _mat_mask, "mirror": _mat_mirror,
                 "null": _mat_null, "light_mat": _mat_light,
                 "translucent": _mat_translucent},
    "texture": {t: _texture for t in (
        "clouds", "marble", "wood", "voronoi", "musgrave", "distorted_noise",
        "rgb_cube", "blend", "image")},
    "background": {"textureback": _bg_texture, "constant": _bg_constant,
                   "gradientback": _bg_gradient, "darksky": _bg_darksky,
                   "sunsky": _bg_sunsky},
    "light": {"sunlight": _light_sun, "pointlight": _light_point,
              "spotlight": _light_spot, "directional": _light_directional,
              "arealight": _light_area, "ieslight": _light_ies,
              "bgPortalLight": _light_portal, "spherelight": _light_sphere,
              "meshlight": _light_mesh, "bglight": _light_bg},
    "camera": {"perspective": _cam_perspective,
               "architect": _cam_perspective, "angular": _cam_angular,
               "orthographic": _cam_ortho, "ortho": _cam_ortho},
    "integrator": {t: _integrator for t in (
        "directlighting", "pathtracing", "photonmapping", "SPPM",
        "bidirectional", "DebugIntegrator")},
}
