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
              as integrator_params, as core_tpu records them); the volume
              integrators none, EmissionIntegrator, SingleScatterIntegrator,
              SkyIntegrator (recorded as volume_integrator_params)
  volumeregion UniformVolume, ExpDensityVolume, NoiseVolume, GridVolume
              (a grid array, or a df3 / .npy density_file), SkyVolume
  object      sphere (tessellated as core_tpu tessellates it)
Any other type raises NotImplementedError by name.
SceneBuilder.render_options / setup_render_options map the scene file's
render, integrator and volume-integrator parameters onto RenderOptions, as
core_tpu's do (environment.py:231-386); the volume integrator's world-space
stepSize becomes a static march count (volume_march_steps).
A light that needs the compiled scene (the mesh lights and portals, which
read an object's triangles; the background lights, which read the
background) is made at the end of compile_scene by a deferred maker that
takes the scene, in creation order; one that finds nothing (an object with
no triangles, no background) makes no light.

The geometry calls of core_tpu's SceneBuilder (start_mesh, add_vertex,
add_uv, set_material, add_triangle, smooth_mesh, end_mesh, the curve calls
and add_instance) drive the assembler as core_tpu's do; a scene without a
camera gets core_tpu's default one.  The render parameter spp_chunk (the
samples of one wavefront, RenderOptions.spp_chunk) is this package's own:
core_tpu ignores it and renders in chunks of 4.

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
from core_tpu_torch.volumes import regions as vr

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
        self.volumes: list = []
        # the integrator elements' parameters (the integrator factories)
        # and the scene file's render parameters, for render_options
        self.integrator_params = None
        self.volume_integrator_params = None
        self.render_params = ParamMap()
        # the geometry state machine: the open mesh, its current material
        # and the elements pushed since the last flush into its blocks
        self._cur_mesh = None
        self._cur_mesh_mat = 0
        self._clear_pending()

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
        core_tpu does not know evaluates to white, as there."""
        ndefs = tuple(nd for nd in (nodes.parse_node(pm) for pm in extra)
                      if nd is not None)
        if not ndefs:
            return
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

    # ---- geometry: scene_t's state machine (core_tpu environment.py:
    # 123-177).  Elements pushed one call each are kept in Python lists and
    # become one numpy block each when the mesh ends, so a file of 100k+
    # elements assembles in one pass. ----

    def _clear_pending(self):
        self._pend_v, self._pend_uv = [], []
        self._pend_f, self._pend_fuv, self._pend_fmat = [], [], []
        self._curve_points = []

    def _flush_mesh(self):
        m, a = self._cur_mesh, self.assembler
        if m is not None:
            if self._pend_v:
                a.add_vertices(m, self._pend_v)
            if self._pend_uv:
                a.add_uvs(m, self._pend_uv)
            if self._pend_f:
                fuv = self._pend_fuv
                uv_ids = None if all(u is None for u in fuv) else [
                    (-1, -1, -1) if u is None else u for u in fuv]
                a.add_triangles(m, self._pend_f, self._pend_fmat, uv_ids)
        self._clear_pending()

    def start_mesh(self, obj_id=None, has_uv=False):
        """Opens a mesh under the next object id (obj_id is not used, as in
        core_tpu: the XML loader sets an explicit id on the result)."""
        self._flush_mesh()
        self._cur_mesh = self.assembler.start_mesh()
        self._cur_mesh_mat = 0
        return self._cur_mesh

    def add_vertex(self, x, y, z) -> int:
        self._pend_v.append((float(x), float(y), float(z)))
        return self._cur_mesh.n_verts + len(self._pend_v) - 1

    def add_uv(self, u, v) -> int:
        self._pend_uv.append((float(u), float(v)))
        return self._cur_mesh.n_uvs + len(self._pend_uv) - 1

    def set_material(self, name: str):
        """An unknown name selects material 0, as material_index does."""
        self._cur_mesh_mat = self.material_index(name)

    def add_triangle(self, a, b, c, uv=None):
        self._pend_f.append((int(a), int(b), int(c)))
        self._pend_fuv.append(None if uv is None
                              else tuple(int(i) for i in uv))
        self._pend_fmat.append(self._cur_mesh_mat)

    def smooth_mesh(self, obj_id, angle) -> bool:
        for m in self.assembler.meshes:
            if m.obj_id == obj_id:
                self.assembler.smooth_mesh(m, angle)
                return True
        return False

    def end_mesh(self):
        self._flush_mesh()
        self._cur_mesh = None

    def start_curve_mesh(self, obj_id=None):
        """A strand (scene_t::startCurveMesh, scene.cc:118): its points are
        collected until end_curve_mesh."""
        self._flush_mesh()
        self._cur_mesh = self.assembler.start_mesh()
        return self._cur_mesh

    def add_curve_vertex(self, x, y, z) -> int:
        self._curve_points.append((float(x), float(y), float(z)))
        return len(self._curve_points) - 1

    def end_curve_mesh(self, mat_name: str, strand_start: float,
                       strand_end: float, strand_shape: float):
        """Tessellates the collected strand (scene_t::endCurveMesh)."""
        self.assembler.add_curve(self._cur_mesh, self._curve_points,
                                 self.material_index(mat_name),
                                 strand_start, strand_end, strand_shape)
        self._cur_mesh = None
        self._clear_pending()
        return True

    def add_instance(self, base_obj_id, matrix) -> int:
        return self.assembler.add_instance(base_obj_id, np.asarray(matrix))

    def compile_scene(self) -> Scene:
        """The Scene on the builder's device.  Without a camera, core_tpu's
        default one (environment.py:192-195): perspective from (0, 1, -5)
        toward (0, 1, 0), 320 x 240."""
        self._flush_mesh()
        if not self.materials:
            self.add_material("default", MaterialDef())
        if self.camera is None:
            from core_tpu_torch.cameras import make_perspective
            self.camera = make_perspective(pos=(0, 1, -5), look=(0, 1, 0),
                                           up=(0, 2, -5), resx=320,
                                           resy=240, device=self.device)
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
            if self.textures else None, volumes=tuple(self.volumes),
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

    def render_options(self):
        """RenderOptions from the recorded render, integrator and volume
        integrator parameters; the largest volume's diagonal turns the
        volume integrator's stepSize into a march count."""
        span = None
        if self.volumes:
            span = max(float(np.linalg.norm((v.bmax - v.bmin).cpu().numpy()))
                       for v in self.volumes)
        return setup_render_options(self.render_params,
                                    self.integrator_params,
                                    self.volume_integrator_params,
                                    volume_span=span)


def volume_march_steps(step_size: float, volume_span) -> int:
    """The static march count of a world-space stepSize
    (SingleScatterIntegrator.cc:16): ceil(span / stepSize) over the largest
    volume's diagonal, clamped to [4, 128]; 16 without volumes."""
    if volume_span is None or volume_span <= 0:
        return 16
    return int(np.clip(np.ceil(volume_span / step_size), 4, 128))


def setup_render_options(rp: ParamMap, ip, vp, volume_span=None):
    """The reference's global render and integrator parameters as
    RenderOptions (environment.cc setupScene :596-705, createImageFilm
    :481-532; the integrator factories in src/integrators/), every field
    as core_tpu's setup_render_options sets it.  An unknown surface
    integrator raises ValueError, as in core_tpu."""
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.bidir import BidirOptions
    from core_tpu_torch.integrators.debug import DebugOptions
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.integrators.photonmap import PhotonOptions
    from core_tpu_torch.integrators.sppm import SPPMOptions
    from core_tpu_torch.integrators.volume import VolumeOptions
    from core_tpu_torch.render import RenderOptions

    ip = ip or ParamMap({"type": "directlighting"})
    itype = ip.get_str("type", "directlighting")
    raydepth = ip.get_int("raydepth", 5)
    bg_transp = rp.get_bool("bg_transp", False)
    common_ao = dict(
        transp_shad=ip.get_bool("transpShad", False),
        shadow_depth=ip.get_int("shadowDepth", 5),
        use_ao=ip.get_bool("do_AO", False),
        ao_samples=ip.get_int("AO_samples", 32),
        ao_dist=ip.get_float("AO_distance", 1.0),
        ao_color=ip.get_color("AO_color", (1.0, 1.0, 1.0)),
        transp_background=bg_transp)
    sss = dict(use_sss=ip.get_bool("useSSS", False),
               sss_photons=ip.get_int("sssPhotons", 8192),
               sss_steps=ip.get_int("sssDepth", 4),
               sss_scale=ip.get_float("sssScale", 1.0))
    if itype in ("pathtracing", "pathtracer"):
        integrator = "pathtracing"
        iopts = PathOptions(
            path_samples=ip.get_int("path_samples", 32),
            bounces=ip.get_int("bounces", 3), raydepth=raydepth,
            no_recursive=ip.get_bool("no_recursive", False),
            caustic_type=ip.get_str("caustic_type", "path"),
            c_photons=ip.get_int("photons", 500000),
            caustic_radius=ip.get_float("caustic_radius", 0.25),
            caustic_depth=ip.get_int("caustic_depth", 10),
            **sss, **common_ao)
    elif itype == "photonmapping":
        integrator = "photonmapping"
        iopts = PhotonOptions(
            photons=ip.get_int("photons", 100000),
            c_photons=ip.get_int("cPhotons", 50000),
            diffuse_radius=ip.get_float("diffuseRadius", 1.0),
            caustic_radius=ip.get_float("causticRadius", 0.1),
            bounces=ip.get_int("bounces", 5),
            final_gather=ip.get_bool("finalGather", True),
            fg_samples=ip.get_int("fg_samples", 16), raydepth=raydepth,
            transp_background=bg_transp)
    elif itype == "SPPM":
        integrator = "SPPM"
        iopts = SPPMOptions(
            passes=ip.get_int("passNums", 8),
            photons=ip.get_int("photons", 100000),
            bounces=ip.get_int("bounces", 5),
            search_radius=ip.get_float("photonRadius", 1.0)
            * ip.get_float("times", 1.0),
            pm_ire=ip.get_bool("pmIRE", False),
            search_count=ip.get_int("searchNum", 64), raydepth=raydepth)
    elif itype == "bidirectional":
        integrator = "bidirectional"
        iopts = BidirOptions(
            eye_depth=min(raydepth, 6), light_depth=min(raydepth, 6),
            transp_background=bg_transp,
            do_light_image=ip.get_bool("do_LightImage", True))
    elif itype == "DebugIntegrator":
        integrator = "debug"
        dbg = {1: "N", 2: "dPdU", 3: "dPdV", 4: "NU", 5: "NV",
               6: "dSdU", 7: "dSdV"}
        iopts = DebugOptions(
            debug_type=dbg.get(ip.get_int("debugType", 1), "N"),
            show_pn=ip.get_bool("showPN", False))
    elif itype == "directlighting":
        integrator = "directlight"
        iopts = DirectOptions(raydepth=raydepth, **sss, **common_ao)
    else:
        raise ValueError(f"unknown surface integrator type '{itype}'")

    vpm = vp or ParamMap()
    step_size = max(1e-4, vpm.get_float("stepSize", 1.0))
    vopts = VolumeOptions(
        integrator=_VOLUME_INTEGRATORS.get(vpm.get_str("type", "none"),
                                           "none"),
        step_size=step_size,
        steps=volume_march_steps(step_size, volume_span),
        sky_alpha=vpm.get_float("alpha", 0.5),
        sky_scale=vpm.get_float("sigma_t", 0.1),
        sky_turbidity=vpm.get_float("turbidity", 3.0),
        optimize=vpm.get_bool("optimize", False),
        att_grid_res=max(4, 8 * vpm.get_int("attgridScale", 2)))
    filt = {"box": FilterType.BOX, "mitchell": FilterType.MITCHELL,
            "gauss": FilterType.GAUSS, "lanczos": FilterType.LANCZOS}.get(
        rp.get_str("filter_type", "box").lower(), FilterType.BOX)
    return RenderOptions(
        aa_passes=max(1, rp.get_int("AA_passes", 1)),
        aa_samples=max(1, rp.get_int("AA_minsamples", 1)),
        aa_inc_samples=max(1, rp.get_int("AA_inc_samples", 1)),
        aa_threshold=rp.get_float("AA_threshold", 0.05),
        filter_type=filt, filter_size=rp.get_float("AA_pixelwidth", 1.5),
        gamma=rp.get_float("gamma", 1.0),
        clamp_rgb=rp.get_bool("clamp_rgb", False),
        premult=rp.get_bool("premult", False),
        show_sam_pix=rp.get_bool("show_sam_pix", False),
        spp_chunk=max(1, rp.get_int("spp_chunk", RenderOptions.spp_chunk)),
        integrator=integrator, integrator_opts=iopts, volume_opts=vopts,
        z_channel=rp.get_bool("z_channel", False))


# the volume integrator element types (core_tpu environment.py:916-923)
_VOLUME_INTEGRATORS = {"none": "none", "EmissionIntegrator": "emission",
                       "SingleScatterIntegrator": "singlescatter",
                       "SkyIntegrator": "sky"}


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


def _vol_integrator(b: SceneBuilder, name, p: ParamMap):
    """core_tpu environment.py:919-923: the parameters are kept for the
    render options' VolumeOptions."""
    b.volume_integrator_params = p
    return p


def _box_of(p: ParamMap):
    return dict(bmin=(p.get_float("minX"), p.get_float("minY"),
                      p.get_float("minZ")),
                bmax=(p.get_float("maxX"), p.get_float("maxY"),
                      p.get_float("maxZ")))


def _media(p: ParamMap):
    return dict(sigma_a=p.get_float("sigma_a", 0.1),
                sigma_s=p.get_float("sigma_s", 0.1),
                l_e=p.get_float("l_e", 0.0), g=p.get_float("g", 0.0))


def _add_volume(b: SceneBuilder, vol):
    b.volumes.append(vol)
    return vol


def _vol_uniform(b: SceneBuilder, name, p: ParamMap):
    return _add_volume(b, vr.make_uniform_volume(
        **_media(p), **_box_of(p), device=b.device))


def _vol_exp(b: SceneBuilder, name, p: ParamMap):
    return _add_volume(b, vr.make_expdensity_volume(
        **_media(p), a=p.get_float("a", 1.0), b=p.get_float("b", 1.0),
        **_box_of(p), device=b.device))


def _vol_noise(b: SceneBuilder, name, p: ParamMap):
    return _add_volume(b, vr.make_noise_volume(
        **_media(p), sharpness=p.get_float("sharpness", 1.0),
        cover=p.get_float("cover", 1.0), density=p.get_float("density", 1.0),
        **_box_of(p), device=b.device))


def _vol_grid(b: SceneBuilder, name, p: ParamMap):
    """A `grid` array, else the voxels of `density_file` (df3 or .npy,
    GridVolume.cc:40-125), else a 2x2x2 grid of ones."""
    g = p.get("grid")
    if g is None and p.get_str("density_file", ""):
        g = vr.load_density_grid(p.get_str("density_file"))
    if g is None:
        g = np.ones((2, 2, 2), np.float32)
    return _add_volume(b, vr.make_grid_volume(
        grid=g, **_media(p), **_box_of(p), device=b.device))


def _vol_sky(b: SceneBuilder, name, p: ParamMap):
    return _add_volume(b, vr.make_sky_volume(
        s_ray=p.get_float("sigma_t", 0.05) * 0.8,
        s_mie=p.get_float("sigma_t", 0.05) * 0.2,
        l_e=p.get_float("l_e", 0.0), g=p.get_float("g", 0.8), **_box_of(p),
        device=b.device))


def _obj_sphere(b: SceneBuilder, name, p: ParamMap):
    """The sphere object (std_primitives.cc:33-90), tessellated as
    core_tpu tessellates it (environment.py:926-960): tess_v + 1 rings of
    tess_u + 1 vertices at exact sphere positions, U = atan2(y, x)/pi + 1,
    V = 1 - theta/pi, outward winding, all-smooth normals.  Returns the
    object id."""
    center = np.asarray(p.get_point("center", (0.0, 0.0, 0.0)), np.float64)
    radius = p.get_float("radius", 1.0)
    mat = b.material_index(p.get_str("material", ""))
    n_u = int(p.get_int("tess_u", 64))
    n_v = int(p.get_int("tess_v", 32))
    a = b.assembler
    m = a.start_mesh()
    verts, uvs = [], []
    # element by element with numpy's scalar functions, as core_tpu does
    for j in range(n_v + 1):
        theta = np.pi * j / n_v
        for i in range(n_u + 1):
            phi = 2 * np.pi * i / n_u
            nrm = np.array([np.sin(theta) * np.cos(phi),
                            np.sin(theta) * np.sin(phi), np.cos(theta)])
            verts.append(center + radius * nrm)
            uvs.append((np.arctan2(nrm[1], nrm[0]) / np.pi + 1.0,
                        1.0 - theta / np.pi))
    v0 = a.add_vertices(m, np.asarray(verts))
    u0 = a.add_uvs(m, np.asarray(uvs))
    faces, face_uvs = [], []

    def idx(j, i):
        return j * (n_u + 1) + i

    for j in range(n_v):
        for i in range(n_u):
            q = (idx(j, i), idx(j, i + 1), idx(j + 1, i + 1), idx(j + 1, i))
            tris = ([(q[0], q[2], q[1])] if j > 0 else []) \
                + ([(q[0], q[3], q[2])] if j < n_v - 1 else [])
            faces += [tuple(v0 + k for k in t) for t in tris]
            face_uvs += [tuple(u0 + k for k in t) for t in tris]
    a.add_triangles(m, faces, mat, uv_ids=face_uvs)
    a.smooth_mesh(m, 181.0)
    return m.obj_id


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
    "integrator": {**{t: _integrator for t in (
        "directlighting", "pathtracing", "photonmapping", "SPPM",
        "bidirectional", "DebugIntegrator")},
        **{t: _vol_integrator for t in _VOLUME_INTEGRATORS}},
    "volumeregion": {"UniformVolume": _vol_uniform,
                     "ExpDensityVolume": _vol_exp,
                     "NoiseVolume": _vol_noise, "GridVolume": _vol_grid,
                     "SkyVolume": _vol_sky},
    "object": {"sphere": _obj_sphere},
}
