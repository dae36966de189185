"""Built-in example scenes (counterpart of core_tpu/scenes.py).

cornell_box: the classic Cornell box with an area light, shiny-diffuse
walls and white, mirror, glass, glossy or blend blocks.
mesh_scene: a displaced terrain grid and a smooth torus with marble and
voronoi textured materials, a clouds environment with importance-sampled
IBL and a sun light; big_scene is its 1,017,202-triangle size.
mesh_builder holds mesh_scene's elements but its background and lights;
add_dirac_lights gives such a builder the dirac variant's lighting.
golden_mesh_scene: the reference renderer's textured torus and ground
(checker.tga through texture_mapper nodes) lit only by a sky.tga
environment with IBL, the scene of the mesh + IBL goldens.
golden_volume_scene: a spotlight shaft through a uniform fog box over a
grey ground, the scene of the volume golden.
MESH_ZOO: the elements of the "mesh zoo", mesh_scene with its materials
swapped for the procedural textures, mix / layer nodes, bump mapping and
coated anisotropic glossy, as plain data (core_tpu has no scene function
for it; chip_smoke.zoo_builder feeds it to either package's builder).
LIGHT_ZOO: the "light zoo", mesh_scene's geometry and camera placement
with an emitter panel and a portal quad, lit by a sphere, a mesh, an IES
and a portal light under a darksky with its sun and background light, seen
through a hexagonal thin lens (chip_smoke.light_zoo_builder feeds it to
either package's builder).

Each is built host-side in numpy exactly as core_tpu builds it, so the two
packages' scenes agree leaf by leaf.  Every entry point builds on the card
unless the caller passes device="cpu".
"""
from __future__ import annotations

import os

import numpy as np

from core_tpu_torch.cameras import make_perspective
from core_tpu_torch.geometry.mesh import MeshAssembler
from core_tpu_torch.lights.area import make_area_light
from core_tpu_torch.materials.base import (MaterialDef, MatType,
                                           build_material_table)
from core_tpu_torch.params import ParamMap
from core_tpu_torch.scene import Scene, check_device, resolve_intersector


def _add_quad(a: MeshAssembler, m, p0, p1, p2, p3, mat: int):
    """Two triangles, CCW as seen from the visible side."""
    i0 = a.add_vertex(m, *p0)
    i1 = a.add_vertex(m, *p1)
    i2 = a.add_vertex(m, *p2)
    i3 = a.add_vertex(m, *p3)
    a.add_triangle(m, i0, i1, i2, mat)
    a.add_triangle(m, i0, i2, i3, mat)


def _box(a, m, corner, size_x, size_z, height, angle_deg, mat):
    """Axis-rotated box standing on the floor (classic Cornell blocks)."""
    c, s = np.cos(np.radians(angle_deg)), np.sin(np.radians(angle_deg))
    rot = np.array([[c, 0, -s], [0, 1, 0], [s, 0, c]])
    base = np.asarray(corner, np.float64)
    dx = rot @ np.array([size_x, 0, 0])
    dz = rot @ np.array([0, 0, size_z])
    dy = np.array([0, height, 0])
    p = [base, base + dx, base + dx + dz, base + dz]
    q = [v + dy for v in p]
    _add_quad(a, m, q[0], q[1], q[2], q[3], mat)                  # top
    _add_quad(a, m, p[1], p[0], q[0], q[1], mat)                  # front
    _add_quad(a, m, p[2], p[1], q[1], q[2], mat)                  # right
    _add_quad(a, m, p[3], p[2], q[2], q[3], mat)                  # back
    _add_quad(a, m, p[0], p[3], q[3], q[0], mat)                  # left
    _add_quad(a, m, p[3], p[2], p[1], p[0], mat)                  # bottom


# the area light's corner, point1 and point2 on the ceiling, slightly below
# it, facing down (-y): with the reference convention fnormal = toY x toX
# must point +y
CORNELL_LIGHT = ((343.0, 548.0, 227.0), (343.0, 548.0, 332.0),
                 (213.0, 548.0, 227.0))
CORNELL_MATS = {"white": 0, "red": 1, "green": 2, "light": 3}
CORNELL_CAMERA = {"pos": (278, 273, -800), "look": (278, 273, 0),
                  "up": (278, 274, -800), "focal": 1.4}


def cornell_geometry(a, block_mats=(0, 0), show_light_geo=True):
    """cornell_box's geometry calls on `a`, a MeshAssembler or anything
    with its start_mesh / add_vertex / add_triangle: the room's walls in one
    mesh with the two blocks (block_mats: the short and the tall block's
    material indices, None for no blocks), then the light's quad in a mesh
    of its own wearing material 3."""
    WHITE, RED, GREEN = (CORNELL_MATS[k] for k in ("white", "red", "green"))
    m = a.start_mesh()
    # floor (y=0), normal +y
    _add_quad(a, m, (552.8, 0, 0), (0, 0, 0), (0, 0, 559.2),
              (549.6, 0, 559.2), WHITE)
    # ceiling (y=548.8), normal -y
    _add_quad(a, m, (556, 548.8, 0), (556, 548.8, 559.2),
              (0, 548.8, 559.2), (0, 548.8, 0), WHITE)
    # back wall (z=559.2), normal -z
    _add_quad(a, m, (549.6, 0, 559.2), (0, 0, 559.2),
              (0, 548.8, 559.2), (556, 548.8, 559.2), WHITE)
    # right wall (x=0) GREEN, normal +x
    _add_quad(a, m, (0, 0, 559.2), (0, 0, 0),
              (0, 548.8, 0), (0, 548.8, 559.2), GREEN)
    # left wall (x~552.8..556) RED, normal -x
    _add_quad(a, m, (552.8, 0, 0), (549.6, 0, 559.2),
              (556, 548.8, 559.2), (556, 548.8, 0), RED)
    if block_mats is not None:
        _box(a, m, (130.0, 0.0, 65.0), 160, 160, 165, -18.0, block_mats[0])
        _box(a, m, (265.0, 0.0, 296.0), 160, 160, 330, 17.0, block_mats[1])
    if show_light_geo:
        # geometry for the light so camera rays see it (emissive material)
        lc, lp1, lp2 = (np.array(p) for p in CORNELL_LIGHT)
        lm = a.start_mesh()
        i0 = a.add_vertex(lm, *lc)
        i1 = a.add_vertex(lm, *lp1)
        i2 = a.add_vertex(lm, *(lp1 + (lp2 - lc)))
        i3 = a.add_vertex(lm, *lp2)
        a.add_triangle(lm, i0, i1, i2, CORNELL_MATS["light"])
        a.add_triangle(lm, i0, i2, i3, CORNELL_MATS["light"])


def cornell_box(resx=256, resy=256, light_samples=16, light_power=30.0,
                with_blocks=True, block_materials=("white", "white"),
                show_light_geo=True, intersector="auto", *,
                device="cuda") -> Scene:
    """The Cornell box with an area light (core_tpu's cornell_box).
    block_materials picks 'white', 'mirror', 'glass', 'glossy',
    'blend_diff' or 'blend_cross' for the short and the tall block; the
    rows are core_tpu's, appended in the same order."""
    device = check_device(device)
    WHITE, RED = CORNELL_MATS["white"], CORNELL_MATS["red"]
    mats = [
        MaterialDef(name="white", diffuse_color=(0.75, 0.75, 0.75)),
        MaterialDef(name="red", diffuse_color=(0.63, 0.065, 0.05)),
        MaterialDef(name="green", diffuse_color=(0.14, 0.45, 0.091)),
        MaterialDef(name="light", diffuse_color=(1.0, 1.0, 1.0),
                    diffuse_strength=0.0, emit_strength=light_power),
    ]

    def glossy(name):
        # refgold/driver.cc's glossymat: as_diffuse=False, so the lobe goes
        # through the glossy indirect branch
        return MaterialDef(name=name, mtype=MatType.GLOSSY,
                           diffuse_color=(0.3, 0.3, 0.3),
                           glossy_color=(0.8, 0.8, 0.8), glossy_reflect=0.7,
                           exp_u=120.0, exp_v=120.0, as_diffuse=False)

    def glass(name):
        return MaterialDef(name=name, mtype=MatType.GLASS, ior=1.5,
                           filter_color=(1.0, 1.0, 1.0), transmit_filter=1.0)

    extra = {"white": WHITE}
    for bm in block_materials:
        if bm in extra:
            continue
        if bm == "mirror":
            mats.append(MaterialDef(name="mirror", mirror_strength=1.0,
                                    diffuse_strength=0.0,
                                    mirror_color=(0.9, 0.9, 0.9)))
        elif bm == "glossy":
            mats.append(glossy("glossy"))
        elif bm == "glass":
            mats.append(glass("glass"))
        elif bm == "blend_diff":
            # same-family blend: white (+) red at 0.35 (blend.cc)
            mats.append(MaterialDef(name="blend_diff", mtype=MatType.BLEND,
                                    sub_mat0=WHITE, sub_mat1=RED,
                                    blend_val=0.35))
        elif bm == "blend_cross":
            # cross-family blend: glossy (+) glass at 0.5, one sub-material
            # picked per sample (scene.composite_pick)
            mats += [glossy("bglossy"), glass("bglass"),
                     MaterialDef(name="blend_cross", mtype=MatType.BLEND,
                                 sub_mat0=len(mats), sub_mat1=len(mats) + 1,
                                 blend_val=0.5)]
        else:
            raise ValueError(f"unknown block material {bm!r}")
        extra[bm] = len(mats) - 1

    a = MeshAssembler()
    cornell_geometry(a, (extra[block_materials[0]], extra[block_materials[1]])
                     if with_blocks else None, show_light_geo)
    lc, lp1, lp2 = (np.array(p) for p in CORNELL_LIGHT)
    light = make_area_light(lc, lp1, lp2, color=(1.0, 1.0, 1.0),
                            power=light_power, samples=light_samples,
                            device=device)
    geom = a.build(device)
    cam = make_perspective(resx=resx, resy=resy, device=device,
                           **CORNELL_CAMERA)
    has_spec = any(d.mirror_strength > 0 or d.transparency > 0
                   or d.mtype in (MatType.GLASS, MatType.COATED_GLOSSY)
                   for d in mats)
    has_transp = any(d.transparency > 0 or d.mtype == MatType.GLASS
                     for d in mats)
    return Scene(geom=geom, materials=build_material_table(mats, device),
                 lights=(light,), camera=cam,
                 has_specular=has_spec, has_transparency=has_transp,
                 mat_types=tuple(sorted({int(d.mtype) for d in mats})),
                 intersector=resolve_intersector(intersector, device))


def _terrain_height(x, z):
    """Deterministic multi-octave displacement (numpy, build time)."""
    h = np.zeros_like(x)
    for freq, amp, px, pz in ((0.7, 0.55, 0.0, 1.3), (1.7, 0.22, 2.1, 0.4),
                              (3.9, 0.11, 4.2, 5.0), (8.3, 0.05, 1.1, 2.7)):
        h = h + amp * np.sin(freq * x + px) * np.cos(freq * z + pz)
    return h


def _grid_mesh(a: MeshAssembler, m, n, extent, mat, uv_tiles=4.0):
    """n x n vertex grid on the XZ plane, displaced by _terrain_height."""
    xs = np.linspace(-extent, extent, n)
    zs = np.linspace(-extent, extent, n)
    X, Z = np.meshgrid(xs, zs, indexing="ij")
    Y = _terrain_height(X, Z)
    base_v = a.add_vertices(m, np.stack([X, Y, Z], axis=-1).reshape(-1, 3))
    U, V = np.meshgrid(np.linspace(0, uv_tiles, n),
                       np.linspace(0, uv_tiles, n), indexing="ij")
    base_uv = a.add_uvs(m, np.stack([U, V], -1).reshape(-1, 2))
    i, j = np.meshgrid(np.arange(n - 1), np.arange(n - 1), indexing="ij")
    v00 = (i * n + j).ravel() + base_v
    v01 = v00 + 1
    v10 = v00 + n
    v11 = v10 + 1
    faces = np.concatenate([np.stack([v00, v10, v11], axis=-1),
                            np.stack([v00, v11, v01], axis=-1)], axis=0)
    a.add_triangles(m, faces, mat, uv_ids=faces - base_v + base_uv)


def _torus_mesh(a: MeshAssembler, m, nu, nv, R, r, center, mat):
    """Parametric torus with UVs."""
    us = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vs = np.linspace(0, 2 * np.pi, nv, endpoint=False)
    U, V = np.meshgrid(us, vs, indexing="ij")
    cx, cy, cz = center
    x = (R + r * np.cos(V)) * np.cos(U) + cx
    z = (R + r * np.cos(V)) * np.sin(U) + cz
    y = r * np.sin(V) + cy
    base_v = a.add_vertices(m, np.stack([x, y, z], -1).reshape(-1, 3))
    base_uv = a.add_uvs(m, np.stack(
        [U / (2 * np.pi) * 8.0, V / (2 * np.pi) * 2.0], -1).reshape(-1, 2))
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    i1 = (i + 1) % nu
    j1 = (j + 1) % nv
    v00 = (i * nv + j).ravel() + base_v
    v01 = (i * nv + j1).ravel() + base_v
    v10 = (i1 * nv + j).ravel() + base_v
    v11 = (i1 * nv + j1).ravel() + base_v
    faces = np.concatenate([np.stack([v00, v10, v11], -1),
                            np.stack([v00, v11, v01], -1)], axis=0)
    a.add_triangles(m, faces, mat, uv_ids=faces - base_v + base_uv)


# mesh_scene's elements but its geometry, background and lights, as plain
# data: (name, parameters) of its textures and materials, and its camera
MESH_SCENE = {
    "textures": (
        ("rockmarble", {"type": "marble", "color1": (0.22, 0.18, 0.14),
                        "color2": (0.75, 0.7, 0.62), "size": 2.3,
                        "depth": 3, "turbulence": 4.0, "sharpness": 2.0,
                        "noise_type": "newperlin"}),
        ("cellvor", {"type": "voronoi", "color1": (0.05, 0.12, 0.3),
                     "color2": (0.9, 0.85, 0.6), "size": 1.4,
                     "pattern": "f2f1", "intensity": 1.6}),
        ("skytex", {"type": "clouds", "color1": (0.25, 0.45, 0.9),
                    "color2": (1.0, 0.98, 0.92), "size": 0.8, "depth": 3,
                    "noise_type": "stdperlin"}),
    ),
    "materials": (
        ("terrain", {"type": "shinydiffusemat", "color": (0.7, 0.7, 0.7),
                     "diffuse_reflect": 0.9,
                     "diffuse_shader": "rockmarble"}),
        ("torus", {"type": "glossy", "diffuse_color": (0.4, 0.4, 0.45),
                   "color": (0.7, 0.7, 0.75), "glossy_reflect": 0.35,
                   "exponent": 80.0, "as_diffuse": False,
                   "diffuse_shader": "cellvor"}),
    ),
    "camera": {"pos": (5.2, 3.4, -5.6), "look": (0.0, 1.2, 0.0),
               "up": (5.2, 4.4, -5.6), "focal": 1.25},
}


def big_scene(resx=1024, resy=1024, ibl_samples=8, sun_samples=4, *,
              device="cuda") -> Scene:
    """core_tpu's BASELINE config #5 scale proof: 1,017,202 triangles
    (977k displaced-terrain tris + 40k torus tris) at 1024^2, through the
    grouped cluster kernels."""
    return mesh_scene(resx=resx, resy=resy, n_grid=700, torus_u=250,
                      torus_v=80, ibl_samples=ibl_samples,
                      sun_samples=sun_samples, device=device)


def mesh_builder(resx=256, resy=256, n_grid=160, torus_u=180, torus_v=64, *,
                 device="cuda"):
    """An environment.SceneBuilder holding mesh_scene's textures,
    materials, terrain grid ((n_grid-1)^2 * 2 tris, shiny-diffuse with a
    marble diffuse texture), torus (torus_u * torus_v * 2 tris, glossy with
    a voronoi diffuse texture) and camera: everything but its background
    and lights."""
    from core_tpu_torch.environment import SceneBuilder

    b = SceneBuilder(check_device(device))
    for name, params in MESH_SCENE["textures"]:
        b.create("texture", name, ParamMap(params))
    for name, params in MESH_SCENE["materials"]:
        b.create("material", name, ParamMap(params))

    m = b.assembler.start_mesh()
    _grid_mesh(b.assembler, m, n_grid, 6.0, b.material_index("terrain"))
    b.assembler.smooth_mesh(m, 80.0)
    m2 = b.assembler.start_mesh()
    _torus_mesh(b.assembler, m2, torus_u, torus_v, 1.5, 0.55,
                (0.0, 1.6, 0.0), b.material_index("torus"))
    b.assembler.smooth_mesh(m2, 80.0)

    b.camera = make_perspective(resx=resx, resy=resy, device=b.device,
                                **MESH_SCENE["camera"])
    return b


def mesh_scene(resx=256, resy=256, n_grid=160, torus_u=180, torus_v=64,
               ibl_samples=8, sun_samples=4, *, device="cuda") -> Scene:
    """core_tpu's mesh-scene configuration (BASELINE config #3):
    mesh_builder's elements under a clouds environment with ibl=True and a
    sun.  The intersection path follows core_tpu's rule
    (environment.accel_for): <= 4,096 tris go brute, else the cluster count
    decides; the defaults' 73,602 tris (512 clusters) take the flat cluster
    kernels 4-6."""
    b = mesh_builder(resx, resy, n_grid, torus_u, torus_v, device=device)
    for kind, name, params in mesh_scene_lighting(ibl_samples, sun_samples):
        b.create(kind, name, ParamMap(params))
    return b.compile_scene()


def mesh_scene_lighting(ibl_samples=8, sun_samples=4):
    """mesh_scene's clouds background with IBL and its sun, as (kind, name,
    parameters) elements."""
    return (("background", "world", {
        "type": "textureback", "texture": "skytex", "ibl": True,
        "ibl_samples": ibl_samples, "power": 1.0}),
        ("light", "sun", {
            "type": "sunlight", "direction": (0.45, 0.8, 0.3),
            "color": (1.0, 0.95, 0.85), "power": 1.6, "angle": 0.5,
            "samples": sun_samples}))


# the dirac variant's lights: (name, parameters), one of each dirac type
DIRAC_LIGHTS = (
    ("point", {"type": "pointlight", "from": (2.0, 3.5, -2.0),
               "power": 12.0}),
    ("spot", {"type": "spotlight", "from": (-2.5, 4.0, -1.5),
              "to": (0.0, 1.2, 0.0), "cone_angle": 35.0, "blend": 0.15,
              "power": 20.0}),
    ("dir", {"type": "directional", "direction": (0.45, 0.8, 0.3),
             "infinite": True, "power": 1.2}),
)


def add_dirac_lights(b):
    """Light a mesh_builder's scene as the dirac variant of mesh_scene: the
    clouds background without IBL (camera rays see it; no background light
    is made) and, for the sun, DIRAC_LIGHTS.  Every light of it goes
    through the one-ray any-hit kernels (3 brute, 5 flat)."""
    b.create("background", "world", ParamMap({
        "type": "textureback", "texture": "skytex", "ibl": False,
        "power": 1.0}))
    for name, params in DIRAC_LIGHTS:
        b.create("light", name, ParamMap(params))
    return b


# The "mesh zoo": mesh_scene's geometry, camera and lights with its two
# materials and their textures replaced by the procedural textures, the
# mix and layer nodes, bump mapping and anisotropic coated glossy.  Plain
# data, so that one definition feeds either package's SceneBuilder (core_tpu
# has no scene function for these families): `textures` and `materials`
# go through SceneBuilder.create (a material with its shader nodes as the
# `extra` list), `texture_defs` through SceneBuilder.add_texture as
# TextureDef fields (ttype by name), since core_tpu's voronoi factory reads
# neither the colour mode nor the metric.
MESH_ZOO = {
    "textures": (
        ("woodrings", {"type": "wood", "wood_type": "rings", "shape": "saw",
                       "turbulence": 2.0, "depth": 2, "size": 4.0,
                       "noise_type": "blender"}),
        ("ridged", {"type": "musgrave", "musgrave_type": "ridgedmf",
                    "H": 1.0, "lacunarity": 2.0, "octaves": 4.0,
                    "offset": 1.0, "gain": 2.0, "size": 1.5}),
        ("hetero", {"type": "musgrave", "musgrave_type": "heteroterrain",
                    "octaves": 3.5, "offset": 0.8, "noise_type": "cellnoise",
                    "size": 2.0}),
        ("warp", {"type": "distorted_noise", "distort": 2.0,
                  "noise_type": "voronoi_crackle", "noise_type2": "stdperlin",
                  "size": 1.2}),
        ("cube", {"type": "rgb_cube"}),
        ("ease", {"type": "blend", "stype": "ease"}),
        ("skytex", {"type": "clouds", "color1": (0.25, 0.45, 0.9),
                    "color2": (1.0, 0.98, 0.92), "size": 0.8, "depth": 3,
                    "noise_type": "stdperlin"}),
    ),
    "texture_defs": (
        ("vorcol", {"ttype": "VORONOI", "vor_color_mode": 2,
                    "vor_metric": 6, "vor_mk_exp": 1.5,
                    "vor_weights": (1.0, 0.5, 0.25, 0.0), "size": 3.0}),
    ),
    "materials": (
        ("terrain", {"type": "shinydiffusemat", "diffuse_reflect": 0.9,
                     "diffuse_shader": "terrain_layer",
                     "bump_shader": "terrain_bump"}, (
            {"name": "ridged_map", "type": "texture_mapper",
             "texture": "ridged", "texco": "uv", "scale": (2.0, 2.0, 2.0)},
            {"name": "wood_map", "type": "texture_mapper",
             "texture": "woodrings", "texco": "global"},
            {"name": "terrain_layer", "type": "layer", "mode": 2,
             "colfac": 0.7, "do_color": True, "input": "ridged_map",
             "upper_layer": "wood_map"},
            {"name": "terrain_bump", "type": "texture_mapper",
             "texture": "hetero", "texco": "global", "bump_strength": 5.0})),
        ("torus", {"type": "coated_glossy", "anisotropic": True,
                   "exp_u": 200.0, "exp_v": 20.0, "IOR": 1.5,
                   "glossy_reflect": 0.6, "mirror_color": (1.0, 1.0, 1.0),
                   "diffuse_shader": "torus_mix",
                   "glossy_shader": "cube_map"}, (
            {"name": "warp_map", "type": "texture_mapper",
             "texture": "warp"},
            {"name": "vorcol_map", "type": "texture_mapper",
             "texture": "vorcol"},
            {"name": "ease_map", "type": "texture_mapper",
             "texture": "ease"},
            {"name": "torus_mix", "type": "mix", "mode": 4,
             "input1": "warp_map", "input2": "vorcol_map",
             "factor": "ease_map"},
            {"name": "cube_map", "type": "texture_mapper",
             "texture": "cube"})),
    ),
    # mesh_scene's defaults: an n x n-vertex terrain and an nu x nv-quad
    # torus, each smoothed at `smooth` degrees: 73,602 triangles in 512
    # clusters (the flat cluster kernels 4 and 6)
    "grid": {"n": 160, "extent": 6.0},
    "torus": {"nu": 180, "nv": 64, "R": 1.5, "r": 0.55,
              "center": (0.0, 1.6, 0.0)},
    "smooth": 80.0,
    "camera": {"pos": (5.2, 3.4, -5.6), "look": (0.0, 1.2, 0.0),
               "up": (5.2, 4.4, -5.6), "focal": 1.25},
    "background": ("world", {"type": "textureback", "texture": "skytex",
                             "ibl": True, "ibl_samples": 8, "power": 1.0}),
    "lights": (("sun", {"type": "sunlight", "direction": (0.45, 0.8, 0.3),
                        "color": (1.0, 0.95, 0.85), "power": 1.6,
                        "angle": 0.5, "samples": 4}),),
}


# An LM-63 profile: a downlight whose candela falls from the axis to 90
# degrees, over two horizontal angles (the parser averages them).
LIGHT_ZOO_IES = """IESNA:LM-63-1995
[TEST] light zoo downlight
TILT=NONE
1 1000.0 1.0 7 2 1 2 0.0 0.0 0.0
1.0 1.0 60.0
0.0 15.0 30.0 45.0 60.0 75.0 90.0
0.0 90.0
1000.0 960.0 820.0 600.0 330.0 120.0 10.0
1000.0 940.0 780.0 560.0 300.0 100.0 0.0
"""

# The "light zoo": mesh_scene's terrain and torus (plain materials) and
# camera placement, plus a 4 x 4-quad emitter panel (32 triangles wearing
# light_mat, facing down, a meshlight over its object) and a 2-triangle
# portal quad above the scene and out of the camera's view (a
# bgPortalLight over it); lit by a sphere light, the mesh light, an IES
# spot and the portal under a darksky with add_sun and background_light;
# seen through a thin lens with a hexagonal bokeh focused on the torus.
# 73,636 triangles at these sizes: the flat cluster kernels 4, 5 (the IES
# light's shadow rays) and 6 (the other lights' bundles).  The darksky's
# zenith is +z (core_tpu's sky convention) while this scene's up is +y;
# the sun is placed high in both.  Plain data, so one definition feeds
# either package's SceneBuilder (chip_smoke.light_zoo_builder); the IES
# profile is carried as text (LIGHT_ZOO_IES) and written to a file for the
# factory; `film` holds the RenderOptions filter.
LIGHT_ZOO = {
    "materials": (
        ("terrain", {"type": "shinydiffusemat", "color": (0.7, 0.7, 0.7),
                     "diffuse_reflect": 0.9}),
        ("torus", {"type": "glossy", "diffuse_color": (0.4, 0.4, 0.45),
                   "color": (0.7, 0.7, 0.75), "glossy_reflect": 0.35,
                   "exponent": 80.0, "as_diffuse": False}),
        ("emitter", {"type": "light_mat", "color": (1.0, 0.85, 0.6),
                     "power": 3.0}),
        ("portal", {"type": "null"}),
    ),
    "grid": {"n": 160, "extent": 6.0},
    "torus": {"nu": 180, "nv": 64, "R": 1.5, "r": 0.55,
              "center": (0.0, 1.6, 0.0)},
    "smooth": 80.0,
    # the panel: a (quads x quads) grid on y = height over [x0, x1] x
    # [z0, z1], wound so its normals point down (-y)
    "panel": {"quads": 4, "x": (-3.4, -2.2), "z": (-0.4, 0.8),
              "height": 3.1},
    # the portal: one quad on y = height over [x0, x1] x [z0, z1]
    "portal": {"x": (-1.0, 1.0), "z": (-1.0, 1.0), "height": 7.0},
    "camera": ("cam", {"type": "perspective", "from": (5.2, 3.4, -5.6),
                       "to": (0.0, 1.2, 0.0), "up": (5.2, 4.4, -5.6),
                       "focal": 1.25, "aperture": 0.06,
                       "dof_distance": 7.9, "bokeh_type": "hexagon",
                       "bokeh_rotation": 15.0}),
    "background": ("sky", {"type": "darksky", "from": (0.3, 0.8, 0.5),
                           "turbidity": 3.0, "add_sun": True,
                           "sun_power": 0.6, "background_light": True,
                           "light_samples": 8, "power": 0.4}),
    # (name, parameters); "object" names a mesh of this dict ("panel",
    # "portal"), "file" is set to the written LIGHT_ZOO_IES
    "lights": (
        ("sphere", {"type": "spherelight", "from": (-2.2, 2.4, -1.8),
                    "radius": 0.3, "color": (0.6, 0.8, 1.0), "power": 6.0,
                    "samples": 4}),
        ("panel", {"type": "meshlight", "object": "panel",
                   "color": (1.0, 0.85, 0.6), "power": 3.0,
                   "samples": 4}),
        ("ies", {"type": "ieslight", "from": (1.8, 4.2, -2.4),
                 "to": (0.0, 1.2, 0.0), "color": (1.0, 0.95, 0.9),
                 "power": 14.0}),
        ("portal", {"type": "bgPortalLight", "object": "portal",
                    "power": 1.0, "samples": 4}),
    ),
    "film": {"filter_type": "GAUSS", "filter_size": 1.5},
}


ASSET_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "refgold", "assets")


def golden_mesh_scene(resx=128, resy=128, ibl_samples=8, asset_dir=None, *,
                      device="cuda") -> Scene:
    """core_tpu's golden_mesh_scene, the scene of refgold/driver_ms.cc (the
    mesh + IBL goldens): a torus (48 x 24 quads, R = 1.2, r = 0.5, centre
    (0, 1.5, 0), uvs tiled 3x along u, smoothed at 80 degrees) and a 24 x 24
    ground quad (uvs 0..6), 2,306 triangles (the brute kernels 1 and 2),
    each with checker.tga as its diffuse colour through a
    texture_mapper(texco=uv) node, lit only by a sky.tga textureback with
    ibl=True.  Vertices, uvs and faces are added in core_tpu's order, in
    bulk.  asset_dir defaults to refgold/assets beside the package; a
    missing asset raises."""
    from core_tpu_torch.environment import SceneBuilder
    if asset_dir is None:
        asset_dir = ASSET_DIR
    b = SceneBuilder(check_device(device))
    for name, fname in (("checktex", "checker.tga"), ("skytex", "sky.tga")):
        b.create("texture", name, ParamMap({
            "type": "image", "filename": os.path.join(asset_dir, fname),
            "gamma": 1.0, "interpolate": "bilinear"}))

    def mapper(nm):
        return [ParamMap({"element": "shader_node", "name": nm,
                          "type": "texture_mapper", "texture": "checktex",
                          "texco": "uv"})]

    b.create("material", "ball", ParamMap({
        "type": "shinydiffusemat", "color": (1.0, 1.0, 1.0),
        "diffuse_reflect": 0.9, "diffuse_shader": "map_ball"}),
        extra=mapper("map_ball"))
    b.create("material", "ground", ParamMap({
        "type": "shinydiffusemat", "color": (1.0, 1.0, 1.0),
        "diffuse_reflect": 0.8, "diffuse_shader": "map_gnd"}),
        extra=mapper("map_gnd"))

    a = b.assembler
    U, V = 48, 24
    R, r, cy = 1.2, 0.5, 1.5
    m = a.start_mesh()
    # vertex and uv (i, j) is number i * (V + 1) + j, as core_tpu's loop
    # over i then j adds them
    i, j = np.meshgrid(np.arange(U + 1), np.arange(V + 1), indexing="ij")
    u = 2.0 * np.pi * i / U
    v = 2.0 * np.pi * j / V
    a.add_vertices(m, np.stack([(R + r * np.cos(v)) * np.cos(u),
                                cy + r * np.sin(v),
                                (R + r * np.cos(v)) * np.sin(u)], -1))
    a.add_uvs(m, np.stack([3.0 * i / U, j / V], -1))
    i, j = np.meshgrid(np.arange(U), np.arange(V), indexing="ij")
    p_, q_ = i * (V + 1) + j, (i + 1) * (V + 1) + j
    s_, t_ = q_ + 1, p_ + 1
    # per quad two triangles (p, q, s) and (p, s, t); uv ids equal vertex ids
    faces = np.stack([np.stack([p_, q_, s_], -1), np.stack([p_, s_, t_], -1)],
                     axis=2).reshape(-1, 3)
    a.add_triangles(m, faces, b.material_index("ball"), uv_ids=faces)
    a.smooth_mesh(m, 80.0)

    m2 = a.start_mesh()
    E, T = 12.0, 6.0
    a.add_vertices(m2, [(-E, 0.0, -E), (E, 0.0, -E), (E, 0.0, E),
                        (-E, 0.0, E)])
    a.add_uvs(m2, [(0.0, 0.0), (T, 0.0), (T, T), (0.0, T)])
    quad = [(0, 1, 2), (0, 2, 3)]
    a.add_triangles(m2, quad, b.material_index("ground"), uv_ids=quad)

    b.create("background", "world", ParamMap({
        "type": "textureback", "texture": "skytex", "ibl": True,
        "ibl_samples": ibl_samples, "power": 1.0}))
    b.camera = make_perspective(pos=(6.0, 3.2, -7.5), look=(0.0, 1.8, 0.0),
                                up=(6.0, 4.2, -7.5), resx=resx, resy=resy,
                                focal=1.1, device=b.device)
    return b.compile_scene()


def golden_volume_scene(resx=128, resy=128, *, device="cuda") -> Scene:
    """core_tpu's golden_volume_scene, the scene of refgold/driver_vol.cc
    (the volume golden): a grey 20 x 20 ground (2 triangles: the brute
    kernels), a UniformVolume box [-2, 2] x [0, 4] x [-2, 2] (sigma_s 0.05,
    sigma_a 0.01) and one 30-degree spotlight at (0, 6, 0) aimed straight
    down.  Render with VolumeOptions(integrator="singlescatter")."""
    from core_tpu_torch.environment import SceneBuilder
    b = SceneBuilder(check_device(device))
    b.create("material", "gray", ParamMap({
        "type": "shinydiffusemat", "color": (0.6, 0.6, 0.6)}))
    a = b.assembler
    m = a.start_mesh()
    a.add_vertices(m, [(-10.0, 0.0, -10.0), (10.0, 0.0, -10.0),
                       (10.0, 0.0, 10.0), (-10.0, 0.0, 10.0)])
    a.add_triangles(m, [(0, 1, 2), (0, 2, 3)], b.material_index("gray"))
    b.create("volumeregion", "fog", ParamMap({
        "type": "UniformVolume", "sigma_s": 0.05, "sigma_a": 0.01,
        "l_e": 0.0, "g": 0.0, "minX": -2.0, "minY": 0.0, "minZ": -2.0,
        "maxX": 2.0, "maxY": 4.0, "maxZ": 2.0}))
    b.create("light", "spot", ParamMap({
        "type": "spotlight", "from": (0.0, 6.0, 0.0), "to": (0.0, 0.0, 0.0),
        "color": (1.0, 1.0, 1.0), "power": 200.0, "cone_angle": 30.0,
        "blend": 0.15}))
    b.camera = make_perspective(pos=(5.0, 2.5, -6.0), look=(0.0, 1.5, 0.0),
                                up=(5.0, 3.5, -6.0), resx=resx, resy=resy,
                                focal=1.2, device=b.device)
    return b.compile_scene()
