"""Built-in example scenes (counterpart of core_tpu/scenes.py).

cornell_box: the classic Cornell box with an area light and shiny-diffuse
walls and blocks, built host-side in numpy exactly as core_tpu builds it,
so the two packages' scenes agree leaf by leaf.
"""
from __future__ import annotations

import numpy as np

from core_tpu_torch.cameras import make_perspective
from core_tpu_torch.geometry.mesh import MeshAssembler
from core_tpu_torch.lights.area import make_area_light
from core_tpu_torch.materials.base import (MaterialDef, MatType,
                                           build_material_table)
from core_tpu_torch.scene import Scene, resolve_intersector


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


def cornell_box(resx=256, resy=256, light_samples=16, light_power=30.0,
                with_blocks=True, show_light_geo=True, intersector="auto", *,
                device="cpu") -> Scene:
    """The Cornell box with its default white blocks (core_tpu's
    cornell_box with block_materials=("white", "white")).  The mirror,
    glass, glossy and blend blocks come with their material families."""
    WHITE, RED, GREEN, LIGHTMAT = 0, 1, 2, 3
    mats = [
        MaterialDef(name="white", diffuse_color=(0.75, 0.75, 0.75)),
        MaterialDef(name="red", diffuse_color=(0.63, 0.065, 0.05)),
        MaterialDef(name="green", diffuse_color=(0.14, 0.45, 0.091)),
        MaterialDef(name="light", diffuse_color=(1.0, 1.0, 1.0),
                    diffuse_strength=0.0, emit_strength=light_power),
    ]

    a = MeshAssembler()
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

    if with_blocks:
        _box(a, m, (130.0, 0.0, 65.0), 160, 160, 165, -18.0, WHITE)
        _box(a, m, (265.0, 0.0, 296.0), 160, 160, 330, 17.0, WHITE)

    # area light quad on the ceiling, slightly below it, facing down (-y):
    # with the reference convention fnormal = toY x toX must point +y.
    lc = np.array([343.0, 548.0, 227.0])
    lp1 = np.array([343.0, 548.0, 332.0])
    lp2 = np.array([213.0, 548.0, 227.0])
    light = make_area_light(lc, lp1, lp2, color=(1.0, 1.0, 1.0),
                            power=light_power, samples=light_samples,
                            device=device)
    if show_light_geo:
        lm = a.start_mesh()
        # geometry for the light so camera rays see it (emissive material)
        i0 = a.add_vertex(lm, *lc)
        i1 = a.add_vertex(lm, *lp1)
        i2 = a.add_vertex(lm, *(lp1 + (lp2 - lc)))
        i3 = a.add_vertex(lm, *lp2)
        a.add_triangle(lm, i0, i1, i2, LIGHTMAT)
        a.add_triangle(lm, i0, i2, i3, LIGHTMAT)

    geom = a.build(device)
    cam = make_perspective(pos=(278, 273, -800), look=(278, 273, 0),
                           up=(278, 274, -800), resx=resx, resy=resy,
                           focal=1.4, device=device)
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
