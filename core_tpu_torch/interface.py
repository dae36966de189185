"""Embedding API (counterpart of core_tpu/interface.py): the reference's
yafrayInterface_t
(include/interface/yafrayinterface.h:45-146): paramsSet* builders, create*
factories, geometry push calls, and render().  This is the entry point for
DCC exporters (the reference's Blender addon drives exactly this surface,
src/bindings/yafrayinterface.i).

    yi = Interface()                     # the card; Interface("cpu") for CPU
    yi.params_set_string("type", "shinydiffusemat")
    yi.params_set_color("color", 0.8, 0.2, 0.2)
    yi.create_material("red")
    yi.start_tri_mesh(); yi.add_vertex(...); yi.add_triangle(a, b, c)
    yi.create_camera(...); yi.create_light(...)
    img = yi.render()
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.params import ParamMap
from core_tpu_torch.scene import check_device


class Interface:
    def __init__(self, device="cuda"):
        self.device = check_device(device)
        self.clear_all()

    # ---- lifecycle (startScene / clearAll) ----

    def clear_all(self):
        self.builder = SceneBuilder(self.device)
        self._params = ParamMap()
        self._eparams = []          # shader-node list (paramsStartList)
        self._list_mode = False
        self._scene = None
        self._opts = None
        self._in_curve = False

    start_scene = clear_all

    # ---- paramsSet* (yafrayinterface.h paramsSetPoint/String/...) ----

    def params_clear(self):
        self._params = ParamMap()
        self._eparams = []
        self._list_mode = False

    def _cur(self) -> ParamMap:
        if self._list_mode:
            if not self._eparams:
                self._eparams.append(ParamMap())
            return self._eparams[-1]
        return self._params

    def params_start_list(self):
        """paramsStartList: subsequent paramsSet* write to the extended
        list (shader-node descriptions for node materials)."""
        self._list_mode = True
        self._eparams = []

    def params_push_list(self):
        """paramsPushList: begin a new list element (one shader node)."""
        self._list_mode = True
        self._eparams.append(ParamMap())

    def params_end_list(self):
        """paramsEndList: revert to the normal param map."""
        self._list_mode = False

    def params_set_point(self, name, x, y, z):
        self._cur()[name] = (float(x), float(y), float(z))

    def params_set_string(self, name, s):
        self._cur()[name] = str(s)

    def params_set_bool(self, name, b):
        self._cur()[name] = bool(b)

    def params_set_int(self, name, i):
        self._cur()[name] = int(i)

    def params_set_float(self, name, f):
        self._cur()[name] = float(f)

    def params_set_color(self, name, r, g, b, a=1.0):
        self._cur()[name] = (float(r), float(g), float(b), float(a))

    def _take_params(self) -> ParamMap:
        p = self._params
        self._params = ParamMap()
        self._list_mode = False
        return p

    def _take_eparams(self) -> list:
        e = self._eparams
        self._eparams = []
        return e

    # ---- create* factories ----

    def create_material(self, name):
        eparams = self._take_eparams()
        return self.builder.create("material", name, self._take_params(),
                                   eparams)

    def create_object(self, name):
        return self.builder.create("object", name, self._take_params())

    def create_light(self, name):
        return self.builder.create("light", name, self._take_params())

    def create_texture(self, name):
        return self.builder.create("texture", name, self._take_params())

    def create_camera(self, name):
        return self.builder.create("camera", name, self._take_params())

    def create_background(self, name):
        return self.builder.create("background", name, self._take_params())

    def create_integrator(self, name):
        return self.builder.create("integrator", name, self._take_params())

    def create_volume_region(self, name):
        return self.builder.create("volumeregion", name, self._take_params())

    # ---- geometry (startTriMesh/addVertex/addTriangle/smoothMesh) ----

    def start_geometry(self):
        return True

    def end_geometry(self):
        return True

    def start_tri_mesh(self, obj_id=None, has_uv=False):
        m = self.builder.start_mesh(has_uv=has_uv)
        return m.obj_id

    def end_tri_mesh(self):
        self.builder.end_mesh()
        return True

    def start_curve_mesh(self, obj_id=None):
        """Strand/hair curve mesh (yafrayinterface.h startCurveMesh)."""
        self._in_curve = True
        m = self.builder.start_curve_mesh(obj_id)
        return m.obj_id

    def end_curve_mesh(self, mat_name, strand_start=0.01, strand_end=0.01,
                       strand_shape=0.0):
        """yafrayinterface.h endCurveMesh(mat, start, end, shape)."""
        self._in_curve = False
        return self.builder.end_curve_mesh(mat_name, strand_start,
                                           strand_end, strand_shape)

    def add_vertex(self, x, y, z):
        if self._in_curve:
            return self.builder.add_curve_vertex(x, y, z)
        return self.builder.add_vertex(x, y, z)

    def add_uv(self, u, v):
        return self.builder.add_uv(u, v)

    def set_current_material(self, name):
        self.builder.set_material(name)

    def add_triangle(self, a, b, c, uv=None):
        self.builder.add_triangle(a, b, c, uv=uv)
        return True

    def smooth_mesh(self, obj_id, angle):
        return self.builder.smooth_mesh(obj_id, angle)

    def add_instance(self, base_obj_id, matrix):
        return self.builder.add_instance(base_obj_id, np.asarray(matrix))

    # ---- render params + render ----

    def setup_render(self, **render_params):
        self.builder.render_params.update(render_params)

    def compile(self):
        if self._scene is None:
            self._scene = self.builder.compile_scene()
            self._opts = self.builder.render_options()
        return self._scene, self._opts

    def render(self, output_path: Optional[str] = None, output=None,
               progress=None):
        """Render and return the image [H,W,4]; optionally write it.

        output: a gui.MemoryOutput / gui.CallbackOutput / gui.LiveView (or
        any on_flush callable) — the colorOutput_t parameter of the
        reference's yafrayInterface_t::render(output, pb)
        (src/interface/yafrayinterface.cc:336-342).
        progress: a utils.monitor.ProgressBar.  Returns a numpy array."""
        scene, opts = self.compile()
        from core_tpu_torch.render import render_image
        img, _ = render_image(scene, opts, progress=progress,
                              on_flush=output)
        img = img.cpu().numpy()
        if output is not None and hasattr(output, "finish"):
            output.finish()
        if output_path:
            from core_tpu_torch.io.image import write_image
            write_image(output_path, img)
        return img
