"""XML scene loader (counterpart of core_tpu/io/xml_loader.py): the
reference's SAX parser and pushdown state machine
(src/yafraycore/xmlparser.cc:43-713).

A <scene> holds material, light, texture, camera, background, integrator,
volumeregion and object elements (each a parameter map of typed children
with fval / ival / bval / sval or x,y,z / r,g,b,a attributes, parseParam
xmlparser.cc:161-195; a material's shader nodes as <list_element> maps),
<mesh> with <p> / <uv> / <f> (uv_a..uv_c) / <set_material> / <n>,
<smooth>, <curve>, <instance> with its <transform>, and the <render>
parameter block.  Each element goes to SceneBuilder's factory or geometry
call of the same name.

parse_xml_scene(path, device) returns (Scene, RenderOptions) on the device;
it records the seconds of the parse and of compile_scene as the "parse"
and "compile" events of utils.timer.timer.
"""
from __future__ import annotations

import xml.sax
from typing import Optional

import numpy as np

from core_tpu_torch.environment import SceneBuilder
from core_tpu_torch.params import ParamMap
from core_tpu_torch.scene import check_device
from core_tpu_torch.utils.timer import timer


def _parse_param(attrs) -> object:
    """parseParam (xmlparser.cc:161-195): typed single attr or point/color."""
    keys = attrs.getNames()
    if len(keys) == 1:
        k = keys[0]
        v = attrs.getValue(k)
        if k == "ival":
            return int(v)
        if k == "fval":
            return float(v)
        if k == "bval":
            return v.lower() in ("true", "yes", "on", "1")
        if k == "sval":
            return v
    point = {}
    color = {}
    for k in keys:
        if k in ("x", "y", "z"):
            point[k] = float(attrs.getValue(k))
        elif k in ("r", "g", "b", "a"):
            color[k] = float(attrs.getValue(k))
    if point:
        return (point.get("x", 0.0), point.get("y", 0.0), point.get("z", 0.0))
    if color:
        c = (color.get("r", 0.0), color.get("g", 0.0), color.get("b", 0.0))
        return c + ((color["a"],) if "a" in color else ())
    return None


class _Handler(xml.sax.ContentHandler):
    """Pushdown state machine mirroring xmlparser.cc's pushState chain."""

    def __init__(self, builder: SceneBuilder):
        super().__init__()
        self.b = builder
        self.stack = ["document"]
        self.cur_kind: Optional[str] = None
        self.cur_name: Optional[str] = None
        self.cur_params: Optional[ParamMap] = None
        self.cur_list: list = []

    # -- dispatch --

    def startElement(self, tag, attrs):
        getattr(self, "start_" + self.stack[-1])(tag, attrs)

    def endElement(self, tag):
        fn = getattr(self, "end_" + self.stack[-1], None)
        if fn:
            fn(tag)

    # -- states --

    def start_document(self, tag, attrs):
        if tag == "scene":
            self.stack.append("scene")

    def start_scene(self, tag, attrs):
        b = self.b
        if tag in ("material", "integrator", "light", "texture", "camera",
                   "background", "object", "volumeregion"):
            self.cur_kind = tag
            self.cur_name = attrs.get("name", "")
            self.cur_params = ParamMap()
            self.cur_list = []
            self.stack.append("parammap")
        elif tag == "mesh":
            has_uv = attrs.get("has_uv", "false").lower() in ("true", "1")
            obj_id = int(attrs.get("id", -1))
            m = b.start_mesh(has_uv=has_uv)
            if obj_id >= 0:
                m.obj_id = obj_id
                b.assembler._next_obj = max(b.assembler._next_obj, obj_id + 1)
            self.stack.append("mesh")
        elif tag == "curve":
            b.start_curve_mesh()
            self._curve = {"mat": "", "start": 0.0, "end": 0.0, "shape": 0.0}
            self.stack.append("curve")
        elif tag == "smooth":
            b.smooth_mesh(int(attrs.get("ID", 0)),
                          float(attrs.get("angle", 181.0)))
        elif tag == "render":
            self.cur_params = b.render_params
            self.stack.append("render")
        elif tag == "instance":
            self._instance_base = int(attrs.get("base_object_id", 0))
            self._instance_rows = []
            self.stack.append("instance")

    def start_parammap(self, tag, attrs):
        if tag == "list_element":
            self.cur_list.append(ParamMap())
            self.stack.append("paramlist")
            return
        v = _parse_param(attrs)
        if v is not None:
            self.cur_params[tag] = v

    def end_parammap(self, tag):
        if tag == self.cur_kind:
            self.stack.pop()
            self.b.create(self.cur_kind, self.cur_name, self.cur_params,
                          self.cur_list)
            self.cur_kind = None

    def start_paramlist(self, tag, attrs):
        v = _parse_param(attrs)
        if v is not None:
            self.cur_list[-1][tag] = v

    def end_paramlist(self, tag):
        if tag == "list_element":
            self.stack.pop()

    def start_render(self, tag, attrs):
        v = _parse_param(attrs)
        if v is not None:
            self.b.render_params[tag] = v

    def end_render(self, tag):
        if tag == "render":
            self.stack.pop()

    def start_mesh(self, tag, attrs):
        b = self.b
        if tag == "p":
            b.add_vertex(float(attrs.get("x", 0)), float(attrs.get("y", 0)),
                         float(attrs.get("z", 0)))
        elif tag == "uv":
            b.add_uv(float(attrs.get("u", 0)), float(attrs.get("v", 0)))
        elif tag == "f":
            a = int(attrs.get("a", 0))
            bb = int(attrs.get("b", 0))
            c = int(attrs.get("c", 0))
            if "uv_a" in attrs:
                uv = (int(attrs.get("uv_a", 0)), int(attrs.get("uv_b", 0)),
                      int(attrs.get("uv_c", 0)))
                b.add_triangle(a, bb, c, uv=uv)
            else:
                b.add_triangle(a, bb, c)
        elif tag == "set_material":
            b.set_material(attrs.get("sval", ""))
        # <n>, explicit normals: accepted; smoothing recomputes them

    def end_mesh(self, tag):
        if tag == "mesh":
            self.b.end_mesh()
            self.stack.pop()

    def start_curve(self, tag, attrs):
        """Curve element children (reference xmlparser.cc:438-468)."""
        if tag == "p":
            self.b.add_curve_vertex(float(attrs.get("x", 0)),
                                    float(attrs.get("y", 0)),
                                    float(attrs.get("z", 0)))
        elif tag in ("strand_start", "strand_end", "strand_shape"):
            self._curve[tag[len("strand_"):]] = float(
                attrs.get("fval", attrs.get("sval", 0)))
        elif tag == "set_material":
            self._curve["mat"] = attrs.get("sval", "")

    def end_curve(self, tag):
        if tag == "curve":
            c = self._curve
            self.b.end_curve_mesh(c["mat"], c["start"], c["end"], c["shape"])
            self.stack.pop()

    def start_instance(self, tag, attrs):
        if tag == "transform":
            m = np.eye(4)
            for i in range(4):
                for j in range(4):
                    key = f"m{i}{j}"
                    if key in attrs:
                        m[i, j] = float(attrs.get(key))
            self._instance_rows = m

    def end_instance(self, tag):
        if tag == "instance":
            self.b.add_instance(self._instance_base,
                                np.asarray(self._instance_rows))
            self.stack.pop()


def parse_xml_scene(path: str, device="cuda"):
    """Parse a reference-format XML scene file -> (Scene, RenderOptions)
    on `device`."""
    builder = SceneBuilder(check_device(device))
    with timer("parse"):
        xml.sax.parse(path, _Handler(builder))
    with timer("compile"):
        scene = builder.compile_scene()
        opts = builder.render_options()
    return scene, opts
