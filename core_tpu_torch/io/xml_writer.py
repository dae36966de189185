"""XML-writing interface, the exporter path (counterpart of
core_tpu/io/xml_writer.py; for the same calls it writes the same text).

Reference: src/interface/xmlinterface.cc — an yafrayInterface_t subclass
that, instead of building the scene in memory, serializes every call to the
scene-XML schema the CLI/loader consumes (xmlparser.cc).  DCC exporters use
it to dump portable scene files.

XmlInterface mirrors interface.Interface's method surface; the file it
writes parses back through io.xml_loader.parse_xml_scene.  Floats are
written with 8 significant digits (_fmt's .8g), as core_tpu writes them,
so a float32 value does not always come back to the same bits (that takes
9).
"""
from __future__ import annotations

from xml.sax.saxutils import escape, quoteattr

import numpy as np

from core_tpu_torch.params import ParamMap


def _fmt(v) -> str:
    if isinstance(v, bool):
        return f'bval="{str(v).lower()}"'
    if isinstance(v, int):
        return f'ival="{v}"'
    if isinstance(v, float):
        return f'fval="{v:.8g}"'
    if isinstance(v, str):
        return f'sval={quoteattr(v)}'
    if isinstance(v, (tuple, list)):
        if len(v) == 3:
            return (f'x="{v[0]:.8g}" y="{v[1]:.8g}" z="{v[2]:.8g}"')
        if len(v) == 4:
            return (f'r="{v[0]:.8g}" g="{v[1]:.8g}" b="{v[2]:.8g}" '
                    f'a="{v[3]:.8g}"')
    raise TypeError(f"unsupported param type {type(v)}")


class XmlInterface:
    """Collects interface calls and writes scene XML (xmlInterface_t)."""

    def __init__(self):
        self.clear_all()

    def clear_all(self):
        self._params = ParamMap()
        self._body: list[str] = []
        self._mesh_open = False
        self._next_obj = 0

    start_scene = clear_all

    # ---- paramsSet* ----
    def params_clear(self):
        self._params = ParamMap()

    def params_set_point(self, name, x, y, z):
        self._params[name] = (float(x), float(y), float(z))

    def params_set_string(self, name, s):
        self._params[name] = str(s)

    def params_set_bool(self, name, b):
        self._params[name] = bool(b)

    def params_set_int(self, name, i):
        self._params[name] = int(i)

    def params_set_float(self, name, f):
        self._params[name] = float(f)

    def params_set_color(self, name, r, g, b, a=1.0):
        self._params[name] = (float(r), float(g), float(b), float(a))

    # ---- element factories -> XML blocks ----
    def _element(self, kind, name):
        self._body.append(f'<{kind} name={quoteattr(str(name))}>')
        for k, v in self._params.items():
            self._body.append(f'\t<{escape(k)} {_fmt(v)}/>')
        self._body.append(f'</{kind}>')
        self._params = ParamMap()
        return name

    def create_material(self, name):
        return self._element("material", name)

    def create_light(self, name):
        return self._element("light", name)

    def create_texture(self, name):
        return self._element("texture", name)

    def create_camera(self, name):
        return self._element("camera", name)

    def create_background(self, name):
        return self._element("background", name)

    def create_integrator(self, name):
        return self._element("integrator", name)

    def create_volume_region(self, name):
        return self._element("volumeregion", name)

    # ---- geometry ----
    def start_tri_mesh(self, obj_id=None, has_uv=False):
        if obj_id is None:
            obj_id = self._next_obj
        self._next_obj = max(self._next_obj, obj_id) + 1
        self._body.append(
            f'<mesh id="{obj_id}" has_uv="{str(bool(has_uv)).lower()}">')
        self._mesh_open = True
        return obj_id

    def add_vertex(self, x, y, z):
        self._body.append(f'\t<p x="{x:.8g}" y="{y:.8g}" z="{z:.8g}"/>')

    def add_normal(self, x, y, z):
        self._body.append(f'\t<n x="{x:.8g}" y="{y:.8g}" z="{z:.8g}"/>')

    def add_uv(self, u, v):
        self._body.append(f'\t<uv u="{u:.8g}" v="{v:.8g}"/>')

    def set_current_material(self, name):
        self._body.append(f'\t<set_material sval={quoteattr(str(name))}/>')

    def add_triangle(self, a, b, c, uv=None):
        if uv is not None:
            ua, ub, uc = uv
            self._body.append(f'\t<f a="{a}" b="{b}" c="{c}" '
                              f'uv_a="{ua}" uv_b="{ub}" uv_c="{uc}"/>')
        else:
            self._body.append(f'\t<f a="{a}" b="{b}" c="{c}"/>')

    def end_tri_mesh(self):
        self._body.append('</mesh>')
        self._mesh_open = False

    def start_curve_mesh(self, obj_id=None):
        """Strand curve element (xmlinterface curve writing; loader parity
        in io/xml_loader.py start_curve)."""
        if obj_id is None:
            obj_id = self._next_obj
        self._next_obj = max(self._next_obj, obj_id) + 1
        self._body.append(f'<curve id="{obj_id}">')
        self._mesh_open = True
        return obj_id

    def end_curve_mesh(self, mat_name, strand_start=0.01, strand_end=0.01,
                       strand_shape=0.0):
        self._body.append(f'\t<strand_start fval="{strand_start:.8g}"/>')
        self._body.append(f'\t<strand_end fval="{strand_end:.8g}"/>')
        self._body.append(f'\t<strand_shape fval="{strand_shape:.8g}"/>')
        self._body.append(f'\t<set_material sval={quoteattr(str(mat_name))}/>')
        self._body.append('</curve>')
        self._mesh_open = False
        return True

    def smooth_mesh(self, obj_id, angle):
        self._body.append(f'<smooth ID="{obj_id}" angle="{angle:.8g}"/>')

    def add_instance(self, base_obj_id, matrix):
        m = np.asarray(matrix, np.float64).reshape(4, 4)
        vals = " ".join(f'm{i}{j}="{m[i, j]:.8g}"'
                        for i in range(4) for j in range(4))
        self._body.append(f'<instance base_object_id="{base_obj_id}">')
        self._body.append(f'\t<transform {vals}/>')
        self._body.append('</instance>')

    # ---- render block + output ----
    def render(self, path_or_file):
        """Write the scene file; render params come from the current
        paramMap (xmlInterface_t::render writes and returns)."""
        out = ['<?xml version="1.0"?>', '<scene type="triangle">']
        out.extend(self._body)
        out.append('<render>')
        for k, v in self._params.items():
            out.append(f'\t<{escape(k)} {_fmt(v)}/>')
        out.append('</render>')
        out.append('</scene>')
        text = "\n".join(out) + "\n"
        if hasattr(path_or_file, "write"):
            path_or_file.write(text)
        else:
            with open(path_or_file, "w") as f:
                f.write(text)
        return text
