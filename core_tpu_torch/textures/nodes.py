"""Shader-node DAGs (counterpart of core_tpu/textures/nodes.py; reference
src/textures/basicnodes.cc and layernode.cc, graph solver
src/yafraycore/nodematerial.cc).

A material's node list is topologically sorted once and evaluated over the
whole wavefront, each node to (rgb V3 [N], alpha [N], scalar [N]):
- texture_mapper (basicnodes.cc:253-310): texco uv / transformed / normal /
  reflect, anything else the global point (the reference's getCoords
  fallback); the proj_x/y/z axis swizzle; plain, tube, sphere or cube
  mapping; scale and offset; then the texture at the mapped point, an
  image texture at ((x + 1) / 2, (y + 1) / 2) of it.  Its scalar is the
  mean of the colour.
- value (basicnodes.cc:325-335): a constant colour, alpha and scalar.
- mix (basicnodes.cc:340-600): two inputs, each a node or a constant
  colour and value, combined by a factor (a node's scalar or a constant)
  in one of the modes of _MODE_NAMES; the node types "add", "multiply",
  ... name their mode themselves.  Mode 5 ("divide") has no branch of its
  own in core_tpu and mixes by lerp: this copy does the same.  Alpha 1.
- layer (layernode.cc; texture_rgb_blend / texture_value_blend,
  shader.h:112-210): an input blended over an upper layer (a node or a
  constant) by colfac / valfac in one of nine modes, with the stencil,
  negative, noRGB and use_alpha flags; do_color and do_scalar pick the
  outputs it blends.
Where core_tpu substitutes ones (white, alpha 1, scalar 1), this copy
does too: a node of any other type, a texture_mapper naming no texture of
the scene, and an output name naming no node of the list.  A mix input
naming no node takes the node's own constant (color1 / value1, color2 /
value2, the factor's value); a layer input naming no node takes white (or
the upper_color / upper_value constant).  A node cycle raises ValueError.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from core_tpu_torch.textures.base import eval_texture_def
from core_tpu_torch.vec import V3, dot3

# int mix mode (shader.h mix_modes) -> combine key; the reference registers
# one "mix" node type whose factory dispatches on the int "mode" param
# (basicnodes.cc:585-604)
_MODE_NAMES = {0: "mix", 1: "add", 2: "multiply", 3: "subtract", 4: "screen",
               5: "divide", 6: "difference", 7: "darken", 8: "lighten",
               9: "overlay"}
_MIX_TYPES = {"mix"} | set(_MODE_NAMES.values())


@dataclass(frozen=True)
class NodeDef:
    name: str
    ntype: str                      # texture_mapper | value | mix | layer
    params: tuple                   # sorted (key, value) pairs (hashable)

    def get(self, key, default=None):
        for k, v in self.params:
            if k == key:
                return v
        return default


def parse_node(pm) -> Optional[NodeDef]:
    """ParamMap (one element of a material's node list) -> NodeDef; None
    for an element without a name or a type."""
    name = pm.get_str("name", "")
    ntype = pm.get_str("type", "")
    if not name or not ntype:
        return None

    def freeze(v):
        return tuple(v) if isinstance(v, list) else v

    items = {k: freeze(v) for k, v in pm.items()
             if k not in ("name", "element")}
    return NodeDef(name=name, ntype=ntype,
                   params=tuple(sorted(items.items(),
                                       key=lambda kv: kv[0])))


def _deps(nd: NodeDef):
    out = []
    for key in ("input", "upper_layer", "input1", "input2", "factor"):
        v = nd.get(key)
        if isinstance(v, str) and v:
            out.append(v)
    return out


def toposort(nodes: dict) -> list:
    """Dependency order (reference nodematerial.cc solveNodesOrder); a
    cycle raises ValueError."""
    order, seen = [], {}

    def visit(name):
        state = seen.get(name)
        if state == 2:
            return
        if state == 1:
            raise ValueError(f"shader node cycle at '{name}'")
        seen[name] = 1
        nd = nodes.get(name)
        if nd is not None:
            for d in _deps(nd):
                visit(d)
            order.append(nd)
        seen[name] = 2

    for n in nodes:
        visit(n)
    return order


# ---- coordinate mapping (basicnodes.cc getCoords + doMapping) ----

def _tubemap(p: V3):
    d = p.x * p.x + p.y * p.y
    dn = torch.where(d > 0, 1.0 / torch.sqrt(d.clamp_min(1e-20)), 0.0)
    u = torch.where(d > 0, 0.5 * (1.0 - torch.atan2(p.x * dn, p.y * dn)
                                  / math.pi), 0.0)
    v = 1.0 - (p.z + 1.0) * 0.5
    return u, v


def _spheremap(p: V3):
    r_phi = p.x * p.x + p.y * p.y
    r_theta = r_phi + p.z * p.z
    cosphi = p.x / torch.sqrt(r_phi.clamp_min(1e-20))
    phi = torch.acos(cosphi.clamp(-1.0, 1.0))
    phi = torch.where(p.y < 0, 2 * math.pi - phi, phi) / (2 * math.pi)
    u = torch.where(r_phi > 0, 1.0 - phi, 0.0)
    v = 1.0 - torch.acos((p.z / torch.sqrt(r_theta.clamp_min(1e-20)))
                         .clamp(-1.0, 1.0)) / math.pi
    return u, v


def _cubemap(p: V3, n: V3):
    """Project along the dominant normal axis (texture.h cubemap)."""
    ax, ay, az = n.x.abs(), n.y.abs(), n.z.abs()
    use_x = (ax >= ay) & (ax >= az)
    use_y = ~use_x & (ay >= az)
    u = torch.where(use_x, p.y, p.x)
    v = torch.where(use_x, p.z, torch.where(use_y, p.z, p.y))
    return u, v


def _mapper_coords(nd: NodeDef, ctx) -> V3:
    """The mapper's texture-space point (before scale and offset)."""
    texco = nd.get("texco", "global")
    p = ctx["p"]
    if texco == "uv":
        u, v = ctx["uv"]
        return V3(2.0 * u - 1.0, 2.0 * v - 1.0, torch.zeros_like(u))
    if texco == "transformed":
        m = np.asarray(nd.get("transform", np.eye(4).ravel().tolist()),
                       np.float32).reshape(4, 4)
        return V3(*(p.x * float(m[r, 0]) + p.y * float(m[r, 1])
                    + p.z * float(m[r, 2]) + float(m[r, 3])
                    for r in range(3)))
    if texco == "normal":
        return ctx["n"]
    if texco == "reflect":
        n, wo = ctx["n"], ctx.get("wo")
        return n if wo is None else n * (2.0 * dot3(n, wo)) - wo
    return p       # global / orco / window / stick / stress / tangent


def _mapper_eval(nd: NodeDef, ctx, ctex):
    tex_idx = ctx["texture_names"].get(nd.get("texture", ""), -1)
    if tex_idx < 0 or ctex is None:
        return _white(torch.ones_like(ctx["p"].x))
    tp = _mapper_coords(nd, ctx)
    # axis swizzle proj_x/y/z in {0: none, 1: x, 2: y, 3: z}
    comps = (torch.zeros_like(tp.x), tp.x, tp.y, tp.z)
    tp = V3(*(comps[min(max(int(nd.get(key, dflt)), 0), 3)]
              for key, dflt in (("proj_x", 1), ("proj_y", 2),
                                ("proj_z", 3))))
    mapping = nd.get("mapping", "plain")
    if mapping in ("tube", "sphere", "cube"):
        u, v = (_tubemap(tp) if mapping == "tube" else _spheremap(tp)
                if mapping == "sphere" else _cubemap(tp, ctx["n"]))
        tp = V3(u, v, comps[0])
    scale = np.asarray(nd.get("scale", (1.0, 1.0, 1.0)), np.float32)
    offset = np.asarray(nd.get("offset", (0.0, 0.0, 0.0)), np.float32)
    tp = V3(*(c * float(s) + float(o) for c, s, o in zip(tp, scale, offset)))
    # image textures sample ((x+1)/2, (y+1)/2) of the mapped point
    # (imagetex.cc doMapping); procedural textures take the 3D point.  The
    # round trip 2u - 1 -> (x + 1) / 2 is kept as written: in float32 it
    # does not give u back exactly
    uv = ((tp.x + 1.0) * 0.5, (tp.y + 1.0) * 0.5)
    rgb, alpha = eval_texture_def(ctex, tex_idx, tp, uv)
    return rgb, alpha, _mean3(rgb)


# ---- mix modes (basicnodes.cc:440-600), in core_tpu's operation order ----

def _v3map(fn, *args) -> V3:
    """fn per colour channel; a V3 argument gives its channel, any other
    is passed as it is."""
    return V3(*(fn(*(a[c] if isinstance(a, V3) else a for a in args))
                for c in range(3)))


def _absdiff(a, b):
    return (a - b).abs()


def _mix_combine(mode: str, c1: V3, f1v, c2: V3, f2v, f2):
    """(colour, scalar) of a mix node: input 1 (c1, f1v) and input 2 (c2,
    f2v) by factor f2.  "divide" has no branch and lerps, as in core_tpu."""
    f1 = 1.0 - f2
    if mode == "add":
        return c1 + c2 * f2, f1v + f2 * f2v
    if mode == "multiply":
        return c1 * (c2 * f2 + f1), f1v * (f1 + f2 * f2v)
    if mode == "subtract":
        return c1 - c2 * f2, f1v - f2 * f2v
    if mode == "screen":
        return (1.0 - ((1.0 - c2) * f2 + f1) * (1.0 - c1),
                1.0 - (f1 + f2 * (1.0 - f2v)) * (1.0 - f1v))
    if mode == "difference":
        return (c1 * f1 + _v3map(_absdiff, c1, c2) * f2,
                f1 * f1v + f2 * (f1v - f2v).abs())
    if mode == "darken":
        return _v3map(torch.minimum, c2 * f2, c1), torch.minimum(f2 * f2v,
                                                                 f1v)
    if mode == "lighten":
        return _v3map(torch.maximum, c2 * f2, c1), torch.maximum(f2 * f2v,
                                                                 f1v)
    if mode == "overlay":
        f2x2 = 2.0 * f2
        lo = c1 * (c2 * f2x2 + f1)
        hi = 1.0 - ((1.0 - c2) * f2x2 + f1) * (1.0 - c1)
        col = _v3map(lambda a, lo_, hi_: torch.where(a < 0.5, lo_, hi_),
                     c1, lo, hi)
        slo = f1v * (f1 + f2x2 * f2v)
        shi = 1.0 - (f1 + f2x2 * (1.0 - f2v)) * (1.0 - f1v)
        return col, torch.where(f1v < 0.5, slo, shi)
    return c1 * f1 + c2 * f2, f1 * f1v + f2 * f2v          # mix (lerp)


# ---- layer blend (shader.h texture_rgb_blend / texture_value_blend) ----

def _rgb_blend(mode: int, tex: V3, out: V3, fact, facg) -> V3:
    fc = fact * facg
    if mode == 1:   # ADD
        return tex * fc + out
    if mode == 2:   # MULT
        return (tex * fc + (1.0 - facg)) * out
    if mode == 3:   # SUB
        return tex * (-fc) + out
    if mode == 4:   # SCREEN
        return 1.0 - ((1.0 - tex) * fc + (1.0 - facg)) * (1.0 - out)
    if mode == 5:   # DIV
        return out * (1.0 - fc) + out * fc * (1.0 - tex)
    if mode == 6:   # DIFF
        return out * (1.0 - fc) + _v3map(_absdiff, tex, out) * fc
    if mode == 7:   # DARK
        return _v3map(torch.minimum, tex * fc, out)
    if mode == 8:   # LIGHT
        return _v3map(torch.maximum, tex * fc, out)
    return tex * fc + out * (1.0 - fc)                    # MIX


def _value_blend(mode: int, tex, out, fact, facg, flip: bool):
    f = fact * facg
    fm = 1.0 - f
    if flip:
        f, fm = fm, f
    if mode == 1:
        return f * tex + out
    if mode == 2:
        return ((1.0 - facg) + f * tex) * out
    if mode == 3:
        return -f * tex + out
    if mode == 4:
        return 1.0 - ((1.0 - facg) + f * (1.0 - tex)) * (1.0 - out)
    if mode == 5:
        zero = tex == 0.0
        return torch.where(zero, 0.0, fm * out + f * out
                           / torch.where(zero, 1.0, tex))
    if mode == 6:
        return fm * out + f * (tex - out).abs()
    if mode == 7:
        return torch.minimum(f * tex, out)
    if mode == 8:
        return torch.maximum(f * tex, out)
    return f * tex + fm * out


def _input(nd: NodeDef, key: str, results):
    """The result of the node that parameter `key` names; None when the
    parameter is absent, empty or names no node of the list."""
    return results.get(nd.get(key, "") or None)


def _white(one):
    """core_tpu's substitute for a node it cannot evaluate: ones."""
    return V3(one, one, one), one, one


def _const(one, color, value):
    """A constant input: the colour (alpha 1) and value as float32."""
    return (V3(*(one * float(np.float32(c)) for c in tuple(color)[:3])), one,
            one * float(np.float32(value)))


def _mean3(c: V3):
    return (c.x + c.y + c.z) / 3.0


def _layer_eval(nd: NodeDef, one, results):
    """layerNode_t::eval as core_tpu's _layer_eval: the input blended over
    the upper layer, colour and scalar."""
    upper = _input(nd, "upper_layer", results) or _const(
        one, nd.get("upper_color", (0, 0, 0)), nd.get("upper_value", 0.0))
    rcol, ralpha, rval = upper
    stencil_tin = ralpha
    icol, ialpha, ival = _input(nd, "input", results) or _white(one)
    color_input = bool(nd.get("color_input", True))
    mode = int(nd.get("mode", 0))
    tex_rgb = color_input
    texcolor = icol
    if color_input:
        ta = ialpha if bool(nd.get("use_alpha", False)) else one
        tin = torch.zeros_like(one)
    else:
        ta, tin = one, ival
    if bool(nd.get("noRGB", False)) and color_input:
        tex_rgb = False
        tin = _mean3(texcolor)
    if bool(nd.get("negative", False)):
        tin = 1.0 - tin
        texcolor = 1.0 - texcolor
    if bool(nd.get("stencil", False)):
        if tex_rgb:
            fact = ta
            ta = ta * stencil_tin
        else:
            fact = tin
            tin = tin * stencil_tin
        stencil_tin = stencil_tin * fact
    out_col, out_alpha, out_val = rcol, ralpha, rval
    if bool(nd.get("do_color", True)):
        out_col = _rgb_blend(mode, texcolor, rcol, ta if tex_rgb else tin,
                             stencil_tin * float(nd.get("colfac", 1.0)))
        out_alpha = stencil_tin
    if bool(nd.get("do_scalar", False)):
        out_val = _value_blend(mode, one * float(nd.get("def_val", 1.0)),
                               rval, _mean3(texcolor) if tex_rgb else tin,
                               stencil_tin * float(nd.get("valfac", 1.0)),
                               False)
    return out_col, out_alpha, out_val


def _mix_eval(nd: NodeDef, one, results):
    """A mix node (or one of the types naming a mode): inputs as nodes or
    as constants color1/value1 and color2/value2, the factor a node's
    scalar or the constant value (cfactor, 0.5)."""
    c1, _, f1v = _input(nd, "input1", results) or _const(
        one, nd.get("color1", (0, 0, 0)), nd.get("value1", 0.0))
    c2, _, f2v = _input(nd, "input2", results) or _const(
        one, nd.get("color2", (0, 0, 0)), nd.get("value2", 0.0))
    factor = _input(nd, "factor", results)
    f2 = factor[2] if factor is not None else one * float(
        nd.get("value", nd.get("cfactor", 0.5)))
    mode = _MODE_NAMES.get(int(nd.get("mode", 0)), nd.ntype) \
        if nd.ntype == "mix" else nd.ntype
    col, sval = _mix_combine(mode, c1, f1v, c2, f2v, f2)
    return col, one, sval


def eval_graph(node_defs: list, out_name: str, ctx, ctex):
    """Evaluate the node named out_name over the wavefront.

    ctx: dict with p (V3 [N]), uv ((u, v), [N] each), n (V3 [N]), optional
    wo (V3 [N]) and texture_names (name -> index in ctex).  Returns (rgb
    V3, alpha, scalar), [N] each."""
    nodes = {nd.name: nd for nd in node_defs if nd is not None}
    one = torch.ones_like(ctx["p"].x)
    if out_name not in nodes:
        return _white(one)
    results = {}
    for nd in toposort(nodes):
        if nd.ntype == "texture_mapper":
            results[nd.name] = _mapper_eval(nd, ctx, ctex)
        elif nd.ntype == "layer":
            results[nd.name] = _layer_eval(nd, one, results)
        elif nd.ntype in _MIX_TYPES:
            results[nd.name] = _mix_eval(nd, one, results)
        elif nd.ntype != "value":
            results[nd.name] = _white(one)
        else:
            col, _, sval = _const(one, nd.get("color", (1.0, 1.0, 1.0)),
                                  nd.get("scalar", 1.0))
            results[nd.name] = (
                col, one * float(np.float32(nd.get("alpha", 1.0))), sval)
    return results[out_name]
