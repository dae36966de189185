"""Shader-node DAGs: texture mappers and value nodes
(counterpart of core_tpu/textures/nodes.py; reference src/textures/
basicnodes.cc, graph solver src/yafraycore/nodematerial.cc).

A material's node list is topologically sorted once and evaluated over the
whole wavefront, each node to (rgb V3 [N], alpha [N], scalar [N]):
- texture_mapper (basicnodes.cc:253-310): texco uv / transformed / normal /
  reflect, anything else the global point (the reference's getCoords
  fallback); the proj_x/y/z axis swizzle; plain, tube, sphere or cube
  mapping; scale and offset; then the texture at the mapped point, an
  image texture at ((x + 1) / 2, (y + 1) / 2) of it.  Its scalar is the
  mean of the colour.
- value (basicnodes.cc:325-335): a constant colour, alpha and scalar.
The mix and layer nodes, and any other type, raise NotImplementedError by
name.  A mapper naming no texture of the scene raises ValueError (core_tpu
substitutes white there; the reference fails to create the node).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from core_tpu_torch.textures.base import eval_texture_def
from core_tpu_torch.vec import V3, dot3

SUPPORTED = ("texture_mapper", "value")


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


def check_supported(ndefs):
    for nd in ndefs:
        if nd.ntype not in SUPPORTED:
            raise NotImplementedError(
                f"shader node {nd.name!r} of type {nd.ntype!r} is not ported "
                f"to core_tpu_torch yet (ported: {', '.join(SUPPORTED)})")


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
    texname = nd.get("texture", "")
    tex_idx = ctx["texture_names"].get(texname, -1)
    if tex_idx < 0 or ctex is None:
        raise ValueError(f"texture_mapper {nd.name!r}: the scene has no "
                         f"texture named {texname!r}")
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
    return rgb, alpha, (rgb.x + rgb.y + rgb.z) / 3.0


def eval_graph(node_defs: list, out_name: str, ctx, ctex):
    """Evaluate the node named out_name over the wavefront.

    ctx: dict with p (V3 [N]), uv ((u, v), [N] each), n (V3 [N]), optional
    wo (V3 [N]) and texture_names (name -> index in ctex).  Returns (rgb
    V3, alpha, scalar), [N] each."""
    nodes = {nd.name: nd for nd in node_defs if nd is not None}
    if out_name not in nodes:
        raise ValueError(f"no shader node named {out_name!r}")
    check_supported(nodes.values())
    one = torch.ones_like(ctx["p"].x)
    results = {}
    for nd in toposort(nodes):
        if nd.ntype == "texture_mapper":
            results[nd.name] = _mapper_eval(nd, ctx, ctex)
        else:   # value
            col = tuple(nd.get("color", (1.0, 1.0, 1.0)))[:3]
            results[nd.name] = (
                V3(*(one * float(np.float32(c)) for c in col)),
                one * float(np.float32(nd.get("alpha", 1.0))),
                one * float(np.float32(nd.get("scalar", 1.0))))
    return results[out_name]
