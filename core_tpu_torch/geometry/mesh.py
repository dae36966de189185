"""Host-side scene geometry assembly (counterpart of core_tpu/geometry/mesh.py).

A numpy assembler bakes every mesh into one flat SoA triangle soup, the
layout the intersection kernels consume; per-object identity is an int
column.  Scope: flat-shaded meshes without UVs (start_mesh / add_vertex /
add_triangle / build), which is what the Cornell box uses.  Smoothing, UV
pools, curves and instances come with the scenes that need them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch


class GeomData(NamedTuple):
    """Flattened scene geometry (tensors on one device)."""
    verts: torch.Tensor          # [V,3] f32
    tri_vidx: torch.Tensor       # [T,3] i32 vertex indices
    corner_n: torch.Tensor       # [T,3,3] f32 per-corner shading normals
    smooth: torch.Tensor         # [T] bool — use corner_n vs geometric normal
    uvs: torch.Tensor            # [T,3,2] f32 per-corner uv
    tri_mat: torch.Tensor        # [T] i32 material index
    tri_light: torch.Tensor      # [T] i32 area-light index (-1 = none)
    tri_obj: torch.Tensor        # [T] i32 object id

    @property
    def n_tris(self) -> int:
        return self.tri_vidx.shape[0]


@dataclass
class MeshObject:
    """One mesh being assembled (reference triangleObject_t, meshtypes.h)."""
    obj_id: int
    verts: list = field(default_factory=list)
    faces: list = field(default_factory=list)        # (a,b,c) vertex ids
    face_mats: list = field(default_factory=list)    # material index per face


class MeshAssembler:
    """Builds GeomData from a sequence of meshes.

        a = MeshAssembler()
        m = a.start_mesh()
        a.add_vertex(m, x, y, z); a.add_triangle(m, ia, ib, ic, mat)
        geom = a.build(device)
    """

    def __init__(self):
        self.meshes: list[MeshObject] = []

    def start_mesh(self) -> MeshObject:
        m = MeshObject(obj_id=len(self.meshes))
        self.meshes.append(m)
        return m

    def add_vertex(self, m: MeshObject, x, y, z) -> int:
        m.verts.append((float(x), float(y), float(z)))
        return len(m.verts) - 1

    def add_triangle(self, m: MeshObject, a, b, c, mat: int):
        m.faces.append((int(a), int(b), int(c)))
        m.face_mats.append(int(mat))

    def build(self, device) -> GeomData:
        if not any(m.faces for m in self.meshes):
            raise ValueError("empty scene geometry")
        all_v, all_f, all_cn, all_mat, all_light, all_obj = \
            [], [], [], [], [], []
        v_off = 0
        for m in self.meshes:
            verts = np.asarray(m.verts, np.float32).reshape(-1, 3)
            faces = np.asarray(m.faces, np.int32).reshape(-1, 3)
            nT = faces.shape[0]
            all_v.append(verts)
            all_f.append(faces + v_off)
            all_cn.append(_flat_normals(verts, faces))
            all_mat.append(np.asarray(m.face_mats, np.int32))
            # no mesh is bound to an area light (mesh lights not ported)
            all_light.append(np.full(nT, -1, np.int32))
            all_obj.append(np.full(nT, m.obj_id, np.int32))
            v_off += verts.shape[0]
        n_tris = sum(f.shape[0] for f in all_f)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return GeomData(
            verts=dev(np.concatenate(all_v)),
            tri_vidx=dev(np.concatenate(all_f)),
            corner_n=dev(np.concatenate(all_cn)),
            smooth=dev(np.zeros(n_tris, bool)),
            uvs=dev(np.zeros((n_tris, 3, 2), np.float32)),
            tri_mat=dev(np.concatenate(all_mat)),
            tri_light=dev(np.concatenate(all_light)),
            tri_obj=dev(np.concatenate(all_obj)))


def _flat_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """[T,3,3] corner normals = the face normal at every corner (the
    un-smoothed branch of core_tpu's _smooth_normals, same float32 math)."""
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = np.cross(e1, e2)
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norm, 1e-20)
    return np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
