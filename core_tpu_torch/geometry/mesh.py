"""Host-side scene geometry assembly (counterpart of core_tpu/geometry/mesh.py).

A numpy assembler bakes every mesh into one flat SoA triangle soup, the
layout the intersection kernels consume; per-object identity is an int
column.  Scope: meshes with optional per-face UVs and angle-thresholded
smoothing (start_mesh / add_vertex / add_triangle / smooth_mesh / build),
plus bulk forms (add_vertices / add_uvs / add_triangles) that take whole
numpy arrays, so a million-triangle mesh assembles in seconds.
Curves and instances come with the scenes that need them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional

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
    """One mesh being assembled (reference triangleObject_t, meshtypes.h).
    Each field is a list of numpy blocks, concatenated at build."""
    obj_id: int
    verts: list = field(default_factory=list)        # [k,3] blocks
    uvs: list = field(default_factory=list)          # [k,2] uv pool blocks
    faces: list = field(default_factory=list)        # [k,3] vertex id blocks
    face_uvs: list = field(default_factory=list)     # [k,3] uv ids or None
    face_mats: list = field(default_factory=list)    # [k] material blocks
    n_verts: int = 0
    n_uvs: int = 0
    smooth_angle: Optional[float] = None             # degrees; None = flat


class MeshAssembler:
    """Builds GeomData from a sequence of meshes.

        a = MeshAssembler()
        m = a.start_mesh()
        a.add_vertex(m, x, y, z); a.add_triangle(m, ia, ib, ic, mat)
        a.smooth_mesh(m, angle)
        geom = a.build(device)
    """

    def __init__(self):
        self.meshes: list[MeshObject] = []

    def start_mesh(self) -> MeshObject:
        m = MeshObject(obj_id=len(self.meshes))
        self.meshes.append(m)
        return m

    def add_vertices(self, m: MeshObject, xyz) -> int:
        """Appends [k,3] vertices; returns the index of the first."""
        xyz = np.asarray(xyz, np.float32).reshape(-1, 3)
        m.verts.append(xyz)
        m.n_verts += xyz.shape[0]
        return m.n_verts - xyz.shape[0]

    def add_vertex(self, m: MeshObject, x, y, z) -> int:
        return self.add_vertices(m, [(float(x), float(y), float(z))])

    def add_uvs(self, m: MeshObject, uv) -> int:
        """Appends [k,2] pool uvs; returns the index of the first."""
        uv = np.asarray(uv, np.float32).reshape(-1, 2)
        m.uvs.append(uv)
        m.n_uvs += uv.shape[0]
        return m.n_uvs - uv.shape[0]

    def add_triangles(self, m: MeshObject, faces, mat: int, uv_ids=None):
        """Appends [k,3] faces of one material, with [k,3] uv ids or none."""
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        m.faces.append(faces)
        m.face_uvs.append(None if uv_ids is None
                          else np.asarray(uv_ids, np.int64).reshape(-1, 3))
        m.face_mats.append(np.full(faces.shape[0], int(mat), np.int32))

    def add_triangle(self, m: MeshObject, a, b, c, mat: int, uv_ids=None):
        self.add_triangles(m, [(int(a), int(b), int(c))], mat,
                           None if uv_ids is None else [tuple(uv_ids)])

    def smooth_mesh(self, m: MeshObject, angle_deg: float):
        m.smooth_angle = float(angle_deg)

    def build(self, device) -> GeomData:
        if not any(m.faces for m in self.meshes):
            raise ValueError("empty scene geometry")
        all_v, all_f, all_cn, all_sm, all_uv, all_mat, all_light, all_obj = \
            [], [], [], [], [], [], [], []
        v_off = 0
        for m in self.meshes:
            verts = np.concatenate(m.verts) if m.verts \
                else np.zeros((0, 3), np.float32)
            faces = np.concatenate(m.faces) if m.faces \
                else np.zeros((0, 3), np.int32)
            nT = faces.shape[0]
            corner_n, smooth = _smooth_normals(verts, faces, m.smooth_angle)
            uvs = np.zeros((nT, 3, 2), np.float32)
            if any(fu is not None for fu in m.face_uvs):
                if not m.uvs:
                    raise ValueError("mesh has per-face UV indices but no "
                                     "UV pool")
                pool = np.concatenate(m.uvs)
                row = 0
                for fb, fu in zip(m.faces, m.face_uvs):
                    if fu is not None:
                        uvs[row:row + fb.shape[0]] = pool[fu]
                    row += fb.shape[0]
            all_v.append(verts)
            all_f.append(faces + v_off)
            all_cn.append(corner_n)
            all_sm.append(smooth)
            all_uv.append(uvs)
            all_mat.append(np.concatenate(m.face_mats) if m.face_mats
                           else np.zeros(0, np.int32))
            # no mesh is bound to an area light (mesh lights not ported)
            all_light.append(np.full(nT, -1, np.int32))
            all_obj.append(np.full(nT, m.obj_id, np.int32))
            v_off += verts.shape[0]

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        return GeomData(
            verts=dev(np.concatenate(all_v)),
            tri_vidx=dev(np.concatenate(all_f)),
            corner_n=dev(np.concatenate(all_cn)),
            smooth=dev(np.concatenate(all_sm)),
            uvs=dev(np.concatenate(all_uv)),
            tri_mat=dev(np.concatenate(all_mat)),
            tri_light=dev(np.concatenate(all_light)),
            tri_obj=dev(np.concatenate(all_obj)))


def _smooth_normals(verts: np.ndarray, faces: np.ndarray,
                    angle_deg: Optional[float]):
    """Angle-thresholded vertex-normal smoothing, the same float32 math and
    accumulation order as core_tpu's _smooth_normals (reference
    triangle.cc).  Returns ([T,3,3] corner normals, [T] smooth flags)."""
    nT = faces.shape[0]
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    fn = np.cross(e1, e2)
    norm = np.linalg.norm(fn, axis=1, keepdims=True)
    fn = fn / np.maximum(norm, 1e-20)
    corner_n = np.repeat(fn[:, None, :], 3, axis=1).astype(np.float32)
    if angle_deg is None:
        return corner_n, np.zeros(nT, bool)
    cos_thresh = np.cos(np.radians(angle_deg))
    # area-weighted face normals accumulated per vertex, in face order
    vn = np.zeros_like(verts)
    weighted = fn * norm
    for c in range(3):
        np.add.at(vn, faces[:, c], weighted)
    vn_norm = vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True),
                              1e-20)
    for c in range(3):
        cand = vn_norm[faces[:, c]]
        ok = np.sum(cand * fn, axis=1) > cos_thresh
        corner_n[:, c, :] = np.where(ok[:, None], cand, fn).astype(np.float32)
    return corner_n, np.ones(nT, bool)
