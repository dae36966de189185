"""Host-side scene geometry assembly (counterpart of core_tpu/geometry/mesh.py).

A numpy assembler bakes every mesh and instance into one flat SoA triangle
soup, the layout the intersection kernels consume; per-object identity is
an int column.  Meshes take optional per-face UVs and angle-thresholded
smoothing (start_mesh / add_vertex / add_triangle / smooth_mesh / build),
plus bulk forms (add_vertices / add_uvs / add_triangles) that take whole
numpy arrays, so a million-triangle mesh assembles in seconds.  add_curve
extrudes a strand ribbon and add_instance repeats a mesh under a 4x4
transform, as core_tpu's do; object ids come from one counter, _next_obj,
which build also advances for every instance it emits (core_tpu
mesh.py:219-225), so an instance's triangles carry the id it gets at build,
not the one add_instance returned.
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
    light_idx: int = -1                              # area light, -1 none


class MeshAssembler:
    """Builds GeomData from a sequence of meshes and instances.

        a = MeshAssembler()
        m = a.start_mesh()
        a.add_vertex(m, x, y, z); a.add_triangle(m, ia, ib, ic, mat)
        a.smooth_mesh(m, angle)
        a.add_instance(base_obj_id, matrix4)
        geom = a.build(device)
    """

    def __init__(self):
        self.meshes: list[MeshObject] = []
        self.instances: list[tuple[int, np.ndarray]] = []
        self._next_obj = 0

    def start_mesh(self, light_idx: int = -1) -> MeshObject:
        m = MeshObject(obj_id=self._next_obj, light_idx=light_idx)
        self._next_obj += 1
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

    def add_uv(self, m: MeshObject, u, v) -> int:
        return self.add_uvs(m, [(float(u), float(v))])

    def add_triangles(self, m: MeshObject, faces, mat, uv_ids=None):
        """Appends [k,3] faces of one material (an int) or of one each
        ([k] ints), with [k,3] uv ids (a row of -1: that face has none) or
        none."""
        faces = np.asarray(faces, np.int32).reshape(-1, 3)
        m.faces.append(faces)
        m.face_uvs.append(None if uv_ids is None
                          else np.asarray(uv_ids, np.int64).reshape(-1, 3))
        mat = np.asarray(mat, np.int32)
        m.face_mats.append(np.full(faces.shape[0], int(mat), np.int32)
                           if mat.ndim == 0 else mat.reshape(-1))

    def add_triangle(self, m: MeshObject, a, b, c, mat: int, uv_ids=None):
        self.add_triangles(m, [(int(a), int(b), int(c))], mat,
                           None if uv_ids is None else [tuple(uv_ids)])

    def smooth_mesh(self, m: MeshObject, angle_deg: float):
        m.smooth_angle = float(angle_deg)

    def add_curve(self, m: MeshObject, points, mat: int,
                  strand_start: float = 0.01, strand_end: float = 0.01,
                  strand_shape: float = 0.0):
        """Strand/hair curve (reference scene_t::endCurveMesh,
        scene.cc:138-230; core_tpu mesh.py:92-158): the points, then per
        point a radius from the strand taper and two side vertices in the
        tangent frame, 6 side triangles per segment plus end caps, with
        1-D strand UVs (u = v = the arc parameter).  The same float64
        arithmetic, in the same order, as core_tpu."""
        pts = np.asarray(points, np.float64).reshape(-1, 3)
        n = pts.shape[0]
        if n < 2:
            raise ValueError("curve needs >= 2 points")
        base = m.n_verts
        verts = [p for p in pts]
        u = v = None
        for i in range(n):
            t = i / (n - 1)
            if strand_shape < 0:
                r = strand_start + t ** (1 + strand_shape) \
                    * (strand_end - strand_start)
            else:
                r = strand_start + (1 - (1 - t) ** (1 - strand_shape)) \
                    * (strand_end - strand_start)
            if i < n - 1:
                N = pts[i + 1] - pts[i]
                N = N / max(np.linalg.norm(N), 1e-20)
                # createCS (include/core_api/vector3d.h:316-334)
                if N[0] == 0 and N[1] == 0:
                    u = np.array([-1.0, 0, 0]) if N[2] < 0 \
                        else np.array([1.0, 0, 0])
                    v = np.array([0.0, 1, 0])
                else:
                    d = 1.0 / np.sqrt(N[1] * N[1] + N[0] * N[0])
                    u = np.array([N[1] * d, -N[0] * d, 0.0])
                    v = np.cross(N, u)
            o = pts[i]
            verts.append(o - 0.5 * r * v - 1.5 * r / np.sqrt(3.0) * u)
            verts.append(o - 0.5 * r * v + 1.5 * r / np.sqrt(3.0) * u)
        self.add_vertices(m, np.asarray(verts, np.float64))
        uv_base = m.n_uvs
        uvs, faces, face_uvs = [], [], []

        def uvid(s):
            uvs.append(s)
            return uv_base + len(uvs) - 1

        def tri(a, b, c, uv):
            faces.append((a, b, c))
            face_uvs.append(uv)

        for i in range(n - 1):
            su = i / (n - 1)
            sv = su + 1.0 / (n - 1)
            iu, iv = uvid(su), uvid(sv)
            a1, a2 = base + i, base + n + 2 * i
            a3 = a2 + 1
            b1, b2 = base + i + 1, a2 + 2
            b3 = b2 + 1
            if i == 0:  # bottom cap
                tri(a1, a3, a2, (iu, iu, iu))
            tri(a1, b2, b1, (iu, iv, iv))
            tri(a1, a2, b2, (iu, iu, iv))
            tri(a2, b3, b2, (iu, iv, iv))
            tri(a2, a3, b3, (iu, iu, iv))
            tri(b3, a3, a1, (iv, iu, iu))
            tri(b3, a1, b1, (iv, iu, iv))
        # top cap (i = n-1 after the loop, reference scene.cc:227)
        i = n - 1
        iv_top = uvid(1.0)
        tri(base + i, base + n + 2 * i, base + n + 2 * i + 1,
            (iv_top, iv_top, iv_top))
        self.add_uvs(m, np.repeat(np.asarray(uvs, np.float64)[:, None], 2,
                                  axis=1))
        self.add_triangles(m, faces, mat, uv_ids=face_uvs)

    def add_instance(self, base_obj_id: int, matrix) -> int:
        """Instance an already-added mesh with a 4x4 transform (reference
        scene_t::addInstance, scene.cc:982).  Returns the next object id;
        build emits the instance under the id the counter holds then."""
        self.instances.append((base_obj_id, np.asarray(matrix, np.float64)))
        obj_id = self._next_obj
        self._next_obj += 1
        return obj_id

    def build(self, device) -> GeomData:
        all_v, all_f, all_cn, all_sm, all_uv, all_mat, all_light, all_obj = \
            [], [], [], [], [], [], [], []
        v_off = 0
        # obj id -> (verts, faces, uv blocks, uv pool, face mats, smooth
        # angle, light idx), the sources of instances; uv blocks are
        # (face count, [k,3] uv ids or None) pairs
        base_ranges = {}

        def emit(verts, faces, uv_blocks, uv_pool, face_mats, smooth_angle,
                 light_idx, obj_id):
            nonlocal v_off
            nT = faces.shape[0]
            corner_n, smooth = _smooth_normals(verts, faces, smooth_angle)
            uvs = np.zeros((nT, 3, 2), np.float32)
            if any(fu is not None for _, fu in uv_blocks):
                if uv_pool is None:
                    raise ValueError("mesh has per-face UV indices but no "
                                     "UV pool")
                row = 0
                for k, fu in uv_blocks:
                    if fu is not None:
                        has = (fu >= 0).all(axis=1)
                        uvs[row:row + k][has] = uv_pool[fu[has]]
                    row += k
            all_v.append(verts)
            all_f.append(faces + v_off)
            all_cn.append(corner_n)
            all_sm.append(smooth)
            all_uv.append(uvs)
            all_mat.append(face_mats)
            all_light.append(np.full(nT, light_idx, np.int32))
            all_obj.append(np.full(nT, obj_id, np.int32))
            base_ranges[obj_id] = (verts, faces, uv_blocks, None, face_mats,
                                   smooth_angle, light_idx)
            v_off += verts.shape[0]

        for m in self.meshes:
            verts = np.concatenate(m.verts) if m.verts \
                else np.zeros((0, 3), np.float32)
            faces = np.concatenate(m.faces) if m.faces \
                else np.zeros((0, 3), np.int32)
            pool = np.concatenate(m.uvs) if m.uvs else None
            uv_blocks = [(f.shape[0], fu) for f, fu in zip(m.faces,
                                                           m.face_uvs)]
            mats = np.concatenate(m.face_mats) if m.face_mats \
                else np.zeros(0, np.int32)
            emit(verts, faces, uv_blocks, pool, mats, m.smooth_angle,
                 m.light_idx, m.obj_id)
            # keep the uv pool for instances
            base_ranges[m.obj_id] = (verts, faces, uv_blocks, pool, mats,
                                     m.smooth_angle, m.light_idx)
        for obj_id_src, mat4 in self.instances:
            verts, faces, uv_blocks, uv_pool, face_mats, sm_ang, light_idx = \
                base_ranges[obj_id_src]
            vh = np.concatenate(
                [verts, np.ones((verts.shape[0], 1), np.float32)], axis=1)
            tv = (vh @ mat4.T)[:, :3].astype(np.float32)
            emit(tv, faces, uv_blocks, uv_pool, face_mats, sm_ang, light_idx,
                 obj_id=self._next_obj)
            self._next_obj += 1
        if not any(f.shape[0] for f in all_f):
            raise ValueError("empty scene geometry")

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
