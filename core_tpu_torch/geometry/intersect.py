"""Ray-triangle intersection: the plain PyTorch versions of the CUDA kernels
(counterpart of core_tpu/geometry/intersect.py, with the kernel semantics of
core_tpu/geometry/pallas_intersect.py).

Each function here has the signature and the exact semantics of one kernel
in csrc/intersect.cu, and writes its arithmetic in the kernel's order, so a
kernel and its plain version agree bit for bit (the kernels are compiled
with FMA contraction off for that reason):

- closest_hit_torch  <-> cti_closest_hit   (Pallas _intersect_kernel)
- any_hit_torch      <-> cti_any_hit       (Pallas _any_hit_kernel)
- any_hit_nee_torch  <-> cti_any_hit_nee   (Pallas _any_hit_nee_kernel)

They serve the CPU path of the renderer, the CPU tests, and the on-card
comparison in chip_smoke.py.  Rays are processed in chunks so the [n, T]
intermediates stay bounded when the plain versions run on the card.

Shared rules (ROADMAP Queue 2): a Möller-Trumbore hit counts only when
|det| > 1e-12 and t lies in (tmin, tcap); tcap <= 0 marks an open ray
(cap = BIG); each ray may exclude two primitive ids (-2 = none), compared
against the triangle's row in pack_tris order.  A closest-hit miss comes
back as prim = -1, t = -1, u = v = 0; ties go to the lowest triangle index.
"""
from __future__ import annotations

import torch

from core_tpu_torch.types import Hits

BIG = 3.0e38
# [n, T] elements per chunk: about 1M rays at the Cornell box's 36 triangles
CHUNK_ELEMS = 1 << 25


def pack_tris(verts, tri_vidx):
    """[T, 9] float32 triangle rows v0, e1, e2 (core_tpu _pack_tris, without
    the TPU's padding to a multiple of 8).  Detached: intersection is not a
    gradient path (core_tpu/scene.py:81-95)."""
    verts = verts.detach()
    idx = tri_vidx.long()
    v0 = verts[idx[:, 0]]
    e1 = verts[idx[:, 1]] - v0
    e2 = verts[idx[:, 2]] - v0
    return torch.cat([v0, e1, e2], dim=1).contiguous()


def _tri_cols(tri):
    """The nine [1, T] triangle columns."""
    return [tri[:, c][None, :] for c in range(9)]


def _chunks(n: int, n_tris: int):
    step = max(1, CHUNK_ELEMS // max(n_tris, 1))
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def _not_excluded(tri_idx, exclude_prim, exclude_prim2, c0, c1):
    ok = torch.ones((c1 - c0, tri_idx.shape[1]), dtype=torch.bool,
                    device=tri_idx.device)
    for ex in (exclude_prim, exclude_prim2):
        if ex is not None:
            ok = ok & (tri_idx != ex[c0:c1, None])
    return ok


def closest_hit_torch(tri, rays_s, exclude_prim=None,
                      exclude_prim2=None) -> Hits:
    """Closest hit of every ray against every triangle row of `tri`.

    tri: [T, 9] from pack_tris; rays_s: vec.RaysS of [N] float32 tensors
    (tmax <= 0 = open); exclude_prim*: optional [N] int32 ids."""
    closest_hit_torch.calls += 1
    n = rays_s.tmin.shape[0]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(tri)
    tri_idx = torch.arange(tri.shape[0], device=tri.device)[None, :]
    out_t, out_p, out_u, out_v = [], [], [], []
    for c0, c1 in _chunks(n, tri.shape[0]):
        def col(a):
            return a[c0:c1, None]
        ox, oy, oz = col(rays_s.o.x), col(rays_s.o.y), col(rays_s.o.z)
        dx, dy, dz = col(rays_s.d.x), col(rays_s.d.y), col(rays_s.d.z)
        tmin = col(rays_s.tmin)
        tmax = col(rays_s.tmax)
        tcap = torch.where(tmax > 0, tmax, BIG)
        # pvec = d x e2
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        det_ok = det.abs() > 1e-12
        inv_det = 1.0 / torch.where(det_ok, det, 1.0)
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        u = (tx * px + ty * py + tz * pz) * inv_det
        # qvec = tvec x e1
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        v = (dx * qx + dy * qy + dz * qz) * inv_det
        t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
        ok = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
            & (t > tmin) & (t < tcap) \
            & _not_excluded(tri_idx, exclude_prim, exclude_prim2, c0, c1)
        best, j = torch.where(ok, t, BIG).min(dim=1)
        hit = ok.any(dim=1)
        j1 = j[:, None]
        out_t.append(torch.where(hit, best, -1.0))
        out_p.append(torch.where(hit, j, -1).to(torch.int32))
        out_u.append(torch.where(hit, u.gather(1, j1)[:, 0], 0.0))
        out_v.append(torch.where(hit, v.gather(1, j1)[:, 0], 0.0))
    if not out_t:
        e = torch.empty(0, dtype=torch.float32, device=tri.device)
        return Hits(t=e, prim=e.to(torch.int32), u=e, v=e)
    return Hits(t=torch.cat(out_t), prim=torch.cat(out_p),
                u=torch.cat(out_u), v=torch.cat(out_v))


def any_hit_torch(tri, rays_s, exclude_prim=None, exclude_prim2=None,
                  count_tests=False):
    """Occlusion of one ray per lane (the dirac lights' shadow rays), with
    the division-free, sign-folded test of the kernel.  Returns [N] bool,
    or with count_tests (bits, triangle tests per ray): the work the rays
    need, tested in index order, up to a ray's first occluder (T if none);
    a dead ray (0 < tmax <= tmin) needs none."""
    any_hit_torch.calls += 1
    n = rays_s.tmin.shape[0]
    T = tri.shape[0]
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(tri)
    tri_idx = torch.arange(T, device=tri.device)[None, :]
    out = torch.empty(n, dtype=torch.bool, device=tri.device)
    tests = torch.empty(n, dtype=torch.int64, device=tri.device)
    for c0, c1 in _chunks(n, tri.shape[0]):
        def col(a):
            return a[c0:c1, None]
        ox, oy, oz = col(rays_s.o.x), col(rays_s.o.y), col(rays_s.o.z)
        dx, dy, dz = col(rays_s.d.x), col(rays_s.d.y), col(rays_s.d.z)
        tmin = col(rays_s.tmin)
        tmax = col(rays_s.tmax)
        tcap = torch.where(tmax > 0, tmax, BIG)
        px = dy * e2z - dz * e2y
        py = dz * e2x - dx * e2z
        pz = dx * e2y - dy * e2x
        det = e1x * px + e1y * py + e1z * pz
        s = torch.where(det < 0.0, -1.0, 1.0)
        dd = det.abs()
        tx = ox - v0x
        ty = oy - v0y
        tz = oz - v0z
        un = (tx * px + ty * py + tz * pz) * s
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        vn = (dx * qx + dy * qy + dz * qz) * s
        tn = (e2x * qx + e2y * qy + e2z * qz) * s
        ok = (dd > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= dd) \
            & (tn > tmin * dd) & (tn < tcap * dd) \
            & _not_excluded(tri_idx, exclude_prim, exclude_prim2, c0, c1)
        out[c0:c1] = ok.any(dim=1)
        stop = torch.where(out[c0:c1], ok.to(torch.uint8).argmax(dim=1) + 1,
                           T)
        dead = ((tmax > 0) & (tmax <= tmin))[:, 0]
        tests[c0:c1] = torch.where(dead, 0, stop)
    return (out, tests) if count_tests else out


def any_hit_nee_torch(tri, o3, tmin, dirs, tcaps, exclude_prim=None,
                      exclude_prim2=None, count_tests=False):
    """Occlusion of K shadow rays per lane that share one origin (the NEE
    bundle), with the division-free, sign-folded test of the kernel.

    o3: V3 of [N] origins; tmin: [N]; dirs: K V3 of [N] directions; tcaps:
    K [N] caps (<= 0 -> open).  Returns [K*N] bool, sample-major (ray k of
    lane j at k*N + j).  Per triangle the origin-only terms (tvec, w =
    e2 x tvec, qvec = tvec x e1, tnum = e2 . qvec, the exclusions) are
    computed once and shared by the K directions.

    With count_tests, (bits, lane tests [N], direction tests [N]): the
    work the bundle needs, tested in index order.  A dead ray (0 < tcap <=
    tmin) needs no test; a live one is tested up to its first occluder (T
    if none), and a lane's origin terms up to the last of its live rays'
    stops."""
    any_hit_nee_torch.calls += 1
    K = len(dirs)
    n = tmin.shape[0]
    T = tri.shape[0]
    lane_tests = torch.zeros(n, dtype=torch.int64, device=tri.device)
    dir_tests = torch.zeros(n, dtype=torch.int64, device=tri.device)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(tri)
    tri_idx = torch.arange(tri.shape[0], device=tri.device)[None, :]
    # m1 = e2 x e1  (det = d . m1)
    m1x = e2y * e1z - e2z * e1y
    m1y = e2z * e1x - e2x * e1z
    m1z = e2x * e1y - e2y * e1x
    out = torch.empty(K * n, dtype=torch.bool, device=tri.device)
    for c0, c1 in _chunks(n, tri.shape[0]):
        def col(a):
            return a[c0:c1, None]
        tx = col(o3.x) - v0x
        ty = col(o3.y) - v0y
        tz = col(o3.z) - v0z
        # w = e2 x tvec  (u_num = d . w)
        wx = e2y * tz - e2z * ty
        wy = e2z * tx - e2x * tz
        wz = e2x * ty - e2y * tx
        # qvec = tvec x e1  (v_num = d . qvec; t_num = e2 . qvec)
        qx = ty * e1z - tz * e1y
        qy = tz * e1x - tx * e1z
        qz = tx * e1y - ty * e1x
        tnum = e2x * qx + e2y * qy + e2z * qz
        not_excl = _not_excluded(tri_idx, exclude_prim, exclude_prim2,
                                 c0, c1)
        rtmin = col(tmin)
        for k in range(K):
            dx, dy, dz = col(dirs[k].x), col(dirs[k].y), col(dirs[k].z)
            cap = col(tcaps[k])
            tc = torch.where(cap > 0, cap, BIG)
            det = dx * m1x + dy * m1y + dz * m1z
            s = torch.where(det < 0.0, -1.0, 1.0)
            dd = det.abs()
            un = (dx * wx + dy * wy + dz * wz) * s
            vn = (dx * qx + dy * qy + dz * qz) * s
            tn = tnum * s
            ok = (dd > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= dd) \
                & (tn > rtmin * dd) & (tn < tc * dd) & not_excl
            hit = ok.any(dim=1)
            out[k * n + c0:k * n + c1] = hit
            if count_tests:
                dead = ((cap > 0) & (cap <= rtmin))[:, 0]
                stop = torch.where(hit, ok.to(torch.uint8).argmax(dim=1)
                                   + 1, T)
                stop = torch.where(dead, 0, stop)
                dir_tests[c0:c1] += stop
                lane_tests[c0:c1] = torch.maximum(lane_tests[c0:c1], stop)
    return (out, lane_tests, dir_tests) if count_tests else out


# call counters: a run can show which path its intersections took
closest_hit_torch.calls = 0
any_hit_torch.calls = 0
any_hit_nee_torch.calls = 0
