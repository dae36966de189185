"""Clustered intersection for scenes above 4,096 triangles
(counterpart of core_tpu/geometry/cluster_intersect.py).

Host build (numpy, as core_tpu's): triangles are split by recursive axis
median into clusters of at most 256 triangles (128 at grouped scale).
Below GROUPED_MIN_CLUSTERS clusters the scene takes the FLAT sweep: every
ray visits every cluster in build order.  At or above it the clusters are
put into groups of GROUP consecutive siblings, ordered near to far from the
camera; each group carries its AABB, its OCTET-cluster union AABBs
("octets") and its clusters' AABBs.  The accels hold the arrays on the
device in the layout the CUDA kernels read (csrc/cluster.cu):

    ClusterAccel  aabb [C, 8]
    GroupedAccel  g_aabb [G, 8]  o_aabb [G, GROUP/8, 8]  c_aabb [G, GROUP, 8]
    both          tris [C, L, 9] f32 (v0, e1, e2)   tri_id [C, L] i32
                  (-1 = pad)   count [C] i32 (real triangles lead each
                  cluster)

Kernels and their plain versions here compute the same functions, in the
same visit order (flat: clusters in build order; grouped: groups, then
octets, then clusters, in build order):

- closest_hit_flat_torch <-> cti_cluster_closest_hit (Pallas _kernel,
  cluster_intersect.py:204) and closest_hit_grouped_torch <->
  cti_grouped_closest_hit (_grouped_kernel, :912): per ray, each level is
  gated by _slab_test with tcap = min(tmax cap, best t); a gated cluster's
  triangles are Möller-Trumbore tested and a hit is kept only if t < best
  t (strict, so ties keep the first visited).
- any_hit_flat_torch <-> cti_cluster_any_hit (_any_kernel, :279) and
  any_hit_grouped_torch <-> cti_grouped_any_hit (_grouped_any_kernel,
  :1129): the same walk gated with the ray's own cap, the division-free,
  sign-folded test, ending at the first hit.
- any_hit_nee_flat_torch <-> cti_cluster_any_hit_nee (_any_nee_kernel,
  :342): K shadow rays per lane sharing one origin; each direction is gated
  with its own cap, and the origin-only Möller-Trumbore terms are shared
  by the K directions.

The plain versions are vectorised: (ray, cluster) gate pairs, the triangle
tests of the gated pairs, then (closest hit) a replay of the kernel's walk
over each ray's gated clusters in visit order, so that the best-t gates
decide exactly as the kernel's do.  Occlusion is an OR over the gated
clusters and needs no replay.  With `count_tests=True` they also count the
triangle tests the kernel's walk makes, the data-dependent work behind the
kernels' bound.

NEE bundles: on the grouped path every bundle is re-bucketed first
(any_hit_nee_clusters_s): all n*K shadow rays are sorted by _nee_bucket_key
(octahedral direction bin major, origin Morton cell minor), swept in that
order, and the occlusion bits are scattered back.  Bits do not depend on
ray order; the sort only makes neighbouring lanes coherent, as it does for
core_tpu's ray tiles.  On the flat path the bundle goes straight to kernel
6, with no re-bucketing, as core_tpu's flat branch does (:677-686).

Entry points, by core_tpu's names: core_tpu's closest_hit_clusters_s,
any_hit_clusters_s and any_hit_nee_clusters_s are, here, the kernels'
wrappers in cuda_cluster.py (which take the same arguments as the plain
versions below and run them on CPU tensors) and, for grouped NEE,
any_hit_nee_clusters_s; scene._backend picks wrapper or plain version by
intersector and accel.

Not carried over (TPU workarounds): the [rows, 128] padding, the 16-row
field-major triangle block, the per-tile group order, the SMEM-sized row
chunking of the re-bucketed sweep, the NEE capture hook, the K-sweep
branch, and the interpret plumbing.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from core_tpu_torch.types import Hits
from core_tpu_torch.vec import V3, RaysS

BIG = 3.0e38
CLUSTER = 256                  # triangles per cluster below grouped scale
GROUPED_MIN_CLUSTERS = 1024    # grouped path at or above this (131,584 tris)
GROUP = 64                     # clusters per group
OCTET = 8                      # clusters per octet-union AABB
# elements per [pairs, L] or [rays, G] intermediate of the plain versions
CHUNK_ELEMS = 1 << 23


class ClusterData(NamedTuple):
    """core_tpu's ClusterData, on the host."""
    aabb: np.ndarray      # [C, 8] f32: bmin(3), bmax(3), pad
    tris: np.ndarray      # [C, L, 10] f32: v0, e1, e2, tri_id (-1 = pad)


class GroupedData(NamedTuple):
    """core_tpu's GroupedData, on the host, with the triangle block kept
    [C, L, 10] (core_tpu stores it field-major [C, 16, L] for the TPU)."""
    g_aabb: np.ndarray    # [G, 8]
    c_aabb: np.ndarray    # [G, group, 8] (pads inverted)
    o_aabb: np.ndarray    # [G, group // OCTET, 8]
    tris: np.ndarray      # [G * group, L, 10]


class ClusterAccel(NamedTuple):
    """ClusterData on a device, laid out as the flat kernels read it."""
    aabb: torch.Tensor    # [C, 8] f32
    tris: torch.Tensor    # [C, L, 9] f32
    tri_id: torch.Tensor  # [C, L] i32
    count: torch.Tensor   # [C] i32

    @property
    def leaf(self) -> int:
        return self.tris.shape[1]


class GroupedAccel(NamedTuple):
    """GroupedData on a device, laid out as the kernels read it."""
    g_aabb: torch.Tensor  # [G, 8] f32
    o_aabb: torch.Tensor  # [G, group // OCTET, 8] f32
    c_aabb: torch.Tensor  # [G, group, 8] f32
    tris: torch.Tensor    # [C, L, 9] f32
    tri_id: torch.Tensor  # [C, L] i32
    count: torch.Tensor   # [C] i32

    @property
    def group(self) -> int:
        return self.c_aabb.shape[1]

    @property
    def leaf(self) -> int:
        return self.tris.shape[1]


def build_clusters(verts, tri_vidx, max_leaf: int | None = None
                   ) -> ClusterData:
    """Axis-median recursive partition into <= max_leaf-tri clusters, the
    same numpy code and order as core_tpu's build_clusters.  max_leaf None
    = 256, or 128 at grouped scale."""
    verts = np.asarray(verts, np.float32)
    tri_vidx = np.asarray(tri_vidx, np.int32)
    if max_leaf is None:
        max_leaf = 128 if tri_vidx.shape[0] >= GROUPED_MIN_CLUSTERS * CLUSTER \
            else CLUSTER
    v0 = verts[tri_vidx[:, 0]]
    v1 = verts[tri_vidx[:, 1]]
    v2 = verts[tri_vidx[:, 2]]
    cent = (v0 + v1 + v2) / 3.0
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    T = tri_vidx.shape[0]
    order = np.arange(T)
    clusters = []
    stack = [(0, T)]
    while stack:
        lo, hi = stack.pop()
        if hi - lo <= max_leaf:
            clusters.append(order[lo:hi].copy())
            continue
        ids = order[lo:hi]
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = (lo + hi) // 2
        part = np.argpartition(c[:, axis], mid - lo)
        order[lo:hi] = ids[part]
        stack.append((lo, mid))
        stack.append((mid, hi))

    C = len(clusters)
    aabb = np.zeros((C, 8), np.float32)
    tris = np.zeros((C, max_leaf, 10), np.float32)
    tris[:, :, 9] = -1.0
    for ci, ids in enumerate(clusters):
        aabb[ci, 0:3] = tmin[ids].min(0)
        aabb[ci, 3:6] = tmax[ids].max(0)
        k = len(ids)
        tris[ci, :k, 0:3] = v0[ids]
        tris[ci, :k, 3:6] = v1[ids] - v0[ids]
        tris[ci, :k, 6:9] = v2[ids] - v0[ids]
        tris[ci, :k, 9] = ids.astype(np.float32)
    return ClusterData(aabb=aabb, tris=tris)


def group_clusters(cl: ClusterData, group: int = GROUP,
                   sort_origin=None) -> GroupedData:
    """Pad the clusters to a multiple of `group` and take group and octet
    AABBs over consecutive build-order runs (core_tpu's group_clusters).
    sort_origin (the camera position) orders clusters near to far within
    each group and groups near to far overall."""
    aabb = np.asarray(cl.aabb)
    tris = np.asarray(cl.tris)
    C = aabb.shape[0]
    if sort_origin is not None and C > group:
        so = np.asarray(sort_origin, np.float32)
        cent = 0.5 * (aabb[:, 0:3] + aabb[:, 3:6])
        d = np.linalg.norm(cent - so[None], axis=1)
        n_full = (C // group) * group
        order = np.arange(C)
        for g0 in range(0, n_full, group):
            seg = order[g0:g0 + group]
            order[g0:g0 + group] = seg[np.argsort(d[seg], kind="stable")]
        runs = [order[g0:g0 + group] for g0 in range(0, C, group)]
        runs.sort(key=lambda seg: float(d[seg].min()))
        order = np.concatenate(runs)
        aabb = aabb[order]
        tris = tris[order]
    pad = (-C) % group
    if pad:
        inv = np.zeros((pad, 8), np.float32)
        inv[:, 0:3] = BIG
        inv[:, 3:6] = -BIG
        aabb = np.concatenate([aabb, inv], axis=0)
        tpad = np.zeros((pad, tris.shape[1], 10), np.float32)
        tpad[:, :, 9] = -1.0
        tris = np.concatenate([tris, tpad], axis=0)
    G = aabb.shape[0] // group
    c_aabb = aabb.reshape(G, group, 8)
    g_aabb = np.zeros((G, 8), np.float32)
    g_aabb[:, 0:3] = c_aabb[:, :, 0:3].min(axis=1)
    g_aabb[:, 3:6] = c_aabb[:, :, 3:6].max(axis=1)
    oc = c_aabb.reshape(G, group // OCTET, OCTET, 8)
    o_aabb = np.zeros((G, group // OCTET, 8), np.float32)
    o_aabb[:, :, 0:3] = oc[:, :, :, 0:3].min(axis=2)
    o_aabb[:, :, 3:6] = oc[:, :, :, 3:6].max(axis=2)
    return GroupedData(g_aabb=g_aabb, c_aabb=c_aabb, o_aabb=o_aabb,
                       tris=tris)


def to_device(data: ClusterData | GroupedData, device
              ) -> ClusterAccel | GroupedAccel:
    """The kernels' layout of ClusterData (flat) or GroupedData on
    `device`."""
    ids = data.tris[:, :, 9].astype(np.int32)
    count = (ids >= 0).sum(axis=1).astype(np.int32)
    if not np.array_equal(ids >= 0,
                          np.arange(ids.shape[1])[None] < count[:, None]):
        raise ValueError("each cluster's triangles must come before its pads")

    def t(a, dtype=np.float32):
        return torch.tensor(np.asarray(a, dtype), device=device)

    tri = dict(tris=t(data.tris[:, :, :9]), tri_id=t(ids, np.int32),
               count=t(count, np.int32))
    if isinstance(data, ClusterData):
        return ClusterAccel(aabb=t(data.aabb), **tri)
    return GroupedAccel(g_aabb=t(data.g_aabb), o_aabb=t(data.o_aabb),
                        c_aabb=t(data.c_aabb), **tri)


# ---------------------------------------------------------------------------
# NEE re-bucketing (core_tpu _nee_bucket_key / _rebucketed_any_nee)
# ---------------------------------------------------------------------------

def _spread3(x):
    """Spread a 5-bit int so its bits land at positions 0,3,6,9,12."""
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _cell(a, lo, inv, n):
    """int(clip((a - lo) * inv)) into [0, n-1]; the float is clamped first
    so out-of-range values saturate as XLA's conversion does."""
    return ((a - lo) * inv).clamp(-1.0, float(n)).to(torch.int32) \
        .clamp(0, n - 1)


def _nee_bucket_key(ox, oy, oz, dx, dy, dz, tcap, tmin, g_aabb):
    """int32 sort key: direction bin (6 bits, 8x8 octahedral map) major,
    origin Morton cell (15 bits, 32^3 over the scene bounds) minor.  Dead
    lanes (0 < tcap <= tmin) get the max key 1 << 24."""
    lo = [g_aabb[:, i].min() for i in range(3)]
    inv = [32.0 / (g_aabb[:, 3 + i].max() - lo[i]).clamp_min(1e-6)
           for i in range(3)]
    # octahedral map: (dx, dz) / l1-norm, lower hemisphere folded
    s = (dx.abs() + dy.abs() + dz.abs()).clamp_min(1e-20)
    u = dx / s
    v = dz / s
    su = torch.where(u >= 0, 1.0, -1.0)
    sv = torch.where(v >= 0, 1.0, -1.0)
    neg = dy < 0
    uo = torch.where(neg, (1.0 - v.abs()) * su, u)
    vo = torch.where(neg, (1.0 - u.abs()) * sv, v)
    dbin = _cell(uo * 0.5 + 0.5, 0.0, 8.0, 8) * 8 \
        + _cell(vo * 0.5 + 0.5, 0.0, 8.0, 8)
    morton = (_spread3(_cell(ox, lo[0], inv[0], 32))
              | (_spread3(_cell(oy, lo[1], inv[1], 32)) << 1)
              | (_spread3(_cell(oz, lo[2], inv[2], 32)) << 2))
    key = (dbin << 15) | morton
    dead = (tcap > 0) & (tcap <= tmin)
    return torch.where(dead, 1 << 24, key).to(torch.int32)


def any_hit_nee_clusters_s(acc: GroupedAccel, o3: V3, tmin, dirs, tcaps,
                           exclude_prim, exclude_prim2, any_hit):
    """One occlusion sweep over all n*K NEE rays in _nee_bucket_key order:
    torch.sort of the key, a gather of the carried ray arrays by the sort
    permutation, `any_hit` (the kernel's wrapper or its plain version),
    then a scatter of the bits back.  Returns [K*n] bool, K-major."""
    K = len(dirs)
    ox, oy, oz = o3.x.repeat(K), o3.y.repeat(K), o3.z.repeat(K)
    dx = torch.cat([d.x for d in dirs])
    dy = torch.cat([d.y for d in dirs])
    dz = torch.cat([d.z for d in dirs])
    tc = torch.cat(list(tcaps))
    tm = tmin.repeat(K)
    key = _nee_bucket_key(ox, oy, oz, dx, dy, dz, tc, tm, acc.g_aabb)
    perm = torch.sort(key, stable=True).indices

    def carried(a):
        return None if a is None else a.repeat(K)[perm]

    rays = RaysS(o=V3(ox[perm], oy[perm], oz[perm]),
                 d=V3(dx[perm], dy[perm], dz[perm]), tmin=tm[perm],
                 tmax=tc[perm])
    hit_sorted = any_hit(acc, rays, carried(exclude_prim),
                         carried(exclude_prim2))
    hit = torch.empty_like(hit_sorted)
    hit[perm] = hit_sorted
    return hit


# ---------------------------------------------------------------------------
# plain versions of kernels 4 to 8
# ---------------------------------------------------------------------------

def _inv_dir(d):
    """_slab_test's eps-guarded reciprocal (cluster_intersect.py:189)."""
    eps = 1e-20
    return 1.0 / torch.where(d.abs() < eps, torch.where(d < 0, -eps, eps),
                             d)


def _slab(box, r, tcap):
    """_slab_test (cluster_intersect.py:185-201): box [..., 8] against
    rays r (dict of [...] ray fields broadcast against the boxes)."""
    def axis(i, o, inv):
        q0 = (box[..., i] - o) * inv
        q1 = (box[..., i + 3] - o) * inv
        return torch.minimum(q0, q1), torch.maximum(q0, q1)

    nx, fx = axis(0, r["ox"], r["ix"])
    ny, fy = axis(1, r["oy"], r["iy"])
    nz, fz = axis(2, r["oz"], r["iz"])
    tn = torch.maximum(torch.maximum(nx, ny), torch.maximum(nz, r["tmin"]))
    tf = torch.minimum(torch.minimum(fx, fy), torch.minimum(fz, tcap))
    return tn <= tf


def _ray_fields(rays_s, exclude_prim, exclude_prim2, tcap):
    n = rays_s.tmin.shape[0]
    none = torch.full((n,), -2, dtype=torch.int32, device=tcap.device)
    return {"ox": rays_s.o.x, "oy": rays_s.o.y, "oz": rays_s.o.z,
            "dx": rays_s.d.x, "dy": rays_s.d.y, "dz": rays_s.d.z,
            "ix": _inv_dir(rays_s.d.x), "iy": _inv_dir(rays_s.d.y),
            "iz": _inv_dir(rays_s.d.z), "tmin": rays_s.tmin, "tcap": tcap,
            "ex0": none if exclude_prim is None else exclude_prim,
            "ex1": none if exclude_prim2 is None else exclude_prim2}


def _take(r, idx, extra_dim=False):
    """The ray fields of lanes idx, as [P] (or [P, 1] columns)."""
    return {k: (v[idx][:, None] if extra_dim else v[idx])
            for k, v in r.items()}


def _cluster_boxes(acc):
    """[C, 8] cluster boxes in cluster order."""
    if isinstance(acc, ClusterAccel):
        return acc.aabb
    return acc.c_aabb.reshape(-1, 8)


def _levels(acc):
    """The gate levels above the clusters, outermost first, as (boxes
    [M, 8], clusters per box): none on the flat path; groups and octets on
    the grouped one."""
    if isinstance(acc, ClusterAccel):
        return ()
    return ((acc.g_aabb, acc.group), (acc.o_aabb.reshape(-1, 8), OCTET))


def _gated_pairs(acc, r):
    """(ray, cluster) pairs whose gates all pass with tcap = the ray's cap,
    sorted by ray then cluster (the visit order)."""
    col = {k: v[:, None] for k, v in r.items()}
    if isinstance(acc, ClusterAccel):
        return _slab(acc.aabb[None], col, col["tcap"]).nonzero(as_tuple=True)
    G = acc.g_aabb.shape[0]
    n_oct = acc.o_aabb.shape[1]
    ri, gi = _slab(acc.g_aabb[None], col, col["tcap"]).nonzero(as_tuple=True)
    rr = _take(r, ri, True)
    pi, oi = _slab(acc.o_aabb[gi], rr, rr["tcap"]).nonzero(as_tuple=True)
    ri, gi = ri[pi], gi[pi]
    rr = _take(r, ri, True)
    boxes = acc.c_aabb.view(G, n_oct, OCTET, 8)[gi, oi]
    qi, ji = _slab(boxes, rr, rr["tcap"]).nonzero(as_tuple=True)
    return ri[qi], (gi[qi] * n_oct + oi[qi]) * OCTET + ji


def _tri_cols(tri):
    return [tri[..., c] for c in range(9)]


def _mt_closest(acc, r, ray, cl):
    """Per gated pair: the cluster's closest accepted triangle (no best-t
    gate), earliest slot on ties.  Returns (t [P] (BIG = none), prim, u,
    v, hit [P])."""
    rr = _take(r, ray, True)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(acc.tris[cl])
    tid = acc.tri_id[cl]
    dx, dy, dz = rr["dx"], rr["dy"], rr["dz"]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det.abs() > 1e-12
    inv_det = 1.0 / torch.where(det_ok, det, 1.0)
    tx = rr["ox"] - v0x
    ty = rr["oy"] - v0y
    tz = rr["oz"] - v0z
    u = (tx * px + ty * py + tz * pz) * inv_det
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    ok = det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) \
        & (t > rr["tmin"]) & (t < rr["tcap"]) & (tid >= 0) \
        & (tid != rr["ex0"]) & (tid != rr["ex1"])
    best, j = torch.where(ok, t, BIG).min(dim=1)
    j1 = j[:, None]
    return (best, tid.gather(1, j1)[:, 0], u.gather(1, j1)[:, 0],
            v.gather(1, j1)[:, 0], ok.any(dim=1))


def _mt_any(acc, r, ray, cl):
    """Per gated pair: (any accepted triangle [P], first accepted slot [P])
    under the division-free, sign-folded test of kernels 5 and 8."""
    rr = _take(r, ray, True)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(acc.tris[cl])
    tid = acc.tri_id[cl]
    dx, dy, dz = rr["dx"], rr["dy"], rr["dz"]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    s = torch.where(det < 0.0, -1.0, 1.0)
    dd = det.abs()
    tx = rr["ox"] - v0x
    ty = rr["oy"] - v0y
    tz = rr["oz"] - v0z
    un = (tx * px + ty * py + tz * pz) * s
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    vn = (dx * qx + dy * qy + dz * qz) * s
    tn = (e2x * qx + e2y * qy + e2z * qz) * s
    ok = (dd > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= dd) \
        & (tn > rr["tmin"] * dd) & (tn < rr["tcap"] * dd) & (tid >= 0) \
        & (tid != rr["ex0"]) & (tid != rr["ex1"])
    return ok.any(dim=1), ok.to(torch.uint8).argmax(dim=1)


def _mt_nee(acc, r, ray, cl):
    """Per gated pair: any accepted triangle [P] under kernel 6's shared-
    origin test (the origin-only terms m1 = e2 x e1, w = e2 x tvec,
    qvec = tvec x e1, tnum = e2 . qvec, then det = d . m1, un = d . w,
    vn = d . qvec), in the kernel's order of arithmetic."""
    rr = _take(r, ray, True)
    v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z = _tri_cols(acc.tris[cl])
    tid = acc.tri_id[cl]
    tx = rr["ox"] - v0x
    ty = rr["oy"] - v0y
    tz = rr["oz"] - v0z
    m1x = e2y * e1z - e2z * e1y
    m1y = e2z * e1x - e2x * e1z
    m1z = e2x * e1y - e2y * e1x
    wx = e2y * tz - e2z * ty
    wy = e2z * tx - e2x * tz
    wz = e2x * ty - e2y * tx
    qx = ty * e1z - tz * e1y
    qy = tz * e1x - tx * e1z
    qz = tx * e1y - ty * e1x
    tnum = e2x * qx + e2y * qy + e2z * qz
    dx, dy, dz = rr["dx"], rr["dy"], rr["dz"]
    det = dx * m1x + dy * m1y + dz * m1z
    s = torch.where(det < 0.0, -1.0, 1.0)
    dd = det.abs()
    un = (dx * wx + dy * wy + dz * wz) * s
    vn = (dx * qx + dy * qy + dz * qz) * s
    tn = tnum * s
    ok = (dd > 1e-12) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= dd) \
        & (tn > rr["tmin"] * dd) & (tn < rr["tcap"] * dd) & (tid >= 0) \
        & (tid != rr["ex0"]) & (tid != rr["ex1"])
    return ok.any(dim=1)


def _pair_chunks(n_pairs: int, leaf: int):
    step = max(1, CHUNK_ELEMS // max(leaf, 1))
    for p0 in range(0, n_pairs, step):
        yield p0, min(n_pairs, p0 + step)


def _ray_chunks(n: int, acc):
    """Ray ranges whose [rays, top-level boxes] gate stays bounded."""
    top = (acc.aabb if isinstance(acc, ClusterAccel) else acc.g_aabb)
    step = max(1, CHUNK_ELEMS // (8 * max(top.shape[0], 1)))
    for c0 in range(0, n, step):
        yield c0, min(n, c0 + step)


def _cap(tmax):
    return torch.where(tmax > 0, tmax, BIG)


def _closest_hit(acc, rays_s, exclude_prim, exclude_prim2, count_tests):
    """Closest hit through either accel (kernels 4 and 7's function)."""
    n = rays_s.tmin.shape[0]
    dev = rays_s.tmin.device
    r_all = _ray_fields(rays_s, exclude_prim, exclude_prim2,
                        _cap(rays_s.tmax))
    t = torch.full((n,), BIG, device=dev)
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    boxes = _cluster_boxes(acc)
    levels = _levels(acc)
    for c0, c1 in _ray_chunks(n, acc):
        r = {k: a[c0:c1] for k, a in r_all.items()}
        ray, cl = _gated_pairs(acc, r)
        parts = [_mt_closest(acc, r, ray[p0:p1], cl[p0:p1])
                 for p0, p1 in _pair_chunks(ray.shape[0], acc.leaf)]
        pt, pp, pu, pv = (torch.cat([p[i] for p in parts]) if parts else
                          torch.empty(0, device=dev) for i in range(4))
        # replay the kernel's walk over each ray's gated clusters, in visit
        # order: the gates of every level with the best t at the moment the
        # kernel tests them
        m = c1 - c0
        cnt = torch.bincount(ray, minlength=m)
        start = torch.cumsum(cnt, 0) - cnt
        bt = torch.full((m,), BIG, device=dev)
        bp = torch.full((m,), -1, dtype=torch.int32, device=dev)
        bu = torch.zeros(m, device=dev)
        bv = torch.zeros(m, device=dev)
        tc = torch.zeros(m, dtype=torch.int64, device=dev)
        # per level: the box the walk is in, and the best t on entering it
        cur = [torch.full((m,), -1, dtype=torch.int64, device=dev)
               for _ in levels]
        bt_in = [bt.clone() for _ in levels]
        for rank in range(int(cnt.max()) if m else 0):
            sel = (cnt > rank).nonzero(as_tuple=True)[0]
            pidx = start[sel] + rank
            c = cl[pidx]
            b = bt[sel]
            rr = _take(r, sel)
            cap = rr["tcap"]
            gate = _slab(boxes[c], rr, torch.minimum(cap, b))
            for li, (lboxes, per) in enumerate(levels):
                j = c // per
                bt_in[li][sel] = torch.where(j != cur[li][sel], b,
                                             bt_in[li][sel])
                cur[li][sel] = j
                gate = gate & _slab(lboxes[j], rr,
                                    torch.minimum(cap, bt_in[li][sel]))
            tc[sel] += torch.where(gate, acc.count[c].long(), 0)
            take = gate & (pt[pidx] < b)
            bt[sel] = torch.where(take, pt[pidx], b)
            bp[sel] = torch.where(take, pp[pidx], bp[sel])
            bu[sel] = torch.where(take, pu[pidx], bu[sel])
            bv[sel] = torch.where(take, pv[pidx], bv[sel])
        t[c0:c1], prim[c0:c1], u[c0:c1], v[c0:c1] = bt, bp, bu, bv
        tests[c0:c1] = tc
    hits = Hits(t=torch.where(prim < 0, -1.0, t), prim=prim, u=u, v=v)
    return (hits, tests) if count_tests else hits


def _stop_counts(acc, ray, cl, has, first, m):
    """Triangle tests of a walk that ends at the first accepted triangle of
    the first cluster (in visit order) that has one: every triangle of the
    clusters before it, and the slots up to the accepted one."""
    dev = ray.device
    pos = torch.arange(ray.shape[0], device=dev)
    stop = torch.full((m,), ray.shape[0], dtype=torch.int64, device=dev)
    stop.scatter_reduce_(0, ray[has], pos[has], "amin")
    full = pos < stop[ray]
    per = torch.where(full, acc.count[cl].long(),
                      torch.where(pos == stop[ray], first + 1, 0))
    return torch.zeros(m, dtype=torch.int64, device=dev).index_add(0, ray,
                                                                    per)


def _any_hit(acc, rays_s, exclude_prim, exclude_prim2, count_tests):
    """Occlusion through either accel (kernels 5 and 8's function)."""
    n = rays_s.tmin.shape[0]
    dev = rays_s.tmin.device
    r_all = _ray_fields(rays_s, exclude_prim, exclude_prim2,
                        _cap(rays_s.tmax))
    hit = torch.zeros(n, dtype=torch.bool, device=dev)
    tests = torch.zeros(n, dtype=torch.int64, device=dev)
    for c0, c1 in _ray_chunks(n, acc):
        r = {k: a[c0:c1] for k, a in r_all.items()}
        ray, cl = _gated_pairs(acc, r)
        parts = [_mt_any(acc, r, ray[p0:p1], cl[p0:p1])
                 for p0, p1 in _pair_chunks(ray.shape[0], acc.leaf)]
        if not parts:
            continue
        has = torch.cat([p[0] for p in parts])
        m = c1 - c0
        hit[c0:c1] = torch.zeros(m, dtype=torch.int32, device=dev) \
            .index_add(0, ray, has.to(torch.int32)) > 0
        if count_tests:
            tests[c0:c1] = _stop_counts(acc, ray, cl, has,
                                        torch.cat([p[1] for p in parts]), m)
    return (hit, tests) if count_tests else hit


def closest_hit_flat_torch(acc: ClusterAccel, rays_s, exclude_prim=None,
                           exclude_prim2=None, count_tests=False):
    """Closest hit through the flat accel (kernel 4's function).  Returns
    Hits, or (Hits, triangle tests per ray) with count_tests."""
    closest_hit_flat_torch.calls += 1
    return _closest_hit(acc, rays_s, exclude_prim, exclude_prim2,
                        count_tests)


def closest_hit_grouped_torch(acc: GroupedAccel, rays_s, exclude_prim=None,
                              exclude_prim2=None, count_tests=False):
    """Closest hit through the grouped accel (kernel 7's function).
    Returns Hits, or (Hits, triangle tests per ray) with count_tests."""
    closest_hit_grouped_torch.calls += 1
    return _closest_hit(acc, rays_s, exclude_prim, exclude_prim2,
                        count_tests)


def any_hit_flat_torch(acc: ClusterAccel, rays_s, exclude_prim=None,
                       exclude_prim2=None, count_tests=False):
    """Occlusion through the flat accel (kernel 5's function), one ray per
    lane, tmax <= 0 = open.  Returns [N] bool, or (bits, triangle tests
    per ray) with count_tests."""
    any_hit_flat_torch.calls += 1
    return _any_hit(acc, rays_s, exclude_prim, exclude_prim2, count_tests)


def any_hit_grouped_torch(acc: GroupedAccel, rays_s, exclude_prim=None,
                          exclude_prim2=None, count_tests=False):
    """Occlusion through the grouped accel (kernel 8's function), one ray
    per lane, tmax <= 0 = open.  Returns [N] bool, or (bits, triangle
    tests per ray) with count_tests."""
    any_hit_grouped_torch.calls += 1
    return _any_hit(acc, rays_s, exclude_prim, exclude_prim2, count_tests)


def any_hit_nee_flat_torch(acc: ClusterAccel, o3: V3, tmin, dirs, tcaps,
                           exclude_prim=None, exclude_prim2=None,
                           count_tests=False):
    """Occlusion of K shadow rays per lane sharing one origin through the
    flat accel (kernel 6's function).  o3: V3 of [N]; tmin: [N]; dirs: K V3
    of [N]; tcaps: K [N] (<= 0 = open).  Returns [K*N] bool, sample-major,
    or with count_tests (bits, lane tests [N], direction tests [N]).

    The kernel walks the clusters once per lane: direction k is gated by
    its own slab test while it has no hit yet, and a cluster any direction
    passes has its triangles' origin terms computed once (a lane test) and
    the passing directions tested (direction tests).  The bits are an OR
    over each direction's gated clusters, so they need no replay."""
    any_hit_nee_flat_torch.calls += 1
    K = len(dirs)
    n = tmin.shape[0]
    dev = tmin.device
    C = acc.aabb.shape[0]
    hit = torch.zeros(K * n, dtype=torch.bool, device=dev)
    lane_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    dir_tests = torch.zeros(n, dtype=torch.int64, device=dev)
    fields = [_ray_fields(RaysS(o=o3, d=d, tmin=tmin, tmax=tc),
                          exclude_prim, exclude_prim2, _cap(tc))
              for d, tc in zip(dirs, tcaps)]
    for c0, c1 in _ray_chunks(n, acc):
        m = c1 - c0
        walked = []
        for k in range(K):
            r = {f: a[c0:c1] for f, a in fields[k].items()}
            ray, cl = _gated_pairs(acc, r)
            has = torch.cat([_mt_nee(acc, r, ray[p0:p1], cl[p0:p1])
                             for p0, p1 in _pair_chunks(ray.shape[0],
                                                        acc.leaf)]
                            or [torch.zeros(0, dtype=torch.bool,
                                            device=dev)])
            hit[k * n + c0:k * n + c1] = torch.zeros(
                m, dtype=torch.int32, device=dev).index_add(
                0, ray, has.to(torch.int32)) > 0
            if count_tests:
                # the direction stays live up to its first hit cluster
                first = torch.full((m,), C, dtype=torch.int64, device=dev)
                first.scatter_reduce_(0, ray[has], cl[has], "amin")
                keep = cl <= first[ray]
                walked.append(ray[keep] * C + cl[keep])
        if count_tests and walked:
            pairs = torch.cat(walked)
            per = acc.count[pairs % C].long()
            dir_tests[c0:c1] = torch.zeros(
                m, dtype=torch.int64, device=dev).index_add(0, pairs // C,
                                                            per)
            lane = torch.unique(pairs)
            lane_tests[c0:c1] = torch.zeros(
                m, dtype=torch.int64, device=dev).index_add(
                0, lane // C, acc.count[lane % C].long())
    return (hit, lane_tests, dir_tests) if count_tests else hit


closest_hit_flat_torch.calls = 0
closest_hit_grouped_torch.calls = 0
any_hit_flat_torch.calls = 0
any_hit_grouped_torch.calls = 0
any_hit_nee_flat_torch.calls = 0
