"""SAH BVH: host-side binned builder and a wavefront traversal (counterpart
of core_tpu/geometry/bvh.py).

The reference traverses a SAH kd-tree per ray with a small stack
(triKdTree_t, src/yafraycore/kdtree.cc).  Here a flattened binary BVH,
built with a binned-SAH sweep (numpy, or the native C++ builder at
NATIVE_THRESHOLD triangles and above, native.py), is walked by the whole
wavefront: each step pops one node per live ray, tests a leaf's
triangles or its children's boxes, and pushes the far child on the ray's
own [STACK_DEPTH] stack (core_tpu/geometry/bvh.py:164-297).  Rays that
finish drop out of the wavefront, so a step costs the live rays only.

A scene takes the BVH only when asked (with_bvh_accel); resolve_intersector
never picks it.  The traversal is plain PyTorch on either device (core_tpu's
is plain JAX, with no Pallas kernel).  Intersection is not a gradient path.

Node encoding (flat arrays, index = node id):
  node_min/node_max [M,3]  the node's box
  left  [M]  inner: left child id (right child = left+1)
             leaf:  ~first (negative), its triangles tri_order[first:]
  count [M]  inner: split axis   leaf: triangle count
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from core_tpu_torch.types import Hits

BIG = 3.0e38
MAX_LEAF = 4
STACK_DEPTH = 48
NATIVE_THRESHOLD = 20000   # the C++ builder from this many triangles on


class BVHData(NamedTuple):
    node_min: torch.Tensor   # [M, 3] float32
    node_max: torch.Tensor   # [M, 3] float32
    left: torch.Tensor       # [M] int64
    count: torch.Tensor      # [M] int64
    tri_order: torch.Tensor  # [T] int64


def to_device(arrays, device) -> BVHData:
    """BVHData on `device` from five arrays in its layout (numpy, this
    package's or core_tpu's)."""
    f32, i64 = torch.float32, torch.int64
    return BVHData(*[torch.tensor(np.asarray(a), dtype=dt, device=device)
                     for a, dt in zip(arrays, (f32, f32, i64, i64, i64))])


def build_bvh(verts, tri_vidx, max_leaf: int = MAX_LEAF, n_bins: int = 16,
              force_native: bool = False, device="cuda") -> BVHData:
    """Binned-SAH top-down build (core_tpu/geometry/bvh.py:47-161), with
    an explicit stack so children are allocated in pairs (right = left +
    1).  At NATIVE_THRESHOLD triangles and above, or with force_native, the
    C++ builder runs (a failed build raises)."""
    verts = np.asarray(verts)
    tri_vidx = np.asarray(tri_vidx)
    if force_native or tri_vidx.shape[0] >= NATIVE_THRESHOLD:
        from core_tpu_torch import native
        return to_device(native.build_bvh_native(
            verts, tri_vidx, max_leaf=max_leaf, n_bins=n_bins), device)
    verts = verts.astype(np.float64)
    tris = tri_vidx.astype(np.int64)
    T = tris.shape[0]
    p0, p1, p2 = verts[tris[:, 0]], verts[tris[:, 1]], verts[tris[:, 2]]
    tmin = np.minimum(np.minimum(p0, p1), p2)
    tmax = np.maximum(np.maximum(p0, p1), p2)
    centroid = (tmin + tmax) * 0.5

    order = np.arange(T)
    node_min, node_max, left, count = [], [], [], []

    def alloc():
        node_min.append(np.zeros(3))
        node_max.append(np.zeros(3))
        left.append(0)
        count.append(0)
        return len(left) - 1

    def grow(mn, mx):
        d = np.maximum(mx - mn, 0.0)
        return d[:, 0] * d[:, 1] + d[:, 1] * d[:, 2] + d[:, 2] * d[:, 0]

    stack = [(alloc(), 0, T)]
    while stack:
        node, lo, hi = stack.pop()
        ids = order[lo:hi]
        node_min[node] = tmin[ids].min(axis=0)
        node_max[node] = tmax[ids].max(axis=0)
        n = hi - lo
        if n <= max_leaf:
            left[node] = ~lo
            count[node] = n
            continue
        cmin = centroid[ids].min(axis=0)
        ext = centroid[ids].max(axis=0) - cmin
        axis = int(np.argmax(ext))
        mid = lo + n // 2         # degenerate extent or no finite cost
        if ext[axis] >= 1e-12:
            scale = n_bins * (1.0 - 1e-6) / ext[axis]
            bins = ((centroid[ids, axis] - cmin[axis]) * scale) \
                .astype(np.int64)
            cnt = np.bincount(bins, minlength=n_bins)
            bb_min = np.full((n_bins, 3), np.inf)
            bb_max = np.full((n_bins, 3), -np.inf)
            for a in range(3):
                np.minimum.at(bb_min[:, a], bins, tmin[ids, a])
                np.maximum.at(bb_max[:, a], bins, tmax[ids, a])
            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcnt = np.cumsum(cnt)
            rcnt = np.cumsum(cnt[::-1])[::-1]
            cost = np.full(n_bins - 1, np.inf)
            for b in range(n_bins - 1):
                if lcnt[b] == 0 or rcnt[b + 1] == 0:
                    continue
                cost[b] = grow(lmin[b:b + 1], lmax[b:b + 1])[0] * lcnt[b] \
                    + grow(rmin[b + 1:b + 2], rmax[b + 1:b + 2])[0] \
                    * rcnt[b + 1]
            best = int(np.argmin(cost))
            if np.isfinite(cost[best]):
                go_left = bins <= best
                li, ri = ids[go_left], ids[~go_left]
                order[lo:lo + len(li)] = li
                order[lo + len(li):hi] = ri
                mid = lo + len(li)
                if mid == lo or mid == hi:
                    mid = lo + n // 2
        lchild, rchild = alloc(), alloc()
        left[node] = lchild
        count[node] = axis if ext[axis] >= 1e-12 else 0
        # push right first so the left child is built next
        stack.append((rchild, mid, hi))
        stack.append((lchild, lo, mid))

    return to_device((np.asarray(node_min, np.float32),
                      np.asarray(node_max, np.float32),
                      np.asarray(left), np.asarray(count), order), device)


def with_bvh_accel(scene, force_native: bool = False):
    """The scene with a BVH built over its triangles as its accel: the
    opt-in (the scene's closest_hit_s / any_hit_s / any_hit_nee_s then
    walk it)."""
    g = scene.geom
    return dataclasses.replace(scene, accel=build_bvh(
        g.verts.detach().cpu().numpy(), g.tri_vidx.cpu().numpy(),
        force_native=force_native, device=scene.device))


def _cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def _dot(a, b):
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


def _mt_single(o, d, rows):
    """Moller-Trumbore of each ray against one gathered triangle row
    ([n, 9]: v0, e1, e2) -> (t, u, v, ok)."""
    v0, e1, e2 = rows[:, 0:3], rows[:, 3:6], rows[:, 6:9]
    pvec = _cross(d, e2)
    det = _dot(e1, pvec)
    safe = det.abs() > 1e-12
    inv_det = torch.where(safe, 1.0 / torch.where(det == 0, 1.0, det), 0.0)
    tvec = o - v0
    u = _dot(tvec, pvec) * inv_det
    qvec = _cross(tvec, e1)
    v = _dot(d, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    ok = safe & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _slab(bmin, bmax, o, inv_d, tmin, tmax):
    """Ray-box test -> (hit, t_near)."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    t_near = torch.maximum(torch.minimum(t0, t1).amax(dim=1), tmin)
    t_far = torch.minimum(torch.maximum(t0, t1).amin(dim=1), tmax)
    return t_near <= t_far, t_near


def _traverse(tri, bvh: BVHData, rays_s, any_hit: bool, exclude_prim=None,
              exclude_prim2=None):
    n = rays_s.tmin.shape[0]
    dev = rays_s.tmin.device
    o = torch.stack(list(rays_s.o), dim=1)
    d = torch.stack(list(rays_s.d), dim=1)
    tmin = rays_s.tmin
    tcap = torch.where(rays_s.tmax > 0, rays_s.tmax, BIG)
    inv_d = 1.0 / torch.where(d.abs() < 1e-20,
                              torch.where(d < 0, -1e-20, 1e-20), d)
    n_tri, n_nodes = bvh.tri_order.shape[0], bvh.left.shape[0]
    out_t = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    out_p = torch.full((n,), -1, dtype=torch.int64, device=dev)
    out_u = torch.zeros(n, dtype=torch.float32, device=dev)
    out_v = torch.zeros_like(out_u)
    lanes = torch.arange(n, device=dev)
    ex = [e.long() for e in (exclude_prim, exclude_prim2) if e is not None]

    # the live rays' state, compacted: lane ids, node, stack, pointer, best
    root, _ = _slab(bvh.node_min[0:1], bvh.node_max[0:1], o, inv_d, tmin,
                    tcap)
    ids = lanes[root]
    node = torch.zeros_like(ids)
    stack = torch.zeros((ids.shape[0], STACK_DEPTH), dtype=torch.int64,
                        device=dev)
    sp = torch.zeros_like(ids)
    t_best, prim = out_t[ids], out_p[ids]
    u_b, v_b = out_u[ids], out_v[ids]
    while ids.numel():
        ro, rd, rinv = o[ids], d[ids], inv_d[ids]
        rmin, rcap = tmin[ids], tcap[ids]
        lf = bvh.left[node]
        cnt = bvh.count[node]
        is_leaf = lf < 0
        first = ~lf
        for k in range(MAX_LEAF):
            test = is_leaf & (k < cnt)
            tid = bvh.tri_order[(first + k).clamp(0, n_tri - 1)]
            t, u, v, ok = _mt_single(ro, rd, tri[tid])
            ok = ok & test & (t > rmin) & (t < rcap) & (t < t_best)
            for e in ex:
                ok = ok & (tid != e[ids])
            t_best = torch.where(ok, t, t_best)
            prim = torch.where(ok, tid, prim)
            u_b = torch.where(ok, u, u_b)
            v_b = torch.where(ok, v, v_b)
        done_now = (prim >= 0) if any_hit else torch.zeros_like(is_leaf)

        # an inner node: test both children, descend to the nearer, push
        # the farther when both are hit
        lc = lf.clamp(0, n_nodes - 1)
        rc = lc + 1
        cap = torch.minimum(rcap, t_best)
        lhit, lt = _slab(bvh.node_min[lc], bvh.node_max[lc], ro, rinv, rmin,
                         cap)
        rhit, rt = _slab(bvh.node_min[rc], bvh.node_max[rc], ro, rinv, rmin,
                         cap)
        lhit = lhit & ~is_leaf
        rhit = rhit & ~is_leaf
        both = lhit & rhit
        near_left = lt <= rt
        near = torch.where(near_left, lc, rc)
        far = torch.where(near_left, rc, lc)
        next_inner = torch.where(both, near, torch.where(
            lhit, lc, torch.where(rhit, rc, -1)))
        slot = sp.clamp(0, STACK_DEPTH - 1)[:, None]
        stack = stack.scatter(1, slot, torch.where(
            both, far, stack.gather(1, slot)[:, 0])[:, None])
        sp = sp + both.long()
        # a leaf or a dead inner node pops the stack
        want_pop = (is_leaf | (next_inner < 0)) & ~done_now
        can_pop = sp > 0
        pop = want_pop & can_pop
        sp = sp - pop.long()
        popped = stack.gather(1, sp.clamp(0, STACK_DEPTH - 1)[:, None])[:, 0]
        node = torch.where(pop, popped, torch.where(~is_leaf, next_inner, 0)) \
            .clamp_min(0)
        alive = ~done_now & torch.where(want_pop, can_pop,
                                        is_leaf | (next_inner >= 0))
        gone = ~alive
        if bool(gone.any()):
            out = ids[gone]
            out_t[out], out_p[out] = t_best[gone], prim[gone]
            out_u[out], out_v[out] = u_b[gone], v_b[gone]
            ids, node, stack, sp = ids[alive], node[alive], stack[alive], \
                sp[alive]
            t_best, prim = t_best[alive], prim[alive]
            u_b, v_b = u_b[alive], v_b[alive]
    if any_hit:
        return out_p >= 0
    miss = out_p < 0
    return Hits(t=torch.where(miss, -1.0, out_t), prim=out_p.to(torch.int32),
                u=out_u, v=out_v)


def closest_hit_bvh(tri, bvh: BVHData, rays_s, exclude_prim=None) -> Hits:
    """Closest hit of each ray (vec.RaysS; tmax <= 0 = open) through the
    BVH over the triangle rows `tri` ([T, 9] v0, e1, e2; Scene.tri)."""
    return _traverse(tri, bvh, rays_s, any_hit=False,
                     exclude_prim=exclude_prim)


def any_hit_bvh(tri, bvh: BVHData, rays_s, exclude_prim=None,
                exclude_prim2=None):
    """Occlusion of each ray through the BVH; [N] bool."""
    return _traverse(tri, bvh, rays_s, any_hit=True,
                     exclude_prim=exclude_prim, exclude_prim2=exclude_prim2)


def any_hit_nee_bvh(tri, bvh: BVHData, o3, tmin, dirs, tcaps,
                    exclude_prim=None, exclude_prim2=None):
    """The NEE bundle (K rays a lane sharing an origin) as one concatenated
    wavefront, as core_tpu answers it off its brute path
    (core_tpu/scene.py:185-226); [K*N] bool, sample-major."""
    from core_tpu_torch.vec import V3, RaysS
    K = len(dirs)
    rays = RaysS(o=V3(*[c.repeat(K) for c in o3]),
                 d=V3(*[torch.cat([getattr(dd, f) for dd in dirs])
                        for f in "xyz"]),
                 tmin=tmin.repeat(K), tmax=torch.cat(list(tcaps)))
    ex0, ex1 = (None if e is None else e.repeat(K)
                for e in (exclude_prim, exclude_prim2))
    return any_hit_bvh(tri, bvh, rays, ex0, ex1)
