"""Wrappers of the grouped-cluster CUDA kernels (counterpart of the grouped
half of core_tpu/geometry/cluster_intersect.py).

closest_hit_grouped_cuda  launches cti_grouped_closest_hit, the port of
                          cluster_intersect.py:_grouped_kernel.
any_hit_grouped_cuda      launches cti_grouped_any_hit, the port of
                          cluster_intersect.py:_grouped_any_kernel.

Each takes the same arguments as its plain version in
geometry/cluster_intersect.py and keeps the rules of cuda_intersect.py:
given CPU tensors it runs the plain version; given CUDA tensors it checks
them, allocates the outputs, launches on the current stream without
synchronising, counts `launches` and `lanes`, and raises on a launch error.
"""
from __future__ import annotations

import torch

from core_tpu_torch import _build
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry.cuda_intersect import _check, _ex_ptr, _on_cpu, \
    _stream
from core_tpu_torch.types import Hits


def _accel_args(acc: ci.GroupedAccel):
    """Checked pointers and sizes of the accel, in the C argument order."""
    G, n_oct, _ = acc.o_aabb.shape
    group, leaf = acc.group, acc.leaf
    C = G * group
    want = (("g_aabb", acc.g_aabb, torch.float32, (G, 8)),
            ("o_aabb", acc.o_aabb, torch.float32, (G, n_oct, 8)),
            ("c_aabb", acc.c_aabb, torch.float32, (G, group, 8)),
            ("tris", acc.tris, torch.float32, (C, leaf, 9)),
            ("tri_id", acc.tri_id, torch.int32, (C, leaf)),
            ("count", acc.count, torch.int32, (C,)))
    dev = acc.tris.device
    for name, t, dtype, shape in want:
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"accel.{name}: expected a contiguous {dtype} "
                             f"{list(shape)} tensor on {dev}, got {t.dtype} "
                             f"{list(t.shape)} on {t.device}")
    if group % ci.OCTET or n_oct * ci.OCTET != group:
        raise ValueError(f"accel group size {group} is not {n_oct} octets "
                         f"of {ci.OCTET}")
    return [t.data_ptr() for _, t, _, _ in want] + [G, group, leaf]


def _ray_ptrs(rays_s, n, dev):
    f32 = torch.float32
    comps = [("o.x", rays_s.o.x), ("o.y", rays_s.o.y), ("o.z", rays_s.o.z),
             ("d.x", rays_s.d.x), ("d.y", rays_s.d.y), ("d.z", rays_s.d.z),
             ("tmin", rays_s.tmin), ("tmax", rays_s.tmax)]
    return [_check(name, a, f32, n, dev) for name, a in comps]


def closest_hit_grouped_cuda(acc: ci.GroupedAccel, rays_s, exclude_prim=None,
                             exclude_prim2=None) -> Hits:
    """Grouped closest hit (see cluster_intersect.closest_hit_grouped_torch
    for the semantics)."""
    if _on_cpu(acc.tris):
        return ci.closest_hit_grouped_torch(acc, rays_s, exclude_prim,
                                            exclude_prim2)
    dev = acc.tris.device
    n = rays_s.tmin.shape[0]
    args = _accel_args(acc) + _ray_ptrs(rays_s, n, dev) + [
        _ex_ptr("exclude_prim", exclude_prim, n, dev),
        _ex_ptr("exclude_prim2", exclude_prim2, n, dev)]
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        lib = _build.load_library()
        err = lib.cti_grouped_closest_hit(
            *args, t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
            n, _stream(dev))
        _build.check(lib, err, "cti_grouped_closest_hit launch")
        closest_hit_grouped_cuda.launches += 1
        closest_hit_grouped_cuda.lanes += n
    return Hits(t=t, prim=prim, u=u, v=v)


def any_hit_grouped_cuda(acc: ci.GroupedAccel, rays_s, exclude_prim=None,
                         exclude_prim2=None):
    """Grouped occlusion, one ray per lane (see
    cluster_intersect.any_hit_grouped_torch).  Returns [N] bool."""
    if _on_cpu(acc.tris):
        return ci.any_hit_grouped_torch(acc, rays_s, exclude_prim,
                                        exclude_prim2)
    dev = acc.tris.device
    n = rays_s.tmin.shape[0]
    args = _accel_args(acc) + _ray_ptrs(rays_s, n, dev) + [
        _ex_ptr("exclude_prim", exclude_prim, n, dev),
        _ex_ptr("exclude_prim2", exclude_prim2, n, dev)]
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = _build.load_library()
        err = lib.cti_grouped_any_hit(*args, hit.data_ptr(), n, _stream(dev))
        _build.check(lib, err, "cti_grouped_any_hit launch")
        any_hit_grouped_cuda.launches += 1
        any_hit_grouped_cuda.lanes += n
    return hit


def reset_counts():
    """Zero the kernels' launch and lane counters and the plain versions'
    call counters."""
    for f in (closest_hit_grouped_cuda, any_hit_grouped_cuda):
        f.launches = 0
        f.lanes = 0
    ci.closest_hit_grouped_torch.calls = 0
    ci.any_hit_grouped_torch.calls = 0


reset_counts()
