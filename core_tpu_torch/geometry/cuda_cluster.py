"""Wrappers of the cluster CUDA kernels (counterpart of the kernel entry
points of core_tpu/geometry/cluster_intersect.py).

Flat sweep (ClusterAccel, scenes of fewer than 1,024 clusters):
closest_hit_flat_cuda     launches cti_cluster_closest_hit, the port of
                          cluster_intersect.py:_kernel.
any_hit_flat_cuda         launches cti_cluster_any_hit, the port of
                          cluster_intersect.py:_any_kernel.
any_hit_nee_flat_cuda     launches cti_cluster_any_hit_nee, the port of
                          cluster_intersect.py:_any_nee_kernel.
Grouped walk (GroupedAccel):
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
from core_tpu_torch.geometry.cuda_intersect import _on_cpu, _stream, \
    nee_ptrs, ray_ptrs
from core_tpu_torch.types import Hits

# the flat kernels stage all cluster boxes in shared memory (32 B each)
FLAT_MAX_CLUSTERS = ci.GROUPED_MIN_CLUSTERS - 1


def _check_fields(want, dev):
    for name, t, dtype, shape in want:
        # kernels 5-8 copy the tables, 7 and 8 the boxes, in 16-byte pieces
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"accel.{name}: expected a contiguous, 16-byte "
                             f"aligned {dtype} {list(shape)} tensor on {dev}, "
                             f"got {t.dtype} {list(t.shape)} on {t.device}")
    return [t.data_ptr() for _, t, _, _ in want]


def _tri_fields(acc, C):
    leaf = acc.leaf
    return (("tris", acc.tris, torch.float32, (C, leaf, 9)),
            ("tri_id", acc.tri_id, torch.int32, (C, leaf)),
            ("count", acc.count, torch.int32, (C,)))


def _flat_args(acc: ci.ClusterAccel):
    """Checked pointers and sizes of the flat accel, in the C argument
    order."""
    C = acc.aabb.shape[0]
    if not 0 < C <= FLAT_MAX_CLUSTERS:
        raise ValueError(f"the flat cluster kernels take 1 to "
                         f"{FLAT_MAX_CLUSTERS} clusters, got {C}")
    want = (("aabb", acc.aabb, torch.float32, (C, 8)),) + _tri_fields(acc, C)
    return _check_fields(want, acc.tris.device) + [C, acc.leaf]


def _grouped_args(acc: ci.GroupedAccel):
    """Checked pointers and sizes of the grouped accel, in the C argument
    order."""
    G, n_oct, _ = acc.o_aabb.shape
    group = acc.group
    want = (("g_aabb", acc.g_aabb, torch.float32, (G, 8)),
            ("o_aabb", acc.o_aabb, torch.float32, (G, n_oct, 8)),
            ("c_aabb", acc.c_aabb, torch.float32, (G, group, 8))) \
        + _tri_fields(acc, G * group)
    if group % ci.OCTET or n_oct * ci.OCTET != group:
        raise ValueError(f"accel group size {group} is not {n_oct} octets "
                         f"of {ci.OCTET}")
    return _check_fields(want, acc.tris.device) + [G, group, acc.leaf]


def _closest(fn, name, args, rays_s, exclude_prim, exclude_prim2, dev):
    n = rays_s.tmin.shape[0]
    ptrs = ray_ptrs(rays_s, exclude_prim, exclude_prim2, n, dev)
    t = torch.empty(n, dtype=torch.float32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=torch.float32, device=dev)
    v = torch.empty(n, dtype=torch.float32, device=dev)
    if n:
        lib = _build.load_library()
        err = getattr(lib, name)(*args, *ptrs, t.data_ptr(), prim.data_ptr(),
                                 u.data_ptr(), v.data_ptr(), n, _stream(dev))
        _build.check(lib, err, f"{name} launch")
        fn.launches += 1
        fn.lanes += n
    return Hits(t=t, prim=prim, u=u, v=v)


def _any(fn, name, args, rays_s, exclude_prim, exclude_prim2, dev):
    n = rays_s.tmin.shape[0]
    ptrs = ray_ptrs(rays_s, exclude_prim, exclude_prim2, n, dev)
    hit = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        lib = _build.load_library()
        err = getattr(lib, name)(*args, *ptrs, hit.data_ptr(), n,
                                 _stream(dev))
        _build.check(lib, err, f"{name} launch")
        fn.launches += 1
        fn.lanes += n
    return hit


def closest_hit_flat_cuda(acc: ci.ClusterAccel, rays_s, exclude_prim=None,
                          exclude_prim2=None) -> Hits:
    """Flat-sweep closest hit (see
    cluster_intersect.closest_hit_flat_torch for the semantics)."""
    if _on_cpu(acc.tris):
        return ci.closest_hit_flat_torch(acc, rays_s, exclude_prim,
                                         exclude_prim2)
    return _closest(closest_hit_flat_cuda, "cti_cluster_closest_hit",
                    _flat_args(acc), rays_s, exclude_prim, exclude_prim2,
                    acc.tris.device)


def any_hit_flat_cuda(acc: ci.ClusterAccel, rays_s, exclude_prim=None,
                      exclude_prim2=None):
    """Flat-sweep occlusion, one ray per lane (see
    cluster_intersect.any_hit_flat_torch).  Returns [N] bool."""
    if _on_cpu(acc.tris):
        return ci.any_hit_flat_torch(acc, rays_s, exclude_prim,
                                     exclude_prim2)
    return _any(any_hit_flat_cuda, "cti_cluster_any_hit", _flat_args(acc),
                rays_s, exclude_prim, exclude_prim2, acc.tris.device)


def any_hit_nee_flat_cuda(acc: ci.ClusterAccel, o3, tmin, dirs, tcaps,
                          exclude_prim=None, exclude_prim2=None):
    """Flat-sweep shared-origin NEE bundle (see
    cluster_intersect.any_hit_nee_flat_torch).  Returns [K*N] bool,
    sample-major.  The kernel reads the K directions and caps stacked
    sample-major ([K*N])."""
    if _on_cpu(acc.tris):
        return ci.any_hit_nee_flat_torch(acc, o3, tmin, dirs, tcaps,
                                         exclude_prim, exclude_prim2)
    dev = acc.tris.device
    args = _flat_args(acc)
    n = tmin.shape[0]
    shared, _ = nee_ptrs(o3, tmin, dirs, tcaps, exclude_prim, exclude_prim2,
                         n, dev)
    K = len(dirs)
    if K * n >= 2**31:
        raise ValueError(f"kernel 6 takes under 2**31 rays, got {K} x {n}")
    hit = torch.empty(K * n, dtype=torch.bool, device=dev)
    if n:
        stacked = [torch.stack([getattr(d, f) for d in dirs]) for f in "xyz"] \
            + [torch.stack(list(tcaps))]
        lib = _build.load_library()
        err = lib.cti_cluster_any_hit_nee(*args, *shared,
                                          *[a.data_ptr() for a in stacked],
                                          hit.data_ptr(), n, K, _stream(dev))
        _build.check(lib, err, "cti_cluster_any_hit_nee launch")
        any_hit_nee_flat_cuda.launches += 1
        any_hit_nee_flat_cuda.lanes += K * n
    return hit


def closest_hit_grouped_cuda(acc: ci.GroupedAccel, rays_s, exclude_prim=None,
                             exclude_prim2=None) -> Hits:
    """Grouped closest hit (see cluster_intersect.closest_hit_grouped_torch
    for the semantics)."""
    if _on_cpu(acc.tris):
        return ci.closest_hit_grouped_torch(acc, rays_s, exclude_prim,
                                            exclude_prim2)
    return _closest(closest_hit_grouped_cuda, "cti_grouped_closest_hit",
                    _grouped_args(acc), rays_s, exclude_prim, exclude_prim2,
                    acc.tris.device)


def any_hit_grouped_cuda(acc: ci.GroupedAccel, rays_s, exclude_prim=None,
                         exclude_prim2=None):
    """Grouped occlusion, one ray per lane (see
    cluster_intersect.any_hit_grouped_torch).  Returns [N] bool."""
    if _on_cpu(acc.tris):
        return ci.any_hit_grouped_torch(acc, rays_s, exclude_prim,
                                        exclude_prim2)
    return _any(any_hit_grouped_cuda, "cti_grouped_any_hit",
                _grouped_args(acc), rays_s, exclude_prim, exclude_prim2,
                acc.tris.device)


KERNELS = (closest_hit_flat_cuda, any_hit_flat_cuda, any_hit_nee_flat_cuda,
           closest_hit_grouped_cuda, any_hit_grouped_cuda)
PLAIN = (ci.closest_hit_flat_torch, ci.any_hit_flat_torch,
         ci.any_hit_nee_flat_torch, ci.closest_hit_grouped_torch,
         ci.any_hit_grouped_torch)


def reset_counts():
    """Zero the kernels' launch and lane counters and the plain versions'
    call counters."""
    for f in KERNELS:
        f.launches = 0
        f.lanes = 0
    for f in PLAIN:
        f.calls = 0


reset_counts()
