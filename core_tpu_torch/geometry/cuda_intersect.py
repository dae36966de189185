"""Wrappers of the CUDA intersection kernels (counterpart of
core_tpu/geometry/pallas_intersect.py).

closest_hit_cuda  launches cti_closest_hit, the port of
                  pallas_intersect.py:_intersect_kernel.
any_hit_nee_cuda  launches cti_any_hit_nee, the port of
                  pallas_intersect.py:_any_hit_nee_kernel.

Each wrapper takes the same arguments as its plain version in
geometry/intersect.py.  Given CPU tensors it runs that plain version; given
CUDA tensors it launches its kernel on the current stream, without
synchronising, or raises.  There is no fallback from the kernel to the plain
version.  The wrapper checks device, dtype, shape and contiguity, allocates
the outputs, and counts its launches and lanes (`launches`, `lanes`
attributes) so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from core_tpu_torch import _build
from core_tpu_torch.geometry import intersect as isect
from core_tpu_torch.types import Hits

NEE_K = (2, 4, 8, 16, 32)     # instantiated bundle widths (light_samples 1-16)


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"intersection kernels take CPU or CUDA tensors, "
                         f"not {t.device}")
    return False


def _check(name, t, dtype, n, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device or t.dtype != dtype or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {dtype} [{n}] tensor on {device}, "
            f"got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})")
    return t.data_ptr()


def _ex_ptr(name, ex, n, device):
    return None if ex is None else _check(name, ex, torch.int32, n, device)


def _check_tri(tri):
    if tri.dtype != torch.float32 or tri.dim() != 2 or tri.shape[1] != 9 \
            or not tri.is_contiguous():
        raise ValueError(f"tri: expected a contiguous float32 [T, 9] table, "
                         f"got {tri.dtype} {tuple(tri.shape)}")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def closest_hit_cuda(tri, rays_s, exclude_prim=None,
                     exclude_prim2=None) -> Hits:
    """Closest hit (see intersect.closest_hit_torch for the semantics)."""
    if _on_cpu(tri):
        return isect.closest_hit_torch(tri, rays_s, exclude_prim,
                                       exclude_prim2)
    _check_tri(tri)
    dev = tri.device
    n = rays_s.tmin.shape[0]
    f32 = torch.float32
    comps = [("o.x", rays_s.o.x), ("o.y", rays_s.o.y), ("o.z", rays_s.o.z),
             ("d.x", rays_s.d.x), ("d.y", rays_s.d.y), ("d.z", rays_s.d.z),
             ("tmin", rays_s.tmin), ("tmax", rays_s.tmax)]
    ptrs = [_check(name, a, f32, n, dev) for name, a in comps]
    ex0 = _ex_ptr("exclude_prim", exclude_prim, n, dev)
    ex1 = _ex_ptr("exclude_prim2", exclude_prim2, n, dev)
    t = torch.empty(n, dtype=f32, device=dev)
    prim = torch.empty(n, dtype=torch.int32, device=dev)
    u = torch.empty(n, dtype=f32, device=dev)
    v = torch.empty(n, dtype=f32, device=dev)
    if n:
        lib = _build.load_library()
        err = lib.cti_closest_hit(
            tri.data_ptr(), tri.shape[0], *ptrs, ex0, ex1, t.data_ptr(),
            prim.data_ptr(), u.data_ptr(), v.data_ptr(), n, _stream(dev))
        _build.check(lib, err, "cti_closest_hit launch")
        closest_hit_cuda.launches += 1
        closest_hit_cuda.lanes += n
    return Hits(t=t, prim=prim, u=u, v=v)


def any_hit_nee_cuda(tri, o3, tmin, dirs, tcaps, exclude_prim=None,
                     exclude_prim2=None):
    """Shared-origin NEE occlusion bundle (see intersect.any_hit_nee_torch).
    Returns [K*N] bool, sample-major."""
    if _on_cpu(tri):
        return isect.any_hit_nee_torch(tri, o3, tmin, dirs, tcaps,
                                       exclude_prim, exclude_prim2)
    _check_tri(tri)
    K = len(dirs)
    if K not in NEE_K or len(tcaps) != K:
        raise ValueError(f"NEE bundle width K={K} (with {len(tcaps)} caps) "
                         f"is not one of the compiled widths {NEE_K}")
    dev = tri.device
    n = tmin.shape[0]
    f32 = torch.float32
    shared = [_check(name, a, f32, n, dev) for name, a in
              (("o.x", o3.x), ("o.y", o3.y), ("o.z", o3.z), ("tmin", tmin))]
    ex0 = _ex_ptr("exclude_prim", exclude_prim, n, dev)
    ex1 = _ex_ptr("exclude_prim2", exclude_prim2, n, dev)
    dir_ptrs = ([_check(f"dirs[{k}].x", d.x, f32, n, dev)
                 for k, d in enumerate(dirs)]
                + [_check(f"dirs[{k}].y", d.y, f32, n, dev)
                   for k, d in enumerate(dirs)]
                + [_check(f"dirs[{k}].z", d.z, f32, n, dev)
                   for k, d in enumerate(dirs)]
                + [_check(f"tcaps[{k}]", c, f32, n, dev)
                   for k, c in enumerate(tcaps)])
    hit = torch.empty(K * n, dtype=torch.bool, device=dev)
    if n:
        lib = _build.load_library()
        # the pointer array is read on the host by the C entry point, which
        # copies it into the kernel's parameter block before returning
        ptr_array = (ctypes.c_void_p * (4 * K))(*dir_ptrs)
        err = lib.cti_any_hit_nee(
            tri.data_ptr(), tri.shape[0], *shared, ex0, ex1, K, ptr_array,
            hit.data_ptr(), n, _stream(dev))
        _build.check(lib, err, "cti_any_hit_nee launch")
        any_hit_nee_cuda.launches += 1
        any_hit_nee_cuda.lanes += K * n
    return hit


def reset_counts():
    """Zero the kernels' launch and lane counters and the plain versions'
    call counters."""
    for f in (closest_hit_cuda, any_hit_nee_cuda):
        f.launches = 0
        f.lanes = 0
    isect.closest_hit_torch.calls = 0
    isect.any_hit_nee_torch.calls = 0


reset_counts()
