"""ctypes binding of the native BVH builder (counterpart of
core_tpu/native/__init__.py).

csrc/bvh_builder.cpp is compiled with g++ at first use into
build/core_tpu_torch/ beside the package (like the kernels, _build.py),
under a name that carries a hash of the source and flags, so an edit
rebuilds.  A failed build raises with g++'s output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile

import numpy as np

from core_tpu_torch._build import BUILD_DIR, SRC_DIR

SRC = SRC_DIR / "bvh_builder.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path():
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    return BUILD_DIR / f"libcore_tpu_torch_bvh_{h.hexdigest()[:16]}.so"


def build():
    """Compile the builder if its library is missing; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a private directory and rename into place, so concurrent
    # builders never load a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        out = os.path.join(tmp, "lib.so")
        run = subprocess.run(["g++", *GXX_FLAGS, "-o", out, str(SRC)],
                             capture_output=True, text=True)
        if run.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {run.returncode}):\n"
                               + run.stdout + run.stderr)
        os.replace(out, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    i32 = ctypes.c_int32
    lib.core_tpu_build_bvh.restype = i32
    lib.core_tpu_build_bvh.argtypes = [fp, i32, ip, i32, i32, i32, fp, fp,
                                       ip, ip, ip, i32]
    return lib


def build_bvh_native(verts: np.ndarray, tri_vidx: np.ndarray,
                     max_leaf: int = 4, n_bins: int = 16):
    """Binned-SAH build in C++; returns (node_min, node_max, left, count,
    tri_order) numpy arrays in the bvh.BVHData layout."""
    lib = load_library()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tri_vidx, np.int32)
    if verts.ndim != 2 or verts.shape[1] != 3 or tris.ndim != 2 \
            or tris.shape[1] != 3:
        raise ValueError(f"verts {verts.shape} and tri_vidx {tris.shape} "
                         "must be [V, 3] and [T, 3]")
    n_tris = tris.shape[0]
    max_nodes = max(2 * n_tris, 16)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    left = np.empty(max_nodes, np.int32)
    count = np.empty(max_nodes, np.int32)
    order = np.empty(n_tris, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.core_tpu_build_bvh(
        verts.ctypes.data_as(fp), verts.shape[0], tris.ctypes.data_as(ip),
        n_tris, max_leaf, n_bins, node_min.ctypes.data_as(fp),
        node_max.ctypes.data_as(fp), left.ctypes.data_as(ip),
        count.ctypes.data_as(ip), order.ctypes.data_as(ip), max_nodes)
    if n < 0:
        raise RuntimeError("native BVH build failed (no triangles, a vertex "
                           "index out of range, or too many nodes)")
    return node_min[:n], node_max[:n], left[:n], count[:n], order
