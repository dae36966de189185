"""Build and load the port's CUDA kernels.

The sources under csrc/ are compiled with nvcc into one shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds).  Each .cu file is compiled by its own nvcc process, all
started together, and the objects are then linked.  The build runs at first
use, from the sources in the checkout only, into build/core_tpu_torch/
beside the package.  The library's name carries a hash of the sources and
flags, so an edit rebuilds.  A failed build raises with nvcc's output.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "core_tpu_torch"
# --fmad=false: no FMA contraction, so the kernels round every product like
# their plain PyTorch versions (see the note in csrc/intersect.cu)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas=-v", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "cti_closest_hit": ([_P, _I] + [_P] * 14 + [_I, _P], _I),
    "cti_any_hit": ([_P, _I] + [_P] * 11 + [_I, _P], _I),
    "cti_any_hit_nee": ([_P, _I] + [_P] * 6 + [_I, _P, _P, _I, _P], _I),
    "cti_cluster_closest_hit": ([_P] * 4 + [_I] * 2 + [_P] * 14 + [_I, _P],
                                _I),
    "cti_cluster_any_hit": ([_P] * 4 + [_I] * 2 + [_P] * 11 + [_I, _P], _I),
    "cti_cluster_any_hit_nee": ([_P] * 4 + [_I] * 2 + [_P] * 11
                                + [_I] * 2 + [_P], _I),
    "cti_grouped_closest_hit": ([_P] * 6 + [_I] * 3 + [_P] * 14 + [_I, _P],
                                _I),
    "cti_grouped_any_hit": ([_P] * 6 + [_I] * 3 + [_P] * 11 + [_I, _P], _I),
    "cti_error_string": ([_I], ctypes.c_char_p),
}


def _sources():
    return sorted(SRC_DIR.glob("*.cu")) + sorted(SRC_DIR.glob("*.cuh"))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit on PATH or in CUDA_HOME")


def library_path(sources=None) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources() if sources is None else sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcore_tpu_torch_{h.hexdigest()[:16]}.so"


def build(sources=None) -> tuple[Path, float]:
    """Compile the kernels (csrc/, or the given .cu/.cuh paths) if their
    library is missing.  Returns (library path, seconds spent compiling;
    0.0 when cached)."""
    sources = _sources() if sources is None else [Path(s) for s in sources]
    lib = library_path(sources)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = [s for s in sources if s.suffix == ".cu"]
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # compile into a private directory and rename the library into place,
    # so concurrent builders never load a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj,
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        logs = [p.communicate()[0] for p in procs]
        link = subprocess.run([nvcc, "-shared", "-o",
                               os.path.join(tmp, "lib.so"), *objs],
                              capture_output=True, text=True) \
            if all(p.returncode == 0 for p in procs) else None
        if link is None or link.returncode != 0:
            codes = [p.returncode for p in procs]
            raise RuntimeError(f"nvcc failed (exits {codes}):\n"
                               + "\n".join(logs)
                               + ("" if link is None else link.stderr))
        lib.with_suffix(".log").write_text("".join(
            f"== {src.name}\n{log}" for src, log in zip(cu, logs)))
        os.replace(os.path.join(tmp, "lib.so"), lib)
    return lib, time.perf_counter() - t0


def open_library(path) -> ctypes.CDLL:
    """A built library, with the entry points' argtypes declared."""
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with argtypes declared."""
    return open_library(build()[0])


def check(lib, code: int, what: str):
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.cti_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
