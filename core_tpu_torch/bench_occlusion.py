"""Kernels 6 and 8 of this checkout against other builds of them, timed in
turns on the same captured main-path inputs, on one card.

    python3 -m core_tpu_torch.bench_occlusion --parent DIR [--alt NAME=FILE]

Run from the root of the checkout (it reuses chip_smoke.py's scene builds
and captures).  --parent DIR: a checkout of the parent commit; its
core_tpu_torch/csrc/*.cu are built into a library of their own, and its
kernel 6 is called through its own C interface (K direction pointers per
lane).  --alt NAME=FILE (repeatable): a cluster.cu with this checkout's C
interface, built beside this checkout's intersect.cu, for another design of
kernel 6 or 8.

Inputs: every NEE bundle of one 256^2 mesh_scene chunk (kernel 6: IBL
K=16 and sun K=8 at the camera hit and at the glossy-chain hit, 65,536
lanes, 512 clusters) and every re-bucketed bundle of one 1024^2 big_scene
chunk (kernel 8: IBL and sun at both hits), as chip_smoke.py captures
them.  Each version's time
is the median of `--reps` launches (CUDA events); the versions are visited
in rounds, forward then backward, and the median over the rounds is
printed.  Every output is held against the plain version (kernel 6: every
ray; kernel 8: a 65,536-ray subset) and against this checkout's kernel on
every ray.  Also timed: kernel 6's wrapper (stacking the directions and
the launch) and kernel 8's re-bucketing (key, sort, gathers and scatter).
The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from core_tpu_torch import _build
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster as cc
from core_tpu_torch.geometry import cuda_intersect as ck

_P = ctypes.c_void_p
_I = ctypes.c_int
# kernel 6's C interface before its redesign: per-lane directions as 4*K
# pointers
_OLD_NEE = [_P] * 4 + [_I] * 2 + [_P] * 6 + [_I, _P, _P, _I, _P]


def _ptxas(path: Path, tag: str):
    """Print the ptxas lines of kernels 6 and 8 in a build's log."""
    log = path.with_suffix(".log")
    name = None
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1) if re.search(
                r"any_hit_nee_kernel|grouped_any_hit_kernel",
                m.group(1)) else None
        elif name and ("Used" in ln or "spill" in ln):
            print(f"ptxas {tag} {name}: {ln.split(':', 1)[-1].strip()}")


def _libs(parent, alts):
    """{name: (library, interface)}: this checkout's ("new"), the parent's
    ("old" interface of kernel 6) and the alternatives."""
    new_path, _ = _build.build()
    _ptxas(new_path, "new")
    libs = {"new": (_build.load_library(), "new")}
    if parent:
        path, _ = _build.build(sorted(
            (Path(parent) / "core_tpu_torch" / "csrc").glob("*.cu")))
        _ptxas(path, "parent")
        lib = _build.open_library(path)
        lib.cti_cluster_any_hit_nee.argtypes = _OLD_NEE
        libs["parent"] = (lib, "old")
    for alt in alts:
        name, src = alt.split("=", 1)
        path, _ = _build.build([Path(src), _build.SRC_DIR / "intersect.cu"])
        _ptxas(path, name)
        libs[name] = (_build.open_library(path), "new")
    return libs


def _nee_runs(libs, acc, o3, tmin, dirs, tcaps, ex0, ex1):
    """{version: fn() -> [K*n] bits} of kernel 6 on one bundle."""
    n, K = tmin.shape[0], len(dirs)
    dev = tmin.device
    args = cc._flat_args(acc)
    shared, ptr_array = ck.nee_ptrs(o3, tmin, dirs, tcaps, ex0, ex1, n, dev)
    stacked = [torch.stack([getattr(d, f) for d in dirs]) for f in "xyz"] \
        + [torch.stack(list(tcaps))]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make(lib, iface):
        hit = torch.empty(K * n, dtype=torch.bool, device=dev)

        def run():
            # the stacked directions stay referenced here while the runs live
            if iface == "old":
                err = lib.cti_cluster_any_hit_nee(
                    *args, *shared, K, ptr_array, hit.data_ptr(), n, stream)
            else:
                err = lib.cti_cluster_any_hit_nee(
                    *args, *shared, *[a.data_ptr() for a in stacked],
                    hit.data_ptr(), n, K, stream)
            _build.check(lib, err, "cti_cluster_any_hit_nee")
            return hit
        return run
    return {name: make(lib, iface) for name, (lib, iface) in libs.items()}


def _grouped_runs(libs, acc, rays, ex0, ex1):
    n = rays.tmin.shape[0]
    dev = rays.tmin.device
    args = cc._grouped_args(acc)
    ptrs = ck.ray_ptrs(rays, ex0, ex1, n, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make(lib):
        hit = torch.empty(n, dtype=torch.bool, device=dev)

        def run():
            _build.check(lib, lib.cti_grouped_any_hit(
                *args, *ptrs, hit.data_ptr(), n, stream),
                "cti_grouped_any_hit")
            return hit
        return run
    return {name: make(lib) for name, (lib, _) in libs.items()}


def _in_turns(runs, reps, rounds):
    """{version: median ms}: rounds of forward-then-backward visits."""
    import statistics
    from chip_smoke import cuda_time_ms
    names = list(runs)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(cuda_time_ms(runs[k], reps, warmup=1)[0])
    return {k: statistics.median(v) for k, v in times.items()}


def _check(runs, want, idx=None, what=""):
    """Every version's bits equal the plain bits (on idx) and this
    checkout's bits (everywhere)."""
    ref = runs["new"]()
    torch.cuda.synchronize()
    ref = ref.clone()
    for k, fn in runs.items():
        got = fn()
        torch.cuda.synchronize()
        sub = got if idx is None else got[idx]
        if not torch.equal(sub, want) or not torch.equal(got, ref):
            raise RuntimeError(f"{what}: {k} differs from the plain version "
                               f"or this checkout's kernel")


def main():
    from chip_smoke import (BIG_IBL, BIG_RES, MESH_RES, SUBSET,
                            _capture_calls, _capture_chunk, _subset,
                            cuda_time_ms, phase_big_build, phase_mesh_build)
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--alt", action="append", default=[])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_occlusion: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    libs = _libs(a.parent, a.alt)
    out = {"card": smi, "kernel6": {}, "kernel8": {}}

    scene, _ = phase_mesh_build(MESH_RES)
    nees = [c for c in _capture_calls(scene, MESH_RES) if c[0] == "nee"]
    for i, (_, args, kw) in enumerate(nees):
        acc, o3, tmin, dirs, tcaps = args
        K = len(dirs)
        label = f"mesh {'IBL' if K == 16 else 'sun'} K={K} " \
            f"({'camera' if i < len(nees) // 2 else 'glossy-chain'} hit)"
        ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
        runs = _nee_runs(libs, acc, o3, tmin, dirs, tcaps, ex0, ex1)
        want = ci.any_hit_nee_flat_torch(acc, o3, tmin, dirs, tcaps, ex0, ex1)
        _check(runs, want, what=label)
        ms = _in_turns(runs, a.reps, a.rounds)
        ms["wrapper"] = cuda_time_ms(lambda: cc.any_hit_nee_flat_cuda(
            acc, o3, tmin, dirs, tcaps, ex0, ex1), a.reps, warmup=1)[0]
        print(f"kernel 6, {label}, {tmin.shape[0]} lanes: "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()))
        out["kernel6"][label] = ms
    del scene, nees, runs
    torch.cuda.empty_cache()

    scene, _ = phase_big_build(BIG_RES)
    acc = scene.accel
    calls = _capture_chunk(scene)
    anys = [c for c in calls if c[0] == "any"]
    nees = [c for c in calls if c[0] == "nee"]
    n_pix = BIG_RES * BIG_RES
    gen = torch.Generator(device="cuda").manual_seed(7)
    for i, ((_, rays, ex0, ex1), nee) in enumerate(zip(anys, nees)):
        n = rays.tmin.shape[0]
        K = n // n_pix
        label = f"big {'IBL' if K == 2 * BIG_IBL else 'sun'} K={K} " \
            f"({'camera' if i < len(anys) // 2 else 'glossy-chain'} hit)"
        runs = _grouped_runs(libs, acc, rays, ex0, ex1)
        idx = torch.randperm(n, generator=gen, device="cuda")[:SUBSET] \
            .sort().values
        want = ci.any_hit_grouped_torch(acc, *_subset(rays, ex0, ex1, idx))
        _check(runs, want, idx, label)
        ms = _in_turns(runs, a.reps, a.rounds)
        _, o3, tmin, dirs, tcaps, e0, e1 = nee

        def no_sweep(acc_, r, *x):
            return torch.zeros(r.tmin.shape[0], dtype=torch.bool,
                               device="cuda")
        ms["re-bucketing (key, sort, gathers, scatter)"] = cuda_time_ms(
            lambda: ci.any_hit_nee_clusters_s(acc, o3, tmin, dirs, tcaps, e0,
                                              e1, no_sweep), a.reps,
            warmup=1)[0]
        print(f"kernel 8, {label}, {n} rays: "
              + ", ".join(f"{k_} {v:.4f} ms" for k_, v in ms.items()))
        out["kernel8"][label] = ms
    print(json.dumps(out))


if __name__ == "__main__":
    main()
