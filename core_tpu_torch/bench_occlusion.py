"""Kernels 1 to 8 of this checkout against other builds of them, timed in
turns on the same captured main-path inputs, on one card.

    python3 -m core_tpu_torch.bench_occlusion [--parent DIR]
        [--alt NAME=FILE] [--only brute|flat|grouped]

Run from the root of the checkout (it reuses chip_smoke.py's scene builds,
captures and checks).  --parent DIR: a checkout of the parent commit; its
core_tpu_torch/csrc/*.cu are built into a library of their own, called
through the same C interface.  --alt NAME=FILE (repeatable): a .cu file
with this checkout's C interface that takes the place of the checkout's
source of the same file name (cluster.cu or intersect.cu), for another
design of the kernels in it.  --only: the brute kernels 1-3, the flat
4-6 or the grouped 7-8 alone.

Inputs, as chip_smoke.py captures them:
  kernel 1  the six closest-hit calls of one 256^2 Cornell path-trace
            chunk (primary at 65,536 rays, five bounces at 524,288; 36
            triangles), and the two of one 256^2 chunk of the dirac
            variant of mesh_scene at 1,634 triangles (brute: camera and
            glossy chain, 65,536 rays each);
  kernel 2  the six NEE bundles of one 256^2 Cornell path-trace chunk
            (light_samples=4, so K=8; the primary bundle at 65,536 lanes,
            five bounce bundles at 524,288), and chip_smoke's synthetic
            bounce-shape bundle (524,288 lanes, no lane all dead);
  kernel 3  the six shadow wavefronts of the dirac-brute chunk (point,
            spot and directional light at the camera and at the
            glossy-chain hit);
  kernel 4  both closest-hit calls of one 256^2 mesh_scene chunk (camera
            and glossy chain, 512 clusters);
  kernel 5  the six shadow wavefronts of one 256^2 chunk of the dirac
            variant of mesh_scene (73,602 triangles, flat; point, spot and
            directional light at the camera and at the glossy-chain hit);
  kernel 6  every NEE bundle of one 256^2 mesh_scene chunk (IBL K=16 and
            sun K=8 at both hits, 65,536 lanes, 512 clusters);
  kernel 7  both closest-hit calls of one 1024^2 big_scene chunk (camera
            and glossy chain);
  kernel 8  every re-bucketed bundle of that chunk (IBL and sun at both
            hits).
Each input first goes through chip_smoke's check of this checkout's kernel
against the plain version (kernels 1-6: every lane; 7 and 8: a 65,536 lane
subset), which also times the plain version and computes the bound from
its count of the triangle and slab tests.  Then every version's output is
held against this checkout's on every lane, bit for bit, and the versions
are timed through their C entry in rounds, forward then backward: each
visit's time is the device time of one launch (device_ms: the mean of
`--reps` launches queued back to back behind a spin kernel, between CUDA
events), and each version's median over its visits is printed with their
spread (least and most).  Timed alone, one launch at a time (the median of
`--reps`, each between two events, so the host's time to enqueue it counts):
this checkout's kernel through its C entry ("single"), the wrappers of
kernels 1, 2, 3 and 6 (checks, allocation, launch) and kernel 8's
re-bucketing (key, sort, gathers and scatter).  Then, per kernel and
chunk, each version's device time summed over the chunk's calls and
launches x (device time - bound).  The last line is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
from pathlib import Path

import torch

from core_tpu_torch import _build
from core_tpu_torch.geometry import cluster_intersect as ci
from core_tpu_torch.geometry import cuda_cluster as cc
from core_tpu_torch.geometry import cuda_intersect as ck


def _ptxas(path: Path, tag: str):
    """Print the ptxas lines of a build's kernels."""
    from chip_smoke import ptxas_lines
    for kernel, ln in ptxas_lines(path):
        print(f"ptxas {tag} {kernel}: {ln}")


def _libs(parent, alts):
    """{name: library}: this checkout's ("new"), the parent's and the
    alternatives."""
    new_path, _ = _build.build()
    _ptxas(new_path, "new")
    libs = {"new": _build.load_library()}
    if parent:
        path, _ = _build.build(sorted(
            (Path(parent) / "core_tpu_torch" / "csrc").glob("*.cu")))
        _ptxas(path, "parent")
        libs["parent"] = _build.open_library(path)
    for alt in alts:
        name, src = alt.split("=", 1)
        src = Path(src)
        path, _ = _build.build([src] + [s for s in _build._sources()
                                        if s.name != src.name])
        _ptxas(path, name)
        libs[name] = _build.open_library(path)
    return libs


def _runs(libs, entry, lead, outs, trail, dev, keep=()):
    """{version: fn() -> output tensors}: entry(*lead, *outputs, *trail,
    stream) in each library; outs: (dtype, numel) of each output; keep:
    objects behind pointers in lead, held as long as the runs."""
    stream = torch.cuda.current_stream(dev).cuda_stream

    def make(lib):
        bufs = [torch.empty(m, dtype=dt, device=dev) for dt, m in outs]
        fn = getattr(lib, entry)

        def run():
            _build.check(lib, fn(*lead, *[b.data_ptr() for b in bufs],
                                 *trail, stream), entry)
            return bufs
        run.keep = keep
        return run
    return {name: make(lib) for name, lib in libs.items()}


def _ray_runs(libs, entry, args, rays, ex0, ex1, closest):
    n = rays.tmin.shape[0]
    dev = rays.tmin.device
    outs = ([(torch.float32, n), (torch.int32, n), (torch.float32, n),
             (torch.float32, n)] if closest else [(torch.bool, n)])
    return _runs(libs, entry, args + ck.ray_ptrs(rays, ex0, ex1, n, dev),
                 outs, [n], dev)


def _nee_runs(libs, acc, o3, tmin, dirs, tcaps, ex0, ex1):
    n, K = tmin.shape[0], len(dirs)
    dev = tmin.device
    shared, _ = ck.nee_ptrs(o3, tmin, dirs, tcaps, ex0, ex1, n, dev)
    stacked = [torch.stack([getattr(d, f) for d in dirs]) for f in "xyz"] \
        + [torch.stack(list(tcaps))]
    return _runs(libs, "cti_cluster_any_hit_nee",
                 cc._flat_args(acc) + shared + [a.data_ptr() for a in stacked],
                 [(torch.bool, K * n)], [n, K], dev, keep=stacked)


def _brute_nee_runs(libs, tri, o3, tmin, dirs, tcaps, ex0, ex1):
    n, K = tmin.shape[0], len(dirs)
    dev = tmin.device
    shared, ptr_array = ck.nee_ptrs(o3, tmin, dirs, tcaps, ex0, ex1, n, dev)
    return _runs(libs, "cti_any_hit_nee",
                 [tri.data_ptr(), tri.shape[0]] + shared + [K, ptr_array],
                 [(torch.bool, K * n)], [n], dev, keep=(ptr_array,))


# a spin of ~2 ms at the H100's clock: long enough for the host to queue a
# visit's launches behind it
SPIN_CYCLES = 4_000_000


def device_ms(fn, reps):
    """Device time of one launch of fn() in ms: the mean of `reps` launches
    queued back to back behind a spin kernel, between two CUDA events, so
    that the host's time to enqueue them is hidden (a single launch timed
    alone also counts the host's enqueue time)."""
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def _in_turns(runs, reps, rounds):
    """({version: median ms}, {version: [least, most] ms}) over rounds of
    forward-then-backward visits, each visit's time device_ms."""
    names = list(runs)
    times = {k: [] for k in names}
    for _ in range(rounds):
        for k in names + names[::-1]:
            times[k].append(device_ms(runs[k], reps))
    return ({k: statistics.median(v) for k, v in times.items()},
            {k: [min(v), max(v)] for k, v in times.items()})


def _same_everywhere(runs, what):
    """Every version's outputs equal this checkout's on every lane, bit for
    bit."""
    def bits(outs):
        torch.cuda.synchronize()
        return [o.view(torch.int32) if o.dtype == torch.float32 else o.clone()
                for o in outs]
    ref = bits(runs["new"]())
    for k, fn in runs.items():
        got = bits(fn())
        bad = [int((g != r).sum()) for g, r in zip(got, ref)]
        if any(bad):
            raise RuntimeError(f"{what}: {k} differs from this checkout's "
                               f"kernel on {bad} lanes (per output)")


def _row(check, runs, what, a):
    """chip_smoke's row of one input (plain ms, bound) with every version's
    device time in turns, and this checkout's kernel timed alone through
    its C entry ("single": one launch between two events, the host's enqueue
    time included)."""
    from chip_smoke import cuda_time_ms
    _same_everywhere(runs, what)
    row = {"plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
           "bound_by": check["bound_by"]}
    ms, spread = _in_turns(runs, a.reps, a.rounds)
    row.update(ms)
    row["single"] = cuda_time_ms(runs["new"], a.reps, warmup=1)[0]
    row["spread"] = spread
    return row


def _print(kernel, label, lanes, row):
    def fmt(v):
        return f"{v:.4f} ms" if isinstance(v, float) else str(v)
    print(f"kernel {kernel}, {label}, {lanes}: " + ", ".join(
        f"{k} {fmt(v)}" for k, v in row.items() if k != "spread")
        + "; spread " + ", ".join(f"{k} {lo:.4f}-{hi:.4f}"
                                  for k, (lo, hi) in row["spread"].items()))


def _brute_ray_row(libs, a, out, kernel, label, call):
    """Kernel 1 or 3 on one captured call: chip_smoke's check, every
    version in turns through its C entry, and this checkout's wrapper."""
    from chip_smoke import _check_captured, cuda_time_ms
    q, (tri, rays), kw = call
    ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
    check = _check_captured(f"bench: {label}", q, (tri, rays), kw)
    closest = q == "closest"
    runs = _ray_runs(libs, "cti_closest_hit" if closest else "cti_any_hit",
                     [tri.data_ptr(), tri.shape[0]], rays, ex0, ex1, closest)
    row = _row(check, runs, label, a)
    wrapper = ck.closest_hit_cuda if closest else ck.any_hit_cuda
    row["wrapper"] = cuda_time_ms(lambda: wrapper(tri, rays, ex0, ex1),
                                  a.reps, warmup=1)[0]
    _print(kernel, label, f"{rays.tmin.shape[0]} rays", row)
    out[f"kernel{kernel}"][label] = row


def _brute_kernels(libs, a, out):
    """Kernels 1 and 2 on the Cornell chunk (and 2 on the synthetic
    bundle), kernels 1 and 3 on the dirac-brute chunk."""
    from chip_smoke import (AA_SAMPLES, LIGHT_SAMPLES, MESH_RES,
                            PATH_SAMPLES, RES, _capture_calls,
                            _check_captured, _cornell_opts, _nee_bundle,
                            cuda_time_ms, phase_mesh_build)
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=RES, resy=RES, light_samples=LIGHT_SAMPLES,
                        device="cuda")
    calls = _capture_calls(scene, RES, _cornell_opts(AA_SAMPLES))
    for i, call in enumerate(c for c in calls if c[0] == "closest"):
        _brute_ray_row(libs, a, out, 1, f"cornell "
                       f"{'primary' if i == 0 else f'bounce {i}'} closest "
                       "hit", call)
    nees = [c for c in calls if c[0] == "nee"]
    # chip_smoke's synthetic bounce-shape bundle (phase 2's kind: no lane
    # all dead), from a generator of its own
    gen = torch.Generator(device="cuda").manual_seed(1234)
    o3, tmin, dirs, tcaps, ex0, _ = _nee_bundle(
        scene, RES * RES * PATH_SAMPLES, 2 * LIGHT_SAMPLES, gen)
    nees.append(("nee", (scene.tri, o3, tmin, dirs, tcaps),
                 {"exclude_prim": ex0}))
    for i, (q, args, kw) in enumerate(nees):
        tri, o3, tmin, dirs, tcaps = args
        ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
        label = f"cornell {'primary' if i == 0 else f'bounce {i}'} NEE " \
            f"K={len(dirs)}" if i < len(nees) - 1 else \
            f"synthetic bounce-shape NEE K={len(dirs)}"
        check = _check_captured(f"bench: {label}", q, args, kw)
        runs = _brute_nee_runs(libs, tri, o3, tmin, dirs, tcaps, ex0, ex1)
        row = _row(check, runs, label, a)
        row["wrapper"] = cuda_time_ms(lambda: ck.any_hit_nee_cuda(
            tri, o3, tmin, dirs, tcaps, ex0, ex1), a.reps, warmup=1)[0]
        _print(2, label, f"{tmin.shape[0]} lanes", row)
        out["kernel2"][label] = row
    del scene, calls, nees
    scene, _ = phase_mesh_build(MESH_RES, "dirac brute")
    calls = _capture_calls(scene, MESH_RES)
    for i, call in enumerate(c for c in calls if c[0] == "closest"):
        _brute_ray_row(libs, a, out, 1, f"dirac brute "
                       f"{'camera' if i == 0 else 'glossy-chain'} closest "
                       "hit", call)
    for i, call in enumerate(c for c in calls if c[0] == "any"):
        _brute_ray_row(libs, a, out, 3, f"dirac brute "
                       f"{('point', 'spot', 'directional')[i % 3]} light "
                       f"({'camera' if i < 3 else 'glossy-chain'} hit)",
                       call)


def _flat_kernels(libs, a, out):
    from chip_smoke import (MESH_RES, _capture_calls, _check_captured,
                            cuda_time_ms, phase_mesh_build)
    scene, _ = phase_mesh_build(MESH_RES, "dirac flat")
    anys = [c for c in _capture_calls(scene, MESH_RES) if c[0] == "any"]
    for i, (q, args, kw) in enumerate(anys):
        acc, rays = args
        ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
        label = f"dirac {('point', 'spot', 'directional')[i % 3]} " \
            f"light ({'camera' if i < 3 else 'glossy-chain'} hit)"
        check = _check_captured(f"bench: {label}", q, args, kw)
        runs = _ray_runs(libs, "cti_cluster_any_hit", cc._flat_args(acc),
                         rays, ex0, ex1, closest=False)
        row = _row(check, runs, label, a)
        _print(5, label, f"{rays.tmin.shape[0]} rays", row)
        out["kernel5"][label] = row
    del scene, anys
    scene, _ = phase_mesh_build(MESH_RES)
    calls = _capture_calls(scene, MESH_RES)
    closest = [c for c in calls if c[0] == "closest"]
    nees = [c for c in calls if c[0] == "nee"]
    for i, (q, args, kw) in enumerate(closest):
        acc, rays = args
        ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
        label = f"mesh {'camera' if i == 0 else 'glossy-chain'} closest hit"
        check = _check_captured(f"bench: {label}", q, args, kw)
        runs = _ray_runs(libs, "cti_cluster_closest_hit", cc._flat_args(acc),
                         rays, ex0, ex1, closest=True)
        row = _row(check, runs, label, a)
        _print(4, label, f"{rays.tmin.shape[0]} rays", row)
        out["kernel4"][label] = row
    for i, (q, args, kw) in enumerate(nees):
        acc, o3, tmin, dirs, tcaps = args
        K = len(dirs)
        label = f"mesh {'IBL' if K == 16 else 'sun'} K={K} " \
            f"({'camera' if i < len(nees) // 2 else 'glossy-chain'} hit)"
        ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
        check = _check_captured(f"bench: {label}", q, args, kw)
        runs = _nee_runs(libs, acc, o3, tmin, dirs, tcaps, ex0, ex1)
        row = _row(check, runs, label, a)
        row["wrapper"] = cuda_time_ms(lambda: cc.any_hit_nee_flat_cuda(
            acc, o3, tmin, dirs, tcaps, ex0, ex1), a.reps, warmup=1)[0]
        _print(6, label, f"{tmin.shape[0]} lanes", row)
        out["kernel6"][label] = row


def _grouped_kernels(libs, a, out):
    from chip_smoke import (BIG_IBL, BIG_RES, _capture_chunk,
                            _check_big_kernel, cuda_time_ms, phase_big_build)
    scene, _ = phase_big_build(BIG_RES)
    acc = scene.accel
    args = cc._grouped_args(acc)
    calls = _capture_chunk(scene)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for i, (_, rays, ex0, ex1) in enumerate(
            c for c in calls if c[0] == "closest"):
        label = f"big {'camera' if i == 0 else 'glossy-chain'} closest hit"
        check = _check_big_kernel(acc, f"bench: {label}", "closest", rays,
                                  ex0, ex1, gen)
        runs = _ray_runs(libs, "cti_grouped_closest_hit", args, rays, ex0,
                         ex1, closest=True)
        row = _row(check, runs, label, a)
        _print(7, label, f"{rays.tmin.shape[0]} rays", row)
        out["kernel7"][label] = row
    anys = [c for c in calls if c[0] == "any"]
    nees = [c for c in calls if c[0] == "nee"]
    n_pix = BIG_RES * BIG_RES
    for i, ((_, rays, ex0, ex1), nee) in enumerate(zip(anys, nees)):
        n = rays.tmin.shape[0]
        K = n // n_pix
        label = f"big {'IBL' if K == 2 * BIG_IBL else 'sun'} K={K} " \
            f"({'camera' if i < len(anys) // 2 else 'glossy-chain'} hit)"
        check = _check_big_kernel(acc, f"bench: {label}", "any", rays, ex0,
                                  ex1, gen)
        runs = _ray_runs(libs, "cti_grouped_any_hit", args, rays, ex0, ex1,
                         closest=False)
        row = _row(check, runs, label, a)
        _, o3, tmin, dirs, tcaps, e0, e1 = nee

        def no_sweep(acc_, r, *x):
            return torch.zeros(r.tmin.shape[0], dtype=torch.bool,
                               device="cuda")
        row["re-bucketing (key, sort, gathers, scatter)"] = cuda_time_ms(
            lambda: ci.any_hit_nee_clusters_s(acc, o3, tmin, dirs, tcaps, e0,
                                              e1, no_sweep), a.reps,
            warmup=1)[0]
        _print(8, label, f"{n} rays", row)
        out["kernel8"][label] = row


def _gaps(out, versions):
    """Print, per chunk and kernel, each version's time summed over the
    kernel's captured calls of that chunk and launches x (version - bound)
    (chip_smoke's synthetic bundle belongs to no chunk)."""
    for key, rows in out.items():
        if key == "card":
            continue
        chunks = {}
        for label, row in rows.items():
            if not label.startswith("synthetic"):
                chunk = label.split(" ")[0]
                if chunk == "dirac":
                    chunk += " brute" if "brute" in label else " flat"
                chunks.setdefault(chunk, []).append(row)
        for chunk, rs in chunks.items():
            bound = sum(r["bound_ms"] for r in rs)
            print(f"gap: kernel {key[6:]}, {chunk} chunk, {len(rs)} "
                  "launches: " + ", ".join(
                      f"{v} {sum(r[v] for r in rs):.4f} ms (gap "
                      f"{sum(r[v] for r in rs) - bound:.4f})"
                      for v in versions))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent")
    ap.add_argument("--alt", action="append", default=[])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", choices=("brute", "flat", "grouped"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bench_occlusion: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    out = {"card": smi, **{f"kernel{k}": {} for k in range(1, 9)}}
    libs = _libs(a.parent, a.alt)
    for name, fn in (("brute", _brute_kernels), ("flat", _flat_kernels),
                     ("grouped", _grouped_kernels)):
        if a.only in (None, name):
            fn(libs, a, out)
            torch.cuda.empty_cache()
    _gaps(out, list(libs))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
