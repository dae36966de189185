"""Profile one 1-spp chunk of a configuration chip_smoke.py drives, on the GPU.

    python3 -m core_tpu_torch.profile_chunk            # the Cornell bench
    python3 -m core_tpu_torch.profile_chunk big        # the 1M-tri scene
    python3 -m core_tpu_torch.profile_chunk mesh       # the 73.6k-tri scene

Run from the root of a checkout on a machine with a CUDA card.  "cornell"
renders cornell_box(light_samples=4) with PathOptions(path_samples=8,
bounces=5, raydepth=2) at 256^2; "big" renders big_scene(ibl_samples=4,
sun_samples=2) with DirectOptions(raydepth=1) at 1024^2; "mesh" renders
mesh_scene() at its defaults (256^2, ibl_samples=8, sun_samples=4; the
flat cluster kernels) with DirectOptions(raydepth=1).  It times RUNS
unprofiled chunks on the host clock (each ending in a synchronise), then
profiles one chunk under torch.profiler and prints: the unprofiled median
wall, the profiled wall, device kernel time and launch count per chunk, the
device's busy share against both walls, peak device memory, the kernels and
aten ops with the most device time, and the card's name and power limit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

from core_tpu_torch import film as film_mod
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import (RenderOptions, render_chunk,
                                   scene_material_types)
from core_tpu_torch.scenes import big_scene, cornell_box, mesh_scene

RUNS = 5
TOP = 18


def _config(name):
    """(scene, options) of a named configuration."""
    if name == "cornell":
        return (cornell_box(resx=256, resy=256, light_samples=4,
                            device="cuda"),
                RenderOptions(aa_samples=4, spp_chunk=1,
                              integrator="pathtracing",
                              integrator_opts=PathOptions(
                                  path_samples=8, bounces=5, raydepth=2)))
    direct = RenderOptions(aa_samples=1, spp_chunk=1,
                           integrator="directlight",
                           integrator_opts=DirectOptions(raydepth=1))
    if name == "big":
        return (big_scene(resx=1024, resy=1024, ibl_samples=4,
                          sun_samples=2, device="cuda"), direct)
    if name == "mesh":
        return mesh_scene(device="cuda"), direct
    raise SystemExit(f"profile_chunk: unknown configuration {name!r} "
                     "(cornell, big or mesh)")


def main(name="cornell"):
    if not torch.cuda.is_available():
        raise SystemExit("profile_chunk: needs a CUDA card")

    scene, opts = _config(name)
    types = scene_material_types(scene)
    res_y, res_x = scene.camera.resy, scene.camera.resx

    def chunk():
        with torch.no_grad():
            film = film_mod.make_film(res_y, res_x, device="cuda")
            return render_chunk(scene, types, opts, film, 0, 1, 0)

    for _ in range(2):
        chunk()
    torch.cuda.synchronize()
    walls = []
    for _ in range(RUNS):
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(walls)
    print(f"{name} chunk {res_x}x{res_y}: unprofiled wall ms median "
          f"{med:.3f} over {RUNS} runs, all "
          f"{sorted(round(w, 3) for w in walls)}")

    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    ka = prof.key_averages()
    # device kernels carry device time and are not aten:: op records
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in ka
                   if e.device_time_total > 0
                   and not e.key.startswith("aten::")),
                  key=lambda x: -x[1])
    dev_ms = sum(d for _, d, _ in kern)
    launches = sum(c for _, _, c in kern)
    print(f"profiled chunk: wall {wall:.3f} ms, device kernel time "
          f"{dev_ms:.3f} ms over {launches} kernel launches, busy share "
          f"{dev_ms / wall:.4f} (profiled wall), {dev_ms / med:.4f} "
          f"(unprofiled median wall)")
    print(f"peak device memory {peak_mb:.1f} MiB")
    print("kernels by device time:")
    for k, d, c in kern[:TOP]:
        print(f"  {d:9.3f} ms {c:6d}x  {k[:110]}")
    ops = sorted(((e.key, e.device_time_total / 1e3, e.cpu_time_total / 1e3,
                   e.count) for e in ka if e.key.startswith("aten::")),
                 key=lambda x: -x[1])
    print("aten ops by device time:")
    for k, d, cpu, c in ops[:12]:
        print(f"  {d:9.3f} ms dev {cpu:9.3f} ms cpu {c:6d}x {k}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main(*sys.argv[1:2])
