#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one GPU: the Cornell box path
traced forward + backward, in Mrays/s, and the 1M-triangle scene's datum
(the counterpart of bench.py, computed by core_tpu_torch on the card).

    python3 bench_cuda.py

Run from the root of a checkout on a machine with a CUDA card.  Prints ONE
JSON line on stdout with bench.py's keys,
  {"metric", "value", "unit", "vs_baseline", "active_lane_fraction",
   "useful_mrays", "kernel_parity", "bigscene_tris", "bigscene_fwd_mrays",
   "bigscene_fwdbwd_mrays"}
plus "bigscene_fwdbwd_res", the resolution the big fwd+bwd ran at.  Its
diagnostics go to stderr as "# bench:" lines: the card's name and power
limit (nvidia-smi), the Cornell step's times, its median with and
without torch.autograd.grad (timed in turns) and the backward's share,
and each phase's peak device memory.

- value: the Cornell box (256^2, light_samples=4, PathOptions(path_samples
  =8, bounces=5, raydepth=2), bench.py:45-50) at 1 spp a step, no folding:
  diff.value_and_grad of the mean squared RGB against a zero target, with
  respect to extract_params(geometry=False); 5 timed steps after one
  warm-up, ending in torch.cuda.synchronize().  Rays are the lanes of every
  closest-hit, any-hit and NEE query of one forward pass, counted at the
  core_tpu_torch.scene entry points (counted_rays).  vs_baseline is value
  over the 80 Mrays/s of bench.py.
- active_lane_fraction: useful / traced lane-rays of the path tracer's
  stats on the 256^2 1-spp raster; useful_mrays = value * that fraction.
- kernel_parity: kernel 1 against its plain version on bench.py's 1,024-ray
  wavefront (bench.py:106-129); "ok" only for identical prims and t within
  rtol 1e-6.
- bigscene_*: big_scene(1024, 1024, ibl_samples=4, sun_samples=2) under
  DirectOptions(raydepth=1): the forward over 3 timed 1-spp chunks after a
  warm-up; the fwd+bwd is value_and_grad of mean(img[..., :3]) with respect
  to extract_params(geometry=False), 3 timed steps after a warm-up.  It
  falls back to 512^2 only on torch.cuda.OutOfMemoryError; any other error
  is raised.

No number falls back to the CPU: without a card the script exits non-zero
and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# --- bench configuration (bench.py:45-50) ---
RES = 256
SPP_PER_STEP = 1
LIGHT_SAMPLES = 4
PATH_SAMPLES = 8
BOUNCES = 5
RAYDEPTH = 2
N_TIMED_STEPS = 5
BASELINE_MRAYS = 80.0

# --- big-scene configuration (bench.py:70-75) ---
BIG_RES = 1024
BIG_IBL_SAMPLES = 4
BIG_SUN_SAMPLES = 2
BIG_TIMED_STEPS = 3


def log(msg):
    print(f"# bench: {msg}", file=sys.stderr, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def sync():
    import torch
    torch.cuda.synchronize()


def counted_rays(fn):
    """Run fn() with the scene-level trace entry points wrapped, counting
    every wavefront lane of every closest-hit, any-hit and NEE shadow query
    (the way bench.py's counted_lanes counts).  Returns (fn(), lanes)."""
    from core_tpu_torch import scene as sm
    counts = {"n": 0}
    orig = (sm.closest_hit_s, sm.any_hit_s, sm.any_hit_nee_s)

    def ch(scene, rays, *a, **k):
        counts["n"] += rays.o.x.numel()
        return orig[0](scene, rays, *a, **k)

    def anyh(scene, rays, *a, **k):
        counts["n"] += rays.o.x.numel()
        return orig[1](scene, rays, *a, **k)

    def nee(scene, origin, tmin, dirs, tcaps, *a, **k):
        counts["n"] += origin.x.numel() * len(dirs)
        return orig[2](scene, origin, tmin, dirs, tcaps, *a, **k)

    sm.closest_hit_s, sm.any_hit_s, sm.any_hit_nee_s = ch, anyh, nee
    try:
        out = fn()
    finally:
        sm.closest_hit_s, sm.any_hit_s, sm.any_hit_nee_s = orig
    return out, counts["n"]


def cornell_scene(res=RES, intersector="auto"):
    from core_tpu_torch.scenes import cornell_box
    return cornell_box(resx=res, resy=res, light_samples=LIGHT_SAMPLES,
                       intersector=intersector, device="cuda")


def cornell_opts(**fold):
    """bench.py's Cornell options; `fold` sets PathOptions' folding fields
    (fold_interval, fold_start, fold_sort)."""
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(integrator="pathtracing", integrator_opts=PathOptions(
        path_samples=PATH_SAMPLES, bounces=BOUNCES, raydepth=RAYDEPTH,
        **fold))


def cornell_loss(scene, **fold):
    """The bench loss (bench.py:166-177): mean squared RGB of one 1-spp
    chunk against a zero target, as a function of the params dict."""
    import torch
    from core_tpu_torch import diff
    cam = scene.camera
    target = torch.zeros((cam.resy, cam.resx, 4), device=scene.device)
    return diff.make_loss_fn(scene, cornell_opts(**fold), SPP_PER_STEP,
                             target)


def forward_step(loss_fn, params):
    """The step without its backward: the loss of leaf copies that require
    grad, so the forward records the same graph as in value_and_grad."""
    import torch
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in params.items()}
    with torch.enable_grad():
        return loss_fn(leaves).detach()


def timed_steps(step, n):
    """Wall seconds of each of n calls of step(), each ending in a
    synchronise."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        step()
        sync()
        out.append(time.perf_counter() - t0)
    return out


def check_kernel_parity() -> str:
    """Kernel 1 against its plain version on bench.py's fixed 1,024-ray
    wavefront: "ok" for identical prims and t within rtol 1e-6."""
    import numpy as np
    import torch
    from core_tpu_torch import vec
    from core_tpu_torch.geometry import cuda_intersect as ck
    from core_tpu_torch.geometry import intersect as isect
    from core_tpu_torch.scenes import cornell_box

    scene = cornell_box(resx=8, resy=8, light_samples=1, device="cuda")
    rng = np.random.default_rng(3)
    n = 1024
    o = (np.array([278.0, 273.0, -500.0], np.float32)
         + rng.normal(0, 40, (n, 3)).astype(np.float32))
    tgt = rng.uniform(50, 500, (n, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = vec.RaysS(o=vec.v3(torch.from_numpy(o).cuda()),
                     d=vec.v3(torch.from_numpy(d).cuda()),
                     tmin=torch.full((n,), 5e-4, device="cuda"),
                     tmax=torch.full((n,), -1.0, device="cuda"))
    hk = ck.closest_hit_cuda(scene.tri, rays)
    hp = isect.closest_hit_torch(scene.tri, rays)
    prim_ok = bool(torch.equal(hk.prim, hp.prim))
    t_ok = bool(((hk.t - hp.t).abs()
                 <= 1e-6 * hp.t.abs().clamp_min(1.0)).all())
    return "ok" if prim_ok and t_ok else "FAIL"


def active_lane_fraction(scene, **fold) -> float:
    """useful / traced lane-rays of the path tracer on the full raster at
    1 spp (bench.py:187-211), under cornell_opts(**fold)."""
    import torch
    from core_tpu_torch.cameras import shoot_ray
    from core_tpu_torch.integrators import path as path_mod
    from core_tpu_torch.render import _pixel_grid_raster, scene_material_types
    from core_tpu_torch.sampling import qmc
    cam = scene.camera
    x, y, s = _pixel_grid_raster(cam.resy, cam.resx, 1, scene.device)
    offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    rays, _ = shoot_ray(cam, x.float() + 0.5, y.float() + 0.5)
    stats = {}
    with torch.no_grad():
        path_mod.integrate(scene, scene_material_types(scene), rays, s,
                           offs, cornell_opts(**fold).integrator_opts,
                           stats=stats)
    return float(stats["useful"]) / stats["traced"]


def bench_cornell():
    """(fwd+bwd Mrays/s, active lane fraction)."""
    import torch
    from core_tpu_torch import diff
    scene = cornell_scene()
    loss_fn = cornell_loss(scene)
    params = diff.extract_params(scene, geometry=False)
    step = diff.value_and_grad(loss_fn)
    with torch.no_grad():
        _, rays = counted_rays(lambda: loss_fn(params))
    torch.cuda.reset_peak_memory_stats()
    step(params)                                   # warm-up
    sync()
    walls = timed_steps(lambda: step(params), N_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**20
    mrays = rays * N_TIMED_STEPS / sum(walls) / 1e6
    log(f"cornell {RES}^2 fwd+bwd: {rays} rays a step, steps ms "
        f"{[round(w * 1e3, 3) for w in walls]}, median "
        f"{statistics.median(walls) * 1e3:.3f} ms; peak device memory "
        f"{peak:.1f} MiB")
    # the backward's share: the step with and without torch.autograd.grad,
    # in turns, so both see the same host and card
    fwd, both = [], []
    for _ in range(N_TIMED_STEPS):
        fwd += timed_steps(lambda: forward_step(loss_fn, params), 1)
        both += timed_steps(lambda: step(params), 1)
    med_f, med = statistics.median(fwd), statistics.median(both)
    log(f"cornell in turns: without the backward median "
        f"{med_f * 1e3:.3f} ms (all {[round(w * 1e3, 3) for w in fwd]}), "
        f"with it {med * 1e3:.3f} ms (all "
        f"{[round(w * 1e3, 3) for w in both]}); backward share "
        f"{1 - med_f / med:.4f}")
    return mrays, active_lane_fraction(scene)


def _big_opts():
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))


def _big_scene(res):
    from core_tpu_torch.scenes import big_scene
    return big_scene(resx=res, resy=res, ibl_samples=BIG_IBL_SAMPLES,
                     sun_samples=BIG_SUN_SAMPLES, device="cuda")


def _big_fwdbwd(scene):
    """Mrays/s of value_and_grad of mean(img[..., :3]) (bench.py:255-266)."""
    import torch
    from core_tpu_torch import diff
    opts = _big_opts()

    def loss_fn(params):
        img = diff.render_flat(diff.apply_params(scene, params), opts, 1)
        return torch.mean(img[..., :3])

    params = diff.extract_params(scene, geometry=False)
    step = diff.value_and_grad(loss_fn)
    with torch.no_grad():
        _, rays = counted_rays(lambda: loss_fn(params))
    torch.cuda.reset_peak_memory_stats()
    step(params)
    sync()
    walls = timed_steps(lambda: step(params), BIG_TIMED_STEPS)
    log(f"bigscene fwd+bwd at {scene.camera.resx}^2: {rays} rays a step, "
        f"steps ms {[round(w * 1e3, 3) for w in walls]}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    return rays * BIG_TIMED_STEPS / sum(walls) / 1e6


def bench_big_scene():
    """(n_tris, fwd Mrays/s, fwd+bwd Mrays/s, fwd+bwd resolution)."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    scene = _big_scene(BIG_RES)
    n_tris = scene.geom.n_tris
    opts = _big_opts()
    types = scene_material_types(scene)

    def fwd():
        with torch.no_grad():
            film = film_mod.make_film(BIG_RES, BIG_RES, device="cuda")
            return render_chunk(scene, types, opts, film, 0, 1, 0)

    _, rays = counted_rays(fwd)
    sync()
    walls = timed_steps(fwd, BIG_TIMED_STEPS)
    fwd_mrays = rays * BIG_TIMED_STEPS / sum(walls) / 1e6
    log(f"bigscene fwd at {BIG_RES}^2: {rays} rays a chunk, chunks ms "
        f"{[round(w * 1e3, 3) for w in walls]}")

    for res in (BIG_RES, BIG_RES // 2):
        try:
            if res != BIG_RES:
                scene = _big_scene(res)
            return n_tris, fwd_mrays, _big_fwdbwd(scene), res
        except torch.cuda.OutOfMemoryError:
            if res != BIG_RES:
                raise
            log(f"bigscene fwd+bwd at {res}^2 ran out of device memory; "
                f"falling back to {res // 2}^2")
        scene = None
        torch.cuda.empty_cache()


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("bench_cuda: torch.cuda.is_available() is false: "
                         "this benchmark needs a CUDA GPU")
    if not (ROOT / "core_tpu_torch" / "__init__.py").is_file():
        raise SystemExit(f"bench_cuda: no core_tpu_torch/ beside "
                         f"{Path(__file__).name}: run it from a checkout")
    sys.path.insert(0, str(ROOT))
    log(f"card: {card()}; torch {torch.__version__}, cuda "
        f"{torch.version.cuda}")
    log("phase: kernel parity")
    parity = check_kernel_parity()
    log("phase: cornell")
    mrays, active = bench_cornell()
    result = {
        "metric": "cornell_pathtrace_fwd_bwd_throughput",
        "value": round(mrays, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 4),
        "active_lane_fraction": round(active, 4),
        "useful_mrays": round(mrays * active, 3),
        "kernel_parity": parity,
    }
    log("phase: big scene")
    n_tris, big_fwd, big_bwd, big_res = bench_big_scene()
    result.update(bigscene_tris=n_tris,
                  bigscene_fwd_mrays=round(big_fwd, 3),
                  bigscene_fwdbwd_mrays=round(big_bwd, 3),
                  bigscene_fwdbwd_res=big_res)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
