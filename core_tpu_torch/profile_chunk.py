"""Profile one 1-spp chunk of a configuration chip_smoke.py drives, on the GPU.

    python3 -m core_tpu_torch.profile_chunk            # the Cornell bench
    python3 -m core_tpu_torch.profile_chunk big        # the 1M-tri scene
    python3 -m core_tpu_torch.profile_chunk mesh       # the 73.6k-tri scene
    python3 -m core_tpu_torch.profile_chunk cornell fwdbwd  # a fwd+bwd step
    python3 -m core_tpu_torch.profile_chunk spec_pt    # a specular chain
    python3 -m core_tpu_torch.profile_chunk ao_dl      # an integrator option
    python3 -m core_tpu_torch.profile_chunk cornell_fold2 fwdbwd  # folded
    python3 -m core_tpu_torch.profile_chunk golden_pt  # the golden mesh
    python3 -m core_tpu_torch.profile_chunk zoo_pt     # the mesh zoo
    python3 -m core_tpu_torch.profile_chunk lightzoo_pt  # the light zoo
    python3 -m core_tpu_torch.profile_chunk pm512      # photonmapping
    python3 -m core_tpu_torch.profile_chunk sppm512    # one SPPM pass
    python3 -m core_tpu_torch.profile_chunk bd256      # bidirectional
    python3 -m core_tpu_torch.profile_chunk sss256_dl  # translucent box

Run from the root of a checkout on a machine with a CUDA card.  "cornell"
renders cornell_box(light_samples=4) with PathOptions(path_samples=8,
bounces=5, raydepth=2) at 256^2; "big" renders big_scene(ibl_samples=4,
sun_samples=2) with DirectOptions(raydepth=1) at 1024^2; "mesh" renders
mesh_scene() at its defaults (256^2, ibl_samples=8, sun_samples=4; the
flat cluster kernels) with DirectOptions(raydepth=1); "spec_pt",
"spec_dl" and "blend_dl" render chip_smoke's chain configurations at
256^2: cornell_box(light_samples=8) with glossy + glass blocks under
PathOptions(path_samples=8, bounces=3, raydepth=5) or
DirectOptions(raydepth=5), and with blend_diff + blend_cross blocks under
DirectOptions(raydepth=5).  "ao_dl", "pane_ts_dl" and "glass_ts_dl" render
chip_smoke.py's option configurations (cornell256_ao_dl_fwd,
pane256_ts_dl_fwd, cornell256_glass_ts_dl_fwd: ambient occlusion, and
transparent shadows on the pane scene and on the glass-block box), taken
from chip_smoke.py itself; "cornell_fold2" is "cornell" with
fold_interval=2 (sorted), chip_smoke's fold table row; "golden_dl" and
"golden_pt" render chip_smoke.py's golden-mesh configurations at 512^2
(goldenmesh512_dl_fwd, goldenmesh512_pt_fwd: golden_mesh_scene with
ibl_samples=8, DirectOptions(raydepth=3) or PathOptions(path_samples=4,
bounces=2, raydepth=3)); "zoo_dl" and "zoo_pt" render the mesh zoo
(chip_smoke.zoo_scene: scenes.MESH_ZOO at 256^2) under those two option
sets (meshzoo256_dl_fwd, meshzoo256_pt_fwd); "lightzoo_dl" and
"lightzoo_pt" render the light zoo (chip_smoke.light_zoo_scene:
scenes.LIGHT_ZOO at 256^2, the sphere, mesh, IES and portal lights, a
darksky with its sun and background light, a thin lens) under those two
option sets with its Gauss filter (lightzoo256_dl_fwd,
lightzoo256_pt_fwd).  "pm512" renders one 2-spp chunk of chip_smoke.py's
cornellspec512_pm (the 512^2 glass-and-glossy box, 1M + 1M photons, final
gathering with 8 rays), its photon maps built once beforehand; "sppm512"
runs one pass of cornellspec512_sppm (500k photons a pass).  "bd256"
renders chip_smoke.py's cornell256_bd (cornell_box(light_samples=16) at
256^2, BidirOptions(): eye and light depth 3, the light image on);
"sss256_dl" and "sss256_pt" its cornell256_sss_dl / _pt (the translucent
box of tests/test_sss.py at 256^2, light_samples=16, sigma_s 8, under
DirectOptions(raydepth=1) or PathOptions(path_samples=2, bounces=2,
raydepth=1) with use_sss, 8,192 photons and 4 interior steps), the SSS map
built once beforehand.  With "fwdbwd" it
profiles bench_cuda.py's step instead of a forward chunk: value_and_grad
of the loss of one 1-spp chunk (Cornell: the mean squared RGB against a
zero target; big and mesh: the mean RGB) with respect to
diff.extract_params(geometry=False).  It times RUNS
unprofiled chunks on the host clock (each ending in a synchronise), then
profiles one chunk under torch.profiler and prints: the unprofiled median
wall, the profiled wall, device kernel time and launch count per chunk, the
device's busy share against both walls, peak device memory, the kernels and
aten ops with the most device time, the CUDA runtime calls with the most
host time (a pageable copy or a synchronise there stalls the host until
the device drains), and the card's name and power limit.
"""
from __future__ import annotations

import statistics
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from core_tpu_torch import diff
from core_tpu_torch import film as film_mod
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.render import (RenderOptions, integrator_preprocess,
                                   render_chunk, scene_material_types)
from core_tpu_torch.scenes import big_scene, cornell_box, mesh_scene

RUNS = 5
TOP = 18


OPTIONS = {"ao_dl": "cornell256_ao_dl_fwd", "pane_ts_dl": "pane256_ts_dl_fwd",
           "glass_ts_dl": "cornell256_glass_ts_dl_fwd"}


def _config(name):
    """(scene, options) of a named configuration."""
    if name in ("cornell", "cornell_fold2"):
        fold = dict(fold_interval=2) if name == "cornell_fold2" else {}
        return (cornell_box(resx=256, resy=256, light_samples=4,
                            device="cuda"),
                RenderOptions(aa_samples=4, spp_chunk=1,
                              integrator="pathtracing",
                              integrator_opts=PathOptions(
                                  path_samples=8, bounces=5, raydepth=2,
                                  **fold)))
    if name in OPTIONS:
        import chip_smoke       # from the root of the checkout
        return chip_smoke.option_config(OPTIONS[name], 256)
    if name in ("golden_dl", "golden_pt"):
        import chip_smoke
        return (chip_smoke.golden_scene(512),
                chip_smoke.golden_opts(name[-2:]))
    if name in ("zoo_dl", "zoo_pt"):
        import chip_smoke
        return chip_smoke.zoo_scene(256), chip_smoke.golden_opts(name[-2:])
    if name in ("lightzoo_dl", "lightzoo_pt"):
        import chip_smoke
        return (chip_smoke.light_zoo_scene(256),
                chip_smoke.light_zoo_opts(name[-2:]))
    if name in ("pm512", "sppm512"):
        import chip_smoke
        kind = name[:-3]
        return (cornell_box(resx=512, resy=512, light_samples=16,
                            block_materials=chip_smoke.PH_BLOCKS,
                            device="cuda"),
                chip_smoke.photon_opts(kind, chip_smoke.PH_PM if kind == "pm"
                                       else chip_smoke.PH_SPPM))
    if name == "bd256":
        import chip_smoke
        return (cornell_box(resx=chip_smoke.BD_RES, resy=chip_smoke.BD_RES,
                            light_samples=16, device="cuda"),
                chip_smoke.bidir_opts(1, 1))
    if name in ("sss256_dl", "sss256_pt"):
        import chip_smoke
        kind = name[-2:]
        return (chip_smoke.translucent_box(chip_smoke.SSS_RES, 16),
                chip_smoke.sss_opts(kind, True))
    direct = RenderOptions(aa_samples=1, spp_chunk=1,
                           integrator="directlight",
                           integrator_opts=DirectOptions(raydepth=1))
    if name == "big":
        return (big_scene(resx=1024, resy=1024, ibl_samples=4,
                          sun_samples=2, device="cuda"), direct)
    if name == "mesh":
        return mesh_scene(device="cuda"), direct
    chains = {"spec_pt": (("glossy", "glass"), "pathtracing"),
              "spec_dl": (("glossy", "glass"), "directlight"),
              "blend_dl": (("blend_diff", "blend_cross"), "directlight")}
    if name in chains:
        blocks, integ = chains[name]
        iopts = (PathOptions(path_samples=8, bounces=3, raydepth=5)
                 if integ == "pathtracing" else DirectOptions(raydepth=5))
        return (cornell_box(resx=256, resy=256, light_samples=8,
                            block_materials=blocks, device="cuda"),
                RenderOptions(aa_samples=4, spp_chunk=1, integrator=integ,
                              integrator_opts=iopts))
    raise SystemExit(f"profile_chunk: unknown configuration {name!r} "
                     "(cornell, cornell_fold2, big, mesh, spec_pt, spec_dl, "
                     "blend_dl, ao_dl, pane_ts_dl, glass_ts_dl, golden_dl, "
                     "golden_pt, zoo_dl, zoo_pt, lightzoo_dl, "
                     "lightzoo_pt, pm512, sppm512, bd256, sss256_dl or "
                     "sss256_pt)")


def _fwdbwd_step(name, scene, opts):
    """bench_cuda.py's fwd+bwd step on a named configuration."""
    types = scene_material_types(scene)

    def loss_fn(params):
        img = diff.render_flat(diff.apply_params(scene, params), opts, 1,
                               types)[..., :3]
        return torch.mean(img * img) if name.startswith("cornell") \
            else img.mean()

    params = diff.extract_params(scene, geometry=False)
    vg = diff.value_and_grad(loss_fn)
    return lambda: vg(params)


def _sppm_pass(scene, types, so):
    """One SPPM pass (pass 0) from a fresh state."""
    from core_tpu_torch.integrators import sppm
    from core_tpu_torch.integrators.photonmap import (scene_bound,
                                                      world_sphere)
    from core_tpu_torch.vec import zeros3
    bmin, bmax = scene_bound(scene)
    center, world_r = world_sphere(scene, bmin, bmax)
    r0 = float(so.search_radius)
    h, w = scene.camera.resy, scene.camera.resx
    zero = torch.zeros(h * w, device="cuda")
    state = sppm.HitPoints(r2=torch.full_like(zero, r0 * r0), acc_n=zero,
                           tau=zeros3(zero), direct=zeros3(zero))

    def one():
        with torch.no_grad():
            return sppm.one_pass_block(scene, types, state, 0, 0, h, w, so,
                                       scene.camera, center, world_r, bmin,
                                       bmax, r0)
    return one


def main(name="cornell", mode="fwd"):
    if not torch.cuda.is_available():
        raise SystemExit("profile_chunk: needs a CUDA card")
    if mode not in ("fwd", "fwdbwd"):
        raise SystemExit(f"profile_chunk: unknown mode {mode!r} (fwd or "
                         "fwdbwd)")

    scene, opts = _config(name)
    types = scene_material_types(scene)
    res_y, res_x = scene.camera.resy, scene.camera.resx

    spp, aux = 1, None
    if name in ("pm512", "sss256_dl", "sss256_pt"):
        spp = opts.spp_chunk
        with torch.no_grad():
            aux = integrator_preprocess(scene, types, opts)

    def chunk():
        with torch.no_grad():
            film = film_mod.make_film(res_y, res_x, device="cuda")
            return render_chunk(scene, types, opts, film, 0, spp, 0, aux)

    if name == "sppm512":
        chunk = _sppm_pass(scene, types, opts.integrator_opts)
    if mode == "fwdbwd":
        chunk = _fwdbwd_step(name, scene, opts)

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
    print(f"{name} {mode} chunk {res_x}x{res_y}: unprofiled wall ms median "
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
    # device kernels are the records of device type CUDA; the host-side
    # records (aten ops, and in a backward pass the autograd nodes) carry
    # their kernels' device time too and are left out of the sum
    kern = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in ka
                   if e.device_type == DeviceType.CUDA
                   and e.device_time_total > 0),
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
                   e.count) for e in ka if e.key.startswith(
                       ("aten::", "autograd::engine::evaluate_function"))),
                 key=lambda x: -x[1])
    print("aten ops and autograd nodes by device time (nested; they "
          "overlap):")
    for k, d, cpu, c in ops[:12]:
        print(f"  {d:9.3f} ms dev {cpu:9.3f} ms cpu {c:6d}x {k}")
    rt = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in ka
                 if e.key.startswith("cuda")), key=lambda x: -x[1])
    print("CUDA runtime calls by host time:")
    for k, cpu, c in rt[:6]:
        print(f"  {cpu:9.3f} ms cpu {c:6d}x {k}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])


if __name__ == "__main__":
    main(*sys.argv[1:3])
