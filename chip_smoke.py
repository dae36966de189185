#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (core_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, with their seconds:
  1. build   — compile csrc/*.cu with nvcc for sm_90a (one nvcc per source,
               all started together) into build/core_tpu_torch/; ptxas
               registers / shared memory / spills per kernel
  2. kernels — kernels 1 and 2 (brute closest hit, NEE bundle) against their
               plain PyTorch versions on the card (identical prim /
               occlusion bits, t/u/v within rtol 1e-6), on >= 1M rays of the
               Cornell box and at each shape the Cornell path gives them
               (65,536 primary and 524,288 bounce lanes, K=8); both timed
               at the bounce shape, kernel 2's bound counted on the timed
               bundle's work as in 4b
  3. render  — the Cornell path: render_image on the 256^2 Cornell box at
               the bench configuration (light_samples=4, path_samples=8,
               bounces=5), one warm-up and one timed request of aa_samples=4
               in 1-spp chunks; rays counted at the scene entry points;
               launch counters prove kernels 1 and 2 ran and the plain
               versions did not; image checks; PNG under build/
  4. slice   — a 64^2 Cornell render through the kernels and through the
               plain versions on the card must give identical images
  4b. cornell kernels — the inputs of kernels 1 and 2 captured from one
               256^2 chunk of the phase-3 configuration: its six closest-hit
               calls (primary, five bounces) and six NEE bundles (K=8: the
               primary one at 65,536 lanes, five at 524,288), each run and
               timed, every lane held against the plain version (identical
               prim and occlusion bits; t/u/v within rtol 1e-6, and whether
               they are identical); per bundle the share of lanes whose rays
               are all dead and the share of dead rays (0 < tcap <= tmin);
               bounds counted on the captured work (kernel 2: each live ray
               tested up to its first occluder, dead rays none; the origin,
               exclusions and directions read only for live lanes and rays);
               launches x (kernel - bound) per chunk
  4c. fwdbwd — bench_cuda.py's Cornell step at full width: value_and_grad
               of the bench loss (256^2, 1 spp) with respect to
               extract_params(geometry=False) through kernels 1 and 2;
               launches of each kernel in one step, finite loss and
               gradients, nonzero gradients of mat.diffuse_color and
               light0.color, the median of 5 timed steps, rays counted at
               the scene entry points, Mrays/s and peak device memory; then
               at 64^2 the loss through the kernels bit-identical to the
               loss through the plain versions and every gradient within
               1e-4 x max|g| of its leaf, and the geometry=True leaf set
               finite
  5. big     — the 1M-triangle direct-light path (core_tpu's bench_big_scene
               configuration): big_scene(1024^2, ibl_samples=4,
               sun_samples=2) built by the port alone; the inputs of kernels
               7 and 8 (grouped closest hit, grouped any hit) captured from
               one chunk: camera and glossy-chain closest hits, one IBL and
               one sun NEE bundle after re-bucketing; each kernel run on the
               whole input and timed, every lane of a fixed random subset of
               65,536 held against the plain version (which also counts the
               triangle and slab tests behind the bound); the re-bucketing
               of each of the chunk's four bundles timed on its own; then
               one warm-up and three timed 1-spp chunks with rays counted,
               launch counters and image checks
  6. big slice — a 64^2 render of the same 1M-triangle scene through the
               kernels and through the plain versions must be identical
  7. mesh    — the 73.6k-triangle flat-cluster path (mesh256_dl_fwd):
               mesh_scene() at its defaults (256^2, ibl_samples=8,
               sun_samples=4; 512 clusters) built by the port alone; the
               inputs of kernels 4 and 6 (flat closest hit, flat NEE bundle)
               captured from one chunk: camera and glossy-chain closest
               hits, one IBL (K=16) and one sun (K=8) bundle; each kernel run
               on the whole input and timed, every lane held against the
               plain version (which counts the triangle and slab tests
               behind the bound); then one warm-up and three timed 1-spp
               chunks with rays counted, launch counters and image checks
  8. dirac   — the dirac variant of mesh_scene (the background without IBL;
               a point, a spot and a directional light instead of the sun)
               at 73,602 triangles (flat: kernels 4 and 5) and at 1,634
               (brute: kernels 1 and 3), 256^2: each light's shadow
               wavefront captured from one chunk (camera and glossy-chain
               hit), kernels 5 and 3 held against their plain versions on
               every lane and timed, with each wavefront's share of dead
               rays (0 < tcap <= tmin); kernels 4 and 1 likewise on each
               variant's two closest-hit calls (camera, glossy chain);
               launches x (kernel - bound) per chunk for kernels 1, 3, 4
               and 5; one timed chunk each with launch counters and image
               checks
  9. mesh slice — 64^2 renders of mesh_scene and of both dirac sizes
               through the kernels and through the plain versions must be
               identical
  10-12. the specular chains and composite materials, each at 256^2 and
               full width: cornell256_spec_pt_fwd (glossy + glass blocks,
               light_samples=8, path_samples=8, bounces=3, raydepth=5),
               cornell256_spec_dl_fwd (the same box, directlight raydepth
               5) and cornell256_blend_dl_fwd (blend_diff + blend_cross
               blocks, directlight raydepth 5): counts at 0, a warm-up
               chunk with rays counted, 4 timed 1-spp chunks; kernels 1
               and 2 launched (their launches per chunk), kernel 3 and
               the plain versions not; the share of live lanes in each
               chain depth's closest-hit wavefront; peak memory; a finite
               image whose block pixels differ from the white-block box's;
               a 64^2 slice through the kernels bit-identical to one
               through the plain versions
  spec extras — the 64^2 dispersive box (glass dispersion 0.1) finite and
               different from the plain one; the 64^2 fwd+bwd of the
               glossy + glass path-traced box: finite gradients, nonzero
               for filter_color and mirror_color on the glass row, the
               loss through the kernels bit-identical to the plain
               versions' and each gradient within 1e-4 x max|g|
  13-15. the integrator options at 256^2 through the brute kernels, each
               with counts at 0, a warm-up chunk with rays counted, 2 timed
               1-spp chunks, every kernel's launches per chunk, peak memory
               and a 64^2 render through the kernels bit-identical to one
               through the plain versions: cornell256_ao_dl_fwd
               (cornell_box(light_samples=4), DirectOptions(raydepth=5,
               use_ao=True, ao_samples=32, ao_dist=100): kernel 3 launched
               once per AO sample); pane256_ts_dl_fwd (the scene of
               tests/test_shadow_sentinel.py:141-193 built by the port,
               DirectOptions(transp_shad=True, shadow_depth=4): the walks
               on kernel 1, kernels 2 and 3 idle; at floor points under the
               pane, estimate_all_direct_s blocked without transp_shad and
               green with it, core_tpu's three assertions);
               cornell256_glass_ts_dl_fwd (glass blocks, DirectOptions(
               raydepth=5, transp_shad=True): glass has no FILTER flag, so
               the image equals the opaque-shadow one on >= 99.9% of the
               pixels)
  16. fold table — bench.py:52-68's five folding rows on the
               cornell256_pt_fwdbwd step: median of 3 timed steps (one
               step of each row in turn, row order, reverse, row order), rays
               counted at the scene entry points, Mrays/s,
               active_lane_fraction, useful Mrays/s, peak memory, the
               launches per step, and the equal-spp MSE of a 64^2 4-spp
               render against a 64-spp fold-0 reference on other QMC
               streams; then the folded (fold_interval=2, sorted) 64^2
               gradients through the kernels within 1e-4 x max|g| of the
               plain versions'
  17. golden mesh — golden_mesh_scene (2,306 triangles: the brute kernels
               1 and 2; checker.tga through texture_mapper nodes, lit only
               by a sky.tga textureback with IBL): at 128^2, ibl_samples=8,
               aa_samples=16 in chunks of 2, box filter 1.0, directlight
               raydepth=3 and path tracing (path_samples=4, bounces=2,
               raydepth=3), each held against its reference golden by
               tests/test_golden_mesh_ibl.py's checks at its bands (sky mean
               and MAE, energy, 12 x 12 block Pearson; each value printed
               beside its band), with every kernel's launches per chunk
               (kernels 1 and 2 > 0, no other, no plain version); the
               inputs of kernels 1 and 2 captured from one 1-spp
               path-traced 128^2 chunk (camera and two bounce closest
               hits, three IBL bundles of K=16: 8 light and 8 BSDF
               samples) held against the plain versions on every lane and
               timed; 1-spp chunks at 512^2, dl and pt in turns (dl, pt,
               pt, dl): ms per chunk, Mrays/s counted at the scene entry
               points, peak memory, launches per chunk; 64^2 dl and pt
               renders through the kernels bit-identical to the plain
               versions'; a 64^2 dl fwd+bwd against
               extract_params(geometry=False) with finite gradients within
               1e-4 x max|g| of the plain versions' and a nonzero
               diffuse_reflect gradient on both node-mapped materials
  18. mesh zoo — scenes.MESH_ZOO built by the port (zoo_builder):
               mesh_scene's 73,602 triangles in 512 clusters (the flat
               kernels 4 and 6), its camera, clouds IBL (K=16 bundles) and
               sun (K=8), with the terrain's diffuse a layer node over a
               ridged-multifractal and a wood texture and its bump a
               heteroterrain musgrave over cell noise, and the torus a
               coated anisotropic glossy whose diffuse is a screen mix of a
               distorted-noise and a coloured Minkowski voronoi by a blend
               ramp, its glossy colour an rgb cube; the build seconds; the
               inputs of kernels 4 and 6 captured from one 1-spp
               path-traced 256^2 chunk (directlight raydepth 3 and path
               tracing path_samples=4, bounces=2, raydepth=3, golden_opts):
               the camera, two bounce and first chain-depth closest hits
               and the sun and IBL bundles of those four vertices, every
               lane against the plain versions, timed, with bounds as in
               phase 7; 1-spp 256^2 chunks of meshzoo256_dl_fwd /
               meshzoo256_pt_fwd in turns with mesh_scene under the same
               options (zoo dl, mesh dl, mesh pt, zoo pt, then back): ms per
               chunk and its ratio to mesh_scene's, Mrays/s counted at the
               scene entry points, peak memory, launches per chunk (kernels
               4 and 6 > 0, no other kernel, no plain version); 64^2 dl and
               pt renders through the kernels bit-identical to the plain
               versions'; a 64^2 dl fwd+bwd over extract_params(geometry=
               False) within 1e-4 x max|g| of the plain versions', with the
               coated torus row's mirror_color and glossy_reflect gradients
               nonzero (its glossy_color is node-mapped: 0)
  19. light zoo — scenes.LIGHT_ZOO built by the port (light_zoo_builder,
               through the factories): mesh_scene's terrain and torus with
               plain materials, a 32-triangle emitter panel in light_mat
               with a meshlight over it, a portal quad out of the camera's
               view with a bgPortalLight, a sphere light and an IES light,
               under a darksky with add_sun and background_light (K=16
               bundles with MIS), seen through a thin lens (hexagonal
               bokeh, focused on the torus), splatted with a Gauss filter
               of size 1.5: 73,636 triangles on the flat path (kernels 4,
               5 for the IES light's shadow rays, 6 for the other five
               lights' bundles); the build seconds; the inputs of one
               1-spp path-traced 256^2 chunk (light_zoo_opts: golden_opts
               with the Gauss filter): kernel 4 on the camera and two
               bounce closest hits, kernel 5 on the IES light's camera and
               first-bounce shadow rays, kernel 6 on the camera vertex's
               sun, sphere, sky, mesh-light and portal bundles, every lane
               against the plain versions, timed, with bounds as in phase
               7; 1-spp 256^2 chunks of lightzoo256_dl_fwd /
               lightzoo256_pt_fwd in turns with mesh_scene under the same
               options: ms per chunk and its ratio, Mrays/s, peak memory,
               launches per chunk (kernels 4, 5 and 6 > 0 in the light
               zoo, no other, no plain version) and the busy share of one
               profiled chunk; then at 64^2 on the small light zoo (1,668
               triangles: the brute kernels 1, 2 and 3) the dl and pt
               renders and a sweep of one change at a time (pinhole,
               ring-bokeh, architect, angular and orthographic cameras; a
               night darksky, sunsky, gradient and constant sky; box,
               Mitchell and Lanczos filters), each through the kernels
               bit-identical to the plain versions'
  20. photons — the photon integrators through kernels 1 and 2 (kernel 4
               on the light zoo): (a) both photon goldens on the 64^2 Cornell
               box (cornell_box(light_samples=16), the goldens' options:
               photonmapping with 200k + 200k photons, bounces 4, radii 40 /
               30, final gathering with 8 rays, aa 4 in 2-spp chunks, box
               filter 1; SPPM 8 passes of 100k photons, radius 15) held to
               tests/test_golden_photon_family.py's bands, rel / Pearson /
               q50 printed; (b) the 64^2 glass-and-glossy box under
               photonmapping (final gathering with its cache), SPPM over 2
               passes and path tracing with caustic_type "both", through
               the kernels bit-identical to the plain versions; (c)
               cornellspec512_pm (the box at 512^2, light_samples=16, 1M +
               1M photons, bounces 5, aa 4 in 2-spp chunks): preprocess
               seconds (shoots, grids, radiance cache), deposits stored per
               map, ms per chunk, Mrays/s, peak memory, launches per chunk,
               the busy share of one profiled chunk; (d)
               cornellspec512_sppm (16 passes of 500k photons, radius 15):
               ms per pass, peak memory, launches per pass; (e) a diffuse
               shoot of 262,144 photons, 3 bounces, on the 256^2 light zoo
               (kernel 4) identical to the plain version's, every light
               emitting; (f) kernel 1 on the 1M-photon diffuse shoot's six
               captured wavefronts against the plain version, timed, with
               bounds as in phase 7, and launches x (kernel - bound) per
               shoot
  21. bidir — the bidirectional path tracer, subsurface scattering and
               the debug integrator: (a) bd64_golden, the 64^2 Cornell box
               (light_samples=16) under BidirOptions(do_light_image=False),
               aa 8 in 2-spp chunks, box filter 1, through kernels 1 and 3
               at tests/test_golden_photon_family.py's bands (block Pearson
               > 0.99 against bd_128x128_64spp pooled 2x, energy rel in
               [0.1, 0.6], mean within 10% of the float64 arbiter's
               0.6524); (b) at 64^2, through the kernels bit-identical to
               the plain versions: bidirectional with the light image, the
               translucent box (tests/test_sss.py's scene, translucent_box)
               under directlight and path tracing with use_sss, and every
               debug type on golden_mesh_scene; (c) cornell256_bd
               (cornell_box(light_samples=16), BidirOptions(): eye and
               light depth 3, the light image on, 1-spp chunks): ms per
               chunk, rays, peak memory, launches per chunk, the light
               image's splats that land, the busy share of one profiled
               chunk, and kernels 1 and 3 on the chunk's 6 closest-hit and
               15 visibility wavefronts against the plain versions, timed,
               with bounds; (d) emit_pdf of all ten light types on the
               card; lightzoo256_bd (scenes.LIGHT_ZOO, BidirOptions(), one
               1-spp chunk on kernels 4 and 5): ms, peak memory, launches,
               busy share, each light's contribution alone (nonzero), and
               kernels 4 and 5 on two captured wavefronts each against the
               plain versions; (e) cornell256_sss_dl / _pt (the
               translucent box at 256^2, light_samples=16, sigma_s 8, 8,192
               photons, 4 interior steps): the SSS map's build seconds,
               valid deposits and launches, the dipole estimate's device
               ms at the 65,536 camera hits, ms per chunk, peak memory,
               launches per chunk, the busy share, and the energy SSS adds
               on the block
  22. volumes — the volume regions, the volume integrators and the rest
               of render_image: (a) vol128_golden, golden_volume_scene at
               128^2 under tests/test_golden_volume.py's options (16 spp
               in 2-spp chunks, box filter 1.0, directlight raydepth 1,
               single scattering in 24 steps) through kernels 1 (2 a
               chunk: the camera hit and the volume branch's own) and 3
               (25 a chunk: 24 march steps and the spotlight's NEE), held
               to that test's bands (air mean and MAE, ground mean and 12
               x 12 block Pearson, optimize against the march at 64^2);
               (b) at 64^2 each configuration of (c) through the kernels
               bit-identical to the plain versions; (c) vol128_golden,
               vol512_ss (the golden scene at 512^2, one 4-spp chunk: 24
               steps over 1,048,576 lanes), cornell256_fog_pt (the Cornell
               box with a NoiseVolume inside under the phase-3 path
               tracer and 16-step single scattering: kernels 1, 2, 3 and
               the NEE transmittance), goldenmesh256_sky_dl (the golden
               mesh under the sky integrator) and cornell256_aa3_dl (three
               adaptive passes with show_sam_pix, the flagged pixels per
               pass): ms per chunk, launches per chunk, peak memory, the
               busy share of one profiled request; (d) one chunk of
               vol512_ss (1,048,576 lanes) and of cornell256_fog_pt at
               full size, every call of kernels 1, 2 and 3 in it (the
               camera hits, the path's bounces and NEE bundles, the
               spotlight's NEE, every march step's shadow wavefront)
               against the plain versions lane by lane, timed, with
               bounds, and launches x (kernel - bound) per chunk
  23. frontend — the front ends: (a) xml_cornell256_pt, phase 3's
               configuration (256^2 Cornell box, light_samples=4, path
               tracer with path_samples=8, bounces=5, raydepth=2, AA 4 in
               1-spp chunks) written as a reference-schema scene file by
               replaying scenes.cornell_box's elements and geometry through
               io.xml_writer.XmlInterface (write_cornell_xml), rendered by
               cli.main([xml, out, "-f", "png", "-z", "-dp", "--device",
               "cuda"]) in process: kernels 1 and 2 at phase 3's launches a
               chunk (kernel 1 once more for the z-buffer), no plain
               version, the parsed options equal to phase 3's, the image
               equal to render_image of parse_xml_scene's scene and in
               phase 3's MEAN_REF band, the PNG equal to write_png of that
               image under the same badge, the z-buffer PNG written; the
               CLI's parse, compile and render seconds; (b) python -m
               core_tpu_torch on the same file in a subprocess on the card
               (no -dp): exit 0, the kernels' library not rebuilt, its PNG
               and z-buffer PNG byte-identical to (a)'s image and z-buffer
               (else the differing pixels and the largest difference are
               printed, and a difference over 1 LSB fails); (c)
               xml_mesh256_dl, mesh_scene's 73,602 triangles, materials,
               textures, sun and clouds IBL written the same way (256^2,
               directlight raydepth 1, as mesh256_dl_fwd) and rendered
               through cli.main: the file's size, parse and compile
               seconds, ms a chunk; kernels 4 and 6 at phase 7's launches a
               chunk, no other kernel and no plain version; the image
               equal to render_image of the parsed scene, and within a
               mean relative difference of 1e-3 of phase 7's in-memory
               image (.8g text moves a float32 vertex by an ulp at most);
               (d) (a)'s calls into interface.Interface(device="cuda"),
               rendered with gui.MemoryOutput and a
               utils.monitor.CallbackProgressBar: flushes, ticks and
               chunks equal, the image equal to (a)'s; (e) the phase within
               90 s
  24. multi — several ranks on the one card and the BVH: (i)
               cornell256_pt_rowsharded nccl1, phase 3's configuration
               through render_image_rowsharded over a one-rank NCCL group on
               cuda:0 (parallel/distributed.init_distributed): kernels 1
               and 2 a chunk, the collectives (calls, bytes, ms a call),
               ms a chunk, the image against phase 3's at
               tests/test_sharding.py's tolerance; (ii) two gloo ranks on
               cuda:0, started as subprocesses (python3 chip_smoke.py
               --rank R PORT DIR, multi_rank): the same render on meshes
               2x1 (gloo2_tiles) and 1x2 (gloo2_spp) against phase 3's
               image, make_train_step_rowsharded on the fwd+bwd bench step
               (2x1) against diff.value_and_grad of the bench loss (loss at
               rtol 1e-3, lr * grad at rtol 1e-3 / atol 1e-4), and
               cornellspec512_sppm_sharded (phase 20's configuration at 2
               passes of 500,000 photons, 2x1) against render_sppm; each
               rank's launches, collectives and ms per chunk (step, pass),
               every call run twice and the second counted; gloo stages
               CUDA tensors through host memory, so these measure
               correctness and host staging, not NCCL scaling; (iii) the
               launches in each row's multi_launches; (iv) mesh256_dl_bvh:
               mesh_scene built with the port's native BVH builder (g++
               and build seconds), one directlight chunk through the torch
               traversal (no kernel launched) against phase 7's image
               (kernels 4 and 6)
A busy share, in every phase, is the summed duration of the device events
(kernels, copies, memsets) of one profiled call under torch.profiler's
CUDA activity, over that call's wall time under the same profiler
(_busy_share).
The line before the last is the card's name and power limit (nvidia-smi),
the one before that the kernel table as JSON, and the last line is
{"ok": true, "device": {...}}.  Rows 1 and 2 of that table are phase 2's
synthetic bounce-shape inputs (comparable with earlier runs); phase 4b
prints the captured ones.  Each row's fwdbwd_launches is the kernel's
launches in one fwd+bwd step of phase 4c, its chain_launches,
option_launches, golden_launches, zoo_launches and lightzoo_launches those
per chunk of each phase 10-12, 13-15, 17, 18 and 19 configuration, its
fold_launches those per step of each fold-table row, its photon_launches
those per request of each photon golden, per chunk of cornellspec512_pm,
per pass of cornellspec512_sppm and per light-zoo shoot, its
bidir_launches those per bd64_golden request, per chunk of cornell256_bd,
lightzoo256_bd and cornell256_sss_dl / _pt, and per SSS map build, its
volume_launches those per vol128_golden request and per chunk of each
phase-22 configuration, its frontend_launches those per chunk of each
phase-23 scene file, its multi_launches those per chunk (step, pass) and
rank of each phase-24 configuration.
Any failure raises (non-zero exit).  Imports nothing of jax or core_tpu.
"""
from __future__ import annotations

import contextlib
import json
import re
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

ROOT = Path(__file__).resolve().parent
BUILD = ROOT / "build"

# main-path configuration (the Cornell bench of the JAX package)
RES = 256
LIGHT_SAMPLES = 4
PATH_SAMPLES = 8
BOUNCES = 5
AA_SAMPLES = 4
# image-mean band: the port's CPU render of the same configuration at 64^2
# (aa_samples=4, path_samples=8, bounces=5) gave a mean RGB of 0.65279; the
# band allows for the resolution change and sample noise
MEAN_REF = 0.65279
MEAN_BAND = 0.05
RTOL = 1e-6

# the 1M-triangle configuration (core_tpu bench.py bench_big_scene)
BIG_RES = 1024
BIG_IBL = 4
BIG_SUN = 2
BIG_TIMED = 3
BIG_TRIS = 1_017_202
SUBSET = 65_536          # lanes held against the plain versions

# peak rates of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
PEAK_F32 = 67e12         # float32 operations/s outside the tensor cores
PEAK_BYTES = 3.35e12     # HBM bytes/s
# float operations per ray-triangle test, counted from the kernels' code:
# Moller-Trumbore with the reciprocal (closest hit), the division-free test
# (any hit), and for the shared-origin NEE bundle 35 per lane and triangle
# (origin terms) plus 29 per direction
OPS_CLOSEST = 57
OPS_ANY = 56
OPS_NEE_LANE = 35
OPS_NEE_DIR = 29
# and per slab test of a cluster, octet or group box (6 subtractions, 6
# products, 12 min/max, 1 compare)
OPS_SLAB = 25


def bound(ops, nbytes):
    """(bound_ms, bound_by): the larger of the operation and byte times."""
    t_ops = ops / PEAK_F32 * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def fail(msg):
    raise RuntimeError(f"chip_smoke: {msg}")


def sync():
    import torch
    torch.cuda.synchronize()


def cuda_time_ms(fn, reps: int, warmup: int = 2):
    """Median device time of fn() in ms over reps launches (CUDA events),
    and the output of the last launch."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2], out


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def ptxas_lines(path):
    """(kernel, line) of each ptxas -v line (registers / shared memory /
    spills per kernel instantiation) in the build log of library `path`."""
    log = Path(path).with_suffix(".log")
    kernel = "?"
    for ln in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            k = re.search(r"\d+((?:cluster_|grouped_)?(?:closest_hit|"
                          r"any_hit_nee|any_hit))_kernel(?:ILi(\d+)E)?",
                          m.group(1))
            kernel = (m.group(1) if not k else k.group(1) if not k.group(2)
                      else f"{k.group(1)}<{k.group(2)}>")
        elif "Used" in ln or "spill" in ln:
            yield kernel, ln.split(":", 1)[-1].strip()


def phase_build():
    from core_tpu_torch import _build
    path, secs = _build.build()
    _build.load_library()
    print(f"build: {path.relative_to(ROOT)} nvcc {secs:.3f} s "
          f"(0 = already built)")
    for kernel, ln in ptxas_lines(path):
        print(f"build: ptxas {kernel}: {ln}")
    return secs


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def _unit(v):
    return v / v.norm(dim=-1, keepdim=True)


def _rays(scene, n_cam, n_int, gen):
    """Camera rays plus random interior rays of the Cornell box, with mixed
    open and bounded caps and exclusion ids."""
    import torch
    from core_tpu_torch import vec
    from core_tpu_torch.cameras import shoot_ray
    dev = scene.device
    cam = scene.camera
    px = torch.rand(n_cam, generator=gen, device=dev) * cam.resx
    py = torch.rand(n_cam, generator=gen, device=dev) * cam.resy
    crays, _ = shoot_ray(cam, px, py)
    lo = torch.tensor([10.0, 10.0, 10.0], device=dev)
    hi = torch.tensor([546.0, 538.0, 549.0], device=dev)
    o = lo + torch.rand((n_int, 3), generator=gen, device=dev) * (hi - lo)
    d = _unit(torch.randn((n_int, 3), generator=gen, device=dev))
    o = torch.cat([crays.o, o])
    d = torch.cat([crays.d, d])
    n = n_cam + n_int
    tmax = torch.where(torch.rand(n, generator=gen, device=dev) < 0.5,
                       torch.rand(n, generator=gen, device=dev) * 800.0,
                       torch.full((n,), -1.0, device=dev))
    T = scene.geom.n_tris
    ex = torch.randint(-2, T, (n,), generator=gen, device=dev,
                       dtype=torch.int32)
    rs = vec.RaysS(o=vec.v3(o), d=vec.v3(d),
                   tmin=torch.full((n,), 5e-5, device=dev), tmax=tmax)
    return rs, ex


def _nee_bundle(scene, n, K, gen):
    """K shadow rays per lane from surface points: light-bound (bounded
    caps), random open, random bounded and dead (0 < tcap <= tmin) rays,
    with the hit prim as exclusion."""
    import torch
    from core_tpu_torch import scene as scene_mod
    from core_tpu_torch import vec
    dev = scene.device
    rs, _ = _rays(scene, 0, n, gen)
    rs = rs._replace(tmax=torch.full((n,), -1.0, device=dev))
    hits = scene_mod.closest_hit_s(scene, rs)
    sp = scene_mod.surface_points_s(scene, rs, hits)
    light = scene.lights[0]
    dirs, tcaps = [], []
    for k in range(K):
        kind = k % 4
        if kind == 0:      # toward a random point on the light
            s1 = torch.rand(n, generator=gen, device=dev)
            s2 = torch.rand(n, generator=gen, device=dev)
            tgt = light.corner + s1[:, None] * light.to_x \
                + s2[:, None] * light.to_y
            p = torch.stack([sp.p.x, sp.p.y, sp.p.z], dim=1)
            dv = tgt - p
            dist = dv.norm(dim=1)
            dirs.append(vec.v3(dv / dist[:, None].clamp_min(1e-12)))
            tcaps.append(dist - 5e-4)
        else:
            dirs.append(vec.v3(_unit(torch.randn((n, 3), generator=gen,
                                                 device=dev))))
            if kind == 1:
                tcaps.append(torch.full((n,), -1.0, device=dev))
            elif kind == 2:
                tcaps.append(torch.rand(n, generator=gen, device=dev) * 600)
            else:
                tcaps.append(torch.full((n,), 2.5e-4, device=dev))
    tmin = torch.full((n,), 5e-4, device=dev)
    ex1 = torch.randint(-2, scene.geom.n_tris, (n,), generator=gen,
                        device=dev, dtype=torch.int32)
    return sp.p, tmin, dirs, tcaps, sp.prim, ex1


def _rel_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max()) \
        if a.numel() else 0.0


def check_closest(hk, hp, what):
    """Kernel hits hk against plain hits hp: identical prim, t/u/v within
    rtol 1e-6.  Returns the max abs error of t/u/v."""
    import torch
    sync()
    n = hp.prim.numel()
    if not torch.equal(hk.prim, hp.prim):
        bad = int((hk.prim != hp.prim).sum())
        fail(f"closest hit ({what}): prim differs on {bad} of {n} rays")
    errs = [_rel_err(getattr(hk, f), getattr(hp, f)) for f in "tuv"]
    if max(errs) > RTOL:
        fail(f"closest hit ({what}): t/u/v rel err {errs} > {RTOL}")
    err = max(float((getattr(hk, f) - getattr(hp, f)).abs().max())
              for f in "tuv")
    print(f"kernels: closest_hit parity, {what}: {n} rays, prim identical, "
          f"hit {float(hk.valid.float().mean()):.4f}, max abs err t/u/v "
          f"{err}")
    return err


def _nee_work(tmin, tcaps, lane_t, dir_t, n_slabs, data_bytes, ex_bytes):
    """(operations, bytes) that a NEE bundle needs, from the plain
    version's count of its triangle tests (lane_t, dir_t) and slab tests.
    Bytes: every lane's tmin, K caps and K output bits; the origin and
    exclusions (ex_bytes) of a lane with a live ray; the direction of a live
    ray (a dead one, 0 < tcap <= tmin, is decided by its cap); the scene's
    data_bytes."""
    import torch
    caps = torch.stack(list(tcaps))
    live = ~((caps > 0) & (caps <= tmin[None]))
    K, n = caps.shape
    ops = float(lane_t.sum()) * OPS_NEE_LANE \
        + float(dir_t.sum()) * OPS_NEE_DIR + n_slabs * OPS_SLAB
    nbytes = n * (4 + K * 5) + int(live.any(0).sum()) * (12 + ex_bytes) \
        + int(live.sum()) * 12 + data_bytes
    return ops, nbytes


def check_nee(ok_, op, what, K):
    """Kernel occlusion bits against plain bits: identical, and no dead
    ray (every 4th sample of _nee_bundle) occluded.  Returns the max abs
    error of the bits."""
    import torch
    sync()
    if not torch.equal(ok_, op):
        fail(f"NEE bundle ({what}): occlusion differs on "
             f"{int((ok_ != op).sum())} of {ok_.numel()} rays")
    if bool(ok_.view(K, -1)[3::4].any()):
        fail(f"NEE bundle ({what}): a dead ray (tcap <= tmin) reported "
             "occlusion")
    err = float((ok_.float() - op.float()).abs().max())
    print(f"kernels: any_hit_nee parity, {what}: {ok_.numel() // K} lanes "
          f"x K={K} = {ok_.numel()} rays, bits identical, occluded "
          f"{float(ok_.float().mean()):.4f}")
    return err


def phase_kernels(scene, K=8):
    """Each kernel against its plain version on >= 1M mixed rays and at
    every shape the main path gives it (65,536 primary lanes and 524,288
    bounce lanes of the 256^2 render at path_samples=8; closest hit with no
    exclusion on primary rays and one on bounces, NEE with one), then both
    timed at the bounce shape, where the timed outputs are compared too."""
    import torch
    from core_tpu_torch.geometry import cuda_intersect as ck
    from core_tpu_torch.geometry import intersect as isect
    gen = torch.Generator(device=scene.device).manual_seed(1234)
    tri = scene.tri
    primary, bounce = RES * RES, RES * RES * PATH_SAMPLES

    # closest hit: 1M mixed rays with two exclusions, then the primary shape
    rs, ex = _rays(scene, 262_144, 786_432, gen)
    ch_err = [check_closest(
        ck.closest_hit_cuda(tri, rs, ex, ex.flip(0)),
        isect.closest_hit_torch(tri, rs, ex, ex.flip(0)),
        "1M camera + interior rays, two exclusions")]
    rs_p, _ = _rays(scene, primary, 0, gen)
    rs_p = rs_p._replace(tmax=torch.full((primary,), -1.0,
                                         device=scene.device))
    ch_err.append(check_closest(ck.closest_hit_cuda(tri, rs_p),
                                isect.closest_hit_torch(tri, rs_p),
                                "primary shape, camera rays, no exclusion"))
    # the bounce shape, timed; the last timed outputs are compared
    rs_b, ex_b = _rays(scene, primary, bounce - primary, gen)
    ch_ms, hk = cuda_time_ms(lambda: ck.closest_hit_cuda(tri, rs_b, ex_b), 20)
    ch_plain, hp = cuda_time_ms(
        lambda: isect.closest_hit_torch(tri, rs_b, ex_b), 5, warmup=1)
    ch_err.append(check_closest(hk, hp, "bounce shape, timed"))

    # NEE: 1M rays with two exclusions, then the primary shape
    o3, tmin, dirs, tcaps, ex0, ex1 = _nee_bundle(scene, 131_072, K, gen)
    nee_err = [check_nee(
        ck.any_hit_nee_cuda(tri, o3, tmin, dirs, tcaps, ex0, ex1),
        isect.any_hit_nee_torch(tri, o3, tmin, dirs, tcaps, ex0, ex1),
        "1M rays, two exclusions", K)]
    o3, tmin, dirs, tcaps, ex0, _ = _nee_bundle(scene, primary, K, gen)
    nee_err.append(check_nee(
        ck.any_hit_nee_cuda(tri, o3, tmin, dirs, tcaps, ex0),
        isect.any_hit_nee_torch(tri, o3, tmin, dirs, tcaps, ex0),
        "primary shape", K))
    o3, tmin, dirs, tcaps, ex0, _ = _nee_bundle(scene, bounce, K, gen)
    nee_ms, ok_ = cuda_time_ms(lambda: ck.any_hit_nee_cuda(
        tri, o3, tmin, dirs, tcaps, ex0), 20)
    nee_plain, op = cuda_time_ms(lambda: isect.any_hit_nee_torch(
        tri, o3, tmin, dirs, tcaps, ex0), 5, warmup=1)
    nee_err.append(check_nee(ok_, op, "bounce shape, timed", K))

    # bounds at the timed bounce shape.  Closest hit: every lane tests
    # every triangle; bytes: the ray fields and exclusion in, the triangle
    # table, the outputs.  NEE: the work this bundle needs (_nee_work)
    T = tri.shape[0]
    ch_bound = bound(bounce * T * OPS_CLOSEST,
                     bounce * (8 * 4 + 4) + T * 36 + bounce * 16)
    _, lane_t, dir_t = isect.any_hit_nee_torch(tri, o3, tmin, dirs, tcaps,
                                               ex0, count_tests=True)
    nee_bound = bound(*_nee_work(tmin, tcaps, lane_t, dir_t, 0.0, T * 36, 4))
    print(f"kernels: closest_hit {bounce} lanes: kernel {ch_ms:.4f} ms, "
          f"plain {ch_plain:.4f} ms, bound {ch_bound[0]:.4f} ms "
          f"({ch_bound[1]})")
    print(f"kernels: any_hit_nee {bounce} lanes x K={K}: kernel "
          f"{nee_ms:.4f} ms, plain {nee_plain:.4f} ms, bound "
          f"{nee_bound[0]:.4f} ms ({nee_bound[1]})")
    return {
        "closest_hit": {"max_abs_err": max(ch_err), "ms": ch_ms,
                        "plain_ms": ch_plain, "bound_ms": ch_bound[0],
                        "bound_by": ch_bound[1], "library_ms": None},
        "any_hit_nee": {"max_abs_err": max(nee_err), "ms": nee_ms,
                        "plain_ms": nee_plain, "bound_ms": nee_bound[0],
                        "bound_by": nee_bound[1], "library_ms": None},
    }


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

def counted_rays(fn):
    """(fn(), the lanes of every closest-hit and shadow query fn traced),
    counted as bench_cuda.py counts them."""
    import bench_cuda
    return bench_cuda.counted_rays(fn)


def write_png(path: Path, img):
    """[H,W,>=3] float image -> 8-bit sRGB-ish PNG (gamma 2.2)."""
    import numpy as np
    rgb = (np.clip(img[..., :3], 0.0, 1.0) ** (1 / 2.2) * 255 + 0.5)
    rgb = rgb.astype(np.uint8)
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(raw, 6))
                     + chunk(b"IEND", b""))


def check_image(scene, img):
    """The repo's own means: finite, mean in band, walls coloured, the
    light the brightest region."""
    import torch
    from core_tpu_torch import scene as sm
    from core_tpu_torch import vec
    from core_tpu_torch.cameras import shoot_ray
    h, w = scene.camera.resy, scene.camera.resx
    if tuple(img.shape) != (h, w, 4):
        fail(f"image shape {tuple(img.shape)} != {(h, w, 4)}")
    if not bool(torch.isfinite(img).all()):
        fail("image has non-finite values")
    rgb = img[..., :3]
    mean = float(rgb.mean())
    if abs(mean - MEAN_REF) > MEAN_BAND * MEAN_REF:
        fail(f"image mean {mean} outside {MEAN_REF} +- {MEAN_BAND:.0%}")
    # primary hit material per pixel centre
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device),
                            indexing="ij")
    rays, _ = shoot_ray(scene.camera, xs.reshape(-1).float() + 0.5,
                        ys.reshape(-1).float() + 0.5)
    rs = vec.rays_to_soa(rays)
    hits = sm.closest_hit_s(scene, rs)
    mat = scene.geom.tri_mat[hits.prim.clamp_min(0).long()]
    mat = torch.where(hits.valid, mat, -1).reshape(h, w)
    red, green, light = 1, 2, 3                 # cornell_box material ids
    lum = rgb.mean(dim=-1)
    r_px = rgb[mat == red]
    g_px = rgb[mat == green]
    l_px = lum[mat == light]
    if r_px.numel() == 0 or g_px.numel() == 0 or l_px.numel() == 0:
        fail("red wall, green wall or light not visible")
    r_mean, g_mean = r_px.mean(dim=0), g_px.mean(dim=0)
    if not (r_mean[0] > r_mean[1] and r_mean[0] > r_mean[2]):
        fail(f"red wall not red-dominant: {r_mean.tolist()}")
    if not (g_mean[1] > g_mean[0] and g_mean[1] > g_mean[2]):
        fail(f"green wall not green-dominant: {g_mean.tolist()}")
    # the red wall is on the image's left, the green on its right
    cols = torch.arange(w, device=img.device).expand(h, w)
    if not (cols[mat == red].float().mean() < w / 2
            < cols[mat == green].float().mean()):
        fail("red wall not left of the green wall")
    brightest = int(lum.reshape(-1).argmax())
    if int(mat.reshape(-1)[brightest]) != light:
        fail("the brightest pixel is not on the light")
    if float(l_px.mean()) < 10 * float(lum.mean()):
        fail("the light is not the brightest region")
    return mean, r_mean.tolist(), g_mean.tolist(), float(l_px.mean())


def reset_counts():
    from core_tpu_torch.geometry import cuda_cluster, cuda_intersect
    cuda_intersect.reset_counts()
    cuda_cluster.reset_counts()


def all_launches():
    """Every kernel's launch count, by its row name in the kernels line."""
    from core_tpu_torch.geometry import cuda_cluster as cc
    from core_tpu_torch.geometry import cuda_intersect as ck
    wrappers = {"closest_hit": ck.closest_hit_cuda,
                "any_hit_nee": ck.any_hit_nee_cuda,
                "any_hit": ck.any_hit_cuda,
                "cluster_closest_hit": cc.closest_hit_flat_cuda,
                "cluster_any_hit": cc.any_hit_flat_cuda,
                "cluster_any_hit_nee": cc.any_hit_nee_flat_cuda,
                "grouped_closest_hit": cc.closest_hit_grouped_cuda,
                "grouped_any_hit": cc.any_hit_grouped_cuda}
    return {name: f.launches for name, f in wrappers.items()}


def brute_only(launches, what):
    """Fails unless kernels 1 and 2 launched and no other kernel did."""
    others = {k: n for k, n in launches.items()
              if k not in ("closest_hit", "any_hit_nee") and n}
    if min(launches["closest_hit"], launches["any_hit_nee"]) <= 0 or others:
        fail(f"{what}: kernels 1 and 2 must launch and no other: {launches}")


def plain_calls():
    from core_tpu_torch.geometry import cuda_cluster
    from core_tpu_torch.geometry import intersect as isect
    return sum(f.calls for f in (isect.closest_hit_torch, isect.any_hit_torch,
                                 isect.any_hit_nee_torch)
               + cuda_cluster.PLAIN)


def _cornell_opts(aa_samples):
    """The Cornell path's options (core_tpu's bench.py:44-49) in 1-spp
    chunks."""
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(
        aa_samples=aa_samples, spp_chunk=1, integrator="pathtracing",
        integrator_opts=PathOptions(path_samples=PATH_SAMPLES,
                                    bounces=BOUNCES, raydepth=2))


def image_digest(img):
    """The first 16 hex digits of the sha256 of an image's float32 bytes:
    equal digests, identical images."""
    import hashlib
    return hashlib.sha256(img.float().contiguous().cpu().numpy()
                          .tobytes()).hexdigest()[:16]


CORNELL_IMAGE = {}   # phase 3's image, for phase 24


def phase_render():
    import torch
    from core_tpu_torch.geometry import cuda_intersect as ck
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box

    scene = cornell_box(resx=RES, resy=RES, light_samples=LIGHT_SAMPLES,
                        device="cuda")
    if scene.intersector != "cuda":
        fail(f"scene on the card resolved intersector {scene.intersector!r}")
    opts = _cornell_opts(AA_SAMPLES)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    (img0, _), rays = counted_rays(lambda: render_image(scene, opts))
    sync()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    img, _ = render_image(scene, opts)
    sync()
    dt = time.perf_counter() - t0
    counts = {"closest_hit": ck.closest_hit_cuda.launches,
              "any_hit_nee": ck.any_hit_nee_cuda.launches}
    if min(counts.values()) <= 0:
        fail(f"a kernel of the main path never launched: {counts}")
    if plain_calls():
        fail(f"the plain versions ran {plain_calls()} times in the render")
    if not torch.equal(img0, img):
        fail("two identical requests rendered different images")
    mean, r_mean, g_mean, l_mean = check_image(scene, img)
    write_png(BUILD / "chip_smoke_cornell.png", img.cpu().numpy())
    CORNELL_IMAGE["render"] = img
    chunks = AA_SAMPLES
    print(f"render: {RES}x{RES} cornell, light_samples={LIGHT_SAMPLES}, "
          f"path_samples={PATH_SAMPLES}, bounces={BOUNCES}, "
          f"aa_samples={AA_SAMPLES} in {chunks} chunks")
    print(f"render: rays per request {rays}, warm-up {t_warm:.4f} s, "
          f"timed {dt:.4f} s, {rays / dt / 1e6:.3f} Mrays/s forward, "
          f"{dt * 1e3 / chunks:.3f} ms/chunk")
    print(f"render: launches {counts} (two requests), plain calls 0, "
          f"image mean {mean:.6f}, red wall {r_mean}, green wall {g_mean}, "
          f"light {l_mean:.3f}, image sha256 {image_digest(img)}, png "
          f"build/chip_smoke_cornell.png")
    return counts


# --------------------------------------------------------------------------
# phase 4
# --------------------------------------------------------------------------

def phase_slice():
    import torch
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box
    opts = _cornell_opts(1)
    imgs = {}
    for isec in ("cuda", "torch"):
        scene = cornell_box(resx=64, resy=64, light_samples=LIGHT_SAMPLES,
                            intersector=isec, device="cuda")
        imgs[isec], _ = render_image(scene, opts)
    sync()
    a, b = imgs["cuda"], imgs["torch"]
    if not torch.equal(a, b):
        fail(f"64^2 kernel and plain renders differ: max abs "
             f"{float((a - b).abs().max())}")
    print(f"slice: 64x64 render through the kernels == through the plain "
          f"versions (bit-identical), mean {float(a[..., :3].mean()):.6f}, "
          f"image sha256 {image_digest(a)}")


# --------------------------------------------------------------------------
# phase 4c: the Cornell path forward + backward
# --------------------------------------------------------------------------

FWDBWD_STEPS = 5
# the 64^2 gradients through the kernels against those through the plain
# versions: elementwise within GRAD_RTOL * max|g| of each leaf.  The forward
# passes are bit-identical (phase 4); the backward of index_select (the
# material-table gathers) accumulates with atomics in no fixed order, so a
# leaf's sums may differ by a few ulps
GRAD_RTOL = 1e-4


def _grads_ok(loss, grads, what):
    import torch
    if not bool(torch.isfinite(loss)):
        fail(f"fwd+bwd ({what}): the loss is {float(loss)}")
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    if bad:
        fail(f"fwd+bwd ({what}): non-finite gradients of {bad}")


def phase_fwdbwd():
    """bench_cuda.py's Cornell step at full width: value_and_grad of the
    bench loss (256^2, 1 spp, path_samples=8, bounces=5) through kernels 1
    and 2; then the 64^2 gradients through the kernels against those
    through the plain versions, and the geometry=True leaf set at 64^2.
    Returns the launches of each kernel in one fwd+bwd step."""
    import torch
    import bench_cuda as bc
    from core_tpu_torch import diff

    scene = bc.cornell_scene()
    loss_fn = bc.cornell_loss(scene)
    params = diff.extract_params(scene, geometry=False)
    step = diff.value_and_grad(loss_fn)
    with torch.no_grad():
        _, rays = counted_rays(lambda: loss_fn(params))
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    loss, grads = step(params)
    sync()
    launches = all_launches()
    brute_only(launches, "the fwd+bwd step")
    if plain_calls():
        fail(f"the plain versions ran {plain_calls()} times in the step")
    _grads_ok(loss, grads, f"{RES}^2")
    for leaf in ("mat.diffuse_color", "light0.color"):
        if float(grads[leaf].abs().max()) <= 0.0:
            fail(f"fwd+bwd: the gradient of {leaf} is zero")
    walls = bc.timed_steps(lambda: step(params), FWDBWD_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(walls)[len(walls) // 2]
    print(f"fwdbwd: {RES}x{RES} cornell, 1 spp, path_samples={PATH_SAMPLES}, "
          f"bounces={BOUNCES}, light_samples={LIGHT_SAMPLES}: loss "
          f"{float(loss):.6f}, rays per step {rays}, median step "
          f"{med * 1e3:.3f} ms over {FWDBWD_STEPS} (all "
          f"{[round(w * 1e3, 3) for w in walls]}), "
          f"{rays / med / 1e6:.3f} Mrays/s fwd+bwd; peak device memory "
          f"{peak:.3f} GiB")
    print(f"fwdbwd: launches in one fwd+bwd step {launches}, plain calls 0; "
          f"max |grad| "
          f"{ {k: float(g.abs().max()) for k, g in grads.items()} }")

    # 64^2: through the kernels against through the plain versions
    out = {}
    for isec in ("cuda", "torch"):
        sc = bc.cornell_scene(64, isec)
        out[isec] = diff.value_and_grad(bc.cornell_loss(sc))(
            diff.extract_params(sc, geometry=False))
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    _grads_ok(lk, gk, "64^2")
    if not torch.equal(lk, lp):
        fail(f"64^2 losses differ: kernels {float(lk)}, plain {float(lp)}")
    worst = 0.0
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        if err > GRAD_RTOL * scale:
            fail(f"64^2 gradient of {k}: kernels vs plain max abs "
                 f"{err} > {GRAD_RTOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    sc = bc.cornell_scene(64)
    lg, gg = diff.value_and_grad(bc.cornell_loss(sc))(
        diff.extract_params(sc, geometry=True))
    _grads_ok(lg, gg, "64^2 geometry=True")
    print(f"fwdbwd slice: 64x64 loss through the kernels == through the "
          f"plain versions ({float(lk):.6f}); gradients within {GRAD_RTOL} "
          f"x max|g| of each leaf (worst {worst:.3e}); geometry=True "
          f"leaves finite, max |grad| of light0.corner "
          f"{float(gg['light0.corner'].abs().max()):.6e}, geom.obj_offset "
          f"{float(gg['geom.obj_offset'].abs().max()):.6e}")
    return launches


# --------------------------------------------------------------------------
# phase 5: the 1M-triangle direct-light path
# --------------------------------------------------------------------------

def _big_opts():
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(aa_samples=1, spp_chunk=1, integrator="directlight",
                         integrator_opts=DirectOptions(raydepth=1))


def phase_big_build(res):
    from core_tpu_torch.scenes import big_scene
    t0 = time.perf_counter()
    scene = big_scene(resx=res, resy=res, ibl_samples=BIG_IBL,
                      sun_samples=BIG_SUN, device="cuda")
    sync()
    dt = time.perf_counter() - t0
    acc = scene.accel
    if scene.geom.n_tris != BIG_TRIS or acc is None:
        fail(f"big_scene has {scene.geom.n_tris} triangles, accel {acc}")
    print(f"big: {res}x{res} big_scene built in {dt:.3f} s (host build, "
          f"accel and IBL CDFs): {scene.geom.n_tris} triangles, "
          f"{acc.g_aabb.shape[0]} groups of {acc.group} clusters of <= "
          f"{acc.leaf}, intersector {scene.intersector}")
    return scene, dt


def _capture_chunk(scene):
    """Run one 1-spp chunk of the big scene with the grouped kernels'
    wrappers recorded at the scene's dispatch point: every closest-hit call
    and every NEE bundle (before and after re-bucketing).  Returns the
    calls in order."""
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import scene as sm
    from core_tpu_torch.geometry import cuda_cluster as cc
    from core_tpu_torch.render import render_chunk, scene_material_types
    route = sm._ROUTES["grouped", "cuda"]
    orig = dict(route)
    calls = []

    def closest(acc, rays, exclude_prim=None, exclude_prim2=None):
        calls.append(("closest", rays, exclude_prim, exclude_prim2))
        return orig["closest"](acc, rays, exclude_prim=exclude_prim,
                               exclude_prim2=exclude_prim2)

    def any_hit(acc, rays, ex0=None, ex1=None):
        calls.append(("any", rays, ex0, ex1))
        return cc.any_hit_grouped_cuda(acc, rays, ex0, ex1)

    rebucketed = sm._nee_rebucketed(any_hit)

    def nee(acc, o3, tmin, dirs, tcaps, exclude_prim=None,
            exclude_prim2=None):
        calls.append(("nee", o3, tmin, dirs, tcaps, exclude_prim,
                      exclude_prim2))
        return rebucketed(acc, o3, tmin, dirs, tcaps, exclude_prim,
                          exclude_prim2)

    route.update(closest=closest, nee=nee)
    try:
        import torch
        with torch.no_grad():
            render_chunk(scene, scene_material_types(scene), _big_opts(),
                         film_mod.make_film(BIG_RES, BIG_RES, device="cuda"),
                         0, 1, 0)
        sync()
    finally:
        route.update(orig)
    return calls


def _subset(rays, ex0, ex1, idx):
    from core_tpu_torch import vec
    sub = vec.RaysS(o=vec.V3(*[c[idx] for c in rays.o]),
                    d=vec.V3(*[c[idx] for c in rays.d]),
                    tmin=rays.tmin[idx], tmax=rays.tmax[idx])
    return sub, (None if ex0 is None else ex0[idx]), \
        (None if ex1 is None else ex1[idx])


def _accel_bytes(acc):
    return sum(t.numel() * t.element_size() for t in acc)


def _check_big_kernel(acc, what, kind, rays, ex0, ex1, gen):
    """One captured kernel input: the kernel on all lanes (timed), the
    plain version on a fixed random subset (timed, counting the triangle
    tests), every subset lane compared.  Returns the kernel's row."""
    import torch
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    n = rays.tmin.shape[0]
    kern = (cc.closest_hit_grouped_cuda if kind == "closest"
            else cc.any_hit_grouped_cuda)
    plain = (ci.closest_hit_grouped_torch if kind == "closest"
             else ci.any_hit_grouped_torch)
    ms, out = cuda_time_ms(lambda: kern(acc, rays, ex0, ex1), 3, warmup=1)
    idx = torch.randperm(n, generator=gen, device="cuda")[:SUBSET] \
        .sort().values
    sub, s0, s1 = _subset(rays, ex0, ex1, idx)
    plain_ms, (want, tests, slabs) = cuda_time_ms(
        lambda: plain(acc, sub, s0, s1, count_tests=True), 1, warmup=0)
    sync()
    m = idx.numel()
    if kind == "closest":
        got = type(out)(*[a[idx] for a in out])
        err = check_closest(got, want, f"{what}, {m} of {n} lanes")
        ops_per_test, out_bytes = OPS_CLOSEST, 16
        frac = float(got.valid.float().mean())
    else:
        got = out[idx]
        if not torch.equal(got, want):
            fail(f"grouped any hit ({what}): occlusion differs on "
                 f"{int((got != want).sum())} of {m} lanes")
        err = float((got.float() - want.float()).abs().max())
        ops_per_test, out_bytes = OPS_ANY, 1
        frac = float(out.float().mean())
    tests_est = float(tests.sum()) * n / m
    slabs_est = float(slabs.sum()) * n / m
    b = bound(tests_est * ops_per_test + slabs_est * OPS_SLAB,
              n * (8 * 4 + 2 * 4) + _accel_bytes(acc) + n * out_bytes)
    print(f"big: {what}: {n} lanes, kernel {ms:.4f} ms "
          f"({n / ms / 1e3:.3f} Mrays/s), plain {plain_ms:.4f} ms on "
          f"{m} lanes; {'hit' if kind == 'closest' else 'occluded'} "
          f"{frac:.4f}; triangle tests {tests_est / n:.1f} and slab tests "
          f"{slabs_est / n:.1f} per lane (plain count on the subset), "
          f"bound {b[0]:.4f} ms ({b[1]})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None,
            "lanes": n, "plain_lanes": m}


def phase_big_kernels(scene):
    """Kernels 7 and 8 at the big path's own shapes (see the header)."""
    import torch
    from core_tpu_torch.geometry import cluster_intersect as ci
    acc = scene.accel
    calls = _capture_chunk(scene)
    closest = [c for c in calls if c[0] == "closest"]
    anys = [c for c in calls if c[0] == "any"]
    nees = [c for c in calls if c[0] == "nee"]
    n_pix = BIG_RES * BIG_RES
    ibl = next(c for c in anys if c[1].tmin.numel() == 2 * BIG_IBL * n_pix)
    sun = next(c for c in anys if c[1].tmin.numel() == 2 * BIG_SUN * n_pix)
    print(f"big: one chunk made {len(closest)} closest-hit calls and "
          f"{len(nees)} NEE bundles")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rows = {
        "grouped_closest_hit": _check_big_kernel(
            acc, "camera closest hit", "closest", *closest[0][1:], gen),
        "grouped_any_hit": _check_big_kernel(
            acc, f"IBL bundle (K={2 * BIG_IBL}, re-bucketed)", "any",
            *ibl[1:], gen)}
    chain = _check_big_kernel(acc, "glossy-chain closest hit", "closest",
                              *closest[1][1:], gen)
    sun_row = _check_big_kernel(acc, f"sun bundle (K={2 * BIG_SUN}, "
                                "re-bucketed)", "any", *sun[1:], gen)
    for k, extra in (("grouped_closest_hit", chain),
                     ("grouped_any_hit", sun_row)):
        rows[k]["max_abs_err"] = max(rows[k]["max_abs_err"],
                                     extra["max_abs_err"])
    # the re-bucketing alone (key, sort, gathers, scatter) of each bundle
    def no_sweep(acc_, rays, *a):
        return torch.zeros(rays.tmin.shape[0], dtype=torch.bool,
                           device="cuda")

    for i, (_, o3, tmin, dirs, tcaps, e0, e1) in enumerate(nees):
        name = "IBL" if len(dirs) == 2 * BIG_IBL else "sun"
        hit = "camera" if i < len(nees) // 2 else "glossy-chain"
        sort_ms, _ = cuda_time_ms(lambda: ci.any_hit_nee_clusters_s(
            acc, o3, tmin, dirs, tcaps, e0, e1, no_sweep), 3, warmup=1)
        print(f"big: re-bucketing of the {name} bundle at the {hit} hit "
              f"({tmin.numel()} lanes x K={len(dirs)}; key, sort, gathers, "
              f"scatter): {sort_ms:.4f} ms")
    return rows


def phase_big_render(scene):
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.geometry import cuda_cluster as cc
    from core_tpu_torch.render import render_chunk, scene_material_types
    opts = _big_opts()
    types = scene_material_types(scene)

    def chunk(film):
        with torch.no_grad():
            return render_chunk(scene, types, opts, film, 0, 1, 0)

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    film, rays = counted_rays(lambda: chunk(
        film_mod.make_film(BIG_RES, BIG_RES, device="cuda")))
    sync()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(BIG_TIMED):
        film = chunk(film)
    sync()
    dt = time.perf_counter() - t0
    counts = {"grouped_closest_hit": cc.closest_hit_grouped_cuda.launches,
              "grouped_any_hit": cc.any_hit_grouped_cuda.launches}
    if min(counts.values()) <= 0:
        fail(f"a kernel of the big path never launched: {counts}")
    if plain_calls():
        fail(f"the plain versions ran {plain_calls()} times in the render")
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = film_mod.flush(film)
    if not bool(torch.isfinite(img).all()):
        fail("big-scene image has non-finite values")
    mean = float(img[..., :3].mean())
    sky = float(img[:4, :, 2].mean())
    if mean <= 0.05 or sky <= 0.05:
        fail(f"big-scene image mean {mean} or sky rows' blue {sky} <= 0.05")
    write_png(BUILD / "chip_smoke_big.png", img.cpu().numpy())
    per = dt / BIG_TIMED
    print(f"big: render {BIG_RES}x{BIG_RES} directlight raydepth=1, "
          f"ibl_samples={BIG_IBL}, sun_samples={BIG_SUN}: rays per chunk "
          f"{rays}, warm-up chunk {t_warm:.4f} s, {BIG_TIMED} timed chunks "
          f"{dt:.4f} s: {per:.4f} s/chunk, {rays / per / 1e6:.3f} Mrays/s "
          f"forward; peak device memory {peak:.3f} GiB")
    print(f"big: launches {counts} over {BIG_TIMED + 1} chunks, plain calls "
          f"0, image mean {mean:.6f}, sky rows blue {sky:.6f}, png "
          f"build/chip_smoke_big.png")
    return counts


def phase_big_slice():
    import dataclasses
    import torch
    from core_tpu_torch.render import render_image
    scene, _ = phase_big_build(64)
    imgs = {}
    for isec in ("cuda", "torch"):
        imgs[isec], _ = render_image(
            dataclasses.replace(scene, intersector=isec), _big_opts())
    sync()
    a, b = imgs["cuda"], imgs["torch"]
    if not torch.equal(a, b):
        fail(f"64^2 big-scene kernel and plain renders differ: max abs "
             f"{float((a - b).abs().max())}")
    print(f"big slice: 64x64 render of the 1M-triangle scene through the "
          f"kernels == through the plain versions (bit-identical), mean "
          f"{float(a[..., :3].mean()):.6f}")


# --------------------------------------------------------------------------
# phases 7-9: the 73.6k-triangle flat-cluster path and the dirac lights
# --------------------------------------------------------------------------

MESH_RES = 256
MESH_TIMED = 3
MESH_TRIS = 73_602
DIRAC_SMALL = dict(n_grid=24, torus_u=24, torus_v=12)   # 1,634 tris: brute
# image-mean references: the port's CPU renders of the same scenes at 64^2
# (aa_samples=1, directlight raydepth=1); the band allows for the
# resolution change
MEAN_REFS = {"mesh": 0.563554, "dirac flat": 0.577937, "dirac brute": 0.589587}
MESH_BAND = 0.10
MESH_IMAGES = {}     # each variant's rendered image, for phase 23


def phase_mesh_build(res, variant="mesh"):
    """mesh_scene() at its defaults, or its dirac variant ("dirac flat",
    or "dirac brute" at 1,634 triangles), built by the port alone."""
    from core_tpu_torch import scene as sm
    from core_tpu_torch.scenes import add_dirac_lights, mesh_builder, \
        mesh_scene
    t0 = time.perf_counter()
    if variant == "mesh":
        scene = mesh_scene(resx=res, resy=res, device="cuda")
    else:
        b = mesh_builder(res, res, device="cuda",
                         **(DIRAC_SMALL if variant == "dirac brute" else {}))
        scene = add_dirac_lights(b).compile_scene()
    sync()
    dt = time.perf_counter() - t0
    kind = sm.accel_kind(scene.accel)
    want = ("brute", 1634) if variant == "dirac brute" else ("flat",
                                                             MESH_TRIS)
    if (kind, scene.geom.n_tris) != want:
        fail(f"{variant}: {scene.geom.n_tris} triangles on the {kind} path, "
             f"expected {want}")
    clusters = "" if scene.accel is None else \
        f", {scene.accel.aabb.shape[0]} clusters of <= {scene.accel.leaf}"
    print(f"{variant}: {res}x{res} scene built in {dt:.3f} s (host build, "
          f"accel and IBL CDFs): {scene.geom.n_tris} triangles{clusters}, "
          f"lights {[type(x).__name__ for x in scene.lights]}")
    return scene, dt


@contextlib.contextmanager
def _recording(scene):
    """A context in which the scene's route records every call of its
    kernel wrappers at the dispatch point; its value is the list of calls
    as (query, args, kwargs), in order."""
    from core_tpu_torch import scene as sm
    route = sm._ROUTES[sm.accel_kind(scene.accel), scene.intersector]
    orig = dict(route)
    calls = []

    def recorded(q):
        def fn(*args, **kw):
            calls.append((q, args, kw))
            return orig[q](*args, **kw)
        return fn

    route.update({q: recorded(q) for q in orig})
    try:
        yield calls
    finally:
        route.update(orig)


def _capture_calls(scene, res, opts=None, spp=1, vol_aux=None):
    """Run one spp-sample chunk of a flat or brute scene (directlight at
    raydepth 1, or `opts`; `vol_aux`, precompute_attenuation's grids) with
    its route's kernel wrappers recorded.  Returns every call as (query,
    args, kwargs), in order."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    with _recording(scene) as calls, torch.no_grad():
        render_chunk(scene, scene_material_types(scene), opts or _big_opts(),
                     film_mod.make_film(res, res, device="cuda"), 0, spp, 0,
                     vol_aux=vol_aux)
        sync()
    return calls


def _check_captured(what, q, args, kw):
    """One captured input of kernel 1, 2, 3, 4, 5 or 6: the kernel on every
    lane (timed with CUDA events), the plain version on every lane (timed
    once, counting the triangle tests), compared lane by lane.  Returns the
    kernel's row."""
    import torch
    from core_tpu_torch.geometry import cluster_intersect as ci
    from core_tpu_torch.geometry import cuda_cluster as cc
    from core_tpu_torch.geometry import cuda_intersect as ck
    from core_tpu_torch.geometry import intersect as isect
    data = args[0]
    brute = isinstance(data, torch.Tensor)
    ex0, ex1 = kw.get("exclude_prim"), kw.get("exclude_prim2")
    ex_bytes = 4 * sum(e is not None for e in (ex0, ex1))
    data_bytes = data.numel() * 4 if brute else _accel_bytes(data)
    dead = ""
    if q == "nee":
        _, o3, tmin, dirs, tcaps = args
        n, K = tmin.shape[0], len(dirs)
        kern, plain = ((ck.any_hit_nee_cuda, isect.any_hit_nee_torch)
                       if brute else (cc.any_hit_nee_flat_cuda,
                                      ci.any_hit_nee_flat_torch))
        ms, out = cuda_time_ms(lambda: kern(data, o3, tmin, dirs, tcaps, ex0,
                                            ex1), 5, warmup=1)
        # the brute bundle (kernel 2) has no gates
        plain_ms, (want, lane_t, dir_t, *slabs) = cuda_time_ms(
            lambda: plain(data, o3, tmin, dirs, tcaps, ex0, ex1,
                          count_tests=True), 1, warmup=0)
        n_slabs = float(slabs[0].sum()) if slabs else 0.0
        ops, nbytes = _nee_work(tmin, tcaps, lane_t, dir_t, n_slabs,
                                data_bytes, ex_bytes)
        tests = f"{float(lane_t.sum()) / n:.1f} lane and " \
            f"{float(dir_t.sum()) / n:.1f} direction, slab tests " \
            f"{n_slabs / n:.1f}"
        lanes = f"{n} lanes x K={K}"
        caps = torch.stack(list(tcaps))
        is_dead = (caps > 0) & (caps <= tmin[None])
        dead = f"; dead lanes (all K rays) " \
            f"{float(is_dead.all(0).float().mean()):.4f}, dead rays " \
            f"{float(is_dead.float().mean()):.4f}"
    else:
        rays = args[1]
        n = rays.tmin.shape[0]
        kern, plain = {
            "closest": ((ck.closest_hit_cuda, isect.closest_hit_torch)
                        if brute else (cc.closest_hit_flat_cuda,
                                       ci.closest_hit_flat_torch)),
            "any": ((ck.any_hit_cuda, isect.any_hit_torch) if brute else
                    (cc.any_hit_flat_cuda, ci.any_hit_flat_torch))}[q]
        ms, out = cuda_time_ms(lambda: kern(data, rays, ex0, ex1), 5,
                               warmup=1)
        if brute and q == "closest":
            # kernel 1 tests every ray against every triangle
            plain_ms, want = cuda_time_ms(lambda: plain(data, rays, ex0, ex1),
                                          1, warmup=0)
            tests_n, slabs = torch.full((n,), data.shape[0]), []
        else:
            plain_ms, (want, tests_n, *slabs) = cuda_time_ms(
                lambda: plain(data, rays, ex0, ex1, count_tests=True), 1,
                warmup=0)
        per_test = OPS_CLOSEST if q == "closest" else OPS_ANY
        # the brute kernels 1 and 3 have no gates
        n_slabs = float(slabs[0].sum()) if slabs else 0.0
        ops = float(tests_n.sum()) * per_test + n_slabs * OPS_SLAB
        nbytes = n * (8 * 4 + ex_bytes + (16 if q == "closest" else 1)) \
            + data_bytes
        tests = f"{float(tests_n.sum()) / n:.1f}, slab tests " \
            f"{n_slabs / n:.1f}"
        lanes = f"{n} lanes"
        if q == "any":
            is_dead = (rays.tmax > 0) & (rays.tmax <= rays.tmin)
            dead = f"; dead rays {float(is_dead.float().mean()):.4f}"
    sync()
    if q == "closest":
        err = check_closest(out, want, what)
        same = all(torch.equal(getattr(out, f), getattr(want, f))
                   for f in "tuv")
        frac = f"hit {float(out.valid.float().mean()):.4f}, t/u/v " \
            f"{'identical' if same else 'within rtol'}"
    else:
        if not torch.equal(out, want):
            fail(f"{what}: occlusion differs on {int((out != want).sum())} "
                 f"of {out.numel()} rays")
        err = float((out.float() - want.float()).abs().max())
        frac = f"occluded {float(out.float().mean()):.4f}"
    b = bound(ops, nbytes)
    print(f"{what}: {lanes}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bits identical on every lane, {frac}{dead}; triangle tests per "
          f"lane {tests}, bound {b[0]:.4f} ms ({b[1]})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b[0], "bound_by": b[1], "library_ms": None}


def _gap(name, rows):
    """Print launches x (kernel - bound) over one chunk's captured
    launches of a kernel."""
    gap = sum(r["ms"] - r["bound_ms"] for r in rows)
    print(f"gap: {name}: {len(rows)} launches per chunk, kernel "
          f"{sum(r['ms'] for r in rows):.4f} ms, bound "
          f"{sum(r['bound_ms'] for r in rows):.4f} ms, gap {gap:.4f} ms")


def _merge(row, extra):
    row["max_abs_err"] = max(row["max_abs_err"], extra["max_abs_err"])


def phase_mesh_kernels(scene):
    """Kernels 4 and 6 at the mesh path's own shapes (see the header)."""
    calls = _capture_calls(scene, MESH_RES)
    closest = [c for c in calls if c[0] == "closest"]
    nees = [c for c in calls if c[0] == "nee"]
    print(f"mesh: one chunk made {len(closest)} closest-hit calls and "
          f"{len(nees)} NEE bundles (K = {[len(c[1][3]) for c in nees]})")
    ibl = next(c for c in nees if len(c[1][3]) == 16)
    sun = next(c for c in nees if len(c[1][3]) == 8)
    rows = {"cluster_closest_hit": _check_captured(
                "mesh: camera closest hit", *closest[0]),
            "cluster_any_hit_nee": _check_captured(
                "mesh: IBL bundle (K=16)", *ibl)}
    chain = _check_captured("mesh: glossy-chain closest hit", *closest[1])
    _merge(rows["cluster_closest_hit"], chain)
    _merge(rows["cluster_any_hit_nee"], _check_captured(
        "mesh: sun bundle (K=8)", *sun))
    _gap("kernel 4 (flat closest hit), mesh chunk",
         [rows["cluster_closest_hit"], chain])
    return rows


def phase_dirac_kernels(flat, brute):
    """Kernels 5 and 3 on every dirac light's captured shadow wavefronts
    (three lights, at the camera hit and at the glossy-chain hit); the row
    is the point light's camera-hit wavefront.  Also kernels 4 and 1 on
    each variant's two closest-hit calls (their errors only in the
    table)."""
    rows = {}
    for name, scene, kind, (kernel, k), (closest_kernel, kc) in (
            ("dirac flat", flat, "flat", ("cluster_any_hit", 5),
             ("cluster_closest_hit", 4)),
            ("dirac brute", brute, "brute", ("any_hit", 3),
             ("closest_hit", 1))):
        calls = _capture_calls(scene, MESH_RES)
        anys = [c for c in calls if c[0] == "any"]
        closest = [_check_captured(f"{name}: {hit} closest hit", *c)
                   for hit, c in zip(("camera", "glossy-chain"),
                                     [c for c in calls if c[0] == "closest"])]
        rows[closest_kernel] = {"max_abs_err": max(
            r["max_abs_err"] for r in closest)}
        _gap(f"kernel {kc} ({kind} closest hit), {name} chunk", closest)
        if len(anys) != 6:
            fail(f"{name}: {len(anys)} shadow wavefronts in a chunk, not 6")
        lights = ("point", "spot", "directional")
        per = []
        for i, call in enumerate(anys):
            per.append(_check_captured(
                f"{name}: {lights[i % 3]} light shadow rays "
                f"({'camera' if i < 3 else 'glossy-chain'} hit)", *call))
        rows[kernel] = per[0]
        for row in per[1:]:
            _merge(rows[kernel], row)
        _gap(f"kernel {k} ({kind} any hit), {name} chunk", per)
    return rows


def phase_cornell_kernels(scene):
    """Kernels 1 and 2 on the inputs captured from one 256^2 chunk of the
    Cornell path (see the header); the table keeps phase 2's rows, and
    these merge their errors into them."""
    calls = _capture_calls(scene, RES, _cornell_opts(AA_SAMPLES))
    closest = [c for c in calls if c[0] == "closest"]
    nees = [c for c in calls if c[0] == "nee"]
    if len(closest) != BOUNCES + 1 or len(nees) != BOUNCES + 1:
        fail(f"cornell: {len(closest)} closest-hit calls and {len(nees)} "
             f"NEE bundles in a chunk, not {BOUNCES + 1} each")
    rows = {}
    for kernel, q, got in (("closest_hit", "closest", closest),
                           ("any_hit_nee", "nee", nees)):
        per = [_check_captured(
            f"cornell: {'primary' if i == 0 else f'bounce {i}'} "
            f"{'closest hit' if q == 'closest' else 'NEE bundle'}", *c)
            for i, c in enumerate(got)]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per)}
        _gap(f"kernel {1 if q == 'closest' else 2} (brute "
             f"{'closest hit' if q == 'closest' else 'NEE bundle'}), "
             "cornell chunk", per)
    return rows


def phase_mesh_render(scene, name, kernels, timed):
    """Counts at 0, one warm-up and `timed` 1-spp chunks (rays counted on
    the warm-up), the counts read: every kernel of `kernels` (name ->
    wrapper) launched and no plain version ran; image checks."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    opts = _big_opts()
    types = scene_material_types(scene)
    res = scene.camera.resx

    def chunk(film):
        with torch.no_grad():
            return render_chunk(scene, types, opts, film, 0, 1, 0)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync()
    t0 = time.perf_counter()
    film, rays = counted_rays(lambda: chunk(
        film_mod.make_film(res, res, device="cuda")))
    sync()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(timed):
        film = chunk(film)
    sync()
    dt = time.perf_counter() - t0
    counts = {k: f.launches for k, f in kernels.items()}
    if min(counts.values()) <= 0:
        fail(f"{name}: a kernel of the path never launched: {counts}")
    if plain_calls():
        fail(f"{name}: the plain versions ran {plain_calls()} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = film_mod.flush(film)
    if not bool(torch.isfinite(img).all()):
        fail(f"{name}: image has non-finite values")
    mean = float(img[..., :3].mean())
    sky = float(img[:4, :, 2].mean())
    ref = MEAN_REFS[name]
    if abs(mean - ref) > MESH_BAND * ref or sky <= 0.5:
        fail(f"{name}: image mean {mean} outside {ref} +- {MESH_BAND:.0%}, "
             f"or sky rows' blue {sky} <= 0.5")
    png = f"chip_smoke_{name.replace(' ', '_')}.png"
    write_png(BUILD / png, img.cpu().numpy())
    MESH_IMAGES[name] = img
    per = dt / timed
    print(f"{name}: render {res}x{res} directlight raydepth=1: rays per "
          f"chunk {rays}, warm-up chunk {t_warm:.4f} s, {timed} timed "
          f"chunks {dt:.4f} s: {per * 1e3:.3f} ms/chunk, "
          f"{rays / per / 1e6:.3f} Mrays/s forward; peak device memory "
          f"{peak:.3f} GiB")
    print(f"{name}: launches {counts} over {timed + 1} chunks, plain calls "
          f"0, image mean {mean:.6f}, sky rows blue {sky:.6f}, png "
          f"build/{png}")
    return counts


def phase_mesh_slice():
    """64^2 renders of mesh_scene and both dirac sizes, through the kernels
    and through the plain versions on the card: identical images."""
    import dataclasses
    import torch
    from core_tpu_torch.render import render_image
    for variant in ("mesh", "dirac flat", "dirac brute"):
        scene, _ = phase_mesh_build(64, variant)
        imgs = [render_image(dataclasses.replace(scene, intersector=isec),
                             _big_opts())[0] for isec in ("cuda", "torch")]
        sync()
        if not torch.equal(*imgs):
            fail(f"64^2 {variant} kernel and plain renders differ: max abs "
                 f"{float((imgs[0] - imgs[1]).abs().max())}")
        print(f"mesh slice: 64x64 {variant} render through the kernels == "
              f"through the plain versions (bit-identical), mean "
              f"{float(imgs[0][..., :3].mean()):.6f}")


# --------------------------------------------------------------------------
# phases 10-12: the specular chains and the composite materials
# --------------------------------------------------------------------------

# name -> (block materials, integrator); full width, not cut: the
# dl_spec / pt_spec / dl_blend goldens' scenes and options at 256^2
SPEC = {"cornell256_spec_pt_fwd": (("glossy", "glass"), "pathtracing"),
        "cornell256_spec_dl_fwd": (("glossy", "glass"), "directlight"),
        "cornell256_blend_dl_fwd": (("blend_diff", "blend_cross"),
                                    "directlight")}
SPEC_LIGHT_SAMPLES = 8
SPEC_AA = 4                  # timed 1-spp chunks (one request)
BLOCK_DIFF = 0.02            # least mean |rgb| change of the block pixels


def _spec_scene(res, blocks, intersector="auto", dispersion=0.0):
    """The Cornell box with the given blocks at light_samples=8; the glass
    rows' dispersion set to `dispersion` (tests/test_spectrum.py's 0.1)."""
    import dataclasses
    import torch
    from core_tpu_torch.materials.base import MatType
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=res, resy=res, light_samples=SPEC_LIGHT_SAMPLES,
                        block_materials=blocks, intersector=intersector,
                        device="cuda")
    if dispersion:
        m = scene.materials
        disp = torch.where(m.mtype == int(MatType.GLASS), dispersion,
                           m.dispersion)
        scene = dataclasses.replace(scene,
                                    materials=m._replace(dispersion=disp))
    return scene


def _spec_opts(integrator, aa=SPEC_AA):
    """pt_spec's PathOptions(path_samples=8, bounces=3, raydepth=5) or the
    dl goldens' DirectOptions(raydepth=5), in 1-spp chunks."""
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.render import RenderOptions
    if integrator == "pathtracing":
        return RenderOptions(aa_samples=aa, spp_chunk=1,
                             integrator="pathtracing",
                             integrator_opts=PathOptions(
                                 path_samples=8, bounces=3, raydepth=5))
    return RenderOptions(aa_samples=aa, spp_chunk=1,
                         integrator_opts=DirectOptions(raydepth=5))


def _chain_live(scene, opts):
    """The share of live lanes in each chain depth's closest-hit wavefront
    of one 1-spp camera wavefront (pixel centres, sample 0)."""
    import torch
    from core_tpu_torch.cameras import shoot_ray
    from core_tpu_torch.render import (_INTEGRATORS, _pixel_grid_raster,
                                       scene_material_types)
    from core_tpu_torch.sampling import qmc
    cam = scene.camera
    x, y, s = _pixel_grid_raster(cam.resy, cam.resx, 1, scene.device)
    offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    rays, _ = shoot_ray(cam, x.float() + 0.5, y.float() + 0.5)
    stats = {}
    with torch.no_grad():
        _INTEGRATORS[opts.integrator][0](scene, scene_material_types(scene),
                                         rays, s, offs, opts.integrator_opts,
                                         stats=stats)
    return [round(float(c) / x.numel(), 4) for c in stats["chain_live"]]


def _block_pixels(scene):
    """[H, W] bool: pixels whose centre's camera ray hits a block (the
    materials after cornell_box's four)."""
    import torch
    from core_tpu_torch import scene as sm
    from core_tpu_torch import vec
    from core_tpu_torch.cameras import shoot_ray
    h, w = scene.camera.resy, scene.camera.resx
    ys, xs = torch.meshgrid(torch.arange(h, device=scene.device),
                            torch.arange(w, device=scene.device),
                            indexing="ij")
    rays, _ = shoot_ray(scene.camera, xs.reshape(-1).float() + 0.5,
                        ys.reshape(-1).float() + 0.5)
    hits = sm.closest_hit_s(scene, vec.rays_to_soa(rays))
    mat = scene.geom.tri_mat[hits.prim.clamp_min(0).long()]
    return (hits.valid & (mat >= 4)).reshape(h, w)


def _render_chunks(scene, opts, chunks):
    """`chunks` 1-spp chunks (samples 0..chunks-1) into one film; the
    flushed image."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    types = scene_material_types(scene)
    film = film_mod.make_film(scene.camera.resy, scene.camera.resx,
                              device=scene.device)
    with torch.no_grad():
        for s in range(chunks):
            film = render_chunk(scene, types, opts, film, 0, 1, s)
    return film_mod.flush(film)


def phase_spec(name):
    """One chain configuration at 256^2: counts at 0, a warm-up chunk (rays
    counted), SPEC_AA timed 1-spp chunks; kernels 1 and 2 launched, no
    plain version; the live-lane share per chain depth; a finite image
    whose block pixels differ from the white-block box's; a 64^2 slice
    through the kernels bit-identical to one through the plain versions.
    Returns the launches of every kernel per chunk."""
    import torch
    blocks, integ = SPEC[name]
    scene = _spec_scene(RES, blocks)
    if scene.intersector != "cuda" or scene.accel is not None:
        fail(f"{name}: not on the brute kernels ({scene.intersector})")
    opts = _spec_opts(integ)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync()
    t0 = time.perf_counter()
    _, rays = counted_rays(lambda: _render_chunks(scene, opts, 1))
    sync()
    t_warm = time.perf_counter() - t0
    launches = all_launches()
    brute_only(launches, name)
    t0 = time.perf_counter()
    img = _render_chunks(scene, opts, SPEC_AA)
    sync()
    dt = time.perf_counter() - t0
    total = all_launches()
    if any(total[k] != (SPEC_AA + 1) * launches[k] for k in total):
        fail(f"{name}: launches per chunk {launches}, in all {total}")
    if plain_calls():
        fail(f"{name}: the plain versions ran {plain_calls()} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    live = _chain_live(scene, opts)
    if not bool(torch.isfinite(img).all()):
        fail(f"{name}: image has non-finite values")
    white = _render_chunks(_spec_scene(RES, ("white", "white")), opts,
                           SPEC_AA)
    blk = _block_pixels(scene)
    change = float((img[..., :3] - white[..., :3]).abs()[blk].mean())
    if not change > BLOCK_DIFF:
        fail(f"{name}: block pixels differ from the white blocks' by "
             f"{change} <= {BLOCK_DIFF}")
    write_png(BUILD / f"chip_smoke_{name}.png", img.cpu().numpy())
    per = dt / SPEC_AA
    print(f"{name}: {RES}x{RES} {integ}, blocks {blocks}, light_samples="
          f"{SPEC_LIGHT_SAMPLES}, {opts.integrator_opts}: rays per chunk "
          f"{rays}, warm-up chunk {t_warm:.4f} s, {SPEC_AA} timed chunks "
          f"{dt:.4f} s: {per * 1e3:.3f} ms/chunk, {rays / per / 1e6:.3f} "
          f"Mrays/s forward; peak device memory {peak:.3f} GiB")
    print(f"{name}: launches per chunk {launches}, plain calls 0; "
          f"live-lane share per chain depth {live}; "
          f"image mean {float(img[..., :3].mean()):.6f}, block pixels "
          f"{int(blk.sum())} differ from the white blocks' by {change:.6f}; "
          f"image sha256 {image_digest(img)}, png build/chip_smoke_{name}"
          ".png")
    # 64^2: through the kernels == through the plain versions
    imgs = [_render_chunks(_spec_scene(64, blocks, isec), _spec_opts(integ),
                           1) for isec in ("cuda", "torch")]
    sync()
    if not torch.equal(*imgs):
        fail(f"{name}: 64^2 kernel and plain renders differ: max abs "
             f"{float((imgs[0] - imgs[1]).abs().max())}")
    print(f"{name} slice: 64x64 render through the kernels == through the "
          f"plain versions (bit-identical), mean "
          f"{float(imgs[0][..., :3].mean()):.6f}")
    return launches


def phase_spec_extras():
    """Once: the 64^2 dispersive variant of the glossy + glass box
    (directlight, raydepth 5) finite and different from the plain one;
    the 64^2 fwd+bwd of cornell256_spec_pt_fwd's scene (one 1-spp chunk,
    mean squared RGB against zero, extract_params(geometry=False)) with
    finite gradients, nonzero for mat.filter_color and mat.mirror_color
    on the glass row, and through the kernels within GRAD_RTOL x max|g|
    of the gradients through the plain versions."""
    import torch
    from core_tpu_torch import diff
    from core_tpu_torch.materials.base import MatType
    blocks = SPEC["cornell256_spec_pt_fwd"][0]
    dl = _spec_opts("directlight", 1)
    plain_img = _render_chunks(_spec_scene(64, blocks), dl, 1)
    disp_img = _render_chunks(_spec_scene(64, blocks, dispersion=0.1), dl, 1)
    if not bool(torch.isfinite(disp_img).all()):
        fail("dispersion: image has non-finite values")
    moved = float((disp_img - plain_img).abs().max())
    if not moved > 0.0:
        fail("dispersion: the dispersive image equals the plain one")
    print(f"dispersion: 64x64 glossy+glass box, glass dispersion 0.1, "
          f"directlight raydepth 5: finite, max |rgb| change {moved:.6f} "
          f"over the plain image, mean {float(disp_img[..., :3].mean()):.6f}"
          f" vs {float(plain_img[..., :3].mean()):.6f}")

    out = {}
    for isec in ("cuda", "torch"):
        sc = _spec_scene(64, blocks, isec)
        target = torch.zeros((64, 64, 4), device=sc.device)
        loss_fn = diff.make_loss_fn(sc, _spec_opts("pathtracing", 1), 1,
                                    target)
        out[isec] = diff.value_and_grad(loss_fn)(
            diff.extract_params(sc, geometry=False))
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    _grads_ok(lk, gk, "64^2 spec")
    glass = int(torch.nonzero(sc.materials.mtype == int(MatType.GLASS))[0])
    for leaf in ("mat.filter_color", "mat.mirror_color"):
        if float(gk[leaf][glass].abs().max()) <= 0.0:
            fail(f"spec fwd+bwd: the gradient of {leaf} on the glass row "
                 "is zero")
    if not torch.equal(lk, lp):
        fail(f"spec 64^2 losses differ: kernels {float(lk)}, plain "
             f"{float(lp)}")
    worst = 0.0
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        if err > GRAD_RTOL * scale:
            fail(f"spec 64^2 gradient of {k}: kernels vs plain max abs "
                 f"{err} > {GRAD_RTOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"spec fwdbwd: 64x64 glossy+glass box, path_samples=8, bounces=3, "
          f"raydepth=5: loss through the kernels == through the plain "
          f"versions ({float(lk):.6f}); gradients finite, within "
          f"{GRAD_RTOL} x max|g| of each leaf (worst {worst:.3e}); glass row "
          f"|grad| filter_color "
          f"{float(gk['mat.filter_color'][glass].abs().max()):.6e}, "
          f"mirror_color "
          f"{float(gk['mat.mirror_color'][glass].abs().max()):.6e}")


# --------------------------------------------------------------------------
# phases 13-15: the integrator options; phase 16: the fold table
# --------------------------------------------------------------------------

OPT_AA = 2                   # timed 1-spp chunks of each option phase
AO_SAMPLES = 32
EQUAL_SHARE = 0.999          # least share of glass pixels equal to opaque


def pane_scene(res, intersector="auto", device="cuda"):
    """tests/test_shadow_sentinel.py:141-193's scene, built by the port: a
    white 40 x 40 floor at y = 0, a green pane (transparency 0.8) at y = 5
    over its -x half, a point light at (-7, 30, 0), the camera 15 above
    the floor looking down."""
    from core_tpu_torch.cameras import make_perspective
    from core_tpu_torch.geometry.mesh import MeshAssembler
    from core_tpu_torch.lights.point import make_point_light
    from core_tpu_torch.materials.base import (MaterialDef,
                                               build_material_table)
    from core_tpu_torch.scene import Scene, resolve_intersector
    a = MeshAssembler()
    m = a.start_mesh()
    for quad, mat in ((((-20, 0, -20), (-20, 0, 20), (20, 0, 20),
                        (20, 0, -20)), 0),
                      (((-12, 5, -12), (-12, 5, 12), (-2, 5, 12),
                        (-2, 5, -12)), 1)):
        ids = [a.add_vertex(m, *q) for q in quad]
        a.add_triangle(m, ids[0], ids[1], ids[2], mat)
        a.add_triangle(m, ids[0], ids[2], ids[3], mat)
    mats = [MaterialDef(name="white", diffuse_color=(0.8, 0.8, 0.8)),
            MaterialDef(name="pane", diffuse_color=(0.1, 0.9, 0.1),
                        transparency=0.8, transmit_filter=1.0,
                        diffuse_strength=0.2)]
    return Scene(geom=a.build(device),
                 materials=build_material_table(mats, device),
                 lights=(make_point_light(pos=(-7, 30, 0), color=(1, 1, 1),
                                          power=4000.0, device=device),),
                 camera=make_perspective(pos=(0, 15, 0), look=(0, 0, 0),
                                         up=(0, 15, 1), resx=res, resy=res,
                                         focal=1.0, device=device),
                 has_specular=True, has_transparency=True, mat_types=(0,),
                 intersector=resolve_intersector(intersector, device))


def option_config(name, res, intersector="auto", device="cuda", **extra):
    """(scene, RenderOptions in 1-spp chunks) of an option phase; `extra`
    overrides DirectOptions fields."""
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.render import RenderOptions
    from core_tpu_torch.scenes import cornell_box
    if name == "pane256_ts_dl_fwd":
        scene = pane_scene(res, intersector, device)
        iopts = dict(transp_shad=True, shadow_depth=4)
    else:
        blocks = ("glass", "glass") if name == "cornell256_glass_ts_dl_fwd" \
            else ("white", "white")
        scene = cornell_box(resx=res, resy=res, light_samples=LIGHT_SAMPLES,
                            block_materials=blocks, intersector=intersector,
                            device=device)
        iopts = (dict(raydepth=5, use_ao=True, ao_samples=AO_SAMPLES,
                      ao_dist=100.0) if name == "cornell256_ao_dl_fwd"
                 else dict(raydepth=5, transp_shad=True))
    iopts.update(extra)
    return scene, RenderOptions(aa_samples=OPT_AA, spp_chunk=1,
                                integrator_opts=DirectOptions(**iopts))


OPTIONS = ("cornell256_ao_dl_fwd", "pane256_ts_dl_fwd",
           "cornell256_glass_ts_dl_fwd")


def _pane_floor_light(scene, transp_shad):
    """core_tpu's test_transparent_shadows (tests/test_shadow_sentinel.py:
    175-189) on the card: the mean direct light of 16 floor points under
    the pane, with opaque or transparent shadows (shadow_depth 4)."""
    import torch
    from core_tpu_torch import scene as sm
    from core_tpu_torch.integrators import common
    from core_tpu_torch.render import scene_material_types
    from core_tpu_torch.vec import SPS, V3
    dev = scene.device
    n = 16
    xs = torch.tensor([-8.0, -7.0, -6.0, -7.5] * 4, device=dev)
    zero, one = torch.zeros(n, device=dev), torch.ones(n, device=dev)
    up = V3(zero, one, zero)
    ids = torch.zeros(n, dtype=torch.int32, device=dev)
    sp = SPS(p=V3(xs, zero, torch.linspace(-1.0, 1.0, n, device=dev)),
             n=up, ng=up, nu=V3(one, zero, zero), nv=V3(zero, zero, one),
             u=zero, v=zero, mat=ids, light=ids - 1, prim=ids, obj=ids)
    with torch.no_grad():
        col = common.estimate_all_direct_s(
            scene, scene_material_types(scene),
            sm.material_params_s(scene, sp), sp, up,
            torch.arange(n, device=dev), torch.zeros(n, dtype=torch.int64,
                                                     device=dev),
            torch.ones(n, dtype=torch.bool, device=dev),
            transp_shad=transp_shad, shadow_depth=4)
    return [float(c.mean()) for c in col]


def phase_option(name):
    """One option configuration at 256^2: counts at 0, a warm-up chunk
    (rays counted), OPT_AA timed 1-spp chunks, the launches of all eight
    kernels per chunk; each configuration's own checks; a 64^2 render
    through the kernels identical to one through the plain versions.
    Returns the launches per chunk."""
    import torch
    scene, opts = option_config(name, RES)
    if scene.intersector != "cuda" or scene.accel is not None:
        fail(f"{name}: not on the brute kernels ({scene.intersector})")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync()
    t0 = time.perf_counter()
    _, rays = counted_rays(lambda: _render_chunks(scene, opts, 1))
    sync()
    t_warm = time.perf_counter() - t0
    launches = all_launches()
    t0 = time.perf_counter()
    img = _render_chunks(scene, opts, OPT_AA)
    sync()
    dt = time.perf_counter() - t0
    total = all_launches()
    if any(total[k] != (OPT_AA + 1) * launches[k] for k in total):
        fail(f"{name}: launches per chunk {launches}, in all {total}")
    if plain_calls():
        fail(f"{name}: the plain versions ran {plain_calls()} times")
    peak = torch.cuda.max_memory_allocated() / 2**30
    if not bool(torch.isfinite(img).all()):
        fail(f"{name}: image has non-finite values")
    others = {k: v for k, v in launches.items()
              if k not in ("closest_hit", "any_hit_nee", "any_hit") and v}
    if others or launches["closest_hit"] <= 0:
        fail(f"{name}: kernel 1 must launch and no cluster kernel: "
             f"{launches}")
    extra = ""
    if name == "cornell256_ao_dl_fwd":
        # one occlusion wavefront per AO sample, at the camera hits only
        # (the white box has no chain)
        if launches["any_hit"] != AO_SAMPLES:
            fail(f"{name}: kernel 3 launched {launches['any_hit']} times a "
                 f"chunk, not once per AO sample ({AO_SAMPLES})")
    else:
        # transparent shadows walk closest hits: no NEE bundle, no any hit
        if launches["any_hit_nee"] or launches["any_hit"]:
            fail(f"{name}: a shadow kernel launched under transp_shad: "
                 f"{launches}")
    if name == "pane256_ts_dl_fwd":
        blocked = _pane_floor_light(scene, False)
        filtered = _pane_floor_light(scene, True)
        if not (max(blocked) < 1e-4 and filtered[1] > 1e-3
                and filtered[1] > 3.0 * max(filtered[0], filtered[2])):
            fail(f"{name}: floor under the pane, opaque {blocked}, "
                 f"transparent {filtered}")
        extra = (f"; floor under the pane: opaque shadows {blocked} (max < "
                 f"1e-4), transparent {filtered} (green > 1e-3 and > 3x "
                 "red, blue)")
    if name == "cornell256_glass_ts_dl_fwd":
        _, opaque_opts = option_config(name, RES, transp_shad=False)
        opaque = _render_chunks(scene, opaque_opts, OPT_AA)
        same = (img == opaque).all(dim=-1)
        share = float(same.float().mean())
        diff = float((img - opaque).abs().max())
        if share < EQUAL_SHARE:
            fail(f"{name}: only {share} of the pixels equal the "
                 f"opaque-shadow image's (max abs difference {diff})")
        extra = (f"; equal to the opaque-shadow image on {share:.6f} of the "
                 f"pixels ({int((~same).sum())} differ, max abs {diff:.6e})")
    write_png(BUILD / f"chip_smoke_{name}.png", img.cpu().numpy())
    per = dt / OPT_AA
    print(f"{name}: {RES}x{RES}, {opts.integrator_opts}: rays per chunk "
          f"{rays}, warm-up chunk {t_warm:.4f} s, {OPT_AA} timed chunks "
          f"{dt:.4f} s: {per * 1e3:.3f} ms/chunk, {rays / per / 1e6:.3f} "
          f"Mrays/s forward; peak device memory {peak:.3f} GiB")
    print(f"{name}: launches per chunk {launches}, plain calls 0; image "
          f"mean {float(img[..., :3].mean()):.6f}, sha256 "
          f"{image_digest(img)}, png build/chip_smoke_{name}.png{extra}")
    imgs = [_render_chunks(*option_config(name, 64, isec), 1)
            for isec in ("cuda", "torch")]
    sync()
    if not torch.equal(*imgs):
        fail(f"{name}: 64^2 kernel and plain renders differ: max abs "
             f"{float((imgs[0] - imgs[1]).abs().max())}")
    print(f"{name} slice: 64x64 render through the kernels == through the "
          f"plain versions (bit-identical), mean "
          f"{float(imgs[0][..., :3].mean()):.6f}")
    return launches


# bench.py:52-68's folding table: row -> PathOptions folding fields
FOLD_ROWS = {"fold 0": {},
             "fold 2 plain": dict(fold_interval=2, fold_sort=False),
             "fold 2 sorted": dict(fold_interval=2),
             "fold 1 sorted": dict(fold_interval=1),
             "fold 1 start 2 sorted": dict(fold_interval=1, fold_start=2)}
FOLD_TIMED = 3
FOLD_RES = 64                # the equal-spp MSE renders
FOLD_SPP = 4                 # spp of each row's render; the reference 16x


def _fold_render(scene, fold, spp, pass_offs):
    """A flushed FOLD_RES^2 render of spp samples (in chunks of at most 16)
    under the Cornell options with the given folding; its samples' QMC
    streams start at pixel sample pass_offs."""
    import torch
    import bench_cuda as bc
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import (RenderOptions, render_chunk,
                                       scene_material_types)
    opts = RenderOptions(aa_samples=spp, integrator="pathtracing",
                         integrator_opts=bc.cornell_opts(**fold)
                         .integrator_opts)
    film = film_mod.make_film(FOLD_RES, FOLD_RES, device=scene.device)
    with torch.no_grad():
        for s0 in range(0, spp, 16):
            film = render_chunk(scene, scene_material_types(scene), opts,
                                film, pass_offs, min(16, spp - s0), s0)
    return film_mod.flush(film)


def phase_fold_table():
    """bench.py:52-68's fold table on the card: each row's
    cornell256_pt_fwdbwd step (rays counted as bench_cuda counts them; the
    median of FOLD_TIMED steps, timed in turns: one step of each row in
    row order, then in reverse order, then in row order), its active-lane
    fraction and useful Mrays/s, peak memory, and the equal-spp MSE of a
    FOLD_RES^2 render of FOLD_SPP samples against a fold-0 reference of
    16 x FOLD_SPP samples on other QMC streams; then the folded 64^2
    gradients (fold 2 sorted) through the kernels within GRAD_RTOL x
    max|g| of the plain versions'.  Returns each row's launches per
    step."""
    import torch
    import bench_cuda as bc
    from core_tpu_torch import diff
    scene = bc.cornell_scene()
    small = bc.cornell_scene(FOLD_RES)
    ref = _fold_render(small, {}, 16 * FOLD_SPP, 0)
    params = diff.extract_params(scene, geometry=False)
    rows, steps, launches, mse0 = {}, {}, {}, None
    for row, fold in FOLD_ROWS.items():
        loss_fn = bc.cornell_loss(scene, **fold)
        step = steps[row] = diff.value_and_grad(loss_fn)
        with torch.no_grad():
            _, rays = counted_rays(lambda: loss_fn(params))
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        loss, grads = step(params)
        sync()
        launches[row] = all_launches()
        brute_only(launches[row], f"fold table {row}")
        _grads_ok(loss, grads, row)
        img = _fold_render(small, fold, FOLD_SPP, 16 * FOLD_SPP)
        mse = float(((img[..., :3] - ref[..., :3]) ** 2).mean())
        mse0 = mse if mse0 is None else mse0
        rows[row] = {"rays": rays,
                     "active_lane_fraction": round(
                         bc.active_lane_fraction(scene, **fold), 4),
                     "peak_mib": round(torch.cuda.max_memory_allocated()
                                       / 2**20, 1),
                     "mse": mse,
                     "mse_vs_fold0_pct": round((mse / mse0 - 1) * 100, 2),
                     "launches": {k: v for k, v in launches[row].items()
                                  if v},
                     "steps_ms": []}
    order = list(FOLD_ROWS)
    for turn in range(FOLD_TIMED):
        for row in (order if turn % 2 == 0 else order[::-1]):
            wall = bc.timed_steps(lambda: steps[row](params), 1)[0]
            rows[row]["steps_ms"].append(round(wall * 1e3, 3))
    for row, r in rows.items():
        med = sorted(r["steps_ms"])[len(r["steps_ms"]) // 2]
        mrays = r["rays"] / med * 1e-3
        r.update(step_ms=med, mrays=round(mrays, 3),
                 useful_mrays=round(mrays * r["active_lane_fraction"], 3))
        print(f"fold table {row}: {json.dumps(r)}")
    print(f"fold table: {RES}x{RES} cornell fwd+bwd steps (path_samples="
          f"{PATH_SAMPLES}, bounces={BOUNCES}, light_samples={LIGHT_SAMPLES}"
          f"), steps timed in turns, MSE of {FOLD_RES}x{FOLD_RES} renders "
          f"of {FOLD_SPP} spp against a fold-0 reference of "
          f"{16 * FOLD_SPP} spp: {json.dumps(rows)}")

    fold = FOLD_ROWS["fold 2 sorted"]
    out = {}
    for isec in ("cuda", "torch"):
        sc = bc.cornell_scene(64, isec)
        out[isec] = diff.value_and_grad(bc.cornell_loss(sc, **fold))(
            diff.extract_params(sc, geometry=False))
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    _grads_ok(lk, gk, "64^2 folded")
    if not torch.equal(lk, lp):
        fail(f"folded 64^2 losses differ: kernels {float(lk)}, plain "
             f"{float(lp)}")
    worst = 0.0
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        if err > GRAD_RTOL * scale:
            fail(f"folded 64^2 gradient of {k}: kernels vs plain max abs "
                 f"{err} > {GRAD_RTOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    print(f"fold fwdbwd slice: 64x64, fold_interval=2 sorted: loss through "
          f"the kernels == through the plain versions ({float(lk):.6f}); "
          f"gradients finite, within {GRAD_RTOL} x max|g| of each leaf "
          f"(worst {worst:.3e})")
    return launches


# --------------------------------------------------------------------------
# phase 17: the golden mesh + IBL scene (image textures, shader nodes)
# --------------------------------------------------------------------------

GOLDEN_RES = 128             # the goldens' size
GOLDEN_AA = 16
GOLDEN_TIMED_RES = 512       # the timed chunks: 262,144 camera rays each
GOLDEN_TRIS = 2306
# tests/test_golden_mesh_ibl.py's bands on the 2-pixel-cropped interior
SKY_MEAN_BAND = 0.005
SKY_MAE_BAND = 0.01
ENERGY_BANDS = {"dl": (0.0, 0.15), "pt": (0.0, 0.18)}
PEARSON_BANDS = {"dl": 0.998, "pt": 0.995}
GOLDEN_FILES = {"dl": "ms_dl_128x128_16spp_ibl8",
                "pt": "ms_pt_128x128_16spp_ps4_b2"}


def golden_opts(kind, aa=1, spp_chunk=1):
    """test_golden_mesh_ibl.py's options: directlight raydepth=3, or path
    tracing with path_samples=4, bounces=2, raydepth=3; box filter 1.0."""
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.render import RenderOptions
    if kind == "pt":
        return RenderOptions(integrator="pathtracing", aa_samples=aa,
                             spp_chunk=spp_chunk, filter_size=1.0,
                             filter_type=FilterType.BOX,
                             integrator_opts=PathOptions(
                                 path_samples=4, bounces=2, raydepth=3))
    return RenderOptions(aa_samples=aa, spp_chunk=spp_chunk, filter_size=1.0,
                         filter_type=FilterType.BOX,
                         integrator_opts=DirectOptions(raydepth=3))


def golden_scene(res, intersector="auto"):
    import dataclasses
    from core_tpu_torch.scenes import golden_mesh_scene
    scene = golden_mesh_scene(resx=res, resy=res, ibl_samples=8,
                              device="cuda")
    if scene.accel is not None or scene.geom.n_tris != GOLDEN_TRIS:
        fail(f"golden mesh: {scene.geom.n_tris} triangles, accel "
             f"{type(scene.accel).__name__}: not the brute path")
    return scene if intersector == "auto" else \
        dataclasses.replace(scene, intersector=intersector)


def golden_checks(kind, img):
    """test_golden_mesh_ibl.py's checks of one 128^2 image: the sky's mean
    and MAE, the hit pixels' energy, the 12 x 12 block Pearson r; each
    printed beside its band.  Returns the numbers."""
    import numpy as np
    ref = np.load(ROOT / "tests" / "golden" / f"{GOLDEN_FILES[kind]}.npz"
                  )["img"][2:-2, 2:-2]
    img = img.cpu().numpy()[2:-2, 2:-2]
    if img.shape != ref.shape or not np.isfinite(img).all():
        fail(f"golden {kind}: image {img.shape} vs {ref.shape}, or not "
             "finite")
    sky, hit = ref[..., 3] < 0.5, ref[..., 3] > 0.5
    m, r = img[sky][:, :3], ref[sky][:, :3]
    out = {"sky_mean_rel": float(abs(m.mean() - r.mean()) / r.mean()),
           "sky_mae_rel": float(np.abs(m - r).mean() / r.mean()),
           "energy_rel": float((img[hit][:, :3].mean()
                                - ref[hit][:, :3].mean())
                               / ref[hit][:, :3].mean())}
    bm = img[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    br = ref[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    out["pearson"] = float(np.corrcoef(bm.ravel(), br.ravel())[0, 1])
    lo, hi = ENERGY_BANDS[kind]
    ok = {"sky_mean_rel": out["sky_mean_rel"] < SKY_MEAN_BAND,
          "sky_mae_rel": out["sky_mae_rel"] < SKY_MAE_BAND,
          "energy_rel": lo <= out["energy_rel"] <= hi,
          "pearson": out["pearson"] > PEARSON_BANDS[kind]}
    print(f"golden {kind}: sky mean rel {out['sky_mean_rel']:.6f} (< "
          f"{SKY_MEAN_BAND}), sky MAE rel {out['sky_mae_rel']:.6f} (< "
          f"{SKY_MAE_BAND}), energy rel {out['energy_rel']:.6f} (in "
          f"[{lo}, {hi}]), 12x12 block Pearson {out['pearson']:.6f} (> "
          f"{PEARSON_BANDS[kind]})")
    if not all(ok.values()):
        fail(f"golden {kind}: outside the bands: "
             f"{[k for k, v in ok.items() if not v]}")
    return out


def phase_golden():
    """golden_mesh_scene through kernels 1 and 2 (see the header).  Returns
    the launches per chunk of each configuration."""
    import torch
    from core_tpu_torch import diff
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import (render_chunk, render_image,
                                       scene_material_types)
    t0 = time.perf_counter()
    scene = golden_scene(GOLDEN_RES)
    sync()
    print(f"golden mesh: {GOLDEN_RES}x{GOLDEN_RES} scene built in "
          f"{time.perf_counter() - t0:.3f} s: {scene.geom.n_tris} "
          f"triangles (brute), {len(scene.node_programs)} node programs, "
          f"atlas {tuple(scene.textures.atlas.shape)}, lights "
          f"{[type(x).__name__ for x in scene.lights]}")
    launches = {}
    chunks = GOLDEN_AA // 2
    for kind in ("dl", "pt"):
        name = f"goldenmesh128_{kind}_16spp"
        reset_counts()
        sync()
        t0 = time.perf_counter()
        img, _ = render_image(scene, golden_opts(kind, GOLDEN_AA, 2))
        sync()
        dt = time.perf_counter() - t0
        total = all_launches()
        brute_only(total, name)
        if plain_calls():
            fail(f"{name}: the plain versions ran {plain_calls()} times")
        if any(n % chunks for n in total.values()):
            fail(f"{name}: launches {total} not a multiple of {chunks} "
                 "chunks")
        launches[name] = {k: n // chunks for k, n in total.items()}
        write_png(BUILD / f"chip_smoke_{name}.png", img.cpu().numpy())
        print(f"{name}: {chunks} chunks of 2 spp in {dt:.4f} s, launches "
              f"per chunk {launches[name]}, plain calls 0, png "
              f"build/chip_smoke_{name}.png")
        golden_checks(kind, img)

    # the inputs of kernels 1 and 2 from one 1-spp path-traced chunk of the
    # goldens' size (at 512^2 the plain NEE versions alone would take ~10 s)
    calls = _capture_calls(scene, GOLDEN_RES, golden_opts("pt"))
    closest = [c for c in calls if c[0] == "closest"]
    nees = [c for c in calls if c[0] == "nee"]
    if len(closest) != 3 or len(nees) != 3 or len(calls) != 6:
        fail(f"golden pt chunk: {len(closest)} closest-hit calls and "
             f"{len(nees)} NEE bundles of {len(calls)} calls, not 3 and 3")
    rows = {}
    for kernel, q, got in (("closest_hit", "closest", closest),
                           ("any_hit_nee", "nee", nees)):
        per = [_check_captured(
            f"golden pt: {'camera' if i == 0 else f'bounce {i}'} "
            f"{'closest hit' if q == 'closest' else 'IBL bundle (K=16)'}", *c)
            for i, c in enumerate(got)]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per)}
        _gap(f"kernel {1 if q == 'closest' else 2}, golden pt "
             f"{GOLDEN_RES}^2 chunk", per)

    # 1-spp chunks at 512^2, dl and pt in turns (dl, pt, pt, dl)
    big = golden_scene(GOLDEN_TIMED_RES)
    types = scene_material_types(big)
    stats = {}
    for kind in ("dl", "pt"):
        name = f"goldenmesh{GOLDEN_TIMED_RES}_{kind}_fwd"
        opts = golden_opts(kind)
        film = film_mod.make_film(GOLDEN_TIMED_RES, GOLDEN_TIMED_RES,
                                  device=big.device)
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with torch.no_grad():
            _, rays = counted_rays(lambda: render_chunk(
                big, types, opts, film, 0, 1, 0))
        sync()
        launches[name] = all_launches()
        brute_only(launches[name], name)
        if plain_calls():
            fail(f"{name}: the plain versions ran {plain_calls()} times")
        stats[kind] = {"rays": rays, "ms": [], "opts": opts, "film": film,
                       "peak_mib": torch.cuda.max_memory_allocated()
                       / 2**20}
    for kind in ("dl", "pt", "pt", "dl"):
        st = stats[kind]
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            st["film"] = render_chunk(big, types, st["opts"], st["film"], 0,
                                      1, len(st["ms"]) + 1)
        sync()
        st["ms"].append((time.perf_counter() - t0) * 1e3)
    for kind, st in stats.items():
        name = f"goldenmesh{GOLDEN_TIMED_RES}_{kind}_fwd"
        img = film_mod.flush(st["film"])
        if not bool(torch.isfinite(img).all()):
            fail(f"{name}: image has non-finite values")
        per = sum(st["ms"]) / len(st["ms"])
        print(f"{name}: {GOLDEN_TIMED_RES}x{GOLDEN_TIMED_RES}, 1-spp "
              f"chunks timed in turns {[round(t, 3) for t in st['ms']]} ms: "
              f"{per:.3f} ms/chunk, rays per chunk {st['rays']}, "
              f"{st['rays'] / per / 1e3:.3f} Mrays/s forward; peak device "
              f"memory {st['peak_mib']:.1f} MiB; launches per chunk "
              f"{launches[name]}; image mean "
              f"{float(img[..., :3].mean()):.6f}")
    del big, stats
    torch.cuda.empty_cache()

    # 64^2: kernels and plain versions give the same images and gradients
    for kind in ("dl", "pt"):
        imgs = [render_image(golden_scene(64, isec),
                             golden_opts(kind, 2, 2))[0]
                for isec in ("cuda", "torch")]
        sync()
        if not torch.equal(*imgs):
            fail(f"64^2 golden {kind}: kernel and plain renders differ: "
                 f"max abs {float((imgs[0] - imgs[1]).abs().max())}")
        print(f"golden slice: 64x64 {kind} render through the kernels == "
              f"through the plain versions (bit-identical), mean "
              f"{float(imgs[0][..., :3].mean()):.6f}")
    out = {}
    for isec in ("cuda", "torch"):
        sc = golden_scene(64, isec)
        out[isec] = diff.value_and_grad_fn(
            sc, golden_opts("dl"), 1,
            torch.zeros(64, 64, 4, device=sc.device))(
            diff.extract_params(sc, geometry=False))
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    _grads_ok(lk, gk, "64^2 golden dl")
    if not torch.equal(lk, lp):
        fail(f"golden 64^2 losses differ: kernels {float(lk)}, plain "
             f"{float(lp)}")
    worst = 0.0
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        if err > GRAD_RTOL * scale:
            fail(f"golden 64^2 gradient of {k}: kernels vs plain max abs "
                 f"{err} > {GRAD_RTOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    # strengths column 3 is diffuse_reflect; both materials are node-mapped
    refl = gk["mat.strengths"][:, 3]
    if not bool((refl.abs() > 0).all()):
        fail(f"golden 64^2: diffuse_reflect gradients {refl.tolist()}")
    print(f"golden fwdbwd slice: 64x64 dl, 1 spp: loss through the kernels "
          f"== through the plain versions ({float(lk):.6f}); gradients "
          f"finite, within {GRAD_RTOL} x max|g| of each leaf (worst "
          f"{worst:.3e}); diffuse_reflect gradients of the two mapped "
          f"materials {[round(float(g), 6) for g in refl]}")
    return launches, rows


# --------------------------------------------------------------------------
# phase 18: the mesh zoo (procedural textures, mix / layer nodes, bump
# mapping, coated anisotropic glossy) on the flat cluster path
# --------------------------------------------------------------------------

def zoo_builder(b, param_map, texture_def, tex_type, helpers, make_camera,
                res, grid=None, torus=None, ibl_samples=None,
                sun_samples=None):
    """Fill SceneBuilder b with scenes.MESH_ZOO, in mesh_scene's order
    (textures, materials, terrain, torus, background, lights, camera),
    through either package: param_map, texture_def and tex_type are its
    ParamMap, TextureDef and TexType, helpers its scenes module (the
    _grid_mesh and _torus_mesh helpers), make_camera its make_perspective
    with any device bound.  grid (n), torus ((nu, nv)), ibl_samples and
    sun_samples replace MESH_ZOO's sizes.  Returns b."""
    from core_tpu_torch.scenes import MESH_ZOO as z
    for name, params in z["textures"]:
        b.create("texture", name, param_map(dict(params)))
    for name, fields in z["texture_defs"]:
        b.add_texture(name, texture_def(
            **{**fields, "ttype": tex_type[fields["ttype"]]}))
    for name, params, nodes in z["materials"]:
        b.create("material", name, param_map(dict(params)), extra=[
            param_map({"element": "shader_node", **nd}) for nd in nodes])
    a = b.assembler
    m = a.start_mesh()
    helpers._grid_mesh(a, m, grid or z["grid"]["n"], z["grid"]["extent"],
                       b.material_index("terrain"))
    a.smooth_mesh(m, z["smooth"])
    m = a.start_mesh()
    t = z["torus"]
    nu, nv = torus or (t["nu"], t["nv"])
    helpers._torus_mesh(a, m, nu, nv, t["R"], t["r"], t["center"],
                        b.material_index("torus"))
    a.smooth_mesh(m, z["smooth"])
    name, params = z["background"]
    b.create("background", name, param_map(
        {**params, "ibl_samples": ibl_samples or params["ibl_samples"]}))
    for name, params in z["lights"]:
        b.create("light", name, param_map(
            {**params, "samples": sun_samples or params["samples"]}))
    b.camera = make_camera(**z["camera"], resx=res, resy=res)
    return b


def zoo_scene(res, intersector="auto", device="cuda", **sizes):
    """The mesh zoo built by the port (MESH_ZOO at its sizes, or `sizes`
    as zoo_builder takes them)."""
    import dataclasses
    import functools
    from core_tpu_torch import scenes
    from core_tpu_torch.cameras import make_perspective
    from core_tpu_torch.environment import SceneBuilder
    from core_tpu_torch.params import ParamMap
    from core_tpu_torch.textures.base import TexType, TextureDef
    b = SceneBuilder(device)
    scene = zoo_builder(b, ParamMap, TextureDef, TexType, scenes,
                        functools.partial(make_perspective, device=b.device),
                        res, **sizes).compile_scene()
    return scene if intersector == "auto" else \
        dataclasses.replace(scene, intersector=intersector)


ZOO_RES = 256
ZOO_TRIS = 73_602
ZOO_SLICE = 64
ZOO_TURNS = (("zoo", "dl"), ("mesh", "dl"), ("mesh", "pt"), ("zoo", "pt"),
             ("zoo", "pt"), ("mesh", "pt"), ("mesh", "dl"), ("zoo", "dl"))
# the configurations' names; mesh_scene's directlight one at raydepth 3 is
# not phase 7's mesh256_dl_fwd (raydepth 1)
ZOO_CFGS = {("zoo", "dl"): "meshzoo256_dl_fwd", ("zoo", "pt"):
            "meshzoo256_pt_fwd", ("mesh", "dl"): "mesh256_dl3_fwd",
            ("mesh", "pt"): "mesh256_pt_fwd"}
FLAT = ("cluster_closest_hit", "cluster_any_hit_nee")


def _only_kernels(launches, want, what):
    """Fails unless every kernel of `want` launched and no other kernel or
    plain version did."""
    others = {k: n for k, n in launches.items() if k not in want and n}
    if min(launches[k] for k in want) <= 0 or others or plain_calls():
        fail(f"{what}: kernels {want} must launch and no other kernel or "
             f"plain version: {launches}, plain calls {plain_calls()}")


def _zoo_kernels(scene):
    """Kernels 4 and 6 on the inputs captured from one 1-spp path-traced
    zoo chunk: the camera, the two bounce and the first chain depth's
    (the coat's reflection or the glossy lobe) closest hits, and the sun
    (K=8) and IBL (K=16) bundles of those four vertices, every lane
    against the plain versions and timed."""
    calls = _capture_calls(scene, ZOO_RES, golden_opts("pt"))
    closest = [c for c in calls if c[0] == "closest"]
    nees = [c for c in calls if c[0] == "nee"]
    print(f"zoo pt: one chunk made {len(closest)} closest-hit calls (lanes "
          f"{[c[1][1].tmin.shape[0] for c in closest]}) and {len(nees)} NEE "
          f"bundles (K = {[len(c[1][3]) for c in nees]})")
    if len(calls) != 36 or len(closest) != 12:
        fail(f"zoo pt chunk: {len(closest)} closest-hit calls of "
             f"{len(calls)}, not 12 of 36")
    rows = {}
    for kernel, q, got, names in (
            ("cluster_closest_hit", "closest", closest[:4],
             ("camera", "bounce 1", "bounce 2", "chain depth 1")),
            ("cluster_any_hit_nee", "nee", nees[:8],
             [f"{v} {light}" for v in ("camera", "bounce 1", "bounce 2",
                                       "chain depth 1")
              for light in ("sun bundle (K=8)", "IBL bundle (K=16)")])):
        what = " closest hit" if q == "closest" else ""
        per = [_check_captured(f"zoo pt: {name}{what}", *c)
               for name, c in zip(names, got)]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per)}
        _gap(f"kernel {4 if q == 'closest' else 6}, zoo pt captured calls",
             per)
    return rows


def phase_zoo():
    """The mesh zoo through kernels 4 and 6 (see the header).  Returns
    the launches per chunk of each zoo configuration and the kernels'
    error rows."""
    import torch
    from core_tpu_torch import diff
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import scene as sm
    from core_tpu_torch.render import (render_chunk, render_image,
                                       scene_material_types)
    from core_tpu_torch.scenes import mesh_scene
    t0 = time.perf_counter()
    zoo = zoo_scene(ZOO_RES)
    sync()
    dt = time.perf_counter() - t0
    if (sm.accel_kind(zoo.accel), zoo.geom.n_tris) != ("flat", ZOO_TRIS):
        fail(f"zoo: {zoo.geom.n_tris} triangles on the "
             f"{sm.accel_kind(zoo.accel)} path, not {ZOO_TRIS} flat")
    print(f"zoo: {ZOO_RES}x{ZOO_RES} scene built in {dt:.3f} s (host build, "
          f"accel and IBL CDFs): {zoo.geom.n_tris} triangles, "
          f"{zoo.accel.aabb.shape[0]} clusters, "
          f"{len(zoo.textures.defs)} textures "
          f"{sorted({d.ttype.name for d in zoo.textures.defs})}, node "
          f"programs {[(m, slot) for m, slot, _, _ in zoo.node_programs]}, "
          f"material types {zoo.mat_types}")
    rows = _zoo_kernels(zoo)

    # 1-spp chunks of the zoo and of mesh_scene under the same options, in
    # turns, so that their ratio isolates the zoo's shading
    scenes = {"zoo": zoo, "mesh": mesh_scene(resx=ZOO_RES, resy=ZOO_RES,
                                             device="cuda")}
    stats, launches = {}, {}
    for name, kind in sorted(set(ZOO_TURNS)):
        sc = scenes[name]
        cfg = ZOO_CFGS[(name, kind)]
        film = film_mod.make_film(ZOO_RES, ZOO_RES, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        with torch.no_grad():
            film, rays = counted_rays(lambda: render_chunk(
                sc, scene_material_types(sc), golden_opts(kind), film, 0, 1,
                0))
        sync()
        launches[cfg] = all_launches()
        _only_kernels(launches[cfg], FLAT, cfg)
        stats[(name, kind)] = {"cfg": cfg, "rays": rays, "ms": [],
                               "film": film, "peak_mib":
                               torch.cuda.max_memory_allocated() / 2**20}
    for name, kind in ZOO_TURNS:
        st, sc = stats[(name, kind)], scenes[name]
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            st["film"] = render_chunk(sc, scene_material_types(sc),
                                      golden_opts(kind), st["film"], 0, 1,
                                      len(st["ms"]) + 1)
        sync()
        st["ms"].append((time.perf_counter() - t0) * 1e3)
    for (name, kind), st in sorted(stats.items()):
        img = film_mod.flush(st["film"])
        if not bool(torch.isfinite(img).all()):
            fail(f"{st['cfg']}: image has non-finite values")
        per = sum(st["ms"]) / len(st["ms"])
        other = stats[("mesh" if name == "zoo" else "zoo", kind)]
        print(f"{st['cfg']}: {ZOO_RES}x{ZOO_RES}, 1-spp chunks timed in "
              f"turns {[round(t, 3) for t in st['ms']]} ms: {per:.3f} "
              f"ms/chunk (x{per / (sum(other['ms']) / len(other['ms'])):.3f}"
              f" of {other['cfg']}), rays per chunk {st['rays']}, "
              f"{st['rays'] / per / 1e3:.3f} Mrays/s forward; peak device "
              f"memory {st['peak_mib']:.1f} MiB; launches per chunk "
              f"{launches[st['cfg']]}; image mean "
              f"{float(img[..., :3].mean()):.6f}")
        if name == "zoo":
            write_png(BUILD / f"chip_smoke_{st['cfg']}.png", img.cpu().numpy())
    zoo_launches = {c: n for c, n in launches.items()
                    if c.startswith("meshzoo")}
    del zoo, scenes, stats
    torch.cuda.empty_cache()

    # 64^2: kernels and plain versions give the same images and gradients
    for kind in ("dl", "pt"):
        imgs = [render_image(zoo_scene(ZOO_SLICE, isec),
                             golden_opts(kind))[0]
                for isec in ("cuda", "torch")]
        sync()
        if not torch.equal(*imgs):
            fail(f"{ZOO_SLICE}^2 zoo {kind}: kernel and plain renders "
                 f"differ: max abs {float((imgs[0] - imgs[1]).abs().max())}")
        print(f"zoo slice: {ZOO_SLICE}x{ZOO_SLICE} {kind} render through "
              f"the kernels == "
              f"through the plain versions (bit-identical), mean "
              f"{float(imgs[0][..., :3].mean()):.6f}, image sha256 "
              f"{image_digest(imgs[0])}")
    out = {}
    for isec in ("cuda", "torch"):
        sc = zoo_scene(ZOO_SLICE, isec)
        out[isec] = diff.value_and_grad_fn(
            sc, golden_opts("dl"), 1,
            torch.zeros(ZOO_SLICE, ZOO_SLICE, 4, device=sc.device))(
            diff.extract_params(sc, geometry=False))
    (lk, gk), (lp, gp) = out["cuda"], out["torch"]
    _grads_ok(lk, gk, f"{ZOO_SLICE}^2 zoo dl")
    if not torch.equal(lk, lp):
        fail(f"zoo {ZOO_SLICE}^2 losses differ: kernels {float(lk)}, plain "
             f"{float(lp)}")
    worst = 0.0
    for k in gp:
        scale = float(gp[k].abs().max())
        err = float((gk[k] - gp[k]).abs().max())
        if err > GRAD_RTOL * scale:
            fail(f"zoo {ZOO_SLICE}^2 gradient of {k}: kernels vs plain "
                 f"max abs {err} > {GRAD_RTOL} * {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    # the coated torus (row 1): its coat reflects Kr x mirror_color, and its
    # glossy_shader node replaces glossy_color on every torus hit, so that
    # leaf's gradient is 0 there by construction; glossy_reflect scales the
    # lobe it shades
    torus = 1
    mirror = gk["mat.mirror_color"][torus]
    gcol = gk["mat.glossy_color"][torus]
    grefl = gk["mat.glossy_reflect"][torus]
    if not bool((mirror.abs() > 0).all()) or float(grefl.abs()) <= 0 \
            or bool((gcol != 0).any()):
        fail(f"zoo {ZOO_SLICE}^2 torus gradients: mirror_color "
             f"{mirror.tolist()}, "
             f"glossy_reflect {float(grefl)}, glossy_color {gcol.tolist()}")
    print(f"zoo fwdbwd slice: {ZOO_SLICE}x{ZOO_SLICE} dl, 1 spp: loss "
          f"through the kernels == "
          f"through the plain versions ({float(lk):.6f}); gradients finite, "
          f"within {GRAD_RTOL} x max|g| of each leaf (worst {worst:.3e}); "
          f"coated torus row: mirror_color "
          f"{[round(float(g), 6) for g in mirror]}, glossy_reflect "
          f"{float(grefl):.6f}, glossy_color {gcol.tolist()} (node-mapped)")
    return zoo_launches, rows


# --------------------------------------------------------------------------
# phase 19: the light zoo (sphere, mesh, IES and portal lights, a darksky
# with its sun and background light, a thin lens, a Gauss filter) on the
# flat cluster path
# --------------------------------------------------------------------------

def _panel(a, m, mat, quads, x, z, height):
    """LIGHT_ZOO's emitter panel: a quads x quads grid on y = height, wound
    so its normals point down."""
    import numpy as np
    xs, zs = np.linspace(*x, quads + 1), np.linspace(*z, quads + 1)
    ids = [[a.add_vertex(m, xv, height, zv) for zv in zs] for xv in xs]
    for i in range(quads):
        for j in range(quads):
            v00, v01 = ids[i][j], ids[i][j + 1]
            v10, v11 = ids[i + 1][j], ids[i + 1][j + 1]
            a.add_triangle(m, v00, v10, v11, mat)
            a.add_triangle(m, v00, v11, v01, mat)


def light_zoo_builder(b, param_map, helpers, res, grid=None, torus=None,
                      samples=None, panel=None, background=None,
                      camera=None):
    """Fill SceneBuilder b with scenes.LIGHT_ZOO (materials, terrain,
    torus, panel, portal, background, lights, camera) through either
    package: param_map is its ParamMap, helpers its scenes module (the
    _grid_mesh and _torus_mesh helpers).  grid (n), torus ((nu, nv)),
    panel (its quads a side) and samples (every light's and the darksky's
    light_samples) replace LIGHT_ZOO's sizes; background ((name,
    parameters)) replaces its darksky, camera (parameters) updates its
    camera's.  The IES profile is written to a temporary file for
    the ieslight factory.  Returns b."""
    import tempfile
    from core_tpu_torch.scenes import LIGHT_ZOO as z
    from core_tpu_torch.scenes import LIGHT_ZOO_IES
    for name, params in z["materials"]:
        b.create("material", name, param_map(dict(params)))
    a = b.assembler
    objects = {}
    m = a.start_mesh()
    helpers._grid_mesh(a, m, grid or z["grid"]["n"], z["grid"]["extent"],
                       b.material_index("terrain"))
    a.smooth_mesh(m, z["smooth"])
    m = a.start_mesh()
    t = z["torus"]
    nu, nv = torus or (t["nu"], t["nv"])
    helpers._torus_mesh(a, m, nu, nv, t["R"], t["r"], t["center"],
                        b.material_index("torus"))
    a.smooth_mesh(m, z["smooth"])
    m = a.start_mesh()
    pz = z["panel"]
    _panel(a, m, b.material_index("emitter"), panel or pz["quads"], pz["x"],
           pz["z"], pz["height"])
    objects["panel"] = m.obj_id
    m = a.start_mesh()
    po = z["portal"]
    _panel(a, m, b.material_index("portal"), 1, po["x"], po["z"],
           po["height"])
    objects["portal"] = m.obj_id
    name, params = background or z["background"]
    if samples:
        params = {**params, "light_samples": samples, "ibl_samples": samples}
    b.create("background", name, param_map(params))
    with tempfile.TemporaryDirectory() as tmp:
        ies = Path(tmp) / "light_zoo.ies"
        ies.write_text(LIGHT_ZOO_IES)
        for name, params in z["lights"]:
            p = dict(params)
            if "object" in p:
                p["object"] = objects[p["object"]]
            if p["type"] == "ieslight":
                p["file"] = str(ies)
            elif samples:
                p["samples"] = samples
            b.create("light", name, param_map(p))
    name, params = z["camera"]
    b.create("camera", name, param_map({**params, **(camera or {}),
                                        "resx": res, "resy": res}))
    return b


def light_zoo_scene(res, intersector="auto", device="cuda", **sizes):
    """The light zoo built by the port (LIGHT_ZOO at its sizes, or `sizes`
    as light_zoo_builder takes them)."""
    import dataclasses
    from core_tpu_torch import scenes
    from core_tpu_torch.environment import SceneBuilder
    from core_tpu_torch.params import ParamMap
    scene = light_zoo_builder(SceneBuilder(device), ParamMap, scenes, res,
                              **sizes).compile_scene()
    return scene if intersector == "auto" else \
        dataclasses.replace(scene, intersector=intersector)


def light_zoo_opts(kind, **film):
    """golden_opts(kind) with LIGHT_ZOO's film filter (or `film`'s
    filter_type / filter_size)."""
    import dataclasses
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.scenes import LIGHT_ZOO
    f = {**LIGHT_ZOO["film"], **film}
    return dataclasses.replace(golden_opts(kind),
                               filter_type=FilterType[f["filter_type"]],
                               filter_size=f["filter_size"])


LZ_RES = 256
LZ_TRIS = 73_636
LZ_SLICE = 64
LZ_SMALL = dict(grid=24, torus=(24, 12))      # 1,668 triangles: brute
LZ_TURNS = (("lightzoo", "dl"), ("mesh", "dl"), ("mesh", "pt"),
            ("lightzoo", "pt"), ("lightzoo", "pt"), ("mesh", "pt"),
            ("mesh", "dl"), ("lightzoo", "dl"))
LZ_CFGS = {("lightzoo", "dl"): "lightzoo256_dl_fwd",
           ("lightzoo", "pt"): "lightzoo256_pt_fwd",
           ("mesh", "dl"): "mesh256_dl3_gauss_fwd",
           ("mesh", "pt"): "mesh256_pt_gauss_fwd"}
FLAT3 = ("cluster_closest_hit", "cluster_any_hit", "cluster_any_hit_nee")
# the 64^2 sweep on the small light zoo: (what, builder overrides, film)
LZ_SWEEP = (
    ("pinhole camera", {"camera": {"aperture": 0.0}}, {}),
    ("thin lens, hexagon", {}, {}),
    ("thin lens, ring, edge bias", {"camera": {"bokeh_type": "ring",
                                               "bokeh_bias": "edge"}}, {}),
    ("architect camera", {"camera": {"type": "architect", "aperture": 0.0}},
     {}),
    ("angular camera", {"camera": {"type": "angular", "angle": 70.0,
                                   "circular": True}}, {}),
    ("orthographic camera", {"camera": {"type": "ortho", "scale": 9.0}},
     {}),
    ("darksky, night", {"background": ("sky", {
        "type": "darksky", "from": (0.3, 0.8, 0.5), "night": True,
        "add_sun": True, "background_light": True, "light_samples": 8})},
     {}),
    ("sunsky", {"background": ("sky", {
        "type": "sunsky", "from": (0.3, 0.8, 0.5), "turbidity": 3.0,
        "add_sun": True, "sun_power": 0.6, "ibl": True, "ibl_samples": 8,
        "power": 0.4})}, {}),
    ("gradient", {"background": ("sky", {
        "type": "gradientback", "horizon_color": (0.9, 0.8, 0.7),
        "zenith_color": (0.2, 0.3, 0.7), "horizon_ground_color":
        (0.3, 0.25, 0.2), "ibl": True, "ibl_samples": 8})}, {}),
    ("constant", {"background": ("sky", {
        "type": "constant", "color": (0.3, 0.35, 0.4), "ibl": True,
        "ibl_samples": 8})}, {}),
    ("box filter", {}, {"filter_type": "BOX"}),
    ("mitchell filter", {}, {"filter_type": "MITCHELL"}),
    ("lanczos filter", {}, {"filter_type": "LANCZOS"}),
)


def _busy_share(fn):
    """(device ms, device events, wall ms) of one fn() under torch.profiler's
    CUDA activity alone; None when the profiler saw no device time.  Device
    ms is the sum of the durations of every device event (kernels, copies,
    memsets) read from the raw kineto events (no CPU op tree and no
    per-event Python records, so a call of 10^5 launches digests in
    seconds); wall ms is fn()'s wall time under that profiler, through its
    final synchronisation.  The busy share is device ms over wall ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall = (time.perf_counter() - t0) * 1e3
    durs = [e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
    if not durs:
        return None
    return sum(durs) / 1e6, len(durs), wall


def _busy(fn, what="chunk"):
    b = _busy_share(fn)
    return "busy share not measured (the profiler saw no device time)" \
        if b is None else f"profiled {what}: device {b[0]:.3f} ms over " \
        f"{b[1]} device events in {b[2]:.3f} ms, busy share " \
        f"{b[0] / b[2]:.4f}"


def _light_zoo_kernels(scene):
    """Kernels 4, 5 and 6 on the inputs captured from one 1-spp
    path-traced light-zoo chunk: the camera and two bounce closest hits,
    the IES light's shadow rays at the camera and first bounce vertices,
    and the five bundles of the camera vertex (sun, sphere, sky, mesh,
    portal), every lane against the plain versions and timed."""
    calls = _capture_calls(scene, LZ_RES, light_zoo_opts("pt"))
    got = {q: [c for c in calls if c[0] == q]
           for q in ("closest", "any", "nee")}
    print(f"lightzoo pt: one chunk made {len(got['closest'])} closest-hit "
          f"calls (lanes {[c[1][1].tmin.shape[0] for c in got['closest']]}),"
          f" {len(got['any'])} one-ray shadow wavefronts and "
          f"{len(got['nee'])} NEE bundles (K of the first five "
          f"{[len(c[1][3]) for c in got['nee'][:5]]})")
    if (len(got["closest"]), len(got["any"]), len(got["nee"])) != \
            (12, 12, 60):
        fail(f"lightzoo pt chunk: {len(got['closest'])} closest, "
             f"{len(got['any'])} any, {len(got['nee'])} NEE calls, not 12, "
             "12 and 60")
    bundles = ("sun", "sphere", "sky", "mesh light", "portal")
    rows = {}
    for kernel, k, q, names in (
            ("cluster_closest_hit", 4, "closest",
             ("camera", "bounce 1", "bounce 2")),
            ("cluster_any_hit", 5, "any",
             ("IES light, camera hit", "IES light, bounce 1 hit")),
            ("cluster_any_hit_nee", 6, "nee",
             [f"{b} bundle, camera hit" for b in bundles])):
        what = " closest hit" if q == "closest" else ""
        per = [_check_captured(f"lightzoo pt: {name}{what}", *c)
               for name, c in zip(names, got[q])]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per)}
        _gap(f"kernel {k}, lightzoo pt captured calls", per)
    return rows


def phase_light_zoo():
    """The light zoo through kernels 4, 5 and 6 (see the header).  Returns
    the launches per chunk of each light-zoo configuration and the
    kernels' error rows."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import scene as sm
    from core_tpu_torch.render import (render_chunk, render_image,
                                       scene_material_types)
    from core_tpu_torch.scenes import mesh_scene
    t0 = time.perf_counter()
    lz = light_zoo_scene(LZ_RES)
    sync()
    dt = time.perf_counter() - t0
    if (sm.accel_kind(lz.accel), lz.geom.n_tris) != ("flat", LZ_TRIS):
        fail(f"lightzoo: {lz.geom.n_tris} triangles on the "
             f"{sm.accel_kind(lz.accel)} path, not {LZ_TRIS} flat")
    cam = lz.camera
    print(f"lightzoo: {LZ_RES}x{LZ_RES} scene built in {dt:.3f} s (host "
          f"build, accel and IBL CDFs): {lz.geom.n_tris} triangles, "
          f"{lz.accel.aabb.shape[0]} clusters, lights "
          f"{[type(x).__name__ for x in lz.lights]}, background "
          f"{type(lz.background).__name__}, camera aperture {cam.aperture} "
          f"bokeh {cam.bokeh_type}, filter "
          f"{light_zoo_opts('dl').filter_type.name}")
    rows = _light_zoo_kernels(lz)

    # 1-spp chunks of the light zoo and of mesh_scene under the same
    # options (the Gauss filter), in turns
    scenes = {"lightzoo": lz, "mesh": mesh_scene(resx=LZ_RES, resy=LZ_RES,
                                                 device="cuda")}
    stats, launches = {}, {}
    for name, kind in sorted(set(LZ_TURNS)):
        sc, opts = scenes[name], light_zoo_opts(kind)
        cfg = LZ_CFGS[(name, kind)]
        film = film_mod.make_film(LZ_RES, LZ_RES, device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        sync()
        with torch.no_grad():
            film, rays = counted_rays(lambda: render_chunk(
                sc, scene_material_types(sc), opts, film, 0, 1, 0))
        sync()
        launches[cfg] = all_launches()
        _only_kernels(launches[cfg], FLAT3 if name == "lightzoo" else FLAT,
                      cfg)
        stats[(name, kind)] = {"cfg": cfg, "rays": rays, "ms": [],
                               "film": film, "opts": opts, "peak_mib":
                               torch.cuda.max_memory_allocated() / 2**20}
    for name, kind in LZ_TURNS:
        st, sc = stats[(name, kind)], scenes[name]
        sync()
        t0 = time.perf_counter()
        with torch.no_grad():
            st["film"] = render_chunk(sc, scene_material_types(sc),
                                      st["opts"], st["film"], 0, 1,
                                      len(st["ms"]) + 1)
        sync()
        st["ms"].append((time.perf_counter() - t0) * 1e3)
    for (name, kind), st in sorted(stats.items()):
        img = film_mod.flush(st["film"])
        if not bool(torch.isfinite(img).all()):
            fail(f"{st['cfg']}: image has non-finite values")
        per = sum(st["ms"]) / len(st["ms"])
        other = stats[("mesh" if name == "lightzoo" else "lightzoo", kind)]
        busy = ""
        if name == "lightzoo":
            sc = scenes[name]
            with torch.no_grad():
                b = _busy_share(lambda: render_chunk(
                    sc, scene_material_types(sc), st["opts"],
                    film_mod.make_film(LZ_RES, LZ_RES, device="cuda"), 0, 1,
                    0))
            busy = "; busy share not measured (the profiler saw no " \
                "device time)" if b is None else \
                f"; profiled chunk: device {b[0]:.3f} ms over {b[1]} " \
                f"device events in {b[2]:.3f} ms, busy share " \
                f"{b[0] / b[2]:.4f} " \
                f"(of the unprofiled mean {b[0] / per:.4f})"
        print(f"{st['cfg']}: {LZ_RES}x{LZ_RES}, 1-spp chunks timed in turns "
              f"{[round(t, 3) for t in st['ms']]} ms: {per:.3f} ms/chunk "
              f"(x{per / (sum(other['ms']) / len(other['ms'])):.3f} of "
              f"{other['cfg']}), rays per chunk {st['rays']}, "
              f"{st['rays'] / per / 1e3:.3f} Mrays/s forward; peak device "
              f"memory {st['peak_mib']:.1f} MiB; launches per chunk "
              f"{launches[st['cfg']]}; image mean "
              f"{float(img[..., :3].mean()):.6f}{busy}")
        if name == "lightzoo":
            write_png(BUILD / f"chip_smoke_{st['cfg']}.png", img.cpu().numpy())
    lz_launches = {c: n for c, n in launches.items()
                   if c.startswith("lightzoo")}
    del lz, scenes, stats
    torch.cuda.empty_cache()

    # 64^2 on the small light zoo (brute kernels 1-3): the default dl and
    # pt, then each camera type, sky and filter, kernels against plain
    sweep = [("light zoo dl", {}, {}, "dl"), ("light zoo pt", {}, {}, "pt")]
    sweep += [(what, over, film, "dl") for what, over, film in LZ_SWEEP]
    for what, over, film, kind in sweep:
        imgs = []
        for isec in ("cuda", "torch"):
            reset_counts()
            sc = light_zoo_scene(LZ_SLICE, isec, **LZ_SMALL, **over)
            if sc.accel is not None:
                fail(f"small light zoo: {sc.geom.n_tris} triangles, not brute")
            imgs.append(render_image(sc, light_zoo_opts(kind, **film))[0])
            sync()
            if isec == "cuda":
                counts = all_launches()
                want = ("closest_hit", "any_hit_nee", "any_hit")
                _only_kernels(counts, want, f"{LZ_SLICE}^2 {what}")
        if not bool(torch.isfinite(imgs[0]).all()) \
                or not torch.equal(*imgs):
            fail(f"{LZ_SLICE}^2 {what}: kernel and plain renders differ or "
                 f"are not finite: max abs "
                 f"{float((imgs[0] - imgs[1]).abs().max())}")
        print(f"lightzoo slice: {LZ_SLICE}x{LZ_SLICE} {kind}, {what}: "
              f"through the kernels == through the plain versions "
              f"(bit-identical), mean {float(imgs[0][..., :3].mean()):.6f}, "
              f"kernel launches {counts}")
    return lz_launches, rows


# --------------------------------------------------------------------------
# phase 20: the photon integrators (photon emission, the sorted-cell photon
# map, photonmapping with final gathering, SPPM, the path tracer's photon
# caustics)
# --------------------------------------------------------------------------

PH_GOLDEN_RES = 64
PH_RES = 512
PH_SLICE = 64
PH_BLOCKS = ("glass", "glossy")
# tests/test_golden_photon_family.py's options (and the goldens')
PH_GOLDEN = {"pm": dict(photons=200000, c_photons=200000, bounces=4,
                        diffuse_radius=40.0, caustic_radius=30.0,
                        final_gather=True, fg_samples=8, raydepth=5),
             "sppm": dict(passes=8, photons=100000, bounces=4,
                          search_radius=15.0, raydepth=5)}
PH_GOLDEN_FILES = {"pm": "pm_128x128_32spp_ph200k",
                   "sppm": "sppm_128x128_32pass_ph200k",
                   "bd": "bd_128x128_64spp"}     # phase 21's golden
# cornellspec512_pm / cornellspec512_sppm
PH_PM = dict(photons=1_000_000, c_photons=1_000_000, bounces=5,
             diffuse_radius=40.0, caustic_radius=30.0, final_gather=True,
             fg_samples=8, raydepth=5)
PH_PM_AA = 4
PH_PM_CHUNK = 2
PH_SPPM = dict(passes=16, photons=500_000, bounces=5, search_radius=15.0,
               raydepth=5)
# the 64^2 renders through the kernels against the plain versions
PH_SLICE_OPTS = {
    "pm": dict(photons=100_000, c_photons=100_000, bounces=4,
               diffuse_radius=40.0, caustic_radius=30.0, final_gather=True,
               fg_samples=4, raydepth=5),
    "sppm": dict(passes=2, photons=100_000, bounces=4, search_radius=15.0,
                 raydepth=5),
    "pt": dict(path_samples=4, bounces=3, raydepth=3, caustic_type="both",
               c_photons=100_000, caustic_radius=30.0, caustic_depth=5)}
PH_ZOO_PHOTONS = 262_144
PH_ZOO_BOUNCES = 3


def photon_opts(kind, fields, aa=PH_PM_AA, spp_chunk=PH_PM_CHUNK):
    """RenderOptions of a photon configuration: kind "pm" (photonmapping),
    "sppm" or "pt" (the path tracer), with a box filter of size 1 (the
    goldens' film)."""
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.integrators.photonmap import PhotonOptions
    from core_tpu_torch.integrators.sppm import SPPMOptions
    from core_tpu_torch.render import RenderOptions
    integ, cls = {"pm": ("photonmapping", PhotonOptions),
                  "sppm": ("SPPM", SPPMOptions),
                  "pt": ("pathtracing", PathOptions)}[kind]
    return RenderOptions(integrator=integ, integrator_opts=cls(**fields),
                         aa_samples=aa, spp_chunk=spp_chunk,
                         filter_size=1.0, filter_type=FilterType.BOX)


def photon_golden_stats(kind, img):
    """tests/test_golden_photon_family.py's statistics of a 64^2 image
    against its 128^2 golden pooled 2x: (mean energy rel, 7 x 7 block
    Pearson, block median rel), on the 2-pixel-cropped interior."""
    import numpy as np
    ref = np.load(ROOT / "tests" / "golden" / f"{PH_GOLDEN_FILES[kind]}.npz"
                  )["img"][..., :3].reshape(64, 2, 64, 2, 3).mean((1, 3))
    mine = img.cpu().numpy()
    m, r = mine[2:-2, 2:-2, :3], ref[2:-2, 2:-2]

    def blocks(a):
        return a[:56, :56].reshape(7, 8, 7, 8, 3).mean((1, 3, 4))

    bm, br = blocks(m), blocks(r)
    rel = (m.mean() - r.mean()) / r.mean()
    pearson = np.corrcoef(bm.ravel(), br.ravel())[0, 1]
    q50 = np.quantile(np.abs(bm - br) / np.maximum(br, 0.05), 0.5)
    return float(rel), float(pearson), float(q50)


def photon_golden_ok(kind, rel, pearson, q50) -> bool:
    """tests/test_golden_photon_family.py:61-95's bands."""
    if kind == "pm":
        return 0.0 <= rel <= 0.15 and pearson > 0.99 and q50 < 0.2
    return abs(rel) < 0.10 and pearson > 0.995 and q50 < 0.12


def _photon_goldens(launches):
    """(a) both photon goldens through kernels 1 and 2 at their bands."""
    import torch
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=PH_GOLDEN_RES, resy=PH_GOLDEN_RES,
                        light_samples=16, device="cuda")
    for kind in ("pm", "sppm"):
        reset_counts()
        sync()
        t0 = time.perf_counter()
        img, _ = render_image(scene, photon_opts(kind, PH_GOLDEN[kind]))
        sync()
        dt = time.perf_counter() - t0
        cfg = f"{kind}64_golden"
        launches[cfg] = all_launches()
        brute_only(launches[cfg], cfg)
        if plain_calls() or not bool(torch.isfinite(img).all()):
            fail(f"{cfg}: plain calls {plain_calls()} or non-finite image")
        rel, pearson, q50 = photon_golden_stats(kind, img)
        band = "0 <= rel <= 0.15, Pearson > 0.99, q50 < 0.2" \
            if kind == "pm" else "|rel| < 0.10, Pearson > 0.995, q50 < 0.12"
        print(f"photons: {cfg} ({PH_GOLDEN_FILES[kind]}): rel {rel:.6f}, "
              f"Pearson {pearson:.6f}, q50 {q50:.6f} (bands {band}); "
              f"{dt:.3f} s a request, launches {launches[cfg]}")
        if not photon_golden_ok(kind, rel, pearson, q50):
            fail(f"{cfg} outside its golden's bands")


def _photon_slice():
    """(b) the 64^2 glass-and-glossy box, photonmapping, SPPM and path
    tracing with caustic_type "both", through kernels 1 and 2 and through
    the plain versions: identical images."""
    import torch
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box
    for kind, fields in PH_SLICE_OPTS.items():
        imgs = []
        for isec in ("cuda", "torch"):
            reset_counts()
            sc = cornell_box(resx=PH_SLICE, resy=PH_SLICE, light_samples=4,
                             block_materials=PH_BLOCKS, intersector=isec,
                             device="cuda")
            imgs.append(render_image(sc, photon_opts(kind, fields, aa=2))[0])
            sync()
            if isec == "cuda":
                counts = all_launches()
                brute_only(counts, f"{PH_SLICE}^2 {kind}")
                if plain_calls():
                    fail(f"{PH_SLICE}^2 {kind}: the plain versions ran")
        if not bool(torch.isfinite(imgs[0]).all()) or not torch.equal(*imgs):
            fail(f"{PH_SLICE}^2 {kind}: kernel and plain renders differ or "
                 f"are not finite: max abs "
                 f"{float((imgs[0] - imgs[1]).abs().max())}")
        print(f"photons slice: {PH_SLICE}x{PH_SLICE} glass + glossy {kind}: "
              f"through the kernels == through the plain versions "
              f"(bit-identical), mean {float(imgs[0][..., :3].mean()):.6f}, "
              f"sha256 {image_digest(imgs[0])}, kernel launches {counts}")


def _photon_pm512(launches):
    """(c) cornellspec512_pm, its preprocess in steps (the diffuse shoot's
    closest-hit calls recorded for (f)); returns those calls."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.integrators import photonmap as pm_mod
    from core_tpu_torch.photon import map as pmap_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=PH_RES, resy=PH_RES, light_samples=16,
                        block_materials=PH_BLOCKS, device="cuda")
    opts = photon_opts("pm", PH_PM)
    po = opts.integrator_opts
    types = scene_material_types(scene)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync()
    secs = {}
    t0 = time.perf_counter()
    bmin, bmax = pm_mod.scene_bound(scene)
    center, radius = pm_mod.world_sphere(scene, bmin, bmax)

    def step(name, fn):
        nonlocal t0
        out = fn()
        sync()
        t1 = time.perf_counter()
        secs[name] = t1 - t0
        t0 = t1
        return out

    with _recording(scene) as calls:
        dep = step("diffuse shoot", lambda: pmap_mod.shoot_photons(
            scene, types, po.photons, po.bounces, 1, "diffuse", center,
            radius, with_surface=True))
    captured = [c for c in calls if c[0] == "closest"]
    grid = step("diffuse grid", lambda: pmap_mod.build_photon_grid(
        *dep[:4], po.diffuse_radius, bmin, bmax))
    cache = step("radiance cache", lambda: pmap_mod.build_radiance_cache(
        grid, dep[4], dep[5], po.diffuse_radius))
    del dep
    cdep = step("caustic shoot", lambda: pmap_mod.shoot_photons(
        scene, types, po.c_photons, po.bounces, 2, "caustic", center,
        radius))
    cgrid = step("caustic grid", lambda: pmap_mod.build_photon_grid(
        *cdep, po.caustic_radius, bmin, bmax))
    del cdep
    aux = {"diffuse": grid, "fg_cache": cache, "caustic": cgrid}
    pre = all_launches()
    _only_kernels(pre, ("closest_hit",), "cornellspec512_pm preprocess")
    pre_peak = torch.cuda.max_memory_allocated() / 2**30
    stored = {k: int(aux[k].n_valid) for k in ("diffuse", "caustic")}
    print(f"photons: cornellspec512_pm preprocess "
          f"{ {k: round(v, 4) for k, v in secs.items()} } s, deposits "
          f"stored {stored} of {(po.bounces + 1) * po.photons} each, "
          f"grid dims {grid.dims} / {cgrid.dims}, peak device memory "
          f"{pre_peak:.3f} GiB, launches {pre}")

    def chunk(film, sample0):
        with torch.no_grad():
            return render_chunk(scene, types, opts, film, 0, PH_PM_CHUNK,
                                sample0, aux)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    film = film_mod.make_film(PH_RES, PH_RES, device="cuda")
    sync()
    t0 = time.perf_counter()
    film, rays = counted_rays(lambda: chunk(film, 0))
    sync()
    first = time.perf_counter() - t0
    launches["cornellspec512_pm"] = all_launches()
    brute_only(launches["cornellspec512_pm"], "cornellspec512_pm")
    if plain_calls():
        fail("cornellspec512_pm: the plain versions ran")
    ms = []
    for sample0 in range(PH_PM_CHUNK, PH_PM_AA, PH_PM_CHUNK):
        t0 = time.perf_counter()
        film = chunk(film, sample0)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2**30
    img = film_mod.flush(film)
    if not bool(torch.isfinite(img).all()):
        fail("cornellspec512_pm: image has non-finite values")
    write_png(BUILD / "chip_smoke_cornellspec512_pm.png", img.cpu().numpy())
    busy = _busy(lambda: chunk(film_mod.make_film(PH_RES, PH_RES,
                                                  device="cuda"), 0))
    per = ms[-1] if ms else first * 1e3
    print(f"photons: cornellspec512_pm render: {PH_PM_AA} spp in "
          f"{PH_PM_CHUNK}-spp chunks: first chunk {first * 1e3:.3f} ms, then "
          f"{[round(t, 3) for t in ms]} ms; rays per chunk {rays}, "
          f"{rays / per / 1e3:.3f} Mrays/s; peak device memory {peak:.3f} "
          f"GiB; launches per chunk {launches['cornellspec512_pm']}; image "
          f"mean {float(img[..., :3].mean()):.6f}; {busy}")
    return captured


def _photon_sppm512(launches):
    """(d) cornellspec512_sppm, pass by pass."""
    import torch
    from core_tpu_torch.integrators import sppm as sppm_mod
    from core_tpu_torch.integrators.photonmap import (scene_bound,
                                                      world_sphere)
    from core_tpu_torch.render import scene_material_types
    from core_tpu_torch.scenes import cornell_box
    from core_tpu_torch.vec import zeros3
    scene = cornell_box(resx=PH_RES, resy=PH_RES, light_samples=16,
                        block_materials=PH_BLOCKS, device="cuda")
    so = sppm_mod.SPPMOptions(**PH_SPPM)
    types = scene_material_types(scene)
    bmin, bmax = scene_bound(scene)
    center, world_r = world_sphere(scene, bmin, bmax)
    r0 = float(so.search_radius)
    zero = torch.zeros(PH_RES * PH_RES, device="cuda")
    state = sppm_mod.HitPoints(r2=torch.full_like(zero, r0 * r0),
                               acc_n=zero, tau=zeros3(zero),
                               direct=zeros3(zero))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    with torch.no_grad():
        for k in range(so.passes):
            reset_counts()
            sync()
            t0 = time.perf_counter()
            state = sppm_mod.one_pass_block(
                scene, types, state, k, 0, PH_RES, PH_RES, so, scene.camera,
                center, world_r, bmin, bmax, r0)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
            if k == 0:
                launches["cornellspec512_sppm"] = all_launches()
                brute_only(launches["cornellspec512_sppm"],
                           "cornellspec512_sppm")
                if plain_calls():
                    fail("cornellspec512_sppm: the plain versions ran")
    img = sppm_mod.finalize_sppm(state, so.passes, so.photons)
    if not bool(torch.isfinite(img).all()):
        fail("cornellspec512_sppm: image has non-finite values")
    write_png(BUILD / "chip_smoke_cornellspec512_sppm.png",
              img.reshape(PH_RES, PH_RES, 4).cpu().numpy())
    print(f"photons: cornellspec512_sppm: {so.passes} passes of "
          f"{so.photons} photons: {[round(t, 3) for t in ms]} ms a pass "
          f"(median {sorted(ms)[len(ms) // 2]:.3f}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; launches "
          f"per pass {launches['cornellspec512_sppm']}; image mean "
          f"{float(img[:, :3].mean()):.6f}")


def _photon_light_zoo(launches):
    """(e) a diffuse shoot on the light zoo (kernel 4) against the plain
    version; every light emits."""
    import dataclasses
    import torch
    from core_tpu_torch import scene as sm
    from core_tpu_torch.integrators.photonmap import (scene_bound,
                                                      world_sphere)
    from core_tpu_torch.photon import map as pmap_mod
    from core_tpu_torch.render import scene_material_types
    from core_tpu_torch.sampling import qmc
    lz = light_zoo_scene(LZ_RES)
    if (sm.accel_kind(lz.accel), lz.geom.n_tris) != ("flat", LZ_TRIS):
        fail(f"lightzoo: {lz.geom.n_tris} triangles, not {LZ_TRIS} flat")
    types = scene_material_types(lz)
    bmin, bmax = scene_bound(lz)
    center, radius = world_sphere(lz, bmin, bmax)
    outs, ms = [], []
    for isec in ("cuda", "torch"):
        sc = dataclasses.replace(lz, intersector=isec)
        reset_counts()
        sync()
        t0 = time.perf_counter()
        outs.append(pmap_mod.shoot_photons(
            sc, types, PH_ZOO_PHOTONS, PH_ZOO_BOUNCES, 1, "diffuse", center,
            radius))
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
        if isec == "cuda":
            launches["lightzoo256_shoot"] = all_launches()
            _only_kernels(launches["lightzoo256_shoot"],
                          ("cluster_closest_hit",), "lightzoo256_shoot")
    for k, (a, b) in enumerate(zip(*outs)):
        if not torch.equal(a, b):
            fail(f"lightzoo shoot: output {k} through the kernel differs "
                 f"from the plain version's")
    pick = (qmc.scr_halton(5, torch.arange(PH_ZOO_PHOTONS, device="cuda")
                           .to(torch.int64) + 77771) * len(lz.lights)
            ).to(torch.int32).clamp_max(len(lz.lights) - 1)
    power0 = outs[0][1][:PH_ZOO_PHOTONS]
    lit = (power0 > 0).any(dim=1) & torch.isfinite(power0).all(dim=1)
    emitted = {type(li).__name__: int((lit & (pick == i)).sum())
               for i, li in enumerate(lz.lights)}
    if min(emitted.values()) < 1:
        fail(f"lightzoo shoot: a light emitted no photon: {emitted}")
    print(f"photons: lightzoo256_shoot ({PH_ZOO_PHOTONS} photons, "
          f"{PH_ZOO_BOUNCES} bounces, {LZ_TRIS} triangles): kernel "
          f"{ms[0]:.3f} ms, plain {ms[1]:.3f} ms, deposits identical, "
          f"stored {int(outs[0][3].sum())}; photons emitted per light "
          f"{emitted}; launches {launches['lightzoo256_shoot']}")


def phase_photons():
    """Phase 20 (see the header): returns the launches of each photon
    configuration and kernel 1's error row from the captured shoot."""
    launches = {}
    _photon_goldens(launches)
    _photon_slice()
    captured = _photon_pm512(launches)
    _photon_sppm512(launches)
    _photon_light_zoo(launches)
    # (f) kernel 1 on the 1M-photon diffuse shoot's bounce wavefronts
    if len(captured) != PH_PM["bounces"] + 1:
        fail(f"cornellspec512_pm: {len(captured)} closest-hit calls in the "
             f"diffuse shoot, not {PH_PM['bounces'] + 1}")
    rows = [_check_captured(f"pm512 diffuse shoot: "
                            f"{'emission' if i == 0 else f'bounce {i}'} "
                            f"closest hit", *c)
            for i, c in enumerate(captured)]
    _gap("kernel 1 (brute closest hit), 1M-photon diffuse shoot", rows)
    return launches, {"closest_hit": {"max_abs_err": max(
        r["max_abs_err"] for r in rows)}}


# --------------------------------------------------------------------------
# phase 21: the bidirectional path tracer, subsurface scattering with the
# translucent material, the debug integrator
# --------------------------------------------------------------------------

BD_GOLDEN_RES = 64
BD_GOLDEN_AA = 8
# tests/test_golden_photon_family.py:100-106: refgold/arbiter64.py's float64
# energy of the 64^2 box
ARBITER64_ENERGY = 0.6524
BD_RES = 256
BD_TIMED = 3                 # timed 1-spp chunks after the counted one
BD_SLICE = 64
SSS_RES = 256
SSS_SIGMA = (8.0, 8.0, 8.0)
SSS_PHOTONS = 8192
SSS_STEPS = 4
SSS_TIMED = 2
# tests/test_sss.py's options of each integrator
SSS_FIELDS = {"dl": dict(raydepth=1),
              "pt": dict(path_samples=2, bounces=2, raydepth=1)}
SSS_BLOCK = (10, 34)         # the short block's triangles
DEBUG_TYPES = ("N", "dPdU", "dPdV", "NU", "NV", "dSdU", "dSdV")
BRUTE_BD = ("closest_hit", "any_hit")
FLAT_BD = ("cluster_closest_hit", "cluster_any_hit")
# the light types the light zoo lacks, for emit_pdf on all ten
EMIT_EXTRA_LIGHTS = (
    ("area", {"type": "arealight", "corner": (-1.0, 5.0, -1.0),
              "point1": (1.0, 5.0, -1.0), "point2": (-1.0, 5.0, 1.0),
              "color": (1.0, 1.0, 0.9), "power": 2.0, "samples": 1}),
    ("point", {"type": "pointlight", "from": (0.5, 4.0, 0.5),
               "color": (1.0, 0.9, 0.8), "power": 5.0}),
    ("spot", {"type": "spotlight", "from": (2.0, 5.0, 1.0),
              "to": (0.0, 0.0, 0.0), "color": (0.9, 0.9, 1.0), "power": 8.0,
              "cone_angle": 30.0, "blend": 0.2}),
    ("directional", {"type": "directional", "direction": (0.2, 1.0, 0.3),
                     "color": (1.0, 1.0, 1.0), "power": 1.5}))


def translucent_box(res, light_samples, sigma_s=SSS_SIGMA,
                    intersector="auto", device="cuda"):
    """tests/test_sss.py:18-49's scene built by the port: the Cornell box
    whose short block (triangles 10-33) wears a translucent material."""
    import dataclasses
    from core_tpu_torch.materials.base import (MaterialDef, MatType,
                                               build_material_table)
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=res, resy=res, light_samples=light_samples,
                        with_blocks=True, device=device)
    mats = [MaterialDef(name="white", diffuse_color=(0.75, 0.75, 0.75)),
            MaterialDef(name="red", diffuse_color=(0.63, 0.065, 0.05)),
            MaterialDef(name="green", diffuse_color=(0.14, 0.45, 0.091)),
            MaterialDef(name="light", diffuse_color=(1.0, 1.0, 1.0),
                        diffuse_strength=0.0, emit_strength=30.0),
            MaterialDef(name="sss", mtype=MatType.TRANSLUCENT,
                        diffuse_color=(0.9, 0.7, 0.6),
                        glossy_color=(0.2, 0.2, 0.2), glossy_reflect=0.1,
                        diffuse_strength=0.4, ior=1.3,
                        absorption=(0.02, 0.04, 0.06), sigma_s=sigma_s,
                        sss_g=0.0)]
    tri_mat = scene.geom.tri_mat.clone()
    tri_mat[SSS_BLOCK[0]:SSS_BLOCK[1]] = 4
    scene = dataclasses.replace(
        scene, geom=scene.geom._replace(tri_mat=tri_mat),
        materials=build_material_table(mats, scene.device),
        mat_types=tuple(sorted({int(d.mtype) for d in mats})))
    return scene if intersector == "auto" else \
        dataclasses.replace(scene, intersector=intersector)


def bidir_opts(aa, spp_chunk, **fields):
    """The bidirectional integrator with BidirOptions(**fields) and the
    goldens' film (a box filter of size 1)."""
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.bidir import BidirOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(integrator="bidirectional",
                         integrator_opts=BidirOptions(**fields),
                         aa_samples=aa, spp_chunk=spp_chunk, filter_size=1.0,
                         filter_type=FilterType.BOX)


def sss_opts(kind, use_sss, aa=1, spp_chunk=1):
    """tests/test_sss.py's directlight ("dl") or path-tracing ("pt")
    options, with use_sss and this phase's photons and steps."""
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.render import RenderOptions
    integ, cls = {"dl": ("directlight", DirectOptions),
                  "pt": ("pathtracing", PathOptions)}[kind]
    return RenderOptions(integrator=integ, aa_samples=aa,
                         spp_chunk=spp_chunk, integrator_opts=cls(
                             use_sss=use_sss, sss_photons=SSS_PHOTONS,
                             sss_steps=SSS_STEPS, **SSS_FIELDS[kind]))


def _timed_chunks(scene, opts, cfg, want, launches, aux=None, timed=1,
                  res=BD_RES):
    """One counted 1-spp chunk (launches[cfg]; only the kernels of `want`
    may launch), then `timed` more on the host clock; returns (film,
    [ms], peak MiB, rays of the counted chunk)."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    types = scene_material_types(scene)
    film = film_mod.make_film(res, res, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    sync()
    with torch.no_grad():
        film, rays = counted_rays(lambda: render_chunk(
            scene, types, opts, film, 0, 1, 0, aux))
    sync()
    launches[cfg] = all_launches()
    _only_kernels(launches[cfg], want, cfg)
    ms = []
    for k in range(timed):
        t0 = time.perf_counter()
        with torch.no_grad():
            film = render_chunk(scene, types, opts, film, 0, 1, k + 1, aux)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return film, ms, torch.cuda.max_memory_allocated() / 2**20, rays


def _bd_golden(launches):
    """(a) the bidirectional golden through kernels 1 and 3."""
    import torch
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=BD_GOLDEN_RES, resy=BD_GOLDEN_RES,
                        light_samples=16, device="cuda")
    reset_counts()
    sync()
    t0 = time.perf_counter()
    img, _ = render_image(scene, bidir_opts(BD_GOLDEN_AA, 2,
                                            do_light_image=False))
    sync()
    dt = time.perf_counter() - t0
    launches["bd64_golden"] = all_launches()
    _only_kernels(launches["bd64_golden"], BRUTE_BD, "bd64_golden")
    if not bool(torch.isfinite(img).all()):
        fail("bd64_golden: non-finite image")
    rel, pearson, _ = photon_golden_stats("bd", img)
    mean = float(img[..., :3].mean())
    gap = abs(mean - ARBITER64_ENERGY) / ARBITER64_ENERGY
    print(f"bidir: bd64_golden ({PH_GOLDEN_FILES['bd']}): Pearson "
          f"{pearson:.6f} (> 0.99), energy rel {rel:.6f} (in [0.1, 0.6]), "
          f"mean {mean:.6f} vs the float64 arbiter {ARBITER64_ENERGY}: "
          f"{gap:.6f} (< 0.10); {dt:.3f} s a request, launches "
          f"{launches['bd64_golden']}")
    if not (pearson > 0.99 and 0.1 <= rel <= 0.6 and gap < 0.10):
        fail("bd64_golden outside tests/test_golden_photon_family.py's bands")


def _bd_slices():
    """(b) 64^2 renders through the kernels against the plain versions:
    bidirectional with the light image, SSS under both integrators, every
    debug type on golden_mesh_scene."""
    import torch
    from core_tpu_torch.integrators.debug import DebugOptions
    from core_tpu_torch.render import RenderOptions, render_image
    from core_tpu_torch.scenes import cornell_box
    cases = [("bidirectional, light image on", lambda isec: cornell_box(
        resx=BD_SLICE, resy=BD_SLICE, light_samples=4, intersector=isec,
        device="cuda"), bidir_opts(2, 2), BRUTE_BD)]
    for kind in ("dl", "pt"):
        cases.append((f"sss {kind}", lambda isec: translucent_box(
            BD_SLICE, 4, intersector=isec), sss_opts(kind, True, aa=2,
                                                     spp_chunk=2),
            ("closest_hit", "any_hit_nee")))
    for t in DEBUG_TYPES:
        cases.append((f"debug {t}", lambda isec: golden_scene(BD_SLICE, isec),
                      RenderOptions(integrator="debug",
                                    integrator_opts=DebugOptions(
                                        debug_type=t)), ("closest_hit",)))
    for what, make, opts, want in cases:
        imgs = []
        for isec in ("cuda", "torch"):
            reset_counts()
            imgs.append(render_image(make(isec), opts)[0])
            sync()
            if isec == "cuda":
                counts = all_launches()
                _only_kernels(counts, want, f"{BD_SLICE}^2 {what}")
        if not bool(torch.isfinite(imgs[0]).all()) \
                or not torch.equal(*imgs):
            fail(f"{BD_SLICE}^2 {what}: kernel and plain renders differ or "
                 f"are not finite: max abs "
                 f"{float((imgs[0] - imgs[1]).abs().max())}")
        print(f"bidir slice: {BD_SLICE}x{BD_SLICE} {what}: through the "
              f"kernels == through the plain versions (bit-identical), mean "
              f"{float(imgs[0][..., :3].mean()):.6f}, sha256 "
              f"{image_digest(imgs[0])}, kernel launches {counts}")


def _bd_cornell256(launches):
    """(c) cornell256_bd: chunks timed, the light image's splats counted,
    kernels 1 and 3 on the captured inputs of one chunk; returns their
    error rows."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import render as render_mod
    from core_tpu_torch.render import render_chunk, scene_material_types
    from core_tpu_torch.scenes import cornell_box
    scene = cornell_box(resx=BD_RES, resy=BD_RES, light_samples=16,
                        device="cuda")
    opts = bidir_opts(1, 1)
    splats = []
    orig = film_mod.add_density_samples

    def counted(film, x, y, col, n_paths, sample_mask=None):
        h, w = film.density.shape[:2]
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h) & sample_mask
        splats.append((int(inside.sum()), x.shape[0]))
        return orig(film, x, y, col, n_paths, sample_mask)

    render_mod.film_mod.add_density_samples = counted
    try:
        film, ms, peak, rays = _timed_chunks(scene, opts, "cornell256_bd",
                                             BRUTE_BD, launches,
                                             timed=BD_TIMED)
    finally:
        render_mod.film_mod.add_density_samples = orig
    img = film_mod.flush(film)
    if not bool(torch.isfinite(img).all()):
        fail("cornell256_bd: non-finite image")
    write_png(BUILD / "chip_smoke_cornell256_bd.png", img.cpu().numpy())
    types = scene_material_types(scene)
    with torch.no_grad():
        busy = _busy(lambda: render_chunk(scene, types, opts,
                                          film_mod.make_film(
                                              BD_RES, BD_RES, device="cuda"),
                                          0, 1, 0))
    landed, tried = splats[0]
    print(f"bidir: cornell256_bd: {BD_RES}x{BD_RES}, 1-spp chunks "
          f"{[round(t, 3) for t in ms]} ms (median "
          f"{sorted(ms)[len(ms) // 2]:.3f}), rays per chunk {rays}; peak "
          f"device memory {peak:.1f} MiB; launches per chunk "
          f"{launches['cornell256_bd']}; light-image splats per chunk: "
          f"{landed} of {tried} land (unoccluded, in the image); image "
          f"mean {float(img[..., :3].mean()):.6f}; {busy}")
    calls = _capture_calls(scene, BD_RES, opts)
    got = {q: [c for c in calls if c[0] == q] for q in ("closest", "any")}
    if (len(got["closest"]), len(got["any"])) != (6, 15) \
            or len(calls) != 21:
        fail(f"cornell256_bd chunk: {len(got['closest'])} closest and "
             f"{len(got['any'])} any-hit calls of {len(calls)}, not 6 and "
             f"15")
    names = {"closest": ["eye camera", "eye bounce 1", "eye bounce 2",
                         "light emission", "light bounce 1",
                         "light bounce 2"],
             "any": [f"s={s} visibility, eye vertex {i + 1}"
                     for i in range(3) for s in range(1, 5)]
             + [f"t=1 visibility, light vertex {j + 1}" for j in range(3)]}
    rows = {}
    for kernel, k, q in (("closest_hit", 1, "closest"), ("any_hit", 3, "any")):
        per = [_check_captured(f"cornell256_bd: {name}"
                               f"{' closest hit' if q == 'closest' else ''}",
                               *c) for name, c in zip(names[q], got[q])]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per)}
        _gap(f"kernel {k}, cornell256_bd captured calls", per)
    return rows


def _emit_pdf_all_types():
    """emit_pdf of all ten light types on the card, at emission points
    and directions of emit_photon: finite, the pdfs positive, the cosines
    in [0, 1]."""
    import torch
    from core_tpu_torch import scenes
    from core_tpu_torch.environment import SceneBuilder
    from core_tpu_torch.integrators.photonmap import scene_center_radius
    from core_tpu_torch.lights.base import emit_pdf
    from core_tpu_torch.params import ParamMap
    from core_tpu_torch.photon.emit import emit_photon
    b = light_zoo_builder(SceneBuilder("cuda"), ParamMap, scenes, 16,
                          grid=12, torus=(12, 8), samples=1, panel=1)
    for name, params in EMIT_EXTRA_LIGHTS:
        b.create("light", name, ParamMap(dict(params)))
    zoo = b.compile_scene()
    center, radius = scene_center_radius(zoo)
    s = torch.rand((4, 65536), generator=torch.Generator("cuda")
                   .manual_seed(21), device="cuda")
    seen = {}
    for light in zoo.lights:
        o, d, _, _ = emit_photon(light, *s, center, radius)
        area, dirp, cos, sing, ddir = emit_pdf(light, o, d,
                                               scene_radius=radius)
        ok = all(bool(torch.isfinite(x).all()) for x in (area, dirp, cos)) \
            and bool((area > 0).all()) and bool((dirp >= 0).all()) \
            and float(dirp.max()) > 0 and bool((cos >= 0).all()) \
            and float(cos.max()) <= 1.0 + 1e-6
        if not ok:
            fail(f"emit_pdf of {type(light).__name__} on the card: not "
                 "finite or out of range")
        seen[type(light).__name__] = (round(float(dirp.mean()), 6),
                                      bool(sing), bool(ddir))
    if len(seen) != 10:
        fail(f"emit_pdf: {len(seen)} light types, not 10: {sorted(seen)}")
    print(f"bidir: emit_pdf of the ten light types on the card (mean "
          f"direction pdf, singular, dirac direction): {seen}")


def _dark(light):
    """The light with its emission scaled to 0 and its pdfs kept: its
    colour, the sun's col_pdf, a portal's power, or a background light's
    background's power."""
    import dataclasses
    import torch
    fields = {f.name for f in dataclasses.fields(light)}
    for f in ("color", "col_pdf", "power"):
        if f in fields:
            return dataclasses.replace(
                light, **{f: torch.zeros_like(getattr(light, f))})
    bg = light.background
    return dataclasses.replace(light, background=dataclasses.replace(
        bg, power=torch.zeros_like(bg.power)))


def _bd_light_zoo(launches):
    """(d) lightzoo256_bd on kernels 4 and 5: one counted and timed chunk,
    each light's contribution alone, kernels 4 and 5 on captured
    wavefronts; returns their error rows."""
    import dataclasses
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.integrators.bidir import BidirOptions
    from core_tpu_torch.render import render_chunk, scene_material_types
    lz = light_zoo_scene(LZ_RES)
    opts = dataclasses.replace(light_zoo_opts("dl"),
                               integrator="bidirectional",
                               integrator_opts=BidirOptions())
    film, ms, peak, rays = _timed_chunks(lz, opts, "lightzoo256_bd", FLAT_BD,
                                         launches, res=LZ_RES)
    img = film_mod.flush(film)
    if not bool(torch.isfinite(img).all()):
        fail("lightzoo256_bd: non-finite image")
    write_png(BUILD / "chip_smoke_lightzoo256_bd.png", img.cpu().numpy())
    types = scene_material_types(lz)

    def chunk(sc):
        with torch.no_grad():
            f = render_chunk(sc, types, opts, film_mod.make_film(
                LZ_RES, LZ_RES, device="cuda"), 0, 1, 0)
        return film_mod.flush(f)

    busy = _busy(lambda: chunk(lz))
    # each light's contribution: the chunk minus the same chunk with that
    # light's emission scaled to 0 (its pdfs, and so every weight, kept)
    full = chunk(lz)[..., :3]
    per = {}
    for i, light in enumerate(lz.lights):
        lights = list(lz.lights)
        lights[i] = _dark(light)
        dark = chunk(dataclasses.replace(lz, lights=tuple(lights)))[..., :3]
        per[type(light).__name__] = float((full - dark).mean())
    print(f"bidir: lightzoo256_bd: {LZ_RES}x{LZ_RES}, one 1-spp chunk "
          f"{ms[0]:.3f} ms, rays {rays}; peak device memory {peak:.1f} MiB; "
          f"launches per chunk {launches['lightzoo256_bd']}; image mean "
          f"{float(img[..., :3].mean()):.6f}; each light's contribution "
          f"(the chunk minus the chunk with its emission 0, image mean) "
          f"{per}; {busy}")
    if min(per.values()) <= 0:
        fail(f"lightzoo256_bd: a light contributes nothing: {per}")
    calls = _capture_calls(lz, LZ_RES, opts)
    got = {q: [c for c in calls if c[0] == q] for q in ("closest", "any")}
    if (len(got["closest"]), len(got["any"])) != (6, 15):
        fail(f"lightzoo256_bd chunk: {len(got['closest'])} closest and "
             f"{len(got['any'])} any-hit calls, not 6 and 15")
    rows = {}
    for kernel, k, q, picks in (
            ("cluster_closest_hit", 4, "closest",
             ((0, "eye camera closest hit"),
              (3, "light emission closest hit"))),
            ("cluster_any_hit", 5, "any",
             ((0, "s=1 visibility, eye vertex 1"),
              (1, "s=2 visibility, eye vertex 1")))):
        per_k = [_check_captured(f"lightzoo256_bd: {name}", *got[q][i])
                 for i, name in picks]
        rows[kernel] = {"max_abs_err": max(r["max_abs_err"] for r in per_k)}
        _gap(f"kernel {k}, lightzoo256_bd captured calls ({len(picks)} of "
             f"{len(got[q])})", per_k)
    return rows


def _sss_configs(launches):
    """(e) cornell256_sss_dl / _pt: the SSS map's build, chunks, the
    dipole estimate's device time, the energy SSS adds on the block."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import scene as sm
    from core_tpu_torch.cameras import shoot_ray
    from core_tpu_torch.integrators import sss as sss_mod
    from core_tpu_torch.render import (render_chunk, render_image,
                                       scene_material_types)
    from core_tpu_torch.vec import rays_to_soa
    scene = translucent_box(SSS_RES, 16)
    types = scene_material_types(scene)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        smap = sss_mod.build_sss_map(scene, types, n_photons=SSS_PHOTONS,
                                     interior_steps=SSS_STEPS)
    sync()
    build_s = time.perf_counter() - t0
    launches["cornell256_sss_map"] = all_launches()
    _only_kernels(launches["cornell256_sss_map"], ("closest_hit",),
                  "cornell256_sss_map")
    n_valid = int(smap.valid.sum())
    print(f"sss: cornell256_sss_map: {SSS_PHOTONS} photons, 2 surface "
          f"bounces x {SSS_STEPS} interior steps: {build_s:.3f} s, valid "
          f"deposits {n_valid} of {smap.valid.shape[0]}, launches "
          f"{launches['cornell256_sss_map']}")
    if n_valid == 0:
        fail("cornell256_sss_map: no deposit")

    # the camera hits of one chunk, for the dipole estimate alone
    h = w = SSS_RES
    ys, xs = torch.meshgrid(torch.arange(h, device="cuda"),
                            torch.arange(w, device="cuda"), indexing="ij")
    rays, _ = shoot_ray(scene.camera, xs.reshape(-1).float() + 0.5,
                        ys.reshape(-1).float() + 0.5)
    rs = rays_to_soa(rays)
    hits = sm.closest_hit_s(scene, rs)
    sps = sm.surface_points_s(scene, rs, hits)
    p = sm.material_params_s(scene, sps)
    est_ms, est = cuda_time_ms(lambda: sss_mod.estimate_sss(
        smap, sps, p, -rs.d, hits.valid), 3, warmup=1)
    block = (hits.prim >= SSS_BLOCK[0]) & (hits.prim < SSS_BLOCK[1])
    print(f"sss: the dipole estimate at the {h * w} camera hits "
          f"({int(block.sum())} on the block) over {n_valid} deposits: "
          f"{est_ms:.3f} ms (CUDA events), mean on the block "
          f"{float(torch.stack(list(est), -1)[block].mean()):.6f}")
    block = block.reshape(h, w)
    for kind in ("dl", "pt"):
        cfg = f"cornell256_sss_{kind}"
        opts = sss_opts(kind, True)
        aux = smap if kind == "dl" else {"sss": smap}
        film, ms, peak, rays = _timed_chunks(
            scene, opts, cfg, ("closest_hit", "any_hit_nee"), launches,
            aux=aux, timed=SSS_TIMED, res=SSS_RES)
        img = film_mod.flush(film)
        img_off, _ = render_image(scene, sss_opts(kind, False))
        img_on, _ = render_image(scene, opts)
        if not bool(torch.isfinite(img).all()) \
                or not bool(torch.isfinite(img_on).all()):
            fail(f"{cfg}: non-finite image")
        gain = float((img_on - img_off)[..., :3][block].mean())
        write_png(BUILD / f"chip_smoke_{cfg}.png", img.cpu().numpy())
        with torch.no_grad():
            busy = _busy(lambda: render_chunk(
                scene, types, opts, film_mod.make_film(
                    SSS_RES, SSS_RES, device="cuda"), 0, 1, 0, aux))
        print(f"sss: {cfg}: {SSS_RES}x{SSS_RES}, 1-spp chunks "
              f"{[round(t, 3) for t in ms]} ms, rays per chunk {rays}; "
              f"peak device memory {peak:.1f} MiB; launches per chunk "
              f"{launches[cfg]}; with SSS minus without, mean on the "
              f"block {gain:.6f}; image mean "
              f"{float(img[..., :3].mean()):.6f}; {busy}")
        if gain <= 0:
            fail(f"{cfg}: SSS adds no energy on the block ({gain})")


def phase_bidir():
    """Phase 21 (see the header): returns the launches of each
    configuration and the kernels' error rows."""
    launches, rows = {}, {}
    _bd_golden(launches)
    _bd_slices()
    rows.update(_bd_cornell256(launches))
    _emit_pdf_all_types()
    rows.update(_bd_light_zoo(launches))
    _sss_configs(launches)
    return launches, rows


# --------------------------------------------------------------------------
# phase 22
# --------------------------------------------------------------------------

VOL_GOLDEN_RES = 128
VOL_GOLDEN_AA = 16
VOL_STEPS = 24
VOL_RES = 512
VOL_SLICE = 64
VOL_TIMED = 1                # timed requests after the counted (and timed) one
FOG_RES = 256
# the fog filling the Cornell box's interior: sigma_s 0.05, sigma_a 0.01
# per unit of density; a density of 0.01 keeps the box's 550 units of
# depth at an optical depth near 0.3 (the noise's own values scale it)
FOG = dict(sigma_s=0.05, sigma_a=0.01, density=0.01,
           bmin=(0.0, 0.0, 0.0), bmax=(556.0, 548.8, 559.2))
FOG_STEPS = 16
AA3 = dict(aa_passes=3, aa_samples=2, aa_inc_samples=2, aa_threshold=0.05,
           show_sam_pix=True, spp_chunk=2)
# tests/test_golden_volume.py's bands
VOL_BANDS = {"air_mean_rel": 0.02, "air_mae_rel": 0.04,
             "ground_mean_rel": 0.02, "optimize_rel": 0.03}
VOL_PEARSON = 0.999
# per chunk of the golden: the directlight camera hit and the volume
# branch's own (kernel 1); 24 march steps and the spotlight's NEE (kernel 3)
VOL_GOLDEN_LAUNCHES = {"closest_hit": 2, "any_hit": VOL_STEPS + 1}
VOL_CFGS = {  # name: (resolution on the card, the kernels it launches)
    "vol128_golden": (VOL_GOLDEN_RES, ("closest_hit", "any_hit")),
    "vol512_ss": (VOL_RES, ("closest_hit", "any_hit")),
    "cornell256_fog_pt": (FOG_RES, ("closest_hit", "any_hit_nee",
                                    "any_hit")),
    "goldenmesh256_sky_dl": (256, ("closest_hit", "any_hit_nee")),
    "cornell256_aa3_dl": (256, ("closest_hit", "any_hit_nee"))}


def volume_golden_opts(aa=VOL_GOLDEN_AA, spp_chunk=2, optimize=False):
    """tests/test_golden_volume.py's options: directlight raydepth 1,
    single scattering in 24 steps, box filter 1.0."""
    from core_tpu_torch.film import FilterType
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.volume import VolumeOptions
    from core_tpu_torch.render import RenderOptions
    return RenderOptions(
        aa_samples=aa, spp_chunk=spp_chunk, filter_size=1.0,
        filter_type=FilterType.BOX,
        integrator_opts=DirectOptions(raydepth=1),
        volume_opts=VolumeOptions(integrator="singlescatter",
                                  steps=VOL_STEPS, optimize=optimize))


def fog_box(res, intersector="auto", device="cuda"):
    """The Cornell box (light_samples=4) with a NoiseVolume (FOG) filling
    its interior."""
    import dataclasses
    from core_tpu_torch.scenes import cornell_box
    from core_tpu_torch.volumes import make_noise_volume
    scene = cornell_box(resx=res, resy=res, light_samples=4,
                        intersector=intersector, device=device)
    return dataclasses.replace(scene, volumes=(make_noise_volume(
        **FOG, device=scene.device),))


def volume_config(name, res, intersector="auto", device="cuda"):
    """(scene, RenderOptions) of a phase-22 configuration at res^2."""
    import dataclasses
    from core_tpu_torch.integrators.direct import DirectOptions
    from core_tpu_torch.integrators.path import PathOptions
    from core_tpu_torch.integrators.volume import VolumeOptions
    from core_tpu_torch.render import RenderOptions
    from core_tpu_torch.scenes import (cornell_box, golden_mesh_scene,
                                       golden_volume_scene)
    if name in ("vol128_golden", "vol512_ss"):
        scene = golden_volume_scene(res, res, device=device)
        opts = volume_golden_opts() if name == "vol128_golden" \
            else volume_golden_opts(aa=4, spp_chunk=4)
    elif name == "cornell256_fog_pt":
        scene = fog_box(res, device=device)
        opts = RenderOptions(
            integrator="pathtracing", integrator_opts=PathOptions(
                path_samples=PATH_SAMPLES, bounces=BOUNCES, raydepth=2),
            volume_opts=VolumeOptions(integrator="singlescatter",
                                      steps=FOG_STEPS))
    elif name == "goldenmesh256_sky_dl":
        scene = golden_mesh_scene(res, res, ibl_samples=8, device=device)
        opts = dataclasses.replace(golden_opts("dl"),
                                   volume_opts=VolumeOptions(
                                       integrator="sky"))
    elif name == "cornell256_aa3_dl":
        scene = cornell_box(resx=res, resy=res, light_samples=LIGHT_SAMPLES,
                            device=device)
        opts = RenderOptions(integrator_opts=DirectOptions(raydepth=2),
                             **AA3)
    else:
        raise ValueError(name)
    if intersector != "auto":
        scene = dataclasses.replace(scene, intersector=intersector)
    return scene, opts


def volume_golden_stats(img):
    """tests/test_golden_volume.py's numbers of one 128^2 image, the 2-px
    border cropped: the air's mean and mean-absolute errors over the
    reference mean, the ground's mean error and 12 x 12 block Pearson."""
    import numpy as np
    ref = np.load(ROOT / "tests" / "golden" / "vol_ss_128x128_16spp.npz"
                  )["img"][2:-2, 2:-2]
    img = img.cpu().numpy()[2:-2, 2:-2]
    if img.shape != ref.shape or not np.isfinite(img).all():
        fail(f"vol128_golden: image {img.shape} vs {ref.shape}, or not "
             "finite")
    out = {}
    for part, m in (("air", ref[..., 3] < 0.5), ("ground", ref[..., 3] > 0.5)):
        a, r = img[m][:, :3], ref[m][:, :3]
        out[f"{part}_mean_rel"] = float(abs(a.mean() - r.mean())
                                        / max(r.mean(), 1e-6))
        out[f"{part}_mae_rel"] = float(np.abs(a - r).mean()
                                       / max(r.mean(), 1e-6))
    bm = img[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    br = ref[:120, :120, :3].reshape(12, 10, 12, 10, 3).mean((1, 3, 4))
    out["ground_pearson"] = float(np.corrcoef(bm.ravel(), br.ravel())[0, 1])
    return out


def volume_golden_ok(stats) -> bool:
    return (stats["air_mean_rel"] < VOL_BANDS["air_mean_rel"]
            and stats["air_mae_rel"] < VOL_BANDS["air_mae_rel"]
            and stats["ground_mean_rel"] < VOL_BANDS["ground_mean_rel"]
            and stats["ground_pearson"] > VOL_PEARSON)


def optimize_rel(device="cuda"):
    """optimize=True against the march at 64^2, 4 spp (the golden test's
    self-consistency check)."""
    from core_tpu_torch.render import render_image
    scene, _ = volume_config("vol128_golden", 64, device=device)
    a, b = (render_image(scene, volume_golden_opts(4, 2, optimize=o))[0]
            for o in (False, True))
    return float(abs(b[..., :3].mean() - a[..., :3].mean())
                 / max(float(a[..., :3].mean()), 1e-6))


def _chunks(opts):
    per = [opts.aa_samples] + [opts.aa_inc_samples] * (opts.aa_passes - 1)
    return sum(-(-n // opts.spp_chunk) for n in per)


def _vol_golden(launches):
    """(a) the volume golden through kernels 1 and 3, at its bands."""
    import torch
    from core_tpu_torch.render import render_image
    scene, opts = volume_config("vol128_golden", VOL_GOLDEN_RES)
    reset_counts()
    sync()
    t0 = time.perf_counter()
    img, _ = render_image(scene, opts)
    sync()
    dt = time.perf_counter() - t0
    counts = all_launches()
    launches["vol128_golden_request"] = counts
    n = _chunks(opts)
    want = {k: v * n for k, v in VOL_GOLDEN_LAUNCHES.items()}
    if {k: c for k, c in counts.items() if c} != want or plain_calls():
        fail(f"vol128_golden: launches {counts} per request, expected "
             f"{want} ({n} chunks); plain calls {plain_calls()}")
    stats = volume_golden_stats(img)
    rel = optimize_rel()
    print(f"volumes: vol128_golden (vol_ss_128x128_16spp): air mean rel "
          f"{stats['air_mean_rel']:.6f} (< 0.02), air MAE rel "
          f"{stats['air_mae_rel']:.6f} (< 0.04), ground mean rel "
          f"{stats['ground_mean_rel']:.6f} (< 0.02), ground block Pearson "
          f"{stats['ground_pearson']:.6f} (> 0.999); optimize against the "
          f"march at 64^2 x 4 spp: rel {rel:.6f} (< 0.03); {dt:.3f} s a "
          f"request of {n} chunks, launches per request {counts}")
    write_png(BUILD / "chip_smoke_vol128_golden.png", img.cpu().numpy())
    if not volume_golden_ok(stats) or not rel < VOL_BANDS["optimize_rel"]:
        fail("vol128_golden outside tests/test_golden_volume.py's bands")
    if not bool(torch.isfinite(img).all()):
        fail("vol128_golden: non-finite image")


def _vol_slices():
    """(b) each configuration at 64^2 through the kernels and through the
    plain versions: identical images (show_sam_pix's marks included)."""
    import torch
    from core_tpu_torch.render import render_image
    for name, (_, want) in VOL_CFGS.items():
        t0 = time.perf_counter()
        imgs = []
        for isec in ("cuda", "torch"):
            scene, opts = volume_config(name, VOL_SLICE, isec)
            reset_counts()
            imgs.append(render_image(scene, opts)[0])
            sync()
            if isec == "cuda":
                counts = all_launches()
                _only_kernels(counts, want, f"{VOL_SLICE}^2 {name}")
        if not bool(torch.isfinite(imgs[0]).all()) \
                or not torch.equal(*imgs):
            fail(f"{VOL_SLICE}^2 {name}: kernel and plain renders differ "
                 f"or are not finite: max abs "
                 f"{float((imgs[0] - imgs[1]).abs().max())}")
        print(f"volumes slice: {VOL_SLICE}x{VOL_SLICE} {name}: through the "
              f"kernels == through the plain versions (bit-identical), mean "
              f"{float(imgs[0][..., :3].mean()):.6f}, sha256 "
              f"{image_digest(imgs[0])}, kernel launches {counts}; "
              f"{time.perf_counter() - t0:.1f} s")


def _vol_timed(launches):
    """(c) each configuration at its size: one counted request, VOL_TIMED
    more, each timed; ms per chunk, launches per chunk of each kernel,
    peak memory, the busy share of one profiled request; the adaptive
    passes' flagged pixels (render_image's verbose lines) and the pixels
    show_sam_pix marks red."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch.render import render_image
    for name, (res, want) in VOL_CFGS.items():
        scene, opts = volume_config(name, res)
        n = _chunks(opts)
        t_cfg = time.perf_counter()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        (img, film), rays = counted_rays(lambda: render_image(
            scene, opts, verbose=opts.aa_passes > 1))
        sync()
        ms = [(time.perf_counter() - t_cfg) * 1e3 / n]
        counts = all_launches()
        _only_kernels(counts, want, name)
        launches[name] = {k: c / n for k, c in counts.items()}
        peak = torch.cuda.max_memory_allocated() / 2**20
        if not bool(torch.isfinite(img).all()):
            fail(f"{name}: non-finite image")
        for _ in range(VOL_TIMED):
            t0 = time.perf_counter()
            render_image(scene, opts)
            sync()
            ms.append((time.perf_counter() - t0) * 1e3 / n)
        t_busy = time.perf_counter()
        busy = _busy(lambda: render_image(scene, opts), "request")
        t_busy = time.perf_counter() - t_busy
        write_png(BUILD / f"chip_smoke_{name}.png", img.cpu().numpy())
        extra = f"; marked red by show_sam_pix " \
            f"{int(film_mod.next_pass_flags(film, opts.aa_threshold).sum())}" \
            if opts.show_sam_pix and opts.aa_passes > 1 else ""
        print(f"volumes: {name}: {res}x{res}, {n} chunk(s) a request, ms "
              f"per chunk {[round(t, 3) for t in ms]}, rays a request "
              f"{rays}, launches per chunk {launches[name]}; peak device "
              f"memory {peak:.1f} MiB; image mean "
              f"{float(img[..., :3].mean()):.6f}; {busy}{extra}; "
              f"{time.perf_counter() - t_cfg:.1f} s, the profile "
              f"{t_busy:.1f} s of it")


# the kernel calls of one captured chunk, in order: (closest, NEE, any)
VOL_CAPTURED = {
    # directlight's camera hit and the volume branch's own; the
    # spotlight's NEE, then the 24 march steps' shadow tests
    "vol512_ss": (["camera", "volume branch camera"], [],
                  ["spotlight NEE"] + [f"march step {i + 1}"
                                       for i in range(VOL_STEPS)]),
    # the path tracer's camera hit, 5 bounces and the volume branch's
    # camera hit; a bundle at each of the 6 vertices; the 16 march steps
    "cornell256_fog_pt": (["camera"] + [f"bounce {i}" for i in range(1, 6)]
                          + ["volume branch camera"],
                          ["camera vertex"] + [f"bounce {i} vertex"
                                               for i in range(1, 6)],
                          [f"march step {i + 1}" for i in range(FOG_STEPS)])}


def _vol_captured():
    """(d) one chunk of vol512_ss (4 spp: 1,048,576 lanes) and of
    cornell256_fog_pt at full size with the route's kernel wrappers
    recorded: every captured call of kernels 1, 2 and 3 against its plain
    version lane by lane, timed, with its bound, and launches x (kernel -
    bound) per chunk; returns the kernels' error rows."""
    from core_tpu_torch.integrators import volume as vol_mod
    rows = {}
    for name, names in VOL_CAPTURED.items():
        res = VOL_CFGS[name][0]
        scene, opts = volume_config(name, res)
        # the request's first chunk: min(spp_chunk, aa_samples) samples
        calls = _capture_calls(scene, res, opts,
                               spp=min(opts.spp_chunk, opts.aa_samples),
                               vol_aux=vol_mod.precompute_attenuation(
                                   scene, opts.volume_opts))
        got = [[c for c in calls if c[0] == q]
               for q in ("closest", "nee", "any")]
        if [len(g) for g in got] != [len(x) for x in names] \
                or len(calls) != sum(len(x) for x in names):
            fail(f"{name} chunk: {[len(g) for g in got]} closest, NEE and "
                 f"any-hit calls of {len(calls)}, not "
                 f"{[len(x) for x in names]}")
        for (kernel, k), labels, cs in zip(
                (("closest_hit", 1), ("any_hit_nee", 2), ("any_hit", 3)),
                names, got):
            if not cs:
                continue
            per = [_check_captured(f"{name}: {label}", *c)
                   for label, c in zip(labels, cs)]
            err = max(r["max_abs_err"] for r in per)
            rows[kernel] = {"max_abs_err": max(
                err, rows.get(kernel, {"max_abs_err": 0.0})["max_abs_err"])}
            _gap(f"kernel {k}, {name} captured calls (all {len(cs)})", per)
        del calls, got
    return rows


def phase_volumes():
    """Phase 22 (see the header): returns the launches of each
    configuration and the kernels' error rows."""
    launches = {}
    _vol_golden(launches)
    _vol_slices()
    _vol_timed(launches)
    return launches, _vol_captured()

# --------------------------------------------------------------------------
# phase 23: the front ends (scene files, the CLI, the embedding Interface)
# --------------------------------------------------------------------------

FRONTEND_LIMIT_S = 90
MESH_XML_REL = 1e-3          # mean |xml - in-memory| over mean in-memory


def _set_params(yi, params):
    """A dict of element parameters as an interface's paramsSet* calls."""
    for k, v in params.items():
        if isinstance(v, bool):
            yi.params_set_bool(k, v)
        elif isinstance(v, int):
            yi.params_set_int(k, v)
        elif isinstance(v, float):
            yi.params_set_float(k, v)
        elif isinstance(v, str):
            yi.params_set_string(k, v)
        elif "color" in k:
            yi.params_set_color(k, *v)
        else:
            yi.params_set_point(k, *v)


def _as_in_file(x) -> float:
    """x at the 8 significant digits a scene file keeps (XmlInterface's
    .8g), so that an Interface given the calls builds the scene the file
    holds; writing it again gives the same text."""
    return float(f"{x:.8g}")


class _Replay:
    """A MeshAssembler stand-in that turns scenes.py's geometry calls
    (start_mesh, add_vertex / add_vertices, add_uvs, add_triangle /
    add_triangles) into an interface's element calls, one per vertex, uv
    and face, naming each face's material (mat_names: index -> name);
    coordinates go through _as_in_file."""

    def __init__(self, yi, mat_names, has_uv=False):
        self.yi, self.names, self.has_uv = yi, mat_names, has_uv
        self.open = False

    def start_mesh(self):
        self.end()
        self.open, self.nv, self.nuv, self.mat = True, 0, 0, None
        return self.yi.start_tri_mesh(has_uv=self.has_uv)

    def end(self):
        if self.open:
            self.yi.end_tri_mesh()
            self.open = False

    def add_vertex(self, m, x, y, z):
        self.yi.add_vertex(_as_in_file(x), _as_in_file(y), _as_in_file(z))
        self.nv += 1
        return self.nv - 1

    def add_vertices(self, m, xyz):
        import numpy as np
        base = self.nv
        for p in np.asarray(xyz, np.float64).reshape(-1, 3).tolist():
            self.add_vertex(m, *p)
        return base

    def add_uvs(self, m, uv):
        import numpy as np
        base = self.nuv
        for u, v in np.asarray(uv, np.float64).reshape(-1, 2).tolist():
            self.yi.add_uv(_as_in_file(u), _as_in_file(v))
            self.nuv += 1
        return base

    def add_triangle(self, m, a, b, c, mat, uv_ids=None):
        if mat != self.mat:
            self.yi.set_current_material(self.names[mat])
            self.mat = mat
        self.yi.add_triangle(int(a), int(b), int(c), uv=None if uv_ids is None
                             else tuple(int(i) for i in uv_ids))

    def add_triangles(self, m, faces, mat, uv_ids=None):
        import numpy as np
        faces = np.asarray(faces).reshape(-1, 3).tolist()
        uvs = [None] * len(faces) if uv_ids is None else \
            np.asarray(uv_ids).reshape(-1, 3).tolist()
        for f, uv in zip(faces, uvs):
            self.add_triangle(m, *f, mat, uv_ids=uv)


def _camera_params(cam, res):
    return {"type": "perspective", "from": cam["pos"], "to": cam["look"],
            "up": cam["up"], "resx": res, "resy": res,
            "focal": float(cam["focal"])}


def cornell_calls(yi, res, aa=AA_SAMPLES):
    """scenes.cornell_box(resx=res, resy=res, light_samples=LIGHT_SAMPLES)'s
    materials, geometry (scenes.cornell_geometry), area light and camera as
    an interface's calls (an XmlInterface or an interface.Interface), with
    phase 3's path tracer; returns the render parameters (AA `aa` in 1-spp
    chunks)."""
    from core_tpu_torch.scenes import (CORNELL_CAMERA, CORNELL_LIGHT,
                                       CORNELL_MATS, cornell_geometry)
    # cornell_box's MaterialDefs as the factories' parameters
    for name, color in (("white", (0.75, 0.75, 0.75)),
                        ("red", (0.63, 0.065, 0.05)),
                        ("green", (0.14, 0.45, 0.091))):
        _set_params(yi, {"type": "shinydiffusemat", "color": color})
        yi.create_material(name)
    _set_params(yi, {"type": "light_mat", "color": (1.0, 1.0, 1.0),
                     "power": 30.0})
    yi.create_material("light")
    rp = _Replay(yi, {i: n for n, i in CORNELL_MATS.items()})
    cornell_geometry(rp)
    rp.end()
    corner, point1, point2 = CORNELL_LIGHT
    _set_params(yi, {"type": "arealight", "corner": corner,
                     "point1": point1, "point2": point2,
                     "color": (1.0, 1.0, 1.0), "power": 30.0,
                     "samples": LIGHT_SAMPLES})
    yi.create_light("light")
    _set_params(yi, _camera_params(CORNELL_CAMERA, res))
    yi.create_camera("cam")
    _set_params(yi, {"type": "pathtracing", "path_samples": PATH_SAMPLES,
                     "bounces": BOUNCES, "raydepth": 2})
    yi.create_integrator("default")
    return {"AA_passes": 1, "AA_minsamples": aa, "spp_chunk": 1}


def mesh_calls(yi, res):
    """scenes.mesh_scene(resx=res, resy=res)'s textures, materials,
    geometry (its terrain grid and torus, smoothed), camera, clouds IBL
    and sun as an interface's calls, with mesh256_dl_fwd's directlight
    (raydepth 1); returns the render parameters (1 spp)."""
    from core_tpu_torch.scenes import (MESH_SCENE, MESH_ZOO, _grid_mesh,
                                       _torus_mesh, mesh_scene_lighting)
    for name, params in MESH_SCENE["textures"]:
        _set_params(yi, params)
        yi.create_texture(name)
    for name, params in MESH_SCENE["materials"]:
        _set_params(yi, params)
        yi.create_material(name)
    grid, torus = MESH_ZOO["grid"], MESH_ZOO["torus"]
    rp = _Replay(yi, {0: "terrain", 1: "torus"}, has_uv=True)
    m = rp.start_mesh()
    _grid_mesh(rp, m, grid["n"], grid["extent"], 0)
    rp.end()
    yi.smooth_mesh(m, MESH_ZOO["smooth"])
    m = rp.start_mesh()
    _torus_mesh(rp, m, torus["nu"], torus["nv"], torus["R"], torus["r"],
                torus["center"], 1)
    rp.end()
    yi.smooth_mesh(m, MESH_ZOO["smooth"])
    _set_params(yi, _camera_params(MESH_SCENE["camera"], res))
    yi.create_camera("cam")
    for kind, name, params in mesh_scene_lighting():
        _set_params(yi, params)
        getattr(yi, f"create_{kind}")(name)
    _set_params(yi, {"type": "directlighting", "raydepth": 1})
    yi.create_integrator("default")
    return {"AA_passes": 1, "AA_minsamples": 1, "spp_chunk": 1}


def write_cornell_xml(path, res, aa=AA_SAMPLES):
    """cornell_calls as a scene file at `path`; returns the path."""
    from core_tpu_torch.io.xml_writer import XmlInterface
    xi = XmlInterface()
    _set_params(xi, cornell_calls(xi, res, aa))
    xi.render(str(path))
    return Path(path)


@contextlib.contextmanager
def _cli_images():
    """A context in which every render_image call (the CLI's among them)
    appends its image to the list it yields."""
    from core_tpu_torch import render as render_mod
    orig, images = render_mod.render_image, []

    def spy(*args, **kw):
        out = orig(*args, **kw)
        images.append(out[0])
        return out

    render_mod.render_image = spy
    try:
        yield images
    finally:
        render_mod.render_image = orig


def _cli(argv):
    """cli.main(argv) in process; returns (its image, the seconds of the
    timer events it added: parse, compile, render, write)."""
    from core_tpu_torch import cli
    from core_tpu_torch.utils.timer import timer
    before = dict(timer.events())
    with _cli_images() as images:
        if cli.main(argv) != 0:
            fail(f"cli.main({argv}) did not return 0")
    if len(images) != 1:
        fail(f"cli.main rendered {len(images)} images")
    return images[0], {k: v - before.get(k, 0.0) for k, v in timer.events()}


def _per_chunk(counts, chunks, names, what):
    """Each kernel's launches a chunk from a phase's counts over `chunks`
    chunks."""
    out = {}
    for k in names:
        if counts[k] % chunks:
            fail(f"{what}: {k} launched {counts[k]} times over {chunks} "
                 "chunks, not the same number in each")
        out[k] = counts[k] // chunks
    return out


def _png_diff(got, want, what):
    """Byte-identical PNGs pass; otherwise the differing pixels and the
    largest difference are printed, and a difference over 1 LSB fails."""
    from core_tpu_torch.io.image import read_png
    if got.read_bytes() == want.read_bytes():
        return "byte-identical"
    a = (read_png(str(got)) * 255).round()
    b = (read_png(str(want)) * 255).round()
    if a.shape != b.shape:
        fail(f"{what}: PNG shapes {a.shape} and {b.shape} differ")
    diff = abs(a - b).max(axis=-1)
    n, worst = int((diff > 0).sum()), float(diff.max())
    print(f"frontend: {what}: {n} pixels differ, the largest by {worst} LSB")
    if worst > 1:
        fail(f"{what}: a pixel differs by {worst} LSB")
    return f"{n} pixels within 1 LSB"


def _frontend_cornell(per_chunk):
    """Parts (a), (b) and (d); returns the launches a chunk and the
    image."""
    import os

    import torch
    from core_tpu_torch import __version__
    from core_tpu_torch.gui import MemoryOutput
    from core_tpu_torch.interface import Interface
    from core_tpu_torch.io.badge import badge_lines, draw_badge
    from core_tpu_torch.io.image import write_png as write_png8
    from core_tpu_torch.io.xml_loader import parse_xml_scene
    from core_tpu_torch.render import render_image
    from core_tpu_torch.scenes import cornell_box
    from core_tpu_torch.utils.monitor import CallbackProgressBar
    from core_tpu_torch.utils.timer import timer
    xml = write_cornell_xml(BUILD / "frontend_cornell.xml", RES)
    # (a) the CLI in process
    out = BUILD / "frontend_cornell"
    reset_counts()
    img, ev = _cli([str(xml), str(out), "-f", "png", "-z", "-dp",
                    "--device", "cuda", "-v", "1"])
    launches = all_launches()
    want = {k: AA_SAMPLES * n for k, n in per_chunk.items()}
    want["closest_hit"] += 1                     # the z-buffer's camera hit
    if {k: launches[k] for k in want} != want or \
            sum(launches.values()) != sum(want.values()):
        fail(f"xml_cornell256_pt: launches {launches}, expected {want}")
    if plain_calls():
        fail(f"xml_cornell256_pt: the plain versions ran {plain_calls()} "
             "times")
    scene, opts = parse_xml_scene(str(xml), device="cuda")
    if opts != _cornell_opts(AA_SAMPLES):
        fail(f"xml_cornell256_pt: parsed options {opts} differ from phase "
             "3's")
    ref = render_image(scene, opts)[0]
    if not torch.equal(img, ref):
        fail("xml_cornell256_pt: the CLI's image differs from render_image "
             "of the parsed scene")
    mean = check_image(scene, img)[0]
    lines = badge_lines(__version__, opts.integrator,
                        f"AA 1;{AA_SAMPLES};1", timer.get_time("render"))
    want_png = BUILD / "frontend_cornell_want.png"
    write_png8(str(want_png), draw_badge(img.cpu().numpy(), lines))
    png = out.with_suffix(".png")
    zpng = BUILD / "frontend_cornell_zbuffer.png"
    if png.read_bytes() != want_png.read_bytes() or not zpng.is_file():
        fail("xml_cornell256_pt: the CLI's PNG differs from write_png of "
             "its image under the same badge, or no z-buffer PNG")
    moved = float((scene.geom.verts - cornell_box(
        resx=RES, resy=RES, light_samples=LIGHT_SAMPLES, device="cuda")
        .geom.verts).abs().max())
    print(f"frontend: xml_cornell256_pt {xml.relative_to(ROOT)} "
          f"({xml.stat().st_size} bytes): parse {ev['parse']:.4f} s, "
          f"compile {ev['compile']:.4f} s, render {ev['render']:.4f} s "
          f"({ev['render'] * 1e3 / AA_SAMPLES:.3f} ms/chunk), write "
          f"{ev['write']:.4f} s; launches {launches} (4 chunks and the "
          f"z-buffer), plain calls 0; image == render_image of the parsed "
          f"scene, mean {mean:.6f} (phase 3 band {MEAN_REF} +- "
          f"{MEAN_BAND:.0%}), sha256 {image_digest(img)}; "
          f"largest vertex move against cornell_box's {moved}; "
          f"{png.relative_to(ROOT)} == write_png under the badge, "
          f"{zpng.relative_to(ROOT)}")

    # (b) python -m core_tpu_torch in a subprocess
    libs = {p: p.stat().st_mtime_ns
            for p in (BUILD / "core_tpu_torch").glob("*.so")}
    sub = BUILD / "frontend_cornell_sub"
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "core_tpu_torch", str(xml), str(sub), "-f",
         "png", "-z", "--device", "cuda"], capture_output=True, text=True,
        cwd=str(ROOT), env=dict(os.environ, PYTHONPATH=str(ROOT)),
        timeout=300)
    t_sub = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"python -m core_tpu_torch exited {r.returncode}: "
             f"{r.stderr[-3000:]}")
    if {p: p.stat().st_mtime_ns
            for p in (BUILD / "core_tpu_torch").glob("*.so")} != libs:
        fail("python -m core_tpu_torch rebuilt the kernels' library")
    nobadge = BUILD / "frontend_cornell_nobadge.png"
    write_png8(str(nobadge), img.cpu().numpy())
    same = _png_diff(sub.with_suffix(".png"), nobadge, "subprocess PNG")
    zsame = _png_diff(BUILD / "frontend_cornell_sub_zbuffer.png", zpng,
                      "subprocess z-buffer PNG")
    events = [ln.split("]", 1)[-1].strip() for ln in r.stderr.splitlines()
              if re.search(r"(parse|compile|render|write) +\d", ln)]
    print(f"frontend: python -m core_tpu_torch: exit 0 in {t_sub:.3f} s, "
          f"library not rebuilt, its events {events}; PNG vs (a)'s image: "
          f"{same}; z-buffer PNG vs (a)'s: {zsame}")

    # (d) the embedding Interface, (a)'s calls
    yi = Interface(device="cuda")
    yi.setup_render(**cornell_calls(yi, RES))
    mem, flushes, ticks = MemoryOutput(RES, RES), [], []

    def output(image, pass_idx, chunk_idx):
        flushes.append(chunk_idx)
        mem(image, pass_idx, chunk_idx)

    reset_counts()
    t0 = time.perf_counter()
    got = yi.render(output=output, progress=CallbackProgressBar(
        lambda done, total, tag: ticks.append((done, total))))
    dt = time.perf_counter() - t0
    updates = len(ticks) - 1          # the last call is done()'s
    if not (len(flushes) == updates == AA_SAMPLES == ticks[-1][1]):
        fail(f"Interface: {len(flushes)} flushes, {updates} ticks, "
             f"{ticks[-1][1]} chunks")
    if not (torch.equal(torch.from_numpy(got), img.cpu())
            and (mem.image == got).all()):
        fail("Interface: the image differs from (a)'s")
    ilaunch = all_launches()
    if {k: ilaunch[k] for k in per_chunk} != \
            {k: AA_SAMPLES * n for k, n in per_chunk.items()}:
        fail(f"Interface: launches {ilaunch}")
    print(f"frontend: Interface(device='cuda') replay: {len(flushes)} "
          f"flushes, {updates} ticks, {AA_SAMPLES} chunks; image == (a)'s "
          f"and == MemoryOutput.image; launches {ilaunch}; render "
          f"{dt:.4f} s")
    return per_chunk


def _frontend_mesh(per_chunk):
    """Part (c); returns the launches a chunk."""
    import torch
    from core_tpu_torch.io.xml_loader import parse_xml_scene
    from core_tpu_torch.io.xml_writer import XmlInterface
    from core_tpu_torch.render import render_image
    xml = BUILD / "frontend_mesh.xml"
    t0 = time.perf_counter()
    xi = XmlInterface()
    _set_params(xi, mesh_calls(xi, MESH_RES))
    xi.render(str(xml))
    t_write = time.perf_counter() - t0
    reset_counts()
    img, ev = _cli([str(xml), str(BUILD / "frontend_mesh"), "-f", "png",
                    "--device", "cuda", "-v", "1"])
    launches = all_launches()
    if {k: n for k, n in launches.items() if n} != per_chunk:
        fail(f"xml_mesh256_dl: launches {launches}, expected {per_chunk}")
    if plain_calls():
        fail(f"xml_mesh256_dl: the plain versions ran {plain_calls()} times")
    scene, opts = parse_xml_scene(str(xml), device="cuda")
    if scene.geom.n_tris != MESH_TRIS:
        fail(f"xml_mesh256_dl: {scene.geom.n_tris} triangles")
    if not torch.equal(img, render_image(scene, opts)[0]):
        fail("xml_mesh256_dl: the CLI's image differs from render_image of "
             "the parsed scene")
    mem = MESH_IMAGES["mesh"][..., :3]
    rel = float((img[..., :3] - mem).abs().mean() / mem.abs().mean())
    if not rel < MESH_XML_REL:
        fail(f"xml_mesh256_dl: mean relative difference {rel} to phase 7's "
             f"image, over {MESH_XML_REL}")
    print(f"frontend: xml_mesh256_dl {xml.relative_to(ROOT)} "
          f"({xml.stat().st_size / 2**20:.3f} MiB, written in "
          f"{t_write:.3f} s): {scene.geom.n_tris} triangles, parse "
          f"{ev['parse']:.4f} s, compile {ev['compile']:.4f} s, render "
          f"{ev['render'] * 1e3:.3f} ms (1 chunk); launches {launches}, "
          f"plain calls 0; image == render_image of the parsed scene, "
          f"mean {float(img[..., :3].mean()):.6f}, mean relative "
          f"difference to phase 7's in-memory image {rel:.3e} (limit "
          f"{MESH_XML_REL})")
    return per_chunk


def phase_frontend(cornell_counts, mesh_counts):
    """Phase 23 (see the header).  cornell_counts: phase 3's launches over
    its two requests of AA_SAMPLES chunks; mesh_counts: phase 7's over
    MESH_TIMED + 1 chunks.  Returns each scene file's launches a chunk."""
    t0 = time.perf_counter()
    cornell = _frontend_cornell(_per_chunk(
        cornell_counts, 2 * AA_SAMPLES, ("closest_hit", "any_hit_nee"),
        "phase 3"))
    mesh = _frontend_mesh(_per_chunk(
        mesh_counts, MESH_TIMED + 1,
        ("cluster_closest_hit", "cluster_any_hit_nee"), "phase 7"))
    dt = time.perf_counter() - t0
    if dt > FRONTEND_LIMIT_S:
        fail(f"phase 23 took {dt:.1f} s, over {FRONTEND_LIMIT_S} s")
    names = all_launches()
    return {c: {k: per.get(k, 0) for k in names}
            for c, per in (("xml_cornell256_pt", cornell),
                           ("xml_mesh256_dl", mesh))}


# --------------------------------------------------------------------------
# phase 24: several ranks on the one card, and the BVH
# --------------------------------------------------------------------------

# cornellspec512_sppm_sharded: phase 20's cornellspec512_sppm at 2 passes
MULTI_SPPM = dict(PH_SPPM, passes=2)
MULTI_LR = 1.0
MULTI_RANKS = 2
MULTI_TIMEOUT = 600      # seconds for the two ranks together
# the BVH's image against phase 7's: the share of pixels off by more than
# BVH_TIE_ABS in a channel (coplanar and shared-edge ties between the BVH
# walk and kernel 4's sweep), and the mean absolute difference
BVH_TIE_SHARE = 0.005
BVH_TIE_ABS = 1e-2
BVH_MEAN_ABS = 1e-3


def _sharded_match(img, ref, what):
    """tests/test_sharding.py's tolerance (more than 99.5% of elements
    within rel 1e-3, mean rel below 2e-3); returns how close."""
    import torch
    if img.shape != ref.shape:
        fail(f"{what}: shape {tuple(img.shape)} != {tuple(ref.shape)}")
    if torch.equal(img, ref):
        return "identical"
    rel = (img - ref).abs() / ref.abs().clamp_min(1.0)
    share, mean = float((rel < 1e-3).float().mean()), float(rel.mean())
    if not (share > 0.995 and mean < 2e-3):
        fail(f"{what}: {share} of elements within rel 1e-3 (want > "
             f"0.995), mean rel {mean} (want < 2e-3)")
    return (f"{share:.6f} of elements within rel 1e-3, mean rel {mean:.3e},"
            f" max abs {float((img - ref).abs().max()):.3e}")


def _free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _collectives(stats):
    """{name: [calls, bytes, ms a call]} from parallel.distributed.STATS."""
    return {k: [c, b, round(sec * 1e3 / max(c, 1), 4)]
            for k, (c, b, sec) in stats.items()}


def _rank_run(name, fn, chunks, out):
    """fn() twice, the counts and time of the second: out[name] = the
    launches per chunk of every kernel, the collectives and ms a chunk;
    returns fn's result."""
    from core_tpu_torch.parallel import distributed as pd
    fn()
    reset_counts()
    pd.reset_stats()
    sync()
    t0 = time.perf_counter()
    res = fn()
    sync()
    dt = time.perf_counter() - t0
    out[name] = {"launches": {k: v // chunks if v % chunks == 0
                              else v / chunks
                              for k, v in all_launches().items()},
                 "collectives": _collectives(pd.STATS),
                 "ms": dt * 1e3 / chunks, "plain": plain_calls()}
    return res


def multi_rank(rank: int, port: int, out_dir: str):
    """One of phase 24's two gloo ranks on cuda:0 (run as python3
    chip_smoke.py --rank RANK PORT DIR): the Cornell bench configuration
    row-sharded on meshes 2x1 and 1x2, the fwd+bwd bench step on 2x1,
    cornellspec512_sppm_sharded on 2x1; writes rank{rank}.json (launches
    per chunk, step or pass, collectives, ms) and, on rank 0, the
    results."""
    import numpy as np
    import torch
    import bench_cuda as bc
    from core_tpu_torch import diff
    from core_tpu_torch.integrators.sppm import SPPMOptions
    from core_tpu_torch.parallel import distributed as pd
    from core_tpu_torch.parallel import sharding as sh
    from core_tpu_torch.scenes import cornell_box
    pd.init_distributed(f"127.0.0.1:{port}", MULTI_RANKS, rank,
                        backend="gloo", device="cuda:0")
    pd.TIMING = True
    m21 = sh.make_mesh(MULTI_RANKS)
    m12 = sh.make_mesh(MULTI_RANKS, spp_parallel=MULTI_RANKS)
    scene = cornell_box(resx=RES, resy=RES, light_samples=LIGHT_SAMPLES,
                        device="cuda")
    opts = _cornell_opts(AA_SAMPLES)
    out, res = {}, {}
    for name, mesh in (("gloo2_tiles", m21), ("gloo2_spp", m12)):
        chunks = AA_SAMPLES // mesh.shape["spp"]
        res[name] = _rank_run(name, lambda: sh.render_image_rowsharded(
            scene, opts, mesh), chunks, out)
    step = sh.make_train_step_rowsharded(scene, bc.cornell_opts(), m21,
                                         bc.SPP_PER_STEP, lr=MULTI_LR)
    params = diff.extract_params(scene, geometry=False)
    target = torch.zeros((RES, RES, 4), device="cuda")
    loss, moved = _rank_run("gloo2_train", lambda: step(params, target), 1,
                            out)
    for k in ("mat.diffuse_color", "light0.color"):
        res[f"train.{k}"] = params[k] - moved[k]
    res["train.loss"] = loss
    spec = cornell_box(resx=PH_RES, resy=PH_RES, light_samples=16,
                       block_materials=PH_BLOCKS, device="cuda")
    so = SPPMOptions(**MULTI_SPPM)
    res["gloo2_sppm"] = _rank_run(
        "gloo2_sppm", lambda: sh.render_sppm_rowsharded(spec, so, m21),
        so.passes, out)
    Path(out_dir, f"rank{rank}.json").write_text(json.dumps(out))
    if rank == 0:
        np.savez(Path(out_dir, "results.npz"),
                 **{k: v.cpu().numpy() for k, v in res.items()})
    pd.shutdown()


def _multi_nccl1(scene, opts):
    """(i): render_image_rowsharded over a one-rank NCCL group on cuda:0
    against phase 3's render_image."""
    from core_tpu_torch.parallel import distributed as pd
    from core_tpu_torch.parallel import sharding as sh
    pd.init_distributed(f"127.0.0.1:{_free_port()}", 1, 0, device="cuda:0")
    try:
        if pd.dist.get_backend() != "nccl":
            fail(f"a CUDA rank's default backend is {pd.dist.get_backend()}")
        pd.TIMING = True
        mesh = sh.make_mesh(1)
        row = {}
        img = _rank_run("nccl1", lambda: sh.render_image_rowsharded(
            scene, opts, mesh), AA_SAMPLES, row)
        pd.TIMING = False
    finally:
        pd.shutdown()
    return img, row["nccl1"]


def _multi_bvh():
    """(iv): mesh_scene through the port's native BVH build, one
    directlight chunk through the torch traversal against phase 7's image
    (kernels 4 and 6); returns the chunk's launches of every kernel (none
    may launch)."""
    import torch
    from core_tpu_torch import film as film_mod
    from core_tpu_torch import native
    from core_tpu_torch.geometry import bvh
    from core_tpu_torch.render import render_chunk, scene_material_types
    from core_tpu_torch.scenes import mesh_scene
    scene = mesh_scene(resx=MESH_RES, resy=MESH_RES, device="cuda")
    t0 = time.perf_counter()
    native.build()
    t_gxx = time.perf_counter() - t0
    t0 = time.perf_counter()
    sb = bvh.with_bvh_accel(scene)
    sync()
    t_build = time.perf_counter() - t0
    nodes = sb.accel.left.shape[0]
    reset_counts()
    sync()
    t0 = time.perf_counter()
    with torch.no_grad():
        film = render_chunk(sb, scene_material_types(sb), _big_opts(),
                            film_mod.make_film(MESH_RES, MESH_RES,
                                               device="cuda"), 0, 1, 0)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    launches = all_launches()
    if sum(launches.values()) or plain_calls():
        fail(f"the BVH chunk launched kernels {launches} or plain versions")
    img = film_mod.flush(film)
    ref = MESH_IMAGES["mesh"]
    d = (img - ref)[..., :3].abs()
    share = float((d.amax(dim=-1) > BVH_TIE_ABS).float().mean())
    mean = float(d.mean())
    print(f"multi: mesh256_dl_bvh: {scene.geom.n_tris} triangles, g++ "
          f"{t_gxx:.3f} s (0 = built), native build {t_build:.3f} s, "
          f"{nodes} nodes; one directlight chunk through the traversal "
          f"{ms:.3f} ms (no kernel); against phase 7's image: "
          f"{share:.6f} of pixels off by > {BVH_TIE_ABS}, mean abs {mean:.3e}")
    if share > BVH_TIE_SHARE or mean > BVH_MEAN_ABS \
            or not bool(torch.isfinite(img).all()):
        fail(f"mesh256_dl_bvh: {share} of pixels off by > {BVH_TIE_ABS} "
             f"(at most {BVH_TIE_SHARE}), mean abs {mean} (at most "
             f"{BVH_MEAN_ABS})")
    return launches


def phase_multi():
    """Phase 24; returns each configuration's launches of every kernel per
    chunk (per step, per pass) and rank."""
    import numpy as np
    import torch
    import bench_cuda as bc
    from core_tpu_torch import diff
    from core_tpu_torch.integrators import sppm as sppm_mod
    from core_tpu_torch.scenes import cornell_box
    multi = {}
    ref = CORNELL_IMAGE["render"]
    scene = cornell_box(resx=RES, resy=RES, light_samples=LIGHT_SAMPLES,
                        device="cuda")
    opts = _cornell_opts(AA_SAMPLES)
    img, row = _multi_nccl1(scene, opts)
    brute_only(row["launches"], "cornell256_pt_rowsharded nccl1")
    if row["plain"]:
        fail("nccl1: the plain versions ran")
    print(f"multi: cornell256_pt_rowsharded nccl1 (one NCCL rank, cuda:0): "
          f"{row['ms']:.3f} ms a chunk, launches a chunk "
          f"{row['launches']}, collectives [calls, bytes, ms a call] "
          f"{row['collectives']}; against phase 3's image: "
          f"{_sharded_match(img, ref, 'nccl1')}")
    multi["nccl1"] = row["launches"]

    # (ii) two gloo ranks on cuda:0
    torch.cuda.empty_cache()
    out = BUILD / "multi"
    out.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(MULTI_RANKS):
        log = open(out / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--rank",
             str(rank), str(port), str(out)], cwd=ROOT, stdout=log,
            stderr=subprocess.STDOUT), log))
    try:
        for p, _ in procs:
            p.wait(timeout=MULTI_TIMEOUT)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    wall = time.perf_counter() - t0
    for rank, (p, _) in enumerate(procs):
        if p.returncode != 0:
            fail(f"gloo rank {rank} exited {p.returncode}:\n"
                 + (out / f"rank{rank}.log").read_text()[-3000:])
    rows = [json.loads((out / f"rank{r}.json").read_text())
            for r in range(MULTI_RANKS)]
    with np.load(out / "results.npz") as f:
        res = {k: torch.from_numpy(f[k]).cuda() for k in f.files}
    for name in ("gloo2_tiles", "gloo2_spp"):
        msg = _sharded_match(res[name], ref, name)
        print(f"multi: cornell256_pt_rowsharded {name}: against phase 3's "
              f"image: {msg}")
    # the single-process references of the step and of SPPM
    params = diff.extract_params(scene, geometry=False)
    loss, grads = diff.value_and_grad(bc.cornell_loss(scene))(params)
    if abs(float(res["train.loss"]) - float(loss)) > 1e-3 * float(loss):
        fail(f"gloo2_train: loss {float(res['train.loss'])} against the "
             f"single process's {float(loss)}")
    worst = 0.0
    for k in ("mat.diffuse_color", "light0.color"):
        want = MULTI_LR * grads[k]
        err = (res[f"train.{k}"] - want).abs()
        if bool((err > 1e-4 + 1e-3 * want.abs()).any()):
            fail(f"gloo2_train: lr * grad of {k} off by {float(err.max())}")
        worst = max(worst, float(err.max()))
    spec = cornell_box(resx=PH_RES, resy=PH_RES, light_samples=16,
                       block_materials=PH_BLOCKS, device="cuda")
    with torch.no_grad():
        sref = sppm_mod.render_sppm(spec, sppm_mod.SPPMOptions(**MULTI_SPPM))
    smsg = _sharded_match(res["gloo2_sppm"], sref, "gloo2_sppm")
    print(f"multi: two gloo ranks on cuda:0, {wall:.3f} s of wall for both "
          f"processes (start, CUDA context, scenes, every call twice); "
          f"gloo2_train: loss {float(res['train.loss']):.6f} (single "
          f"{float(loss):.6f}), lr * grad within {worst:.3e} of the single "
          f"process's; cornellspec512_sppm_sharded ({MULTI_SPPM['passes']} "
          f"passes of {MULTI_SPPM['photons']} photons at {PH_RES}^2): {smsg}")
    units = {"gloo2_tiles": "chunk", "gloo2_spp": "chunk",
             "gloo2_train": "step", "gloo2_sppm": "pass"}
    for rank, r in enumerate(rows):
        for name, unit in units.items():
            c = r[name]
            if c["plain"]:
                fail(f"{name} rank {rank}: the plain versions ran")
            brute_only(c["launches"], f"{name} rank {rank}")
            print(f"multi: {name} rank {rank}: {c['ms']:.3f} ms a {unit}, "
                  f"launches a {unit} {c['launches']}, collectives [calls, "
                  f"bytes, ms a call] {c['collectives']}")
            multi[f"{name}_rank{rank}"] = c["launches"]
    multi["mesh256_dl_bvh"] = _multi_bvh()
    return multi


def main():
    import torch
    if len(sys.argv) == 5 and sys.argv[1] == "--rank":
        return multi_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this run needs a CUDA GPU")
    # the port must come from this checkout, not from anywhere on sys.path
    if not (ROOT / "core_tpu_torch" / "__init__.py").is_file():
        fail(f"no core_tpu_torch/ beside {Path(__file__).name}: run it from "
             "the root of a checkout")
    sys.path.insert(0, str(ROOT))
    from core_tpu_torch.scenes import cornell_box
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        print(f"phase {name}: {time.perf_counter() - t0:.3f} s")
        return out

    timed("build", phase_build)
    scene = cornell_box(resx=RES, resy=RES, light_samples=LIGHT_SAMPLES,
                        device="cuda")
    kt = timed("kernels", phase_kernels, scene)
    counts = timed("render", phase_render)
    cornell_counts = dict(counts)
    timed("slice", phase_slice)
    for name, row in timed("cornell kernels", phase_cornell_kernels,
                           scene).items():
        _merge(kt[name], row)
    fwdbwd = timed("fwdbwd", phase_fwdbwd)
    big, _ = timed("big build", phase_big_build, BIG_RES)
    kt.update(timed("big kernels", phase_big_kernels, big))
    counts.update(timed("big render", phase_big_render, big))
    del big
    torch.cuda.empty_cache()
    timed("big slice", phase_big_slice)

    from core_tpu_torch.geometry import cuda_cluster as cc
    from core_tpu_torch.geometry import cuda_intersect as ck
    mesh, _ = timed("mesh build", phase_mesh_build, MESH_RES)
    kt.update(timed("mesh kernels", phase_mesh_kernels, mesh))
    mesh_counts = timed("mesh render", phase_mesh_render, mesh, "mesh", {
        "cluster_closest_hit": cc.closest_hit_flat_cuda,
        "cluster_any_hit_nee": cc.any_hit_nee_flat_cuda}, MESH_TIMED)
    counts.update(mesh_counts)
    del mesh
    flat, _ = timed("dirac build", phase_mesh_build, MESH_RES, "dirac flat")
    brute, _ = timed("dirac build", phase_mesh_build, MESH_RES,
                     "dirac brute")
    for name, row in timed("dirac kernels", phase_dirac_kernels, flat,
                           brute).items():
        if name in kt:
            _merge(kt[name], row)
        else:
            kt[name] = row
    # each path's own launches: kernel 5 on the flat dirac path (beside
    # kernel 4), kernel 3 on the brute one (beside kernel 1)
    counts["cluster_any_hit"] = timed(
        "dirac render", phase_mesh_render, flat, "dirac flat",
        {"cluster_closest_hit": cc.closest_hit_flat_cuda,
         "cluster_any_hit": cc.any_hit_flat_cuda}, 1)["cluster_any_hit"]
    counts["any_hit"] = timed(
        "dirac render", phase_mesh_render, brute, "dirac brute",
        {"closest_hit": ck.closest_hit_cuda,
         "any_hit": ck.any_hit_cuda}, 1)["any_hit"]
    del flat, brute
    timed("mesh slice", phase_mesh_slice)
    # the chains' own launches per chunk, each configuration on its own
    spec = {name: timed(name, phase_spec, name) for name in SPEC}
    timed("spec extras", phase_spec_extras)
    # the integrator options' launches per chunk, the fold table's per step
    options = {name: timed(name, phase_option, name) for name in OPTIONS}
    folds = timed("fold table", phase_fold_table)
    golden, rows = timed("golden mesh", phase_golden)
    for name, row in rows.items():
        _merge(kt[name], row)
    zoo, rows = timed("mesh zoo", phase_zoo)
    for name, row in rows.items():
        _merge(kt[name], row)
    lightzoo, rows = timed("light zoo", phase_light_zoo)
    for name, row in rows.items():
        _merge(kt[name], row)
    photons, rows = timed("photons", phase_photons)
    for name, row in rows.items():
        _merge(kt[name], row)
    bidir, rows = timed("bidir", phase_bidir)
    for name, row in rows.items():
        _merge(kt[name], row)
    volume, rows = timed("volumes", phase_volumes)
    for name, row in rows.items():
        _merge(kt[name], row)
    frontend = timed("frontend", phase_frontend, cornell_counts, mesh_counts)
    multi = timed("multi", phase_multi)

    replaces = {     # kernels 1 to 8
        "closest_hit": ("core_tpu/geometry/pallas_intersect.py:55",
                        "core_tpu_torch/csrc/intersect.cu"),
        "any_hit_nee": ("core_tpu/geometry/pallas_intersect.py:174",
                        "core_tpu_torch/csrc/intersect.cu"),
        "any_hit": ("core_tpu/geometry/pallas_intersect.py:122",
                    "core_tpu_torch/csrc/intersect.cu"),
        "cluster_closest_hit": ("core_tpu/geometry/cluster_intersect.py:204",
                                "core_tpu_torch/csrc/cluster.cu"),
        "cluster_any_hit": ("core_tpu/geometry/cluster_intersect.py:279",
                            "core_tpu_torch/csrc/cluster.cu"),
        "cluster_any_hit_nee": ("core_tpu/geometry/cluster_intersect.py:342",
                                "core_tpu_torch/csrc/cluster.cu"),
        "grouped_closest_hit": ("core_tpu/geometry/cluster_intersect.py:912",
                                "core_tpu_torch/csrc/cluster.cu"),
        "grouped_any_hit": ("core_tpu/geometry/cluster_intersect.py:1129",
                            "core_tpu_torch/csrc/cluster.cu")}
    # fwdbwd_launches: the kernel's launches in one Cornell fwd+bwd step;
    # chain_launches / option_launches / golden_launches / zoo_launches /
    # lightzoo_launches: its launches per chunk of each chain / option /
    # golden-mesh / mesh-zoo / light-zoo configuration; photon_launches:
    # per request of each photon golden, per chunk of cornellspec512_pm,
    # per pass of cornellspec512_sppm, per light-zoo shoot; bidir_launches:
    # per bd64_golden request, per chunk of cornell256_bd, lightzoo256_bd
    # and cornell256_sss_dl / _pt, per SSS map build; volume_launches:
    # per vol128_golden request and per chunk of each phase-22
    # configuration; frontend_launches: per chunk of each phase-23 scene
    # file; multi_launches: per chunk of phase 24's one-rank NCCL render,
    # per rank and chunk (step, pass) of each two-rank gloo configuration,
    # and per chunk of the BVH (none: its traversal is plain PyTorch);
    # fold_launches: per step of each fold table row
    table = [{"name": name, "route": "cuda", "source": src,
              "replaces": rep, "launches": counts[name], **kt[name],
              "fwdbwd_launches": fwdbwd[name],
              "chain_launches": {c: spec[c][name] for c in spec},
              "option_launches": {c: options[c][name] for c in options},
              "fold_launches": {r: folds[r][name] for r in folds},
              "golden_launches": {c: golden[c][name] for c in golden},
              "zoo_launches": {c: zoo[c][name] for c in zoo},
              "lightzoo_launches": {c: lightzoo[c][name] for c in lightzoo},
              "photon_launches": {c: photons[c][name] for c in photons},
              "bidir_launches": {c: bidir[c][name] for c in bidir},
              "volume_launches": {c: volume[c][name] for c in volume},
              "frontend_launches": {c: frontend[c][name] for c in frontend},
              "multi_launches": {c: multi[c][name] for c in multi}}
             for name, (rep, src) in replaces.items()]
    print(json.dumps({"kernels": table}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
