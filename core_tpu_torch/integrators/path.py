"""Unidirectional path tracer, wavefront form
(counterpart of core_tpu/integrators/path.py).

Reference: src/integrators/pathtracer.cc:134-333 — per camera hit:
emission + MIS direct lighting, then `path_samples` independent paths of up
to `bounces` vertices; each bounce does next-event estimation with one
Halton-chosen light and adds emission only on caustic (specular/glossy/
filter) bounces; the background contributes on a primary miss and on a
miss after a caustic bounce.  All `path_samples` paths are batched into one
(path_samples x N)-lane SoA wavefront, so each bounce costs one BSDF
sample, one closest-hit launch and one batched NEE.  QMC dimensions match
the reference: path sample i uses
  offs = n_paths * pixel_sample + sampling_offs + i
  first bounce: s1 = RI_vdC(offs), s2 = scrHalton(2, offs)
  depth d >= 1: s1 = scrHalton(4d+3, offs), s2 = scrHalton(4d+4, offs).

Camera-visible specular and glossy chains go through the same stochastic
recursiveRaytrace as the direct integrator (raytrace.py); each chain hit
gets emission on specular branches, MIS direct light and its own batched
indirect paths (PathOptions.chain_path_samples).

Every NEE takes transp_shad / shadow_depth (transparent shadows), but the
direct light at chain hits, which core_tpu estimates with opaque shadows
(its path.py:404-406); the chain hits' own paths take them.  Wavefront
folding (fold_interval, fold_start, fold_sort) halves the path wavefront
at the bounces core_tpu folds at, with its pairing pick (_fold).  The
ambient-occlusion fields are carried and ignored, as core_tpu's path
tracer ignores them.  caustic_type "photon" or "both" adds a caustic
photon map's radiance at the camera hits' diffuse vertices
(pathtracer.cc:171 estimateCausticPhotons; the map comes from
render.integrator_preprocess as aux["caustic"]); "path" or "both" lets
the paths pick up emission and the background after caustic bounces.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.backgrounds import eval_background_s
from core_tpu_torch.differentials import texture_lod
from core_tpu_torch.integrators import common, raytrace
from core_tpu_torch.lights import base as light_base
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import (RaysS, luminance3, map_lanes, rays_to_soa,
                                tile1, tile3, untile_sum3, where3, zeros3)


@dataclass(frozen=True)
class PathOptions:
    """core_tpu's PathOptions (core_tpu/integrators/path.py:41-93) but its
    SSS fields."""
    path_samples: int = 32        # reference "path_samples" (nPaths)
    bounces: int = 5              # reference "bounces" (maxBounces)
    raydepth: int = 5             # specular recursion depth
    no_recursive: bool = False
    caustic_type: str = "path"    # none|path|photon|both
    # photon caustics (pathtracer.cc:374-383): a caustic photon map built
    # at preprocess, mixed in at the camera hits' diffuse vertices
    c_photons: int = 500000       # reference "photons"
    caustic_radius: float = 0.25  # reference "caustic_radius"
    caustic_depth: int = 10       # reference "caustic_depth"
    transp_shad: bool = False     # reference transpShad
    shadow_depth: int = 5         # reference shadowDepth
    transp_background: bool = False
    # ambient occlusion: carried and ignored, as core_tpu's path tracer
    # ignores it
    use_ao: bool = False
    ao_samples: int = 32
    ao_dist: float = 1.0
    ao_color: tuple = (1.0, 1.0, 1.0)
    # indirect paths at camera-visible specular/glossy chain vertices (the
    # reference re-enters integrate() behind mirrors and glass,
    # mcintegrator.cc:421-628 -> pathtracer.cc:134): 0 = path_samples,
    # -1 = none (chain vertices get emission and direct light only)
    chain_path_samples: int = 0
    # wavefront folding: every fold_interval bounces (from depth
    # max(fold_interval, fold_start)) the path wavefront is halved by
    # pairing lane i with lane i + N/2 and keeping one of the two: the
    # live one, or a QMC pick with its throughput doubled when both live
    # (unbiased).  0 = off.  fold_sort first stable-sorts the lanes by
    # aliveness, so dead lanes pair with live ones first.
    fold_interval: int = 0
    fold_start: int = 0
    fold_sort: bool = True


CAUSTIC_TYPES = ("none", "path", "photon", "both")


def _check_supported(opts: PathOptions):
    if opts.caustic_type not in CAUSTIC_TYPES:
        raise ValueError(f"caustic_type {opts.caustic_type!r} is not one of "
                         f"{CAUSTIC_TYPES}")


def _nee_lanes(scene) -> int:
    """Shadow-ray lanes per shading point of one NEE estimate: both MIS
    sides of each area-like light's samples, one ray per dirac light
    (core_tpu's count, path.py:256-261)."""
    return 2 * sum(1 if light_base.dirac(li)
                   else max(1, light_base.n_samples(li))
                   for li in scene.lights)


def _count(stats, n_lanes: int, useful_mask, per_lane: int = 1):
    """Add n_lanes traced lane-rays and the useful ones (those whose path
    was alive at the launch) to stats; `useful` stays a device tensor, so
    counting reads nothing back to the host."""
    stats["traced"] += per_lane * n_lanes
    stats["useful"] = stats["useful"] \
        + per_lane * useful_mask.sum(dtype=torch.float32)


def _fold_due(opts: PathOptions, depth: int, width: int) -> bool:
    """core_tpu's fold trigger (path.py:135-138)."""
    return (opts.fold_interval > 0 and depth > 0 and depth >= opts.fold_start
            and depth % opts.fold_interval == 0 and width % 2 == 0
            and width >= 256)


def _fold(state, active, offs, depth: int, sort: bool):
    """One wavefront fold (core_tpu path.py:139-237).  state: a tuple of
    per-lane records (V3, SPS, MatParamsS or tensors).  With `sort`, every
    lane is first gathered into a stable order by aliveness (live lanes
    first).  Then lane i of the first half pairs with lane i of the
    second: pick_a takes the first where it lives and the second is dead
    or scr_halton(41 + depth, offs_a + offs_b) < 0.5.  w2 is 2 where both
    lived, else 1: the caller doubles the survivor's throughput by it.
    Returns (state, active, offs, pick_a, w2, sort_idx or None)."""
    sort_idx = None
    if sort:
        sort_idx = torch.sort((~active).to(torch.int32), stable=True).indices
        state, active, offs = map_lanes(
            lambda t: t.index_select(0, sort_idx), (state, active, offs))
    h = offs.shape[0] // 2
    alive_a, alive_b = active[:h], active[h:]
    r_pick = qmc.scr_halton(41 + depth, (offs[:h] + offs[h:]) & qmc.MASK32)
    pick_a = alive_a & (~alive_b | (r_pick < 0.5))
    w2 = torch.where(alive_a & alive_b, 2.0, 1.0)
    state, offs = map_lanes(lambda t: torch.where(pick_a, t[:h], t[h:]),
                            (state, offs))
    return state, alive_a | alive_b, offs, pick_a, w2, sort_idx


def _unfold(path_col, pick_a, frozen, sort_idx):
    """Undo one fold: each survivor's later radiance goes back to its own
    lane of the wider wavefront (the other lane of its pair gets 0), in
    the order before the sort, on top of the radiance frozen at the fold
    (core_tpu path.py:287-299)."""
    def up(c):
        c = torch.cat([torch.where(pick_a, c, 0.0),
                       torch.where(pick_a, 0.0, c)])
        if sort_idx is not None:
            c = torch.zeros_like(c).index_copy(0, sort_idx, c)
        return c
    return frozen + map_lanes(up, path_col)


def _paths_batched(scene, types_present, sp0, p0, wo0, active0, n_paths,
                   pixel_sample, sampling_offs, opts: PathOptions,
                   stats=None):
    """All indirect paths as one (n_paths*N)-lane wavefront; returns V3 [N]
    (already averaged over n_paths).  Lane layout matches vec.tile*: path i
    occupies lanes [i*N, (i+1)*N).

    stats: optional dict accumulating {"traced", "useful"} lane-ray counts
    of the closest-hit and NEE shadow lanes (useful = lanes whose path was
    still alive at the launch), as core_tpu's _paths_batched does; a
    folded wavefront counts at its own width."""
    trace_caustics = opts.caustic_type in ("path", "both")
    base = (n_paths * pixel_sample + sampling_offs) & qmc.MASK32
    offs = ((torch.arange(n_paths, dtype=torch.int64,
                          device=base.device)[:, None]
             + base[None, :]) & qmc.MASK32).reshape(-1)

    sp, p = map_lanes(lambda t: tile1(t, n_paths), (sp0, p0))
    wo = tile3(wo0, n_paths)
    active = tile1(active0, n_paths)
    pixel_sample_b = tile1(pixel_sample, n_paths)
    sampling_offs_b = tile1(sampling_offs, n_paths)

    path_col = zeros3(offs)
    throughput = None
    folds = []      # (pick_a, path_col frozen at the fold, sort_idx)
    for depth in range(opts.bounces):
        if _fold_due(opts, depth, offs.shape[0]):
            state = (sp, p, wo, pixel_sample_b, sampling_offs_b, throughput)
            state, active, offs, pick_a, w2, sort_idx = _fold(
                state, active, offs, depth, opts.fold_sort)
            sp, p, wo, pixel_sample_b, sampling_offs_b, throughput = state
            throughput = throughput * w2
            folds.append((pick_a, path_col, sort_idx))
            path_col = zeros3(offs)
        if depth == 0:
            s1 = qmc.ri_vdc(offs)
            s2 = qmc.scr_halton(2, offs)
            flags = BSDF.DIFFUSE | BSDF.REFLECT | BSDF.TRANSMIT
        else:
            d4 = 4 * depth
            s1 = qmc.scr_halton(d4 + 3, offs)
            s2 = qmc.scr_halton(d4 + 4, offs)
            flags = BSDF.ALL
        sres = detach_sample(
            dispatch.sample_bsdf_s(types_present, p, sp, wo, s1, s2, flags))
        scol = sres.col * sres.w
        if depth == 0:
            throughput = scol
            active = active & (sres.pdf > 0.0)
            caustic_mask = torch.zeros_like(active)
        else:
            alive = active & (luminance3(scol) > 0.0)
            throughput = throughput * scol
            caustic_mask = (sres.flags & (BSDF.SPECULAR | BSDF.GLOSSY
                                          | BSDF.FILTER)) != 0
            if not trace_caustics:
                caustic_mask = torch.zeros_like(alive)
            active = alive

        rays = RaysS(o=sp.p, d=sres.wi,
                     tmin=torch.full_like(s1, MIN_RAYDIST),
                     tmax=torch.full_like(s1, -1.0))
        if stats is not None:
            _count(stats, offs.shape[0], active)
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=sp.prim)
        # an escape after a caustic bounce sees the background
        # (core_tpu/integrators/path.py:243-246)
        if depth > 0 and scene.background is not None:
            bg = eval_background_s(scene.background, sres.wi)
            path_col = path_col + where3(active & ~hits.valid & caustic_mask,
                                         throughput * bg, 0.0)
        active = active & hits.valid

        sp = scene_mod.surface_points_s(scene, rays, hits)
        p = scene_mod.material_params_s(
            scene, sp, pick_seed=(offs + 31 * (depth + 1)) & qmc.MASK32)
        wo = -sres.wi
        has_diffuse = (p.flags & BSDF.DIFFUSE) != 0
        nee_active = active & has_diffuse if depth > 0 else active
        if stats is not None:
            _count(stats, offs.shape[0], nee_active, _nee_lanes(scene))
        lcol = common.estimate_one_direct_s(scene, types_present, p, sp, wo,
                                            offs, pixel_sample_b,
                                            sampling_offs_b, nee_active,
                                            opts.transp_shad,
                                            opts.shadow_depth)
        # Emission pickup at path vertices (pathtracer.cc:240,295): only
        # through caustic chains onto SPECULAR|EMIT materials (see core_tpu)
        if depth > 0:
            emit_c = dispatch.emit_ss(types_present, p)
            emit_mask = ((p.flags & BSDF.EMIT) != 0) & caustic_mask \
                & ((p.flags & BSDF.SPECULAR) != 0)
            lcol = lcol + where3(emit_mask, emit_c, 0.0)
        path_col = path_col + where3(active, lcol * throughput, 0.0)

    for pick_a, frozen, sort_idx in reversed(folds):
        path_col = _unfold(path_col, pick_a, frozen, sort_idx)
    return untile_sum3(path_col, n_paths) * (1.0 / float(n_paths))


def integrate(scene, types_present, rays, pixel_sample, sampling_offs,
              opts: PathOptions, aux=None, stats=None, diff=None):
    """Path-tracer integrate() for a camera wavefront -> rgba [N, 4].

    rays: types.Rays ([N, 3] o, d); pixel_sample, sampling_offs: [N] int64
    tensors holding uint32 values.  stats: optional dict accumulating
    "traced" (an int) and "useful" (a float32 tensor) lane-ray counts of the
    camera rays and the camera hits' paths, the camera rays all useful
    (core_tpu/integrators/path.py:305-316); as in core_tpu, the chains'
    rays are not counted there, but each chain depth's live lanes are
    (raytrace.recursive_raytrace's "chain_live").  diff: optional (dxd,
    dyd) neighbour directions of the camera rays, whose footprint selects
    image-texture mip levels at the camera hits (core_tpu path.py:
    320-326).  aux: render.integrator_preprocess's caustic photon map
    ({"caustic": PhotonMap}) under caustic_type "photon" or "both"."""
    _check_supported(opts)
    rs = rays_to_soa(rays)
    n = rs.tmin.shape[0]
    if stats is not None:
        stats["traced"] = stats.get("traced", 0) + n
        stats["useful"] = stats.get("useful", 0.0) + n
    hits = scene_mod.closest_hit_s(scene, rs)
    primary_valid = hits.valid

    sp = scene_mod.surface_points_s(scene, rs, hits)
    lod = None if diff is None else texture_lod(scene, sp, rs, *diff)
    p = scene_mod.material_params_s(
        scene, sp, pick_seed=(9781 * pixel_sample + sampling_offs)
        & qmc.MASK32, lod=lod)
    wo = -rs.d

    col = where3(primary_valid, dispatch.emit_ss(types_present, p), 0.0)
    nee0 = primary_valid & ((p.flags & BSDF.DIFFUSE) != 0)
    if stats is not None:
        _count(stats, n, nee0, _nee_lanes(scene))
    col = col + common.estimate_all_direct_s(scene, types_present, p, sp, wo,
                                             pixel_sample, sampling_offs,
                                             nee0, opts.transp_shad,
                                             opts.shadow_depth)
    # photon-mapped caustics at the camera hits (pathtracer.cc:171)
    if aux is not None and "caustic" in aux \
            and opts.caustic_type in ("photon", "both"):
        from core_tpu_torch.integrators.photonmap import _caustic_radiance
        col = col + where3(nee0, _caustic_radiance(
            aux["caustic"], p, sp, wo, types_present, opts.caustic_radius),
            0.0)
    n_paths = max(1, opts.path_samples)
    col = col + _paths_batched(scene, types_present, sp, p, wo, nee0,
                               n_paths, pixel_sample, sampling_offs, opts,
                               stats=stats)

    col = where3(primary_valid, col,
                 eval_background_s(scene.background, rs.d))
    alpha = torch.where(primary_valid, 1.0,
                        0.0 if opts.transp_background else 1.0)

    chain = (scene.has_specular or raytrace.has_glossy(types_present)) \
        and opts.raydepth > 0 and not opts.no_recursive
    if chain:
        col = col + raytrace.recursive_raytrace(
            scene, types_present, rs, hits, sp, p,
            _chain_shade_fn(scene, types_present, pixel_sample,
                            sampling_offs, opts),
            pixel_sample, sampling_offs, opts.raydepth, stats=stats)
    return torch.stack([col.x, col.y, col.z, alpha], dim=-1)


def _chain_shade_fn(scene, types_present, pixel_sample, sampling_offs,
                    opts: PathOptions):
    """The shading of chain hits (core_tpu/integrators/path.py:376-425):
    emission on specular branches only, MIS direct light with opaque
    shadows (core_tpu passes no transp_shad there, :404-406), and the
    hit's own batched indirect paths under the full options, chain depth d
    on the QMC stream sampling_offs + 7919 * (d + 1).  Blends pick with
    seed 0 there."""
    n_chain = opts.chain_path_samples
    if n_chain == 0:
        n_chain = max(1, opts.path_samples)
    depth = [0]

    def shade_fn(nrays, nhits, include_lights, active):
        nsp = scene_mod.surface_points_s(scene, nrays, nhits)
        np_ = scene_mod.material_params_s(scene, nsp)
        nwo = -nrays.d
        scol = where3(((np_.flags & BSDF.EMIT) != 0) & include_lights,
                      dispatch.emit_ss(types_present, np_), 0.0)
        live = active & ((np_.flags & BSDF.DIFFUSE) != 0)
        scol = scol + common.estimate_all_direct_s(
            scene, types_present, np_, nsp, nwo, pixel_sample,
            sampling_offs, live)
        if n_chain > 0 and opts.bounces > 0:
            depth[0] += 1
            scol = scol + _paths_batched(
                scene, types_present, nsp, np_, nwo, live, n_chain,
                pixel_sample, (sampling_offs + 7919 * depth[0])
                & qmc.MASK32, opts)
        return scol, nsp, np_

    return shade_fn
