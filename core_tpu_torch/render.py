"""Render orchestration: sample chunks and film accumulation
(counterpart of core_tpu/render.py).

Every pixel of the image gets its samples generated and traced in one
wavefront per chunk.  Pixel-sample QMC matches the reference's renderTile
(integrator.cc:269-306):
  sampling_offs = fnv(i * fnv(j))
  single-pass:   dx = (0.5+s)/n, dy = RI_LP(s + offs)
  lens (u, v):   RI_3 / RI_5 of (pass_offs + offs + s + 1)

Scope: one AA pass (aa_passes == 1); the path tracer (with its photon
caustics and subsurface scattering), the directlight, photonmapping,
bidirectional and debug integrators on the full-raster chunk, and SPPM's
own pass loop; other integrators, adaptive passes and row blocks raise
NotImplementedError.  integrator_preprocess builds the photon maps and the
SSS map once per render_image and render_chunk hands them to the integrator
as `aux`.  The bidirectional integrator's t=1 splats go to the film's light
image (film.add_density_samples).

Cluster scenes, flat and grouped, trace their camera wavefront in 32x32
pixel blocks (_pixel_grid_blocked, as core_tpu's render.py:201 does for
every cluster scene), so neighbouring lanes are neighbouring pixels and the
cluster kernels' warps walk the same clusters; the permutation is undone
before the film splat.  QMC streams key off (x, y, s) only, so the image is
the same in either order.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from core_tpu_torch import film as film_mod
from core_tpu_torch.cameras import shoot_ray
from core_tpu_torch.differentials import camera_diff_dirs
from core_tpu_torch.film import Film, FilterType
from core_tpu_torch.integrators import bidir as bidir_mod
from core_tpu_torch.integrators import debug as debug_mod
from core_tpu_torch.integrators import direct as direct_mod
from core_tpu_torch.integrators import path as path_mod
from core_tpu_torch.integrators import photonmap as pm_mod
from core_tpu_torch.integrators import sppm as sppm_mod
from core_tpu_torch.integrators import sss as sss_mod
from core_tpu_torch.integrators.bidir import BidirOptions
from core_tpu_torch.integrators.debug import DebugOptions
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.integrators.photonmap import PhotonOptions
from core_tpu_torch.integrators.sppm import SPPMOptions
from core_tpu_torch.sampling import qmc
from core_tpu_torch.textures.base import TexType

# integrator name -> (integrate function, its options type)
_INTEGRATORS = {"pathtracing": (path_mod.integrate, PathOptions),
                "directlight": (direct_mod.integrate, DirectOptions),
                "photonmapping": (pm_mod.integrate, PhotonOptions),
                "bidirectional": (bidir_mod.integrate, BidirOptions),
                "debug": (debug_mod.integrate, DebugOptions)}
# the integrators whose camera hits take primary-ray differentials
_DIFF_INTEGRATORS = ("directlight", "pathtracing", "photonmapping")
_BLOCK = 32   # pixel-block edge of cluster-scene camera wavefronts


@dataclass(frozen=True)
class RenderOptions:
    """Same fields and defaults as core_tpu's RenderOptions where ported
    (directlight is the default integrator)."""
    aa_passes: int = 1
    aa_samples: int = 1
    filter_type: FilterType = FilterType.BOX
    filter_size: float = 1.5
    gamma: float = 1.0
    clamp_rgb: bool = False
    premult: bool = False         # premultiply alpha at flush (reference)
    spp_chunk: int = 4            # samples per wavefront (memory bound)
    integrator: str = "directlight"
    integrator_opts: PathOptions | DirectOptions | PhotonOptions \
        | SPPMOptions | BidirOptions | DebugOptions = field(
            default_factory=DirectOptions)


def _check_supported(opts: RenderOptions, chunked: bool = True):
    """chunked: the chunk loop's integrators; SPPM owns its pass loop and
    renders only through render_image (chunked=False)."""
    if opts.integrator == "SPPM" and chunked:
        raise ValueError("SPPM replaces the chunked render loop (its own "
                         "progressive pass loop, sppm.cc:62-109); use "
                         "render_image")
    if opts.integrator not in _INTEGRATORS and opts.integrator != "SPPM":
        raise NotImplementedError(f"integrator {opts.integrator!r} is not "
                                  "ported to core_tpu_torch yet")
    want = SPPMOptions if opts.integrator == "SPPM" else \
        _INTEGRATORS[opts.integrator][1]
    if not isinstance(opts.integrator_opts, want):
        raise TypeError(f"integrator {opts.integrator!r} takes "
                        f"{want.__name__}, got "
                        f"{type(opts.integrator_opts).__name__}")
    if opts.aa_passes != 1:
        raise NotImplementedError("adaptive AA passes (aa_passes > 1) are "
                                  "not ported to core_tpu_torch yet")


def _pixel_grid_raster(h, w, spp, device):
    """(s, y, x)-ordered full-raster grid for the dense film splat."""
    ss, ys, xs = torch.meshgrid(
        torch.arange(spp, dtype=torch.int64, device=device),
        torch.arange(h, dtype=torch.int64, device=device),
        torch.arange(w, dtype=torch.int64, device=device), indexing="ij")
    return xs.reshape(-1), ys.reshape(-1), ss.reshape(-1)


def _pixel_grid_blocked(h, w, spp, device, B=_BLOCK):
    """(s, yblock, xblock, iy, ix)-ordered grid; needs h % B == w % B == 0."""
    ss, ybs, xbs, iys, ixs = torch.meshgrid(
        *[torch.arange(k, dtype=torch.int64, device=device)
          for k in (spp, h // B, w // B, B, B)], indexing="ij")
    return ((xbs * B + ixs).reshape(-1), (ybs * B + iys).reshape(-1),
            ss.reshape(-1))


def _unblock_to_raster(a, spp, h, w, B=_BLOCK):
    """Blocked-order [spp*h*w, ...] -> raster (s, y, x) order."""
    rest = tuple(a.shape[1:])
    a = a.reshape((spp, h // B, w // B, B, B) + rest).movedim(3, 2)
    return a.reshape((spp * h * w,) + rest)


def integrator_preprocess(scene, types_present, opts: RenderOptions):
    """The pre-render hook (the reference's surfaceIntegrator_t::preprocess
    from scene_t::update), as core_tpu's render.py:141-176 runs it:
    photonmapping's maps; the path tracer's {"caustic": photon map} under
    caustic_type "photon" or "both" (pathtracer.cc:90-93) and {"sss": SSS
    map} under use_sss (pathtracer.cc:94-101); directlight's SSS map under
    use_sss; else None."""
    io = opts.integrator_opts
    if opts.integrator == "photonmapping":
        return pm_mod.preprocess(scene, types_present, io)
    if opts.integrator == "pathtracing":
        aux = {}
        if io.caustic_type in ("photon", "both"):
            popts = PhotonOptions(photons=1, c_photons=io.c_photons,
                                  bounces=io.caustic_depth,
                                  caustic_radius=io.caustic_radius,
                                  use_diffuse=False, use_caustics=True)
            aux.update(pm_mod.preprocess(scene, types_present, popts) or {})
        if io.use_sss:
            aux["sss"] = sss_mod.build_sss_map(
                scene, types_present, n_photons=io.sss_photons,
                interior_steps=io.sss_steps)
        return aux or None
    if opts.integrator == "directlight" and io.use_sss:
        return sss_mod.build_sss_map(scene, types_present,
                                     n_photons=io.sss_photons,
                                     interior_steps=io.sss_steps)
    return None


def render_chunk(scene, types_present, opts: RenderOptions, film: Film,
                 pass_offs: int, spp: int, sample0: int, aux=None,
                 density_y0: int = 0) -> Film:
    """Trace spp samples for every pixel and splat them into film.  aux:
    integrator_preprocess's photon or SSS maps, when the integrator takes
    them.  The bidirectional integrator's light-image splats land in the
    film's density plane shifted up by density_y0 rows (core_tpu
    render.py:285-301; 0 for a full-image film)."""
    _check_supported(opts)
    cam = scene.camera
    h, w = cam.resy, cam.resx
    blocked = scene.accel is not None and h % _BLOCK == 0 \
        and w % _BLOCK == 0
    grid = _pixel_grid_blocked if blocked else _pixel_grid_raster
    x, y, s = grid(h, w, spp, scene.device)
    s = s + sample0
    sampling_offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    pixel_sample = (pass_offs + s) & qmc.MASK32

    n_total = opts.aa_samples  # for single-pass stratification
    if n_total > 1:
        dx = (0.5 + s.to(torch.float32)) / n_total
        dy = qmc.ri_lp((s + sampling_offs) & qmc.MASK32)
    else:
        dx = torch.full(x.shape, 0.5, dtype=torch.float32, device=x.device)
        dy = torch.full(x.shape, 0.5, dtype=torch.float32, device=x.device)

    # the thin lens's streams (core_tpu render.py:226-233); only a lens
    # camera reads them
    lens_u = lens_v = None
    if cam.aperture != 0.0:
        lens_offs = (pass_offs + sampling_offs + s + 1) & qmc.MASK32
        lens_u = qmc.radical_inverse(3, lens_offs)
        lens_v = qmc.radical_inverse(5, lens_offs)

    px = x.to(torch.float32) + dx
    py = y.to(torch.float32) + dy
    rays, wt = shoot_ray(cam, px, py, lens_u, lens_v)
    integrate = _INTEGRATORS[opts.integrator][0]
    # primary-ray differentials (diffRay_t, integrator.cc:299-304): the
    # +1-pixel neighbour directions drive image-texture mip filtering; as
    # in core_tpu, only a scene with an image texture computes them
    diff_kw = {"diff": camera_diff_dirs(cam, px, py, lens_u, lens_v)} \
        if opts.integrator in _DIFF_INTEGRATORS \
        and _has_image_textures(scene) else {}
    if aux is not None:
        diff_kw["aux"] = aux
    rgba = integrate(scene, types_present, rays, pixel_sample, sampling_offs,
                     opts.integrator_opts, **diff_kw)
    if opts.integrator == "bidirectional":
        rgba, splat = rgba
        if splat is not None:
            # t=1 splats land anywhere in the image (core_tpu
            # render.py:285-301)
            sx, sy, scol, smask, n_paths = splat
            film = film_mod.add_density_samples(film, sx, sy - density_y0,
                                                scol, n_paths,
                                                sample_mask=smask)
    rgba = rgba * wt[..., None]
    if blocked:
        dx, dy, rgba, wt = (_unblock_to_raster(a, spp, h, w)
                            for a in (dx, dy, rgba, wt))
    filterw = film_mod.effective_filterw(opts.filter_size, opts.filter_type)
    return film_mod.add_samples_grid(film, dx, dy, rgba, spp,
                                     filterw=filterw, ftype=opts.filter_type,
                                     sample_mask=wt > 0.0,
                                     clamp_rgb=opts.clamp_rgb)


def _has_image_textures(scene) -> bool:
    return scene.textures is not None and any(
        d.ttype == TexType.IMAGE for d in scene.textures.defs)


def scene_material_types(scene) -> tuple:
    """Static tuple of material families the dispatcher evaluates."""
    from core_tpu_torch.materials.base import MatType
    return tuple(t for t in scene.mat_types
                 if t not in (int(MatType.BLEND), int(MatType.MASK)))


def render_image(scene, opts: RenderOptions, checkpoint_path=None):
    """Full render; returns (image [H,W,4], Film).  Forward only: runs under
    torch.no_grad().  SPPM runs its own pass loop and folds the result into
    a unit-weight film, so flush treats it as any other (core_tpu
    render.py:357-370).  checkpoint_path (checkpoints) is not ported and
    raises NotImplementedError."""
    _check_supported(opts, chunked=False)
    if checkpoint_path:
        raise NotImplementedError("render checkpoints (checkpoint_path) are "
                                  "not ported to core_tpu_torch yet")
    types_present = scene_material_types(scene)
    cam = scene.camera
    with torch.no_grad():
        if opts.integrator == "SPPM":
            rgba = sppm_mod.render_sppm(scene, opts.integrator_opts)
            film = Film(rgba=rgba, weight=torch.ones_like(rgba[..., 0]))
            return film_mod.flush(film, gamma=opts.gamma,
                                  clamp=opts.clamp_rgb,
                                  premult=opts.premult), film
        aux = integrator_preprocess(scene, types_present, opts)
        film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
        done = 0
        while done < opts.aa_samples:
            spp = min(opts.spp_chunk, opts.aa_samples - done)
            film = render_chunk(scene, types_present, opts, film, 0, spp,
                                done, aux)
            done += spp
        img = film_mod.flush(film, gamma=opts.gamma, clamp=opts.clamp_rgb,
                             premult=opts.premult)
    return img, film
