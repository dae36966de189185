"""Render orchestration: sample chunks and film accumulation
(counterpart of core_tpu/render.py).

Every pixel of the image gets its samples generated and traced in one
wavefront per chunk.  Pixel-sample QMC matches the reference's renderTile
(integrator.cc:269-306):
  sampling_offs = fnv(i * fnv(j))
  single-pass:   dx = (0.5+s)/n, dy = RI_LP(s + offs)

Scope: one AA pass (aa_passes == 1), the path tracer and the directlight
integrator, the full-raster chunk; other integrators, adaptive passes and
row blocks raise NotImplementedError.

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
from core_tpu_torch.film import Film, FilterType
from core_tpu_torch.integrators import direct as direct_mod
from core_tpu_torch.integrators import path as path_mod
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.sampling import qmc

# integrator name -> (integrate function, its options type)
_INTEGRATORS = {"pathtracing": (path_mod.integrate, PathOptions),
                "directlight": (direct_mod.integrate, DirectOptions)}
_BLOCK = 32   # pixel-block edge of cluster-scene camera wavefronts


@dataclass(frozen=True)
class RenderOptions:
    """Same fields as core_tpu's RenderOptions where ported.  The path
    tracer, the port's first integrator, stays the default here."""
    aa_passes: int = 1
    aa_samples: int = 1
    filter_type: FilterType = FilterType.BOX
    filter_size: float = 1.5
    gamma: float = 1.0
    clamp_rgb: bool = False
    premult: bool = False         # premultiply alpha at flush (reference)
    spp_chunk: int = 4            # samples per wavefront (memory bound)
    integrator: str = "pathtracing"
    integrator_opts: PathOptions | DirectOptions = field(
        default_factory=PathOptions)


def _check_supported(opts: RenderOptions):
    if opts.integrator not in _INTEGRATORS:
        raise NotImplementedError(f"integrator {opts.integrator!r} is not "
                                  "ported to core_tpu_torch yet")
    want = _INTEGRATORS[opts.integrator][1]
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


def render_chunk(scene, types_present, opts: RenderOptions, film: Film,
                 pass_offs: int, spp: int, sample0: int) -> Film:
    """Trace spp samples for every pixel and splat them into film."""
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

    px = x.to(torch.float32) + dx
    py = y.to(torch.float32) + dy
    rays, wt = shoot_ray(cam, px, py)
    integrate = _INTEGRATORS[opts.integrator][0]
    rgba = integrate(scene, types_present, rays, pixel_sample, sampling_offs,
                     opts.integrator_opts)
    rgba = rgba * wt[..., None]
    if blocked:
        dx, dy, rgba, wt = (_unblock_to_raster(a, spp, h, w)
                            for a in (dx, dy, rgba, wt))
    filterw = film_mod.effective_filterw(opts.filter_size, opts.filter_type)
    return film_mod.add_samples_grid(film, dx, dy, rgba, spp,
                                     filterw=filterw, ftype=opts.filter_type,
                                     sample_mask=wt > 0.0,
                                     clamp_rgb=opts.clamp_rgb)


def scene_material_types(scene) -> tuple:
    """Static tuple of material families the dispatcher evaluates."""
    from core_tpu_torch.materials.base import MatType
    return tuple(t for t in scene.mat_types
                 if t not in (int(MatType.BLEND), int(MatType.MASK)))


def render_image(scene, opts: RenderOptions):
    """Full render; returns (image [H,W,4], Film).  Forward only: runs under
    torch.no_grad()."""
    _check_supported(opts)
    types_present = scene_material_types(scene)
    cam = scene.camera
    with torch.no_grad():
        film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
        done = 0
        while done < opts.aa_samples:
            spp = min(opts.spp_chunk, opts.aa_samples - done)
            film = render_chunk(scene, types_present, opts, film, 0, spp,
                                done)
            done += spp
        img = film_mod.flush(film, gamma=opts.gamma, clamp=opts.clamp_rgb,
                             premult=opts.premult)
    return img, film
