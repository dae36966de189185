"""Render orchestration: passes, sample chunks and film accumulation
(counterpart of core_tpu/render.py).

Every pixel of the image gets its samples generated and traced in one
wavefront per chunk.  Pixel-sample QMC matches the reference's renderTile
(integrator.cc:269-306):
  sampling_offs = fnv(i * fnv(j))
  multi-pass AA: dx = RI_vdC(s, offs), dy = RI_S(s, offs)
  single pass:   dx = (0.5+s)/n, dy = RI_LP(s + offs)
  lens (u, v):   RI_3 / RI_5 of (pass_offs + offs + s + 1)
with s the pixel sample, pass_offs + the chunk's sample index.

Scope: render_image's whole pass loop: the first pass of aa_samples, then
aa_passes - 1 adaptive passes of aa_inc_samples that resample only the
pixels film.next_pass_flags flags (the rest are masked out of the splat),
pass_offs advancing by the samples taken; checkpoints (checkpoint.py)
after every pass, resumed when the file exists; on_flush after every
chunk; show_sam_pix paints the flagged pixels red.  The path tracer (with
its photon caustics and subsurface scattering), the directlight,
photonmapping, bidirectional and debug integrators on the full-raster
chunk, and SPPM's own pass loop.  integrator_preprocess builds the photon
maps and the SSS map once per render_image, and precompute_attenuation the
single-scatter attenuation grids; render_chunk hands them on as `aux` and
`vol_aux`.  The bidirectional integrator's t=1 splats go to the film's
light image (film.add_density_samples).  render_zbuffer is the primary
hits' depth image.  A progress bar (`progress=`) ticks once per chunk.
render_chunk also renders a row block into an offset film (y0, rows,
splat_y0), which parallel/sharding.py's row-sharded films use.

Volumes (core_tpu render.py:260-286): with VolumeOptions(integrator="sky")
every chunk traces its camera rays once more (scene.closest_hit_s) and the
surface colour is attenuated by the atmosphere and gains its in-scatter;
a scene with volume regions does the same with the regions' transmittance
and the emission or single-scatter march (integrators/volume.py).

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
from core_tpu_torch import scene as scene_mod
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
from core_tpu_torch.integrators import volume as vol_mod
from core_tpu_torch.integrators.bidir import BidirOptions
from core_tpu_torch.integrators.debug import DebugOptions
from core_tpu_torch.integrators.direct import DirectOptions
from core_tpu_torch.integrators.path import PathOptions
from core_tpu_torch.integrators.photonmap import PhotonOptions
from core_tpu_torch.integrators.sppm import SPPMOptions
from core_tpu_torch.integrators.volume import VolumeOptions
from core_tpu_torch.sampling import qmc
from core_tpu_torch.textures.base import TexType
from core_tpu_torch.vec import rays_to_soa

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
    """core_tpu's RenderOptions, field by field, with its defaults
    (directlight is the default integrator)."""
    aa_passes: int = 1
    aa_samples: int = 1
    aa_inc_samples: int = 1
    aa_threshold: float = 0.05
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
    volume_opts: VolumeOptions = field(default_factory=VolumeOptions)
    z_channel: bool = False       # a z channel is wanted (render_zbuffer)
    # debug: paint the pixels flagged for adaptive resampling red
    # (the reference's show_sam_pix)
    show_sam_pix: bool = False


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
    vol_mod.check_supported(opts.volume_opts)


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
                 density_y0: int | None = None, resample_mask=None,
                 vol_aux=None, y0: int = 0, rows: int | None = None,
                 splat_y0: int = 0) -> Film:
    """Trace spp samples for every pixel and splat them into film.  aux:
    integrator_preprocess's photon or SSS maps, when the integrator takes
    them; vol_aux: volume.precompute_attenuation's grids.  resample_mask:
    [H, W] bool over the whole image, the pixels an adaptive pass
    resamples (None: all).

    Row blocks (core_tpu render.py:182-200, for parallel/sharding.py): y0
    and rows restrict the camera rays to the image rows [y0, y0 + rows)
    (rows=None: to the bottom of the image), and the film covers the image
    rows [splat_y0, splat_y0 + film height); 0 = the whole image.  QMC
    streams key off global pixel coordinates, so a block's samples are
    exactly the single-image samples of its pixels.  The bidirectional
    integrator's light-image splats land in the film's density plane,
    whose first row is image row density_y0 (None: splat_y0)."""
    _check_supported(opts)
    cam = scene.camera
    h, w = cam.resy, cam.resx
    rows = h - y0 if rows is None else rows
    blocked = scene_mod.accel_kind(scene.accel) in ("flat", "grouped") \
        and rows % _BLOCK == 0 and w % _BLOCK == 0
    grid = _pixel_grid_blocked if blocked else _pixel_grid_raster
    x, y, s = grid(rows, w, spp, scene.device)
    if y0:
        y = y + y0
    s = s + sample0
    sampling_offs = qmc.fnv32a((y * qmc.fnv32a(x)) & qmc.MASK32)
    pixel_sample = (pass_offs + s) & qmc.MASK32

    n_total = opts.aa_samples  # for single-pass stratification
    if opts.aa_passes > 1:
        dx = qmc.ri_vdc(pixel_sample, sampling_offs)
        dy = qmc.ri_s(pixel_sample, sampling_offs)
    elif n_total > 1:
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
            d_y0 = splat_y0 if density_y0 is None else density_y0
            film = film_mod.add_density_samples(film, sx, sy - d_y0,
                                                scol, n_paths,
                                                sample_mask=smask)
    rgba = _apply_volumes(scene, opts.volume_opts, rays, rgba, pixel_sample,
                          sampling_offs, vol_aux)
    rgba = rgba * wt[..., None]
    if blocked:
        dx, dy, rgba, wt = (_unblock_to_raster(a, spp, rows, w)
                            for a in (dx, dy, rgba, wt))
    mask = wt > 0.0
    if resample_mask is not None:
        mask = mask & resample_mask[y0:y0 + rows].reshape(1, rows * w) \
            .expand(spp, -1).reshape(-1)
    filterw = film_mod.effective_filterw(opts.filter_size, opts.filter_type)
    return film_mod.add_samples_grid(film, dx, dy, rgba, spp,
                                     filterw=filterw, ftype=opts.filter_type,
                                     sample_mask=mask,
                                     clamp_rgb=opts.clamp_rgb,
                                     row0=y0 - splat_y0)


def _apply_volumes(scene, vopts: VolumeOptions, rays, rgba, pixel_sample,
                   sampling_offs, vol_aux):
    """rgb * transmittance + in-scatter along the camera rays (core_tpu
    render.py:260-286; the reference's renderTile applies the volume
    integrator so, integrator.cc:308-312): the sky's atmosphere under
    VolumeOptions(integrator="sky"), else the scene's volume regions when
    it has any.  Either traces the camera rays once more for the surface
    distance.  Returns rgba unchanged otherwise."""
    sky = vopts.integrator == "sky"
    if not sky and not scene.volumes:
        return rgba
    rs = rays_to_soa(rays)
    vhits = scene_mod.closest_hit_s(scene, rs)
    capped = rs._replace(tmax=torch.where(vhits.valid, vhits.t, rs.tmax))
    if sky:
        tr = vol_mod.sky_transmittance(capped, vopts)
        ins = vol_mod.sky_integrate(scene, rs, vhits.t, vopts)
    else:
        tr = vol_mod.transmittance(scene, capped, vopts.steps)
        ins = vol_mod.integrate(scene, rs, vhits.t, pixel_sample,
                                sampling_offs, vopts, vol_aux=vol_aux)
    rgb = [rgba[:, k] * tr[k] + ins[k] for k in range(3)]
    return torch.cat([torch.stack(rgb, dim=-1), rgba[:, 3:]], dim=-1)


def _has_image_textures(scene) -> bool:
    return scene.textures is not None and any(
        d.ttype == TexType.IMAGE for d in scene.textures.defs)


def scene_material_types(scene) -> tuple:
    """Static tuple of material families the dispatcher evaluates."""
    from core_tpu_torch.materials.base import MatType
    return tuple(t for t in scene.mat_types
                 if t not in (int(MatType.BLEND), int(MatType.MASK)))


def render_image(scene, opts: RenderOptions, verbose: bool = False,
                 progress=None, checkpoint_path: str | None = None,
                 on_flush=None):
    """Full multi-pass render; returns (image [H,W,4], Film).  Forward
    only: runs under torch.no_grad().  SPPM runs its own pass loop and
    folds the result into a unit-weight film, so flush treats it as any
    other (core_tpu render.py:357-370).

    checkpoint_path: the film and the pass counters are saved after every
    pass, and an existing checkpoint (of this package or of core_tpu) is
    resumed from; the QMC streams are a function of the stored offsets, so
    the resumed render equals an uninterrupted one.  on_flush(img, pass_idx,
    chunk_idx): called with the flushed film as a numpy [H,W,4] after every
    chunk (the reference's imageFilm_t::finishArea output hook).
    progress (a utils.monitor.ProgressBar): init(the request's chunks),
    update(1) after every chunk, done() at the end, as core_tpu ticks it
    (render.py:386-429); SPPM's pass loop does not tick it, as in
    core_tpu."""
    _check_supported(opts, chunked=False)
    from core_tpu_torch import checkpoint as ck
    types_present = scene_material_types(scene)
    cam = scene.camera
    with torch.no_grad():
        if opts.integrator == "SPPM":
            rgba = sppm_mod.render_sppm(scene, opts.integrator_opts,
                                        verbose=verbose,
                                        checkpoint_path=checkpoint_path)
            film = Film(rgba=rgba, weight=torch.ones_like(rgba[..., 0]))
            return film_mod.flush(film, gamma=opts.gamma,
                                  clamp=opts.clamp_rgb,
                                  premult=opts.premult), film
        aux = integrator_preprocess(scene, types_present, opts)
        vol_aux = vol_mod.precompute_attenuation(scene, opts.volume_opts)
        film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
        start_pass, offs = 0, 0
        if checkpoint_path:
            saved = ck.load_checkpoint(checkpoint_path, device=scene.device)
            if saved is not None:
                film, start_pass, offs, _ = saved
                if verbose:
                    print(f"resumed checkpoint at pass {start_pass}")
        if progress is not None:
            progress.init(sum(-(-n // opts.spp_chunk) for n in (
                [opts.aa_samples]
                + [opts.aa_inc_samples] * (opts.aa_passes - 1))))

        def run_pass(film, pass_offs, n_samples, resample_mask, pass_idx):
            done, chunk_idx = 0, 0
            while done < n_samples:
                spp = min(opts.spp_chunk, n_samples - done)
                film = render_chunk(scene, types_present, opts, film,
                                    pass_offs, spp, done, aux,
                                    resample_mask=resample_mask,
                                    vol_aux=vol_aux)
                done += spp
                chunk_idx += 1
                if progress is not None:
                    progress.update(1)
                if on_flush is not None:
                    on_flush(film_mod.flush(
                        film, gamma=opts.gamma,
                        clamp=opts.clamp_rgb).cpu().numpy(),
                        pass_idx, chunk_idx)
            return film

        if start_pass == 0:
            film = run_pass(film, 0, opts.aa_samples, None, 0)
            offs = opts.aa_samples
            if checkpoint_path:
                ck.save_checkpoint(checkpoint_path, film, 1, offs)
        for p in range(max(1, start_pass), opts.aa_passes):
            flags = film_mod.next_pass_flags(film, opts.aa_threshold)
            if verbose:
                print(f"pass {p + 1}/{opts.aa_passes}: resampling "
                      f"{int(flags.sum())} pixels")
            film = run_pass(film, offs, opts.aa_inc_samples, flags, p)
            offs += opts.aa_inc_samples
            if checkpoint_path:
                ck.save_checkpoint(checkpoint_path, film, p + 1, offs)
        if progress is not None:
            progress.done()
        img = film_mod.flush(film, gamma=opts.gamma, clamp=opts.clamp_rgb,
                             premult=opts.premult)
        if opts.show_sam_pix and opts.aa_passes > 1:
            flags = film_mod.next_pass_flags(film, opts.aa_threshold)
            red = torch.tensor([1.0, 0.0, 0.0, 1.0], device=img.device)
            img = torch.where(flags[..., None], red, img)
    return img, film


def render_zbuffer(scene, normalize: bool = True):
    """The primary hits' depth image [H,W] (the reference's z-channel,
    core_tpu render.py:442-461): t of each pixel centre's camera ray, inf
    where it misses; normalize maps the hit depths to 1 (nearest) .. 0
    (farthest) like precalcDepths (integrator.cc:99), misses to 0."""
    cam = scene.camera
    h, w = cam.resy, cam.resx
    with torch.no_grad():
        x, y, _ = _pixel_grid_raster(h, w, 1, scene.device)
        rays, _ = shoot_ray(cam, x.to(torch.float32) + 0.5,
                            y.to(torch.float32) + 0.5)
        hits = scene_mod.closest_hit_s(scene, rays_to_soa(rays))
        z = torch.where(hits.valid, hits.t, torch.inf).reshape(h, w)
        if not normalize:
            return z
        finite = torch.isfinite(z)
        zmin = torch.where(finite, z, torch.inf).min()
        zmax = torch.where(finite, z, -torch.inf).max()
        zn = 1.0 - ((z - zmin) / (zmax - zmin).clamp_min(1e-9)).clamp(0.0,
                                                                     1.0)
        return torch.where(finite, zn, 0.0)
