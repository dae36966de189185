"""Rendering and training over several devices (counterpart of
core_tpu/parallel/sharding.py).

The reference parallelises over image tiles pulled from a work queue by
pthreads (renderWorker_t / imageSpliter_t, src/yafraycore/integrator.cc:
45-227).  Here one process per device runs the same program (SPMD) over a
("tiles", "spp") mesh of ranks (parallel/distributed.py): every rank traces
its block of pixel rows x its share of the samples per pixel, and every
function returns the replicated result (image, or loss and parameters) on
every rank.  QMC streams key off global pixel coordinates, so a sharded
render takes exactly the single-device samples.

Two film layouts, as in core_tpu:
- render_chunk_sharded / render_sharded / make_train_step: each rank splats
  into a full-frame film and the films are summed over all ranks, once a
  chunk (h % n_tiles == 0);
- the row-sharded film (render_rowsharded, render_image_rowsharded,
  make_train_step_rowsharded): each rank keeps only its row block plus the
  filter's halo rows, so memory and traffic per rank are O(H*W / n_tiles).
  The collectives are one sum over the "spp" ranks, one halo exchange
  along the tiles ring (an all_gather of the edge rows), and one all_gather
  of the owned rows at flush.  Ragged heights pad the last blocks (which
  trace only their image rows) and crop at flush.  The bidirectional
  integrator's light image lands anywhere, so its rank film carries a full-
  height density plane summed over the tiles.

Gradients: the collectives are autograd functions whose backward is the
forward's transpose (a sum's is a sum, the halo sends go back the way they
came); a value replicated on every rank (the loss) seeds 1/n_ranks of its
cotangent on each, and the parameter gradients are summed over all ranks,
so every rank ends with the single-process gradient.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from core_tpu_torch import film as film_mod
from core_tpu_torch.diff import apply_params
from core_tpu_torch.film import Film
from core_tpu_torch.parallel import distributed as pd
from core_tpu_torch.parallel.distributed import Mesh
from core_tpu_torch.render import (RenderOptions, integrator_preprocess,
                                   render_chunk, scene_material_types)
from core_tpu_torch.vec import zeros3


def make_mesh(n_devices: int | None = None, spp_parallel: int = 1) -> Mesh:
    """Mesh over ("tiles", "spp") of the n_devices ranks of the process
    group (core_tpu's make_mesh slices one process's local devices; here a
    device is a rank).  spp_parallel ranks share each tile and split its
    samples per pixel."""
    if not pd.dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a group of ranks, one per device: start them "
            "with the CLI's --devices N, or call "
            "parallel.distributed.init_distributed() in each")
    world = pd.dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh({n}) in a group of {world} ranks: a "
                         "mesh spans every rank")
    return pd.global_mesh(spp_parallel)


def _check(scene, mesh: Mesh, spp: int | None = None):
    if scene.device != mesh.device:
        raise ValueError(f"the scene lives on {scene.device}, this rank "
                         f"renders on {mesh.device}")
    if spp is not None and spp % mesh.shape["spp"]:
        raise ValueError(f"spp {spp} not divisible by "
                         f"{mesh.shape['spp']} spp shards")


def _pack(film: Film, sl=slice(None), density: bool = True):
    """[rows, W, 5 or 8]: rgba, weight (and density) of the film's rows
    sl."""
    parts = [film.rgba[sl], film.weight[sl][..., None]]
    if density:
        parts.append(film.density[sl])
    return torch.cat(parts, dim=-1)


def _unpack(a, n_density) -> Film:
    return Film(rgba=a[..., :4], weight=a[..., 4], density=a[..., 5:8],
                n_density=n_density)


def _film_sum(film: Film, group) -> Film:
    """The film summed over a group: one all_reduce of every field."""
    parts = [film.rgba, film.weight, film.density, film.n_density]
    flat = pd.sum_over(torch.cat([p.reshape(-1) for p in parts]), group)
    out, o = [], 0
    for p in parts:
        out.append(flat[o:o + p.numel()].reshape(p.shape))
        o += p.numel()
    return Film(*out)


def render_chunk_sharded(scene, types_present, opts: RenderOptions,
                         film: Film, mesh: Mesh, pass_offs: int, spp: int,
                         sample0: int) -> Film:
    """One sharded chunk: every rank renders its (row block, spp block)
    into a full-frame film and the films are summed over all ranks."""
    h, w = scene.camera.resy, scene.camera.resx
    _check(scene, mesh, spp)
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    if h % n_tiles:
        raise ValueError(f"image height {h} not divisible by {n_tiles} "
                         "tile shards")
    rows, spp_local = h // n_tiles, spp // n_spp
    local = film_mod.make_film(h, w, device=scene.device)
    local = render_chunk(scene, types_present, opts, local, pass_offs,
                         spp_local, sample0 + mesh.spp_index * spp_local,
                         y0=mesh.tile * rows, rows=rows)
    contrib = _film_sum(local, mesh.world)
    return Film(*[a + b for a, b in zip(film, contrib)])


def render_sharded(scene, opts: RenderOptions, mesh: Mesh, spp: int):
    """A sharded single-pass render -> normalised image [H, W, 4]."""
    cam = scene.camera
    with torch.no_grad():
        film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
        film = render_chunk_sharded(scene, scene_material_types(scene), opts,
                                    film, mesh, 0, spp, 0)
        return film_mod.normalized(film)


# --------------------------------------------------------------------------
# the row-sharded film
# --------------------------------------------------------------------------

def _halo_rows(opts: RenderOptions) -> int:
    """Filter footprint overflow outside a row block, in whole rows."""
    fw = film_mod.effective_filterw(opts.filter_size, opts.filter_type)
    return max(1, int(np.ceil(fw - 0.5 + 1e-6)))


def _layout(h: int, mesh: Mesh, opts: RenderOptions):
    """(rows a block, halo rows)."""
    n_tiles = mesh.shape["tiles"]
    rows, halo = -(-h // n_tiles), _halo_rows(opts)
    if n_tiles > 1 and rows < halo:
        raise ValueError(f"{n_tiles} row blocks of {rows} rows are thinner "
                         f"than the filter's {halo} halo rows")
    return rows, halo


def _rowshard_worker(scene, types_present, opts, mesh: Mesh, spp: int,
                     pass_offs: int, sample0: int, h: int, w: int,
                     rows: int, halo: int, aux=None, vol_aux=None,
                     resample_mask=None, film0: Film | None = None) -> Film:
    """This rank's part of one pass: its rows into a local film of rows +
    2 halo rows, summed over the spp ranks, halos exchanged along the
    tiles.  Returns the rank's owned block ([rows, W]; for the
    bidirectional integrator its rows of the summed full-height light
    image and the global path count).

    aux / vol_aux: the replicated photon maps / attenuation grids;
    resample_mask: the [H, W] adaptive flags; film0: the rank's owned
    block from earlier passes, seeded on one spp rank only (and the path
    count on one rank only), since the films are summed."""
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    ti, si = mesh.tile, mesh.spp_index
    spp_local = spp // n_spp
    y0 = ti * rows
    mine = min(rows, h - y0)   # a padded last block traces only image rows
    bidir = opts.integrator == "bidirectional"
    dev = scene.device
    local = film_mod.make_film(rows + 2 * halo, w, device=dev)
    if bidir:
        local = local._replace(density=torch.zeros(
            (rows * n_tiles, w, 3), dtype=torch.float32, device=dev))
    if film0 is not None:
        own0 = film0 if si == 0 else Film(*map(torch.zeros_like, film0))
        rgba, weight, dens = (a.clone() for a in local[:3])
        rgba[halo:halo + rows] = own0.rgba
        weight[halo:halo + rows] = own0.weight
        if bidir:
            dens[y0:y0 + rows] = own0.density
            nd = own0.n_density if ti == 0 else torch.zeros_like(
                own0.n_density)
        else:
            dens[halo:halo + rows] = own0.density
            nd = own0.n_density
        local = Film(rgba, weight, dens, nd)
    done = 0
    while done < spp_local and mine > 0:
        chunk = min(opts.spp_chunk, spp_local - done)
        local = render_chunk(scene, types_present, opts, local, pass_offs,
                             chunk, sample0 + si * spp_local + done, aux,
                             density_y0=0 if bidir else None,
                             resample_mask=resample_mask, vol_aux=vol_aux,
                             y0=y0, rows=mine, splat_y0=y0 - halo)
        done += chunk
    if n_spp > 1:
        local = _film_sum(local, mesh.spp)
    own = _pack(local, slice(halo, halo + rows), density=False)
    n_density = local.n_density
    if bidir:
        # the light image lands anywhere: sum the full-height plane and the
        # path count over the tiles, keep this block's rows
        dens = pd.sum_over(torch.cat([local.density.reshape(-1),
                                      local.n_density.reshape(1)]),
                           mesh.tiles)
        n_density = dens[-1]
        dens = dens[:-1].reshape(rows * n_tiles, w, 3)[y0:y0 + rows]
    else:
        dens = local.density[halo:halo + rows]
    if n_tiles > 1:
        # my top halo rows belong to the end of tile ti-1's block, my
        # bottom ones to the start of tile ti+1's (the light image needs
        # none: it is summed whole above, and zero elsewhere)
        from_next, from_prev = pd.halo_exchange(
            _pack(local, slice(None, halo), density=False),
            _pack(local, slice(halo + rows, None), density=False), mesh)
        own = own + F.pad(from_next, (0, 0, 0, 0, rows - halo, 0)) \
            + F.pad(from_prev, (0, 0, 0, 0, 0, rows - halo))
    return _unpack(torch.cat([own, dens], dim=-1), n_density)


def _flush_own(own: Film, h: int, w: int, opts: RenderOptions):
    """The owned block's image [rows, W, 4] (film.flush: the light image
    merged scaled by the whole frame's pixels over the path count, clamp,
    gamma, premult)."""
    img = film_mod.normalized(own)
    rgb = img[..., :3] + own.density * ((w * h)
                                        / own.n_density.clamp_min(1.0))
    if opts.clamp_rgb:
        rgb = rgb.clamp(0.0, 1.0)
    if abs(opts.gamma - 1.0) > 1e-3:
        rgb = torch.pow(rgb.clamp_min(0.0), 1.0 / opts.gamma)
    if opts.premult:
        rgb = rgb * img[..., 3:4]
    return torch.cat([rgb, img[..., 3:]], dim=-1)


def _gather_rows(block, mesh: Mesh, h: int):
    """The tiles' [rows, ...] blocks stacked in tile order, cropped to h."""
    g = pd.all_gather(block, mesh.tiles)
    return g.reshape((-1,) + tuple(block.shape[1:]))[:h]


def render_rowsharded(scene, opts: RenderOptions, mesh: Mesh, spp: int,
                      pass_offs: int = 0, sample0: int = 0, aux=None,
                      vol_aux=None):
    """Row-sharded single-pass render -> image [H, W, 4] on every rank.
    aux / vol_aux: photon maps / attenuation grids built once
    (integrator_preprocess), used by every rank."""
    _check(scene, mesh, spp)
    h, w = scene.camera.resy, scene.camera.resx
    rows, halo = _layout(h, mesh, opts)
    with torch.no_grad():
        own = _rowshard_worker(scene, scene_material_types(scene), opts,
                               mesh, spp, pass_offs, sample0, h, w, rows,
                               halo, aux=aux, vol_aux=vol_aux)
        return _gather_rows(_flush_own(own, h, w, opts), mesh, h)


def render_image_rowsharded(scene, opts: RenderOptions, mesh: Mesh,
                            verbose: bool = False):
    """The whole multi-pass render over the mesh -> image [H, W, 4] on
    every rank: the integrator's preprocess, pass 1 of aa_samples, then
    each adaptive pass resampling the pixels flagged from the gathered film
    (the reference runs its whole adaptive loop under its tile threads,
    integrator.cc:132-227).  SPPM runs its own sharded pass loop."""
    from core_tpu_torch.integrators import volume as vol_mod
    if opts.integrator == "SPPM":
        return render_sppm_rowsharded(scene, opts.integrator_opts, mesh,
                                      opts, verbose=verbose)
    _check(scene, mesh, opts.aa_samples)
    if opts.aa_passes > 1:
        _check(scene, mesh, opts.aa_inc_samples)
    types_present = scene_material_types(scene)
    h, w = scene.camera.resy, scene.camera.resx
    rows, halo = _layout(h, mesh, opts)
    with torch.no_grad():
        # every rank builds the photon maps and attenuation grids itself,
        # from the same seeds and the same deterministic sorts and sums,
        # so they are equal on every rank without a broadcast
        aux = integrator_preprocess(scene, types_present, opts)
        vol_aux = vol_mod.precompute_attenuation(scene, opts.volume_opts)

        def run_pass(film0, flags, pass_offs, spp):
            return _rowshard_worker(scene, types_present, opts, mesh, spp,
                                    pass_offs, 0, h, w, rows, halo, aux=aux,
                                    vol_aux=vol_aux, resample_mask=flags,
                                    film0=film0)

        own = run_pass(None, None, 0, opts.aa_samples)
        offs = opts.aa_samples
        for p in range(1, opts.aa_passes):
            full = _gather_rows(_pack(own, density=False), mesh, h)
            flags = film_mod.next_pass_flags(
                Film(rgba=full[..., :4], weight=full[..., 4]),
                opts.aa_threshold)
            if verbose and mesh.tile == 0 and mesh.spp_index == 0:
                print(f"pass {p + 1}/{opts.aa_passes}: resampling "
                      f"{int(flags.sum())} pixels")
            own = run_pass(own, flags, offs, opts.aa_inc_samples)
            offs += opts.aa_inc_samples
        return _gather_rows(_flush_own(own, h, w, opts), mesh, h)


def render_sppm_rowsharded(scene, sppm_opts, mesh: Mesh,
                           render_opts: RenderOptions | None = None,
                           verbose: bool = False):
    """Row-sharded SPPM: each tile owns the hit points of its rows, and
    each pass's photons are split over the tiles (sppm.shoot_sharded: one
    all_gather of the deposits a pass, merged in shard order, so the
    population equals the single-device one element for element).  Returns
    the image [H, W, 4] on every rank, clamped and gamma-corrected by
    render_opts when given."""
    from core_tpu_torch.integrators import sppm as sppm_mod
    from core_tpu_torch.integrators.photonmap import (scene_bound,
                                                      world_sphere)
    cam = scene.camera
    h, w = cam.resy, cam.resx
    n_tiles = mesh.shape["tiles"]
    if h % n_tiles:
        raise ValueError(f"SPPM row sharding needs height {h} divisible by "
                         f"{n_tiles} tiles")
    _check(scene, mesh)
    rows = h // n_tiles
    types_present = scene_material_types(scene)
    bmin, bmax = scene_bound(scene)
    center, world_r = world_sphere(scene, bmin, bmax)
    r0 = float(sppm_opts.search_radius)
    with torch.no_grad():
        zero = torch.zeros(rows * w, dtype=torch.float32,
                           device=scene.device)
        state = sppm_mod.HitPoints(
            r2=torch.full_like(zero, r0 * r0), acc_n=zero,
            tau=zeros3(zero), direct=zeros3(zero))
        for k in range(sppm_opts.passes):
            state = sppm_mod.one_pass_block(
                scene, types_present, state, k, mesh.tile * rows, rows, w,
                sppm_opts, cam, center, world_r, bmin, bmax, r0,
                photon_shard=(mesh.tile, n_tiles),
                photon_axis=lambda t: pd.all_gather(t, mesh.tiles))
            if verbose and mesh.tile == 0 and mesh.spp_index == 0:
                print(f"sharded SPPM pass {k + 1}/{sppm_opts.passes}")
        rgba = _gather_rows(sppm_mod.finalize_sppm(
            state, sppm_opts.passes, sppm_opts.photons).reshape(rows, w, 4),
            mesh, h)
    if render_opts is not None:
        rgb = rgba[..., :3]
        if render_opts.clamp_rgb:
            rgb = rgb.clamp(0.0, 1.0)
        if abs(render_opts.gamma - 1.0) > 1e-3:
            rgb = torch.pow(rgb.clamp_min(0.0), 1.0 / render_opts.gamma)
        rgba = torch.cat([rgb, rgba[..., 3:]], dim=-1)
    return rgba


# --------------------------------------------------------------------------
# train steps
# --------------------------------------------------------------------------

def _step(loss_fn, mesh: Mesh, lr: float):
    """step(params, target) -> (loss, params - lr * grad) on every rank:
    the replicated loss seeds 1/n_ranks of its cotangent on each rank and
    the gradients are summed over all ranks (one all_reduce)."""

    def step(params, target):
        leaves = {k: v.detach().clone().requires_grad_()
                  for k, v in params.items()}
        with torch.enable_grad():
            loss = loss_fn(leaves, target)
            gs = torch.autograd.grad(
                loss, list(leaves.values()),
                grad_outputs=torch.full_like(
                    loss, 1.0 / pd.dist.get_world_size()),
                allow_unused=True)
        gs = [torch.zeros_like(v) if g is None else g
              for v, g in zip(leaves.values(), gs)]
        flat = pd.all_reduce(torch.cat([g.reshape(-1) for g in gs]),
                             mesh.world)
        new, o = {}, 0
        for (k, v), g in zip(params.items(), gs):
            new[k] = v - lr * flat[o:o + g.numel()].reshape(g.shape)
            o += g.numel()
        return loss.detach(), new

    return step


def make_train_step_rowsharded(scene, opts: RenderOptions, mesh: Mesh,
                               spp: int, lr: float = 0.1):
    """Inverse-rendering step over a row-sharded film: each rank reduces
    the loss over its own rows and the partial losses are summed, so no
    rank holds the whole image.  As in core_tpu the sum over all ranks is
    divided by n_spp, since every spp rank of a tile holds the same summed
    rows.  Returns step(params, target [H, W, 4]) -> (loss, new params)."""
    _check(scene, mesh, spp)
    types_present = scene_material_types(scene)
    h, w = scene.camera.resy, scene.camera.resx
    rows, halo = _layout(h, mesh, opts)
    n_tiles, n_spp = mesh.shape["tiles"], mesh.shape["spp"]
    if (n_tiles - 1) * rows >= h:
        # a rank with no rows would take no part in the backward's
        # collectives
        raise ValueError(f"{n_tiles} row blocks of {rows} rows leave the "
                         f"last one empty at height {h}")
    y0 = mesh.tile * rows
    mine = min(rows, h - y0)

    def loss_fn(params, target):
        own = _rowshard_worker(apply_params(scene, params), types_present,
                               opts, mesh, spp, 0, 0, h, w, rows, halo)
        d = film_mod.normalized(own)[:mine, :, :3] \
            - target[y0:y0 + mine, :, :3]
        sq = (d * d).sum() / (h * w * 3)
        return pd.sum_over(sq, mesh.world) / n_spp

    return _step(loss_fn, mesh, lr)


def make_train_step(scene, opts: RenderOptions, mesh: Mesh, spp: int,
                    lr: float = 0.1):
    """Inverse-rendering step over full-frame films summed every chunk
    (render_chunk_sharded): loss = mean squared RGB error against target.
    Returns step(params, target) -> (loss, new params)."""
    _check(scene, mesh, spp)
    types_present = scene_material_types(scene)
    cam = scene.camera

    def loss_fn(params, target):
        film = film_mod.make_film(cam.resy, cam.resx, device=scene.device)
        film = render_chunk_sharded(apply_params(scene, params),
                                    types_present, opts, film, mesh, 0, spp,
                                    0)
        d = film_mod.normalized(film)[..., :3] - target[..., :3]
        return torch.mean(d * d)

    return _step(loss_fn, mesh, lr)


def train_step_sharded(scene, opts: RenderOptions, mesh: Mesh, spp: int,
                       params, target, lr: float = 0.1):
    """One-shot convenience wrapper around make_train_step."""
    return make_train_step(scene, opts, mesh, spp, lr)(params, target)

