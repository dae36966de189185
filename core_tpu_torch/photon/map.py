"""Photon map: wavefront shooting, uniform-grid storage and radius gathers
(counterpart of core_tpu/photon/map.py).

Reference: the photon loops of mcIntegrator_t::createCausticMap
(src/yafraycore/mcintegrator.cc:197-383) and photonIntegrator_t::preprocess
(src/integrators/photonintegr.cc:126-640).  As in core_tpu, the photons are
binned into a uniform grid of cells the size of the gather radius and
sorted by cell id (one stable sort: within a cell, photons stay in emission
order), and a gather scans the 27 neighbour cells with a cap of
MAX_PER_CELL photons a cell, weighting each inspected photon by k/m (k
photons in the cell, m inspected).  Density estimation uses the
reference's `ckernel` (include/utilities/sample_utils.h:180).

The gathers read every candidate of a chunk of queries at once: the 27
cells x MAX_PER_CELL slots of each query are one [n, 864] gather of the
map's cell-sorted rows (position, direction, power, validity), summed over
the candidate axis, in chunks of GATHER_CANDIDATES candidates.  core_tpu
adds the candidates one at a time, so the sums agree to float rounding,
not bit for bit.  The radiance cache sums each cell's deposits over the
cell-sorted order (torch.segment_reduce: one thread a cell, in emission
order, no atomics), so it is deterministic on the card.

Deposits, maps and caches hold [P, 3] tensors as core_tpu's do; queries
and results of the gathers are V3.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from core_tpu_torch import scene as scene_mod
from core_tpu_torch.integrators.raytrace import apply_dispersion
from core_tpu_torch.materials import dispatch
from core_tpu_torch.materials.base import BSDF, MatType, detach_sample
from core_tpu_torch.mathutils import MIN_RAYDIST
from core_tpu_torch.photon import emit as emit_mod
from core_tpu_torch.sampling import qmc
from core_tpu_torch.vec import V3, RaysS, dot3, v3, where3

MAX_PER_CELL = 32
# candidates (queries x 27 x MAX_PER_CELL) one gather step reads: 640 MiB
# of gathered rows
GATHER_CANDIDATES = 1 << 24


class PhotonMap(NamedTuple):
    pos: torch.Tensor         # [P, 3]
    power: torch.Tensor       # [P, 3] flux
    dirn: torch.Tensor        # [P, 3] incoming direction
    valid: torch.Tensor       # [P] bool
    order: torch.Tensor       # [P] int64 photon ids sorted by cell
    cell_start: torch.Tensor  # [C + 2] int64 CSR offsets (last: invalid)
    bmin: torch.Tensor        # [3]
    inv_cell: torch.Tensor    # [] float32
    dims: tuple               # host (nx, ny, nz)
    n_valid: torch.Tensor     # [] int64
    rows: torch.Tensor        # [P, 10] pos, dirn, power, valid by `order`


def _aos(a: V3) -> torch.Tensor:
    return torch.stack([a.x, a.y, a.z], dim=-1)


def shoot_photons(scene, types_present, n_photons: int, max_bounces: int,
                  seed, mode: str, scene_center, scene_radius,
                  with_surface: bool = False, start_index=0,
                  power_norm: int | None = None):
    """Trace a photon wavefront; returns the deposits (pos, power, dirn,
    valid) as [(max_bounces + 1) * n_photons, ...] tensors, bounce-major.
    with_surface=True appends each deposit's (normal, albedo), the surface
    data of the radiance cache (photonintegr.cc:574).

    mode selects the deposit rule through the reference's per-photon
    direct / caustic flags (photonintegr.cc:253-254,318-320; sppm.cc:
    387-403,433-434), which start direct=True, caustic=False and follow
    every scatter's sampled flags f:
        caustic' = f & (GLOSSY|SPECULAR|DISPERSIVE) & direct
                 | f & (GLOSSY|SPECULAR|FILTER|DISPERSIVE) & caustic
        direct'  = f & FILTER & direct
      "diffuse": a DIFFUSE surface and not caustic (photonintegr.cc:285);
      "caustic": a DIFFUSE or GLOSSY surface and caustic (mcintegrator.cc:
                 309-312); a photon neither caustic nor direct dies (:339);
      "sppm":    not direct, and not caustic on DIFFUSE or caustic on
                 DIFFUSE|GLOSSY (sppm.cc:387,403).
    Power is attenuated through absorbing interiors (Beer, on a backface
    hit), dispersive scatters go monochromatic at the photon's wavelength
    (photonintegr.cc:472-479), a scatter survives a roulette on its
    throughput ratio, and the light is picked uniformly with 1/k pdf (the
    reference picks by a power CDF; core_tpu's documented deviation).

    seed: an int (SPPM passes its pass's stream); start_index and
    power_norm shift the photons along one global QMC stream and normalise
    by a whole population (core_tpu's device-sharded shooting).
    """
    assert mode in ("diffuse", "caustic", "sppm"), mode
    n_lights = len(scene.lights)
    assert n_lights > 0
    dev = scene.device
    base = (torch.arange(n_photons, dtype=torch.int64, device=dev)
            + (int(start_index) & qmc.MASK32)
            + ((int(seed) & qmc.MASK32) * 77771 & qmc.MASK32)) & qmc.MASK32
    s1 = qmc.ri_vdc(base)
    s2 = qmc.scr_halton(2, base)
    s3 = qmc.scr_halton(3, base)
    s4 = qmc.scr_halton(4, base)
    pick = (qmc.scr_halton(5, base) * n_lights).to(torch.int32) \
        .clamp_max(n_lights - 1)

    zero = torch.zeros(n_photons, dtype=torch.float32, device=dev)
    o = d = col = V3(zero, zero, zero)
    ipdf = zero
    for li, light in enumerate(scene.lights):
        lo, ld, lc, lip = emit_mod.emit_photon(light, s1, s2, s3, s4,
                                               scene_center, scene_radius)
        m = pick == li
        o, d, col = where3(m, lo, o), where3(m, ld, d), where3(m, lc, col)
        ipdf = torch.where(m, lip, ipdf)

    # photon power (mcintegrator.cc:262): col * ipdf * nLights / nPhotons
    power = col * (ipdf * n_lights / (power_norm or n_photons))
    alive = torch.ones(n_photons, dtype=torch.bool, device=dev)
    direct = alive.clone()                       # photonintegr.cc:254
    caustic = torch.zeros_like(alive)            # photonintegr.cc:253
    disperse_possible = int(MatType.GLASS) in [int(t) for t in types_present]
    chromatic = torch.zeros_like(alive)
    wl = qmc.scr_halton(47, base)

    deposits = []
    rays = RaysS(o=o, d=d, tmin=torch.full_like(zero, MIN_RAYDIST),
                 tmax=torch.full_like(zero, -1.0))
    exclude = None
    for bounce in range(max_bounces + 1):
        hits = scene_mod.closest_hit_s(scene, rays, exclude_prim=exclude)
        alive = alive & hits.valid
        sp = scene_mod.surface_points_s(scene, rays, hits)
        p = scene_mod.material_params_s(scene, sp)
        wo = -rays.d
        if bounce > 0:
            # Beer attenuation: a backface hit means the segment ran inside
            # the hit object (photonintegr.cc:270-276 asks the previous
            # material's volume handler; the same for closed objects)
            inside = dot3(sp.ng, wo) < 0.0
            att = V3(*(torch.exp(-a * hits.t) for a in p.absorption))
            power = where3(alive & inside, power * att, power)
        is_diffuse = (p.flags & BSDF.DIFFUSE) != 0
        has_dg = (p.flags & (BSDF.DIFFUSE | BSDF.GLOSSY)) != 0
        if mode == "diffuse":
            deposit = alive & is_diffuse & ~caustic
        elif mode == "caustic":
            deposit = alive & has_dg & caustic
        else:
            deposit = alive & ~direct & ((~caustic & is_diffuse)
                                         | (caustic & has_dg))
        dep = [sp.p, power, rays.d, deposit]
        if with_surface:
            # eval() omits the Lambert 1/pi, so eval(n, n) is the albedo
            dep += [sp.n, dispatch.eval_bsdf_s(types_present, p, sp, sp.n,
                                               sp.n, BSDF.ALL)]
        deposits.append(dep)
        if bounce == max_bounces:
            break
        if disperse_possible:
            p, chromatic, power = apply_dispersion(p, chromatic, wl, power)
        # scatter (material_t::scatterPhoton, material.cc:77)
        sres = detach_sample(dispatch.sample_bsdf_s(
            types_present, p, sp, wo, qmc.scr_halton(5 + 2 * bounce, base),
            qmc.scr_halton(6 + 2 * bounce, base), BSDF.ALL))
        new_power = power * sres.col * sres.w
        # russian roulette on the throughput ratio (jnp.mean's sum / 3)
        lum_new = (new_power.x + new_power.y + new_power.z) / 3.0
        lum_old = ((power.x + power.y + power.z) / 3.0).clamp_min(1e-12)
        keep_p = (lum_new / lum_old).clamp(0.05, 1.0)
        rr = qmc.scr_halton(7 + 2 * bounce, base)
        alive = alive & (sres.pdf > 0) & (rr < keep_p)
        power = V3(*(c / keep_p for c in new_power))
        f = sres.flags
        caus_set = (f & (BSDF.GLOSSY | BSDF.SPECULAR | BSDF.DISPERSIVE)) != 0
        caus_keep = (f & (BSDF.GLOSSY | BSDF.SPECULAR | BSDF.FILTER
                          | BSDF.DISPERSIVE)) != 0
        caustic = (caus_set & direct) | (caus_keep & caustic)
        direct = ((f & BSDF.FILTER) != 0) & direct
        if mode == "caustic":
            alive = alive & (caustic | direct)
        rays = RaysS(o=sp.p, d=sres.wi, tmin=torch.full_like(zero, MIN_RAYDIST),
                     tmax=torch.full_like(zero, -1.0))
        exclude = sp.prim

    return tuple(torch.cat([_aos(x) if isinstance(x, V3) else x
                            for x in col_])
                 for col_ in zip(*deposits))


def _cell_coords(q: V3, bmin, inv_cell, dims):
    """(ix, iy, iz) int64 cells of points, clipped to the grid."""
    return tuple(((c - b) * inv_cell).to(torch.int32).to(torch.int64)
                 .clamp(0, n - 1) for c, b, n in zip(q, bmin, dims))


def _cell_id(ix, iy, iz, dims):
    _, ny, nz = dims
    return (ix * ny + iy) * nz + iz


def build_photon_grid(pos, power, dirn, valid, radius: float,
                      bmin, bmax) -> PhotonMap:
    """Sort photons into a uniform grid of cells `radius` wide.  bmin and
    bmax are host values: the grid's dimensions are host integers."""
    bmin_np = np.asarray(bmin, np.float64)
    bmax_np = np.asarray(bmax, np.float64)
    extent = np.maximum(bmax_np - bmin_np, 1e-6)
    dims = tuple(int(min(256, max(1, np.ceil(e / radius)))) for e in extent)
    dev = pos.device
    bmin_t = torch.tensor(bmin_np, dtype=torch.float32, device=dev)
    inv_cell = torch.tensor(1.0 / radius, dtype=torch.float32, device=dev)
    ix, iy, iz = _cell_coords(v3(pos), bmin_t, inv_cell, dims)
    n_cells = dims[0] * dims[1] * dims[2]
    cell = torch.where(valid, _cell_id(ix, iy, iz, dims), n_cells)
    sorted_cells, order = torch.sort(cell, stable=True)
    cell_start = torch.searchsorted(
        sorted_cells, torch.arange(n_cells + 2, dtype=torch.int64,
                                   device=dev))
    rows = torch.cat([pos, dirn, power, valid[:, None].float()],
                     dim=1).index_select(0, order)
    return PhotonMap(pos=pos, power=power, dirn=dirn, valid=valid,
                     order=order, cell_start=cell_start, bmin=bmin_t,
                     inv_cell=inv_cell, dims=dims, n_valid=valid.sum(),
                     rows=rows)


@functools.lru_cache()
def _neighbours(device) -> torch.Tensor:
    """The 27 cell offsets [27, 3] on `device`, in core_tpu's order."""
    return torch.tensor([(dx, dy, dz) for dx in (-1, 0, 1)
                         for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
                        dtype=torch.int64, device=device)


def _gather(pmap: PhotonMap, q: V3, qn: V3, r2, max_per_cell: int):
    """The 27-cell gather of both estimators: (flux V3, count [N] float).
    r2: a float, the ckernel estimate's radius squared (gather_photons), or
    [N] radii squared of the flat SPPM estimator (_gather_flat)."""
    n = q.x.shape[0]
    dev = q.x.device
    kernel = isinstance(r2, float)
    flux, count = [], []
    step = max(1, GATHER_CANDIDATES // (27 * max_per_cell))
    slots = torch.arange(max_per_cell, dtype=torch.int64, device=dev)
    nb = _neighbours(dev)
    last = pmap.rows.shape[0] - 1
    for a in range(0, n, step):
        b = min(n, a + step)
        qc = V3(*(c[a:b, None, None] for c in q))
        qnc = V3(*(c[a:b, None, None] for c in qn))
        cells = [(c[:, None] + nb[:, k]).clamp(0, dim - 1) for k, (c, dim)
                 in enumerate(zip(_cell_coords(V3(*(c[a:b] for c in q)),
                                               pmap.bmin, pmap.inv_cell,
                                               pmap.dims), pmap.dims))]
        cid = _cell_id(*cells, pmap.dims)                     # [m, 27]
        start = pmap.cell_start[cid]
        end = pmap.cell_start[cid + 1]
        in_n = (end - start).to(torch.float32).clamp_min(1.0)
        comp = (in_n / in_n.clamp_max(float(max_per_cell)))[..., None]
        slot = start[..., None] + slots                       # [m, 27, S]
        rows = pmap.rows.index_select(0, slot.clamp(0, last).reshape(-1)) \
            .reshape(slot.shape + (10,))
        dvx = rows[..., 0] - qc.x
        dvy = rows[..., 1] - qc.y
        dvz = rows[..., 2] - qc.z
        d2 = dvx * dvx + dvy * dvy + dvz * dvz
        facing = (rows[..., 3] * qnc.x + rows[..., 4] * qnc.y
                  + rows[..., 5] * qnc.z) < 0.0
        r2c = r2 if kernel else r2[a:b, None, None]
        ok = (slot < end[..., None]) & (d2 < r2c) & facing \
            & (rows[..., 9] > 0.0)
        if kernel:
            # ckernel, sample_utils.h:184
            w = 3.0 / (r2c * math.pi) * (1.0 - d2 / r2c) * comp
        else:
            w = comp.expand_as(d2)
        w = torch.where(ok, w, 0.0)
        flux.append(torch.stack([(rows[..., 6 + c] * w).sum(dim=(1, 2))
                                 for c in range(3)], dim=-1))
        count.append(torch.where(ok, comp, 0.0).sum(dim=(1, 2)))
    if not flux:
        return v3(torch.zeros((0, 3), device=dev)), torch.zeros(0, device=dev)
    return v3(torch.cat(flux)), torch.cat(count)


def gather_photons(pmap: PhotonMap, q: V3, qn: V3, radius: float,
                   max_per_cell: int = MAX_PER_CELL):
    """Radius gather around the query points q with surface normals qn:
    (flux_sum V3, count [N] int32), the kernel-weighted flux of the photons
    within `radius` whose direction opposes the normal
    (photonIntegrator_t::integrate's filter, photonintegr.cc:791-860).

    At most max_per_cell photons of a cell are inspected, each weighted
    k/m (k in the cell, m inspected): within a cell photons are in
    emission order, independent of position, so the first m are a random
    sample (without it a dense map undercounts flux 5-8x).  A query near
    the grid's edge visits a clipped cell more than once, as in core_tpu.
    """
    flux, count = _gather(pmap, q, qn, float(radius) * float(radius),
                          max_per_cell)
    return flux, count.to(torch.int32)


def estimate_irradiance(pmap: PhotonMap, q: V3, qn: V3, radius: float) -> V3:
    """Kernel density estimate -> irradiance (estimateCausticPhotons,
    mcintegrator.cc:384; the kernel already normalises by pi r^2)."""
    return gather_photons(pmap, q, qn, radius)[0]


class RadianceCache(NamedTuple):
    """Per-cell precomputed outgoing radiance, the grid form of the
    reference's radiance map (photonintegr.cc:42-107,574): a final-gather
    ray pays one table read instead of a density estimate."""
    cell_rad: torch.Tensor    # [C, 3] mean albedo / pi * irradiance
    bmin: torch.Tensor        # [3]
    inv_cell: torch.Tensor    # []
    dims: tuple               # host (nx, ny, nz)


def build_radiance_cache(pmap: PhotonMap, normal, albedo,
                         radius: float) -> RadianceCache:
    """Per-cell outgoing radiance of a built grid: a deposit's radiance is
    albedo / pi * E(pos, normal); a cell averages its deposits' (an empty
    cell holds 0).  normal, albedo: [P, 3] per deposit (shoot_photons
    with_surface=True).  Only valid deposits are estimated, in cell order
    (one host read of their count); core_tpu estimates every deposit and
    weights the invalid ones by 0."""
    nx, ny, nz = pmap.dims
    n_cells = nx * ny * nz
    idx = pmap.order[:int(pmap.n_valid)]
    irr = estimate_irradiance(pmap, v3(pmap.pos.index_select(0, idx)),
                              v3(normal.index_select(0, idx)), radius)
    rad = albedo.index_select(0, idx) * torch.stack(list(irr), -1) / math.pi
    sums = torch.segment_reduce(rad, "sum",
                                offsets=pmap.cell_start[:n_cells + 1],
                                axis=0, unsafe=True)
    counts = (pmap.cell_start[1:n_cells + 1]
              - pmap.cell_start[:n_cells]).to(torch.float32)
    return RadianceCache(cell_rad=sums / counts.clamp_min(1.0)[:, None],
                         bmin=pmap.bmin, inv_cell=pmap.inv_cell,
                         dims=pmap.dims)


def lookup_radiance(cache: RadianceCache, q: V3) -> V3:
    """One cell read of precomputed outgoing radiance."""
    cid = _cell_id(*_cell_coords(q, cache.bmin, cache.inv_cell, cache.dims),
                   cache.dims)
    return v3(cache.cell_rad.index_select(0, cid))
