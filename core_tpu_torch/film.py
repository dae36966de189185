"""Image film: weighted splatting of full-raster sample chunks
(counterpart of core_tpu/film.py).

Conventions matched to the reference (imagefilm.cc:142-165):
- filterw = filter_size * 0.5, clamped to [0.501, 4.0];
- footprint: pixels i with round(dx-filterw) <= i <= round(dx+filterw-1);
- filter argument: |i - (dx-0.5)| / filterw in [0,1] per axis.

Filters: box, Mitchell, Gauss and Lanczos, evaluated exactly with the
reference's formulas (imagefilm.cc:54-115), so the splat is differentiable.
filterw scales by 2.6 (Mitchell) and 2 (Gauss): at filter_size 1.5 the box
splats a 3x3 stencil, Gauss (filterw 1.5) 4x4 and Mitchell (1.95) 5x5.

Scope: the dense full-raster splat (add_samples_grid), a stencil of shifted
adds per footprint offset, and the light image of the bidirectional
integrator (add_density_samples, merged at flush); the scatter splat and the
adaptive-AA flags come with the passes that use them.

The light image's splats land anywhere in the image, many on one pixel.
add_density_samples sums them in a fixed order (a stable sort by pixel and
a segment sum), never by atomics, so a render is the same from run to run
on the card.
"""
from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

MAX_FILTER_SIZE = 8


class FilterType(enum.IntEnum):
    BOX = 0
    MITCHELL = 1
    GAUSS = 2
    LANCZOS = 3


class Film(NamedTuple):
    rgba: torch.Tensor      # [H,W,4] weighted sums
    weight: torch.Tensor    # [H,W]
    # the light image (imagefilm.cc:566-614): t=1 splat sums, and the light
    # paths traced (setNumSamples); None on a film that has none
    density: torch.Tensor = None    # [H,W,3]
    n_density: torch.Tensor = None  # [] f32


def make_film(h: int, w: int, *, device) -> Film:
    z = dict(dtype=torch.float32, device=device)
    return Film(rgba=torch.zeros((h, w, 4), **z),
                weight=torch.zeros((h, w), **z),
                density=torch.zeros((h, w, 3), **z),
                n_density=torch.zeros((), **z))


def effective_filterw(filter_size: float, ftype: FilterType) -> float:
    fw = 0.5 * filter_size
    if ftype == FilterType.MITCHELL:
        fw *= 2.6
    elif ftype == FilterType.GAUSS:
        fw *= 2.0
    return float(min(max(0.501, fw), 0.5 * MAX_FILTER_SIZE))


def _filter_weight(ftype: FilterType, ndx, ndy):
    """Filter value at normalised per-axis offsets in [0, 1] (the domain the
    reference's table samples, imagefilm.cc:158-165)."""
    if ftype == FilterType.BOX:
        return torch.ones_like(ndx)
    if ftype == FilterType.MITCHELL:
        x = 2.0 * torch.sqrt(ndx * ndx + ndy * ndy)
        far = x * (x * (x * -0.38888889 + 2.0) - 3.33333333) + 1.77777778
        near = x * x * (1.16666666 * x - 2.0) + 0.88888889
        return torch.where(x >= 2.0, 0.0, torch.where(x >= 1.0, far, near))
    if ftype == FilterType.GAUSS:
        r2 = ndx * ndx + ndy * ndy
        return (torch.exp(-6.0 * r2) - 0.00247875).clamp_min(0.0)
    if ftype == FilterType.LANCZOS:
        x = torch.sqrt(ndx * ndx + ndy * ndy)
        small = x < 1e-6
        a = np.pi * x
        b = np.pi * 0.5 * x
        val = torch.where(small, 1.0, torch.sin(a) * torch.sin(b)
                          / torch.where(small, 1.0, a * b))
        return torch.where(x < 2.0, val, 0.0)
    raise ValueError(f"unknown film filter {ftype!r}")


def _round2int(x):
    return torch.floor(x + 0.5).to(torch.int32)


def _shift(img, j: int, i: int, h: int, w: int):
    """Move content by (+j, +i) with zero fill (out-of-image drops)."""
    if j or i:
        img = F.pad(img, (max(i, 0), max(-i, 0), max(j, 0), max(-j, 0)))
        img = img[max(-j, 0):max(-j, 0) + h, max(-i, 0):max(-i, 0) + w]
    return img


def add_samples_grid(film: Film, dx, dy, col_rgba, spp: int,
                     filterw: float, ftype: FilterType,
                     sample_mask=None, clamp_rgb: bool = False) -> Film:
    """Full-raster splat: samples are one per pixel in (s, y, x) order
    ([spp*H*W] wavefront); the filter footprint is a small stencil of dense
    shifted adds instead of a scatter."""
    h, w = film.weight.shape
    r = col_rgba[..., 0].reshape(spp, h, w)
    g = col_rgba[..., 1].reshape(spp, h, w)
    b = col_rgba[..., 2].reshape(spp, h, w)
    a = col_rgba[..., 3].reshape(spp, h, w)
    if clamp_rgb:
        r, g, b = (c.clamp(0.0, 1.0) for c in (r, g, b))
    dx = dx.reshape(spp, h, w)
    dy = dy.reshape(spp, h, w)
    mask = None if sample_mask is None else sample_mask.reshape(spp, h, w)

    dx0 = _round2int(dx - filterw)
    dx1 = _round2int(dx + filterw - 1.0)
    dy0 = _round2int(dy - filterw)
    dy1 = _round2int(dy + filterw - 1.0)
    x_offs = dx - 0.5
    y_offs = dy - 0.5
    inv_fw = 1.0 / filterw

    ilo = int(np.floor(0.5 - filterw))
    ihi = int(np.floor(0.5 + filterw))

    acc = [torch.zeros((h, w), dtype=torch.float32, device=dx.device)
           for _ in range(5)]
    for s in range(spp):
        for j in range(ilo, ihi + 1):
            for i in range(ilo, ihi + 1):
                ndx = (i - x_offs[s]).abs() * inv_fw
                ndy = (j - y_offs[s]).abs() * inv_fw
                fw_val = _filter_weight(ftype, ndx.clamp_max(1.0),
                                        ndy.clamp_max(1.0))
                ok = (i >= dx0[s]) & (i <= dx1[s]) \
                    & (j >= dy0[s]) & (j <= dy1[s])
                if mask is not None:
                    ok = ok & mask[s]
                fw_val = torch.where(ok, fw_val, 0.0)
                for k, c in enumerate((r[s] * fw_val, g[s] * fw_val,
                                       b[s] * fw_val, a[s] * fw_val,
                                       fw_val)):
                    acc[k] = acc[k] + _shift(c, j, i, h, w)

    rgba = film.rgba + torch.stack(acc[:4], dim=-1)
    return film._replace(rgba=rgba, weight=film.weight + acc[4])


def add_density_samples(film: Film, x, y, col_rgb, n_paths,
                        sample_mask=None) -> Film:
    """Splat light-traced (t=1) contributions into the light image
    (imageFilm_t::addDensitySample; core_tpu film.py:207-236): a box
    splat at the projected pixel floor(x), floor(y).  x, y: [N] float pixel
    coordinates; col_rgb: V3 of [N]; n_paths: the light paths this
    wavefront traced, counted whether or not they reached the image.
    Splats outside the image or masked out add nothing.

    core_tpu scatter-adds; here the in-image splats are stably sorted by
    pixel and each pixel's run is summed by torch.segment_reduce, an order
    that does not change from run to run (index_add_ is atomic on the
    card)."""
    h, w = film.density.shape[:2]
    px = torch.floor(x).to(torch.int64)
    py = torch.floor(y).to(torch.int64)
    ok = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    if sample_mask is not None:
        ok = ok & sample_mask
    key = torch.where(ok, py * w + px, h * w)
    key, order = torch.sort(key, stable=True)
    cols = torch.stack(list(col_rgb), dim=-1).index_select(0, order)
    cells, lengths = torch.unique_consecutive(key, return_counts=True)
    sums = torch.segment_reduce(cols, "sum", lengths=lengths, axis=0)
    keep = cells < h * w
    cells, sums = cells[keep], sums[keep]
    dens = film.density.reshape(-1, 3)
    dens = dens.index_put((cells,), dens.index_select(0, cells) + sums)
    return film._replace(density=dens.reshape(h, w, 3),
                         n_density=film.n_density + n_paths)


def normalized(film: Film):
    """Per-pixel color = sum/weight (pixel_t::normalized)."""
    return film.rgba / film.weight[..., None].clamp_min(1e-10)


def flush(film: Film, gamma: float = 1.0, clamp: bool = False,
          premult: bool = False):
    """Final image [H,W,4] with gamma correction (imageFilm_t::flush).
    The light image is merged in scaled by w*h / max(n_density, 1)
    (imagefilm.cc:402,411)."""
    img = normalized(film)
    rgb = img[..., :3]
    if film.density is not None:
        h, w = film.weight.shape
        rgb = rgb + film.density * ((w * h) / film.n_density.clamp_min(1.0))
    if clamp:
        rgb = rgb.clamp(0.0, 1.0)
    if abs(gamma - 1.0) > 1e-3:
        rgb = torch.pow(rgb.clamp_min(0.0), 1.0 / gamma)
    if premult:
        rgb = rgb * img[..., 3:4]
    return torch.cat([rgb, img[..., 3:]], dim=-1)
