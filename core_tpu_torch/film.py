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
adds per footprint offset whose sample_mask also carries an adaptive pass's
resample flags, into the whole image or into a row block's offset frame;
the scatter splat of samples anywhere in the film (add_samples); the light
image of the bidirectional integrator
(add_density_samples, merged at flush), and the adaptive-AA flags of the
next pass (next_pass_flags, imagefilm.cc:213-286).

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


def _shift(img, j: int, i: int, h: int):
    """img [R, W] moved down j rows and right i columns into an [h, W]
    frame (row r of img lands on frame row r + j); what falls outside the
    frame drops, the rest is zero."""
    r, w = img.shape
    if j == 0 and i == 0 and r == h:
        return img
    y0, y1 = max(j, 0), min(j + r, h)
    x0, x1 = max(i, 0), min(i + w, w)
    if y0 >= y1 or x0 >= x1:
        return img.new_zeros((h, w))
    return F.pad(img[y0 - j:y1 - j, x0 - i:x1 - i],
                 (x0, w - x1, y0, h - y1))


def add_samples(film: Film, x, y, dx, dy, col_rgba, filterw: float,
                ftype: FilterType, sample_mask=None,
                clamp_rgb: bool = False) -> Film:
    """Splat a wavefront of samples anywhere in the film (core_tpu
    film.py:87-140).  x, y: [N] integer pixel coordinates in the film's
    frame; dx, dy: [N] in-pixel offsets in [0, 1); col_rgba: [N, 4].
    sample_mask: [N] bool, masked-out samples add nothing.

    core_tpu scatter-adds the footprints; here the contributions are
    stably sorted by pixel and each pixel's run is summed by
    torch.segment_reduce, an order that does not change from run to run
    (index_add_ is atomic on the card).  render_chunk does not call it: a
    row block is a full grid of samples, which add_samples_grid splats
    into an offset frame."""
    h, w = film.weight.shape
    if clamp_rgb:
        col_rgba = torch.cat([col_rgba[..., :3].clamp(0.0, 1.0),
                              col_rgba[..., 3:]], dim=-1)
    k = int(np.floor(2 * filterw)) + 1
    dx0 = _round2int(dx - filterw)
    dx1 = _round2int(dx + filterw - 1.0)
    dy0 = _round2int(dy - filterw)
    dy1 = _round2int(dy + filterw - 1.0)
    x_offs = dx - 0.5
    y_offs = dy - 0.5
    inv_fw = 1.0 / filterw
    keys, vals = [], []
    for oy in range(k):
        j = dy0 + oy
        for ox in range(k):
            i = dx0 + ox
            px = x + i
            py = y + j
            ndx = (i.to(torch.float32) - x_offs).abs() * inv_fw
            ndy = (j.to(torch.float32) - y_offs).abs() * inv_fw
            fw_val = _filter_weight(ftype, ndx.clamp_max(1.0),
                                    ndy.clamp_max(1.0))
            ok = (i <= dx1) & (j <= dy1) & (px >= 0) & (px < w) \
                & (py >= 0) & (py < h)
            if sample_mask is not None:
                ok = ok & sample_mask
            fw_val = torch.where(ok, fw_val, 0.0)
            keys.append(torch.where(ok, py * w + px, h * w).to(torch.int64))
            vals.append(torch.cat([col_rgba * fw_val[..., None],
                                   fw_val[..., None]], dim=-1))
    key, order = torch.sort(torch.cat(keys), stable=True)
    vals = torch.cat(vals).index_select(0, order)
    cells, lengths = torch.unique_consecutive(key, return_counts=True)
    sums = torch.segment_reduce(vals, "sum", lengths=lengths, axis=0)
    keep = cells < h * w
    cells, sums = cells[keep], sums[keep]
    acc = torch.cat([film.rgba.reshape(-1, 4), film.weight.reshape(-1, 1)],
                    dim=-1)
    acc = acc.index_put((cells,), acc.index_select(0, cells) + sums)
    return film._replace(rgba=acc[:, :4].reshape(h, w, 4),
                         weight=acc[:, 4].reshape(h, w))


def add_samples_grid(film: Film, dx, dy, col_rgba, spp: int,
                     filterw: float, ftype: FilterType,
                     sample_mask=None, clamp_rgb: bool = False,
                     row0: int = 0) -> Film:
    """Full-raster splat: samples are one per pixel in (s, y, x) order
    ([spp*R*W] wavefront of R image rows); the filter footprint is a small
    stencil of dense shifted adds instead of a scatter.  The sample rows
    land on the film's rows [row0, row0 + R) (a row block splatting into
    its halo'd frame; R = the film's height and row0 = 0 for a whole
    image); footprints that leave the film drop."""
    h, w = film.weight.shape
    rows = dx.numel() // (spp * w)
    r = col_rgba[..., 0].reshape(spp, rows, w)
    g = col_rgba[..., 1].reshape(spp, rows, w)
    b = col_rgba[..., 2].reshape(spp, rows, w)
    a = col_rgba[..., 3].reshape(spp, rows, w)
    if clamp_rgb:
        r, g, b = (c.clamp(0.0, 1.0) for c in (r, g, b))
    dx = dx.reshape(spp, rows, w)
    dy = dy.reshape(spp, rows, w)
    mask = None if sample_mask is None else sample_mask.reshape(spp, rows,
                                                                w)

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
                    acc[k] = acc[k] + _shift(c, j + row0, i, h)

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


def _col2bri(c):
    """(R + G + B) / 3 of an [..., >= 3] image, summed left to right
    (reference color_t::col2bri, color.h)."""
    return (c[..., 0] + c[..., 1] + c[..., 2]) / 3.0


def next_pass_flags(film: Film, aa_thresh: float):
    """Adaptive-AA resample flags [H, W] bool (imageFilm_t::nextPass,
    imagefilm.cc:226-270): each pixel's |brightness| against its right,
    down, down-right and down-left neighbours' brightness; a difference
    >= aa_thresh flags both pixels (core_tpu film.py:265-301)."""
    img = normalized(film)
    b = _col2bri(img)
    c = b.abs()
    h, w = c.shape
    flags = torch.zeros((h, w), dtype=torch.bool, device=c.device)
    # (this pixel's slice, the neighbour's slice) per neighbour
    for mine, theirs in (
            ((slice(None), slice(0, w - 1)), (slice(None), slice(1, w))),
            ((slice(0, h - 1), slice(None)), (slice(1, h), slice(None))),
            ((slice(0, h - 1), slice(0, w - 1)), (slice(1, h), slice(1, w))),
            ((slice(0, h - 1), slice(1, w)), (slice(1, h), slice(0, w - 1)))):
        d = (c[mine] - b[theirs]).abs() >= aa_thresh
        flags[mine] |= d
        flags[theirs] |= d
    return flags
