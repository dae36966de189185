"""Texture image loading (counterpart of core_tpu/io/image.py's read_image).

read_image(path) -> float32 [H, W, 3] (or the array a .npy file holds),
row 0 the top of the picture.  TGA is decoded here in numpy, with no image
library: uncompressed (type 2) and run-length encoded (type 10) true-colour
files of 24 or 32 bits per pixel, either origin (descriptor bits 4 and 5).
Like core_tpu's PIL path (Image.open(path).convert("RGB")) it drops a 32-bit
file's alpha and scales the 8-bit values by `astype(float32) / 255.0`, so
the two give the same bits.  Other TGA variants and other extensions raise
NotImplementedError by name.
"""
from __future__ import annotations

import os

import numpy as np

_TGA_TYPES = {2: "uncompressed true-colour", 10: "RLE true-colour"}


def _rle_decode(data: bytes, pos: int, n_pixels: int, bpp: int):
    """The pixel bytes of a type-10 image: packets of a header byte (bit 7
    set: one pixel repeated (h & 0x7f) + 1 times; clear: that many raw
    pixels follow)."""
    out = bytearray()
    need = n_pixels * bpp
    while len(out) < need:
        if pos >= len(data):
            raise ValueError("TGA: RLE data ends before the last pixel")
        h = data[pos]
        pos += 1
        count = (h & 0x7F) + 1
        if h & 0x80:
            out += data[pos:pos + bpp] * count
            pos += bpp
        else:
            out += data[pos:pos + count * bpp]
            pos += count * bpp
    return bytes(out[:need])


def read_tga(path: str) -> np.ndarray:
    """A 24- or 32-bit true-colour TGA as float32 [H, W, 3] in [0, 1]."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError(f"{path}: too short for a TGA header")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_len = data[5] | (data[6] << 8)
    cmap_bits = data[7]
    w = data[12] | (data[13] << 8)
    h = data[14] | (data[15] << 8)
    depth, desc = data[16], data[17]
    if itype not in _TGA_TYPES:
        raise NotImplementedError(f"{path}: TGA image type {itype} (only "
                                  "types 2 and 10, true-colour, are read)")
    if depth not in (24, 32):
        raise NotImplementedError(f"{path}: TGA with {depth} bits per pixel "
                                  "(only 24 and 32 are read)")
    bpp = depth // 8
    pos = 18 + id_len
    if cmap_type == 1:        # a true-colour file may still carry a map
        pos += cmap_len * ((cmap_bits + 7) // 8)
    if itype == 2:
        raw = data[pos:pos + w * h * bpp]
        if len(raw) < w * h * bpp:
            raise ValueError(f"{path}: TGA pixel data is truncated")
    else:
        raw = _rle_decode(data, pos, w * h, bpp)
    px = np.frombuffer(raw, np.uint8).reshape(h, w, bpp)
    rgb = px[..., 2::-1]                      # BGR(A) -> RGB, alpha dropped
    if not desc & 0x20:                       # bottom-left origin
        rgb = rgb[::-1]
    if desc & 0x10:                           # right-to-left
        rgb = rgb[:, ::-1]
    return np.ascontiguousarray(rgb).astype(np.float32) / 255.0


def read_image(path: str) -> np.ndarray:
    """Load a texture image by its extension: .tga or .npy."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "tga":
        return read_tga(path)
    if ext == "npy":
        return np.asarray(np.load(path), np.float32)
    raise NotImplementedError(f"reading .{ext} images is not ported to "
                              "core_tpu_torch yet (only .tga and .npy)")
