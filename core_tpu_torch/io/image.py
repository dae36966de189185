"""Texture image loading (counterpart of core_tpu/io/image.py's readers).

read_image(path) -> float32 [H, W, C], row 0 the top of the picture, by
extension, with numpy and zlib only (the card's machine has no image
library):
- .png: core_tpu's read_png (8-bit grey, grey + alpha, RGB or RGBA, no
  interlace; every scanline filter) -> values / 255, C = 1, 2, 3 or 4;
- .hdr / .pic: core_tpu's read_hdr (Radiance RGBE, flat or RLE
  scanlines) -> linear RGB;
- .exr: core_tpu's read_exr (uncompressed FLOAT scanlines, core_tpu's
  write_exr subset) -> RGB, and A where the file has it;
- .tga: decoded here: uncompressed (type 2) and run-length encoded (type
  10) true-colour files of 24 or 32 bits per pixel, either origin
  (descriptor bits 4 and 5).  Like core_tpu's PIL path
  (Image.open(path).convert("RGB")) it drops a 32-bit file's alpha and
  scales the 8-bit values by `astype(float32) / 255.0`, so the two give
  the same bits;
- .npy: the array it holds.
Other TGA variants raise NotImplementedError, as do other extensions,
which core_tpu reads through PIL.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_EXR_MAGIC = b"\x76\x2f\x31\x01"

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


def _unfilter(line: np.ndarray, prev: np.ndarray, ft: int, ch: int):
    """One PNG scanline with its filter (type ft) undone, in place, byte by
    byte as core_tpu's read_png does it (in Python ints, mod 256)."""
    stride = line.shape[0]
    if ft == 1:    # sub
        for i in range(ch, stride):
            line[i] = (int(line[i]) + int(line[i - ch])) & 0xFF
    elif ft == 2:  # up
        line[:] = (line + prev) & 0xFF
    elif ft == 3:  # avg
        for i in range(stride):
            left = int(line[i - ch]) if i >= ch else 0
            line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
    elif ft == 4:  # paeth
        for i in range(stride):
            a = int(line[i - ch]) if i >= ch else 0
            b = int(prev[i])
            c = int(prev[i - ch]) if i >= ch else 0
            pp = a + b - c
            pa, pb, pc = abs(pp - a), abs(pp - b), abs(pp - c)
            pr = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            line[i] = (int(line[i]) + pr) & 0xFF
    return line


def read_png(path: str) -> np.ndarray:
    """An 8-bit, non-interlaced PNG as float32 [H, W, C] in [0, 1]."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat = 8, b""
    w = h = ch = None
    while pos < len(buf):
        (ln,) = struct.unpack(">I", buf[pos:pos + 4])
        tag = buf[pos + 4:pos + 8]
        payload = buf[pos + 8:pos + 8 + ln]
        pos += 12 + ln
        if tag == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(
                ">IIBBBBB", payload)
            if depth != 8 or interlace != 0 or ctype not in (0, 2, 4, 6):
                raise NotImplementedError(
                    f"{path}: PNG of depth {depth}, colour type {ctype}, "
                    f"interlace {interlace} (only 8-bit grey, grey + alpha, "
                    "RGB and RGBA without interlace are read)")
            ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
        elif tag == b"IDAT":
            idat += payload
        elif tag == b"IEND":
            break
    if ch is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    raw = zlib.decompress(idat)
    stride = w * ch
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    pos = 0
    for r in range(h):
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8).copy()
        out[r] = prev = _unfilter(line, prev, raw[pos], ch)
        pos += 1 + stride
    return out.reshape(h, w, ch).astype(np.float32) / 255.0


def read_hdr(path: str) -> np.ndarray:
    """A Radiance RGBE file (flat or RLE scanlines) as float32 [H, W, 3]."""
    with open(path, "rb") as f:
        buf = f.read()
    pos = buf.index(b"\n\n") + 2 if b"\n\n" in buf else 0
    eol = buf.index(b"\n", pos)
    res = buf[pos:eol].decode().split()
    h, w = int(res[1]), int(res[3])
    data = buf[eol + 1:]
    rgbe = np.zeros((h, w, 4), np.uint8)
    p = 0
    for r in range(h):
        if data[p] == 2 and data[p + 1] == 2:  # new RLE
            p += 4
            for c in range(4):
                x = 0
                while x < w:
                    cnt = data[p]
                    p += 1
                    if cnt > 128:
                        rgbe[r, x:x + cnt - 128, c] = data[p]
                        p += 1
                        x += cnt - 128
                    else:
                        rgbe[r, x:x + cnt, c] = np.frombuffer(
                            data[p:p + cnt], np.uint8)
                        p += cnt
                        x += cnt
        else:
            rgbe[r] = np.frombuffer(data[p:p + 4 * w], np.uint8).reshape(w, 4)
            p += 4 * w
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)
    return rgbe[..., :3].astype(np.float32) * scale[..., None]


def read_exr(path: str) -> np.ndarray:
    """An uncompressed FLOAT-scanline OpenEXR file (the subset core_tpu's
    write_exr writes) as float32 [H, W, 3], or [H, W, 4] with its A."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:4] != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    pos = 8
    chans, xmax, ymax = [], 0, 0
    while buf[pos] != 0:
        e = buf.index(b"\0", pos)
        name = buf[pos:e]
        pos = e + 1
        e = buf.index(b"\0", pos)
        pos = e + 1
        (sz,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        payload = buf[pos:pos + sz]
        pos += sz
        if name == b"channels":
            p = 0
            while payload[p] != 0:
                ce = payload.index(b"\0", p)
                (ptype,) = struct.unpack_from("<i", payload, ce + 1)
                if ptype != 2:
                    raise NotImplementedError(
                        f"{path}: EXR channel of pixel type {ptype} (only "
                        "FLOAT channels are read)")
                chans.append(payload[p:ce].decode())
                p = ce + 1 + 16
        elif name == b"compression" and payload[0] != 0:
            raise NotImplementedError(f"{path}: compressed EXR (only "
                                      "uncompressed files are read)")
        elif name == b"dataWindow":
            _, _, xmax, ymax = struct.unpack("<iiii", payload)
    pos += 1
    h, w = ymax + 1, xmax + 1
    pos += 8 * h  # offset table
    planes = {c: np.empty((h, w), np.float32) for c in chans}
    for _ in range(h):
        y, _ = struct.unpack_from("<ii", buf, pos)
        pos += 8
        for c in chans:
            planes[c][y] = np.frombuffer(buf, np.float32, w, pos)
            pos += w * 4
    out = [planes.get(c, np.zeros((h, w), np.float32)) for c in "RGB"]
    if "A" in planes:
        out.append(planes["A"])
    return np.stack(out, axis=-1)


def read_image(path: str) -> np.ndarray:
    """Load a texture image by its extension (see the module docstring)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "tga":
        return read_tga(path)
    if ext == "png":
        return read_png(path)
    if ext in ("hdr", "pic"):
        return read_hdr(path)
    if ext == "exr":
        return read_exr(path)
    if ext == "npy":
        return np.asarray(np.load(path), np.float32)
    raise NotImplementedError(f"reading .{ext} images is not ported to "
                              "core_tpu_torch (read: .tga, .png, .hdr, "
                              ".pic, .exr, .npy)")
