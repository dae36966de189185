"""Image input and output (counterpart of core_tpu/io/image.py).

The card's machine has no image library, so every format core_tpu reads
or writes, itself or through PIL, is decoded and encoded here: with numpy
and zlib, and for JPEG and TIFF with the port's C++ codecs
(csrc/image_codecs.cpp, built by g++ at first use; a failed build raises
with g++'s output).

read_image(path) -> float32 [H, W, C], row 0 the top of the picture, by
extension:
- .png: core_tpu's read_png (8-bit grey, grey + alpha, RGB or RGBA, no
  interlace; every scanline filter) -> values / 255, C = 1, 2, 3 or 4;
- .hdr / .pic: core_tpu's read_hdr (Radiance RGBE, flat or RLE
  scanlines) -> linear RGB;
- .exr: core_tpu's read_exr (uncompressed FLOAT scanlines, core_tpu's
  write_exr subset) -> RGB, and A where the file has it;
- .npy: the array it holds;
- and, as core_tpu's PIL path gives them (Image.open(path).convert("RGB"),
  then astype(float32) / 255, so the two give the same bits), C = 3:
  - .jpg / .jpeg / .jpe / .jfif: io/jpeg.py (baseline and progressive
    Huffman, 8-bit, grey or YCbCr / RGB, 4:4:4, 4:2:2 or 4:2:0);
  - .tif / .tiff: io/tiff.py (strips or tiles, either byte order; none,
    LZW, PackBits or Deflate; 8-bit RGB / RGBA / grey / palette, bilevel,
    16-bit grey and RGB);
  - .tga: types 1 and 9 (8-bit indices into a 16- or 24-bit colour map),
    2 and 10 (16-bit A1R5G5B5, 24 and 32 bits), 3 and 11 (8-bit grey,
    16-bit grey + alpha, and 1-bit uncompressed), either origin
    (descriptor bits 4 and 5), the alpha dropped and 5-bit channels
    expanded as c * 255 // 31.
The variants PIL cannot read either (15-bit or 32-bit-mapped TGA), and
those io/jpeg.py and io/tiff.py refuse by name (arithmetic-coded,
lossless, 12-bit and CMYK JPEG; JPEG-in-TIFF and CCITT TIFF; ...), raise
NotImplementedError, as do the other extensions PIL reads (BMP, GIF,
WebP, ...), which are still to port.

The writers are core_tpu's, and write the same bytes for the same array:
write_png (8-bit RGB or RGBA, zlib level 6), write_hdr (flat RGBE),
write_tga (uncompressed, top-left origin), write_exr (uncompressed FLOAT
scanlines), and write_image by extension (those four, .npy, and what
core_tpu writes through PIL at its defaults: .jpg / .jpeg / .jpe / .jfif
as a quality-75 4:2:0 baseline JPEG, .tif / .tiff as one uncompressed RGB
strip, both of to_uint8(img[..., :3])).  Other extensions raise
NotImplementedError.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from core_tpu_torch.io import jpeg, tiff

_JPEG_EXTS = ("jpg", "jpeg", "jpe", "jfif")
_TIFF_EXTS = ("tif", "tiff")
_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_EXR_MAGIC = b"\x76\x2f\x31\x01"

_TGA_TYPES = {1: "colour-mapped", 2: "true-colour", 3: "grey",
              9: "RLE colour-mapped", 10: "RLE true-colour", 11: "RLE grey"}
# the depths PIL reads for each type (without the RLE bit)
_TGA_DEPTHS = {1: (8,), 2: (16, 24, 32), 3: (1, 8, 16)}


def _rle_decode(data: bytes, pos: int, n_pixels: int, bpp: int):
    """The pixel bytes of a run-length encoded image (types 9, 10, 11):
    packets of a header byte (bit 7 set: one pixel repeated (h & 0x7f) + 1
    times; clear: that many raw pixels follow), running on across rows."""
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


def _expand5(v: np.ndarray) -> np.ndarray:
    """16-bit A1R5G5B5 pixels -> uint8 RGB, each 5-bit channel c as
    c * 255 // 31 (PIL's BGRA;15Z unpacker)."""
    v = v.astype(np.uint32)
    return np.stack([((v >> s) & 31) * 255 // 31 for s in (10, 5, 0)],
                    -1).astype(np.uint8)


def read_tga(path: str) -> np.ndarray:
    """A TGA file as float32 [H, W, 3] in [0, 1] (module docstring)."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 18:
        raise ValueError(f"{path}: too short for a TGA header")
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cmap_first = data[3] | (data[4] << 8)
    cmap_len = data[5] | (data[6] << 8)
    cmap_bits = data[7]
    w = data[12] | (data[13] << 8)
    h = data[14] | (data[15] << 8)
    depth, desc = data[16], data[17]
    base = itype & 7
    if itype not in _TGA_TYPES:
        raise NotImplementedError(f"{path}: TGA image type {itype} (read: "
                                  "types 1, 2, 3, 9, 10 and 11)")
    if depth not in _TGA_DEPTHS[base]:
        raise NotImplementedError(
            f"{path}: {_TGA_TYPES[itype]} TGA with {depth} bits per pixel "
            f"(read: {', '.join(map(str, _TGA_DEPTHS[base]))})")
    if base == 1 and (cmap_type != 1 or cmap_bits not in (16, 24)):
        raise NotImplementedError(
            f"{path}: colour-mapped TGA with a map of type {cmap_type} and "
            f"{cmap_bits}-bit entries (read: 16- and 24-bit maps)")
    if depth == 1 and itype != 3:
        raise NotImplementedError(f"{path}: RLE TGA of 1-bit pixels")
    pos = 18 + id_len
    palette = None
    if cmap_type == 1:
        size = cmap_len * ((cmap_bits + 7) // 8)
        entries = data[pos:pos + size]
        pos += size
        if base == 1:
            pal = _expand5(np.frombuffer(entries, "<u2")) \
                if cmap_bits == 16 else \
                np.frombuffer(entries, np.uint8).reshape(-1, 3)[:, ::-1]
            # indices below the map's first entry, or past its end, are black
            palette = np.zeros((256, 3), np.uint8)
            n = max(0, min(len(pal), 256 - cmap_first))
            palette[cmap_first:cmap_first + n] = pal[:n]
    if depth == 1:
        stride = (w + 7) // 8
        raw = data[pos:pos + h * stride]
        if len(raw) < h * stride:
            raise ValueError(f"{path}: TGA pixel data is truncated")
        bits = np.unpackbits(np.frombuffer(raw, np.uint8).reshape(h, stride),
                             axis=1)[:, :w]
        rgb = np.repeat((bits * 255)[..., None], 3, -1)
    else:
        bpp = depth // 8
        if itype & 8:
            raw = _rle_decode(data, pos, w * h, bpp)
        else:
            raw = data[pos:pos + w * h * bpp]
            if len(raw) < w * h * bpp:
                raise ValueError(f"{path}: TGA pixel data is truncated")
        px = np.frombuffer(raw, np.uint8).reshape(h, w, bpp)
        if base == 1:
            rgb = palette[px[..., 0]]
        elif base == 3:                       # grey (and alpha) -> RGB
            rgb = np.repeat(px[..., :1], 3, -1)
        elif depth == 16:
            rgb = _expand5(px.view("<u2")[..., 0])
        else:
            rgb = px[..., 2::-1]              # BGR(A) -> RGB, alpha dropped
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
    if ext in _JPEG_EXTS:
        return jpeg.read_jpeg(path).astype(np.float32) / 255.0
    if ext in _TIFF_EXTS:
        return tiff.read_tiff(path).astype(np.float32) / 255.0
    raise NotImplementedError(f"reading .{ext} images is not ported to "
                              "core_tpu_torch (read: .tga, .png, .hdr, "
                              ".pic, .exr, .npy, .jpg, .jpeg, .jpe, .jfif, "
                              ".tif, .tiff)")


# ---- writers (core_tpu/io/image.py:16-43, 97-115, 152-211, 259-277) ----

def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    c = tag + payload
    return struct.pack(">I", len(payload)) + c + struct.pack(
        ">I", zlib.crc32(c) & 0xFFFFFFFF)


def encode_png(data: np.ndarray, level: int = 6) -> bytes:
    """8-bit [H,W,3] (RGB) or [H,W,4] (RGBA) -> PNG bytes, every scanline
    unfiltered, zlib at `level`."""
    h, w, ch = data.shape
    raw = b"".join(b"\x00" + data[r].tobytes() for r in range(h))
    return (_PNG_MAGIC
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              6 if ch == 4 else 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(raw, level))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, alpha: bool = False):
    """img: [H,W,3|4] (or [H,W]) float in [0,1], gamma already applied."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    ch = 4 if alpha and img.shape[-1] >= 4 else 3
    png = encode_png(to_uint8(img[..., :ch]))
    with open(path, "wb") as f:
        f.write(png)


def write_hdr(path: str, img: np.ndarray):
    """Radiance RGBE, flat scanlines (reference hdrHandler.cc)."""
    rgb = np.asarray(img)[..., :3].astype(np.float32)
    h, w = rgb.shape[:2]
    maxc = rgb.max(axis=-1)
    e = np.zeros(maxc.shape, np.int32)
    m = np.zeros(maxc.shape, np.float32)
    nz = maxc > 1e-32
    m[nz], e[nz] = np.frexp(maxc[nz])
    scale = np.where(nz, m * 256.0 / np.maximum(maxc, 1e-32), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def write_tga(path: str, img: np.ndarray, alpha: bool = False):
    """Uncompressed true-colour TGA, BGR(A), top-left origin (reference
    tgaHandler.cc)."""
    data = to_uint8(np.asarray(img))
    h, w = data.shape[:2]
    ch = 4 if alpha and data.shape[-1] >= 4 else 3
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, w, h, ch * 8,
                      0x20 | (8 if ch == 4 else 0))
    bgr = data[..., [2, 1, 0]] if ch == 3 else data[..., [2, 1, 0, 3]]
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(bgr.tobytes())


def _exr_attr(name: bytes, typ: bytes, payload: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(payload)) \
        + payload


def write_exr(path: str, img: np.ndarray, alpha: bool = False):
    """OpenEXR 2.0, uncompressed FLOAT scanlines, channels in sorted-name
    order (the subset read_exr reads)."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    chans = ["A", "B", "G", "R"] if (alpha and img.shape[-1] > 3) else \
        ["B", "G", "R"]
    # channel list: name, pixel type (2 = FLOAT), pLinear + fill, sampling
    chl = b"".join(c.encode() + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0,
                                                    0, 1, 1)
                   for c in chans) + b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr = _EXR_MAGIC + struct.pack("<i", 2)
    hdr += _exr_attr(b"channels", b"chlist", chl)
    hdr += _exr_attr(b"compression", b"compression", b"\0")
    hdr += _exr_attr(b"dataWindow", b"box2i", box)
    hdr += _exr_attr(b"displayWindow", b"box2i", box)
    hdr += _exr_attr(b"lineOrder", b"lineOrder", b"\0")
    hdr += _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0))
    hdr += _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0))
    hdr += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    hdr += b"\0"
    line_bytes = w * 4 * len(chans)
    data0 = len(hdr) + 8 * h
    src = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2],
           "A": img[..., 3] if img.shape[-1] > 3 else
           np.ones((h, w), np.float32)}
    with open(path, "wb") as f:
        f.write(hdr)
        for y in range(h):
            f.write(struct.pack("<Q", data0 + y * (8 + line_bytes)))
        for y in range(h):
            f.write(struct.pack("<ii", y, line_bytes))
            for c in chans:
                f.write(np.ascontiguousarray(src[c][y]).tobytes())


def write_image(path: str, img: np.ndarray, alpha: bool = False):
    """Write by extension: .png, .hdr, .tga, .exr, .npy, and the JPEG and
    TIFF extensions (module docstring)."""
    ext = path.rsplit(".", 1)[-1].lower()
    if ext == "png":
        return write_png(path, img, alpha)
    if ext == "hdr":
        return write_hdr(path, img)
    if ext == "tga":
        return write_tga(path, img, alpha)
    if ext == "exr":
        return write_exr(path, img, alpha)
    if ext == "npy":
        return np.save(path, np.asarray(img))
    if ext in _JPEG_EXTS:
        return jpeg.write_jpeg(path, to_uint8(np.asarray(img)[..., :3]))
    if ext in _TIFF_EXTS:
        return tiff.write_tiff(path, to_uint8(np.asarray(img)[..., :3]))
    raise NotImplementedError(f"writing .{ext} images is not ported to "
                              "core_tpu_torch (written: .png, .hdr, .tga, "
                              ".exr, .npy, .jpg, .jpeg, .jpe, .jfif, .tif, "
                              ".tiff)")
