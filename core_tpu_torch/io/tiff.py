"""TIFF reader and writer (core_tpu reads and writes .tif / .tiff through PIL;
TheBounty ships a TIFF handler).

The first image file directory is parsed here; LZW and PackBits data are
decoded by csrc/image_codecs.cpp (native.load_codecs), Deflate by zlib.

read_tiff(path) -> uint8 [H, W, 3], as PIL's Image.open(path).convert("RGB")
gives it:
- little- and big-endian files, strips or tiles, chunky samples;
- uncompressed, LZW, PackBits and Deflate (Adobe's 8 and the old 32946),
  with or without the horizontal predictor (2; PIL ignores it on
  uncompressed data, and so does this reader);
- 8-bit RGB, RGBA (the alpha dropped), grey (BlackIsZero, or WhiteIsZero
  inverted), grey + alpha, palette (each 16-bit colour-map entry // 256),
  bilevel (1 bit; 0 / 255), 16-bit grey (clipped to 255, as PIL converts
  I;16 to L) and 16-bit RGB (the high byte of each sample).
Refused by name (NotImplementedError): JPEG-in-TIFF, CCITT and other
compressions, separate sample planes, FillOrder 2, associated alpha,
floating-point predictors and samples, and photometric interpretations or
bit depths outside that list.

write_tiff(path, img) writes what PIL's Image.save(path) writes for an RGB
image: one uncompressed strip, little-endian.  That is all that write_image
(and core_tpu's) writes.  compression="tiff_lzw" writes LZW strips of at
most 64 KiB of pixels instead, as PIL's libtiff path does; only
chip_smoke.py asks for it, to make LZW textures on a machine without PIL.
"""
from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from core_tpu_torch import native

_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d"}
_REFUSED = {2: "CCITT modified Huffman", 3: "CCITT Group 3 fax",
            4: "CCITT Group 4 fax", 6: "old-style JPEG-in-TIFF",
            7: "JPEG-in-TIFF"}
_COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate",
                 32773: "PackBits"}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _ifd(data: bytes, name: str):
    """The first IFD as {tag: tuple of values} and the byte order."""
    if data[:4] not in (b"II*\0", b"MM\0*"):
        if data[:2] in (b"II", b"MM") and data[2:4] in (b"+\0", b"\0+"):
            raise NotImplementedError(f"{name}: BigTIFF is not read")
        raise ValueError(f"{name}: not a TIFF file")
    bo = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError(f"{name}: TIFF header is truncated")
    (off,) = struct.unpack_from(bo + "I", data, 4)
    if off + 2 > len(data):
        raise ValueError(f"{name}: TIFF directory past the end of the file")
    (count,) = struct.unpack_from(bo + "H", data, off)
    tags = {}
    for i in range(count):
        e = off + 2 + 12 * i
        if e + 12 > len(data):
            raise ValueError(f"{name}: TIFF directory is truncated")
        tag, typ, cnt = struct.unpack_from(bo + "HHI", data, e)
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue
        size = struct.calcsize(bo + fmt) * cnt
        pos = e + 8 if size <= 4 else struct.unpack_from(bo + "I", data,
                                                          e + 8)[0]
        if pos + size > len(data):
            raise ValueError(f"{name}: TIFF tag {tag} past the end of the "
                             "file")
        tags[tag] = struct.unpack_from(bo + fmt * cnt, data, pos)
    return tags, bo


def _decompress(comp: int, chunk: bytes, size: int, name: str):
    """One strip or tile's bytes (at most `size`) as a uint8 array."""
    if comp == 1:
        return np.frombuffer(chunk[:size], np.uint8)
    if comp in (8, 32946):
        return np.frombuffer(zlib.decompressobj().decompress(chunk, size),
                             np.uint8)
    if comp == 5 and chunk[:2] == b"\x00\x01":
        raise NotImplementedError(f"{name}: old-style (LSB-first) TIFF LZW "
                                  "is not read")
    lib = native.load_codecs()
    out = np.empty(size, np.uint8)
    src = np.frombuffer(chunk, np.uint8)
    fn = lib.ctc_lzw_decode if comp == 5 else lib.ctc_packbits_decode
    got = fn(_ptr(src), len(chunk), _ptr(out), size)
    if got < 0:
        raise ValueError(f"{name}: corrupt {_COMPRESSIONS[comp]} data")
    return out[:got]


def decode_tiff(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The first image of a TIFF file as uint8 [H, W, 3]."""
    tags, bo = _ifd(data, name)

    def one(tag, default=None):
        v = tags.get(tag)
        return default if v is None else v[0]

    w, h = one(256), one(257)
    if not w or not h:
        raise ValueError(f"{name}: TIFF without a width or a height")
    comp = one(259, 1)
    if comp in _REFUSED:
        raise NotImplementedError(f"{name}: TIFF with {_REFUSED[comp]} "
                                  f"compression ({comp}) is not read")
    if comp not in _COMPRESSIONS:
        raise NotImplementedError(f"{name}: TIFF compression {comp} is not "
                                  "read")
    spp = one(277, 1)
    bits = tags.get(258, (1,))
    if len(bits) == 1 and spp > 1:
        bits = bits * spp
    bps = bits[0]
    photo = one(262)
    extra = tags.get(338, ())
    if any(b != bps for b in bits):
        raise NotImplementedError(f"{name}: TIFF with mixed bit depths "
                                  f"{bits}")
    if one(284, 1) != 1:
        raise NotImplementedError(f"{name}: TIFF with separate sample "
                                  "planes (PlanarConfiguration 2)")
    if one(266, 1) != 1:
        raise NotImplementedError(f"{name}: TIFF with FillOrder 2")
    if any(f != 1 for f in tags.get(339, (1,))):
        raise NotImplementedError(f"{name}: TIFF with signed or "
                                  "floating-point samples")
    pred = one(317, 1)
    if pred not in (1, 2):
        raise NotImplementedError(f"{name}: TIFF predictor {pred}")
    variant = (photo, spp, bps)
    known = {(2, 3, 8), (2, 4, 8), (2, 3, 16), (0, 1, 8), (1, 1, 8),
             (1, 2, 8), (3, 1, 8), (0, 1, 1), (1, 1, 1), (1, 1, 16)}
    if variant not in known or (spp == 4 and extra[:1] == (1,)) \
            or (spp == 2 and extra[:1] != (2,)):
        raise NotImplementedError(
            f"{name}: TIFF of photometric interpretation {photo}, {spp} "
            f"samples of {bps} bits, extra samples {extra} (read: 8-bit "
            "RGB / RGBA / grey / grey + alpha / palette, bilevel, 16-bit "
            "grey and RGB)")
    if pred == 2 and bps == 1:
        raise NotImplementedError(f"{name}: TIFF predictor 2 on 1-bit "
                                  "samples")

    # the chunks (strips or tiles) and the pixel block each fills
    if 322 in tags:
        tw, tl = one(322), one(323)
        offs, counts = tags.get(324), tags.get(325)
        across = -(-w // tw)
        rects = [((i // across) * tl, (i % across) * tw, tl, tw)
                 for i in range(-(-h // tl) * across)]
    else:
        rps = min(one(278, h), h) or h
        offs, counts = tags.get(273), tags.get(279)
        rects = [(y, 0, min(rps, h - y), w) for y in range(0, h, rps)]
    if offs is None or counts is None or len(offs) < len(rects) \
            or len(counts) < len(rects):
        raise ValueError(f"{name}: TIFF without its strip or tile offsets")
    row_bytes = lambda width: (width * spp * bps + 7) // 8   # noqa: E731
    full_h = max(r[0] + r[2] for r in rects)
    full_w = max(r[1] + r[3] for r in rects)
    dt = np.dtype(bo + "u2") if bps == 16 else np.dtype(np.uint8)
    if bps == 1:
        canvas = np.zeros((full_h, full_w), np.uint8)
    else:
        canvas = np.zeros((full_h, full_w, spp), dt)
    for (y, x, rh, rw), off, cnt in zip(rects, offs, counts):
        size = rh * row_bytes(rw)
        raw = _decompress(comp, data[off:off + cnt], size, name)
        if len(raw) < size:
            raise ValueError(f"{name}: TIFF strip or tile is truncated")
        if bps == 1:
            bitsarr = np.unpackbits(raw.reshape(rh, row_bytes(rw)),
                                    axis=1)[:, :rw]
            canvas[y:y + rh, x:x + rw] = bitsarr
            continue
        px = raw.view(dt).reshape(rh, rw, spp)
        if pred == 2 and comp != 1:     # PIL reads raw data as it is
            px = np.cumsum(px, axis=1, dtype=dt)
        canvas[y:y + rh, x:x + rw] = px
    img = canvas[:h, :w]
    if bps == 1:
        v = np.where(img.astype(bool) == (photo == 1), 255, 0).astype(
            np.uint8)
        return np.repeat(v[..., None], 3, -1)
    if bps == 16:
        v = img.astype(np.uint16)
        rgb = v >> 8 if spp == 3 else np.minimum(v, 255)
        rgb = rgb.astype(np.uint8)
        return rgb if spp == 3 else np.repeat(rgb, 3, -1)
    if photo == 2:
        return np.ascontiguousarray(img[..., :3])
    if photo == 3:
        cmap = tags.get(320)
        if cmap is None or len(cmap) != 3 * 256:
            raise ValueError(f"{name}: palette TIFF without a 256-entry "
                             "colour map")
        pal = (np.asarray(cmap, np.int64).reshape(3, 256).T // 256).astype(
            np.uint8)
        return pal[img[..., 0]]
    g = img[..., 0] if photo == 1 else 255 - img[..., 0]
    return np.repeat(g[..., None], 3, -1)


def read_tiff(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_tiff(f.read(), path)


def encode_tiff(rgb: np.ndarray, compression=None) -> bytes:
    """uint8 [H, W, 3] -> a little-endian RGB TIFF: one uncompressed strip
    (compression None), or LZW strips of min(65536 // row bytes, H) rows
    ("tiff_lzw")."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_tiff takes [H, W, 3] uint8, not "
                         f"{rgb.shape}")
    if compression not in (None, "tiff_lzw"):
        raise NotImplementedError(f"TIFF compression {compression!r} is not "
                                  "written (None or 'tiff_lzw')")
    h, w = rgb.shape[:2]
    stride = 3 * w
    lzw = compression == "tiff_lzw"
    rps = max(1, min(65536 // stride, h)) if lzw else h
    if lzw:
        lib = native.load_codecs()
        strips = []
        for y in range(0, h, rps):
            src = rgb[y:y + rps].reshape(-1)
            cap = 2 * src.size + 64
            out = np.empty(cap, np.uint8)
            got = lib.ctc_lzw_encode(_ptr(src), src.size, _ptr(out), cap)
            if got < 0:
                raise RuntimeError("TIFF LZW encoder ran out of room")
            strips.append(out[:got].tobytes())
    else:
        strips = [rgb.tobytes()]
    counts = [len(s) for s in strips]
    ns = len(strips)
    ifd_end = 8 + 2 + 12 * 10 + 4
    # BitsPerSample, then the strips' byte counts and offsets where they
    # do not fit in their entries, then the strips
    arrays = struct.pack("<3H", 8, 8, 8)
    cnt_pos = ifd_end + len(arrays)
    if ns > 1:
        arrays += struct.pack(f"<{ns}I", *counts)
    off_pos = ifd_end + len(arrays)
    offsets = list(np.cumsum([off_pos + (4 * ns if ns > 1 else 0)]
                             + counts[:-1]))
    if ns > 1:
        arrays += struct.pack(f"<{ns}I", *offsets)

    def entry(tag, typ, cnt, value):
        # value: the one SHORT or LONG, or the offset of a longer array
        return struct.pack("<HHI", tag, typ, cnt) + struct.pack(
            "<I" if typ == 4 or cnt > 1 else "<H", value).ljust(4, b"\0")

    ent = [entry(256, 4, 1, w), entry(257, 4, 1, h),
           entry(258, 3, 3, ifd_end), entry(259, 3, 1, 5 if lzw else 1),
           entry(262, 3, 1, 2),
           entry(273, 4, ns, off_pos if ns > 1 else offsets[0]),
           entry(277, 3, 1, 3), entry(278, 4, 1, rps),
           entry(279, 4, ns, cnt_pos if ns > 1 else counts[0]),
           entry(284, 3, 1, 1)]
    head = b"II*\0" + struct.pack("<IH", 8, len(ent)) + b"".join(ent) \
        + b"\0\0\0\0"
    return head + arrays + b"".join(strips)


def write_tiff(path: str, rgb: np.ndarray, compression=None):
    with open(path, "wb") as f:
        f.write(encode_tiff(rgb, compression))
