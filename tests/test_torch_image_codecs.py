"""The port's image codecs (core_tpu_torch/io/jpeg.py, io/tiff.py, the TGA
variants of io/image.py, csrc/image_codecs.cpp) against core_tpu's PIL
paths, on the CPU, on small files that PIL writes (or that are built byte by
byte here where PIL cannot write the variant), 5 to 200 pixels a side.

Every comparison is exact: the port's read_image and core_tpu's read_image
(PIL's Image.open(path).convert("RGB") / 255) give the same float32 bits
(np.array_equal on the uint32 views); the port's .jpg and .tif files decode,
through PIL and through the port, to the pixels of core_tpu's files.

- JPEG: grey; 4:4:4, 4:2:2, 4:2:0; quality 5, 75, 100 (noise at 100 drives
  the IDCT to its range limits); sizes that are not a multiple of the MCU;
  restart intervals; optimize=True (custom Huffman tables); progressive
  grey and 4:2:0 (PIL's scans include successive approximation, asserted);
  an RGB-coded file (keep_rgb, Adobe transform 0).
- TIFF: PIL's modes RGB, RGBA, L, LA, P, 1 and I;16 under no compression,
  LZW, PackBits and Adobe Deflate, and predictor 2 under LZW and Deflate;
  built here: tiles, big-endian files and 16-bit RGB, with predictor 2.
- TGA: types 1 and 9 (16- and 24-bit maps, a first entry past 0), 2 and 10
  at 16 bits, 3 and 11 at 8 and 16 bits, type 3 at 1 bit, both origins.
- Corrupt JPEGs decode as libjpeg-turbo recovers them under PIL: crafted
  cases for each recovery rule, then seeded corruption of PIL's files.
- The refusals name the variant: arithmetic-coded, lossless, 12-bit and
  CMYK JPEG; a truncated JPEG (ValueError, as PIL raises); JPEG-in-TIFF and
  CCITT TIFF; 15-bit TGA and a 32-bit TGA colour map (PIL cannot read
  either).
- A 16^2 scene file whose texture_mapper reads a relative .jpg builds the
  same leaves in both loaders (convert.scene_to_numpy); no render.
- tests/data/torch_codecs/: the files chip_smoke.py's phase 26 decodes on
  the card, each beside the .npy core_tpu decodes it to; re-decoded here so
  they cannot drift (make_fixtures rewrites them: `JAX_PLATFORMS=cpu
  PYTHONPATH=. python tests/test_torch_image_codecs.py`).
"""
import io
import os
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from core_tpu.io.image import read_image as j_read_image
from core_tpu.io.image import write_image as j_write_image
from core_tpu.io.xml_loader import parse_xml_scene as j_parse
from core_tpu_torch.io import jpeg, tiff
from core_tpu_torch.io.image import read_image, write_image
from core_tpu_torch.io.xml_loader import parse_xml_scene

HERE = os.path.dirname(os.path.abspath(__file__))
FIXTURE_DIR = os.path.join(HERE, "data", "torch_codecs")


def _same(path):
    """The port's read_image of path, bit for bit core_tpu's."""
    got, want = read_image(str(path)), j_read_image(str(path))
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    return np.array_equal(got.view(np.uint32), want.view(np.uint32))


def _picture(rng, h, w, kind):
    """A smooth colour field with some noise, or uniform noise."""
    if kind == "noise":
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[0:h, 0:w]
    a = np.stack([128 + 120 * np.sin(x / 5.0 + y / 7.0),
                  128 + 100 * np.cos(y / 3.0), (x * y) % 256], -1)
    return np.clip(a + rng.normal(0, 12, a.shape), 0, 255).astype(np.uint8)


def _scans(data: bytes):
    """(Ss, Se, Ah, Al) of each SOS header of a JPEG file."""
    out, p = [], data.find(b"\xff\xda")
    while p >= 0:
        ns = data[p + 4]
        q = p + 5 + 2 * ns
        out.append((data[q], data[q + 1], data[q + 2] >> 4, data[q + 2] & 15))
        p = data.find(b"\xff\xda", p + 2)
    return out


# (mode, save options) of each JPEG case; each at every size of JPEG_SIZES
JPEG_CASES = [
    ("L", {}), ("RGB", {"subsampling": 0}), ("RGB", {"subsampling": 1}),
    ("RGB", {"subsampling": 2}), ("RGB", {"quality": 5}),
    ("RGB", {"quality": 100}), ("RGB", {"quality": 100, "subsampling": 0}),
    ("RGB", {"restart_marker_blocks": 3}), ("RGB", {"restart_marker_rows": 1}),
    ("RGB", {"optimize": True}), ("L", {"optimize": True, "quality": 90}),
    ("RGB", {"progressive": True}), ("L", {"progressive": True}),
    ("RGB", {"keep_rgb": True, "subsampling": 0}),
]
JPEG_SIZES = [(5, 5), (17, 23), (64, 48), (61, 103), (200, 131)]


def test_jpeg_reads_as_core_tpu(tmp_path):
    rng = np.random.default_rng(0)
    failed, progressive_sa = [], False
    for h, w in JPEG_SIZES:
        for kind in ("smooth", "noise"):
            a = _picture(rng, h, w, kind)
            for mode, opts in JPEG_CASES:
                if opts.get("progressive") and kind == "noise":
                    opts = {**opts, "quality": 90}
                im = Image.fromarray(a)
                path = tmp_path / "c.jpg"
                (im.convert("L") if mode == "L" else im).save(
                    path, "JPEG", **opts)
                if opts.get("progressive"):
                    progressive_sa |= any(ah > 0 for _, _, ah, _ in
                                          _scans(path.read_bytes()))
                if not _same(path):
                    failed.append((h, w, kind, mode, opts))
    assert not failed, failed
    assert progressive_sa


def _tiff_bytes(px, photo, bo="<", tile=None, pred=1, comp=1, extra=None):
    """A TIFF file of px ([h, w] or [h, w, spp], uint8 or uint16) in byte
    order bo, in strips of 3 rows or in tiles (tw, tl), raw or Deflate,
    with predictor 2 applied where pred == 2."""
    h, w = px.shape[:2]
    spp = px.shape[2] if px.ndim == 3 else 1
    bps = 8 * px.dtype.itemsize
    px = px.reshape(h, w, spp).astype(px.dtype.newbyteorder(bo))

    def encode(block):
        if pred == 2:
            d = block.astype(np.int64)
            d[:, 1:] -= block[:, :-1].astype(np.int64)
            block = (d % (1 << bps)).astype(block.dtype)
        raw = block.tobytes()
        return zlib.compress(raw) if comp == 8 else raw

    chunks = []
    if tile:
        tw, tl = tile
        for ty in range(0, h, tl):
            for tx in range(0, w, tw):
                blk = np.zeros((tl, tw, spp), px.dtype)
                sub = px[ty:ty + tl, tx:tx + tw]
                blk[:sub.shape[0], :sub.shape[1]] = sub
                chunks.append(encode(blk))
        where = [(322, 3, [tw]), (323, 3, [tl]), (324, 4, None),
                 (325, 4, [len(c) for c in chunks])]
    else:
        chunks = [encode(px[y:y + 3]) for y in range(0, h, 3)]
        where = [(273, 4, None), (278, 3, [3]),
                 (279, 4, [len(c) for c in chunks])]
    tags = sorted([(256, 4, [w]), (257, 4, [h]), (258, 3, [bps] * spp),
                   (259, 3, [comp]), (262, 3, [photo]), (277, 3, [spp]),
                   (317, 3, [pred])] + where
                  + ([(338, 3, extra)] if extra else []))
    arrays_at = 8 + 2 + 12 * len(tags) + 4
    sizes = [4 * len(chunks) if v is None else
             struct.calcsize(bo + {3: "H", 4: "I"}[t] * len(v))
             for _, t, v in tags]
    data_at = arrays_at + sum(s for s in sizes if s > 4)
    offsets = list(np.cumsum([data_at] + [len(c) for c in chunks[:-1]]))
    ent, arrays = b"", b""
    for (tag, typ, vals), size in zip(tags, sizes):
        vals = offsets if vals is None else vals
        payload = struct.pack(bo + {3: "H", 4: "I"}[typ] * len(vals),
                              *map(int, vals))
        ent += struct.pack(bo + "HHI", tag, typ, len(vals))
        if size > 4:
            ent += struct.pack(bo + "I", arrays_at + len(arrays))
            arrays += payload
        else:
            ent += payload.ljust(4, b"\0")
    head = (b"II*\0" if bo == "<" else b"MM\0*") + struct.pack(
        bo + "IH", 8, len(tags)) + ent + b"\0\0\0\0"
    return head + arrays + b"".join(chunks)


def test_tiff_reads_as_core_tpu(tmp_path):
    rng = np.random.default_rng(1)
    failed = []
    path = tmp_path / "c.tif"
    for h, w in ((5, 7), (33, 17), (200, 131)):
        base = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
        images = {
            "RGB": Image.fromarray(base[..., :3]),
            "RGBA": Image.fromarray(base, "RGBA"),
            "L": Image.fromarray(base[..., 0]),
            "LA": Image.fromarray(np.ascontiguousarray(base[..., :2]), "LA"),
            "P": Image.fromarray(base[..., :3]).convert(
                "P", palette=Image.Palette.ADAPTIVE, colors=200),
            "1": Image.fromarray(base[..., 0]).convert("1"),
            "I;16": Image.fromarray(base[..., 0].astype(np.uint16) * 3
                                    + base[..., 1])}
        for mode, im in images.items():
            for comp in (None, "tiff_lzw", "packbits", "tiff_adobe_deflate"):
                im.save(path, "TIFF", compression=comp)
                if not _same(path):
                    failed.append((h, w, mode, comp))
            for comp in (("tiff_lzw", "tiff_adobe_deflate")
                         if mode != "1" else ()):
                im.save(path, "TIFF", compression=comp, tiffinfo={317: 2})
                if not _same(path):
                    failed.append((h, w, mode, comp, "predictor 2"))
    # the variants PIL does not write
    for bo in "<>":
        for tile in (None, (16, 16)):
            for pred, comp in ((1, 1), (2, 8), (1, 8), (2, 1)):
                for px, photo, extra in (
                        (rng.integers(0, 256, (37, 29, 3), np.uint8), 2, None),
                        (rng.integers(0, 65536, (37, 29, 3), np.uint16), 2,
                         None),
                        (rng.integers(0, 700, (37, 29), np.uint16), 1, None),
                        (rng.integers(0, 256, (37, 29, 4), np.uint8), 2,
                         [2])):
                    path.write_bytes(_tiff_bytes(px, photo, bo, tile, pred,
                                                 comp, extra))
                    if not _same(path):
                        failed.append((bo, tile, pred, comp, px.dtype,
                                       px.shape))
    assert not failed, failed


def _tga_bytes(itype, depth, w, h, pix: bytes, desc=0x20, cmap=None):
    """A TGA file: an 18-byte header, a 2-byte id field, the colour map
    (first index, bits per entry, entries' bytes) and the pixel bytes."""
    cmt, first, n, bits, entries = 0, 0, 0, 0, b""
    if cmap is not None:
        first, bits, entries = cmap
        cmt, n = 1, len(entries) // ((bits + 7) // 8)
    return struct.pack("<BBBHHBHHHHBB", 2, cmt, itype, first, n, bits, 0, 0,
                       w, h, depth, desc) + b"id" + entries + pix


def _tga_rle(pix: np.ndarray, w: int) -> bytes:
    """Run-length packets of the [n, bpp] pixel stream, row by row of w
    pixels (PIL's decoder refuses a run that crosses a row, as the TGA 2.0
    specification forbids it)."""
    if len(pix) > w:
        return b"".join(_tga_rle(pix[k:k + w], w)
                        for k in range(0, len(pix), w))
    out, k, n = bytearray(), 0, len(pix)
    while k < n:
        r = 1
        while k + r < n and r < 128 and np.array_equal(pix[k + r], pix[k]):
            r += 1
        if r >= 2:
            out += bytes([0x80 | (r - 1)]) + pix[k].tobytes()
            k += r
            continue
        e = k + 1
        while e < n and e - k < 128 and not (
                e + 1 < n and np.array_equal(pix[e], pix[e + 1])):
            e += 1
        out += bytes([e - k - 1]) + pix[k:e].tobytes()
        k = e
    return bytes(out)


def test_tga_reads_as_core_tpu(tmp_path):
    rng = np.random.default_rng(2)
    failed = []
    path = tmp_path / "c.tga"
    for w, h in ((5, 7), (31, 19)):
        n = w * h
        idx = rng.integers(0, 6, n).astype(np.uint8)
        idx[::5] = 9                                 # a run of one value
        for desc in (0x00, 0x20, 0x30):
            files = []
            # colour-mapped, a map of 16- or 24-bit entries starting at 2
            for bits in (16, 24):
                entries = rng.integers(0, 256, (8, bits // 8), np.uint8)
                cmap = (2, bits, entries.tobytes())
                px = (idx % 8 + 2).astype(np.uint8)
                px[1] = 0                            # below the map: black
                files += [_tga_bytes(1, 8, w, h, px.tobytes(), desc, cmap),
                          _tga_bytes(9, 8, w, h, _tga_rle(px[:, None], w),
                                     desc, cmap)]
            # 16-bit true colour (A1R5G5B5), plain and RLE
            px16 = rng.integers(0, 65536, 6, dtype=np.uint16)[idx % 6]
            pix = px16.astype("<u2").view(np.uint8).reshape(n, 2)
            files += [_tga_bytes(2, 16, w, h, pix.tobytes(), desc),
                      _tga_bytes(10, 16, w, h, _tga_rle(pix, w), desc)]
            # grey 8 and grey + alpha 16, plain and RLE; 1-bit grey
            for depth in (8, 16):
                g = rng.integers(0, 256, (6, depth // 8), np.uint8)[idx % 6]
                files += [_tga_bytes(3, depth, w, h, g.tobytes(), desc),
                          _tga_bytes(11, depth, w, h, _tga_rle(g, w), desc)]
            bits = rng.integers(0, 256, h * ((w + 7) // 8), np.uint8)
            files.append(_tga_bytes(3, 1, w, h, bits.tobytes(), desc))
            for k, data in enumerate(files):
                path.write_bytes(data)
                if not _same(path):
                    failed.append((w, h, desc, k))
    assert not failed, failed


def test_writers_match_core_tpu(tmp_path):
    """The port's .jpg and .tif files of one float image decode, through
    PIL and through the port, to the pixels of core_tpu's files; the LZW
    writer's file decodes through PIL to the image."""
    rng = np.random.default_rng(3)
    for h, w in ((5, 5), (23, 17), (64, 96), (101, 67)):
        img = rng.uniform(-0.1, 1.1, (h, w, 4)).astype(np.float32)
        img[:h // 2] = np.sin(np.mgrid[0:h // 2, 0:w, 0:4][1] / 4.0) * 0.5 \
            + 0.5
        for ext in ("jpg", "jpeg", "tif", "tiff"):
            got, want = tmp_path / f"t.{ext}", tmp_path / f"j.{ext}"
            write_image(str(got), img)
            j_write_image(str(want), img)
            with Image.open(want) as im:
                ref = np.asarray(im.convert("RGB"))
            with Image.open(got) as im:
                assert np.array_equal(np.asarray(im.convert("RGB")), ref), \
                    (h, w, ext)
            assert np.array_equal(read_image(str(got)),
                                  j_read_image(str(want))), (h, w, ext)
        rgb = (img[..., :3] * 255).clip(0, 255).astype(np.uint8)
        tiff.write_tiff(str(tmp_path / "l.tif"), rgb, "tiff_lzw")
        with Image.open(tmp_path / "l.tif") as im:
            assert im.info["compression"] == "tiff_lzw"
            assert np.array_equal(np.asarray(im.convert("RGB")), rgb)


def _huffman_codes(counts: bytes, symbols: bytes):
    """{symbol: bit string} of a T.81 Annex C canonical table."""
    codes, code, k = {}, 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            codes[symbols[k]] = format(code, f"0{length}b")
            code, k = code + 1, k + 1
        code <<= 1
    return codes


def _grey_jpeg(w, h, q, bits):
    """A baseline grey JPEG of the given entropy-coded bits (padded with
    ones, 0xFF stuffed), quantiser q everywhere, Annex K luminance tables."""
    def seg(marker, payload):
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
            + payload
    bits += "1" * (-len(bits) % 8)
    data = bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))
    head = b"\xff\xd8" + seg(0xDB, bytes([0] + [q] * 64)) + seg(
        0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
        + bytes([1, 1, 0x11, 0]))
    for tc, key in ((0x00, "dc_luminance"), (0x10, "ac_luminance")):
        head += seg(0xC4, bytes([tc]) + b"".join(jpeg.STD_HUFFMAN[key]))
    return head + seg(0xDA, bytes([1, 1, 0, 0, 63, 0])) \
        + data.replace(b"\xff", b"\xff\x00") + b"\xff\xd9"


def test_corrupt_jpeg_reads_as_core_tpu(tmp_path):
    """Corrupt files decode as libjpeg-turbo recovers them under PIL (which
    ignores its warnings): zero bits once a scan runs into a marker, the
    rest of the restart interval untouched; the resync of a wrong RSTn
    (skip an earlier one, stop at a later one, take one further on); a
    code no table has read as symbol 0 after 17 bits; 0xFF fill before a
    stuffed 0xFF; a sequential file without Huffman tables (Annex K's) or
    with junk in place of its EOI; and coefficients past 16 bits through
    the x86 SIMD IDCT's wrapping arithmetic.  Then seeded corruption of
    PIL's files: each gives the same pixels through both readers, or both
    raise, or the port refuses by name what libjpeg would smooth."""
    rng = np.random.default_rng(8)
    dc, ac = (_huffman_codes(*jpeg.STD_HUFFMAN[k])
              for k in ("dc_luminance", "ac_luminance"))

    def coef(v, cat):        # the category's bits of value v
        return format(v if v > 0 else v + (1 << cat) - 1, f"0{cat}b")

    def pil(opts, kind="smooth", h=40, w=56):
        buf = io.BytesIO()
        im = Image.fromarray(_picture(rng, h, w, kind))
        (im.convert("L") if opts.pop("grey", False) else im).save(
            buf, "JPEG", **opts)
        return buf.getvalue()

    def scan_range(d):       # where the first scan's data lies
        sos = d.index(b"\xff\xda")
        return sos + 2 + int.from_bytes(d[sos + 2:sos + 4], "big"), \
            len(d) - 2

    def patch(d, at, new):
        return d[:at] + new + d[at + len(new):]

    seq = pil({})
    lo, hi = scan_range(seq)
    rst = pil({"restart_marker_blocks": 2})
    marks = [i for i in range(*scan_range(rst))
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    k = marks[len(marks) // 2]
    want = rst[k + 1] - 0xD0
    prog = pil({"progressive": True, "grey": True})
    last = prog.rindex(b"\xff\xda")
    no_dht = bytearray(seq[:2])
    p = 2
    while seq[p + 1] != 0xDA:
        n = 2 + int.from_bytes(seq[p + 2:p + 4], "big")
        if seq[p + 1] != 0xC4:
            no_dht += seq[p:p + n]
        p += n
    stuffed = seq.index(b"\xff\x00", lo)
    crafted = {
        "marker in the scan": patch(seq, (lo + hi) // 2, b"\xff\xd5"),
        "marker in a progressive AC scan": patch(
            prog, (last + len(prog)) // 2, b"\xff\xd2"),
        "an earlier RSTn": patch(rst, k, bytes([0xFF, 0xD0 + (want - 1) % 8])),
        "a later RSTn": patch(rst, k, bytes([0xFF, 0xD0 + (want + 1) % 8])),
        "an RSTn far on": patch(rst, k, bytes([0xFF, 0xD0 + (want + 4) % 8])),
        "fill before a stuffed 0xFF": seq[:stuffed] + b"\xff" + seq[stuffed:],
        "no Huffman tables": bytes(no_dht) + seq[p:],
        "junk for an EOI": seq[:-2] + bytes(range(1, 65)),
        "a bad code": _grey_jpeg(16, 8, 16, dc[0] + "1" * 17 + dc[2] + "11"
                                 + ac[0]),
        "coefficients past 16 bits": _grey_jpeg(
            24, 8, 255, dc[11] + coef(2047, 11) + ac[0x0A] + coef(1023, 10)
            + ac[0] + dc[11] + coef(-2047, 11) + ac[0x2A] + coef(-700, 10)
            + ac[0xF0] + ac[0x1A] + coef(999, 10) + ac[0] + dc[11]
            + coef(2047, 11) + ac[0]),
    }
    path = tmp_path / "c.jpg"
    for what, data in crafted.items():
        path.write_bytes(data)
        assert _same(path), what          # PIL returns an image for each
    cases = [{}, {"grey": True}, {"subsampling": 0}, {"subsampling": 1},
             {"restart_marker_blocks": 3}, {"restart_marker_rows": 1},
             {"progressive": True}, {"progressive": True, "grey": True},
             {"progressive": True, "restart_marker_blocks": 2}]
    same = 0
    for i in range(180):
        d = bytearray(pil(dict(cases[i % len(cases)]), ("smooth", "noise")[
            i % 2], int(rng.integers(8, 72)), int(rng.integers(8, 72))))
        lo, hi = scan_range(d)
        at = int(rng.integers(lo, hi - 2))
        how = i // len(cases) % 4
        if how == 0:                      # a marker over two bytes
            d[at:at + 2] = bytes([0xFF, int(rng.choice(
                [0xD0, 0xD3, 0xD9, 0xC4, 0xDA, 0xDB, 0xDD, 0xE1, 0x01]))])
        elif how == 1:                    # bytes changed
            for at in rng.integers(lo + 1, hi, 3):
                if 0xFF not in (d[at], d[at - 1]):
                    d[at] = int(rng.integers(0, 255))
        elif how == 2:                    # cut, with an EOI
            d = d[:at] + b"\xff\xd9"
        else:                             # bytes dropped
            d = d[:at] + d[at + int(rng.integers(1, 9)):]
        path.write_bytes(bytes(d))
        try:
            want = j_read_image(str(path))
        except (OSError, ValueError):
            want = None
        try:
            got = read_image(str(path))
        except NotImplementedError as e:
            assert "unrefined" in str(e) and want is not None, i
            continue
        except ValueError:
            got = None
        if want is None or got is None:
            assert want is None and got is None, i
        else:
            assert np.array_equal(got.view(np.uint32),
                                  want.view(np.uint32)), i
            same += 1
    assert same > 100


def test_unsupported_variants_raise_by_name(tmp_path):
    rng = np.random.default_rng(4)
    a = _picture(rng, 24, 40, "smooth")
    buf = io.BytesIO()
    Image.fromarray(a).save(buf, "JPEG")
    base = buf.getvalue()
    sof = base.index(b"\xff\xc0")
    cases = [(b"\xff\xc9", "arithmetic coding"), (b"\xff\xc3", "lossless"),
             (b"\xff\xc2\x00\x11\x0c", "12-bit")]
    for patch, match in cases:
        data = base[:sof] + patch + base[sof + len(patch):]
        with pytest.raises(NotImplementedError, match=match):
            jpeg.decode_jpeg(data)
    buf = io.BytesIO()
    Image.fromarray(a).convert("CMYK").save(buf, "JPEG")
    with pytest.raises(NotImplementedError, match="CMYK"):
        jpeg.decode_jpeg(buf.getvalue())
    path = tmp_path / "cut.jpg"
    path.write_bytes(base[:len(base) * 2 // 3])
    with pytest.raises(ValueError):              # PIL: image file truncated
        j_read_image(str(path))
    with pytest.raises(ValueError, match="truncated"):
        read_image(str(path))
    Image.fromarray(a).save(tmp_path / "j.tif", compression="jpeg")
    with pytest.raises(NotImplementedError, match="JPEG-in-TIFF"):
        read_image(str(tmp_path / "j.tif"))
    Image.fromarray(a[..., 0]).convert("1").save(tmp_path / "g.tif",
                                                 compression="group4")
    with pytest.raises(NotImplementedError, match="CCITT"):
        read_image(str(tmp_path / "g.tif"))
    (tmp_path / "f.tga").write_bytes(_tga_bytes(2, 15, 1, 1, b"\0\0"))
    with pytest.raises(NotImplementedError, match="15 bits"):
        read_image(str(tmp_path / "f.tga"))
    (tmp_path / "m.tga").write_bytes(_tga_bytes(1, 8, 1, 1, b"\0",
                                                cmap=(0, 32, b"\0" * 4)))
    with pytest.raises(NotImplementedError, match="32-bit entries"):
        read_image(str(tmp_path / "m.tga"))


def test_scene_file_with_jpg_texture_matches_core_tpu(tmp_path, monkeypatch):
    """test_frontend's 16^2 Cornell file with a quad whose diffuse colour
    is a texture_mapper over an image texture read from a relative .jpg:
    both loaders resolve it against the working directory and build the
    same leaves."""
    from test_frontend import CORNELL_XML
    from test_torch_frontend import _assert_same_leaves
    rng = np.random.default_rng(6)
    Image.fromarray(_picture(rng, 37, 53, "smooth")).save(
        tmp_path / "wall.jpg")
    xml = CORNELL_XML.replace("</scene>\n", """\
<texture name="wall">
    <type sval="image"/>
    <filename sval="wall.jpg"/>
</texture>
<material name="tex">
    <type sval="shinydiffusemat"/>
    <color r="0.8" g="0.8" b="0.8"/>
    <diffuse_shader sval="tmap"/>
    <list_element>
        <element sval="shader_node"/>
        <name sval="tmap"/>
        <type sval="texture_mapper"/>
        <texture sval="wall"/>
        <texco sval="uv"/>
    </list_element>
</material>
<mesh id="1" vertices="4" faces="2" has_uv="true">
    <p x="400" y="100" z="500"/>
    <p x="150" y="100" z="500"/>
    <p x="150" y="350" z="500"/>
    <p x="400" y="350" z="500"/>
    <uv u="0" v="0"/>
    <uv u="1" v="0"/>
    <uv u="1" v="1"/>
    <uv u="0" v="1"/>
    <set_material sval="tex"/>
    <f a="0" b="1" c="2" uv_a="0" uv_b="1" uv_c="2"/>
    <f a="0" b="2" c="3" uv_a="0" uv_b="2" uv_c="3"/>
</mesh>
</scene>
""")
    (tmp_path / "s.xml").write_text(xml)
    monkeypatch.chdir(tmp_path)
    scene, _ = parse_xml_scene("s.xml", device="cpu")
    jscene, _ = j_parse("s.xml")
    assert scene.node_programs and scene.textures is not None
    _assert_same_leaves(scene, jscene)


def make_fixtures(out_dir=FIXTURE_DIR):
    """Write the card's fixtures: small JPEG, TIFF and TGA files from a
    seed, each with the .npy of core_tpu's decode beside it."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(20)
    h, w = 25, 37
    a = _picture(rng, h, w, "smooth")
    noise = _picture(rng, h, w, "noise")
    files = {}

    def pil(name, im, **opts):
        buf = io.BytesIO()
        im.save(buf, name.rsplit(".", 1)[1].replace("jpg", "jpeg")
                .replace("tif", "tiff").upper(), **opts)
        files[name] = buf.getvalue()

    pil("q75_420.jpg", Image.fromarray(a))
    pil("q100_444_noise.jpg", Image.fromarray(noise), quality=100,
        subsampling=0)
    pil("q90_422_restart.jpg", Image.fromarray(a), quality=90, subsampling=1,
        restart_marker_blocks=2)
    pil("progressive_420.jpg", Image.fromarray(a), progressive=True)
    pil("grey_optimized.jpg", Image.fromarray(a).convert("L"), optimize=True)
    pil("rgb_lzw_predictor.tif", Image.fromarray(a), compression="tiff_lzw",
        tiffinfo={317: 2})
    pil("palette_packbits.tif", Image.fromarray(a).convert(
        "P", palette=Image.Palette.ADAPTIVE, colors=64),
        compression="packbits")
    files["rgb16_tiled_be.tif"] = _tiff_bytes(
        rng.integers(0, 65536, (h, w, 3), np.uint16), 2, ">", (16, 16), 2,
        8)
    idx = (a[..., 0] // 32).reshape(-1)
    entries = rng.integers(0, 256, (8, 2), np.uint8).tobytes()
    files["mapped16_rle.tga"] = _tga_bytes(9, 8, w, h, _tga_rle(
        idx[:, None], w), 0x00, (0, 16, entries))
    files["grey_alpha_rle.tga"] = _tga_bytes(11, 16, w, h, _tga_rle(
        a[..., :2].reshape(-1, 2) // 16 * 16, w), 0x20)
    files["argb1555.tga"] = _tga_bytes(2, 16, w, h, noise[..., :2].tobytes(),
                                       0x20)
    for name, data in files.items():
        path = os.path.join(out_dir, name)
        with open(path, "wb") as f:
            f.write(data)
        np.save(path + ".npy", j_read_image(path))
    return sorted(files)


def test_card_fixtures_match_core_tpu():
    names = sorted(f for f in os.listdir(FIXTURE_DIR)
                   if not f.endswith(".npy"))
    assert len(names) >= 11
    total = 0
    for name in names:
        path = os.path.join(FIXTURE_DIR, name)
        want = np.load(path + ".npy")
        assert np.array_equal(j_read_image(path).view(np.uint32),
                              want.view(np.uint32)), name
        assert np.array_equal(read_image(path).view(np.uint32),
                              want.view(np.uint32)), name
        total += os.path.getsize(path) + os.path.getsize(path + ".npy")
    assert total < 200 * 1024


if __name__ == "__main__":
    print("\n".join(make_fixtures()))
