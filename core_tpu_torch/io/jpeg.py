"""JPEG reader and writer (core_tpu reads and writes .jpg through PIL, which
decodes and encodes with libjpeg-turbo; TheBounty ships a JPEG handler).

The markers are parsed here; the entropy-coded data, the IDCT / FDCT, the
resampling and the colour conversion run in csrc/image_codecs.cpp, built at
first use (native.load_codecs).  A failed build raises with g++'s output.

decode_jpeg(data) -> uint8 [H, W, 3], as PIL's Image.open(...).convert("RGB")
gives it with its defaults (the islow IDCT, fancy upsampling, no block
smoothing of a complete file):
- baseline (SOF0), extended sequential (SOF1) and progressive (SOF2)
  Huffman files of 8-bit samples;
- 1 component (grey, replicated to RGB) or 3: YCbCr (a JFIF file, or Adobe
  transform 1, or component ids 1, 2, 3 / anything else) or RGB (Adobe
  transform 0, or ids 'R', 'G', 'B');
- chroma sampled 1:1, 2:1 (4:2:2) or 2:1 x 2:1 (4:2:0) against luma;
- restart intervals;
- corrupt data as libjpeg recovers from it, since PIL ignores libjpeg's
  warnings: zero bits once a scan runs into a marker, and the rest of its
  restart interval left as it was; the resync of a wrong RSTn marker; a
  bit pattern that is no code read as symbol 0 after 17 bits; Annex K's
  Huffman tables where a sequential file has none; a single-scan file that
  ends after its scan without an EOI.
Refused by name (NotImplementedError): arithmetic coding, lossless and
hierarchical files, precisions other than 8 bits, 2 or 4 components
(CMYK / YCCK), other sampling ratios, a height given by a DNL marker, and a
progressive file whose scans leave coefficients unrefined (libjpeg would
smooth its blocks).  Where libjpeg stops with an error, or runs out of data
that a multi-scan image still needs, ValueError, as PIL raises
(LOAD_TRUNCATED_IMAGES off).

encode_jpeg(rgb) -> bytes, as PIL's Image.save(path) writes a .jpg by
default: a JFIF 1.01 header, quality 75 (the standard tables of ITU-T T.81
Annex K scaled by libjpeg's quality rule), 4:2:0, the Annex K Huffman
tables, no restart markers.
"""
from __future__ import annotations

import ctypes

import numpy as np

from core_tpu_torch import native

# natural-order index of each zigzag position (T.81 figure A.6)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63],
    np.int64)

# T.81 Annex K.1, natural order
STD_LUMINANCE_QT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
STD_CHROMINANCE_QT = np.array(
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# PIL's default quality, 75: libjpeg's jpeg_set_quality scales each entry by
# 200 - 2 * 75 = 50 percent, rounding, which keeps every entry in [1, 255]
Q75_TABLES = [((t * 50 + 50) // 100).astype(np.int32)
              for t in (STD_LUMINANCE_QT, STD_CHROMINANCE_QT)]

# T.81 Annex K.3: (code counts by length 1..16, symbols)
STD_HUFFMAN = {
    "dc_luminance": (bytes([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]),
                     bytes(range(12))),
    "dc_chrominance": (bytes([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0,
                              0]), bytes(range(12))),
    "ac_luminance": (bytes([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1,
                            0x7D]), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
        "2433627282090a161718191a25262728292a3435363738393a43444546474849"
        "4a535455565758595a636465666768696a737475767778797a83848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
        "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
        "f9fa")),
    "ac_chrominance": (bytes([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2,
                              0x77]), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0"
        "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
        "494a535455565758595a636465666768696a737475767778797a828384858687"
        "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
        "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
        "f9fa")),
}

_ERRORS = {-2: "entropy-coded data that runs to the end of the file "
               "(truncated)",
           -4: "a Huffman table that is not a prefix code, or a DC table "
               "with a symbol past 15",
           -5: "a scan that uses an undefined Huffman table",
           -6: "an unsupported sampling ratio",
           -7: "no memory for the coefficients",
           -8: "an output buffer too small"}

_SOF_REFUSED = {0xC3: "lossless", 0xC5: "hierarchical (differential "
                "sequential)", 0xC6: "hierarchical (differential "
                "progressive)", 0xC7: "hierarchical lossless",
                0xC9: "arithmetic coding", 0xCA: "arithmetic coding "
                "(progressive)", 0xCB: "arithmetic coding (lossless)",
                0xCD: "arithmetic coding (hierarchical)",
                0xCE: "arithmetic coding (hierarchical progressive)",
                0xCF: "arithmetic coding (hierarchical lossless)"}


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _check(code: int, name: str):
    if code < 0:
        raise ValueError(f"{name}: JPEG with {_ERRORS.get(code, code)}")


def _table_spec(counts: bytes, symbols: bytes) -> np.ndarray:
    spec = np.zeros(272, np.uint8)
    spec[:16] = np.frombuffer(counts, np.uint8)
    spec[16:16 + len(symbols)] = np.frombuffer(symbols, np.uint8)
    return spec


class _Truncated(ValueError):
    pass


def _segment_error(m: int, avail: bytes, length: int, frame) -> str | None:
    """What libjpeg's marker reader finds wrong in a segment of the given
    length, of which avail holds the bytes the file has (all of them, or
    fewer where the file ends first: libjpeg checks what it has read before
    it waits for the rest, and PIL then keeps the image of a finished single
    scan)."""
    if frame is not None and 0xC0 <= m <= 0xCF \
            and m not in (0xC4, 0xC8, 0xCC):
        return "a second frame header"
    if m in (0xC0, 0xC1, 0xC2):                         # SOF
        if len(avail) < 6:
            return None if len(avail) < length - 2 else "a short frame header"
        return "a frame header of bad length" \
            if length != 8 + 3 * avail[5] else None
    if m == 0xDA and frame is None:
        return "a scan before its frame"
    rest = length - 2
    p = 0
    if m == 0xC4:                                       # DHT
        while rest > 16:
            if p + 17 > len(avail):
                return None
            count = sum(avail[p + 1:p + 17])
            rest -= 17
            if count > 256 or count > rest:
                return "a bad Huffman table"
            if p + 17 + count > len(avail):
                return None
            if avail[p] & 0xEF > 3:
                return "a Huffman table index past 3"
            rest -= count
            p += 17 + count
        return "a Huffman table segment of bad length" if rest else None
    if m == 0xDB:                                       # DQT
        while rest > 0 and p < len(avail):
            if avail[p] & 15 > 3:
                return "a quantisation table index past 3"
            size = 128 if avail[p] >> 4 else 64
            rest -= 1 + size
            p += 1 + size
        return "a quantisation table segment of bad length" \
            if rest < 0 and len(avail) >= length - 2 else None
    if m == 0xCC:                                       # DAC
        for p in range(0, rest, 2):
            if p + 2 > len(avail):      # an odd length, or the file's end
                return None if len(avail) < rest else \
                    "an arithmetic conditioning segment of odd length"
            index, val = avail[p], avail[p + 1]
            if index >= 32 or (index < 16 and val & 15 > val >> 4):
                return "a bad arithmetic conditioning table"
        return None
    if m == 0xDD and length != 4:                       # DRI
        return "a restart interval segment of bad length"
    if m == 0xDA and avail:                             # SOS
        ns = avail[0]
        if length != 2 * ns + 6 or not 1 <= ns <= 4:
            return "a scan header of bad length"
        ids = [c[0] for c in frame[3]]
        got = [avail[1 + 2 * i] for i in range(ns) if 3 + 2 * i <= len(avail)]
        if any(c not in ids for c in got) or len(set(got)) < len(got):
            return "a scan of an unknown or repeated component"
    return None


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """The file's pixels as uint8 [H, W, 3] (see the module docstring)."""
    n = len(data)
    if data[:2] != b"\xff\xd8":
        raise ValueError(f"{name}: not a JPEG file")
    buf = np.frombuffer(data, np.uint8)
    lib = native.load_codecs()
    qtables = {}
    huff = np.zeros(8 * 272, np.uint8)
    present = np.zeros(8, np.int32)
    restart = 0
    jfif = False
    adobe = None
    frame = None             # (progressive, width, height, [(id, h, v, tq)])
    latched = {}             # component index -> its quantisation table
    coef_bits = None
    dec = None
    # a sequential file whose first scan holds every component: once that
    # scan is decoded, libjpeg has the image, and PIL returns it even where
    # the file ends early after it
    single_scan_done = False
    pos = 2
    try:
        try:
            while True:
                # the next marker: skip anything up to a 0xFF not followed by
                # 0x00, then the fill bytes
                while True:
                    while pos < n and data[pos] != 0xFF:
                        pos += 1
                    while pos < n and data[pos] == 0xFF:
                        pos += 1
                    if pos >= n:
                        raise _Truncated(f"{name}: JPEG file ends before its "
                                         "EOI marker (truncated)")
                    if data[pos] != 0x00:
                        break
                m = data[pos]
                pos += 1
                if m == 0xD9:                                    # EOI
                    break
                if 0xD0 <= m <= 0xD7 or (m == 0x01 and latched):
                    continue                 # RSTn, TEM: no segment, ignored
                if m == 0xD8 or m < 0xC0:
                    raise ValueError(f"{name}: JPEG with a stray marker "
                                     f"0x{m:02X}")
                if m in _SOF_REFUSED:
                    raise NotImplementedError(
                        f"{name}: JPEG with {_SOF_REFUSED[m]} (SOF{m - 0xC0}) "
                        "is not read")
                if m in (0xC8, 0xDE, 0xDF) or 0xF0 <= m <= 0xFD:
                    # JPG, DHP, EXP, JPGn: extensions that libjpeg refuses too
                    raise NotImplementedError(f"{name}: JPEG marker 0x{m:02X} "
                                              "is not read")
                if pos + 2 > n:
                    raise _Truncated(f"{name}: JPEG file is truncated")
                length = (data[pos] << 8) | data[pos + 1]
                seg = data[pos + 2:pos + length]
                if length < 2:
                    raise ValueError(f"{name}: JPEG marker segment of length "
                                     f"{length}")
                why = _segment_error(m, seg, length, frame)
                if why:
                    raise ValueError(f"{name}: JPEG with {why}")
                if len(seg) < length - 2:
                    raise _Truncated(f"{name}: JPEG marker segment is "
                                     "truncated")
                pos += length
                if m in (0xC0, 0xC1, 0xC2):
                    prec = seg[0]
                    hgt = (seg[1] << 8) | seg[2]
                    wid = (seg[3] << 8) | seg[4]
                    nc = seg[5]
                    if prec != 8:
                        raise NotImplementedError(
                            f"{name}: {prec}-bit JPEG (only 8-bit samples are "
                            "read)")
                    if nc not in (1, 3):
                        raise NotImplementedError(
                            f"{name}: JPEG with {nc} components"
                            + (" (CMYK / YCCK)" if nc == 4 else "")
                            + " (only 1, grey, and 3, YCbCr or RGB, are read)")
                    if hgt == 0:
                        raise NotImplementedError(
                            f"{name}: JPEG whose height is given by a DNL "
                            "marker")
                    if wid == 0:
                        raise ValueError(f"{name}: JPEG of width 0")
                    comps = [(seg[6 + 3 * i], seg[7 + 3 * i] >> 4,
                              seg[7 + 3 * i] & 15, seg[8 + 3 * i])
                             for i in range(nc)]
                    if any(not (1 <= h <= 4 and 1 <= v <= 4)
                           for _, h, v, _ in comps):
                        raise ValueError(f"{name}: JPEG sampling factor "
                                         "out of range")
                    mh = max(c[1] for c in comps)
                    mv = max(c[2] for c in comps)
                    if nc == 3:
                        for cid, h, v, _ in comps:
                            r = (mh // h if mh % h == 0 else 0,
                                 mv // v if mv % v == 0 else 0)
                            if r not in ((1, 1), (2, 1), (2, 2)):
                                raise NotImplementedError(
                                    f"{name}: JPEG sampling factors "
                                    + ", ".join(f"{c[1]}x{c[2]}"
                                                for c in comps)
                                    + " (read: 4:4:4, 4:2:2 and 4:2:0)")
                    frame = (m == 0xC2, wid, hgt, comps)
                    coef_bits = np.full((nc, 64), -1, np.int64)
                    samp = np.array([[h, v] for _, h, v, _ in comps], np.int32)
                    dec = lib.ctc_jpeg_dec_new(wid, hgt, nc, _ptr(samp))
                    if not dec:
                        raise MemoryError(f"{name}: JPEG of {wid} x {hgt}")
                elif m == 0xC4:                                  # DHT
                    p = 0
                    while p < len(seg):          # checked above
                        counts = seg[p + 1:p + 17]
                        total = sum(counts)
                        idx = 4 * (seg[p] >> 4) + (seg[p] & 15)
                        huff[272 * idx:272 * (idx + 1)] = _table_spec(
                            counts, seg[p + 17:p + 17 + total])
                        present[idx] = 1
                        p += 17 + total
                elif m == 0xDB:                                  # DQT
                    p = 0
                    while p < len(seg):          # checked above
                        pq, tq = seg[p] >> 4, seg[p] & 15
                        size = 128 if pq else 64
                        vals = np.frombuffer(seg[p + 1:p + 1 + size],
                                             ">u2" if pq else np.uint8)
                        qt = np.zeros(64, np.int32)
                        qt[ZIGZAG] = vals
                        qtables[tq] = qt
                        p += 1 + size
                elif m == 0xDD:                                  # DRI
                    restart = (seg[0] << 8) | seg[1]
                elif m == 0xE0 and seg[:5] == b"JFIF\0" and len(seg) >= 14:
                    jfif = True
                elif m == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12:
                    adobe = seg[11]
                elif m == 0xDA:                                  # SOS
                    if single_scan_done:
                        raise ValueError(f"{name}: JPEG with a scan after its "
                                         "only one")
                    progressive, _, _, comps = frame
                    if not progressive and not latched:
                        # libjpeg-turbo's sequential decoder fills the tables 0
                        # and 1 still missing at the first scan with Annex K's
                        # (Motion JPEG frames carry none)
                        for idx, key in ((0, "dc_luminance"),
                                         (1, "dc_chrominance"),
                                         (4, "ac_luminance"),
                                         (5, "ac_chrominance")):
                            if not present[idx]:
                                huff[272 * idx:272 * (idx + 1)] = _table_spec(
                                    *STD_HUFFMAN[key])
                                present[idx] = 1
                    ids = [c[0] for c in comps]
                    ns = seg[0]
                    scomp = np.zeros((4, 3), np.int32)
                    for i in range(ns):          # checked above
                        cid, tables = seg[1 + 2 * i], seg[2 + 2 * i]
                        ci = ids.index(cid)
                        scomp[i] = (ci, tables >> 4, tables & 15)
                        if ci not in latched:
                            tq = comps[ci][3]
                            if tq not in qtables:
                                raise ValueError(
                                    f"{name}: JPEG component uses an "
                                    "undefined quantisation table")
                            latched[ci] = qtables[tq].copy()
                    ss, se = seg[1 + 2 * ns], seg[2 + 2 * ns]
                    ah, al = seg[3 + 2 * ns] >> 4, seg[3 + 2 * ns] & 15
                    # the table selectors the scan uses (libjpeg checks only
                    # those): DC in a sequential or first DC scan, AC in a
                    # sequential or AC scan
                    used = [not progressive or (ss == 0 and ah == 0),
                            not progressive or ss > 0]
                    for k in (0, 1):
                        if not used[k]:
                            scomp[:, 1 + k] = 0
                    if (scomp[:ns, 1:] > 3).any():
                        raise ValueError(f"{name}: JPEG scan uses a Huffman "
                                         "table past 3")
                    if progressive:
                        if se > 63 or ss > se or (ss == 0 and se != 0) \
                                or (ss > 0 and ns != 1) or al > 13 \
                                or (ah != 0 and al != ah - 1):
                            raise ValueError(f"{name}: bad progressive JPEG "
                                             "scan parameters")
                        for ci in scomp[:ns, 0]:
                            coef_bits[ci, ss:se + 1] = al
                    else:
                        ss, se, ah, al = 0, 63, 0, 0
                    end = ctypes.c_int64(0)
                    rc = lib.ctc_jpeg_dec_scan(
                        dec, _ptr(buf), n, pos, ns, _ptr(scomp), ss, se, ah,
                        al, restart, int(progressive), _ptr(huff),
                        _ptr(present), ctypes.byref(end))
                    _check(rc, name)
                    pos = end.value
                    single_scan_done = not progressive and ns == len(comps)
                # APPn, COM, DAC and DNL segments carry no pixels
        except _Truncated:
            if not single_scan_done:
                raise
        if frame is None:
            raise ValueError(f"{name}: JPEG without a frame")
        progressive, wid, hgt, comps = frame
        nc = len(comps)
        if len(latched) < nc:
            raise ValueError(f"{name}: JPEG component without a scan")
        if progressive and (coef_bits[:, 0] >= 0).all() \
                and (coef_bits[:, 1:10] != 0).any():
            raise NotImplementedError(
                f"{name}: progressive JPEG whose scans leave coefficients "
                "unrefined (libjpeg smooths its blocks; not read)")
        if nc == 1:
            color = 0
        elif jfif:
            color = 1
        elif adobe is not None:
            color = 2 if adobe == 0 else 1
        else:
            color = 2 if [c[0] for c in comps] == [82, 71, 66] else 1
        quant = np.stack([latched[i] for i in range(nc)]).astype(np.int32)
        out = np.empty((hgt, wid, 3), np.uint8)
        _check(lib.ctc_jpeg_dec_finish(dec, _ptr(quant), color, _ptr(out)),
               name)
        return out
    finally:
        if dec:
            lib.ctc_jpeg_dec_free(dec)


def read_jpeg(path: str) -> np.ndarray:
    """A JPEG file as uint8 [H, W, 3]."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path)


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") \
        + payload


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> a baseline 4:2:0 JFIF file (module docstring)."""
    rgb = np.ascontiguousarray(rgb, np.uint8)
    if rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes [H, W, 3] uint8, not "
                         f"{rgb.shape}")
    h, w = rgb.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a JPEG cannot hold {w} x {h} pixels")
    qt = Q75_TABLES
    tables = [STD_HUFFMAN[k] for k in ("dc_luminance", "ac_luminance",
                                       "dc_chrominance", "ac_chrominance")]
    head = b"\xff\xd8" + _segment(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01"
                                  b"\x00\x00")
    for t in range(2):
        head += _segment(0xDB, bytes([t]) + qt[t][ZIGZAG].astype(
            np.uint8).tobytes())
    head += _segment(0xC0, bytes([8]) + h.to_bytes(2, "big")
                     + w.to_bytes(2, "big")
                     + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for cls_id, (counts, symbols) in zip((0x00, 0x10, 0x01, 0x11), tables):
        head += _segment(0xC4, bytes([cls_id]) + counts + symbols)
    head += _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    quant = np.concatenate(qt).astype(np.int32)
    huff = np.concatenate([_table_spec(*t) for t in tables])
    lib = native.load_codecs()
    cap = w * h * 3 + 65536
    while True:
        out = np.empty(cap, np.uint8)
        size = lib.ctc_jpeg_encode(_ptr(rgb), w, h, _ptr(quant), _ptr(huff),
                                   _ptr(out), cap)
        if size != -8:
            break
        cap *= 2
    _check(size, "encode_jpeg")
    return head + out[:size].tobytes() + b"\xff\xd9"


def write_jpeg(path: str, rgb: np.ndarray):
    with open(path, "wb") as f:
        f.write(encode_jpeg(rgb))
