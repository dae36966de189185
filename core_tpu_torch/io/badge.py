"""Render-settings badge burned into the output image (counterpart of
core_tpu/io/badge.py: the same font and bar, so the same lines give the
same pixels; the version line names core_tpu_torch).

The reference renders a parameter badge into the film with FreeType
(src/yafraycore/imagefilm.cc:660-842, drawRenderSettings: dark bar at the
image bottom with version, render time, AA and integrator settings).  Here
the same feature with a built-in 5x7 bitmap font (no font dependency):
`draw_badge(img, lines)` darkens a bottom bar and rasterizes the text.

Pure numpy post-process (runs on host after film flush, like the
reference which draws into the accumulated film before output).
"""
from __future__ import annotations

import numpy as np

# 5x7 font, each glyph 7 rows x 5 bits (MSB left).  Covers the characters
# the badge actually uses; unknown chars render as blanks.
_GLYPHS = {
    ' ': "00,00,00,00,00,00,00", '!': "04,04,04,04,04,00,04",
    '"': "0A,0A,00,00,00,00,00", '#': "0A,1F,0A,0A,0A,1F,0A",
    '%': "19,1A,02,04,08,0B,13", '(': "02,04,08,08,08,04,02",
    ')': "08,04,02,02,02,04,08", '*': "00,04,15,0E,15,04,00",
    '+': "00,04,04,1F,04,04,00", ',': "00,00,00,00,04,04,08",
    '-': "00,00,00,1F,00,00,00", '.': "00,00,00,00,00,0C,0C",
    '/': "01,01,02,04,08,10,10", '0': "0E,11,13,15,19,11,0E",
    '1': "04,0C,04,04,04,04,0E", '2': "0E,11,01,06,08,10,1F",
    '3': "0E,11,01,06,01,11,0E", '4': "02,06,0A,12,1F,02,02",
    '5': "1F,10,1E,01,01,11,0E", '6': "06,08,10,1E,11,11,0E",
    '7': "1F,01,02,04,08,08,08", '8': "0E,11,11,0E,11,11,0E",
    '9': "0E,11,11,0F,01,02,0C", ':': "00,0C,0C,00,0C,0C,00",
    ';': "00,0C,0C,00,0C,04,08", '<': "02,04,08,10,08,04,02",
    '=': "00,00,1F,00,1F,00,00", '>': "08,04,02,01,02,04,08",
    '?': "0E,11,01,02,04,00,04", '@': "0E,11,17,15,17,10,0E",
    'A': "0E,11,11,1F,11,11,11", 'B': "1E,11,11,1E,11,11,1E",
    'C': "0E,11,10,10,10,11,0E", 'D': "1C,12,11,11,11,12,1C",
    'E': "1F,10,10,1E,10,10,1F", 'F': "1F,10,10,1E,10,10,10",
    'G': "0E,11,10,17,11,11,0F", 'H': "11,11,11,1F,11,11,11",
    'I': "0E,04,04,04,04,04,0E", 'J': "07,02,02,02,02,12,0C",
    'K': "11,12,14,18,14,12,11", 'L': "10,10,10,10,10,10,1F",
    'M': "11,1B,15,15,11,11,11", 'N': "11,19,15,13,11,11,11",
    'O': "0E,11,11,11,11,11,0E", 'P': "1E,11,11,1E,10,10,10",
    'Q': "0E,11,11,11,15,12,0D", 'R': "1E,11,11,1E,14,12,11",
    'S': "0F,10,10,0E,01,01,1E", 'T': "1F,04,04,04,04,04,04",
    'U': "11,11,11,11,11,11,0E", 'V': "11,11,11,11,11,0A,04",
    'W': "11,11,11,15,15,15,0A", 'X': "11,11,0A,04,0A,11,11",
    'Y': "11,11,0A,04,04,04,04", 'Z': "1F,01,02,04,08,10,1F",
    '[': "0E,08,08,08,08,08,0E", ']': "0E,02,02,02,02,02,0E",
    '_': "00,00,00,00,00,00,1F", 'a': "00,00,0E,01,0F,11,0F",
    'b': "10,10,1E,11,11,11,1E", 'c': "00,00,0E,10,10,11,0E",
    'd': "01,01,0F,11,11,11,0F", 'e': "00,00,0E,11,1F,10,0E",
    'f': "06,09,08,1C,08,08,08", 'g': "00,0F,11,11,0F,01,0E",
    'h': "10,10,16,19,11,11,11", 'i': "04,00,0C,04,04,04,0E",
    'j': "02,00,06,02,02,12,0C", 'k': "10,10,12,14,18,14,12",
    'l': "0C,04,04,04,04,04,0E", 'm': "00,00,1A,15,15,11,11",
    'n': "00,00,16,19,11,11,11", 'o': "00,00,0E,11,11,11,0E",
    'p': "00,00,1E,11,1E,10,10", 'q': "00,00,0F,11,0F,01,01",
    'r': "00,00,16,19,10,10,10", 's': "00,00,0F,10,0E,01,1E",
    't': "08,08,1C,08,08,09,06", 'u': "00,00,11,11,11,13,0D",
    'v': "00,00,11,11,11,0A,04", 'w': "00,00,11,11,15,15,0A",
    'x': "00,00,11,0A,04,0A,11", 'y': "00,00,11,11,0F,01,0E",
    'z': "00,00,1F,02,04,08,1F",
}
_FONT = {c: [int(r, 16) for r in rows.split(",")]
         for c, rows in _GLYPHS.items()}

CHAR_W, CHAR_H = 6, 8  # 5x7 glyph + 1px spacing


def text_mask(line: str) -> np.ndarray:
    """Rasterize one text line -> bool [CHAR_H, len*CHAR_W]."""
    out = np.zeros((CHAR_H, CHAR_W * max(len(line), 1)), bool)
    for i, ch in enumerate(line):
        rows = _FONT.get(ch)
        if rows is None:
            continue
        for y, bits in enumerate(rows):
            for x in range(5):
                if bits & (1 << (4 - x)):
                    out[y, i * CHAR_W + x] = True
    return out


def draw_badge(img: np.ndarray, lines, bar_alpha: float = 0.65,
               fg=(0.9, 0.9, 0.9)) -> np.ndarray:
    """Draws a settings badge bar at the image bottom (in place semantics:
    returns a new array).  img: float [H,W,3|4]."""
    img = np.array(img, np.float32, copy=True)
    h, w = img.shape[:2]
    pad = 3
    bar_h = pad * 2 + CHAR_H * len(lines)
    bar_h = min(bar_h, h)
    bar = img[h - bar_h:, :, :3]
    bar *= (1.0 - bar_alpha)
    fg = np.asarray(fg, np.float32)
    for li, line in enumerate(lines):
        m = text_mask(line)
        y0 = h - bar_h + pad + li * CHAR_H
        x0 = pad
        mh, mw = m.shape
        mh = min(mh, h - y0)
        mw = min(mw, w - x0)
        if mh <= 0 or mw <= 0:
            continue
        region = img[y0:y0 + mh, x0:x0 + mw, :3]
        region[m[:mh, :mw]] = fg
    return img


def badge_lines(version: str, integrator: str, aa_settings: str,
                render_time_s: float, custom: str = "") -> list:
    """The reference badge content (imagefilm.cc:700-780): version line,
    integrator + AA settings, render time, optional custom string."""
    lines = [
        f"core_tpu_torch {version} | {integrator}",
        f"{aa_settings} | render time {render_time_s:.1f}s",
    ]
    if custom:
        lines.append(custom)
    return lines
