// Image codecs of core_tpu_torch: the sequential parts of the JPEG and TIFF
// paths (io/jpeg.py and io/tiff.py parse the headers and call these through
// ctypes).  Built with g++ at first use by core_tpu_torch/native.py.
//
// JPEG (ITU-T T.81), with the integer algorithms that libjpeg documents, so
// that a file decodes to the same bits as through libjpeg-turbo's defaults:
// - Huffman decode of baseline and progressive scans (Annex F, G.1.2), into
//   a coefficient buffer in natural order; restart intervals; corrupt data
//   recovered from as libjpeg does (see ctc_jpeg_dec_scan);
// - the accurate integer ("islow") IDCT: the Loeffler-Ligtenberg-Moschytz
//   flow graph with 13-bit constants, a column pass scaled up by 2 bits and
//   a row pass, in the arithmetic of libjpeg-turbo's x86 SIMD code (16-bit
//   dequantisation and sums, 32-bit products, each pass saturated to 16
//   bits, the output to 8); on valid files its C code gives the same bits,
//   on corrupt ones with coefficients past 16 bits the two part, and PIL on
//   x86-64 runs the SIMD code;
// - "fancy" (triangle-filter) upsampling of h2v1 and h2v2 chroma, with the
//   rounding biases and edge rules below, and box replication where a
//   chroma row is two samples or less;
// - YCbCr -> RGB with 16-bit fixed-point tables.
// The encoder does the inverse steps: RGB -> YCbCr in 16-bit fixed point,
// h2v2 downsampling with alternating biases 1, 2, the islow FDCT, and
// quantisation by reciprocal multiplication (a divisor's 16-bit reciprocal,
// correction and shift), then the Huffman coding with the tables passed in.
//
// TIFF 6.0: LZW (MSB-first codes, 9 to 12 bits, the width switching one
// code early), PackBits, and an LZW encoder (for chip_smoke.py's textures;
// the port's write_image writes uncompressed TIFF, as core_tpu's does).
#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // guard entries: a corrupt run past 63 lands on the last coefficient
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum {
  kOk = 0,
  kErrHuffCode = -1,     // an LZW code past the table (corrupt data)
  kErrTruncated = -2,    // entropy-coded data ran past its end
  kErrTable = -4,        // a Huffman table that is not a prefix code
  kErrNoTable = -5,      // a scan uses a table that was never defined
  kErrSampling = -6,     // unsupported sampling-factor ratio
  kErrAlloc = -7,
  kErrCapacity = -8,     // output buffer too small
};

// ---- Huffman decoding ----

struct HuffDec {
  uint16_t look[512];   // 9-bit lookahead: (length << 8) | symbol, 0 = long
  int32_t maxcode[18];
  int32_t valoff[17];
  uint8_t vals[256];
};

// spec: 16 code counts by length, then up to 256 symbols.  As libjpeg
// does, refuse a table whose codes overflow their lengths or use the
// all-ones code, and a DC table with a symbol past 15.
int build_huff_dec(const uint8_t* spec, bool dc, HuffDec* t) {
  const uint8_t* bits = spec;
  int total = 0;
  for (int l = 0; l < 16; ++l) total += bits[l];
  if (total > 256) return kErrTable;
  std::memcpy(t->vals, spec + 16, total);
  for (int i = 0; dc && i < total; ++i)
    if (t->vals[i] > 15) return kErrTable;
  std::memset(t->look, 0, sizeof(t->look));
  int32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    int n = bits[l - 1];
    t->valoff[l] = k - code;
    for (int i = 0; i < n; ++i) {
      if (l <= 9) {
        int shift = 9 - l;
        for (int f = 0; f < (1 << shift); ++f)
          t->look[(code << shift) | f] =
              static_cast<uint16_t>((l << 8) | t->vals[k]);
      }
      ++code;
      ++k;
    }
    if (code >= (1 << l)) return kErrTable;
    t->maxcode[l] = n ? code - 1 : -1;
    code <<= 1;
  }
  t->maxcode[17] = 0x7FFFFFFF;
  return kOk;
}

// The entropy-coded bytes as libjpeg reads them: 0xFF 0x00 is a data byte
// 0xFF (fill 0xFFs before it swallowed); 0xFF and any other byte is a
// marker, where reading stops and zero bits are fed in from then on.
struct BitReader {
  const uint8_t* d;
  int64_t n, pos;        // pos: the next byte to read
  uint64_t buf = 0;
  int bits = 0;
  int fake = 0;          // of the bits, the zero bits fed in
  int marker = 0;        // the marker that stopped reading (pos is past it)
  bool eof = false;      // read past the end of the data: truncated
  bool hit = false;      // consumed a fed-in zero bit (libjpeg's
                         // insufficient_data, JWRN_HIT_MARKER)

  void fill() {
    while (bits <= 56) {
      uint32_t c = 0;
      if (marker || eof) {
        fake += 8;
      } else if (pos >= n) {
        eof = true;
        fake += 8;
      } else if ((c = d[pos++]) == 0xFF) {
        while (pos < n && d[pos] == 0xFF) ++pos;
        if (pos >= n) {
          eof = true;
        } else if (d[pos] == 0x00) {
          ++pos;
        } else {
          marker = d[pos++];
        }
        if (eof || marker) {
          c = 0;
          fake += 8;
        }
      }
      buf |= static_cast<uint64_t>(c) << (56 - bits);
      bits += 8;
    }
  }
  inline uint32_t peek(int k) {
    if (bits < k) fill();
    return static_cast<uint32_t>(buf >> (64 - k));
  }
  inline void skip(int k) {
    buf <<= k;
    bits -= k;
    if (bits < fake) hit = true;
  }
  inline uint32_t get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return v;
  }
  // libjpeg's next_marker: skip to the next marker, past stuffed 0xFF 0x00
  bool next_marker() {
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) {
        eof = true;
        return false;
      }
      int c = d[pos++];
      if (c != 0) {
        marker = c;
        return true;
      }
    }
  }
};

// A symbol of table t.  A bit pattern that no code of 16 bits or less
// matches decodes, as in libjpeg (JWRN_HUFF_BAD_CODE), to symbol 0 after 17
// bits.
inline int decode(BitReader& br, const HuffDec& t) {
  uint32_t p = br.peek(16);
  uint16_t e = t.look[p >> 7];
  if (e) {
    br.skip(e >> 8);
    return e & 0xFF;
  }
  for (int l = 10; l <= 16; ++l) {
    int32_t code = static_cast<int32_t>(p >> (16 - l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(code + t.valoff[l]) & 0xFF];
    }
  }
  br.peek(17);
  br.skip(17);
  return 0;
}

inline int extend(uint32_t v, int s) {
  return (s && v < (1u << (s - 1))) ? static_cast<int>(v) - (1 << s) + 1
                                    : static_cast<int>(v);
}

// ---- the decoder's state between scans ----

struct Comp {
  int h, v;              // sampling factors
  int bw, bh;            // blocks allocated (MCU-padded)
  int wib, hib;          // blocks that hold image samples
  int dw, dh;            // samples that hold image data
  std::vector<int16_t> coef;   // bw * bh blocks of 64, natural order
};

struct JpegDec {
  int w, h, nc, max_h, max_v, mcux, mcuy;
  Comp c[4];
};

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

void* ctc_jpeg_dec_new(int width, int height, int ncomp,
                       const int32_t* samp) {
  if (width <= 0 || height <= 0 || ncomp < 1 || ncomp > 4) return nullptr;
  JpegDec* d = new (std::nothrow) JpegDec();
  if (!d) return nullptr;
  d->w = width;
  d->h = height;
  d->nc = ncomp;
  d->max_h = d->max_v = 1;
  for (int i = 0; i < ncomp; ++i) {
    d->max_h = std::max(d->max_h, static_cast<int>(samp[2 * i]));
    d->max_v = std::max(d->max_v, static_cast<int>(samp[2 * i + 1]));
  }
  d->mcux = ceil_div(width, 8 * d->max_h);
  d->mcuy = ceil_div(height, 8 * d->max_v);
  try {
    for (int i = 0; i < ncomp; ++i) {
      Comp& c = d->c[i];
      c.h = samp[2 * i];
      c.v = samp[2 * i + 1];
      c.dw = ceil_div(width * c.h, d->max_h);
      c.dh = ceil_div(height * c.v, d->max_v);
      c.wib = ceil_div(c.dw, 8);
      c.hib = ceil_div(c.dh, 8);
      c.bw = d->mcux * c.h;
      c.bh = d->mcuy * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
  } catch (...) {
    delete d;
    return nullptr;
  }
  return d;
}

void ctc_jpeg_dec_free(void* p) { delete static_cast<JpegDec*>(p); }

// Decode one scan starting at data[pos] (the first byte after the SOS
// header).  scomp: ns triples (component index, DC table, AC table); huff:
// 8 table specs of 272 bytes (DC 0-3, then AC 0-3), present[t] != 0 where
// defined.  On return *end_pos is where the marker reader goes on.  Corrupt
// data is recovered from as libjpeg does (its warnings, which PIL ignores):
// a marker in the data ends it and zero bits follow; a code no table has
// reads as symbol 0; a wrong RSTn is resynced to.  Only data that runs to
// the end of the buffer fails (kErrTruncated), as PIL then raises.
int ctc_jpeg_dec_scan(void* p, const uint8_t* data, int64_t len, int64_t pos,
                      int ns, const int32_t* scomp, int ss, int se, int ah,
                      int al, int restart_interval, int progressive,
                      const uint8_t* huff, const int32_t* present,
                      int64_t* end_pos) {
  JpegDec* d = static_cast<JpegDec*>(p);
  static thread_local HuffDec tabs[8];
  int ci[4], dct[4], act[4];
  for (int i = 0; i < ns; ++i) {
    ci[i] = scomp[3 * i];
    dct[i] = scomp[3 * i + 1];
    act[i] = 4 + scomp[3 * i + 2];
  }
  bool dc_scan = ss == 0;
  bool need_dc = !progressive || (dc_scan && ah == 0);
  bool need_ac = !progressive || !dc_scan;
  for (int i = 0; i < ns; ++i) {
    if (need_dc) {
      if (!present[dct[i]]) return kErrNoTable;
      int r = build_huff_dec(huff + 272 * dct[i], true, &tabs[dct[i]]);
      if (r) return r;
    }
    if (need_ac) {
      if (!present[act[i]]) return kErrNoTable;
      int r = build_huff_dec(huff + 272 * act[i], false, &tabs[act[i]]);
      if (r) return r;
    }
  }
  BitReader br{data, len, pos};
  int pred[4] = {0, 0, 0, 0};
  int eobrun = 0;
  int rst_next = 0;

  // the units of the scan: interleaved MCUs, or single blocks
  int units_x, units_y;
  if (ns == 1) {
    units_x = d->c[ci[0]].wib;
    units_y = d->c[ci[0]].hib;
  } else {
    units_x = d->mcux;
    units_y = d->mcuy;
  }
  const int p1 = 1 << al;
  const int m1 = -1 * (1 << al);

  auto block_ptr = [&](int comp, int bx, int by) -> int16_t* {
    Comp& c = d->c[comp];
    return c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64;
  };

  auto do_block = [&](int i, int16_t* blk) {
    const HuffDec& dt = tabs[dct[i]];
    const HuffDec& at = tabs[act[i]];
    if (!progressive) {
      int s = decode(br, dt);
      pred[i] += extend(br.get(s), s);
      blk[0] = static_cast<int16_t>(pred[i]);
      for (int k = 1; k < 64; ++k) {
        int rs = decode(br, at);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          int v = extend(br.get(sz), sz);
          blk[kZigzag[k]] = static_cast<int16_t>(v);
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (dc_scan) {
      if (ah == 0) {
        int s = decode(br, dt);
        pred[i] += extend(br.get(s), s);
        blk[0] = static_cast<int16_t>(pred[i] * (1 << al));
      } else if (br.get(1)) {
        blk[0] = static_cast<int16_t>(blk[0] | p1);
      }
      return;
    }
    if (ah == 0) {   // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = decode(br, at);
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
          k += r;
          int v = extend(br.get(sz), sz);
          blk[kZigzag[k]] = static_cast<int16_t>(v * (1 << al));
        } else if (r == 15) {
          k += 15;
        } else {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          --eobrun;
          break;
        }
      }
      return;
    }
    // AC refinement
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode(br, at);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kZigzag[k];
          if (*coef != 0) {
            if (br.get(1) && (*coef & p1) == 0)
              *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1
                                                       : *coef + m1);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        // past the band's end (a corrupt run) this lands on coefficient
        // 63, as in libjpeg
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kZigzag[k];
        if (*coef != 0 && br.get(1) && (*coef & p1) == 0)
          *coef = static_cast<int16_t>(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun;
    }
  };

  // libjpeg's restart handling (process_restart, read_restart_marker and
  // jpeg_resync_to_restart): drop the buffered bits, find the next marker;
  // the expected RSTn is consumed, an earlier one skipped, a later one or
  // any other marker left in place (the interval after it then decodes
  // from zero bits)
  auto restart = [&]() -> bool {
    br.buf = 0;
    br.bits = br.fake = 0;
    if (!br.marker && !br.next_marker()) return false;
    for (;;) {
      int m = br.marker, want = rst_next;
      auto rst = [&](int k) { return 0xD0 + ((want + k) & 7); };
      if (m == rst(0) || (m >= 0xD0 && m <= 0xD7 && m != rst(1) &&
                          m != rst(2) && m != rst(-1) && m != rst(-2))) {
        br.marker = 0;     // consumed: decoding resumes after it
        break;
      }
      if (m >= 0xC0 && m != rst(-1) && m != rst(-2)) break;   // left
      br.marker = 0;       // not a marker of the scan, or an earlier RSTn
      if (!br.next_marker()) return false;
    }
    rst_next = (rst_next + 1) & 7;
    pred[0] = pred[1] = pred[2] = pred[3] = 0;
    eobrun = 0;
    if (!br.marker) br.hit = false;
    return true;
  };

  // Once a unit has read past the data (a marker, or the scan's end),
  // libjpeg leaves the units after it untouched until the next restart:
  // zero in a sequential scan, the earlier scans' values in a progressive
  // one.
  int64_t n_units = static_cast<int64_t>(units_x) * units_y;
  for (int64_t u = 0; u < n_units; ++u) {
    if (restart_interval && u > 0 && u % restart_interval == 0 &&
        !restart()) {
      *end_pos = len;
      return kErrTruncated;
    }
    if (br.hit) continue;
    int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
    if (ns == 1) {
      do_block(0, block_ptr(ci[0], ux, uy));
    } else {
      for (int i = 0; i < ns; ++i) {
        Comp& c = d->c[ci[i]];
        for (int by = 0; by < c.v; ++by)
          for (int bx = 0; bx < c.h; ++bx)
            do_block(i, block_ptr(ci[i], ux * c.h + bx, uy * c.v + by));
      }
    }
    if (br.eof) {
      *end_pos = len;
      return kErrTruncated;
    }
  }
  // where the marker reader goes on: at the marker that stopped the scan
  *end_pos = br.marker ? br.pos - 2 : br.pos;
  return kOk;
}

}  // extern "C"

namespace {

// ---- the islow IDCT ----

const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
const int CONST_BITS = 13, PASS1_BITS = 2;

inline int64_t descale(int64_t x, int n) {
  return (x + (static_cast<int64_t>(1) << (n - 1))) >> n;
}

// The shared lookup tables of the decoder and the encoder.
struct Tables {
  int cr_r[256], cb_b[256];   // YCbCr -> RGB, by Cr or Cb
  int64_t cr_g[256], cb_g[256];
  int64_t rgb_ycc[8 * 256];   // RGB -> YCbCr, 16-bit fixed point
};

Tables make_tables() {
  Tables t;
  const int SB = 16;
  const int64_t half = static_cast<int64_t>(1) << (SB - 1);
  auto fix = [](double v) {
    return static_cast<int64_t>(v * 65536.0 + 0.5);
  };
  for (int i = 0, x = -128; i < 256; ++i, ++x) {
    t.cr_r[i] = static_cast<int>((fix(1.40200) * x + half) >> SB);
    t.cb_b[i] = static_cast<int>((fix(1.77200) * x + half) >> SB);
    t.cr_g[i] = -fix(0.71414) * x;
    t.cb_g[i] = -fix(0.34414) * x + half;
  }
  const int64_t cbcr_off = static_cast<int64_t>(128) << SB;
  for (int i = 0; i < 256; ++i) {
    t.rgb_ycc[0 * 256 + i] = fix(0.29900) * i;
    t.rgb_ycc[1 * 256 + i] = fix(0.58700) * i;
    t.rgb_ycc[2 * 256 + i] = fix(0.11400) * i + half;
    t.rgb_ycc[3 * 256 + i] = -fix(0.16874) * i;
    t.rgb_ycc[4 * 256 + i] = -fix(0.33126) * i;
    // B => Cb and R => Cr share this one (0.5 - epsilon rounding)
    t.rgb_ycc[5 * 256 + i] = fix(0.50000) * i + cbcr_off + half - 1;
    t.rgb_ycc[6 * 256 + i] = -fix(0.41869) * i;
    t.rgb_ycc[7 * 256 + i] = -fix(0.08131) * i;
  }
  return t;
}

// Built at the first call; C++11 initialises a function-local static once,
// also when threads (ctypes drops the GIL) get here together.
const Tables& tables() {
  static const Tables t = make_tables();
  return t;
}

// x86 lane arithmetic: wrap to 16 or 32 bits, saturate to 16
inline int16_t wrap16(int64_t x) { return static_cast<int16_t>(x); }
inline int32_t wrap32(int64_t x) { return static_cast<int32_t>(x); }
inline int16_t sat16(int32_t x) {
  return static_cast<int16_t>(std::min(32767, std::max(-32768, x)));
}

// One 1-D pass over 8 values (a column, then a row; in[k * S], out[k *
// S]), as the SIMD code computes it: sums of two inputs in 16 bits, each
// product pair in 32 (pmaddwd, with the constants combined), the result
// descaled by N bits and saturated to 16.
template <int N, int S>
inline void idct_pass(const int16_t* in, int16_t* out) {
  const int64_t F054 = FIX_0_541196100, F117 = FIX_1_175875602,
                F089 = FIX_0_899976223, F256 = FIX_2_562915447;
  const int64_t i0 = in[0], i1 = in[S], i2 = in[2 * S], i3 = in[3 * S],
                i4 = in[4 * S], i5 = in[5 * S], i6 = in[6 * S],
                i7 = in[7 * S];
  // even part
  int64_t tmp3 = wrap32(i2 * (F054 + FIX_0_765366865) + i6 * F054);
  int64_t tmp2 = wrap32(i2 * F054 + i6 * (F054 - FIX_1_847759065));
  int64_t tmp0 = int64_t{wrap16(i0 + i4)} * (1 << CONST_BITS);
  int64_t tmp1 = int64_t{wrap16(i0 - i4)} * (1 << CONST_BITS);
  int64_t tmp10 = wrap32(tmp0 + tmp3), tmp13 = wrap32(tmp0 - tmp3);
  int64_t tmp11 = wrap32(tmp1 + tmp2), tmp12 = wrap32(tmp1 - tmp2);
  // odd part: i7, i5, i3, i1 are tmp0..tmp3 of T.81's flow graph
  int64_t z3 = wrap16(i7 + i3), z4 = wrap16(i5 + i1);
  int64_t z3p = wrap32(z3 * (F117 - FIX_1_961570560) + z4 * F117);
  int64_t z4p = wrap32(z3 * F117 + z4 * (F117 - FIX_0_390180644));
  int64_t o0 = wrap32(wrap32(i7 * (FIX_0_298631336 - F089) + i1 * -F089)
                      + z3p);
  int64_t o1 = wrap32(wrap32(i5 * (FIX_2_053119869 - F256) + i3 * -F256)
                      + z4p);
  int64_t o2 = wrap32(wrap32(i5 * -F256 + i3 * (FIX_3_072711026 - F256))
                      + z3p);
  int64_t o3 = wrap32(wrap32(i7 * -F089 + i1 * (FIX_1_501321110 - F089))
                      + z4p);
  auto out_of = [](int64_t x) {
    return sat16(wrap32(wrap32(x) + (int64_t{1} << (N - 1))) >> N);
  };
  out[0] = out_of(tmp10 + o3);
  out[7 * S] = out_of(tmp10 - o3);
  out[S] = out_of(tmp11 + o2);
  out[6 * S] = out_of(tmp11 - o2);
  out[2 * S] = out_of(tmp12 + o1);
  out[5 * S] = out_of(tmp12 - o1);
  out[3 * S] = out_of(tmp13 + o0);
  out[4 * S] = out_of(tmp13 - o0);
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out,
                int stride) {
  int16_t deq[64], ws[64], res[8];
  bool ac_zero = true;     // rows 1 to 7 all zero
  for (int k = 0; k < 64; ++k) {
    deq[k] = wrap16(int64_t{in[k]} * q[k]);
    ac_zero = ac_zero && (k < 8 || !in[k]);
  }
  for (int c = 0; c < 8; ++c) {
    if (ac_zero) {
      // the SIMD code's shortcut: the DC shifted up in 16 bits
      int16_t v = wrap16(int64_t{deq[c]} * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) ws[8 * r + c] = v;
    } else {
      idct_pass<CONST_BITS - PASS1_BITS, 8>(deq + c, ws + c);
    }
  }
  for (int r = 0; r < 8; ++r) {
    idct_pass<CONST_BITS + PASS1_BITS + 3, 1>(ws + 8 * r, res);
    for (int c = 0; c < 8; ++c)
      out[r * stride + c] = static_cast<uint8_t>(
          std::min(127, std::max(-128, static_cast<int>(res[c]))) + 128);
  }
}

// One component's samples at full resolution (W x H): plane is the
// component's decoded samples, pw wide, dw x dh of them real.
void upsample(const uint8_t* plane, int pw, int dw, int dh, int hr, int vr,
              int W, int H, uint8_t* out) {
  if (hr == 1 && vr == 1) {
    for (int y = 0; y < H; ++y)
      std::memcpy(out + static_cast<size_t>(y) * W,
                  plane + static_cast<size_t>(y) * pw, W);
    return;
  }
  std::vector<uint8_t> row(2 * static_cast<size_t>(dw) + 2);
  if (vr == 1) {   // h2v1
    for (int y = 0; y < H; ++y) {
      const uint8_t* in = plane + static_cast<size_t>(y) * pw;
      uint8_t* o = row.data();
      if (dw > 2) {
        int v = in[0];
        o[0] = static_cast<uint8_t>(v);
        o[1] = static_cast<uint8_t>((v * 3 + in[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; ++x) {
          int t = in[x] * 3;
          o[2 * x] = static_cast<uint8_t>((t + in[x - 1] + 1) >> 2);
          o[2 * x + 1] = static_cast<uint8_t>((t + in[x + 1] + 2) >> 2);
        }
        v = in[dw - 1];
        o[2 * dw - 2] = static_cast<uint8_t>((v * 3 + in[dw - 2] + 1) >> 2);
        o[2 * dw - 1] = static_cast<uint8_t>(v);
      } else {
        for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
      }
      std::memcpy(out + static_cast<size_t>(y) * W, o, W);
    }
    return;
  }
  // h2v2: output row 2i + v from input row i and its neighbour above (v =
  // 0) or below (v = 1), rows outside [0, dh) replaced by the edge row
  std::vector<int> sum(dw);
  for (int y = 0; y < H; ++y) {
    int i = y >> 1;
    int j = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
    const uint8_t* r0 = plane + static_cast<size_t>(i) * pw;
    const uint8_t* r1 = plane + static_cast<size_t>(j) * pw;
    uint8_t* o = row.data();
    if (dw > 2) {
      for (int x = 0; x < dw; ++x) sum[x] = r0[x] * 3 + r1[x];
      o[0] = static_cast<uint8_t>((sum[0] * 4 + 8) >> 4);
      o[1] = static_cast<uint8_t>((sum[0] * 3 + sum[1] + 7) >> 4);
      for (int x = 1; x < dw - 1; ++x) {
        o[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
        o[2 * x + 1] =
            static_cast<uint8_t>((sum[x] * 3 + sum[x + 1] + 7) >> 4);
      }
      int x = dw - 1;
      o[2 * x] = static_cast<uint8_t>((sum[x] * 3 + sum[x - 1] + 8) >> 4);
      o[2 * x + 1] = static_cast<uint8_t>((sum[x] * 4 + 7) >> 4);
    } else {
      for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = r0[x];
    }
    std::memcpy(out + static_cast<size_t>(y) * W, o, W);
  }
}

}  // namespace

extern "C" {

// IDCT, upsample and colour-convert the coefficients into out (H x W x 3
// uint8).  quant: 64 values per component, natural order; color: 0 grey, 1
// YCbCr, 2 RGB (no transform).
int ctc_jpeg_dec_finish(void* p, const int32_t* quant, int color,
                        uint8_t* out) {
  JpegDec* d = static_cast<JpegDec*>(p);
  const Tables& tb = tables();
  const int W = d->w, H = d->h;
  int ncol = color == 0 ? 1 : 3;
  if (d->nc < ncol) return kErrSampling;
  std::vector<std::vector<uint8_t>> full(ncol);
  try {
    for (int i = 0; i < ncol; ++i) {
      Comp& c = d->c[i];
      if (d->max_h % c.h || d->max_v % c.v) return kErrSampling;
      int hr = d->max_h / c.h, vr = d->max_v / c.v;
      if (!((hr == 1 && vr == 1) || (hr == 2 && vr == 1) ||
            (hr == 2 && vr == 2)))
        return kErrSampling;
      int pw = c.bw * 8;
      std::vector<uint8_t> plane(static_cast<size_t>(pw) * c.bh * 8);
      for (int by = 0; by < c.hib; ++by)
        for (int bx = 0; bx < c.wib; ++bx)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64,
                     quant + 64 * i,
                     plane.data() + static_cast<size_t>(by) * 8 * pw + bx * 8,
                     pw);
      full[i].resize(static_cast<size_t>(W) * H);
      upsample(plane.data(), pw, c.dw, c.dh, hr, vr, W, H, full[i].data());
    }
  } catch (...) {
    return kErrAlloc;
  }
  const size_t n = static_cast<size_t>(W) * H;
  if (color == 0) {
    const uint8_t* g = full[0].data();
    for (size_t k = 0; k < n; ++k) out[3 * k] = out[3 * k + 1] =
        out[3 * k + 2] = g[k];
  } else if (color == 2) {
    for (size_t k = 0; k < n; ++k)
      for (int i = 0; i < 3; ++i) out[3 * k + i] = full[i][k];
  } else {
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data();
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (size_t k = 0; k < n; ++k) {
      int y = Y[k], cb = Cb[k], cr = Cr[k];
      out[3 * k] = clamp(y + tb.cr_r[cr]);
      out[3 * k + 1] =
          clamp(y + static_cast<int>((tb.cb_g[cb] + tb.cr_g[cr]) >> 16));
      out[3 * k + 2] = clamp(y + tb.cb_b[cb]);
    }
  }
  return kOk;
}

}  // extern "C"

namespace {

// ---- encoder ----

void fdct_islow(int32_t* data) {
  for (int r = 0; r < 8; ++r) {
    int32_t* p = data + 8 * r;
    int64_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int64_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int64_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int64_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int32_t>((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = static_cast<int32_t>((tmp10 - tmp11) * (1 << PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = CONST_BITS - PASS1_BITS;
    p[2] = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[6] = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = static_cast<int32_t>(descale(tmp4 + z1 + z3, n));
    p[5] = static_cast<int32_t>(descale(tmp5 + z2 + z4, n));
    p[3] = static_cast<int32_t>(descale(tmp6 + z2 + z3, n));
    p[1] = static_cast<int32_t>(descale(tmp7 + z1 + z4, n));
  }
  for (int c = 0; c < 8; ++c) {
    int32_t* p = data + c;
    int64_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int64_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int64_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int64_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = static_cast<int32_t>(descale(tmp10 + tmp11, PASS1_BITS));
    p[32] = static_cast<int32_t>(descale(tmp10 - tmp11, PASS1_BITS));
    int64_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    const int n = CONST_BITS + PASS1_BITS;
    p[16] = static_cast<int32_t>(descale(z1 + tmp13 * FIX_0_765366865, n));
    p[48] = static_cast<int32_t>(descale(z1 + tmp12 * -FIX_1_847759065, n));
    z1 = tmp4 + tmp7;
    int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = static_cast<int32_t>(descale(tmp4 + z1 + z3, n));
    p[40] = static_cast<int32_t>(descale(tmp5 + z2 + z4, n));
    p[24] = static_cast<int32_t>(descale(tmp6 + z2 + z3, n));
    p[8] = static_cast<int32_t>(descale(tmp7 + z1 + z4, n));
  }
}

// a divisor's reciprocal, correction and total shift for a 16-bit
// coefficient: q = ((|x| + corr) * recip) >> shift
struct Recip {
  uint32_t recip, corr;
  int shift;
};

Recip reciprocal(uint32_t divisor) {
  if (divisor == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(divisor);
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor;
  uint32_t fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq & 0xFFFF, c & 0xFFFF, r};
}

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
};

void build_huff_enc(const uint8_t* spec, HuffEnc* t) {
  std::memset(t->size, 0, sizeof(t->size));
  uint32_t code = 0;
  int k = 0;
  for (int l = 1; l <= 16; ++l) {
    for (int i = 0; i < spec[l - 1]; ++i) {
      uint8_t s = spec[16 + k++];
      t->code[s] = code++;
      t->size[s] = static_cast<uint8_t>(l);
    }
    code <<= 1;
  }
}

struct BitWriter {
  uint8_t* out;
  int64_t cap, n = 0;
  uint64_t buf = 0;
  int bits = 0;
  bool full = false;
  inline void byte(uint8_t b) {
    if (n + 2 > cap) {
      full = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }
  inline void put(uint32_t v, int k) {
    buf = (buf << k) | (v & ((1u << k) - 1));
    bits += k;
    while (bits >= 8) {
      bits -= 8;
      byte(static_cast<uint8_t>(buf >> bits));
    }
  }
  void flush() {
    if (bits) put(0x7F, 8 - bits);   // pad with 1-bits
  }
};

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc,
                  const HuffEnc& dc, const HuffEnc& ac) {
  int temp = blk[0] - last_dc, temp2 = temp;
  last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    --temp2;
  }
  int nbits = 0;
  while (temp) {
    ++nbits;
    temp >>= 1;
  }
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put(static_cast<uint32_t>(temp2), nbits);
  int r = 0;
  for (int k = 1; k < 64; ++k) {
    temp = blk[kZigzag[k]];
    if (temp == 0) {
      ++r;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      --temp2;
    }
    nbits = 1;
    while ((temp >>= 1)) ++nbits;
    int s = (r << 4) + nbits;
    bw.put(ac.code[s], ac.size[s]);
    bw.put(static_cast<uint32_t>(temp2), nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

}  // namespace

extern "C" {

// Baseline 4:2:0 YCbCr entropy-coded data of an RGB image (H x W x 3
// uint8).  quant: 2 x 64 quantisation values, natural order (luminance,
// chrominance); huff: 4 table specs of 272 bytes (DC 0, AC 0, DC 1, AC 1).
// Returns the number of bytes written, or a negative error.
int64_t ctc_jpeg_encode(const uint8_t* rgb, int W, int H,
                        const int32_t* quant, const uint8_t* huff,
                        uint8_t* out, int64_t cap) {
  if (W <= 0 || H <= 0) return kErrSampling;
  const int mcux = ceil_div(W, 16), mcuy = ceil_div(H, 16);
  // luminance at (x, y) of its padded plane: the image's edge replicated
  const int lw = ceil_div(W, 8), lh = ceil_div(H, 8);   // real Y blocks
  const int cw = mcux * 8, ch = ceil_div(H, 2);          // chroma samples
  std::vector<uint8_t> Y, Cb, Cr, cb2, cr2;
  try {
    Y.resize(static_cast<size_t>(lw) * 8 * lh * 8);
    cb2.resize(static_cast<size_t>(cw) * mcuy * 8);
    cr2.resize(cb2.size());
    Cb.resize(static_cast<size_t>(W) * H);
    Cr.resize(Cb.size());
  } catch (...) {
    return kErrAlloc;
  }
  const int yw = lw * 8;
  const int64_t* t = tables().rgb_ycc;
  for (int y = 0; y < H; ++y) {
    const uint8_t* in = rgb + static_cast<size_t>(y) * W * 3;
    for (int x = 0; x < W; ++x) {
      int r = in[3 * x], g = in[3 * x + 1], b = in[3 * x + 2];
      Y[static_cast<size_t>(y) * yw + x] = static_cast<uint8_t>(
          (t[r] + t[256 + g] + t[512 + b]) >> 16);
      Cb[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(
          (t[768 + r] + t[1024 + g] + t[1280 + b]) >> 16);
      Cr[static_cast<size_t>(y) * W + x] = static_cast<uint8_t>(
          (t[1280 + r] + t[1536 + g] + t[1792 + b]) >> 16);
    }
    for (int x = W; x < yw; ++x)
      Y[static_cast<size_t>(y) * yw + x] = Y[static_cast<size_t>(y) * yw + W - 1];
  }
  for (int y = H; y < lh * 8; ++y)
    std::memcpy(&Y[static_cast<size_t>(y) * yw],
                &Y[static_cast<size_t>(H - 1) * yw], yw);
  // h2v2 downsampling with biases 1, 2, 1, 2, ... across a row; the
  // full-resolution chroma extended right and down by replication, then
  // the downsampled rows extended down to the MCU rows
  auto down = [&](const std::vector<uint8_t>& src, std::vector<uint8_t>& dst) {
    for (int y = 0; y < ch; ++y) {
      const uint8_t* r0 = &src[static_cast<size_t>(std::min(2 * y, H - 1)) * W];
      const uint8_t* r1 =
          &src[static_cast<size_t>(std::min(2 * y + 1, H - 1)) * W];
      for (int x = 0; x < cw; ++x) {
        int x0 = std::min(2 * x, W - 1), x1 = std::min(2 * x + 1, W - 1);
        dst[static_cast<size_t>(y) * cw + x] = static_cast<uint8_t>(
            (r0[x0] + r0[x1] + r1[x0] + r1[x1] + 1 + (x & 1)) >> 2);
      }
    }
    for (int y = ch; y < mcuy * 8; ++y)
      std::memcpy(&dst[static_cast<size_t>(y) * cw],
                  &dst[static_cast<size_t>(ch - 1) * cw], cw);
  };
  down(Cb, cb2);
  down(Cr, cr2);

  Recip rq[2][64];
  for (int tb = 0; tb < 2; ++tb)
    for (int k = 0; k < 64; ++k)
      rq[tb][k] = reciprocal(static_cast<uint32_t>(quant[64 * tb + k]) << 3);
  auto fdct_quant = [&](const uint8_t* src, int stride, int tb, int16_t* blk) {
    int32_t ws[64];
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) ws[8 * r + c] = src[r * stride + c] - 128;
    fdct_islow(ws);
    for (int k = 0; k < 64; ++k) {
      int x = ws[k];
      const Recip& q = rq[tb][k];
      uint32_t a = static_cast<uint32_t>(x < 0 ? -x : x);
      uint32_t v = static_cast<uint32_t>(
          (static_cast<uint64_t>((a + q.corr) & 0xFFFF) * q.recip) >>
          q.shift);
      blk[k] = static_cast<int16_t>(x < 0 ? -static_cast<int>(v)
                                          : static_cast<int>(v));
    }
  };
  HuffEnc dc[2], ac[2];
  build_huff_enc(huff, &dc[0]);
  build_huff_enc(huff + 272, &ac[0]);
  build_huff_enc(huff + 544, &dc[1]);
  build_huff_enc(huff + 816, &ac[1]);
  BitWriter bw{out, cap};
  int last[3] = {0, 0, 0};
  int16_t blk[4][64], cblk[64];
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      // the MCU's 2 x 2 luminance blocks; blocks past the image's last
      // block column or row are dummies: zero AC, the DC of the block
      // before them (left, or the MCU's last block above)
      for (int by = 0; by < 2; ++by) {
        for (int bx = 0; bx < 2; ++bx) {
          int gx = 2 * mx + bx, gy = 2 * my + by;
          int16_t* b = blk[2 * by + bx];
          if (gy >= lh) {
            std::memset(b, 0, 128);
            b[0] = blk[2 * by - 1][0];
          } else if (gx >= lw) {
            std::memset(b, 0, 128);
            b[0] = blk[2 * by + bx - 1][0];
          } else {
            fdct_quant(&Y[static_cast<size_t>(gy) * 8 * yw + gx * 8], yw, 0, b);
          }
        }
      }
      for (int k = 0; k < 4; ++k) encode_block(bw, blk[k], last[0], dc[0], ac[0]);
      fdct_quant(&cb2[static_cast<size_t>(my) * 8 * cw + mx * 8], cw, 1, cblk);
      encode_block(bw, cblk, last[1], dc[1], ac[1]);
      fdct_quant(&cr2[static_cast<size_t>(my) * 8 * cw + mx * 8], cw, 1, cblk);
      encode_block(bw, cblk, last[2], dc[1], ac[1]);
      if (bw.full) return kErrCapacity;
    }
  }
  bw.flush();
  if (bw.full) return kErrCapacity;
  return bw.n;
}

// ---- TIFF ----

// LZW as TIFF 6.0 section 13 writes it: codes MSB first, 256 = Clear, 257
// = EndOfInformation, 9 bits growing to 12, each width taking effect one
// code before the table fills it.  Returns the bytes written (at most
// cap), or a negative error.
int64_t ctc_lzw_decode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t cap) {
  static thread_local uint16_t prefix[4096];
  static thread_local uint8_t suffix[4096], first[4096];
  static thread_local uint16_t length[4096];
  for (int i = 0; i < 256; ++i) {
    prefix[i] = 0xFFFF;
    suffix[i] = first[i] = static_cast<uint8_t>(i);
    length[i] = 1;
  }
  int64_t pos = 0, o = 0;
  uint64_t acc = 0;
  int bits = 0;
  int width = 9, next = 258, prev = -1;
  for (;;) {
    while (bits < width && pos < n) {
      acc = (acc << 8) | in[pos++];
      bits += 8;
    }
    if (bits < width) break;
    bits -= width;
    int code = static_cast<int>((acc >> bits) & ((1u << width) - 1));
    if (code == 257) break;
    if (code == 256) {
      width = 9;
      next = 258;
      prev = -1;
      continue;
    }
    int cur;
    if (prev < 0) {
      if (code > 255) return kErrHuffCode;
      cur = code;
    } else {
      if (code > next || code == 256 || code == 257) return kErrHuffCode;
      int base = code < next ? code : prev;
      if (next < 4096) {
        prefix[next] = static_cast<uint16_t>(prev);
        suffix[next] = first[base];
        first[next] = first[prev];
        length[next] = static_cast<uint16_t>(length[prev] + 1);
        ++next;
      }
      cur = code;
    }
    int len = length[cur];
    if (o + len > cap) {
      // the strip holds more than its rows: keep what fits
      len = static_cast<int>(cap - o);
      if (len <= 0) break;
    }
    int c = cur;
    for (int skip = length[cur] - len; skip > 0; --skip) c = prefix[c];
    for (int i = len - 1; i >= 0; --i) {
      out[o + i] = suffix[c];
      c = prefix[c];
    }
    o += len;
    prev = cur;
    if (next >= 2047) width = 12;
    else if (next >= 1023) width = 11;
    else if (next >= 511) width = 10;
    else width = 9;
  }
  return o;
}

int64_t ctc_lzw_encode(const uint8_t* in, int64_t n, uint8_t* out,
                       int64_t cap) {
  const int HS = 1 << 13;
  static thread_local int32_t hkey[1 << 13];
  static thread_local uint16_t hval[1 << 13];
  int64_t o = 0;
  uint64_t acc = 0;
  int bits = 0;
  bool full = false;
  auto emit = [&](int code, int width) {
    acc = (acc << width) | static_cast<uint64_t>(code);
    bits += width;
    while (bits >= 8) {
      bits -= 8;
      if (o >= cap) {
        full = true;
        return;
      }
      out[o++] = static_cast<uint8_t>(acc >> bits);
    }
  };
  auto clear_table = [&]() { std::fill(hkey, hkey + HS, -1); };
  int width = 9, next = 258;
  clear_table();
  emit(256, width);
  if (n > 0) {
    int w = in[0];
    for (int64_t i = 1; i < n; ++i) {
      int c = in[i];
      int32_t key = (w << 8) | c;
      uint32_t h = (static_cast<uint32_t>(key) * 2654435761u) >> 19;
      int found = -1;
      while (hkey[h] != -1) {
        if (hkey[h] == key) {
          found = hval[h];
          break;
        }
        h = (h + 1) & (HS - 1);
      }
      if (found >= 0) {
        w = found;
        continue;
      }
      emit(w, width);
      hkey[h] = key;
      hval[h] = static_cast<uint16_t>(next);
      ++next;
      if (next == 4094) {
        emit(256, width);
        clear_table();
        next = 258;
        width = 9;
      } else if (next > (1 << width) - 1) {
        ++width;
      }
      w = c;
    }
    emit(w, width);
    ++next;
    if (next == 4094) {
      emit(256, width);
      width = 9;
    } else if (next > (1 << width) - 1) {
      ++width;
    }
  }
  emit(257, width);
  if (bits > 0) emit(0, 8 - bits);
  return full ? kErrCapacity : o;
}

// PackBits: a header n in [0, 127] copies n + 1 bytes, [-127, -1] repeats
// the next byte 1 - n times, -128 is skipped.
int64_t ctc_packbits_decode(const uint8_t* in, int64_t n, uint8_t* out,
                            int64_t cap) {
  int64_t i = 0, o = 0;
  while (i < n && o < cap) {
    int h = static_cast<int8_t>(in[i++]);
    if (h >= 0) {
      int64_t k = std::min<int64_t>(h + 1, std::min(n - i, cap - o));
      std::memcpy(out + o, in + i, k);
      i += h + 1;
      o += k;
    } else if (h != -128) {
      if (i >= n) break;
      int64_t k = std::min<int64_t>(1 - h, cap - o);
      std::memset(out + o, in[i++], k);
      o += k;
    }
  }
  return o;
}

}  // extern "C"
