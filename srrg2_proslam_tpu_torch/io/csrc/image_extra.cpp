// Image files the repo's native decoder (native/src/image_decode.cpp) does
// not read: JPEG (baseline, progressive and lossless Huffman, sequential
// and progressive arithmetic; gray, YCbCr / RGB, CMYK / YCCK; libjpeg's
// block smoothing of incomplete progressive files), PNG of every colour
// type, bit depth and interlace (palette, 1/2/4-bit, Adam7), BMP, and
// ``decode_any``, which tries PIL's plugins in its order (this file); TIFF
// (image_tiff.cpp, image_ccitt.cpp), GIF and PNM / PFM (image_gif_pnm.cpp),
// TGA, SGI / PCX, DDS, PSD, ICO / CUR, QOI, IM, the Sun raster / MSP /
// XBM / XPM / SPIDER readers and WebP (image_tga.cpp,
// image_sgi_pcx.cpp, image_dds.cpp, image_psd.cpp, image_ico.cpp,
// image_qoi.cpp, image_im.cpp, image_misc.cpp, image_webp.cpp); plus a
// baseline gray JPEG writer here and PIL's GIF writer for mode L in
// image_gif_pnm.cpp.
//
// Each decoder returns the samples in the mode PIL opens the file in (1,
// L, P, I;16, I;16B, I, F, LA, RGB, RGBA, CMYK), so that the caller can
// apply PIL's per-mode gray rule.  JPEG decodes bit for bit as
// libjpeg-turbo does in its 6.2 API with the default settings: the
// JDCT_ISLOW integer IDCT (jidctint.c), fancy upsampling (jdsample.c:
// h2v1 / h1v2 / h2v2 triangle filters, replication for other integral
// factors and for components at most 2 samples wide), jdcolor.c's
// fixed-point YCbCr -> RGB and YCCK -> CMYK (PIL then inverts CMYK),
// jdarith.c's arithmetic decoder and jdlossls.c's predictors.  The writer
// follows jfdctint.c, jcdctmgr.c's reciprocal quantisation, the Annex K
// Huffman tables and jcmarker.c's marker layout (JFIF APP0, DQT, SOF0,
// DHT, SOS).
//
// Refused with a message (the caller raises it as a ValueError):
// hierarchical JPEG, arithmetic-coded lossless JPEG, sample precision
// other than 8 (PIL refuses it too), 2-component JPEG, non-integral
// sampling ratios, subsampled lossless files and lossless files that
// would need a colour conversion (libjpeg-turbo refuses them), DNL; BMP
// headers, depths, compressions and bit-field layouts PIL does not read,
// RLE with a black / white palette and 1/4-bit files whose palette is the
// gray ramp.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>
#include <zlib.h>

#include "image_common.h"

namespace pslx {

std::vector<uint8_t> read_file(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) throw Error("cannot open the file");
  std::vector<uint8_t> out;
  uint8_t buf[1 << 16];
  size_t n;
  while ((n = std::fread(buf, 1, sizeof(buf), f)) > 0) out.insert(out.end(), buf, buf + n);
  std::fclose(f);
  return out;
}

}  // namespace pslx

namespace {

using namespace pslx;

// ===========================================================================
// JPEG decoder
// ===========================================================================

struct NaturalOrder {
  int k[64 + 16];  // zigzag index -> natural index; 16 guard entries of 63
  NaturalOrder() {
    int i = 0;
    for (int s = 0; s < 15; ++s) {
      if (s % 2 == 0) {
        for (int y = std::min(s, 7); y >= std::max(0, s - 7); --y) k[i++] = y * 8 + (s - y);
      } else {
        for (int y = std::max(0, s - 7); y <= std::min(s, 7); ++y) k[i++] = y * 8 + (s - y);
      }
    }
    for (; i < 80; ++i) k[i] = 63;
  }
};
const NaturalOrder kNatural;

struct HuffTable {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint16_t look[512];  // 9-bit lookahead: (length << 8) | symbol, 0 = slow path

  void derive() {
    int huffsize[257], huffcode[257], p = 0, code = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        huffsize[p] = l;
        huffcode[p++] = code++;
      }
      code <<= 1;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    std::memset(look, 0, sizeof(look));
    for (int i = 0; i < p; ++i) {
      if (huffsize[i] > 9) continue;
      int shift = 9 - huffsize[i];
      for (int j = 0; j < (1 << shift); ++j)
        look[(huffcode[i] << shift) | j] = uint16_t((huffsize[i] << 8) | vals[i]);
    }
  }
};

// Entropy-coded bits: 0xFF00 is a data 0xFF; at a marker the reader feeds
// zeros, as libjpeg does.
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint64_t buf = 0;
  int cnt = 0;
  bool marker = false;

  BitReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void fill() {
    while (cnt <= 56) {
      unsigned b = 0;
      if (!marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < n && d[q] == 0xFF) ++q;
          if (q < n && d[q] == 0) {
            pos = q + 1;
          } else {
            marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= uint64_t(b) << (56 - cnt);
      cnt += 8;
    }
  }
  unsigned peek(int k) {
    if (cnt < k) fill();
    return unsigned(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  int get(int k) {
    if (!k) return 0;
    unsigned v = peek(k);
    skip(k);
    return int(v);
  }
  // Skip to the next marker other than a stuffed byte; returns its code and
  // leaves pos just past it.
  int next_marker() {
    buf = 0;
    cnt = 0;
    marker = false;
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) throw Error("JPEG: the data ends inside a scan");
      int c = d[pos++];
      if (c != 0) return c;
    }
  }
  void restart(int expected) {
    int c = next_marker();
    if (c != 0xD0 + expected) throw Error("JPEG: restart marker out of sequence");
  }
};

inline int decode_huff(BitReader& br, const HuffTable& t) {
  unsigned e = t.look[br.peek(9)];
  if (e) {
    br.skip(int(e >> 8));
    return int(e & 0xFF);
  }
  for (int l = 10; l <= 16; ++l) {
    int code = int(br.peek(l));
    if (code <= t.maxcode[l]) {
      br.skip(l);
      return t.vals[(code + t.valoffset[l]) & 0xFF];
    }
  }
  throw Error("JPEG: corrupt Huffman data");
}

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int bw = 0, bh = 0;    // blocks stored per row / column (whole MCUs)
  int wib = 0, hib = 0;  // blocks holding image samples (a non-interleaved scan)
  int dw = 0, dh = 0;    // downsampled width and height
  int dc_tbl = 0, ac_tbl = 0;
  bool latched = false;
  uint16_t qt[64] = {};  // natural order, latched at the component's first scan
  std::vector<int16_t> coef;  // bw * bh blocks of 64, natural order
  int coef_bits[64] = {};
  std::vector<uint16_t> undiff;  // lossless: the reconstructed samples before the point transform
  int point_transform = 0;
  int16_t* block(int bx, int by) { return &coef[(size_t(by) * bw + bx) * 64]; }
};

// T.81 Table D.2 as jaricom.c packs it: (Qe << 16) | (Next_Index_MPS << 8)
// | (Switch_MPS << 7) | Next_Index_LPS; entry 113 is the fixed 0.5 estimate.
const uint32_t kAriTab[114] = {
#define V(qe, nmps, nlps, sw) ((uint32_t(qe) << 16) | (uint32_t(nmps) << 8) | ((sw) << 7) | (nlps))
    V(0x5a1d, 1, 1, 1),    V(0x2586, 2, 14, 0),   V(0x1114, 3, 16, 0),   V(0x080b, 4, 18, 0),
    V(0x03d8, 5, 20, 0),   V(0x01da, 6, 23, 0),   V(0x00e5, 7, 25, 0),   V(0x006f, 8, 28, 0),
    V(0x0036, 9, 30, 0),   V(0x001a, 10, 33, 0),  V(0x000d, 11, 35, 0),  V(0x0006, 12, 9, 0),
    V(0x0003, 13, 10, 0),  V(0x0001, 13, 12, 0),  V(0x5a7f, 15, 15, 1),  V(0x3f25, 16, 36, 0),
    V(0x2cf2, 17, 38, 0),  V(0x207c, 18, 39, 0),  V(0x17b9, 19, 40, 0),  V(0x1182, 20, 42, 0),
    V(0x0cef, 21, 43, 0),  V(0x09a1, 22, 45, 0),  V(0x072f, 23, 46, 0),  V(0x055c, 24, 48, 0),
    V(0x0406, 25, 49, 0),  V(0x0303, 26, 51, 0),  V(0x0240, 27, 52, 0),  V(0x01b1, 28, 54, 0),
    V(0x0144, 29, 56, 0),  V(0x00f5, 30, 57, 0),  V(0x00b7, 31, 59, 0),  V(0x008a, 32, 60, 0),
    V(0x0068, 33, 62, 0),  V(0x004e, 34, 63, 0),  V(0x003b, 35, 32, 0),  V(0x002c, 9, 33, 0),
    V(0x5ae1, 37, 37, 1),  V(0x484c, 38, 64, 0),  V(0x3a0d, 39, 65, 0),  V(0x2ef1, 40, 67, 0),
    V(0x261f, 41, 68, 0),  V(0x1f33, 42, 69, 0),  V(0x19a8, 43, 70, 0),  V(0x1518, 44, 72, 0),
    V(0x1177, 45, 73, 0),  V(0x0e74, 46, 74, 0),  V(0x0bfb, 47, 75, 0),  V(0x09f8, 48, 77, 0),
    V(0x0861, 49, 78, 0),  V(0x0706, 50, 79, 0),  V(0x05cd, 51, 48, 0),  V(0x04de, 52, 50, 0),
    V(0x040f, 53, 50, 0),  V(0x0363, 54, 51, 0),  V(0x02d4, 55, 52, 0),  V(0x025c, 56, 53, 0),
    V(0x01f8, 57, 54, 0),  V(0x01a4, 58, 55, 0),  V(0x0160, 59, 56, 0),  V(0x0125, 60, 57, 0),
    V(0x00f6, 61, 58, 0),  V(0x00cb, 62, 59, 0),  V(0x00ab, 63, 61, 0),  V(0x008f, 32, 61, 0),
    V(0x5b12, 65, 65, 1),  V(0x4d04, 66, 80, 0),  V(0x412c, 67, 81, 0),  V(0x37d8, 68, 82, 0),
    V(0x2fe8, 69, 83, 0),  V(0x293c, 70, 84, 0),  V(0x2379, 71, 86, 0),  V(0x1edf, 72, 87, 0),
    V(0x1aa9, 73, 87, 0),  V(0x174e, 74, 72, 0),  V(0x1424, 75, 72, 0),  V(0x119c, 76, 74, 0),
    V(0x0f6b, 77, 74, 0),  V(0x0d51, 78, 75, 0),  V(0x0bb6, 79, 77, 0),  V(0x0a40, 48, 77, 0),
    V(0x5832, 81, 80, 1),  V(0x4d1c, 82, 88, 0),  V(0x438e, 83, 89, 0),  V(0x3bdd, 84, 90, 0),
    V(0x34ee, 85, 91, 0),  V(0x2eae, 86, 92, 0),  V(0x299a, 87, 93, 0),  V(0x2516, 71, 86, 0),
    V(0x5570, 89, 88, 1),  V(0x4ca9, 90, 95, 0),  V(0x44d9, 91, 96, 0),  V(0x3e22, 92, 97, 0),
    V(0x3824, 93, 99, 0),  V(0x32b4, 94, 99, 0),  V(0x2e17, 86, 93, 0),  V(0x56a8, 96, 95, 1),
    V(0x4f46, 97, 101, 0), V(0x47e5, 98, 102, 0), V(0x41cf, 99, 103, 0), V(0x3c3d, 100, 104, 0),
    V(0x375e, 93, 99, 0),  V(0x5231, 102, 105, 0), V(0x4c0f, 103, 106, 0), V(0x4639, 104, 107, 0),
    V(0x415e, 99, 103, 0), V(0x5627, 106, 105, 1), V(0x50e7, 107, 108, 0), V(0x4b85, 103, 109, 0),
    V(0x5597, 109, 110, 0), V(0x504f, 107, 111, 0), V(0x5a10, 111, 110, 1), V(0x5522, 109, 112, 0),
    V(0x59eb, 111, 112, 1), V(0x5a1d, 113, 113, 0)
#undef V
};

// jdarith.c arith_decode over the scan's bytes: 0xFF00 is a data 0xFF; at
// a marker it feeds zeros, as libjpeg does.
struct ArithReader {
  const uint8_t* d;
  size_t n, pos;
  int64_t c = 0, a = 0;
  int ct = -16;
  bool marker = false;

  ArithReader(const uint8_t* data, size_t size, size_t start) : d(data), n(size), pos(start) {}

  void reset() {
    c = 0;
    a = 0;
    ct = -16;
  }
  int byte() {
    if (marker || pos >= n) return 0;
    int v = d[pos++];
    if (v != 0xFF) return v;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos < n && d[pos] == 0) {
      ++pos;
      return 0xFF;
    }
    marker = true;
    --pos;  // leave pos on the 0xFF of the marker
    return 0;
  }
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        c = (c << 8) | byte();
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t e = kAriTab[sv & 0x7F];
    int nl = int(e & 0xFF), nm = int((e >> 8) & 0xFF);
    int64_t qe = e >> 16;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
  // Skip to the next marker other than a stuffed byte; returns its code.
  int next_marker() {
    marker = false;
    for (;;) {
      while (pos < n && d[pos] != 0xFF) ++pos;
      while (pos < n && d[pos] == 0xFF) ++pos;
      if (pos >= n) throw Error("JPEG: the data ends inside a scan");
      int m = d[pos++];
      if (m != 0) return m;
    }
  }
};

struct JpegDecoder {
  const std::vector<uint8_t>& f;
  uint16_t qtables[4][64];
  bool qpresent[4] = {false, false, false, false};
  HuffTable dc[4], ac[4];
  int width = 0, height = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  bool progressive = false, lossless = false, arith = false, frame = false, jfif = false,
       adobe = false;
  int arith_dc_l[4] = {0, 0, 0, 0}, arith_dc_u[4] = {1, 1, 1, 1}, arith_ac_k[4] = {5, 5, 5, 5};
  uint8_t dc_stats[4][64], ac_stats[4][256];
  bool ac_error = false;  // jdarith.c's ct = -1 after a bad code: no more coefficients
  int adobe_transform = -1, restart_interval = 0;
  int color = JPEG_AS_MARKED;
  std::vector<Component> comps;

  JpegDecoder(const std::vector<uint8_t>& file, int color_handling)
      : f(file), color(color_handling) {}

  void read_frame(const uint8_t* p, size_t len, int marker) {
    if (frame) throw Error("JPEG: more than one frame");
    if (len < 6) throw Error("JPEG: short SOF");
    if (p[0] != 8) throw Error("JPEG: sample precision " + std::to_string(p[0]) +
                               " is not supported (8-bit only)");
    height = int(be16(p + 1));
    width = int(be16(p + 3));
    int nc = p[5];
    if (height == 0 || width == 0) throw Error("JPEG: zero image size (DNL is not supported)");
    if (nc != 1 && nc != 3 && nc != 4)
      throw Error("JPEG: " + std::to_string(nc) + " components are not supported "
                  "(gray, YCbCr / RGB, CMYK / YCCK only)");
    if (len < size_t(6 + 3 * nc)) throw Error("JPEG: short SOF");
    progressive = marker == 0xC2 || marker == 0xCA;
    lossless = marker == 0xC3;
    arith = marker == 0xC9 || marker == 0xCA;
    for (int i = 0; i < nc; ++i) {
      Component c;
      c.id = p[6 + 3 * i];
      c.h = p[7 + 3 * i] >> 4;
      c.v = p[7 + 3 * i] & 15;
      c.tq = p[8 + 3 * i] & 3;
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) throw Error("JPEG: bad sampling factor");
      comps.push_back(c);
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Error("JPEG: non-integral sampling ratios are not supported");
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.wib = (c.dw + 7) / 8;
      c.hib = (c.dh + 7) / 8;
      if (lossless) {
        if (c.h != 1 || c.v != 1) throw Error("JPEG: subsampled lossless files are not supported");
        c.undiff.assign(size_t(width) * height, 0);
      } else {
        c.coef.assign(size_t(c.bw) * c.bh * 64, 0);
      }
      for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
    }
    frame = true;
  }

  void read_dqt(const uint8_t* p, size_t len) {
    size_t i = 0;
    while (i < len) {
      int pq = p[i] >> 4, tq = p[i] & 15;
      if (tq > 3) throw Error("JPEG: bad DQT table index");
      size_t need = 1 + 64 * (pq ? 2 : 1);
      if (i + need > len) throw Error("JPEG: short DQT");
      for (int k = 0; k < 64; ++k)
        qtables[tq][kNatural.k[k]] = uint16_t(pq ? be16(p + i + 1 + 2 * k) : p[i + 1 + k]);
      qpresent[tq] = true;
      i += need;
    }
  }

  void read_dht(const uint8_t* p, size_t len) {
    size_t i = 0;
    while (i < len) {
      if (i + 17 > len) throw Error("JPEG: short DHT");
      int tc = p[i] >> 4, th = p[i] & 15;
      if (tc > 1 || th > 3) throw Error("JPEG: bad DHT table index");
      HuffTable& t = tc ? ac[th] : dc[th];
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += (t.bits[l] = p[i + l]);
      if (total > 256 || i + 17 + total > len) throw Error("JPEG: bad DHT");
      std::memcpy(t.vals, p + i + 17, size_t(total));
      t.derive();
      t.present = true;
      i += 17 + size_t(total);
    }
  }

  // jdhuff.c jpeg_make_d_derived_tbl: a DC table's symbols are bit counts
  static void check_dc_table(const HuffTable& t, int most) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += t.bits[l];
    for (int i = 0; i < total; ++i)
      if (t.vals[i] > most) throw Error("JPEG: bad Huffman table (a DC symbol above " +
                                        std::to_string(most) + ")");
  }

  // One scan: decode its MCUs; returns the position of the marker after it.
  size_t read_scan(const uint8_t* p, size_t len, size_t data_start) {
    if (!frame) throw Error("JPEG: SOS before SOF");
    int ns = p[0];
    if (ns < 1 || ns > 4 || len < size_t(4 + 2 * ns)) throw Error("JPEG: bad SOS");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = p[1 + 2 * i];
      Component* c = nullptr;
      for (auto& cc : comps)
        if (cc.id == id) c = &cc;
      if (!c) throw Error("JPEG: SOS names an unknown component");
      c->dc_tbl = p[2 + 2 * i] >> 4;
      c->ac_tbl = p[2 + 2 * i] & 15;
      if (c->dc_tbl > 3 || c->ac_tbl > 3) throw Error("JPEG: bad table index in SOS");
      sc.push_back(c);
    }
    int ss = p[1 + 2 * ns], se = p[2 + 2 * ns], ah = p[3 + 2 * ns] >> 4, al = p[3 + 2 * ns] & 15;
    if (lossless) return read_lossless_scan(sc, ss, al, data_start);
    if (progressive) {
      bool bad = ss > se || se > 63 || al > 13 || (ss == 0 && se != 0) || (ss > 0 && ns != 1);
      if (bad) throw Error("JPEG: bad progressive scan parameters");
    } else {
      ss = 0;
      se = 63;
      ah = al = 0;
    }
    for (auto* c : sc) {
      if (!c->latched) {
        if (!qpresent[c->tq]) throw Error("JPEG: missing quantisation table");
        std::memcpy(c->qt, qtables[c->tq], sizeof(c->qt));
        c->latched = true;
      }
      bool needs_dc = ss == 0 && ah == 0;
      bool needs_ac = se > 0;
      if (!arith && ((needs_dc && !dc[c->dc_tbl].present) || (needs_ac && !ac[c->ac_tbl].present)))
        throw Error("JPEG: missing Huffman table");
      if (!arith && needs_dc) check_dc_table(dc[c->dc_tbl], 15);
      for (int k = ss; k <= se; ++k) c->coef_bits[k] = al;
    }

    if (arith) return read_arith_scan(sc, ss, se, ah, al, data_start);
    BitReader br(f.data(), f.size(), data_start);
    int last_dc[4] = {0, 0, 0, 0};
    int eobrun = 0, restarts = 0;
    long units_x, units_y;
    if (ns == 1) {
      units_x = sc[0]->wib;
      units_y = sc[0]->hib;
    } else {
      units_x = mcux;
      units_y = mcuy;
    }
    long total = units_x * units_y;
    for (long u = 0; u < total; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        br.restart(restarts & 7);
        ++restarts;
        std::memset(last_dc, 0, sizeof(last_dc));
        eobrun = 0;
      }
      long ux = u % units_x, uy = u / units_x;
      if (ns == 1) {
        decode_block(br, *sc[0], sc[0]->block(int(ux), int(uy)), last_dc[0], eobrun, ss, se,
                     ah, al);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[size_t(i)];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx)
              decode_block(br, c, c.block(int(ux) * c.h + bx, int(uy) * c.v + by), last_dc[i],
                           eobrun, ss, se, ah, al);
        }
      }
    }
    // the marker that ends the scan (restart markers after the last MCU are skipped)
    for (;;) {
      int c = br.next_marker();
      if (c < 0xD0 || c > 0xD7) return br.pos - 2;
    }
  }

  // A lossless scan (jdlhuff.c, jdlossls.c): per sample a Huffman-coded
  // difference (SSSS 16: 32768) from the predictor ``psv`` of the left,
  // upper and upper-left samples (the first row predicts from the left,
  // the first column from above, the first sample 2^(7 - Pt)); samples
  // are kept mod 2^16 and come out shifted left by Pt.
  size_t read_lossless_scan(const std::vector<Component*>& sc, int psv, int pt,
                            size_t data_start) {
    if (psv < 1 || psv > 7 || pt > 7) throw Error("JPEG: bad lossless scan parameters");
    if (restart_interval) throw Error("JPEG: restart markers in a lossless file are not supported");
    for (auto* c : sc) {
      if (!dc[c->dc_tbl].present) throw Error("JPEG: missing Huffman table");
      check_dc_table(dc[c->dc_tbl], 16);
      c->latched = true;
      c->point_transform = pt;
    }
    BitReader br(f.data(), f.size(), data_start);
    const int w = width;
    for (int y = 0; y < height; ++y)
      for (int x = 0; x < w; ++x)
        for (auto* c : sc) {
          int s = decode_huff(br, dc[c->dc_tbl]);
          int diff = s == 0 ? 0 : (s == 16 ? 32768 : extend(br.get(s), s));
          uint16_t* u = c->undiff.data();
          size_t i = size_t(y) * w + x;
          int pred;
          if (y == 0) {
            pred = x == 0 ? (1 << (8 - pt - 1)) : u[i - 1];
          } else if (x == 0) {
            pred = u[i - w];
          } else {
            int ra = u[i - 1], rb = u[i - w], rc = u[i - w - 1];
            switch (psv) {
              case 1: pred = ra; break;
              case 2: pred = rb; break;
              case 3: pred = rc; break;
              case 4: pred = ra + rb - rc; break;
              case 5: pred = ra + ((rb - rc) >> 1); break;
              case 6: pred = rb + ((ra - rc) >> 1); break;
              default: pred = (ra + rb) >> 1; break;
            }
          }
          u[i] = uint16_t((diff + pred) & 0xFFFF);
        }
    for (;;) {
      int c = br.next_marker();
      if (c < 0xD0 || c > 0xD7) return br.pos - 2;
    }
  }

  // An arithmetic-coded scan (jdarith.c): statistics zeroed at its start
  // and at each restart, per table; sequential or the four progressive
  // scan kinds.
  size_t read_arith_scan(const std::vector<Component*>& sc, int ss, int se, int ah, int al,
                         size_t data_start) {
    ArithReader ar(f.data(), f.size(), data_start);
    int ns = int(sc.size());
    int last_dc[4] = {0, 0, 0, 0}, dc_context[4] = {0, 0, 0, 0};
    auto reset_stats = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (!progressive || (ss == 0 && ah == 0)) {
          std::memset(dc_stats[sc[size_t(i)]->dc_tbl], 0, 64);
          last_dc[i] = 0;
          dc_context[i] = 0;
        }
        if (!progressive || ss) std::memset(ac_stats[sc[size_t(i)]->ac_tbl], 0, 256);
      }
      ar.reset();
      ac_error = false;
    };
    reset_stats();
    long units_x = ns == 1 ? sc[0]->wib : mcux, units_y = ns == 1 ? sc[0]->hib : mcuy;
    long total = units_x * units_y;
    int restarts = 0;
    for (long u = 0; u < total; ++u) {
      if (restart_interval && u > 0 && u % restart_interval == 0) {
        int m = ar.next_marker();
        if (m != 0xD0 + (restarts & 7)) throw Error("JPEG: restart marker out of sequence");
        ++restarts;
        reset_stats();
      }
      long ux = u % units_x, uy = u / units_x;
      for (int i = 0; i < ns; ++i) {
        Component& c = *sc[size_t(i)];
        int nh = ns == 1 ? 1 : c.h, nv = ns == 1 ? 1 : c.v;
        for (int by = 0; by < nv; ++by)
          for (int bx = 0; bx < nh; ++bx) {
            int16_t* blk = ns == 1 ? c.block(int(ux), int(uy))
                                   : c.block(int(ux) * c.h + bx, int(uy) * c.v + by);
            if (ac_error) continue;
            if (!progressive) {
              arith_dc(ar, c, blk, last_dc[i], dc_context[i], 0);
              arith_ac_first(ar, c, blk, 1, 63, 0);
            } else if (ss == 0 && ah == 0) {
              arith_dc(ar, c, blk, last_dc[i], dc_context[i], al);
            } else if (ss == 0) {
              uint8_t fixed = 113;
              if (ar.decode(&fixed)) blk[0] = int16_t(blk[0] | (1 << al));
            } else if (ah == 0) {
              arith_ac_first(ar, c, blk, ss, se, al);
            } else {
              arith_ac_refine(ar, c, blk, ss, se, al);
            }
          }
      }
    }
    for (;;) {
      int m = ar.next_marker();
      if (m < 0xD0 || m > 0xD7) return ar.pos - 2;
    }
  }

  void arith_dc(ArithReader& ar, Component& c, int16_t* blk, int& last_dc, int& context, int al) {
    int tbl = c.dc_tbl;
    uint8_t* st = dc_stats[tbl] + context;
    if (ar.decode(st) == 0) {
      context = 0;
    } else {
      int sign = ar.decode(st + 1);
      st += 2 + sign;
      int m = ar.decode(st);
      if (m) {
        st = dc_stats[tbl] + 20;
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ac_error = true;
            return;
          }
          ++st;
        }
      }
      if (m < ((1 << arith_dc_l[tbl]) >> 1)) context = 0;
      else if (m > ((1 << arith_dc_u[tbl]) >> 1)) context = 12 + sign * 4;
      else context = 4 + sign * 4;
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      last_dc = (last_dc + v) & 0xFFFF;
    }
    blk[0] = int16_t(uint32_t(last_dc) << al);
  }

  void arith_ac_first(ArithReader& ar, Component& c, int16_t* blk, int ss, int se, int al) {
    int tbl = c.ac_tbl;
    uint8_t fixed = 113;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          ac_error = true;
          return;
        }
      }
      int sign = ar.decode(&fixed);
      st += 2;
      int m = ar.decode(st);
      if (m && ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= arith_ac_k[tbl] ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) {
            ac_error = true;
            return;
          }
          ++st;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ar.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural.k[k]] = int16_t(uint32_t(v) << al);
    }
  }

  void arith_ac_refine(ArithReader& ar, Component& c, int16_t* blk, int ss, int se, int al) {
    int tbl = c.ac_tbl;
    uint8_t fixed = 113;
    int p1 = 1 << al, m1 = -1 * (1 << al);
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kNatural.k[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && ar.decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural.k[k];
        if (*coef) {
          if (ar.decode(st + 2)) *coef = int16_t(*coef + (*coef < 0 ? m1 : p1));
          break;
        }
        if (ar.decode(st + 1)) {
          *coef = int16_t(ar.decode(&fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) {
          ac_error = true;
          return;
        }
      }
    }
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk, int& last_dc, int& eobrun,
                    int ss, int se, int ah, int al) {
    if (!progressive) {
      int s = decode_huff(br, dc[c.dc_tbl]);
      int diff = s ? extend(br.get(s), s) : 0;
      last_dc += diff;
      blk[0] = int16_t(last_dc);
      const HuffTable& t = ac[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        int rs = decode_huff(br, t);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural.k[k]] = int16_t(extend(br.get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (ss == 0) {  // DC scans
      if (ah == 0) {
        int s = decode_huff(br, dc[c.dc_tbl]);
        int diff = s ? extend(br.get(s), s) : 0;
        last_dc += diff;
        blk[0] = int16_t(uint32_t(last_dc) << al);
      } else if (br.get(1)) {
        blk[0] = int16_t(blk[0] | (1 << al));
      }
      return;
    }
    const HuffTable& t = ac[c.ac_tbl];
    if (ah == 0) {  // AC first pass
      if (eobrun > 0) {
        --eobrun;
        return;
      }
      for (int k = ss; k <= se; ++k) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          blk[kNatural.k[k]] = int16_t(uint32_t(extend(br.get(s), s)) << al);
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
    // AC refinement (jdphuff.c decode_mcu_AC_refine)
    int p1 = 1 << al, m1 = -1 * (1 << al);
    auto refine = [&](int16_t* coef) {  // a correction bit of a nonzero coefficient
      if (br.get(1) && (*coef & p1) == 0) *coef = int16_t(*coef + (*coef >= 0 ? p1 : m1));
    };
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int rs = decode_huff(br, t);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.get(r);
          break;
        }
        do {
          int16_t* coef = blk + kNatural.k[k];
          if (*coef != 0) {
            refine(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kNatural.k[k]] = int16_t(s);
      }
    }
    if (eobrun > 0) {
      for (; k <= se; ++k) {
        int16_t* coef = blk + kNatural.k[k];
        if (*coef != 0) refine(coef);
      }
      --eobrun;
    }
  }

  void parse() {
    if (f.size() < 4 || f[0] != 0xFF || f[1] != 0xD8) throw Error("not a JPEG file");
    size_t pos = 2;
    for (;;) {
      while (pos < f.size() && f[pos] != 0xFF) ++pos;  // garbage before a marker
      while (pos < f.size() && f[pos] == 0xFF) ++pos;
      if (pos >= f.size()) break;  // no EOI: decode what was read, as libjpeg warns and goes on
      int m = f[pos++];
      if (m == 0xD9) break;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      if (pos + 2 > f.size()) throw Error("JPEG: truncated marker segment");
      size_t len = be16(&f[pos]);
      if (len < 2 || pos + len > f.size()) throw Error("JPEG: truncated marker segment");
      const uint8_t* p = &f[pos + 2];
      size_t plen = len - 2;
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {
        read_frame(p, plen, m);
      } else if ((m >= 0xC5 && m <= 0xC7) || (m >= 0xCD && m <= 0xCF)) {
        throw Error("JPEG: hierarchical JPEG is not supported");
      } else if (m == 0xCB) {
        throw Error("JPEG: arithmetic-coded lossless JPEG is not supported");
      } else if (m == 0xCC) {  // DAC: arithmetic conditioning
        for (size_t i = 0; i + 1 < plen; i += 2) {
          int tc = p[i] >> 4, tb = p[i] & 15, v = p[i + 1];
          if (tb > 3) throw Error("JPEG: bad DAC table index");
          if (tc == 0) {
            arith_dc_l[tb] = v & 15;
            arith_dc_u[tb] = v >> 4;
            if (arith_dc_l[tb] > arith_dc_u[tb]) throw Error("JPEG: bad DAC value");
          } else {
            if (v < 1 || v > 63) throw Error("JPEG: bad DAC value");
            arith_ac_k[tb] = v;
          }
        }
      } else if (m == 0xC4) {
        read_dht(p, plen);
      } else if (m == 0xDB) {
        read_dqt(p, plen);
      } else if (m == 0xDD) {
        if (plen < 2) throw Error("JPEG: short DRI");
        restart_interval = int(be16(p));
      } else if (m == 0xDA) {
        pos = read_scan(p, plen, pos + len);
        continue;
      } else if (m == 0xE0) {
        if (plen >= 5 && !std::memcmp(p, "JFIF\0", 5)) jfif = true;
      } else if (m == 0xEE) {
        if (plen >= 12 && !std::memcmp(p, "Adobe", 5)) {
          adobe = true;
          adobe_transform = p[11];
        }
      } else if (m == 0xDC) {
        throw Error("JPEG: DNL is not supported");
      }
      pos += len;  // APPn, COM and other segments are skipped
    }
    if (!frame) throw Error("JPEG: no frame");
  }

  // jdcoefct.c smoothing_ok: a progressive file whose first nine AC
  // coefficients are not all complete in some component (every DC partly
  // known, the ten quantisers nonzero) is block-smoothed on output.
  bool smoothing_ok() const {
    if (!progressive) return false;
    bool useful = false;
    for (auto& c : comps) {
      for (int k : {0, 1, 8, 16, 9, 2, 3, 10, 17, 24})
        if (c.qt[k] == 0) return false;
      if (c.coef_bits[0] < 0) return false;
      for (int k = 1; k < 10; ++k) useful |= c.coef_bits[k] != 0;
    }
    return useful;
  }

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 3.1): each block's
  // missing low-frequency AC coefficients estimated from the DC values of
  // the 5 x 5 blocks around it (with DC interpolation when no AC bit is
  // known), the neighbours taken row by row as libjpeg's iMCU-row buffer
  // gives them; then the IDCT.
  void smooth_component(Component& c, uint8_t* plane, int stride, const uint8_t* range) {
    const int* cb = c.coef_bits;
    const bool change_dc = std::all_of(cb + 1, cb + 10, [](int v) { return v == -1; });
    const int64_t q00 = c.qt[0], q01 = c.qt[1], q10 = c.qt[8], q20 = c.qt[16], q11 = c.qt[9],
                  q02 = c.qt[2], q03 = change_dc ? c.qt[3] : 0, q12 = change_dc ? c.qt[10] : 0,
                  q21 = change_dc ? c.qt[17] : 0, q30 = change_dc ? c.qt[24] : 0;
    const int last_imcu = mcuy - 1, last_col = c.wib - 1;
    auto estimate = [](int64_t num, int64_t q, int al, bool limit) {
      int pred;
      if (num >= 0) {
        pred = int(((q << 7) + num) / (q << 8));
        if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((q << 7) - num) / (q << 8));
        if (limit && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return pred;
    };
    int16_t ws[64];
    for (int imcu = 0; imcu <= last_imcu; ++imcu) {
      int block_rows = c.v;
      if (imcu == last_imcu) {
        block_rows = c.hib % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      for (int br = 0; br < block_rows; ++br) {
        // libjpeg numbers the rows by this iMCU row's block count, so a short
        // last iMCU row sees fewer rows above and the rows before it may
        // reach into the padding rows below the image
        int row = imcu * c.v + br, at = imcu * block_rows + br, count = block_rows * mcuy;
        int prev = at > 0 ? row - 1 : row, next = at < count - 1 ? row + 1 : row;
        const int rows5[5] = {at > 1 ? row - 2 : prev, prev, row, next,
                              at < count - 2 ? row + 2 : next};
        auto dc = [&](int r, int col) { return int(c.block(col, rows5[r])[0]); };
        int d[5][5];  // d[r][k]: DC01..DC25, the columns clamped to the image's blocks
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, c.block(col, row), sizeof(ws));
          for (int r = 0; r < 5; ++r)
            for (int k = 0; k < 5; ++k)
              d[r][k] = dc(r, std::min(std::max(col + k - 2, 0), last_col));
#define DC(n) int64_t(d[((n) - 1) / 5][((n) - 1) % 5])
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            int64_t num = q00 * (change_dc
                ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) - 13 * DC(9) +
                   3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) + 3 * DC(15) -
                   3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20) - DC(21) - DC(22) +
                   DC(24) + DC(25))
                : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
            ws[1] = int16_t(estimate(num, q01, al, true));
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            int64_t num = q00 * (change_dc
                ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) + 13 * DC(7) +
                   38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) - 13 * DC(17) - 38 * DC(18) -
                   13 * DC(19) + DC(20) + DC(21) + 3 * DC(22) + 3 * DC(23) + 3 * DC(24) +
                   DC(25))
                : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
            ws[8] = int16_t(estimate(num, q10, al, true));
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            int64_t num = q00 * (change_dc
                ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) - 14 * DC(13) -
                   5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) + DC(23))
                : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
            ws[16] = int16_t(estimate(num, q20, al, true));
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            int64_t num = q00 * (change_dc
                ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) + DC(21) -
                   DC(25))
                : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) + DC(22) -
                   DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)));
            ws[9] = int16_t(estimate(num, q11, al, true));
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            int64_t num = q00 * (change_dc
                ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) - 14 * DC(13) +
                   7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) + 2 * DC(19))
                : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
            ws[2] = int16_t(estimate(num, q02, al, true));
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0) {
              int64_t num = q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) - DC(19));
              ws[3] = int16_t(estimate(num, q03, al, true));
            }
            if ((al = cb[7]) != 0 && ws[10] == 0) {
              int64_t num = q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) + 3 * DC(18) - DC(19));
              ws[10] = int16_t(estimate(num, q12, al, true));
            }
            if ((al = cb[8]) != 0 && ws[17] == 0) {
              int64_t num = q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) + DC(17) - DC(19));
              ws[17] = int16_t(estimate(num, q21, al, true));
            }
            if ((al = cb[9]) != 0 && ws[24] == 0) {
              int64_t num = q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) - 2 * DC(18) - DC(19));
              ws[24] = int16_t(estimate(num, q30, al, true));
            }
            int64_t num = q00 *
                (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) - 2 * DC(5) - 6 * DC(6) +
                 6 * DC(7) + 42 * DC(8) + 6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
                 152 * DC(13) + 42 * DC(14) - 8 * DC(15) - 6 * DC(16) + 6 * DC(17) +
                 42 * DC(18) + 6 * DC(19) - 6 * DC(20) - 2 * DC(21) - 6 * DC(22) -
                 8 * DC(23) - 6 * DC(24) - 2 * DC(25));
            ws[0] = int16_t(estimate(num, q00, 0, false));
          }
#undef DC
          idct_islow(ws, c.qt, &plane[size_t(row) * 8 * stride + size_t(col) * 8], stride, range);
        }
      }
    }
  }

  // jidctint.c jpeg_idct_islow
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride,
                         const uint8_t* range) {
    const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                  F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                  F2562 = 20995, F3072 = 25172;
    int ws[64];
    for (int c = 0; c < 8; ++c) {
      const int16_t* ip = in + c;
      const uint16_t* qp = q + c;
      int* wp = ws + c;
      if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
        int dc = (int(ip[0]) * int(qp[0])) * 4;
        for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
        continue;
      }
      int64_t z2 = int64_t(ip[16]) * qp[16], z3 = int64_t(ip[48]) * qp[48];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      z2 = int64_t(ip[0]) * qp[0];
      z3 = int64_t(ip[32]) * qp[32];
      int64_t tmp0 = (z2 + z3) * 8192, tmp1 = (z2 - z3) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = int64_t(ip[56]) * qp[56];
      tmp1 = int64_t(ip[40]) * qp[40];
      tmp2 = int64_t(ip[24]) * qp[24];
      tmp3 = int64_t(ip[8]) * qp[8];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 11;
      const int64_t rnd = int64_t(1) << (sh - 1);
      wp[0] = int((tmp10 + tmp3 + rnd) >> sh);
      wp[56] = int((tmp10 - tmp3 + rnd) >> sh);
      wp[8] = int((tmp11 + tmp2 + rnd) >> sh);
      wp[48] = int((tmp11 - tmp2 + rnd) >> sh);
      wp[16] = int((tmp12 + tmp1 + rnd) >> sh);
      wp[40] = int((tmp12 - tmp1 + rnd) >> sh);
      wp[24] = int((tmp13 + tmp0 + rnd) >> sh);
      wp[32] = int((tmp13 - tmp0 + rnd) >> sh);
    }
    for (int r = 0; r < 8; ++r) {
      const int* wp = ws + 8 * r;
      uint8_t* op = out + size_t(r) * stride;
      if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
        uint8_t v = range[((int64_t(wp[0]) + 16) >> 5) & 1023];
        for (int c = 0; c < 8; ++c) op[c] = v;
        continue;
      }
      int64_t z2 = wp[2], z3 = wp[6];
      int64_t z1 = (z2 + z3) * F0541;
      int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
      int64_t tmp0 = (int64_t(wp[0]) + wp[4]) * 8192, tmp1 = (int64_t(wp[0]) - wp[4]) * 8192;
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      tmp0 = wp[7];
      tmp1 = wp[5];
      tmp2 = wp[3];
      tmp3 = wp[1];
      z1 = tmp0 + tmp3;
      z2 = tmp1 + tmp2;
      z3 = tmp0 + tmp2;
      int64_t z4 = tmp1 + tmp3, z5 = (z3 + z4) * F1175;
      tmp0 *= F0298;
      tmp1 *= F2053;
      tmp2 *= F3072;
      tmp3 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      tmp0 += z1 + z3;
      tmp1 += z2 + z4;
      tmp2 += z2 + z3;
      tmp3 += z1 + z4;
      const int sh = 18;
      const int64_t rnd = int64_t(1) << (sh - 1);
      op[0] = range[((tmp10 + tmp3 + rnd) >> sh) & 1023];
      op[7] = range[((tmp10 - tmp3 + rnd) >> sh) & 1023];
      op[1] = range[((tmp11 + tmp2 + rnd) >> sh) & 1023];
      op[6] = range[((tmp11 - tmp2 + rnd) >> sh) & 1023];
      op[2] = range[((tmp12 + tmp1 + rnd) >> sh) & 1023];
      op[5] = range[((tmp12 - tmp1 + rnd) >> sh) & 1023];
      op[3] = range[((tmp13 + tmp0 + rnd) >> sh) & 1023];
      op[4] = range[((tmp13 - tmp0 + rnd) >> sh) & 1023];
    }
  }

  // jdsample.c: upsample one component plane to the full image size.
  static std::vector<uint8_t> upsample(const std::vector<uint8_t>& plane, int stride,
                                       const Component& c, int hmax, int vmax, int w, int h) {
    int hx = hmax / c.h, vx = vmax / c.v;
    std::vector<uint8_t> out(size_t(w) * h);
    auto px = [&](int x, int y) -> int { return plane[size_t(y) * stride + x]; };
    int last_x = c.dw - 1, last_y = c.dh - 1;
    bool fancy_h = c.dw > 2;
    for (int y = 0; y < h; ++y) {
      uint8_t* op = &out[size_t(y) * w];
      if (hx == 1 && vx == 1) {
        for (int x = 0; x < w; ++x) op[x] = uint8_t(px(x, y));
      } else if (hx == 2 && vx == 1 && fancy_h) {
        for (int x = 0; x < w; ++x) {
          int i = x >> 1, near = px(i, y) * 3;
          op[x] = uint8_t((x & 1) ? (near + px(std::min(i + 1, last_x), y) + 2) >> 2
                                  : (near + px(std::max(i - 1, 0), y) + 1) >> 2);
        }
      } else if (hx == 1 && vx == 2) {
        int i = y >> 1, far = (y & 1) ? std::min(i + 1, last_y) : std::max(i - 1, 0);
        int bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < w; ++x) op[x] = uint8_t((px(x, i) * 3 + px(x, far) + bias) >> 2);
      } else if (hx == 2 && vx == 2 && fancy_h) {
        int i = y >> 1, far = (y & 1) ? std::min(i + 1, last_y) : std::max(i - 1, 0);
        auto colsum = [&](int cx) { return px(cx, i) * 3 + px(cx, far); };
        for (int x = 0; x < w; ++x) {
          int j = x >> 1, cur = colsum(j) * 3;
          op[x] = uint8_t((x & 1) ? (cur + colsum(std::min(j + 1, last_x)) + 7) >> 4
                                  : (cur + colsum(std::max(j - 1, 0)) + 8) >> 4);
        }
      } else {  // replication (int_upsample, h2v1_upsample, h2v2_upsample)
        for (int x = 0; x < w; ++x) op[x] = uint8_t(px(x / hx, y / vx));
      }
    }
    return out;
  }

  Image finish() {
    // post-IDCT range limit (jdmaster.c prepare_range_limit_table), indexed by x & 1023
    uint8_t range[1024];
    for (int i = 0; i < 1024; ++i) {
      int x = (i < 512 ? i : i - 1024) + 128;
      range[i] = uint8_t(x < 0 ? 0 : (x > 255 ? 255 : x));
    }
    std::vector<std::vector<uint8_t>> planes;
    const bool smooth = smoothing_ok();
    for (auto& c : comps) {
      if (!c.latched) throw Error("JPEG: a component is in no scan");
      if (lossless) {
        std::vector<uint8_t> plane(c.undiff.size());
        for (size_t i = 0; i < plane.size(); ++i)
          plane[i] = uint8_t(c.undiff[i] << c.point_transform);
        planes.push_back(std::move(plane));
        continue;
      }
      int stride = c.bw * 8;
      std::vector<uint8_t> plane(size_t(stride) * c.bh * 8);
      for (int by = 0; by < c.bh; ++by)
        for (int bx = 0; bx < c.bw; ++bx)
          if (!smooth || by >= c.hib || bx >= c.wib)
            idct_islow(c.block(bx, by), c.qt, &plane[size_t(by) * 8 * stride + bx * 8], stride,
                       range);
      if (smooth) smooth_component(c, plane.data(), stride, range);
      planes.push_back(upsample(plane, stride, c, hmax, vmax, width, height));
    }
    Image img;
    img.w = width;
    img.h = height;
    if (comps.size() == 1) {
      img.mode = MODE_L;
      img.channels = 1;
      img.data = std::move(planes[0]);
      return img;
    }
    if (comps.size() == 4) {
      // jdapimin.c: CMYK unless an Adobe marker says YCCK (transform 2, or
      // any but 0); libjpeg hands over CMYK (jdcolor.c ycck_cmyk_convert)
      // and PIL's "CMYK;I" inverts every channel.
      bool ycck = adobe && adobe_transform != 0;
      if (lossless && ycck)  // libjpeg-turbo converts no colours in a lossless file
        throw Error("JPEG: a lossless YCCK file is not supported");
      img.mode = MODE_CMYK;
      img.channels = 4;
      const size_t n = size_t(width) * height;
      img.data.resize(n * 4);
      auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
      YccTables t;
      for (size_t i = 0; i < n; ++i) {
        uint8_t* o = &img.data[4 * i];
        if (ycck) {
          int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
          o[0] = clamp(y + t.cr_r[cr]);
          o[1] = clamp(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
          o[2] = clamp(y + t.cb_b[cb]);
        } else {
          for (int k = 0; k < 3; ++k) o[k] = uint8_t(255 - planes[size_t(k)][i]);
        }
        o[3] = uint8_t(255 - planes[3][i]);
      }
      return img;
    }
    // jdapimin.c default_decompress_parms: the colour space of 3 components
    bool ycc;
    if (color != JPEG_AS_MARKED) {
      ycc = color == JPEG_YCC;
    } else if (jfif) {
      ycc = true;
    } else if (adobe) {
      ycc = adobe_transform != 0;
    } else {
      ycc = !(comps[0].id == 82 && comps[1].id == 71 && comps[2].id == 66);
    }
    if (lossless && ycc) throw Error("JPEG: a lossless YCbCr file is not supported");
    img.mode = MODE_RGB;
    img.channels = 3;
    img.data.resize(size_t(width) * height * 3);
    const size_t n = size_t(width) * height;
    if (!ycc) {
      for (size_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) img.data[3 * i + k] = planes[size_t(k)][i];
      return img;
    }
    YccTables t;
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < n; ++i) {
      int y = planes[0][i], cb = planes[1][i], cr = planes[2][i];
      img.data[3 * i] = clamp(y + t.cr_r[cr]);
      img.data[3 * i + 1] = clamp(y + int((t.cb_g[cb] + t.cr_g[cr]) >> 16));
      img.data[3 * i + 2] = clamp(y + t.cb_b[cb]);
    }
    return img;
  }

  // jdcolor.c build_ycc_rgb_table
  struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
      auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
      for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = int((fix(1.40200) * x + 32768) >> 16);
        cb_b[i] = int((fix(1.77200) * x + 32768) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + 32768;
      }
    }
  };
};

Image decode_jpeg_impl(const std::vector<uint8_t>& file, int color) {
  JpegDecoder d(file, color);
  d.parse();
  return d.finish();
}

// ===========================================================================
// PNG decoder (every colour type, bit depth and interlace method)
// ===========================================================================

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void unfilter(uint8_t* rows, int n_rows, size_t stride, int bpp) {
  // rows: n_rows x (1 + stride) bytes, filtered in place to raw bytes
  const uint8_t* prev = nullptr;
  for (int y = 0; y < n_rows; ++y) {
    uint8_t* line = rows + size_t(y) * (stride + 1);
    uint8_t kind = line[0];
    uint8_t* cur = line + 1;
    for (size_t x = 0; x < stride; ++x) {
      int a = x >= size_t(bpp) ? cur[x - bpp] : 0;
      int b = prev ? prev[x] : 0;
      int c = (prev && x >= size_t(bpp)) ? prev[x - bpp] : 0;
      int v = cur[x];
      switch (kind) {
        case 0: break;
        case 1: v += a; break;
        case 2: v += b; break;
        case 3: v += (a + b) >> 1; break;
        case 4: v += paeth(a, b, c); break;
        default: throw Error("PNG: unknown filter type " + std::to_string(kind));
      }
      cur[x] = uint8_t(v);
    }
    prev = cur;
  }
}

Image decode_png(const std::vector<uint8_t>& file) {
  size_t pos = 8;
  uint32_t width = 0, height = 0;
  int depth = 0, color = 0, interlace = 0;
  std::vector<uint8_t> idat, plte;
  bool header = false;
  while (pos + 8 <= file.size()) {
    uint32_t len = be32(&file[pos]);
    if (pos + 12 + size_t(len) > file.size()) throw Error("PNG: truncated chunk");
    const uint8_t* type = &file[pos + 4];
    const uint8_t* data = &file[pos + 8];
    if (!std::memcmp(type, "IHDR", 4)) {
      if (len != 13) throw Error("PNG: bad IHDR");
      width = be32(data);
      height = be32(data + 4);
      depth = data[8];
      color = data[9];
      interlace = data[12];
      header = true;
    } else if (!std::memcmp(type, "PLTE", 4)) {
      plte.assign(data, data + len);
    } else if (!std::memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), data, data + len);
    } else if (!std::memcmp(type, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!header || !width || !height) throw Error("PNG: no image header");
  int nch;
  switch (color) {
    case 0: nch = 1; break;
    case 2: nch = 3; break;
    case 3: nch = 1; break;
    case 4: nch = 2; break;
    case 6: nch = 4; break;
    default: throw Error("PNG: unknown colour type " + std::to_string(color));
  }
  bool ok_depth = (color == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 ||
                                  depth == 16)) ||
                  (color == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                  ((color == 2 || color == 4 || color == 6) && (depth == 8 || depth == 16));
  if (!ok_depth) throw Error("PNG: bad bit depth " + std::to_string(depth));
  if (interlace > 1) throw Error("PNG: unknown interlace method");
  if (color == 3 && plte.empty()) throw Error("PNG: palette image without PLTE");

  struct Pass { int x0, y0, dx, dy; };
  const Pass adam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                         {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  const Pass whole[1] = {{0, 0, 1, 1}};
  const Pass* passes = interlace ? adam7 : whole;
  int n_passes = interlace ? 7 : 1;
  const int bits_pp = nch * depth;
  const int bpp = std::max(1, bits_pp / 8);
  size_t raw_size = 0;
  for (int p = 0; p < n_passes; ++p) {
    size_t pw = (width - passes[p].x0 + passes[p].dx - 1) / passes[p].dx;
    size_t ph = (height - passes[p].y0 + passes[p].dy - 1) / passes[p].dy;
    if (width <= uint32_t(passes[p].x0) || height <= uint32_t(passes[p].y0)) continue;
    raw_size += ph * (1 + (pw * bits_pp + 7) / 8);
  }
  std::vector<uint8_t> raw(raw_size);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
      raw_len != raw.size())
    throw Error("PNG: corrupt image data");

  // samples [H, W, nch] as 16-bit values before the mode conversion
  std::vector<uint16_t> s(size_t(width) * height * nch);
  size_t off = 0;
  for (int p = 0; p < n_passes; ++p) {
    if (width <= uint32_t(passes[p].x0) || height <= uint32_t(passes[p].y0)) continue;
    int pw = int((width - passes[p].x0 + passes[p].dx - 1) / passes[p].dx);
    int ph = int((height - passes[p].y0 + passes[p].dy - 1) / passes[p].dy);
    size_t stride = (size_t(pw) * bits_pp + 7) / 8;
    unfilter(&raw[off], ph, stride, bpp);
    for (int y = 0; y < ph; ++y) {
      const uint8_t* line = &raw[off + size_t(y) * (stride + 1) + 1];
      size_t oy = size_t(passes[p].y0 + y * passes[p].dy);
      for (int x = 0; x < pw; ++x) {
        size_t ox = size_t(passes[p].x0 + x * passes[p].dx);
        uint16_t* dst = &s[(oy * width + ox) * nch];
        for (int ch = 0; ch < nch; ++ch) {
          size_t i = size_t(x) * nch + ch;
          if (depth == 16) {
            dst[ch] = uint16_t((line[2 * i] << 8) | line[2 * i + 1]);
          } else if (depth == 8) {
            dst[ch] = line[i];
          } else {
            size_t bit = i * depth;
            dst[ch] = uint16_t((line[bit / 8] >> (8 - depth - bit % 8)) & ((1 << depth) - 1));
          }
        }
      }
    }
    off += size_t(ph) * (stride + 1);
  }

  Image img;
  img.w = int(width);
  img.h = int(height);
  const size_t n = size_t(width) * height;
  auto put8 = [&](int channels, int mode) {
    img.channels = channels;
    img.mode = mode;
    img.data.resize(n * channels);
  };
  if (color == 0 && depth == 16) {
    img.channels = 1;
    img.mode = MODE_I16;
    img.bitdepth = 16;
    img.data.resize(n * 2);
    std::memcpy(img.data.data(), s.data(), n * 2);
  } else if (color == 0) {  // 1 (0/1), or L scaled to 0..255 (x85, x17)
    put8(1, depth == 1 ? MODE_1 : MODE_L);
    int scale = depth == 1 ? 1 : 255 / ((1 << depth) - 1);
    for (size_t i = 0; i < n; ++i) img.data[i] = uint8_t(s[i] * scale);
  } else if (color == 3) {
    put8(1, MODE_P);
    for (size_t i = 0; i < n; ++i) img.data[i] = uint8_t(s[i]);
    img.palette.assign(plte.begin(), plte.begin() + (plte.size() / 3) * 3);
  } else if (color == 4 && depth == 8) {
    put8(2, MODE_LA);
    for (size_t i = 0; i < 2 * n; ++i) img.data[i] = uint8_t(s[i]);
  } else if (color == 4) {  // 16-bit gray + alpha opens as RGBA of the high bytes
    put8(4, MODE_RGBA);
    for (size_t i = 0; i < n; ++i) {
      uint8_t l = uint8_t(s[2 * i] >> 8);
      img.data[4 * i] = img.data[4 * i + 1] = img.data[4 * i + 2] = l;
      img.data[4 * i + 3] = uint8_t(s[2 * i + 1] >> 8);
    }
  } else {  // RGB / RGBA, 16-bit as the high bytes
    put8(nch, color == 2 ? MODE_RGB : MODE_RGBA);
    int shift = depth == 16 ? 8 : 0;
    for (size_t i = 0; i < n * nch; ++i) img.data[i] = uint8_t(s[i] >> shift);
  }
  return img;
}

// ===========================================================================
// BMP decoder, as BmpImagePlugin.py reads it: OS/2 (12-byte) and Windows
// (40 to 124-byte) headers; 1/4/8-bit palette files raw or RLE8 / RLE4;
// 16-bit (5-5-5, or 5-6-5 through bit fields), 24-bit and 32-bit files
// raw or with PIL's bit-field layouts.  A palette that is the identity
// gray ramp makes the file L (two entries black / white: 1), read with
// 8 (1) bits per pixel whatever the file's depth, as PIL does.
// ===========================================================================

Image decode_bmp(const std::vector<uint8_t>& file) {
  if (file.size() < 18) throw Error("BMP: truncated header");
  uint32_t offset = le32(&file[10]), hsize = le32(&file[14]);
  if (hsize != 12 && hsize != 40 && hsize != 52 && hsize != 56 && hsize != 64 && hsize != 108 &&
      hsize != 124)
    throw Error("BMP: header size " + std::to_string(hsize) + " is not supported");
  if (14 + size_t(hsize) > file.size()) throw Error("BMP: truncated header");
  const uint8_t* hd = &file[18];  // the header after its size field
  int64_t width, height;
  int bits;
  uint32_t compression = 0, colors = 0, masks[4] = {0, 0, 0, 0};
  bool top_down = false;
  size_t pal_at = 14 + hsize;
  int padding = 4;
  if (hsize == 12) {
    width = le16(hd);
    height = le16(hd + 2);
    bits = int(le16(hd + 6));
    padding = 3;
  } else {
    top_down = hd[7] == 0xFF;
    width = int32_t(le32(hd));
    height = top_down ? int64_t(4294967296LL) - int64_t(le32(hd + 4)) : int64_t(le32(hd + 4));
    bits = int(le16(hd + 10));
    compression = le32(hd + 12);
    colors = le32(hd + 28);
    if (compression == 3) {
      if (hsize >= 52) {
        int n = hsize >= 56 ? 4 : 3;
        for (int i = 0; i < n; ++i) masks[i] = le32(hd + 36 + 4 * i);
      } else {
        if (pal_at + 12 > file.size()) throw Error("BMP: truncated bit fields");
        for (int i = 0; i < 3; ++i) masks[i] = le32(&file[pal_at + 4 * size_t(i)]);
        pal_at += 12;
      }
    }
  }
  if (width <= 0 || height <= 0 || too_many_pixels(uint64_t(width), uint64_t(height)))
    throw Error("BMP: bad size");
  int w = int(width), h = int(height);
  if (colors == 0) colors = bits < 32 ? (uint32_t(1) << bits) : 0;
  if (offset == 14 + hsize && bits <= 8) offset += 4 * colors;
  // PIL's mode and raw mode: bits per pixel read and how each becomes samples
  enum { RAW_P, RAW_BGR15, RAW_BGR16, RAW_BGR, RAW_BYTES4 } raw;
  int mode, rawbits = bits, order[4] = {2, 1, 0, -1};  // 32-bit: byte of R, G, B, A
  if (bits == 1 || bits == 4 || bits == 8) {
    mode = MODE_P;
    raw = RAW_P;
  } else if (bits == 16) {
    mode = MODE_RGB;
    raw = RAW_BGR15;
  } else if (bits == 24) {
    mode = MODE_RGB;
    raw = RAW_BGR;
  } else if (bits == 32) {
    mode = MODE_RGB;
    raw = RAW_BYTES4;
  } else {
    throw Error("BMP: " + std::to_string(bits) + "-bit pixels are not supported");
  }
  if (compression == 3) {
    bool ok = false;
    if (bits == 32) {
      static const uint32_t layouts[8][4] = {
          {0xFF0000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0},
          {0xFF000000, 0xFF00, 0xFF, 0}, {0xFF000000, 0xFF0000, 0xFF00, 0xFF},
          {0xFF, 0xFF00, 0xFF0000, 0xFF000000}, {0xFF0000, 0xFF00, 0xFF, 0xFF000000},
          {0xFF000000, 0xFF00, 0xFF, 0xFF0000}, {0, 0, 0, 0}};
      for (auto& l : layouts) {
        if (std::memcmp(l, masks, sizeof(masks))) continue;
        ok = true;
        if (!masks[0] && !masks[1] && !masks[2] && !masks[3]) {
          order[0] = 2, order[1] = 1, order[2] = 0, order[3] = 3;  // BGRA
        } else {
          for (int c = 0; c < 4; ++c) {
            order[c] = -1;
            for (int k = 0; k < 4; ++k)
              if (masks[c] == (0xFFu << (8 * k))) order[c] = k;
          }
        }
        if (order[3] >= 0) mode = MODE_RGBA;
      }
    } else if (bits == 24) {
      ok = masks[0] == 0xFF0000 && masks[1] == 0xFF00 && masks[2] == 0xFF;
    } else if (bits == 16) {
      if (masks[0] == 0xF800 && masks[1] == 0x7E0 && masks[2] == 0x1F) {
        ok = true;
        raw = RAW_BGR16;
      } else {
        ok = masks[0] == 0x7C00 && masks[1] == 0x3E0 && masks[2] == 0x1F;
      }
    }
    if (!ok) throw Error("BMP: this bit-field layout is not supported");
  } else if (compression == 1 || compression == 2) {
    if (bits > 8) throw Error("BMP: RLE needs a palette file");
  } else if (compression != 0) {
    throw Error("BMP: compression " + std::to_string(compression) + " is not supported");
  }
  Image img;
  img.w = w;
  img.h = h;
  bool gray = false;
  if (mode == MODE_P) {
    if (colors == 0 || colors > 65536) throw Error("BMP: bad palette size");
    size_t avail = pal_at < file.size() ? file.size() - pal_at : 0;
    size_t have = std::min<size_t>(avail, size_t(padding) * colors);
    const uint8_t* pal = file.data() + pal_at;
    gray = true;
    for (uint32_t i = 0; i < colors; ++i) {
      uint32_t v = colors == 2 ? (i ? 255 : 0) : i;
      size_t at = size_t(i) * padding;
      if (at + 3 > have || pal[at] != v || pal[at + 1] != v || pal[at + 2] != v) gray = false;
    }
    if (gray) {
      mode = colors == 2 ? MODE_1 : MODE_L;
      rawbits = colors == 2 ? 1 : 8;
    } else {
      for (size_t i = 0; i + 3 <= have && i / padding < 256; i += size_t(padding)) {
        img.palette.push_back(pal[i + 2]);
        img.palette.push_back(pal[i + 1]);
        img.palette.push_back(pal[i]);
      }
    }
  }
  img.mode = mode;
  img.channels = mode == MODE_RGB ? 3 : (mode == MODE_RGBA ? 4 : 1);
  img.data.assign(size_t(w) * h * img.channels, 0);
  auto dst_row = [&](int r) { return top_down ? r : h - 1 - r; };  // file row r -> image row
  if (compression == 1 || compression == 2) {  // BmpRleDecoder
    if (mode == MODE_1) throw Error("BMP: RLE with a black / white palette is not supported");
    bool rle4 = compression == 2;
    std::vector<uint8_t> data;
    size_t want = size_t(w) * h, pos = offset, x = 0;
    while (data.size() < want) {
      if (pos + 2 > file.size()) break;
      int n = file[pos], byte = file[pos + 1];
      pos += 2;
      if (n) {
        if (x + size_t(n) > size_t(w)) n = int(x > size_t(w) ? 0 : size_t(w) - x);
        for (int i = 0; i < n; ++i)
          data.push_back(uint8_t(rle4 ? ((i % 2 == 0) ? byte >> 4 : byte & 15) : byte));
        x += size_t(n);
      } else if (byte == 0) {
        while (data.size() % size_t(w)) data.push_back(0);
        x = 0;
      } else if (byte == 1) {
        break;
      } else if (byte == 2) {
        if (pos + 2 > file.size()) break;
        pos += 2;  // PIL reads the delta from the two bytes after these
        if (pos + 2 > file.size()) throw Error("BMP: truncated RLE delta");
        size_t right = file[pos], up = file[pos + 1];
        pos += 2;
        data.insert(data.end(), right + up * size_t(w), 0);
        x = data.size() % size_t(w);
      } else {
        size_t count = rle4 ? size_t(byte) / 2 : size_t(byte);
        size_t got = std::min(count, file.size() - pos);
        for (size_t i = 0; i < got; ++i) {
          uint8_t b = file[pos + i];
          if (rle4) {
            data.push_back(uint8_t(b >> 4));
            data.push_back(uint8_t(b & 15));
          } else {
            data.push_back(b);
          }
        }
        pos += got;
        if (got < count) break;
        x += size_t(byte);
        if (pos % 2) ++pos;
      }
    }
    if (data.size() < want) throw Error("BMP: not enough RLE image data");
    for (int r = 0; r < h; ++r)
      std::memcpy(&img.data[size_t(dst_row(r)) * w], &data[size_t(r) * w], size_t(w));
    return img;
  }
  size_t stride = ((size_t(w) * bits + 31) >> 3) & ~size_t(3);
  size_t need = (size_t(w) * rawbits + 7) / 8;
  if (need > stride)  // PIL reads 8 bits per pixel on past each row (and past the file)
    throw Error("BMP: a " + std::to_string(bits) + "-bit file whose palette is the gray ramp "
                "is not supported");
  if (size_t(offset) > file.size() || stride * h > file.size() - offset)
    throw Error("BMP: truncated pixel data");
  for (int r = 0; r < h; ++r) {
    const uint8_t* row = &file[offset + stride * size_t(r)];
    uint8_t* d = &img.data[size_t(dst_row(r)) * w * img.channels];
    for (int x = 0; x < w; ++x) {
      if (img.channels == 1) {
        if (rawbits == 8) d[x] = row[x];
        else if (rawbits == 4) d[x] = uint8_t((row[x >> 1] >> ((x & 1) ? 0 : 4)) & 15);
        else d[x] = uint8_t((row[x >> 3] >> (7 - (x & 7))) & 1);
      } else if (raw == RAW_BGR15 || raw == RAW_BGR16) {
        uint32_t v = le16(row + 2 * x);
        uint8_t* o = d + 3 * x;
        if (raw == RAW_BGR15) {
          o[0] = uint8_t(((v >> 10) & 31) * 255 / 31);
          o[1] = uint8_t(((v >> 5) & 31) * 255 / 31);
        } else {
          o[0] = uint8_t(((v >> 11) & 31) * 255 / 31);
          o[1] = uint8_t(((v >> 5) & 63) * 255 / 63);
        }
        o[2] = uint8_t((v & 31) * 255 / 31);
      } else if (raw == RAW_BGR) {
        for (int c = 0; c < 3; ++c) d[3 * x + c] = row[3 * x + 2 - c];
      } else {
        for (int c = 0; c < img.channels; ++c) d[img.channels * x + c] = row[4 * x + order[c]];
      }
    }
  }
  return img;
}

// PIL's Image.open: the plugins in Image.ID order, each claiming a file
// its accept test passes (and, for the few below whose _open then declines
// files, only as far as that).  The port's formats are decoded; a file a
// format of PIL's the port does not read would claim is refused naming it.
// IM, IMT, IPTC, PCD and SPIDER have no accept test in PIL (their _open
// sniffs the header); the port sniffs as PIL does for IM and SPIDER.
Image decode_any(const std::vector<uint8_t>& file) {
  const uint8_t* p = file.data();
  const size_t n = file.size();
  auto starts = [&](const char* m, size_t len) { return n >= len && !std::memcmp(p, m, len); };
  auto le32_at = [&](size_t at) { return n >= at + 4 ? le32(p + at) : 0xFFFFFFFFu; };
  auto refuse = [](const char* format) -> Image {
    throw Error(std::string(format) + " files are not supported");
  };
  if (n >= 12 && !std::memcmp(p + 4, "ftyp", 4) &&
      (!std::memcmp(p + 8, "avif", 4) || !std::memcmp(p + 8, "avis", 4) ||
       !std::memcmp(p + 8, "mif1", 4) || !std::memcmp(p + 8, "msf1", 4)))
    return refuse("AVIF");
  if (starts("BLP1", 4) || starts("BLP2", 4)) return refuse("BLP");
  if (starts("BM", 2)) return decode_bmp(file);
  for (uint32_t size : {12u, 40u, 52u, 56u, 64u, 108u, 124u})
    if (le32_at(0) == size) return refuse("DIB");
  if (starts("BUFR", 4) || starts("ZCZC", 4)) return refuse("BUFR");
  if (starts("\0\0\2\0", 4) && n >= 6 && le16(p + 4) > 0) return decode_cur(file);
  if (n >= 12 && p[0] == 10 && (p[1] == 0 || p[1] == 2 || p[1] == 3 || p[1] == 5) &&
      le16(p + 8) + 1 > le16(p + 4) && le16(p + 10) + 1 > le16(p + 6))
    return decode_pcx(file);
  if (le32_at(0) == 987654321u) return refuse("DCX");
  if (starts("DDS ", 4)) return decode_dds(file);
  if (starts("%!PS", 4) || le32_at(0) == 0xC6D3D0C5u) return refuse("EPS");
  if (starts("SIMPLE", 6)) return refuse("FITS");
  if (n >= 16 && (le16(p + 4) == 0xAF11 || le16(p + 4) == 0xAF12) &&
      (le16(p + 14) == 0 || le16(p + 14) == 3))
    return refuse("FLI");
  if (starts("FTEX", 4)) return refuse("FTEX");
  if (n >= 8 && be32(p) >= 20 && (be32(p + 4) == 1 || be32(p + 4) == 2)) return refuse("GBR");
  if (starts("GIF87a", 6) || starts("GIF89a", 6)) return decode_gif(file);
  if (n >= 8 && starts("GRIB", 4) && p[7] == 1) return refuse("GRIB");
  if (starts("\x89HDF\r\n\x1a\n", 8)) return refuse("HDF5");
  if (starts("\x89PNG\r\n\x1a\n", 8)) return decode_png(file);
  if (starts("\xff\x4f\xff\x51", 4) || starts("\0\0\0\x0cjP  \r\n\x87\n", 12))
    return decode_j2k(file);
  if (starts("icns", 4)) return refuse("ICNS");
  if (starts("\0\0\1\0", 4) && n >= 6 && le16(p + 4) > 0) return decode_ico(file);
  if (im_header(file)) return decode_im(file);  // IM, by PIL's header test (no magic)
  if (starts("\xff\xd8\xff", 3)) return decode_jpeg_impl(file, JPEG_AS_MARKED);
  if (starts("\0\0\0\0\0\0\0\4", 8)) return refuse("McIdas");
  if (starts("\0\0\1\xb3", 4)) return refuse("MPEG");
  if (starts("II*\0", 4) || starts("MM\0*", 4) || starts("II+\0", 4) || starts("MM\0+", 4))
    return decode_tiff(file);
  if (starts("DanM", 4) || starts("LinS", 4)) return decode_msp(file);
  if (starts("\x80\xe8\0\0", 4)) return refuse("PIXAR");
  if (n >= 2 && p[0] == 'P' && p[1] && std::strchr("0123456fy", p[1])) return decode_pnm(file);
  if (starts("8BPS", 4)) return decode_psd(file);
  if (starts("qoif", 4)) return decode_qoi(file);
  if (n >= 2 && be16(p) == 474) return decode_sgi(file);
  if (spider_header(file)) return decode_spider(file);  // PIL's header test, no magic
  if (n >= 4 && be32(p) == 0x59A66A95u) return decode_sun(file);
  if (tga_header_valid(file)) return decode_tga(file);
  if (n >= 16 && starts("RIFF", 4) && !std::memcmp(p + 8, "WEBP", 4) &&
      (!std::memcmp(p + 12, "VP8 ", 4) || !std::memcmp(p + 12, "VP8L", 4) ||
       !std::memcmp(p + 12, "VP8X", 4)))
    return decode_webp(file);
  if (starts("\xd7\xcd\xc6\x9a\0\0", 6) || starts("\1\0\0\0", 4)) return refuse("WMF");
  size_t lead = 0;
  while (lead < n && std::strchr(" \t\n\r\v\f", p[lead]) && p[lead]) ++lead;
  if (n - lead >= 7 && !std::memcmp(p + lead, "#define", 7)) return decode_xbm(file);
  if (starts("/* XPM */", 9)) return decode_xpm(file);
  if (starts("P7 332", 6)) return refuse("XV thumbnail");
  throw Error("not an image file PIL identifies (JPEG, PNG, BMP, CUR, PCX, DDS, ICO, TIFF, "
              "GIF, JPEG 2000, IM, MSP, PNM, PFM, PSD, QOI, SGI, SPIDER, SUN, TGA, WebP, XBM "
              "and XPM are read)");
}

// ===========================================================================
// baseline gray JPEG writer
// ===========================================================================

const uint8_t kStdLumQuant[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
    0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
    0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18,
    0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39,
    0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57,
    0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92,
    0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7,
    0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3,
    0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8,
    0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
    0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
  uint32_t code[256] = {0};
  int size[256] = {0};
  EncTable(const uint8_t* bits, const uint8_t* vals) {
    int code_v = 0, p = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i) {
        code[vals[p]] = uint32_t(code_v++);
        size[vals[p++]] = l;
      }
      code_v <<= 1;
    }
  }
};

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int cnt = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  void put(uint32_t bits, int n) {
    acc = (acc << n) | (bits & ((uint32_t(1) << n) - 1));
    cnt += n;
    while (cnt >= 8) {
      uint8_t b = uint8_t(acc >> (cnt - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      cnt -= 8;
    }
  }
  void flush() {
    if (cnt) put(0x7F, 8 - cnt);  // fill the last byte with ones
  }
};

// jfdctint.c jpeg_fdct_islow on level-shifted samples
void fdct_islow(int* d) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return int((x + (int64_t(1) << (n - 1))) >> n); };
  for (int pass = 0; pass < 2; ++pass) {
    for (int i = 0; i < 8; ++i) {
      int step = pass ? 8 : 1;
      int* p = pass ? d + i : d + 8 * i;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2,
              tmp12 = tmp1 - tmp2;
      int sh = pass ? 13 + 2 : 13 - 2;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, 2);
        p[4 * step] = descale(tmp10 - tmp11, 2);
      } else {
        p[0] = int((tmp10 + tmp11) * 4);
        p[4 * step] = int((tmp10 - tmp11) * 4);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, sh);
      p[6 * step] = descale(z1 + tmp12 * -F1847, sh);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      p[7 * step] = descale(tmp4 + z1 + z3, sh);
      p[5 * step] = descale(tmp5 + z2 + z4, sh);
      p[3 * step] = descale(tmp6 + z2 + z3, sh);
      p[step] = descale(tmp7 + z1 + z4, sh);
    }
  }
}

// jcdctmgr.c compute_reciprocal (16-bit DCTELEM): divisor -> (reciprocal,
// correction, shift) so that q = ((|x| + corr) * recip) >> shift
void reciprocal(uint32_t divisor, uint32_t* recip, uint32_t* corr, int* shift) {
  if (divisor == 1) {
    *recip = 1;
    *corr = 0;
    *shift = 0;
    return;
  }
  int b = 0;
  while ((1u << (b + 1)) <= divisor) ++b;  // floor(log2(divisor))
  int r = 16 + b;
  uint64_t fq = (uint64_t(1) << r) / divisor, fr = (uint64_t(1) << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= divisor / 2) {
    ++c;
  } else {
    ++fq;
  }
  *recip = uint32_t(fq);
  *corr = c;
  *shift = r;
}

// PIL's default quality 75: jcparam.c's jpeg_quality_scaling gives 200 - 2 * 75 = 50 %.
std::vector<uint8_t> encode_jpeg_gray(const uint8_t* px, int w, int h) {
  const long scale = 50;
  uint16_t q[64];  // natural order
  for (int i = 0; i < 64; ++i) {
    long t = (long(kStdLumQuant[i]) * scale + 50) / 100;
    q[i] = uint16_t(std::max(1L, std::min(255L, t)));
  }
  uint32_t recip[64], corr[64];
  int shift[64];
  for (int i = 0; i < 64; ++i) reciprocal(uint32_t(q[i]) << 3, &recip[i], &corr[i], &shift[i]);

  std::vector<uint8_t> out;
  auto put16 = [&](int v) {
    out.push_back(uint8_t(v >> 8));
    out.push_back(uint8_t(v & 0xFF));
  };
  const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  out.insert(out.end(), jfif, jfif + sizeof(jfif));
  out.push_back(0xFF);
  out.push_back(0xDB);
  put16(67);
  out.push_back(0x00);
  for (int k = 0; k < 64; ++k) out.push_back(uint8_t(q[kNatural.k[k]]));
  const uint8_t sof[] = {0xFF, 0xC0, 0x00, 0x0B, 0x08};
  out.insert(out.end(), sof, sof + sizeof(sof));
  put16(h);
  put16(w);
  out.push_back(1);
  out.push_back(1);
  out.push_back(0x11);
  out.push_back(0);
  auto dht = [&](int index, const uint8_t* bits, const uint8_t* vals) {
    int total = 0;
    for (int l = 1; l <= 16; ++l) total += bits[l];
    out.push_back(0xFF);
    out.push_back(0xC4);
    put16(2 + 1 + 16 + total);
    out.push_back(uint8_t(index));
    out.insert(out.end(), bits + 1, bits + 17);
    out.insert(out.end(), vals, vals + total);
  };
  dht(0x00, kDcLumBits, kDcLumVals);
  dht(0x10, kAcLumBits, kAcLumVals);
  const uint8_t sos[] = {0xFF, 0xDA, 0x00, 0x08, 0x01, 0x01, 0x00, 0x00, 0x3F, 0x00};
  out.insert(out.end(), sos, sos + sizeof(sos));

  const EncTable dct(kDcLumBits, kDcLumVals), act(kAcLumBits, kAcLumVals);
  BitWriter bw(out);
  int last_dc = 0;
  auto nbits = [](int v) {
    int n = 0;
    while (v) {
      ++n;
      v >>= 1;
    }
    return n;
  };
  int bw_blocks = (w + 7) / 8, bh_blocks = (h + 7) / 8;
  for (int by = 0; by < bh_blocks; ++by) {
    for (int bx = 0; bx < bw_blocks; ++bx) {
      int d[64], coef[64];
      for (int y = 0; y < 8; ++y)
        for (int x = 0; x < 8; ++x) {  // edge replication pads the last block
          int sy = std::min(by * 8 + y, h - 1), sx = std::min(bx * 8 + x, w - 1);
          d[8 * y + x] = int(px[size_t(sy) * w + sx]) - 128;
        }
      fdct_islow(d);
      for (int i = 0; i < 64; ++i) {
        int t = d[i];
        bool neg = t < 0;
        uint32_t a = uint32_t(neg ? -t : t);
        int v = int((uint64_t(a + corr[i]) * recip[i]) >> shift[i]);
        coef[i] = neg ? -v : v;
      }
      int diff = coef[0] - last_dc;
      last_dc = coef[0];
      int t = diff < 0 ? -diff : diff, t2 = diff < 0 ? diff - 1 : diff, n = nbits(t);
      bw.put(dct.code[n], dct.size[n]);
      if (n) bw.put(uint32_t(t2), n);
      int run = 0;
      for (int k = 1; k < 64; ++k) {
        int c = coef[kNatural.k[k]];
        if (c == 0) {
          ++run;
          continue;
        }
        while (run > 15) {
          bw.put(act.code[0xF0], act.size[0xF0]);
          run -= 16;
        }
        t = c < 0 ? -c : c;
        t2 = c < 0 ? c - 1 : c;
        n = nbits(t);
        int sym = (run << 4) + n;
        bw.put(act.code[sym], act.size[sym]);
        bw.put(uint32_t(t2), n);
        run = 0;
      }
      if (run > 0) bw.put(act.code[0], act.size[0]);
    }
  }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void set_error(char* err, int err_len, const char* msg) {
  if (err && err_len > 0) {
    std::strncpy(err, msg, size_t(err_len) - 1);
    err[err_len - 1] = 0;
  }
}

uint8_t* to_malloc(const std::vector<uint8_t>& v) {
  uint8_t* out = static_cast<uint8_t*>(std::malloc(std::max<size_t>(v.size(), 1)));
  if (out && !v.empty()) std::memcpy(out, v.data(), v.size());
  return out;
}

}  // namespace

namespace pslx {
Image decode_jpeg(const std::vector<uint8_t>& file, int color) {
  return decode_jpeg_impl(file, color);
}
Image decode_bmp_image(const std::vector<uint8_t>& file) { return decode_bmp(file); }
Image decode_png_image(const std::vector<uint8_t>& file) { return decode_png(file); }
}  // namespace pslx

extern "C" {

// Decode a JPEG, PNG or BMP file.  Returns a malloc'd interleaved sample
// buffer (free with pslx_free) and its shape, bit depth and mode (0 "1",
// 1 "L", 2 "P", 3 "I;16", 4 "LA", 5 "RGB", 6 "RGBA"); mode P fills
// palette (up to 768 bytes of RGB) and *palette_len.  On failure returns
// nullptr with the reason in err.
uint8_t* pslx_decode_file(const char* path, int* w, int* h, int* channels, int* bitdepth,
                          int* mode, uint8_t* palette, int* palette_len, char* err,
                          int err_len) {
  try {
    Image img = decode_any(read_file(path));
    *w = img.w;
    *h = img.h;
    *channels = img.channels;
    *bitdepth = img.bitdepth;
    *mode = img.mode;
    *palette_len = int(std::min<size_t>(img.palette.size(), 768));
    if (*palette_len) std::memcpy(palette, img.palette.data(), size_t(*palette_len));
    uint8_t* out = to_malloc(img.data);
    if (!out) set_error(err, err_len, "out of memory");
    return out;
  } catch (const std::exception& e) {
    set_error(err, err_len, e.what());
    return nullptr;
  }
}

// A gray [h, w] uint8 image -> a baseline JPEG at quality 75 (malloc'd
// bytes, *size set), or nullptr.
uint8_t* pslx_encode_jpeg_gray(const uint8_t* pixels, int w, int h, int* size) {
  try {
    std::vector<uint8_t> out = encode_jpeg_gray(pixels, w, h);
    *size = int(out.size());
    return to_malloc(out);
  } catch (const std::exception&) {
    return nullptr;
  }
}

// A gray [h, w] uint8 image -> the GIF PIL writes for mode L (malloc'd
// bytes, *size set), or nullptr.
uint8_t* pslx_encode_gif_gray(const uint8_t* pixels, int w, int h, int* size) {
  try {
    std::vector<uint8_t> out = encode_gif_gray(pixels, w, h);
    *size = int(out.size());
    return to_malloc(out);
  } catch (const std::exception&) {
    return nullptr;
  }
}

void pslx_free(void* p) { std::free(p); }

}  // extern "C"
