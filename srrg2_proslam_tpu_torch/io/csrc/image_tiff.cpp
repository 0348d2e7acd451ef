// TIFF, the first image of the file, as PIL 12 reads it (its own raw
// decoder for uncompressed files, libtiff 4.7 for the others): strips or
// tiles, planar configuration 1 (2 for 8-bit samples); no compression,
// PackBits, LZW and Deflate / AdobeDeflate; horizontal differencing
// (predictor 2) at 8, 16 and 32 bits and the floating-point predictor (3)
// for 32-bit floats.  The samples come out in the mode of PIL's OPEN_INFO
// table (TiffImagePlugin.py) for the file's photometric interpretation,
// sample format, bits per sample and extra samples: MinIsWhite / MinIsBlack
// at 1/2/4/8 bits ("1", "L", inverted for MinIsWhite), 16-bit unsigned
// ("I;16", "I;16B" in a big-endian file), 16- and 32-bit integers ("I"),
// 32-bit float ("F"), gray + alpha ("LA"), RGB / RGBA at 8 and 16 bits
// (16-bit samples keep their high byte; associated alpha is divided out as
// PIL's "RGBa" unpacker does), palette ("P", the colour map's high bytes)
// and CMYK; 12-bit gray (little-endian files, "I;16" holding the 12-bit
// values), LAB ("LAB", the stored bytes) and YCbCr: JPEG-compressed
// files (compression 7, JPEGTables merged ahead of each strip or tile)
// through image_extra.cpp's JPEG decoder as libjpeg converts them to RGB
// for libtiff's JPEGCOLORMODE_RGB, the other compressions through
// libtiff's TIFFRGBAImage conversion (tif_color.c's tables from
// ReferenceBlackWhite and the luma coefficients, chroma replicated over each
// subsampling block), and uncompressed ones as PIL's raw decoder reads them
// (four bytes a pixel, "RGBX").  CCITT RLE / Group 3 / Group 4 bilevel data
// decodes in image_ccitt.cpp, LZMA (34925, libtiff's xz streams) in
// image_lzma.cpp, ZSTD (50000, Zstandard frames) in image_zstd.cpp.
// Little-endian BigTIFF files (magic 43) are read too.  Fill order 2
// reverses the bits of every stored byte first (for the layouts PIL has a
// fill-order-2 mode for); the orientation tag is applied last, as
// PIL's exif_transpose does.  Planar configuration 2 at 16 bits keeps each
// sample's high byte when compressed, and takes the plane's bytes one per
// pixel when uncompressed (PIL's per-band 8-bit unpacker).  Refused with a
// message: old-style JPEG, WebP and the other compressions, and
// any layout PIL has no mode for (in a big-endian file also 16-bit
// MinIsWhite, 32-bit unsigned and 12-bit samples).  PIL unpacks libtiff's
// host-order output of a compressed big-endian file's signed and float
// samples as big-endian, so their bytes come out swapped; so do they here.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <vector>
#include <zlib.h>

#include "image_common.h"

namespace pslx {
namespace {

const int kTypeSize[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};

struct Field {
  uint32_t type = 0;
  uint64_t count = 0;
  size_t at = 0;  // position of the values in the file
};

struct TiffFile {
  const std::vector<uint8_t>& f;
  bool be = false, big = false;
  std::vector<std::pair<uint32_t, Field>> tags;

  explicit TiffFile(const std::vector<uint8_t>& file) : f(file) {}

  void need(size_t p, size_t n) const {
    if (p > f.size() || n > f.size() - p) throw Error("TIFF: truncated file");
  }
  uint32_t u16(size_t p) const {
    need(p, 2);
    return be ? be16(&f[p]) : le16(&f[p]);
  }
  uint32_t u32(size_t p) const {
    need(p, 4);
    return be ? be32(&f[p]) : le32(&f[p]);
  }
  uint64_t u64(size_t p) const {
    need(p, 8);
    uint64_t a = u32(p), b = u32(p + 4);
    return be ? (a << 32) | b : (b << 32) | a;
  }

  void parse() {
    if (f.size() < 8) throw Error("TIFF: truncated header");
    if (f[0] == 'M' && f[1] == 'M') {
      be = true;
    } else if (!(f[0] == 'I' && f[1] == 'I')) {
      throw Error("not a TIFF file");
    }
    uint32_t magic = u16(2);
    if (magic != 42 && magic != 43) throw Error("not a TIFF file");
    big = magic == 43;  // BigTIFF: 8-byte offsets and counts, 20-byte entries
    // PIL tells BigTIFF by the third byte, so a big-endian one ("MM\0+")
    // is parsed as a classic file from offset 0x80000 and fails
    if (big && be) throw Error("BigTIFF: a big-endian BigTIFF is not supported (PIL reads none)");
    if (big && (u16(4) != 8 || u16(6) != 0)) throw Error("BigTIFF: bad header");
    uint64_t ifd64 = big ? u64(8) : u32(4);
    if (ifd64 > f.size()) throw Error("TIFF: truncated file");
    size_t ifd = size_t(ifd64);
    uint64_t n = big ? u64(ifd) : u16(ifd);
    size_t entry = big ? 20 : 12, first = ifd + (big ? 8 : 2), inline_bytes = big ? 8 : 4;
    if (n > f.size() / entry) throw Error("TIFF: truncated file");
    for (uint64_t i = 0; i < n; ++i) {
      size_t e = first + entry * size_t(i);
      Field fl;
      uint32_t tag = u16(e);
      fl.type = u16(e + 2);
      fl.count = big ? u64(e + 4) : u32(e + 4);
      size_t value_at = e + (big ? 12 : 8);
      if (fl.type == 0 || fl.type > 18 || !kTypeSize[fl.type]) continue;
      if (fl.count > f.size()) throw Error("TIFF: truncated file");
      uint64_t bytes = uint64_t(kTypeSize[fl.type]) * fl.count;
      fl.at = bytes <= inline_bytes ? value_at : size_t(big ? u64(value_at) : u32(value_at));
      if (bytes > f.size()) throw Error("TIFF: truncated file");
      need(fl.at, size_t(bytes));
      tags.emplace_back(tag, fl);
    }
  }

  const Field* find(uint32_t tag) const {
    for (auto& t : tags)
      if (t.first == tag) return &t.second;
    return nullptr;
  }

  std::vector<uint64_t> values(uint32_t tag) const {
    std::vector<uint64_t> out;
    const Field* fl = find(tag);
    if (!fl) return out;
    for (uint64_t i = 0; i < fl->count; ++i) {
      size_t p = fl->at + size_t(i) * kTypeSize[fl->type];
      switch (fl->type) {
        case 1: case 6: case 7: out.push_back(f[p]); break;
        case 3: case 8: out.push_back(u16(p)); break;
        case 4: case 9: case 13: out.push_back(u32(p)); break;
        case 16: case 17: case 18: out.push_back(u64(p)); break;
        default: throw Error("TIFF: tag " + std::to_string(tag) + " has a non-integer type");
      }
    }
    return out;
  }

  uint64_t value(uint32_t tag, uint64_t fallback) const {
    auto v = values(tag);
    return v.empty() ? fallback : v[0];
  }

  // RATIONAL / FLOAT / integer values as libtiff stores them for float tags
  std::vector<float> floats(uint32_t tag) const {
    std::vector<float> out;
    const Field* fl = find(tag);
    if (!fl) return out;
    for (uint64_t i = 0; i < fl->count; ++i) {
      size_t p = fl->at + size_t(i) * kTypeSize[fl->type];
      if (fl->type == 5) {
        uint32_t num = u32(p), den = u32(p + 4);
        out.push_back(num == 0 || den == 0 ? 0.0f : float(double(num) / double(den)));
      } else if (fl->type == 11) {
        uint32_t bits = u32(p);
        float v;
        std::memcpy(&v, &bits, 4);
        out.push_back(v);
      } else if (fl->type == 3 || fl->type == 4) {
        out.push_back(float(fl->type == 3 ? u16(p) : u32(p)));
      } else {
        throw Error("TIFF: tag " + std::to_string(tag) + " has an unexpected type");
      }
    }
    return out;
  }

  // an UNDEFINED / BYTE tag's bytes (JPEGTables)
  std::vector<uint8_t> bytes_of(uint32_t tag) const {
    const Field* fl = find(tag);
    if (!fl || kTypeSize[fl->type] != 1) return {};
    return std::vector<uint8_t>(f.begin() + long(fl->at), f.begin() + long(fl->at + fl->count));
  }
};

std::string join(const std::vector<uint64_t>& v) {
  std::string s;
  for (size_t i = 0; i < v.size(); ++i) s += (i ? "," : "") + std::to_string(v[i]);
  return s;
}

// ---- decompression ---------------------------------------------------------

std::vector<uint8_t> unpack_bits(const uint8_t* p, size_t n, size_t want) {
  std::vector<uint8_t> out;
  out.reserve(want);
  size_t i = 0;
  while (i < n && out.size() < want) {
    int c = int8_t(p[i++]);
    if (c >= 0) {
      size_t k = std::min<size_t>(size_t(c) + 1, n - i);
      out.insert(out.end(), p + i, p + i + k);
      i += k;
    } else if (c != -128) {
      if (i >= n) break;
      out.insert(out.end(), size_t(1 - c), p[i++]);
    }
  }
  if (out.size() > want) out.resize(want);
  return out;
}

// libtiff's LZWDecode: MSB-first codes of 9 to 12 bits, the width
// growing one code early; 256 clears the table, 257 ends the strip.  A
// strip starting 0x00 then a byte with its low bit set is old-style LZW
// (LZWDecodeCompat): LSB-first codes, the width growing when the table
// reaches it.
std::vector<uint8_t> unlzw(const uint8_t* p, size_t n, size_t want) {
  const bool compat = n >= 2 && p[0] == 0 && (p[1] & 1);
  const int early = compat ? 0 : 1;
  const int table = 4096 + 1024;  // libtiff's CSIZE
  std::vector<int> prefix(table, -1);
  std::vector<uint8_t> suffix(table), first(table);
  for (int i = 0; i < 256; ++i) suffix[size_t(i)] = first[size_t(i)] = uint8_t(i);
  std::vector<uint8_t> out;
  out.reserve(want);
  std::vector<uint8_t> stack;
  size_t bitpos = 0, nbits_total = n * 8;
  int width = 9, free_ent = 258, old = -1;
  auto get = [&](int k) -> int {
    if (bitpos + size_t(k) > nbits_total) return -1;
    int v = 0;
    for (int b = 0; b < k; ++b, ++bitpos) {
      int bit = compat ? (p[bitpos >> 3] >> (bitpos & 7)) & 1
                       : (p[bitpos >> 3] >> (7 - (bitpos & 7))) & 1;
      v = compat ? v | (bit << b) : (v << 1) | bit;
    }
    return v;
  };
  auto emit = [&](int code) {
    stack.clear();
    for (int c = code; c >= 0; c = prefix[size_t(c)]) stack.push_back(suffix[size_t(c)]);
    for (size_t i = stack.size(); i-- > 0 && out.size() < want;) out.push_back(stack[i]);
  };
  while (out.size() < want) {
    int code = get(width);
    if (code < 0 || code == 257) break;
    if (code == 256) {
      free_ent = 258;
      width = 9;
      do code = get(width);
      while (code == 256);
      if (code < 0 || code == 257) break;
      if (code > 256) throw Error("TIFF: corrupt LZW data");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) throw Error("TIFF: corrupt LZW data (no clear code first)");
    if (code > free_ent || free_ent >= table) throw Error("TIFF: corrupt LZW data");
    uint8_t head = code < free_ent ? first[size_t(code)] : first[size_t(old)];
    prefix[size_t(free_ent)] = old;
    suffix[size_t(free_ent)] = head;
    first[size_t(free_ent)] = first[size_t(old)];
    emit(code);
    ++free_ent;
    if (free_ent >= (1 << width) - early && width < 12) ++width;
    old = code;
  }
  return out;
}

std::vector<uint8_t> inflate_all(const uint8_t* p, size_t n, size_t want) {
  std::vector<uint8_t> out(want);
  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) throw Error("TIFF: zlib failed");
  zs.next_in = const_cast<Bytef*>(p);
  zs.avail_in = uInt(n);
  zs.next_out = out.data();
  zs.avail_out = uInt(want);
  int rc = Z_OK;
  while (zs.avail_out > 0 && rc == Z_OK) rc = inflate(&zs, Z_NO_FLUSH);
  size_t got = want - zs.avail_out;
  inflateEnd(&zs);
  if (rc != Z_OK && rc != Z_STREAM_END && rc != Z_BUF_ERROR)
    throw Error("TIFF: corrupt Deflate data");
  out.resize(got);
  return out;
}

// ---- the layout and PIL's mode -----------------------------------------------

enum Kind { K_BILEVEL, K_GRAY, K_LA, K_U16, K_I16S, K_I32, K_F32, K_RGB, K_PAL, K_CMYK, K_LAB };

struct Layout {
  Kind kind;
  int mode;
  bool invert = false;
  bool swapped = false;    // compressed big-endian signed / float: PIL swaps the bytes
  int alpha = -1;          // RGB(A): 0 none, 1 associated (premultiplied), 2 unassociated
};

// PIL's OPEN_INFO for the file's photometric interpretation (YCbCr read as
// RGB, which libtiff hands over), sample format, bits and extra samples;
// ``fill2`` asks for the layouts PIL also has a fill-order-2 entry for.
Layout pil_layout(int photo, uint64_t sf, const std::vector<uint64_t>& bps,
                  const std::vector<uint64_t>& extra, bool be, bool fill2, bool planar2) {
  size_t n = bps.size();
  int b = int(bps[0]);
  bool same = std::all_of(bps.begin(), bps.end(), [&](uint64_t v) { return int(v) == b; });
  std::string what = "TIFF: photometric " + std::to_string(photo) + ", sample format " +
                     std::to_string(sf) + ", " + join(bps) + "-bit samples" +
                     (extra.empty() ? "" : ", extra samples " + join(extra)) +
                     (planar2 ? ", planar configuration 2" : "") + (fill2 ? ", fill order 2" : "");
  auto refuse = [&]() -> Layout { throw Error(what + " is not supported"); };
  if (!same) return refuse();
  if (fill2) {  // OPEN_INFO's fill-order-2 keys
    bool ok = sf == 1 && extra.empty() &&
              (((photo == 0 || photo == 1 || photo == 3) && n == 1 &&
                (b == 1 || b == 2 || b == 4 || b == 8)) ||
               (photo == 1 && n == 1 && b == 16 && !be) || (photo == 2 && n == 3 && b == 8));
    if (!ok) return refuse();
  }
  if ((photo == 0 || photo == 1) && n == 1 && extra.empty()) {
    bool inv = photo == 0;
    if (sf == 1 && b == 1) return {K_BILEVEL, MODE_1, inv};
    if (sf == 1 && (b == 2 || b == 4)) return {K_GRAY, MODE_L, inv};
    if (b == 8 && (sf == 1 || (sf == 2 && !inv))) return {K_GRAY, MODE_L, inv};
    if (sf == 1 && b == 12 && !inv && !be) return {K_U16, MODE_I16};
    if (sf == 1 && b == 16 && !(be && inv)) return {K_U16, be ? MODE_I16B : MODE_I16};
    Layout l{K_I32, MODE_I};
    l.swapped = be;
    if (sf == 2 && b == 16 && !inv) {
      l.kind = K_I16S;
      return l;
    }
    if (sf == 1 && b == 32 && !inv && !be) return l;
    if (sf == 2 && b == 32 && !inv) return l;
    if (sf == 3 && b == 32) {
      l.kind = K_F32;
      l.mode = MODE_F;
      return l;
    }
    return refuse();
  }
  if (photo == 1 && n == 2 && b == 8 && sf == 1 && extra.size() == 1 && extra[0] == 2)
    return {K_LA, MODE_LA};
  if (photo == 2 && sf == 1 && (b == 8 || b == 16) && n >= 3 && n == 3 + extra.size()) {
    Layout l{K_RGB, MODE_RGB};
    l.alpha = 0;
    if (n == 4 && extra.empty()) {
      l.alpha = 2;
    } else if (!extra.empty()) {
      bool rest_zero =
          std::all_of(extra.begin() + 1, extra.end(), [](uint64_t v) { return v == 0; });
      bool ok = rest_zero && (b == 8 ? n <= 6 : n == 4);
      if (!ok || extra[0] > 2) return refuse();
      l.alpha = int(extra[0]);
    } else if (n != 3) {
      return refuse();
    }
    if (l.alpha) l.mode = MODE_RGBA;
    return l;
  }
  if (photo == 3 && n == 1 && extra.empty() && sf == 1 && (b == 1 || b == 2 || b == 4 || b == 8))
    return {K_PAL, MODE_P};
  if (photo == 5 && sf == 1 && n == 4 + extra.size() &&
      ((b == 8 && extra.size() <= 2) || (b == 16 && extra.empty())) &&
      std::all_of(extra.begin(), extra.end(), [](uint64_t v) { return v == 0; })) {
    return {K_CMYK, MODE_CMYK};
  }
  if (photo == 8 && sf == 1 && n == 3 && b == 8 && extra.empty()) return {K_LAB, MODE_LAB};
  return refuse();
}

// tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB, in libtiff's float and
// fixed-point arithmetic.
struct YCbCrToRGB {
  int32_t cr_r[256], cb_b[256], y[256];
  int64_t cr_g[256], cb_g[256];
  YCbCrToRGB(const std::vector<float>& luma_in, const std::vector<float>& rbw_in) {
    float luma[3] = {0.299f, 0.587f, 0.114f};
    if (luma_in.size() >= 3) std::copy(luma_in.begin(), luma_in.begin() + 3, luma);
    float rbw[6] = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
    if (rbw_in.size() >= 6) std::copy(rbw_in.begin(), rbw_in.begin() + 6, rbw);
    auto fix = [](float x) { return int32_t(double(x * float(1L << 16)) + 0.5); };
    auto clamp2 = [](float x) { return x < 0.0f ? 0.0f : (x > 2.0f ? 2.0f : x); };
    auto code2v = [](int c, float rb, float rw, float cr) {
      float den = (rw - rb) != 0 ? (rw - rb) : 1.0f;
      return (float(c - int32_t(rb)) * cr) / den;
    };
    auto clampw = [](float v) {
      return int32_t(v < -128.0f * 32 ? -128.0f * 32 : (v > 128.0f * 32 ? 128.0f * 32 : v));
    };
    float f1 = 2 - 2 * luma[0];
    int32_t d1 = fix(clamp2(f1));
    float f2 = luma[0] * f1 / luma[1];
    int32_t d2 = -fix(clamp2(f2));
    float f3 = 2 - 2 * luma[2];
    int32_t d3 = fix(clamp2(f3));
    float f4 = luma[2] * f3 / luma[1];
    int32_t d4 = -fix(clamp2(f4));
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      int32_t cr = clampw(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127));
      int32_t cb = clampw(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127));
      cr_r[i] = int32_t((int64_t(d1) * cr + (1 << 15)) >> 16);
      cb_b[i] = int32_t((int64_t(d3) * cb + (1 << 15)) >> 16);
      cr_g[i] = int64_t(d2) * cr;
      cb_g[i] = int64_t(d4) * cb + (1 << 15);
      y[i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255));
    }
  }
  void convert(int yy, int cb, int cr, uint8_t* out) const {
    auto clamp = [](int64_t v) { return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    int64_t i = y[yy];
    out[0] = clamp(i + cr_r[cr]);
    out[1] = clamp(i + int32_t((cb_g[cb] + cr_g[cr]) >> 16));
    out[2] = clamp(i + cb_b[cb]);
  }
};

uint8_t reverse_bits(uint8_t v) {
  v = uint8_t((v & 0xF0) >> 4 | (v & 0x0F) << 4);
  v = uint8_t((v & 0xCC) >> 2 | (v & 0x33) << 2);
  return uint8_t((v & 0xAA) >> 1 | (v & 0x55) << 1);
}

// PIL's exif_transpose for orientation 2-8 (``in_place``), any pixel size.
void orient(Image& img, int orientation) {
  if (orientation < 2 || orientation > 8) return;
  size_t px = size_t(img.channels) * (img.bitdepth / 8 ? img.bitdepth / 8 : 1);
  int w = img.w, h = img.h;
  bool swap = orientation >= 5;
  int ow = swap ? h : w, oh = swap ? w : h;
  std::vector<uint8_t> out(img.data.size());
  for (int y = 0; y < oh; ++y)
    for (int x = 0; x < ow; ++x) {
      int sx, sy;  // source pixel of output (x, y)
      switch (orientation) {
        case 2: sx = w - 1 - x; sy = y; break;
        case 3: sx = w - 1 - x; sy = h - 1 - y; break;
        case 4: sx = x; sy = h - 1 - y; break;
        case 5: sx = y; sy = x; break;
        case 6: sx = y; sy = h - 1 - x; break;
        case 7: sx = w - 1 - y; sy = h - 1 - x; break;
        default: sx = w - 1 - y; sy = x; break;
      }
      std::memcpy(&out[(size_t(y) * ow + x) * px], &img.data[(size_t(sy) * w + sx) * px], px);
    }
  img.data.swap(out);
  img.w = ow;
  img.h = oh;
}

// One JPEG strip or tile of a compression-7 file: the JPEGTables' segments
// (without their EOI) ahead of the strip (without its SOI).
Image jpeg_chunk(const std::vector<uint8_t>& tables, const uint8_t* src, size_t cnt, bool ycc) {
  std::vector<uint8_t> jpeg;
  if (tables.size() >= 4 && cnt >= 2 && src[0] == 0xFF && src[1] == 0xD8) {
    jpeg.assign(tables.begin(), tables.end() - 2);
    jpeg.insert(jpeg.end(), src + 2, src + cnt);
  } else {
    jpeg.assign(src, src + cnt);
  }
  try {
    return decode_jpeg(jpeg, ycc ? JPEG_YCC : JPEG_NO_CONVERSION);
  } catch (const Error& e) {
    throw Error(std::string("TIFF: compression 7 (JPEG): ") + e.what());
  }
}

Image decode_tiff_file(const std::vector<uint8_t>& file, const TiffFile& t) {
  uint64_t w = t.value(256, 0), h = t.value(257, 0);
  if (!t.find(256) || !t.find(257)) throw Error("TIFF: missing dimensions");
  if (w == 0 || h == 0 || too_many_pixels(w, h)) throw Error("TIFF: bad image size");
  uint64_t compression = t.value(259, 1), photo = t.value(262, 0), fill = t.value(266, 1);
  uint64_t orientation = t.value(274, 1), planar = t.value(284, 1), predictor = t.value(317, 1);
  if (t.find(0xBC01)) throw Error("TIFF: Windows Media Photo is not supported");
  const bool ccitt = compression == 2 || compression == 3 || compression == 4;
  const bool jpeg = compression == 7, xz = compression == 34925, zstd = compression == 50000;
  if (compression == 6) throw Error("TIFF: compression 6 (old-style JPEG) is not supported");
  if (compression != 1 && compression != 5 && compression != 8 && compression != 32946 &&
      compression != 32773 && !ccitt && !jpeg && !xz && !zstd)
    throw Error("TIFF: compression " + std::to_string(compression) + " is not supported "
                "(none, CCITT, LZW, JPEG, Deflate, PackBits, LZMA and ZSTD only)");
  if (fill != 1 && fill != 2)
    throw Error("TIFF: fill order " + std::to_string(fill) + " is not supported");
  if (planar != 1 && planar != 2) throw Error("TIFF: bad planar configuration");
  std::vector<uint64_t> sfs = t.values(339);
  uint64_t sf = 1;
  if (!sfs.empty()) {
    bool all_one = std::all_of(sfs.begin(), sfs.end(), [](uint64_t v) { return v == 1; });
    if (sfs.size() > 1 && !all_one) throw Error("TIFF: per-sample formats are not supported");
    sf = sfs[0];
  }
  std::vector<uint64_t> bps = t.values(258);
  if (bps.empty()) bps.push_back(1);
  std::vector<uint64_t> extra = t.values(338);
  uint64_t spp = t.value(277, 1);
  if (spp == 0 || spp > 6) throw Error("TIFF: bad samples per pixel");
  if (spp < bps.size()) bps.resize(spp);
  else if (spp > bps.size() && bps.size() == 1) bps.assign(spp, bps[0]);
  if (bps.size() != spp) throw Error("TIFF: unknown data organization");
  const bool ycbcr = photo == 6 && spp == 3;
  Layout lay = pil_layout(ycbcr ? 2 : (photo == 6 ? 1 : int(photo)), sf, bps, extra, t.be,
                          fill == 2, planar == 2 && spp > 1);
  if (ycbcr && (!extra.empty() || bps[0] != 8))
    throw Error("TIFF: photometric 6 (YCbCr) needs three 8-bit samples");
  int b = int(bps[0]);
  const bool raw = compression == 1;
  if (planar == 2 && spp > 1 && b != 8 && b != 16)
    throw Error("TIFF: planar configuration 2 is supported for 8- and 16-bit samples only");
  if (ccitt && !(b == 1 && spp == 1))
    throw Error("TIFF: CCITT compression needs 1-bit samples");
  if (jpeg && (b != 8 || (planar == 2 && spp > 1) || !(photo == 0 || photo == 1 || photo == 2 ||
                                                       photo == 6)))
    throw Error("TIFF: compression 7 (JPEG) is supported for 8-bit gray, RGB and YCbCr only");
  if (!raw && predictor == 2 && b != 8 && b != 16 && b != 32)
    throw Error("TIFF: horizontal differencing at " + std::to_string(b) + " bits is not supported");
  if (!raw && predictor == 3 && !(sf == 3 && b == 32))
    throw Error("TIFF: the floating-point predictor needs 32-bit float samples");
  if (!raw && predictor != 1 && predictor != 2 && predictor != 3)
    throw Error("TIFF: predictor " + std::to_string(predictor) + " is not supported");
  if ((ccitt || jpeg) && predictor != 1)
    throw Error("TIFF: a predictor with CCITT or JPEG compression is not supported");
  if (ycbcr && planar == 2) throw Error("TIFF: YCbCr in planar configuration 2 is not supported");
  int hs = 1, vs = 1;
  if (ycbcr && !jpeg && !raw) {
    std::vector<uint64_t> sub = t.values(530);
    if (sub.size() >= 2) {
      hs = int(sub[0]);
      vs = int(sub[1]);
    }
    bool ok = (hs == 1 || hs == 2 || hs == 4) && (vs == 1 || vs == 2 || vs == 4) && vs <= hs;
    if (!ok) throw Error("TIFF: YCbCr subsampling " + std::to_string(hs) + "x" +
                         std::to_string(vs) + " is not supported");
    if (predictor != 1) throw Error("TIFF: a predictor with YCbCr samples is not supported");
  }
  const YCbCrToRGB* ycc = nullptr;
  std::unique_ptr<YCbCrToRGB> ycc_tables;
  if (ycbcr && !jpeg && !raw) {
    ycc_tables.reset(new YCbCrToRGB(t.floats(529), t.floats(532)));
    ycc = ycc_tables.get();
  }
  const std::vector<uint8_t> jpeg_tables = jpeg ? t.bytes_of(347) : std::vector<uint8_t>();
  const uint32_t t4 = uint32_t(t.value(compression == 4 ? 293 : 292, 0));

  bool tiled = t.find(324) != nullptr;
  uint64_t cw = w, ch = t.value(278, h);
  std::vector<uint64_t> offsets, counts;
  if (tiled) {
    cw = t.value(322, 0);
    ch = t.value(323, 0);
    if (!cw || !ch || too_many_pixels(cw, ch)) throw Error("TIFF: bad tile size");
    offsets = t.values(324);
    counts = t.values(325);
  } else {
    if (!t.find(273)) throw Error("TIFF: no strips or tiles");
    offsets = t.values(273);
    counts = t.values(279);
    if (ch == 0 || ch > h) ch = h;
  }
  int planes = planar == 2 ? int(spp) : 1;
  int nsamp = planar == 2 ? 1 : int(spp);
  uint64_t across = (w + cw - 1) / cw, down = (h + ch - 1) / ch;
  uint64_t per_plane = across * down;
  if (offsets.size() < per_plane * planes) throw Error("TIFF: too few strip or tile offsets");
  if (!raw && counts.size() < per_plane * planes) throw Error("TIFF: missing byte counts");
  size_t rowbytes = size_t((cw * nsamp * b + 7) / 8);
  bool swap_out = lay.swapped && !raw;
  // uncompressed 16-bit planes: PIL's per-band unpacker takes a byte a pixel
  const bool byte_planes = raw && planar == 2 && spp > 1 && b == 16;

  std::vector<uint32_t> vals(size_t(w) * h * spp);
  for (int pl = 0; pl < planes; ++pl) {
    for (uint64_t ci = 0; ci < per_plane; ++ci) {
      uint64_t x0 = (ci % across) * cw, y0 = (ci / across) * ch;
      uint64_t rows = tiled ? ch : std::min<uint64_t>(ch, h - y0);
      size_t want = size_t(rows) * rowbytes;
      size_t off = size_t(offsets[size_t(pl * per_plane + ci)]);
      std::vector<uint8_t> data;
      size_t chunk_rowbytes = rowbytes;
      bool swap = false;
      if (raw) {
        uint64_t keep_rows = std::min<uint64_t>(rows, h - y0);
        uint64_t keep_cols = std::min<uint64_t>(cw, w - x0);
        size_t stride = rowbytes;
        if (ycbcr) {  // PIL's raw "RGBX": four bytes a pixel
          stride = size_t(x0 + cw > w ? cw * 4 : keep_cols * 4);
        } else if (byte_planes) {
          stride = size_t(x0 + cw > w ? cw * 2 : keep_cols);
        }
        size_t need = size_t(keep_rows) * stride;
        if (off > file.size() || need > file.size() - off)
          throw Error(ycbcr ? "TIFF: photometric 6 (YCbCr) uncompressed: PIL reads it as RGBX "
                              "and the file is truncated"
                            : "TIFF: truncated image data");
        data.assign(file.begin() + long(off), file.begin() + long(off + need));
        if (fill == 2)
          for (auto& v : data) v = reverse_bits(v);
        if (ycbcr || byte_planes) {  // regroup into rows of the usual layout
          std::vector<uint8_t> packed(size_t(keep_rows) * rowbytes, 0);
          for (uint64_t r = 0; r < keep_rows; ++r)
            for (uint64_t x = 0; x < keep_cols; ++x) {
              const uint8_t* sp = &data[size_t(r) * stride];
              uint8_t* dp = &packed[size_t(r) * rowbytes];
              if (ycbcr) {
                for (int c = 0; c < 3; ++c) dp[3 * x + c] = sp[4 * x + c];
              } else {  // as big-endian 16-bit values whose high byte is the plane's byte
                dp[2 * x] = sp[x];
                dp[2 * x + 1] = 0;
              }
            }
          data.swap(packed);
        }
        rows = keep_rows;
        swap = t.be && !byte_planes;
        if (byte_planes) swap = true;
      } else {
        size_t cnt = size_t(counts[size_t(pl * per_plane + ci)]);
        if (off > file.size() || cnt > file.size() - off) throw Error("TIFF: truncated image data");
        std::vector<uint8_t> reversed;
        const uint8_t* src = file.data() + off;
        if (fill == 2) {
          reversed.assign(src, src + cnt);
          for (auto& v : reversed) v = reverse_bits(v);
          src = reversed.data();
        }
        size_t units_x = size_t((cw + hs - 1) / hs), units_y = size_t((rows + vs - 1) / vs);
        size_t coded = ycc ? units_x * units_y * size_t(hs * vs + 2) : want;
        if (compression == 5) data = unlzw(src, cnt, coded);
        else if (compression == 32773) data = unpack_bits(src, cnt, coded);
        else if (xz) data = decode_xz(src, cnt, coded);
        else if (zstd) data = decode_zstd(src, cnt, coded);
        else if (ccitt) {
          std::vector<uint8_t> px =
              decode_ccitt(src, cnt, int(cw), int(rows), int(compression), t4);
          data.assign(want, 0);
          for (uint64_t r = 0; r < rows; ++r)
            for (uint64_t x = 0; x < cw; ++x)
              if (px[size_t(r * cw + x)])
                data[size_t(r) * rowbytes + size_t(x >> 3)] |= uint8_t(0x80 >> (x & 7));
        } else if (jpeg) {
          Image part = jpeg_chunk(jpeg_tables, src, cnt, photo == 6);
          if (uint64_t(part.channels) != spp || uint64_t(part.w) < cw ||
              uint64_t(part.h) < std::min<uint64_t>(rows, h - y0))
            throw Error("TIFF: a JPEG strip or tile does not match the image");
          data.assign(want, 0);
          size_t prow = size_t(part.w) * part.channels;
          for (uint64_t r = 0; r < std::min<uint64_t>(rows, uint64_t(part.h)); ++r)
            std::memcpy(&data[size_t(r) * rowbytes], &part.data[size_t(r) * prow], rowbytes);
        } else data = inflate_all(src, cnt, coded);
        if (data.size() < coded) throw Error("TIFF: not enough image data in a strip or tile");
        if (ycc) {  // TIFFRGBAImage's putcontig8bitYCbCr*tile: chroma over each block
          std::vector<uint8_t> rgb(want, 0);
          const uint8_t* u = data.data();
          for (size_t by = 0; by < units_y; ++by)
            for (size_t bx = 0; bx < units_x; ++bx, u += hs * vs + 2) {
              int cb = u[hs * vs], cr = u[hs * vs + 1];
              for (int yy = 0; yy < vs; ++yy)
                for (int xx = 0; xx < hs; ++xx) {
                  size_t y = by * size_t(vs) + size_t(yy), x = bx * size_t(hs) + size_t(xx);
                  if (y < rows && x < cw)
                    ycc->convert(u[yy * hs + xx], cb, cr, &rgb[y * rowbytes + 3 * x]);
                }
            }
          data.swap(rgb);
        }
        swap = t.be;  // the file's byte order; libtiff hands over host order
      }
      size_t per_row = size_t(cw) * nsamp;
      std::vector<uint32_t> row(per_row);
      for (uint64_t r = 0; r < rows; ++r) {
        const uint8_t* src = data.data() + size_t(r) * chunk_rowbytes;
        if (!raw && predictor == 3) {
          std::vector<uint8_t> tmp(src, src + rowbytes);
          for (size_t i = size_t(nsamp); i < rowbytes; ++i)
            tmp[i] = uint8_t(tmp[i] + tmp[i - nsamp]);
          size_t wc = rowbytes / 4;
          for (size_t i = 0; i < per_row; ++i)
            row[i] = (uint32_t(tmp[i]) << 24) | (uint32_t(tmp[wc + i]) << 16) |
                     (uint32_t(tmp[2 * wc + i]) << 8) | tmp[3 * wc + i];
        } else {
          for (size_t i = 0; i < per_row; ++i) {
            uint32_t v;
            if (b == 8) {
              v = src[i];
            } else if (b == 16) {
              v = swap ? be16(src + 2 * i) : le16(src + 2 * i);
            } else if (b == 32) {
              v = swap ? be32(src + 4 * i) : le32(src + 4 * i);
            } else if (b == 12) {  // PIL's I;12: MSB-first 12-bit fields
              size_t bit = i * 12, at = bit >> 3;
              v = (bit & 7) ? ((src[at] & 0x0F) << 8) | src[at + 1]
                            : (uint32_t(src[at]) << 4) | (src[at + 1] >> 4);
            } else {
              size_t bit = i * size_t(b);
              v = (src[bit >> 3] >> (8 - b - (bit & 7))) & ((1u << b) - 1);
            }
            row[i] = v;
          }
          if (!raw && predictor == 2) {
            uint32_t mask = b == 32 ? 0xFFFFFFFFu : ((1u << b) - 1);
            for (size_t i = size_t(nsamp); i < per_row; ++i)
              row[i] = (row[i] + row[i - nsamp]) & mask;
          }
        }
        if (swap_out)
          for (size_t i = 0; i < per_row; ++i)
            row[i] = b == 16 ? ((row[i] & 0xFF) << 8) | (row[i] >> 8) : __builtin_bswap32(row[i]);
        uint64_t y = y0 + r;
        if (y >= h) break;
        for (uint64_t x = x0; x < std::min<uint64_t>(x0 + cw, w); ++x) {
          size_t px = (size_t(y) * w + x) * spp;
          size_t i = size_t(x - x0) * nsamp;
          if (planar == 2) vals[px + size_t(pl)] = row[i];
          else for (uint64_t c = 0; c < spp; ++c) vals[px + c] = row[i + c];
        }
      }
    }
  }

  Image img;
  img.w = int(w);
  img.h = int(h);
  img.mode = lay.mode;
  size_t npx = size_t(w) * h;
  auto put8 = [&](int channels) {
    img.channels = channels;
    img.bitdepth = 8;
    img.data.assign(npx * channels, 0);
  };
  switch (lay.kind) {
    case K_BILEVEL:
      put8(1);
      for (size_t i = 0; i < npx; ++i) img.data[i] = uint8_t(lay.invert ? 1 - vals[i] : vals[i]);
      break;
    case K_GRAY: {
      put8(1);
      int scale = b == 2 ? 85 : (b == 4 ? 17 : 1);
      for (size_t i = 0; i < npx; ++i) {
        int v = int(vals[i]) * scale;
        img.data[i] = uint8_t(lay.invert ? 255 - v : v);
      }
      break;
    }
    case K_LA:
      put8(2);
      for (size_t i = 0; i < 2 * npx; ++i) img.data[i] = uint8_t(vals[i]);
      break;
    case K_LAB:  // PIL's "LAB" raw mode keeps the stored bytes
      put8(3);
      for (size_t i = 0; i < 3 * npx; ++i) img.data[i] = uint8_t(vals[i]);
      break;
    case K_PAL: {
      put8(1);
      for (size_t i = 0; i < npx; ++i) img.data[i] = uint8_t(vals[i]);
      std::vector<uint64_t> cmap = t.values(320);
      if (cmap.empty() || cmap.size() % 3) throw Error("TIFF: palette image without a colour map");
      size_t entries = cmap.size() / 3;
      for (size_t i = 0; i < entries; ++i)
        for (size_t k = 0; k < 3; ++k) img.palette.push_back(uint8_t(cmap[k * entries + i] >> 8));
      break;
    }
    case K_U16: {
      img.channels = 1;
      img.bitdepth = 16;
      img.data.resize(npx * 2);
      uint16_t* d = reinterpret_cast<uint16_t*>(img.data.data());
      for (size_t i = 0; i < npx; ++i) d[i] = uint16_t(vals[i]);
      break;
    }
    case K_I16S:
    case K_I32: {
      img.channels = 1;
      img.bitdepth = 32;
      img.data.resize(npx * 4);
      int32_t* d = reinterpret_cast<int32_t*>(img.data.data());
      for (size_t i = 0; i < npx; ++i)
        d[i] = lay.kind == K_I16S ? int32_t(int16_t(uint16_t(vals[i]))) : int32_t(vals[i]);
      break;
    }
    case K_F32: {
      img.channels = 1;
      img.bitdepth = 32;
      img.data.resize(npx * 4);
      std::memcpy(img.data.data(), vals.data(), npx * 4);
      break;
    }
    case K_RGB:
    case K_CMYK: {
      int out_ch = lay.kind == K_CMYK ? 4 : (lay.alpha ? 4 : 3);
      put8(out_ch);
      int shift = b == 16 ? 8 : 0;
      for (size_t i = 0; i < npx; ++i) {
        const uint32_t* s = &vals[i * spp];
        uint8_t* d = &img.data[i * out_ch];
        for (int c = 0; c < out_ch; ++c) d[c] = uint8_t(s[c] >> shift);
        if (lay.alpha == 1) {  // Unpack.c unpackRGBa
          int a = d[3];
          for (int c = 0; c < 3; ++c) {
            int v = a == 0 ? 0 : (a == 255 ? d[c] : d[c] * 255 / a);
            d[c] = uint8_t(v > 255 ? 255 : v);
          }
        }
      }
      break;
    }
  }
  orient(img, int(orientation));
  return img;
}

}  // namespace

Image decode_tiff(const std::vector<uint8_t>& file) {
  TiffFile t(file);
  t.parse();
  if (!t.big) return decode_tiff_file(file, t);
  try {
    return decode_tiff_file(file, t);
  } catch (const Error& e) {
    throw Error(std::string("BigTIFF: ") + e.what());
  }
}

}  // namespace pslx
