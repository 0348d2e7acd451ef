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
// and CMYK.  Refused with a message: fill order 2, orientations other than
// 1, other compressions, the old-style LZW, YCbCr, LAB and any layout PIL
// has no mode for (in a big-endian file also 16-bit MinIsWhite and 32-bit
// unsigned samples).  PIL unpacks libtiff's host-order output of a
// compressed big-endian file's signed and float samples as big-endian, so
// their bytes come out swapped; so do they here.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>
#include <zlib.h>

#include "image_common.h"

namespace pslx {
namespace {

const int kTypeSize[17] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 0, 0, 0, 8};

struct Field {
  uint32_t type = 0, count = 0;
  size_t at = 0;  // position of the values in the file
};

struct TiffFile {
  const std::vector<uint8_t>& f;
  bool be = false;
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

  void parse() {
    if (f.size() < 8) throw Error("TIFF: truncated header");
    if (f[0] == 'M' && f[1] == 'M') {
      be = true;
    } else if (!(f[0] == 'I' && f[1] == 'I')) {
      throw Error("not a TIFF file");
    }
    uint32_t magic = u16(2);
    if (magic == 43) throw Error("TIFF: BigTIFF is not supported");
    if (magic != 42) throw Error("not a TIFF file");
    size_t ifd = u32(4);
    uint32_t n = u16(ifd);
    for (uint32_t i = 0; i < n; ++i) {
      size_t e = ifd + 2 + 12 * size_t(i);
      Field fl;
      uint32_t tag = u16(e);
      fl.type = u16(e + 2);
      fl.count = u32(e + 4);
      if (fl.type == 0 || fl.type > 16 || !kTypeSize[fl.type]) continue;
      uint64_t bytes = uint64_t(kTypeSize[fl.type]) * fl.count;
      fl.at = bytes <= 4 ? e + 8 : u32(e + 8);
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
    for (uint32_t i = 0; i < fl->count; ++i) {
      size_t p = fl->at + size_t(i) * kTypeSize[fl->type];
      switch (fl->type) {
        case 1: case 6: case 7: out.push_back(f[p]); break;
        case 3: case 8: out.push_back(u16(p)); break;
        case 4: case 9: out.push_back(u32(p)); break;
        default: throw Error("TIFF: tag " + std::to_string(tag) + " has a non-integer type");
      }
    }
    return out;
  }

  uint64_t value(uint32_t tag, uint64_t fallback) const {
    auto v = values(tag);
    return v.empty() ? fallback : v[0];
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

// libtiff's LZWDecode: MSB-first codes of 9 to 12 bits, the width growing
// one code early; 256 clears the table, 257 ends the strip.
std::vector<uint8_t> unlzw(const uint8_t* p, size_t n, size_t want) {
  if (n >= 2 && p[0] == 0 && (p[1] & 1)) throw Error("TIFF: old-style LZW is not supported");
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096);
  for (int i = 0; i < 256; ++i) suffix[size_t(i)] = first[size_t(i)] = uint8_t(i);
  std::vector<uint8_t> out;
  out.reserve(want);
  std::vector<uint8_t> stack;
  size_t bitpos = 0, nbits_total = n * 8;
  int width = 9, free_ent = 258, old = -1;
  auto get = [&](int k) -> int {
    if (bitpos + size_t(k) > nbits_total) return -1;
    int v = 0;
    for (int b = 0; b < k; ++b, ++bitpos)
      v = (v << 1) | ((p[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
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
      code = get(width);
      if (code < 0 || code == 257) break;
      if (code >= 256) throw Error("TIFF: corrupt LZW data");
      emit(code);
      old = code;
      continue;
    }
    if (old < 0) throw Error("TIFF: corrupt LZW data (no clear code first)");
    if (code > free_ent || free_ent >= 4096) throw Error("TIFF: corrupt LZW data");
    uint8_t head = code < free_ent ? first[size_t(code)] : first[size_t(old)];
    prefix[size_t(free_ent)] = old;
    suffix[size_t(free_ent)] = head;
    first[size_t(free_ent)] = first[size_t(old)];
    emit(code);
    ++free_ent;
    if (free_ent >= (1 << width) - 1 && width < 12) ++width;
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

enum Kind { K_BILEVEL, K_GRAY, K_LA, K_U16, K_I16S, K_I32, K_F32, K_RGB, K_PAL, K_CMYK };

struct Layout {
  Kind kind;
  int mode;
  bool invert = false;
  bool swapped = false;    // compressed big-endian signed / float: PIL swaps the bytes
  int alpha = -1;          // RGB(A): 0 none, 1 associated (premultiplied), 2 unassociated
};

Layout pil_layout(int photo, uint64_t sf, const std::vector<uint64_t>& bps,
                  const std::vector<uint64_t>& extra, bool be) {
  size_t n = bps.size();
  int b = int(bps[0]);
  bool same = std::all_of(bps.begin(), bps.end(), [&](uint64_t v) { return int(v) == b; });
  std::string what = "TIFF: photometric " + std::to_string(photo) + ", sample format " +
                     std::to_string(sf) + ", " + join(bps) + "-bit samples" +
                     (extra.empty() ? "" : ", extra samples " + join(extra));
  auto refuse = [&]() -> Layout { throw Error(what + " is not supported"); };
  if (!same) return refuse();
  if ((photo == 0 || photo == 1) && n == 1 && extra.empty()) {
    bool inv = photo == 0;
    if (sf == 1 && b == 1) return {K_BILEVEL, MODE_1, inv};
    if (sf == 1 && (b == 2 || b == 4)) return {K_GRAY, MODE_L, inv};
    if (b == 8 && (sf == 1 || (sf == 2 && !inv))) return {K_GRAY, MODE_L, inv};
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
  return refuse();
}

}  // namespace

Image decode_tiff(const std::vector<uint8_t>& file) {
  TiffFile t(file);
  t.parse();
  uint64_t w = t.value(256, 0), h = t.value(257, 0);
  if (!t.find(256) || !t.find(257)) throw Error("TIFF: missing dimensions");
  if (w == 0 || h == 0 || too_many_pixels(w, h)) throw Error("TIFF: bad image size");
  uint64_t compression = t.value(259, 1), photo = t.value(262, 0), fill = t.value(266, 1);
  uint64_t orientation = t.value(274, 1), planar = t.value(284, 1), predictor = t.value(317, 1);
  if (t.find(0xBC01)) throw Error("TIFF: Windows Media Photo is not supported");
  if (fill != 1) throw Error("TIFF: fill order " + std::to_string(fill) + " is not supported");
  if (orientation != 1)
    throw Error("TIFF: orientation " + std::to_string(orientation) + " is not supported");
  if (compression != 1 && compression != 5 && compression != 8 && compression != 32946 &&
      compression != 32773)
    throw Error("TIFF: compression " + std::to_string(compression) + " is not supported "
                "(none, PackBits, LZW and Deflate only)");
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
  Layout lay = pil_layout(int(photo), sf, bps, extra, t.be);
  int b = int(bps[0]);
  bool raw = compression == 1;
  if (planar == 2 && spp > 1 && b != 8)
    throw Error("TIFF: planar configuration 2 is supported for 8-bit samples only");
  if (!raw && predictor == 2 && b < 8)
    throw Error("TIFF: horizontal differencing at " + std::to_string(b) + " bits is not supported");
  if (!raw && predictor == 3 && !(sf == 3 && b == 32))
    throw Error("TIFF: the floating-point predictor needs 32-bit float samples");
  if (!raw && predictor != 1 && predictor != 2 && predictor != 3)
    throw Error("TIFF: predictor " + std::to_string(predictor) + " is not supported");

  bool tiled = t.find(324) != nullptr;
  uint64_t cw = w, ch = t.value(278, h);
  std::vector<uint64_t> offsets, counts;
  if (tiled) {
    cw = t.value(322, 0);
    ch = t.value(323, 0);
    if (!cw || !ch) throw Error("TIFF: bad tile size");
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

  std::vector<uint32_t> vals(size_t(w) * h * spp);
  for (int pl = 0; pl < planes; ++pl) {
    for (uint64_t ci = 0; ci < per_plane; ++ci) {
      uint64_t x0 = (ci % across) * cw, y0 = (ci / across) * ch;
      uint64_t rows = tiled ? ch : std::min<uint64_t>(ch, h - y0);
      size_t want = size_t(rows) * rowbytes;
      size_t off = size_t(offsets[size_t(pl * per_plane + ci)]);
      std::vector<uint8_t> data;
      bool swap = false;
      if (raw) {
        uint64_t keep_rows = std::min<uint64_t>(rows, h - y0);
        size_t need = size_t(keep_rows) * rowbytes;
        if (off > file.size() || need > file.size() - off)
          throw Error("TIFF: truncated image data");
        data.assign(file.begin() + long(off), file.begin() + long(off + need));
        rows = keep_rows;
        swap = t.be;
      } else {
        size_t cnt = size_t(counts[size_t(pl * per_plane + ci)]);
        if (off > file.size() || cnt > file.size() - off) throw Error("TIFF: truncated image data");
        const uint8_t* src = file.data() + off;
        if (compression == 5) data = unlzw(src, cnt, want);
        else if (compression == 32773) data = unpack_bits(src, cnt, want);
        else data = inflate_all(src, cnt, want);
        if (data.size() < want) throw Error("TIFF: not enough image data in a strip or tile");
        swap = t.be;  // the file's byte order; libtiff hands over host order
      }
      size_t per_row = size_t(cw) * nsamp;
      std::vector<uint32_t> row(per_row);
      for (uint64_t r = 0; r < rows; ++r) {
        const uint8_t* src = data.data() + size_t(r) * rowbytes;
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
  return img;
}

}  // namespace pslx
