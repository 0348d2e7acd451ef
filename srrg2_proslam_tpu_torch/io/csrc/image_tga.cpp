// TGA as PIL 12's TgaImagePlugin reads it: an 18-byte header PIL accepts
// (colour-map type 0 or 1, a nonzero size, 1/8/16/24/32 bits), image types
// 1/9 (colour-mapped: mode P with a colour map, else L), 2/10 (true colour:
// RGB at 24 bits, RGBA at 16 and 32) and 3/11 (gray: 1 at 1 bit, L at 8, LA
// at 16), raw or run-length encoded (Pillow's TgaRleDecode: a run may not
// cross a row, a literal packet may), rows bottom-up unless bit 5 of the
// descriptor is set, mirrored when bit 4 is; colour maps of 16 (BGRA;15Z),
// and 24 bits with PIL's leading blank entries for a nonzero first index.
// What PIL cannot load is refused: a type / depth pair it has no raw mode
// for, a colour-mapped image without a map, a 32-bit map, run-length
// encoding at 1 bit, a run crossing a row, truncated data.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

struct TgaHeader {
  int id_len, cmap_type, image_type, map_start, map_size, map_depth, w, h, depth, flags;
  explicit TgaHeader(const std::vector<uint8_t>& f)
      : id_len(f[0]), cmap_type(f[1]), image_type(f[2]), map_start(int(le16(&f[3]))),
        map_size(int(le16(&f[5]))), map_depth(f[7]), w(int(le16(&f[12]))),
        h(int(le16(&f[14]))), depth(f[16]), flags(f[17]) {}
};

// PIL's 5/5/5 field expansion, as its BGR;15 unpackers do
inline uint8_t five(uint32_t v) { return uint8_t((v & 31) * 255 / 31); }

}  // namespace

// Whether PIL's TgaImageFile._open gets past the header (the file is then
// claimed as TGA): a valid header, a known image type and colour-map depth.
bool tga_header_valid(const std::vector<uint8_t>& f) {
  if (f.size() < 18) return false;
  TgaHeader t(f);
  bool depth_ok =
      t.depth == 1 || t.depth == 8 || t.depth == 16 || t.depth == 24 || t.depth == 32;
  if (t.cmap_type > 1 || t.w <= 0 || t.h <= 0 || !depth_ok) return false;
  int type = t.image_type;
  if (!(type == 1 || type == 2 || type == 3 || type == 9 || type == 10 || type == 11)) return false;
  if (t.cmap_type && !(t.map_depth == 16 || t.map_depth == 24 || t.map_depth == 32)) return false;
  return true;
}

Image decode_tga(const std::vector<uint8_t>& f) {
  if (!tga_header_valid(f)) throw Error("not a TGA file");
  TgaHeader t(f);
  if (too_many_pixels(uint64_t(t.w), uint64_t(t.h))) throw Error("TGA: bad image size");
  Image img;
  img.w = t.w;
  img.h = t.h;
  int type = t.image_type & 7;
  if (type == 3) {
    img.mode = t.depth == 1 ? MODE_1 : (t.depth == 16 ? MODE_LA : MODE_L);
  } else if (type == 1) {
    img.mode = t.cmap_type ? MODE_P : MODE_L;
  } else {
    img.mode = t.depth == 24 ? MODE_RGB : MODE_RGBA;
  }
  img.channels =
      img.mode == MODE_LA ? 2 : (img.mode == MODE_RGB ? 3 : (img.mode == MODE_RGBA ? 4 : 1));
  const size_t npx = size_t(t.w) * t.h;
  img.data.assign(npx * img.channels, 0);
  size_t pos = 18 + size_t(t.id_len);
  if (t.cmap_type) {
    int bytes = t.map_depth == 16 ? 2 : t.map_depth / 8;
    size_t avail = pos < f.size() ? f.size() - pos : 0;
    size_t entries = std::min<size_t>(size_t(t.map_size), avail / size_t(bytes));
    size_t total = std::min<size_t>(size_t(t.map_start) + entries, 256);
    for (size_t i = 0; i < total; ++i) {
      uint8_t rgb[3] = {0, 0, 0};
      if (i >= size_t(t.map_start)) {
        const uint8_t* e = &f[pos + (i - size_t(t.map_start)) * size_t(bytes)];
        if (bytes == 2) {
          uint32_t v = le16(e);
          rgb[0] = five(v >> 10);
          rgb[1] = five(v >> 5);
          rgb[2] = five(v);
        } else {
          rgb[0] = e[2];
          rgb[1] = e[1];
          rgb[2] = e[0];
        }
      }
      img.palette.insert(img.palette.end(), rgb, rgb + 3);
    }
    pos += size_t(t.map_size) * size_t(bytes);
    if (img.mode != MODE_P) img.palette.clear();
  }
  // PIL's raw modes by (type, depth); it cannot load the other pairs, a
  // colour-mapped image without a map (raw mode P for mode L) or a 32-bit map
  int bits;
  if ((type == 1 && t.depth == 8) || (type == 3 && t.depth == 8)) bits = 8;
  else if (type == 3 && (t.depth == 1 || t.depth == 16)) bits = t.depth;
  else if (type == 2 && (t.depth == 16 || t.depth == 24 || t.depth == 32)) bits = t.depth;
  else
    throw Error("TGA: image type " + std::to_string(t.image_type) + " at " +
                std::to_string(t.depth) + " bits is not supported (PIL cannot load it)");
  if (type == 1 && !t.cmap_type)
    throw Error("TGA: a colour-mapped image without a colour map is not supported "
                "(PIL cannot load it)");
  if (t.cmap_type && t.map_depth == 32 && img.mode == MODE_P)
    throw Error("TGA: 32-bit colour maps are not supported (PIL cannot load them)");
  const size_t rowbytes = (size_t(t.w) * size_t(bits) + 7) / 8;
  std::vector<uint8_t> raw(rowbytes * t.h);
  if (t.image_type & 8) {  // TgaRleDecode.c
    const int pixel = t.depth / 8;
    if (pixel == 0)
      throw Error("TGA: run-length encoding at 1 bit is not supported (PIL reads none)");
    size_t x = 0, row = 0;
    while (row < size_t(t.h)) {
      if (pos >= f.size()) throw Error("TGA: truncated run-length data");
      int head = f[pos];
      size_t n = size_t(pixel) * ((head & 0x7F) + 1);
      uint8_t* line = &raw[row * rowbytes];
      if (head & 0x80) {
        if (pos + 1 + size_t(pixel) > f.size()) throw Error("TGA: truncated run-length data");
        if (x + n > rowbytes) throw Error("TGA: a run crosses the end of a row");
        for (size_t i = 0; i < n; i += size_t(pixel))
          std::memcpy(line + x + i, &f[pos + 1], size_t(pixel));
        pos += 1 + size_t(pixel);
        x += n;
        if (x >= rowbytes) {
          x = 0;
          ++row;
        }
      } else {
        if (pos + 1 + n > f.size()) throw Error("TGA: truncated run-length data");
        const uint8_t* src = &f[pos + 1];
        pos += 1 + n;
        while (n > 0 && row < size_t(t.h)) {  // a literal packet may run on into the next rows
          size_t k = std::min(n, rowbytes - x);
          std::memcpy(&raw[row * rowbytes + x], src, k);
          src += k;
          n -= k;
          x += k;
          if (x >= rowbytes) {
            x = 0;
            ++row;
          }
        }
      }
    }
  } else {
    if (pos > f.size() || raw.size() > f.size() - pos) throw Error("TGA: truncated image data");
    std::memcpy(raw.data(), &f[pos], raw.size());
  }
  const bool top_down = (t.flags & 0x20) != 0, mirror = (t.flags & 0x10) != 0;
  for (int r = 0; r < t.h; ++r) {
    const uint8_t* s = &raw[size_t(r) * rowbytes];
    int y = top_down ? r : t.h - 1 - r;
    for (int x = 0; x < t.w; ++x) {
      int ox = mirror ? t.w - 1 - x : x;
      uint8_t* d = &img.data[(size_t(y) * t.w + ox) * img.channels];
      if (bits == 1) {
        d[0] = uint8_t((s[x >> 3] >> (7 - (x & 7))) & 1);
      } else if (bits == 8) {
        d[0] = s[x];
      } else if (type == 3) {  // LA
        d[0] = s[2 * x];
        d[1] = s[2 * x + 1];
      } else if (bits == 16) {  // BGRA;15Z: alpha 0 where the top bit is set
        uint32_t v = le16(s + 2 * x);
        d[0] = five(v >> 10);
        d[1] = five(v >> 5);
        d[2] = five(v);
        d[3] = (v & 0x8000) ? 0 : 255;
      } else {
        int k = bits / 8;
        d[0] = s[k * x + 2];
        d[1] = s[k * x + 1];
        d[2] = s[k * x];
        if (k == 4) d[3] = s[4 * x + 3];
      }
    }
  }
  return img;
}

}  // namespace pslx
