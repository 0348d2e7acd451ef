// ICO and CUR as PIL 12 reads them.  ICO (IcoImagePlugin): the entry PIL
// picks (entries sorted by colour depth, then by area from the largest,
// both stable; the first), a PNG inside decoded as PNG, else a DIB of half
// its stated height read as PIL's BMP reader reads it, then converted to
// RGBA with PIL's mask: the fourth byte of each pixel where the entry says
// 32 bits, else the AND mask at the entry's end (1 = transparent, rows of
// a multiple of 32 bits, bottom-up).  CUR (CurImagePlugin): the first
// entry, replaced by each later one larger in both dimensions, its DIB at
// half height and no mask.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

struct IcoEntry {
  int w, h, bpp, depth;
  uint32_t size, offset;
};

// The DIB at ``at`` as a BMP file with its height halved -> PIL's BMP
// decode; ``data_at``: where its pixels start in ``f``.
Image half_height_dib(const std::vector<uint8_t>& f, size_t at, size_t* data_at) {
  if (at > f.size() || f.size() - at < 16) throw Error("ICO: truncated bitmap header");
  const uint32_t hsize = le32(&f[at]);
  if (hsize < 12 || hsize > f.size() - at) throw Error("ICO: truncated bitmap header");
  std::vector<uint8_t> bmp(14, 0);
  bmp.insert(bmp.end(), f.begin() + long(at), f.end());
  uint8_t* hd = &bmp[14];
  size_t colours = 0, padding = hsize == 12 ? 3 : 4, extra = 0;
  int bits;
  if (hsize == 12) {
    uint32_t h = le16(hd + 6) / 2;
    hd[6] = uint8_t(h);
    hd[7] = uint8_t(h >> 8);
    bits = int(le16(hd + 10));
  } else {
    if (hsize < 40) throw Error("ICO: bad bitmap header");
    int32_t h = int32_t(le32(hd + 8));
    h = int32_t(double(h) / 2);  // Python's int(h / 2)
    for (int k = 0; k < 4; ++k) hd[8 + k] = uint8_t(uint32_t(h) >> (8 * k));
    bits = int(le16(hd + 14));
    colours = le32(hd + 32);
    if (le32(hd + 16) == 3 && hsize == 40) extra = 12;
  }
  if (bits <= 8 && colours == 0) colours = size_t(1) << bits;
  if (bits > 8) colours = 0;
  const size_t offset = 14 + hsize + extra + padding * colours;
  bmp[0] = 'B';
  bmp[1] = 'M';
  for (int k = 0; k < 4; ++k) bmp[10 + k] = uint8_t(offset >> (8 * k));
  *data_at = at + offset - 14;
  return decode_bmp_image(bmp);
}

// Image.convert("RGBA") of the modes PIL's BMP reader gives
void to_rgba(Image& img) {
  if (img.mode == MODE_RGBA) return;
  std::vector<uint8_t> out(size_t(img.w) * img.h * 4, 255);
  for (size_t i = 0; i < size_t(img.w) * img.h; ++i) {
    uint8_t* o = &out[4 * i];
    if (img.mode == MODE_RGB) {
      std::memcpy(o, &img.data[3 * i], 3);
    } else if (img.mode == MODE_P) {
      size_t k = img.data[i];
      for (int c = 0; c < 3; ++c)
        o[c] = 3 * k + 2 < img.palette.size() ? img.palette[3 * k + size_t(c)] : 0;
    } else {  // L, 1
      uint8_t v = img.mode == MODE_1 ? uint8_t(img.data[i] * 255) : img.data[i];
      o[0] = o[1] = o[2] = v;
    }
  }
  img.data.swap(out);
  img.palette.clear();
  img.mode = MODE_RGBA;
  img.channels = 4;
}

std::vector<IcoEntry> entries(const std::vector<uint8_t>& f) {
  if (f.size() < 6) throw Error("ICO: truncated header");
  const size_t n = le16(&f[4]);
  if (6 + 16 * n > f.size()) throw Error("ICO: truncated directory");
  std::vector<IcoEntry> out;
  for (size_t i = 0; i < n; ++i) {
    const uint8_t* s = &f[6 + 16 * i];
    IcoEntry e;
    e.w = s[0] ? s[0] : 256;
    e.h = s[1] ? s[1] : 256;
    e.bpp = int(le16(s + 6));
    e.size = le32(s + 8);
    e.offset = le32(s + 12);
    int from_colours = s[2] ? int(std::ceil(std::log(double(s[2])) / std::log(2.0))) : 0;
    e.depth = e.bpp ? e.bpp : (from_colours ? from_colours : 256);
    out.push_back(e);
  }
  return out;
}

}  // namespace

Image decode_ico(const std::vector<uint8_t>& f) {
  std::vector<IcoEntry> all = entries(f);
  if (all.empty()) throw Error("ICO: no icons");
  std::stable_sort(all.begin(), all.end(),
                   [](const IcoEntry& a, const IcoEntry& b) { return a.depth < b.depth; });
  std::stable_sort(all.begin(), all.end(), [](const IcoEntry& a, const IcoEntry& b) {
    return a.w * a.h > b.w * b.h;
  });
  const IcoEntry& e = all[0];
  static const uint8_t png_sig[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  if (e.offset <= f.size() && f.size() - e.offset >= 8 && !std::memcmp(&f[e.offset], png_sig, 8))
    return decode_png_image(std::vector<uint8_t>(f.begin() + long(e.offset), f.end()));
  size_t data_at = 0;
  Image img = half_height_dib(f, e.offset, &data_at);
  const size_t w = size_t(img.w), h = size_t(img.h);
  std::vector<uint8_t> alpha(w * h);
  if (e.bpp == 32) {
    if (data_at > f.size() || f.size() - data_at < w * h * 4)
      throw Error("ICO: not enough alpha data");
    for (size_t i = 0; i < w * h; ++i) {
      size_t r = i / w, x = i % w;  // rows bottom-up
      alpha[(h - 1 - r) * w + x] = f[data_at + 4 * i + 3];
    }
  } else {
    const size_t padded = (w + 31) / 32 * 32, total = padded * h / 8;
    const int64_t at = int64_t(e.offset) + int64_t(e.size) - int64_t(total);
    if (at < 0 || size_t(at) > f.size() || f.size() - size_t(at) < total)
      throw Error("ICO: not enough mask data");
    for (size_t r = 0; r < h; ++r)
      for (size_t x = 0; x < w; ++x) {
        int bit = (f[size_t(at) + r * (padded / 8) + (x >> 3)] >> (7 - (x & 7))) & 1;
        alpha[(h - 1 - r) * w + x] = bit ? 0 : 255;
      }
  }
  to_rgba(img);
  for (size_t i = 0; i < w * h; ++i) img.data[4 * i + 3] = alpha[i];
  return img;
}

Image decode_cur(const std::vector<uint8_t>& f) {
  std::vector<IcoEntry> all = entries(f);
  if (all.empty()) throw Error("CUR: no cursors");
  size_t pick = 0;
  for (size_t i = 1; i < all.size(); ++i) {
    const uint8_t* m = &f[6 + 16 * pick];
    const uint8_t* s = &f[6 + 16 * i];
    if (s[0] > m[0] && s[1] > m[1]) pick = i;
  }
  size_t data_at = 0;
  return half_height_dib(f, le32(&f[6 + 16 * pick + 12]), &data_at);
}

}  // namespace pslx
