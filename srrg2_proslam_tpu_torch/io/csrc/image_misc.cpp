// Sun raster, MSP, XBM, XPM and SPIDER as PIL 12 reads them.
//
// SPIDER (SpiderImagePlugin, no magic): 27 header floats, big-endian
// first, then little-endian; a header where the values PIL checks are
// whole numbers, the form is one PIL knows and the header length is the
// record count x the record length; a 2-D image (form 1, else the file is
// not PIL's SPIDER) of float32 samples (F) after the header (two headers
// for the first image of a stack).
// SUN (SunImagePlugin): big-endian header; 1-bit ("1", 0 is white), 4- and
// 8-bit gray (L; 4-bit samples x 17) or palette (P with an RGB;L colour
// map of at most 1024 bytes), 24 / 32-bit RGB (RGB order for type 3, BGR
// otherwise); rows padded to 16 bits; type 2 run-length coded as
// SunRleDecode.c does (0x80 n v: n + 1 copies of v, 0x80 0: a literal
// 0x80; a run may continue into the next rows, which are unpadded then).
// MSP (MspImagePlugin): the header's 16-bit XOR checksum must be zero;
// "DanM" raw 1-bit rows, "LinS" rows through the row map (0: a blank
// white row; a zero byte then count, value: a run; else a literal run).
// XBM (XbmImagePlugin): PIL's header pattern in the first 512 bytes, then
// the two characters after each 'x' as a hex byte, bits least significant
// first.  XPM (XpmImagePlugin): "width height colours chars" then the
// colour lines (``c #RRGGBB`` only), P for at most 256 colours, else RGB;
// the pixel lines between their first and last quotes.

#include <algorithm>
#include <array>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

int hexval(uint8_t v) {
  return (v >= '0' && v <= '9') ? v - '0'
         : (v >= 'a' && v <= 'f') ? v - 'a' + 10
         : (v >= 'A' && v <= 'F') ? v - 'A' + 10 : 0;
}

}  // namespace

Image decode_sun(const std::vector<uint8_t>& f) {
  if (f.size() < 32 || be32(f.data()) != 0x59A66A95u) throw Error("not a SUN raster file");
  const uint32_t w = be32(&f[4]), h = be32(&f[8]), depth = be32(&f[12]), type = be32(&f[20]),
                 pal_type = be32(&f[24]), pal_len = be32(&f[28]);
  Image img;
  if (depth == 1) img.mode = MODE_1;
  else if (depth == 4 || depth == 8) img.mode = MODE_L;
  else if (depth == 24 || depth == 32) img.mode = MODE_RGB;
  else throw Error("SUN: unsupported depth " + std::to_string(depth));
  size_t pos = 32;
  if (pal_len) {
    if (pal_len > 1024) throw Error("SUN: unsupported colour map length");
    if (pal_type != 1) throw Error("SUN: unsupported colour map type");
    if (img.mode == MODE_L) {
      img.mode = MODE_P;
      const size_t n = std::min<size_t>(pal_len, f.size() - 32) / 3;
      for (size_t i = 0; i < n; ++i)
        for (size_t k = 0; k < 3; ++k) img.palette.push_back(f[32 + k * n + i]);
    }
    pos += pal_len;
  }
  if (type > 5) throw Error("SUN: unsupported raster type " + std::to_string(type));
  if (too_many_pixels(w, h) || w == 0 || h == 0) throw Error("SUN: bad image size");
  img.w = int(w);
  img.h = int(h);
  img.channels = img.mode == MODE_RGB ? 3 : 1;
  img.data.assign(size_t(w) * h * img.channels, 0);
  const size_t rowbytes = (size_t(w) * depth + 7) / 8;
  const size_t stride = type == 2 ? rowbytes : (size_t(w) * depth + 15) / 16 * 2;
  std::vector<uint8_t> rows(stride * h);
  if (type == 2) {  // SunRleDecode.c over unpadded rows
    size_t x = 0, total = rows.size();
    while (x < total) {
      if (pos >= f.size()) throw Error("SUN: truncated image data");
      if (f[pos] == 0x80) {
        if (pos + 1 >= f.size()) throw Error("SUN: truncated image data");
        if (f[pos + 1] == 0) {
          rows[x++] = 0x80;
          pos += 2;
        } else {
          if (pos + 2 >= f.size()) throw Error("SUN: truncated image data");
          size_t n = std::min<size_t>(size_t(f[pos + 1]) + 1, total - x);
          std::memset(&rows[x], f[pos + 2], n);
          x += n;
          pos += 3;
        }
      } else {
        rows[x++] = f[pos++];
      }
    }
  } else {
    if (pos > f.size() || rows.size() > f.size() - pos) throw Error("SUN: truncated image data");
    std::memcpy(rows.data(), &f[pos], rows.size());
  }
  const bool rgb_order = type == 3;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t* s = &rows[size_t(y) * stride];
    uint8_t* d = &img.data[size_t(y) * w * img.channels];
    for (uint32_t x = 0; x < w; ++x) {
      if (depth == 1) {
        d[x] = uint8_t(1 - ((s[x >> 3] >> (7 - (x & 7))) & 1));  // "1;I"
      } else if (depth == 4) {
        int v = (s[x >> 1] >> ((x & 1) ? 0 : 4)) & 15;
        d[x] = uint8_t(img.mode == MODE_P ? v : v * 17);
      } else if (depth == 8) {
        d[x] = s[x];
      } else {
        const uint8_t* p = s + size_t(x) * (depth / 8);
        for (int c = 0; c < 3; ++c) d[3 * x + c] = rgb_order ? p[c] : p[2 - c];
      }
    }
  }
  return img;
}

Image decode_msp(const std::vector<uint8_t>& f) {
  if (f.size() < 32 || (std::memcmp(f.data(), "DanM", 4) && std::memcmp(f.data(), "LinS", 4)))
    throw Error("not an MSP file");
  uint32_t sum = 0;
  for (int i = 0; i < 32; i += 2) sum ^= le16(&f[size_t(i)]);
  if (sum) throw Error("MSP: bad checksum");
  const uint32_t w = le16(&f[4]), h = le16(&f[6]);
  if (w == 0 || h == 0) throw Error("MSP: bad image size");
  const size_t rowbytes = (size_t(w) + 7) / 8;
  std::vector<uint8_t> stream;
  if (!std::memcmp(f.data(), "DanM", 4)) {
    if (32 + rowbytes * h > f.size()) throw Error("MSP: truncated image data");
    stream.assign(f.begin() + 32, f.begin() + long(32 + rowbytes * h));
  } else {  // MspDecoder
    if (32 + size_t(h) * 2 > f.size()) throw Error("MSP: truncated row map");
    size_t pos = 32 + size_t(h) * 2;
    for (uint32_t r = 0; r < h; ++r) {
      const size_t len = le16(&f[32 + 2 * size_t(r)]);
      if (len == 0) {
        stream.insert(stream.end(), rowbytes, 0xFF);
        continue;
      }
      if (pos + len > f.size()) throw Error("MSP: truncated row " + std::to_string(r));
      const uint8_t* row = &f[pos];
      size_t i = 0;
      while (i < len) {
        const int type = row[i++];
        if (type == 0) {
          if (i + 2 > len) throw Error("MSP: corrupted row " + std::to_string(r));
          stream.insert(stream.end(), row[i], row[i + 1]);
          i += 2;
        } else {
          size_t n = std::min<size_t>(size_t(type), len - i);
          stream.insert(stream.end(), row + i, row + i + n);
          i += size_t(type);
        }
      }
      pos += len;
    }
    if (stream.size() < rowbytes * h) throw Error("MSP: not enough image data");
  }
  Image img;
  img.w = int(w);
  img.h = int(h);
  img.mode = MODE_1;
  img.data.assign(size_t(w) * h, 0);
  for (uint32_t y = 0; y < h; ++y)
    for (uint32_t x = 0; x < w; ++x)
      img.data[size_t(y) * w + x] = uint8_t((stream[y * rowbytes + (x >> 3)] >> (7 - (x & 7))) & 1);
  return img;
}

// XbmImagePlugin's header pattern on the first 512 bytes: -> the width,
// height and the end of the match, or false.
bool xbm_header(const std::vector<uint8_t>& f, uint32_t* w, uint32_t* h, size_t* end) {
  const size_t n = std::min<size_t>(512, f.size());
  std::string s(reinterpret_cast<const char*>(f.data()), n);
  size_t p = 0;
  auto spaces = [&](const char* set) {
    while (p < s.size() && std::strchr(set, s[p]) && s[p]) ++p;
  };
  auto define = [&](const char* suffix, uint32_t* value) -> bool {
    // #define[ \t]+.*<suffix>[ \t]+([0-9]+)[\r\n]+ (.* greedy: the last match on the line)
    if (s.compare(p, 7, "#define")) return false;
    p += 7;
    size_t q = p;
    spaces(" \t");
    if (p == q) return false;
    size_t eol = s.find_first_of("\r\n", p);
    if (eol == std::string::npos) return false;
    std::string line = s.substr(p, eol - p);
    size_t best = std::string::npos;
    for (size_t at = line.find(suffix); at != std::string::npos; at = line.find(suffix, at + 1)) {
      size_t k = at + std::strlen(suffix), sp = k;
      while (k < line.size() && (line[k] == ' ' || line[k] == '\t')) ++k;
      size_t d = k;
      while (k < line.size() && line[k] >= '0' && line[k] <= '9') ++k;
      if (k > sp && d > sp && k > d && k == line.size()) best = at;
    }
    if (best == std::string::npos) return false;
    size_t k = best + std::strlen(suffix);
    while (line[k] == ' ' || line[k] == '\t') ++k;
    *value = uint32_t(std::stoul(line.substr(k)));
    p = eol;
    size_t before = p;
    spaces("\r\n");
    return p > before;
  };
  spaces(" \t\n\r\v\f");
  if (!define("_width", w) || !define("_height", h)) return false;
  size_t bits = s.find("_bits[]", p);
  if (bits == std::string::npos) return false;
  size_t last;
  for (last = bits; s.find("_bits[]", last + 1) != std::string::npos;)
    last = s.find("_bits[]", last + 1);
  *end = last + 7;
  return true;
}

Image decode_xbm(const std::vector<uint8_t>& f) {
  uint32_t w, h;
  size_t pos;
  if (!xbm_header(f, &w, &h, &pos)) throw Error("XBM: not a XBM file (PIL's header pattern)");
  if (w == 0 || h == 0 || too_many_pixels(w, h)) throw Error("XBM: bad image size");
  Image img;
  img.w = int(w);
  img.h = int(h);
  img.mode = MODE_1;
  img.data.assign(size_t(w) * h, 0);
  const size_t rowbytes = (size_t(w) + 7) / 8;
  for (size_t i = 0; i < rowbytes * h; ++i) {  // XbmDecode.c
    while (pos < f.size() && f[pos] != 'x') ++pos;
    if (pos + 3 > f.size()) throw Error("XBM: not enough image data");
    const int byte = (hexval(f[pos + 1]) << 4) + hexval(f[pos + 2]);
    pos += 3;
    const size_t y = i / rowbytes, x0 = (i % rowbytes) * 8;
    for (size_t b = 0; b < 8 && x0 + b < w; ++b)  // "1;R"
      img.data[y * w + x0 + b] = uint8_t((byte >> b) & 1);
  }
  return img;
}

Image decode_xpm(const std::vector<uint8_t>& f) {
  if (f.size() < 9 || std::memcmp(f.data(), "/* XPM */", 9)) throw Error("not an XPM file");
  size_t pos = 9;
  auto readline = [&]() {
    size_t end = pos;
    while (end < f.size() && f[end] != '\n') ++end;
    if (end < f.size()) ++end;
    std::string line(reinterpret_cast<const char*>(&f[pos]), end - pos);
    pos = end;
    return line;
  };
  long vals[4];
  for (;;) {  // re.match('"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)') on each line
    if (pos >= f.size()) throw Error("XPM: broken XPM file");
    std::string line = readline();
    if (line.empty() || line[0] != '"') continue;
    size_t p = 1;
    bool matched = true, empty = false;
    for (int k = 0; k < 4 && matched; ++k) {
      size_t d = p;
      while (p < line.size() && std::isdigit(static_cast<unsigned char>(line[p]))) ++p;
      empty |= p == d;
      vals[k] = p > d ? std::stol(line.substr(d, std::min<size_t>(p - d, 12))) : 0;
      if (k < 3) matched = p < line.size() && line[p++] == ' ';
    }
    if (!matched) continue;
    if (empty) throw Error("XPM: bad header");  // int('') in PIL
    break;
  }
  const long w = vals[0], h = vals[1], colours = vals[2], bpp = vals[3];
  if (w <= 0 || h <= 0 || bpp <= 0 || too_many_pixels(uint64_t(w), uint64_t(h)))
    throw Error("XPM: bad image size");
  std::vector<std::string> keys;
  std::map<std::string, std::array<uint8_t, 3>> table;
  for (long i = 0; i < colours; ++i) {
    std::string line = readline();
    while (!line.empty() && std::isspace(static_cast<unsigned char>(line.back()))) line.pop_back();
    if (line.size() < size_t(bpp) + 1) throw Error("XPM: cannot read this XPM file");
    std::string key = line.substr(1, size_t(bpp));
    std::string rest = line.size() >= size_t(bpp) + 3 ? line.substr(size_t(bpp) + 1,
                                                                     line.size() - bpp - 3)
                                                      : "";
    std::vector<std::string> words;
    size_t p = 0;
    while (p < rest.size()) {
      while (p < rest.size() && std::isspace(static_cast<unsigned char>(rest[p]))) ++p;
      size_t q = p;
      while (q < rest.size() && !std::isspace(static_cast<unsigned char>(rest[q]))) ++q;
      if (q > p) words.push_back(rest.substr(p, q - p));
      p = q;
    }
    bool done = false;
    for (size_t k = 0; k < words.size(); k += 2) {
      if (words[k] != "c") continue;
      if (k + 1 >= words.size()) throw Error("XPM: cannot read this XPM file");
      const std::string& rgb = words[k + 1];
      done = true;
      if (rgb == "None") break;  // transparency: no colour, as in PIL
      if (rgb.empty() || rgb[0] != '#') throw Error("XPM: cannot read this XPM file");
      unsigned long v = std::stoul(rgb.substr(1), nullptr, 16);
      if (!table.count(key)) keys.push_back(key);
      table[key] = {uint8_t(v >> 16), uint8_t(v >> 8), uint8_t(v)};
      break;
    }
    if (!done) throw Error("XPM: cannot read this XPM file");
  }
  Image img;
  img.w = int(w);
  img.h = int(h);
  img.mode = colours > 256 ? MODE_RGB : MODE_P;
  img.channels = img.mode == MODE_RGB ? 3 : 1;
  if (img.mode == MODE_P)
    for (auto& k : keys) img.palette.insert(img.palette.end(), table[k].begin(), table[k].end());
  const size_t total = size_t(w) * h;
  img.data.assign(total * img.channels, 0);
  size_t px = 0;
  bool header = false;
  while (px < total && pos < f.size()) {
    std::string line = readline();
    std::string trimmed = line;
    while (!trimmed.empty() && std::isspace(static_cast<unsigned char>(trimmed.back())))
      trimmed.pop_back();
    if (trimmed == "/* pixels */" && !header) {
      header = true;
      continue;
    }
    size_t a = line.find('"'), b = line.rfind('"');
    if (a == std::string::npos || a == b) continue;
    std::string body = line.substr(a + 1, b - a - 1);
    for (size_t i = 0; i < body.size() && px < total; i += size_t(bpp)) {
      std::string key = body.substr(i, size_t(bpp));
      auto it = table.find(key);
      if (it == table.end()) throw Error("XPM: a pixel names no colour");
      if (img.mode == MODE_RGB) {
        std::memcpy(&img.data[3 * px], it->second.data(), 3);
      } else {
        size_t idx = 0;
        while (keys[idx] != key) ++idx;
        img.data[px] = uint8_t(idx);
      }
      ++px;
    }
  }
  if (px < total) throw Error("XPM: not enough image data");
  return img;
}

// SpiderImagePlugin.isSpiderHeader on 27 floats of one byte order -> the
// header length, or 0
namespace {

int64_t spider_header_length(const float* t) {
  auto whole = [&](int i) { return std::isfinite(t[i - 1]) && std::trunc(t[i - 1]) == t[i - 1]; };
  for (int i : {1, 2, 5, 12, 13, 22, 23})
    if (!whole(i) || std::fabs(t[i - 1]) > 1e15) return 0;
  const int64_t iform = int64_t(t[4]);
  if (iform != 1 && iform != 3 && iform != -11 && iform != -12 && iform != -21 && iform != -22)
    return 0;
  const int64_t labrec = int64_t(t[12]), labbyt = int64_t(t[21]), lenbyt = int64_t(t[22]);
  if (labbyt != labrec * lenbyt) return 0;
  return labbyt;
}

bool spider_floats(const std::vector<uint8_t>& f, float* t, bool* big) {
  if (f.size() < 27 * 4) return false;
  for (int order = 0; order < 2; ++order) {
    *big = order == 0;
    for (int i = 0; i < 27; ++i) {
      uint32_t bits = *big ? be32(&f[4 * size_t(i)]) : le32(&f[4 * size_t(i)]);
      std::memcpy(&t[i], &bits, 4);
    }
    if (spider_header_length(t)) return true;
  }
  return false;
}

}  // namespace

// Whether PIL's SpiderImageFile claims the file (a valid header of a 2-D
// image)
bool spider_header(const std::vector<uint8_t>& f) {
  float t[27];
  bool big;
  return spider_floats(f, t, &big) && int64_t(t[4]) == 1;
}

Image decode_spider(const std::vector<uint8_t>& f) {
  float t[27];
  bool big;
  if (!spider_floats(f, t, &big) || int64_t(t[4]) != 1) throw Error("not a SPIDER file");
  const int64_t hdrlen = spider_header_length(t);
  const float w = t[11], h = t[1];
  if (!std::isfinite(t[23]) || !std::isfinite(t[26])) throw Error("SPIDER: bad stack header");
  const int64_t istack = int64_t(t[23]), imgnumber = int64_t(t[26]);
  int64_t offset;
  if (istack == 0 && imgnumber == 0) offset = hdrlen;
  else if (istack > 0 && imgnumber == 0) offset = 2 * hdrlen;
  else throw Error("SPIDER: this stack header is not supported (PIL reads none)");
  if (w <= 0 || h <= 0 || too_many_pixels(uint64_t(w), uint64_t(h)) || offset < 0)
    throw Error("SPIDER: bad image size");
  Image img;
  img.w = int(w);
  img.h = int(h);
  img.mode = MODE_F;
  img.bitdepth = 32;
  const size_t n = size_t(img.w) * img.h;
  if (size_t(offset) > f.size() || 4 * n > f.size() - size_t(offset))
    throw Error("SPIDER: truncated image data");
  img.data.resize(4 * n);
  for (size_t i = 0; i < n; ++i) {
    uint32_t bits = big ? be32(&f[size_t(offset) + 4 * i]) : le32(&f[size_t(offset) + 4 * i]);
    std::memcpy(&img.data[4 * i], &bits, 4);
  }
  return img;
}

}  // namespace pslx
