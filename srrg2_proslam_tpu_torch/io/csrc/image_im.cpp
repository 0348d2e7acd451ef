// IM (IFUNC image memory) as PIL 12's ImImagePlugin reads it, for the
// image types its IM writer gives and their aliases: "0 1" / "L 1" / "B1"
// (1), "Greyscale" / "Grayscale" (L, or P with a colour Lut), LA, RGB,
// RGBA, RGBX and CMYK (line-interleaved: a row of each band in turn),
// "X 24" (RGB interleaved), "L 16" / "L 16B" (I;16 / I;16B), "L 32S" (I),
// "L 32F" (F); rows bottom-up after the header's 0x1A (and the 768-byte
// Lut).  ``im_header`` is PIL's test of the header: lines "Key: value" of
// at most 100 bytes up to a NUL or 0x1A, a newline in the first 100 bytes,
// at least one of its known keys.  Other image types are refused.

#include <algorithm>
#include <cctype>
#include <cstdint>
#include <cstring>
#include <map>
#include <stdexcept>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

const char* const kImTags[] = {"Comment", "Date", "Digitalization equipment",
                               "File size (no of images)", "Lut", "Name", "Scale (x,y)",
                               "Image size (x*y)", "Image type"};

// PIL's header loop -> the keys and values, and where the 0x1A ends it;
// false where PIL would not claim the file.
bool parse_header(const std::vector<uint8_t>& f, std::map<std::string, std::string>* kv,
                  size_t* data_at) {
  const size_t probe = std::min<size_t>(100, f.size());
  if (!std::memchr(f.data(), '\n', probe)) return false;
  size_t pos = 0;
  int known = 0;
  for (;;) {
    if (pos >= f.size()) break;
    uint8_t c = f[pos++];
    if (c == '\r') continue;
    if (c == 0 || c == 0x1A) {
      --pos;
      break;
    }
    size_t start = pos - 1, end = pos;
    while (end < f.size() && f[end] != '\n') ++end;
    size_t next = end < f.size() ? end + 1 : end;
    if (next - start > 100) return false;
    size_t line_end = end;
    if (line_end > start && end < f.size() && f[line_end - 1] == '\r') --line_end;
    std::string s(reinterpret_cast<const char*>(&f[start]), line_end - start);
    pos = next;
    // ^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$
    if (s.empty() || !std::isalpha(static_cast<unsigned char>(s[0])) || (s[0] & 0x80))
      return false;
    size_t colon = s.find(':');
    if (colon == std::string::npos) return false;
    size_t v = colon + 1;
    while (v < s.size() && (s[v] == ' ' || s[v] == '\t')) ++v;
    std::string key = s.substr(0, colon);
    (*kv)[key] = s.substr(v);
    for (const char* t : kImTags)
      if (key == t) ++known;
  }
  if (!known) return false;
  while (pos < f.size() && f[pos] != 0x1A) ++pos;
  if (pos >= f.size()) return false;  // "File truncated"
  *data_at = pos + 1;
  return true;
}

}  // namespace

bool im_header(const std::vector<uint8_t>& f) {
  std::map<std::string, std::string> kv;
  size_t at;
  return parse_header(f, &kv, &at);
}

Image decode_im(const std::vector<uint8_t>& f) {
  std::map<std::string, std::string> kv;
  size_t pos;
  if (!parse_header(f, &kv, &pos)) throw Error("not an IM file");
  long w = 512, h = 512;
  if (kv.count("Image size (x*y)")) {
    const std::string& v = kv["Image size (x*y)"];
    size_t star = v.find_first_of("*,");
    if (star == std::string::npos) throw Error("IM: bad image size");
    try {
      size_t a, b;
      w = std::stol(v.substr(0, star), &a);
      h = std::stol(v.substr(star + 1), &b);
      if (v.find_first_not_of(" \t", a) != star ||
          v.find_first_not_of(" \t", star + 1 + b) != std::string::npos)
        throw Error("IM: bad image size");
    } catch (const std::logic_error&) {
      throw Error("IM: bad image size");
    }
  }
  if (w <= 0 || h <= 0 || too_many_pixels(uint64_t(w), uint64_t(h)))
    throw Error("IM: bad image size");
  std::string type = kv.count("Image type") ? kv["Image type"] : "Greyscale image";
  enum { R_1, R_L, R_LINES, R_RGB, R_U16, R_U16B, R_I32, R_F32 } raw;
  Image img;
  int bands = 1;
  if (type == "0 1 image" || type == "L 1 image" || type == "B1 image") {
    img.mode = MODE_1;
    raw = R_1;
  } else if (type == "Greyscale image" || type == "Grayscale image") {
    img.mode = MODE_L;
    raw = R_L;
  } else if (type == "LA image" || type == "RGB image" || type == "RGBA image" ||
             type == "RGBX image" || type == "CMYK image") {
    bands = type[0] == 'L' ? 2 : (type[3] == ' ' ? 3 : 4);
    img.mode = type == "LA image" ? MODE_LA
               : type == "CMYK image" ? MODE_CMYK
               : type == "RGBA image" ? MODE_RGBA : MODE_RGB;
    raw = R_LINES;
  } else if (type == "X 24 image") {
    img.mode = MODE_RGB;
    raw = R_RGB;
  } else if (type == "L 16 image" || type == "L*16 image") {
    img.mode = MODE_I16;
    raw = R_U16;
  } else if (type == "L 16B image" || type == "L*16B image") {
    img.mode = MODE_I16B;
    raw = R_U16B;
  } else if (type == "L 32S image" || type == "L*32S image") {
    img.mode = MODE_I;
    raw = R_I32;
  } else if (type == "L 32F image" || type == "L*32F image") {
    img.mode = MODE_F;
    raw = R_F32;
  } else {
    throw Error("IM: image type \"" + type + "\" is not supported");
  }
  img.w = int(w);
  img.h = int(h);
  if (kv.count("Lut")) {
    if (pos + 768 > f.size()) throw Error("IM: truncated Lut");
    const uint8_t* lut = &f[pos];
    bool grey = true;
    for (int i = 0; i < 256; ++i) grey &= lut[i] == lut[i + 256] && lut[i] == lut[i + 512];
    if (!grey && img.mode == MODE_L) {
      img.mode = MODE_P;
      for (int i = 0; i < 256; ++i)
        for (int k = 0; k < 3; ++k) img.palette.push_back(lut[k * 256 + i]);
    } else if (!grey && img.mode == MODE_LA) {
      throw Error("IM: a colour Lut on LA (PIL's PA) is not supported");
    }
    pos += 768;
  }
  const size_t n = size_t(w) * h;
  const size_t row = raw == R_1 ? (size_t(w) + 7) / 8
                     : raw == R_RGB ? 3 * size_t(w)
                     : raw == R_U16 || raw == R_U16B ? 2 * size_t(w)
                     : raw == R_I32 || raw == R_F32 ? 4 * size_t(w)
                                                    : size_t(bands) * w;
  if (pos > f.size() || row * h > f.size() - pos) throw Error("IM: truncated image data");
  const int channels =
      raw == R_LINES ? (img.mode == MODE_RGB ? 3 : bands) : (raw == R_RGB ? 3 : 1);
  const int bytes = raw == R_U16 || raw == R_U16B ? 2 : (raw == R_I32 || raw == R_F32 ? 4 : 1);
  img.channels = channels;
  img.bitdepth = 8 * bytes;
  img.data.assign(n * channels * bytes, 0);
  for (long r = 0; r < h; ++r) {
    const uint8_t* s = &f[pos + size_t(r) * row];
    uint8_t* d = &img.data[size_t(h - 1 - r) * w * channels * bytes];  // bottom-up
    for (long x = 0; x < w; ++x) {
      if (raw == R_1) {
        d[x] = uint8_t((s[x >> 3] >> (7 - (x & 7))) & 1);
      } else if (raw == R_L) {
        d[x] = s[x];
      } else if (raw == R_LINES) {
        for (int c = 0; c < channels; ++c) d[x * channels + c] = s[size_t(c) * w + size_t(x)];
      } else if (raw == R_RGB) {
        std::memcpy(d + 3 * x, s + 3 * x, 3);
      } else if (raw == R_U16B) {  // kept big-endian as PIL holds I;16B: as a value here
        uint16_t v = uint16_t(be16(s + 2 * x));
        std::memcpy(d + 2 * x, &v, 2);
      } else {
        std::memcpy(d + bytes * x, s + bytes * x, size_t(bytes));
      }
    }
  }
  return img;
}

}  // namespace pslx
