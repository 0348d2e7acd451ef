// GIF (the first frame) and PNM / PFM as PIL 12 reads them, and PIL's GIF
// writer for mode L.
//
// GIF: the frame's LZW codes (global or local colour table, interlaced or
// not) on a canvas of the logical screen, grown to hold the frame, whose
// other pixels are the frame's transparent index or 0.  The mode is P
// unless the frame's colour table is the identity gray ramp (or there is
// none): then L, as GifImagePlugin._is_palette_needed decides.
// PNM (PpmImagePlugin.py): P1 / P4 as mode 1 (a set bit is black), P2 / P5
// as L, or I when maxval > 255, P3 / P6 as RGB; samples scaled to 255 (I:
// 65535) as round(v / maxval * out) unless maxval is 255 (65535 for 16-bit
// P5).  Pf is mode F, rows stored bottom-up; PF (colour) PIL does not read.
// The writer: the used gray levels as the global colour table (ascending,
// padded to a power of two, at least 4), rows interlaced when both sides
// are at least 16, 8-bit LZW with a clear code first and when the table
// reaches 4096 codes, 255-byte sub-blocks, GIF87a.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

bool palette_needed(const uint8_t* p, size_t entries) {
  for (size_t i = 0; i < entries; ++i)
    if (p[3 * i] != i || p[3 * i + 1] != i || p[3 * i + 2] != i) return true;
  return false;
}

std::vector<int> interlaced_rows(int h) {
  std::vector<int> rows;
  const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
  for (int p = 0; p < 4; ++p)
    for (int y = start[p]; y < h; y += step[p]) rows.push_back(y);
  return rows;
}

// GifDecode.c: LSB-first codes from the initial size + 1 up to 12 bits.
std::vector<uint8_t> gif_lzw(const std::vector<uint8_t>& data, int bits, size_t want) {
  if (bits < 1 || bits > 11) throw Error("GIF: bad LZW code size");
  const int clear = 1 << bits, eoi = clear + 1;
  std::vector<int> prefix(4096, -1);
  std::vector<uint8_t> suffix(4096), first(4096), stack;
  for (int i = 0; i < clear; ++i) suffix[size_t(i)] = first[size_t(i)] = uint8_t(i);
  std::vector<uint8_t> out;
  out.reserve(want);
  size_t bitpos = 0, total = data.size() * 8;
  int width = bits + 1, next = clear + 2, old = -1;
  while (out.size() < want && bitpos + size_t(width) <= total) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code |= ((data[bitpos >> 3] >> (bitpos & 7)) & 1) << b;
    if (code == clear) {
      width = bits + 1;
      next = clear + 2;
      old = -1;
      continue;
    }
    if (code == eoi) break;
    if (old < 0) {
      if (code >= clear) throw Error("GIF: corrupt LZW data");
      out.push_back(uint8_t(code));
      old = code;
      continue;
    }
    if (code > next) throw Error("GIF: corrupt LZW data");
    int emit_code = code;
    if (next < 4096) {
      prefix[size_t(next)] = old;
      suffix[size_t(next)] = code < next ? first[size_t(code)] : first[size_t(old)];
      first[size_t(next)] = first[size_t(old)];
      ++next;
      if (next == (1 << width) && width < 12) ++width;
    } else if (code == next) {
      throw Error("GIF: corrupt LZW data");
    }
    stack.clear();
    for (int c = emit_code; c >= 0; c = prefix[size_t(c)]) stack.push_back(suffix[size_t(c)]);
    for (size_t i = stack.size(); i-- > 0;) out.push_back(stack[i]);
    old = code;
  }
  if (out.size() > want) out.resize(want);
  return out;
}

// ---- PNM helpers -------------------------------------------------------------

bool pnm_space(uint8_t c) {
  return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == '\v' || c == '\f';
}

// PpmImagePlugin._read_token: skip whitespace and comments, read up to 10
// characters; pos ends past the whitespace character that ends the token.
std::string pnm_token(const std::vector<uint8_t>& f, size_t& pos) {
  std::string tok;
  while (tok.size() <= 10) {
    if (pos >= f.size()) break;
    uint8_t c = f[pos++];
    if (pnm_space(c)) {
      if (tok.empty()) continue;
      break;
    }
    if (c == '#') {
      while (pos < f.size() && f[pos] != '\r' && f[pos] != '\n') ++pos;
      if (pos < f.size()) ++pos;
      continue;
    }
    tok.push_back(char(c));
  }
  if (tok.empty()) throw Error("PNM: the header ends early");
  if (tok.size() > 10) throw Error("PNM: token too long in the header");
  return tok;
}

long pnm_int(const std::string& tok) {
  char* end = nullptr;
  long v = std::strtol(tok.c_str(), &end, 10);
  if (!end || *end) throw Error("PNM: bad number in the header");
  return v;
}

// The plain formats' data with comments removed (to CR or LF).
std::vector<uint8_t> strip_comments(const std::vector<uint8_t>& f, size_t pos) {
  std::vector<uint8_t> out;
  while (pos < f.size()) {
    if (f[pos] == '#') {
      while (pos < f.size() && f[pos] != '\r' && f[pos] != '\n') ++pos;
      if (pos < f.size()) ++pos;
      continue;
    }
    out.push_back(f[pos++]);
  }
  return out;
}

}  // namespace

Image decode_gif(const std::vector<uint8_t>& f) {
  if (f.size() < 13 || (std::memcmp(f.data(), "GIF87a", 6) && std::memcmp(f.data(), "GIF89a", 6)))
    throw Error("not a GIF file");
  int sw = int(le16(&f[6])), sh = int(le16(&f[8]));
  int flags = f[10];
  size_t pos = 13;
  std::vector<uint8_t> global;
  if (flags & 128) {
    size_t n = size_t(3) << ((flags & 7) + 1);
    if (pos + n > f.size()) throw Error("GIF: truncated colour table");
    if (palette_needed(&f[pos], n / 3))
      global.assign(f.begin() + long(pos), f.begin() + long(pos + n));
    pos += n;
  }
  int transparency = -1;
  for (;;) {
    if (pos >= f.size()) throw Error("GIF: no image in the file");
    uint8_t s = f[pos++];
    if (s == '!') {
      if (pos >= f.size()) throw Error("GIF: truncated extension");
      uint8_t label = f[pos++];
      bool first_block = true;
      while (pos < f.size() && f[pos]) {
        size_t n = f[pos];
        if (pos + 1 + n > f.size()) throw Error("GIF: truncated extension");
        if (label == 0xF9 && first_block && n >= 4 && (f[pos + 1] & 1)) transparency = f[pos + 4];
        first_block = false;
        pos += 1 + n;
      }
      ++pos;
      continue;
    }
    if (s == ',') break;
    if (s == ';') throw Error("GIF: no image in the file");
    // other bytes are skipped, as PIL does
  }
  if (pos + 9 > f.size()) throw Error("GIF: truncated image descriptor");
  int x0 = int(le16(&f[pos])), y0 = int(le16(&f[pos + 2]));
  int fw = int(le16(&f[pos + 4])), fh = int(le16(&f[pos + 6]));
  int lflags = f[pos + 8];
  pos += 9;
  bool interlace = (lflags & 64) != 0;
  std::vector<uint8_t> palette = global;
  if (lflags & 128) {  // a local colour table replaces the global one
    size_t n = size_t(3) << ((lflags & 7) + 1);
    if (pos + n > f.size()) throw Error("GIF: truncated colour table");
    palette.clear();
    if (palette_needed(&f[pos], n / 3))
      palette.assign(f.begin() + long(pos), f.begin() + long(pos + n));
    pos += n;
  }
  if (pos >= f.size()) throw Error("GIF: truncated image data");
  int bits = f[pos++];
  std::vector<uint8_t> data;
  while (pos < f.size() && f[pos]) {
    size_t n = f[pos];
    if (pos + 1 + n > f.size()) throw Error("GIF: truncated image data");
    data.insert(data.end(), f.begin() + long(pos + 1), f.begin() + long(pos + 1 + n));
    pos += 1 + n;
  }
  int w = std::max(sw, x0 + fw), h = std::max(sh, y0 + fh);
  if (w <= 0 || h <= 0 || too_many_pixels(uint64_t(w), uint64_t(h)))
    throw Error("GIF: bad image size");
  std::vector<uint8_t> px = gif_lzw(data, bits, size_t(fw) * fh);
  if (px.size() < size_t(fw) * fh) throw Error("GIF: truncated image data");
  Image img;
  img.w = w;
  img.h = h;
  img.channels = 1;
  img.mode = palette.empty() ? MODE_L : MODE_P;
  img.palette = palette;
  img.data.assign(size_t(w) * h, uint8_t(transparency >= 0 ? transparency : 0));
  std::vector<int> rows;
  if (interlace) rows = interlaced_rows(fh);
  for (int r = 0; r < fh; ++r) {
    int y = y0 + (interlace ? rows[size_t(r)] : r);
    std::memcpy(&img.data[size_t(y) * w + x0], &px[size_t(r) * fw], size_t(fw));
  }
  return img;
}

Image decode_pnm(const std::vector<uint8_t>& f) {
  size_t pos = 0;
  std::string magic;
  while (pos < f.size() && magic.size() < 6 && !pnm_space(f[pos])) magic.push_back(char(f[pos++]));
  if (pos < f.size() && magic.size() < 6) ++pos;  // the whitespace that ends the magic
  const std::string known[] = {"P1", "P2", "P3", "P4", "P5", "P6", "Pf"};
  bool ok = false;
  for (auto& k : known) ok |= magic == k;
  if (!ok) throw Error("PNM: magic " + magic + " is not supported");
  long w = pnm_int(pnm_token(f, pos)), h = pnm_int(pnm_token(f, pos));
  if (w <= 0 || h <= 0 || too_many_pixels(uint64_t(w), uint64_t(h)))
    throw Error("PNM: bad image size");
  size_t npx = size_t(w) * size_t(h);
  Image img;
  img.w = int(w);
  img.h = int(h);
  char kind = magic[1];
  if (kind == 'f') {
    std::string tok = pnm_token(f, pos);
    double scale = std::strtod(tok.c_str(), nullptr);
    if (scale == 0.0 || !std::isfinite(scale))
      throw Error("PFM: the scale must be finite and non-zero");
    if (pos + npx * 4 > f.size()) throw Error("PFM: truncated image data");
    img.mode = MODE_F;
    img.bitdepth = 32;
    img.data.resize(npx * 4);
    for (long y = 0; y < h; ++y)
      for (long x = 0; x < w; ++x) {
        const uint8_t* p = &f[pos + 4 * (size_t(h - 1 - y) * w + x)];
        uint32_t v = scale < 0 ? le32(p) : be32(p);
        std::memcpy(&img.data[4 * (size_t(y) * w + x)], &v, 4);
      }
    return img;
  }
  if (kind == '1' || kind == '4') {
    img.mode = MODE_1;
    img.data.resize(npx);
    if (kind == '4') {
      size_t stride = size_t((w + 7) / 8);
      if (pos + stride * h > f.size()) throw Error("PBM: truncated image data");
      for (long y = 0; y < h; ++y)
        for (long x = 0; x < w; ++x)
          img.data[size_t(y) * w + x] =
              uint8_t(!((f[pos + y * stride + x / 8] >> (7 - x % 8)) & 1));
      return img;
    }
    std::vector<uint8_t> body = strip_comments(f, pos);
    size_t n = 0;
    for (uint8_t c : body) {
      if (pnm_space(c)) continue;
      if (c != '0' && c != '1') throw Error("PBM: invalid token in the data");
      if (n < npx) img.data[n++] = uint8_t(c == '0');
    }
    if (n < npx) throw Error("PBM: truncated image data");
    return img;
  }
  long maxval = pnm_int(pnm_token(f, pos));
  if (maxval <= 0 || maxval >= 65536) throw Error("PNM: maxval must be in 1..65535");
  int bands = (kind == '3' || kind == '6') ? 3 : 1;
  bool wide = bands == 1 && maxval > 255;  // mode I
  long out_max = wide ? 65535 : 255;
  img.mode = bands == 3 ? MODE_RGB : (wide ? MODE_I : MODE_L);
  img.channels = bands;
  img.bitdepth = wide ? 32 : 8;
  size_t count = npx * size_t(bands);
  std::vector<long> vals(count);
  if (kind == '2' || kind == '3') {
    std::vector<uint8_t> body = strip_comments(f, pos);
    size_t n = 0, i = 0;
    while (n < count) {
      while (i < body.size() && pnm_space(body[i])) ++i;
      if (i >= body.size()) break;
      size_t j = i;
      while (j < body.size() && !pnm_space(body[j])) ++j;
      if (j - i > 10) throw Error("PNM: token too long in the data");
      std::string tok(body.begin() + long(i), body.begin() + long(j));
      long v = pnm_int(tok);
      if (v < 0 || v > maxval) throw Error("PNM: sample out of range");
      vals[n++] = std::lrint(double(v) / double(maxval) * double(out_max));
      i = j;
    }
    if (n < count) throw Error("PNM: truncated image data");
  } else {
    bool two = maxval > 255;
    size_t need = count * (two ? 2 : 1);
    if (pos + need > f.size()) throw Error("PNM: truncated image data");
    for (size_t i = 0; i < count; ++i) {
      long v = two ? long(be16(&f[pos + 2 * i])) : long(f[pos + i]);
      bool as_is = maxval == 255 || (wide && maxval == 65535);
      vals[i] = as_is ? v
                      : std::min(out_max, std::lrint(double(v) / double(maxval) * double(out_max)));
    }
  }
  if (wide) {
    img.data.resize(count * 4);
    int32_t* d = reinterpret_cast<int32_t*>(img.data.data());
    for (size_t i = 0; i < count; ++i) d[i] = int32_t(vals[i]);
  } else {
    img.data.resize(count);
    for (size_t i = 0; i < count; ++i) img.data[i] = uint8_t(vals[i] > 255 ? 255 : vals[i]);
  }
  return img;
}

std::vector<uint8_t> encode_gif_gray(const uint8_t* px, int w, int h) {
  size_t npx = size_t(w) * h;
  bool used[256] = {false};
  for (size_t i = 0; i < npx; ++i) used[px[i]] = true;
  uint8_t index[256] = {0};
  std::vector<uint8_t> levels;
  for (int v = 0; v < 256; ++v)
    if (used[v]) {
      index[v] = uint8_t(levels.size());
      levels.push_back(uint8_t(v));
    }
  size_t n = levels.size();
  int size = 1;
  if (n * 3 >= 9) {
    size = 0;
    while ((size_t(1) << size) < n) ++size;
    size -= 1;
  }
  std::vector<uint8_t> out = {'G', 'I', 'F', '8', '7', 'a', uint8_t(w), uint8_t(w >> 8),
                              uint8_t(h), uint8_t(h >> 8), uint8_t(128 + size), 0, 0};
  for (size_t i = 0; i < (size_t(2) << size); ++i)
    for (int k = 0; k < 3; ++k) out.push_back(i < n ? levels[i] : 0);
  bool interlace = std::min(w, h) >= 16;
  out.insert(out.end(), {',', 0, 0, 0, 0, uint8_t(w), uint8_t(w >> 8), uint8_t(h),
                         uint8_t(h >> 8), uint8_t(interlace ? 64 : 0), 8});
  std::vector<int> rows;
  if (interlace) rows = interlaced_rows(h);
  std::vector<uint8_t> seq(npx);
  for (int r = 0; r < h; ++r) {
    int y = interlace ? rows[size_t(r)] : r;
    for (int x = 0; x < w; ++x) seq[size_t(r) * w + x] = index[px[size_t(y) * w + x]];
  }
  // greedy LZW: a (prefix, byte) -> code table, LSB-first codes
  std::vector<uint8_t> codes;
  uint64_t acc = 0;
  int nacc = 0;
  auto put = [&](int code, int width) {
    acc |= uint64_t(code) << nacc;
    nacc += width;
    while (nacc >= 8) {
      codes.push_back(uint8_t(acc & 0xFF));
      acc >>= 8;
      nacc -= 8;
    }
  };
  std::vector<int> table(size_t(4096) * 256, -1);
  int width = 9, next = 258;
  put(256, width);
  if (npx) {
    int prefix = seq[0];
    for (size_t i = 1; i < npx; ++i) {
      int c = seq[i];
      int& slot = table[size_t(prefix) * 256 + size_t(c)];
      if (slot >= 0) {
        prefix = slot;
        continue;
      }
      put(prefix, width);
      if (next >= 4096) {
        put(256, width);
        std::fill(table.begin(), table.end(), -1);
        width = 9;
        next = 258;
      } else {
        slot = next++;
        if (next > (1 << width) && width < 12) ++width;
      }
      prefix = c;
    }
    put(prefix, width);
    ++next;
    if (next > (1 << width) && width < 12) ++width;
  }
  put(257, width);
  if (nacc) put(0, 8 - nacc);
  for (size_t i = 0; i < codes.size(); i += 255) {
    size_t k = std::min<size_t>(255, codes.size() - i);
    out.push_back(uint8_t(k));
    out.insert(out.end(), codes.begin() + long(i), codes.begin() + long(i + k));
  }
  out.push_back(0);
  out.push_back(';');
  return out;
}

}  // namespace pslx
