// WebP as PIL 12 reads it through libwebp's animation decoder: a still
// image, alone ("VP8L" / "VP8 " chunk) or in an extended file ("VP8X",
// whose alpha flag then decides the mode), RGBA where the file has alpha,
// else RGB.  Lossy (VP8 key frame) as libwebp decodes it: RFC 6386's
// boolean decoder, segments, the coefficient probabilities and their
// updates, intra modes (16x16, 4x4 with libwebp's replicated top-right,
// chroma), the Walsh-Hadamard and TransformOne inverse DCTs on int16
// coefficients, prediction from the unfiltered frame with libwebp's 127 /
// 129 borders, the simple and complex loop filters per macroblock in
// order, and its fancy upsampling with the 14-bit YUV -> RGB; the ALPH
// chunk (raw or VP8L, row filters).  Lossless (VP8L) as libwebp decodes
// it: the predictor
// (14 modes; the top row predicts from the left, the left column from
// above, the right column takes the row's first pixel as top-right),
// cross-colour, subtract-green and colour-indexing transforms (with pixel
// bundling), the colour cache, meta prefix codes, canonical prefix codes
// (simple or from code-length codes), LZ77 references through libwebp's
// 120-entry distance map.  An animated file (VP8X's animation flag) gives
// its first frame as WebPAnimDecoder composites it: the chunks checked as
// libwebp's demuxer checks every frame, then the frame decoded into a
// transparent black canvas at its offset (a key frame: never blended).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <utility>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

const uint8_t kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13,
                                      14, 15};
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a, 0x38, 0x05, 0x37,
    0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56,
    0x5a, 0x23, 0x2d, 0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e, 0x78, 0x01, 0x77,
    0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e,
    0x30, 0x73, 0x7d, 0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70};

struct LsbBits {
  const uint8_t* d;
  size_t n, pos = 0;  // in bits
  LsbBits(const uint8_t* data, size_t size) : d(data), n(size * 8) {}
  uint32_t read(int k) {
    if (pos + size_t(k) > n) throw Error("WebP: truncated lossless data");
    uint32_t v = 0;
    for (int i = 0; i < k; ++i, ++pos) v |= uint32_t((d[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  }
};

// A canonical prefix code read a bit at a time; one used symbol reads none.
struct Prefix {
  int single = -1;
  std::vector<int> first_code, first_index, symbols;  // per length 1..15
  explicit Prefix(const std::vector<int>& lengths) {
    std::vector<int> used;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) used.push_back(int(s));
    if (used.empty()) throw Error("WebP: an empty prefix code");
    if (used.size() == 1) {
      single = used[0];
      return;
    }
    first_code.assign(16, 0);
    first_index.assign(16, 0);
    int code = 0;
    for (int len = 1; len < 16; ++len) {
      first_code[size_t(len)] = code;
      first_index[size_t(len)] = int(symbols.size());
      for (int s : used)
        if (lengths[size_t(s)] == len) {
          symbols.push_back(s);
          ++code;
        }
      code <<= 1;
    }
    if (code != 1 << 16) throw Error("WebP: an incomplete prefix code");
  }
  int read(LsbBits& br) const {
    if (single >= 0) return single;
    int code = 0;
    for (int len = 1; len < 16; ++len) {
      code = code << 1 | int(br.read(1));
      int count = (len + 1 < 16 ? first_index[size_t(len) + 1] : int(symbols.size())) -
                  first_index[size_t(len)];
      if (code >= first_code[size_t(len)] && code - first_code[size_t(len)] < count)
        return symbols[size_t(first_index[size_t(len)] + code - first_code[size_t(len)])];
    }
    throw Error("WebP: a bad prefix code");
  }
};

Prefix prefix_code(LsbBits& br, int size) {
  std::vector<int> lengths(size_t(size), 0);
  if (br.read(1)) {  // simple code
    const int n = int(br.read(1)) + 1;
    const uint32_t first = br.read(br.read(1) ? 8 : 1);
    if (int(first) >= size) throw Error("WebP: a bad simple prefix code");
    lengths[first] = 1;
    if (n == 2) {
      const uint32_t second = br.read(8);
      if (int(second) >= size) throw Error("WebP: a bad simple prefix code");
      lengths[second] = 1;
    }
    return Prefix(lengths);
  }
  std::vector<int> cl(19, 0);
  const int count = int(br.read(4)) + 4;
  for (int i = 0; i < count; ++i) cl[kCodeLengthOrder[i]] = int(br.read(3));
  const Prefix lengths_code(cl);
  int max_symbol = size;
  if (br.read(1)) {
    max_symbol = 2 + int(br.read(2 + 2 * int(br.read(3))));
    if (max_symbol > size) throw Error("WebP: a bad code length count");
  }
  int symbol = 0, prev = 8;
  while (symbol < size) {
    if (max_symbol-- == 0) break;
    const int c = lengths_code.read(br);
    if (c < 16) {
      lengths[size_t(symbol++)] = c;
      if (c) prev = c;
      continue;
    }
    const int repeat = int(br.read(c == 16 ? 2 : (c == 17 ? 3 : 7))) + (c == 18 ? 11 : 3);
    if (symbol + repeat > size) throw Error("WebP: a code length run past the alphabet");
    for (int k = 0; k < repeat; ++k) lengths[size_t(symbol++)] = c == 16 ? prev : 0;
  }
  return Prefix(lengths);
}

int copy_distance(LsbBits& br, int symbol) {
  if (symbol < 4) return symbol + 1;
  const int extra = (symbol - 2) >> 1;
  return ((2 + (symbol & 1)) << extra) + int(br.read(extra)) + 1;
}

struct Transform {
  int kind, bits, width;  // width: the image's width where the transform applies
  std::vector<uint32_t> data;
};

// One entropy-coded image (the main one with ``level0``): its ARGB pixels
// before the transforms, the transforms read, and the width it is coded at.
std::vector<uint32_t> vp8l_image(LsbBits& br, int w, int h, bool level0,
                                 std::vector<Transform>* transforms, int* coded_w) {
  if (level0) {
    while (br.read(1)) {
      Transform t;
      t.kind = int(br.read(2));
      t.width = w;
      for (auto& seen : *transforms)
        if (seen.kind == t.kind) throw Error("WebP: a transform repeated");
      if (t.kind == 0 || t.kind == 1) {
        t.bits = int(br.read(3)) + 2;
        const int sw = (w + (1 << t.bits) - 1) >> t.bits, sh = (h + (1 << t.bits) - 1) >> t.bits;
        t.data = vp8l_image(br, sw, sh, false, nullptr, nullptr);
      } else if (t.kind == 3) {
        const int colours = int(br.read(8)) + 1;
        t.bits = colours > 16 ? 0 : (colours > 4 ? 1 : (colours > 2 ? 2 : 3));
        t.data = vp8l_image(br, colours, 1, false, nullptr, nullptr);
        for (int i = 1; i < colours; ++i) {  // delta-coded per channel
          uint32_t a = t.data[size_t(i) - 1], b = t.data[size_t(i)], sum = 0;
          for (int s = 0; s < 32; s += 8) sum |= (((a >> s) + (b >> s)) & 255) << s;
          t.data[size_t(i)] = sum;
        }
        w = (w + (1 << t.bits) - 1) >> t.bits;
      } else {
        t.bits = 0;
      }
      transforms->push_back(std::move(t));
    }
    *coded_w = w;
  }
  int cache_bits = 0;
  if (br.read(1)) {
    cache_bits = int(br.read(4));
    if (cache_bits < 1 || cache_bits > 11) throw Error("WebP: a bad colour cache size");
  }
  int meta_bits = 0, mw = 0;
  std::vector<uint32_t> meta;
  if (level0 && br.read(1)) {
    meta_bits = int(br.read(3)) + 2;
    mw = (w + (1 << meta_bits) - 1) >> meta_bits;
    const int mh = (h + (1 << meta_bits) - 1) >> meta_bits;
    meta = vp8l_image(br, mw, mh, false, nullptr, nullptr);
    for (auto& p : meta) p = (p >> 8) & 0xFFFF;
  }
  const int groups = meta.empty() ? 1 : int(*std::max_element(meta.begin(), meta.end())) + 1;
  const int cache_size = cache_bits ? 1 << cache_bits : 0;
  std::vector<std::vector<Prefix>> codes;
  for (int g = 0; g < groups; ++g) {
    std::vector<Prefix> group;
    for (int size : {280 + cache_size, 256, 256, 256, 40})
      group.push_back(prefix_code(br, size));
    codes.push_back(std::move(group));
  }
  const size_t total = size_t(w) * size_t(h);
  std::vector<uint32_t> out;
  out.reserve(total);
  std::vector<uint32_t> cache(size_t(cache_size), 0);
  size_t inserted = 0;
  auto insert = [&]() {
    for (; inserted < out.size(); ++inserted) {
      const uint32_t p = out[inserted];
      cache[size_t((0x1E35A7BDu * p) >> (32 - cache_bits))] = p;
    }
  };
  while (out.size() < total) {
    const size_t pos = out.size();
    const std::vector<Prefix>& g =
        meta.empty() ? codes[0]
                     : codes[meta[(pos / size_t(w) >> meta_bits) * size_t(mw) +
                                  (pos % size_t(w) >> meta_bits)]];
    const int code = g[0].read(br);
    if (code < 256) {
      const uint32_t r = uint32_t(g[1].read(br)), b = uint32_t(g[2].read(br)),
                     a = uint32_t(g[3].read(br));
      out.push_back(a << 24 | r << 16 | uint32_t(code) << 8 | b);
    } else if (code < 280) {
      const size_t length = size_t(copy_distance(br, code - 256));
      const int plane = copy_distance(br, g[4].read(br));
      size_t dist;
      if (plane > 120) {
        dist = size_t(plane - 120);
      } else {
        const int d = kCodeToPlane[plane - 1];
        dist = size_t(std::max((d >> 4) * w + 8 - (d & 15), 1));
      }
      if (dist > pos || pos + length > total)
        throw Error("WebP: a backward reference out of the image");
      for (size_t k = 0; k < length; ++k) out.push_back(out[pos - dist + k]);
    } else {
      if (code - 280 >= cache_size) throw Error("WebP: a bad colour cache index");
      insert();
      out.push_back(cache[size_t(code - 280)]);
    }
    if (cache_size) insert();
  }
  return out;
}

inline uint32_t channel(uint32_t v, int s) { return (v >> s) & 255; }

uint32_t average2(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) out |= ((channel(a, s) + channel(b, s)) >> 1) << s;
  return out;
}

uint32_t predict(int mode, uint32_t L, uint32_t T, uint32_t TL, uint32_t TR) {
  switch (mode) {
    case 1: return L;
    case 2: return T;
    case 3: return TR;
    case 4: return TL;
    case 5: return average2(average2(L, TR), T);
    case 6: return average2(L, TL);
    case 7: return average2(L, T);
    case 8: return average2(TL, T);
    case 9: return average2(T, TR);
    case 10: return average2(average2(L, TL), average2(T, TR));
    case 11: {  // select: the one of L and T nearer the gradient estimate
      int pl = 0, pt = 0;
      for (int s = 0; s < 32; s += 8) {
        pl += std::abs(int(channel(T, s)) - int(channel(TL, s)));
        pt += std::abs(int(channel(L, s)) - int(channel(TL, s)));
      }
      return pl < pt ? L : T;
    }
    case 12: {
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8) {
        int v = int(channel(L, s)) + int(channel(T, s)) - int(channel(TL, s));
        out |= uint32_t(std::min(std::max(v, 0), 255)) << s;
      }
      return out;
    }
    case 13: {
      const uint32_t a = average2(L, T);
      uint32_t out = 0;
      for (int s = 0; s < 32; s += 8) {
        int x = int(channel(a, s)), c = int(channel(TL, s)), v = x + (x - c) / 2;
        out |= uint32_t(std::min(std::max(v, 0), 255)) << s;
      }
      return out;
    }
    default: return 0xFF000000u;
  }
}

uint32_t add_pixels(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) out |= ((channel(a, s) + channel(b, s)) & 255) << s;
  return out;
}

inline int s8(uint32_t v) { return int(int8_t(uint8_t(v))); }

// The transforms undone in reverse order -> ARGB [h, w].
std::vector<uint32_t> inverse(std::vector<uint32_t> px, std::vector<Transform>& ts, int h,
                              int coded_w) {
  int w = coded_w;
  for (size_t k = ts.size(); k-- > 0;) {
    const Transform& t = ts[k];
    if (t.kind == 2) {
      for (auto& p : px) {
        const uint32_t g = channel(p, 8);
        p = (p & 0xFF00FF00u) | ((channel(p, 16) + g) & 255) << 16 | ((channel(p, 0) + g) & 255);
      }
    } else if (t.kind == 3) {
      std::vector<uint32_t> table(256, 0);
      std::copy(t.data.begin(), t.data.end(), table.begin());
      std::vector<uint32_t> out(size_t(t.width) * size_t(h));
      const int per = 1 << t.bits, bpp = 8 >> t.bits;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < t.width; ++x) {
          const uint32_t packed = channel(px[size_t(y) * size_t(w) + size_t(x >> t.bits)], 8);
          const uint32_t index = (packed >> ((x & (per - 1)) * bpp)) & ((1u << bpp) - 1);
          out[size_t(y) * size_t(t.width) + size_t(x)] = table[index];
        }
      px.swap(out);
      w = t.width;
    } else {
      const int sw = (w + (1 << t.bits) - 1) >> t.bits;
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t& p = px[size_t(y) * size_t(w) + size_t(x)];
          const uint32_t el = t.data[size_t(y >> t.bits) * size_t(sw) + size_t(x >> t.bits)];
          if (t.kind == 1) {  // cross colour
            const int g = s8(channel(p, 8));
            const uint32_t r = (channel(p, 16) + uint32_t((s8(el) * g) >> 5)) & 255;
            const uint32_t b = (channel(p, 0) + uint32_t((s8(el >> 8) * g) >> 5) +
                                uint32_t((s8(el >> 16) * s8(r)) >> 5)) & 255;
            p = (p & 0xFF00FF00u) | r << 16 | b;
            continue;
          }
          uint32_t pred;
          if (y == 0) {
            pred = x == 0 ? 0xFF000000u : px[size_t(x) - 1];
          } else if (x == 0) {
            pred = px[size_t(y - 1) * size_t(w)];
          } else {
            const size_t at = size_t(y) * size_t(w) + size_t(x), up = at - size_t(w);
            const uint32_t TR = x + 1 < w ? px[up + 1] : px[size_t(y) * size_t(w)];
            pred = predict(int(channel(el, 8) & 15), px[at - 1], px[up], px[up - 1], TR);
          }
          p = add_pixels(p, pred);
        }
    }
  }
  return px;
}

// ---- lossy WebP (VP8 key frame, libwebp's decoder) --------------------------------

const uint8_t kVp8Update[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255,
    250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255,
    234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,};

const uint8_t kVp8Coeffs0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128,
    106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128,
    181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128,
    1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128,
    77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128,
    170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128,
    1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128,
    102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128,
    177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62,
    131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128,
    1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128,
    81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128,
    99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128,
    1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128,
    44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128,
    94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128,
    1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128,
    35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128,
    121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128,
    1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128,
    175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128,
    1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128,
    155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128,
    201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128,
    1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128,
    141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128,
    213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255,
    126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128,
    1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128,
    39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128,
    124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128,
    1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128,
    28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128,
    123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128,
    1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128,
    47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128,
    141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128,
    1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,};

const uint8_t kVp8BModes[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112,
    152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103,
    56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173,
    121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26,
    170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226,
    81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148,
    72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128,
    41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157,
    65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7,
    87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194,
    66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205,
    43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171,
    56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64,
    34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31,
    68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124,
    62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111,
    60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114,
    40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154,
    61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71,
    142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221,
    51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229,
    67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154,
    40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183,
    46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37,
    65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223,
    87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226,
    64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213,
    30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255,
    31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51,
    88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192,
    55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82,
    95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1,
    57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85,
    41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6,
    101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43,
    117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192,
    69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171,
    62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1,
    63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16,
    86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128,
    58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218,
    51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128,
    22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197,
    56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28,
    85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246,
    35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45,
    85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85,
    56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138,
    101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20,
    138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163,
    112, 19, 12, 61, 195, 128, 48, 4, 24,};

const uint8_t kVp8Dc[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,};

const uint16_t kVp8Ac[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27,
    28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39,
    40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68,
    70, 72, 74, 76, 78, 80, 82, 84, 86, 88, 90, 92,
    94, 96, 98, 100, 102, 104, 106, 108, 110, 112, 114, 116,
    119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193,
    197, 201, 205, 209, 213, 217, 221, 225, 229, 234, 239, 245,
    249, 254, 259, 264, 269, 274, 279, 284,};
const uint8_t kVp8Bands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kVp8Zigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const int8_t kVp8YModes4[18] = {0, 1, -1, 2, -2, 3, 4, 6, -3, 5, -4, -5, -6, 7, -7, 8, -8, -9};
const uint8_t kVp8Cat3[] = {173, 148, 140, 0}, kVp8Cat4[] = {176, 155, 140, 135, 0},
              kVp8Cat5[] = {180, 157, 141, 134, 130, 0},
              kVp8Cat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kVp8Cat[4] = {kVp8Cat3, kVp8Cat4, kVp8Cat5, kVp8Cat6};
enum { DC_PRED = 0, TM_PRED = 1, V_PRED = 2, H_PRED = 3 };

// RFC 6386's boolean decoder; zeros past the end, as libwebp feeds them.
struct BoolDecoder {
  const uint8_t* d = nullptr;
  size_t n = 0, pos = 2;
  uint32_t value = 0, range = 255;
  int count = 0;
  BoolDecoder() = default;
  BoolDecoder(const uint8_t* data, size_t size) : d(data), n(size) {
    value = (n > 0 ? uint32_t(d[0]) << 8 : 0) | (n > 1 ? d[1] : 0);
  }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * uint32_t(prob)) >> 8), big = split << 8;
    int b;
    if (value >= big) {
      b = 1;
      range -= split;
      value -= big;
    } else {
      b = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++count == 8) {
        count = 0;
        value |= pos < n ? d[pos] : 0;
        ++pos;
      }
    }
    return b;
  }
  int bits(int k) {
    int v = 0;
    for (int i = 0; i < k; ++i) v = v << 1 | bit(128);
    return v;
  }
  int signed_bits(int k) {
    const int v = bits(k);
    return bit(128) ? -v : v;
  }
};

inline int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }
inline int16_t to16(int v) { return int16_t(uint16_t(v)); }

struct Vp8Quant {
  int y1[2], y2[2], uv[2];
};

// libwebp GetLargeValue / GetCoeffsFast -> the count of coefficients read
int vp8_large(BoolDecoder& br, const uint8_t* p) {
  if (!br.bit(p[3])) return br.bit(p[4]) ? 3 + br.bit(p[5]) : 2;
  if (!br.bit(p[6])) {
    if (!br.bit(p[7])) return 5 + br.bit(159);
    const int v = 7 + 2 * br.bit(165);
    return v + br.bit(145);
  }
  const int bit1 = br.bit(p[8]), bit0 = br.bit(p[9 + bit1]), cat = 2 * bit1 + bit0;
  int v = 0;
  for (const uint8_t* t = kVp8Cat[cat]; *t; ++t) v += v + br.bit(*t);
  return v + 3 + (8 << cat);
}

int vp8_coeffs(BoolDecoder& br, const uint8_t (*prob)[3][11], int ctx, const int* dq, int n,
               int16_t* out) {
  const uint8_t* p = prob[kVp8Bands[n]][ctx];
  for (; n < 16; ++n) {
    if (!br.bit(p[0])) return n;
    while (!br.bit(p[1])) {
      p = prob[kVp8Bands[++n]][0];
      if (n == 16) return 16;
    }
    const uint8_t (*next)[11] = prob[kVp8Bands[n + 1]];
    int v;
    if (!br.bit(p[2])) {
      v = 1;
      p = next[1];
    } else {
      v = vp8_large(br, p);
      p = next[2];
    }
    out[kVp8Zigzag[n]] = to16((br.bit(128) ? -v : v) * dq[n > 0]);
  }
  return 16;
}

void vp8_wht(const int16_t* in, int16_t (*coeffs)[16]) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    const int a0 = in[i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
    const int a2 = in[4 + i] - in[8 + i], a3 = in[i] - in[12 + i];
    tmp[i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = tmp[4 * i] + 3, a0 = dc + tmp[4 * i + 3], a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
    const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2], a3 = dc - tmp[4 * i + 3];
    coeffs[4 * i][0] = to16((a0 + a1) >> 3);
    coeffs[4 * i + 1][0] = to16((a3 + a2) >> 3);
    coeffs[4 * i + 2][0] = to16((a0 - a1) >> 3);
    coeffs[4 * i + 3][0] = to16((a3 - a2) >> 3);
  }
}

inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

// libwebp TransformOne: the inverse DCT of ``in`` added into dst (stride)
void vp8_idct(const int16_t* in, int* dst, int stride) {
  int c[16];
  for (int i = 0; i < 4; ++i) {
    const int a = in[i] + in[8 + i], b = in[i] - in[8 + i];
    const int cc = mul2(in[4 + i]) - mul1(in[12 + i]), d = mul1(in[4 + i]) + mul2(in[12 + i]);
    c[4 * i] = a + d;
    c[4 * i + 1] = b + cc;
    c[4 * i + 2] = b - cc;
    c[4 * i + 3] = a - d;
  }
  for (int i = 0; i < 4; ++i) {
    const int dc = c[i] + 4, a = dc + c[8 + i], b = dc - c[8 + i];
    const int cc = mul2(c[4 + i]) - mul1(c[12 + i]), d = mul1(c[4 + i]) + mul2(c[12 + i]);
    const int v[4] = {a + d, b + cc, b - cc, a - d};
    for (int x = 0; x < 4; ++x) {
      int& p = dst[i * stride + x];
      p = clampi(p + (v[x] >> 3), 0, 255);
    }
  }
}

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

// one 4x4 intra prediction into p (stride s): the row above p[-s - 1 ..
// -s + 7], the column left p[-1 .. 3 s - 1]
void vp8_pred4(int* p, int s, int mode) {
  const int X = p[-s - 1], A = p[-s], B = p[-s + 1], C = p[-s + 2], D = p[-s + 3],
            E = p[-s + 4], F = p[-s + 5], G = p[-s + 6], H = p[-s + 7];
  const int I = p[-1], J = p[s - 1], K = p[2 * s - 1], L = p[3 * s - 1];
  auto at = [&](int x, int y) -> int& { return p[y * s + x]; };
  switch (mode) {
    case 0: {
      const int dc = (A + B + C + D + I + J + K + L + 4) >> 3;
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) at(x, y) = dc;
      break;
    }
    case 1: {
      const int top[4] = {A, B, C, D}, left[4] = {I, J, K, L};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) at(x, y) = clampi(top[x] + left[y] - X, 0, 255);
      break;
    }
    case 2: {
      const int v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, D), avg3(C, D, E)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) at(x, y) = v[x];
      break;
    }
    case 3: {
      const int v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, L), avg3(K, L, L)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) at(x, y) = v[y];
      break;
    }
    case 4:
      at(0, 3) = avg3(J, K, L);
      at(1, 3) = at(0, 2) = avg3(I, J, K);
      at(2, 3) = at(1, 2) = at(0, 1) = avg3(X, I, J);
      at(3, 3) = at(2, 2) = at(1, 1) = at(0, 0) = avg3(A, X, I);
      at(3, 2) = at(2, 1) = at(1, 0) = avg3(B, A, X);
      at(3, 1) = at(2, 0) = avg3(C, B, A);
      at(3, 0) = avg3(D, C, B);
      break;
    case 5:
      at(0, 0) = at(1, 2) = avg2(X, A);
      at(1, 0) = at(2, 2) = avg2(A, B);
      at(2, 0) = at(3, 2) = avg2(B, C);
      at(3, 0) = avg2(C, D);
      at(0, 3) = avg3(K, J, I);
      at(0, 2) = avg3(J, I, X);
      at(0, 1) = at(1, 3) = avg3(I, X, A);
      at(1, 1) = at(2, 3) = avg3(X, A, B);
      at(2, 1) = at(3, 3) = avg3(A, B, C);
      at(3, 1) = avg3(B, C, D);
      break;
    case 6: {
      const int v[7] = {avg3(A, B, C), avg3(B, C, D), avg3(C, D, E), avg3(D, E, F),
                        avg3(E, F, G), avg3(F, G, H), avg3(G, H, H)};
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) at(x, y) = v[x + y];
      break;
    }
    case 7:
      at(0, 0) = avg2(A, B);
      at(1, 0) = at(0, 2) = avg2(B, C);
      at(2, 0) = at(1, 2) = avg2(C, D);
      at(3, 0) = at(2, 2) = avg2(D, E);
      at(0, 1) = avg3(A, B, C);
      at(1, 1) = at(0, 3) = avg3(B, C, D);
      at(2, 1) = at(1, 3) = avg3(C, D, E);
      at(3, 1) = at(2, 3) = avg3(D, E, F);
      at(3, 2) = avg3(E, F, G);
      at(3, 3) = avg3(F, G, H);
      break;
    case 8:
      at(0, 0) = at(2, 1) = avg2(I, X);
      at(0, 1) = at(2, 2) = avg2(J, I);
      at(0, 2) = at(2, 3) = avg2(K, J);
      at(0, 3) = avg2(L, K);
      at(3, 0) = avg3(A, B, C);
      at(2, 0) = avg3(X, A, B);
      at(1, 0) = at(3, 1) = avg3(I, X, A);
      at(1, 1) = at(3, 2) = avg3(J, I, X);
      at(1, 2) = at(3, 3) = avg3(K, J, I);
      at(1, 3) = avg3(L, K, J);
      break;
    default:
      at(0, 0) = avg2(I, J);
      at(2, 0) = at(0, 1) = avg2(J, K);
      at(2, 1) = at(0, 2) = avg2(K, L);
      at(1, 0) = avg3(I, J, K);
      at(3, 0) = at(1, 1) = avg3(J, K, L);
      at(3, 1) = at(1, 2) = avg3(K, L, L);
      at(3, 2) = at(2, 2) = at(0, 3) = at(1, 3) = at(2, 3) = at(3, 3) = L;
      break;
  }
}

// 16x16 / 8x8 prediction (CheckMode's DC variants at the frame's edges)
void vp8_pred_n(int* p, int s, int n, int mode, int mx, int my) {
  int top = 0, left = 0;
  for (int i = 0; i < n; ++i) {
    top += p[-s + i];
    left += p[i * s - 1];
  }
  const int sh = n == 16 ? 5 : 4;
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) {
      int v;
      if (mode == DC_PRED) {
        v = mx == 0 && my == 0 ? 0x80
            : my == 0          ? (left + (n >> 1)) >> (sh - 1)
            : mx == 0          ? (top + (n >> 1)) >> (sh - 1)
                               : (top + left + n) >> sh;
      } else if (mode == TM_PRED) {
        v = clampi(p[-s + x] + p[y * s - 1] - p[-s - 1], 0, 255);
      } else if (mode == V_PRED) {
        v = p[-s + x];
      } else {
        v = p[y * s - 1];
      }
      p[y * s + x] = v;
    }
}

// the loop filter (dsp/dec.c)
inline int sclip1(int v) { return clampi(v, -128, 127); }
inline int sclip2(int v) { return clampi(v, -16, 15); }
inline int clip1(int v) { return clampi(v, 0, 255); }

void filter2(int* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
  p[-s] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
}
void filter4(int* p, int s) {
  const int p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s];
  const int a = 3 * (q0 - p0);
  const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
  p[-2 * s] = clip1(p1 + a3);
  p[-s] = clip1(p0 + a2);
  p[0] = clip1(q0 - a1);
  p[s] = clip1(q1 - a3);
}
void filter6(int* p, int s) {
  const int p2 = p[-3 * s], p1 = p[-2 * s], p0 = p[-s], q0 = p[0], q1 = p[s], q2 = p[2 * s];
  const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
  p[-3 * s] = clip1(p2 + a3);
  p[-2 * s] = clip1(p1 + a2);
  p[-s] = clip1(p0 + a1);
  p[0] = clip1(q0 - a1);
  p[s] = clip1(q1 - a2);
  p[2 * s] = clip1(q2 - a3);
}
bool high_edge_variance(const int* p, int s, int t) {
  return std::abs(p[-2 * s] - p[-s]) > t || std::abs(p[s] - p[0]) > t;
}
bool needs_filter(const int* p, int s, int t) {
  return 4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) <= t;
}
bool needs_filter2(const int* p, int s, int t, int it) {
  if (4 * std::abs(p[-s] - p[0]) + std::abs(p[-2 * s] - p[s]) > t) return false;
  return std::abs(p[-4 * s] - p[-3 * s]) <= it && std::abs(p[-3 * s] - p[-2 * s]) <= it &&
         std::abs(p[-2 * s] - p[-s]) <= it && std::abs(p[3 * s] - p[2 * s]) <= it &&
         std::abs(p[2 * s] - p[s]) <= it && std::abs(p[s] - p[0]) <= it;
}
// an edge of ``count`` pixels from p, stepping ``along``, filtered across ``across``
void filter_edge(int* p, int across, int along, int count, int thresh, int ithresh, int hev,
                 bool simple, bool six) {
  const int t2 = 2 * thresh + 1;
  for (int i = 0; i < count; ++i, p += along) {
    if (simple) {
      if (needs_filter(p, across, t2)) filter2(p, across);
    } else if (needs_filter2(p, across, t2, ithresh)) {
      if (high_edge_variance(p, across, hev)) filter2(p, across);
      else if (six) filter6(p, across);
      else filter4(p, across);
    }
  }
}

struct Vp8Filter {
  int limit, ilevel, hev;
  bool inner;
};

struct Vp8Frame {
  int w, h, mbw, mbh;
  std::vector<int> y, u, v;  // whole macroblocks, strides 16 mbw and 8 mbw
};

Vp8Frame decode_vp8(const uint8_t* data, size_t size) {
  if (size < 10) throw Error("WebP: truncated VP8 frame");
  const uint32_t tag = uint32_t(data[0]) | uint32_t(data[1]) << 8 | uint32_t(data[2]) << 16;
  if (tag & 1) throw Error("WebP: a VP8 frame that is not a key frame");
  const size_t part0 = tag >> 5;
  if (data[3] != 0x9d || data[4] != 0x01 || data[5] != 0x2a)
    throw Error("WebP: bad VP8 start code");
  Vp8Frame fr;
  fr.w = int(le16(data + 6) & 0x3FFF);
  fr.h = int(le16(data + 8) & 0x3FFF);
  if (fr.w == 0 || fr.h == 0 || too_many_pixels(uint64_t(fr.w), uint64_t(fr.h)))
    throw Error("WebP: bad image size");
  if (part0 > size - 10) throw Error("WebP: truncated VP8 frame");
  BoolDecoder br(data + 10, part0);
  br.bits(2);  // colour space, clamping type
  const int use_segment = br.bits(1);
  int update_map = 0, absolute = 0, seg_q[4] = {}, seg_f[4] = {}, seg_p[3] = {255, 255, 255};
  if (use_segment) {
    update_map = br.bits(1);
    if (br.bits(1)) {
      absolute = br.bits(1);
      for (int& q : seg_q) q = br.bits(1) ? br.signed_bits(7) : 0;
      for (int& f : seg_f) f = br.bits(1) ? br.signed_bits(6) : 0;
    }
    if (update_map)
      for (int& p : seg_p) p = br.bits(1) ? br.bits(8) : 255;
  }
  const int simple = br.bits(1), level = br.bits(6), sharpness = br.bits(3);
  const int use_lf_delta = br.bits(1);
  int ref_d[4] = {}, mode_d[4] = {};
  if (use_lf_delta && br.bits(1)) {
    for (int& d : ref_d) d = br.bits(1) ? br.signed_bits(6) : 0;
    for (int& d : mode_d) d = br.bits(1) ? br.signed_bits(6) : 0;
  }
  const int num_parts = 1 << br.bits(2);
  std::vector<BoolDecoder> parts(static_cast<size_t>(num_parts));
  {
    size_t sizes = 10 + part0, at = sizes + 3 * size_t(num_parts - 1);
    if (at > size) throw Error("WebP: truncated VP8 partitions");
    for (int p = 0; p < num_parts; ++p) {
      size_t n = size - at;
      if (p < num_parts - 1) {
        const uint8_t* s = data + sizes + 3 * size_t(p);
        n = std::min<size_t>(size_t(s[0]) | size_t(s[1]) << 8 | size_t(s[2]) << 16, size - at);
      }
      parts[size_t(p)] = BoolDecoder(data + at, n);
      at += n;
    }
  }
  const int base_q = br.bits(7);
  int dq[5];
  for (int& d : dq) d = br.bits(1) ? br.signed_bits(4) : 0;
  Vp8Quant quant[4];
  for (int s = 0; s < 4; ++s) {
    const int q = use_segment ? seg_q[s] + (absolute ? 0 : base_q) : base_q;
    quant[s].y1[0] = kVp8Dc[clampi(q + dq[0], 0, 127)];
    quant[s].y1[1] = kVp8Ac[clampi(q, 0, 127)];
    quant[s].y2[0] = kVp8Dc[clampi(q + dq[1], 0, 127)] * 2;
    quant[s].y2[1] = std::max(int(kVp8Ac[clampi(q + dq[2], 0, 127)]) * 101581 >> 16, 8);
    quant[s].uv[0] = kVp8Dc[clampi(q + dq[3], 0, 117)];
    quant[s].uv[1] = kVp8Ac[clampi(q + dq[4], 0, 127)];
  }
  br.bits(1);  // refresh entropy probabilities: ignored
  uint8_t proba[4][8][3][11];
  std::memcpy(proba, kVp8Coeffs0, sizeof(proba));
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
    if (br.bit(kVp8Update[i])) (&proba[0][0][0][0])[i] = uint8_t(br.bits(8));
  const int use_skip = br.bits(1), skip_p = use_skip ? br.bits(8) : 0;
  // filter strengths per segment and 4x4 / 16x16 (PrecomputeFilterStrengths)
  const int filter_type = level == 0 ? 0 : (simple ? 1 : 2);
  Vp8Filter fstr[4][2];
  for (int s = 0; s < 4; ++s) {
    const int base = use_segment ? seg_f[s] + (absolute ? 0 : level) : level;
    for (int i4 = 0; i4 < 2; ++i4) {
      int lv = base;
      if (use_lf_delta) lv += ref_d[0] + (i4 ? mode_d[0] : 0);
      lv = clampi(lv, 0, 63);
      Vp8Filter& f = fstr[s][i4];
      f.inner = i4;
      if (lv > 0) {
        int il = lv;
        if (sharpness > 0) {
          il >>= sharpness > 4 ? 2 : 1;
          il = std::min(il, 9 - sharpness);
        }
        il = std::max(il, 1);
        f = {2 * lv + il, il, lv >= 40 ? 2 : (lv >= 15 ? 1 : 0), bool(i4)};
      } else {
        f = {0, 0, 0, bool(i4)};
      }
    }
  }
  fr.mbw = (fr.w + 15) / 16;
  fr.mbh = (fr.h + 15) / 16;
  const int ys = 16 * fr.mbw, cs = 8 * fr.mbw;
  fr.y.assign(size_t(ys) * 16 * fr.mbh, 0);
  fr.u.assign(size_t(cs) * 8 * fr.mbh, 0);
  fr.v.assign(size_t(cs) * 8 * fr.mbh, 0);
  std::vector<int> intra_t(size_t(4 * fr.mbw), 0);
  std::vector<std::pair<int, int>> nz_top(size_t(fr.mbw), {0, 0});  // (nz, nz_dc)
  std::vector<Vp8Filter> finfo(size_t(fr.mbw) * fr.mbh);
  int buf[17 * 21];  // the work block: a border row and column, 4 top-right columns
  for (int my = 0; my < fr.mbh; ++my) {
    int intra_l[4] = {0, 0, 0, 0};
    std::pair<int, int> nz_left{0, 0};
    BoolDecoder& tok = parts[size_t(my & (num_parts - 1))];
    for (int mx = 0; mx < fr.mbw; ++mx) {
      const int segment =
          update_map ? (!br.bit(seg_p[0]) ? br.bit(seg_p[1]) : br.bit(seg_p[2]) + 2) : 0;
      const int skip = use_skip ? br.bit(skip_p) : 0;
      const bool is_i4 = !br.bit(145);
      int ymode = DC_PRED, imodes[16];
      if (!is_i4) {
        ymode = br.bit(156) ? (br.bit(128) ? TM_PRED : H_PRED) : (br.bit(163) ? V_PRED : DC_PRED);
        for (int k = 0; k < 4; ++k) intra_t[size_t(4 * mx + k)] = intra_l[k] = ymode;
      } else {
        for (int y = 0; y < 4; ++y) {
          int ym = intra_l[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* prob = &kVp8BModes[(intra_t[size_t(4 * mx + x)] * 10 + ym) * 9];
            int i = kVp8YModes4[br.bit(prob[0])];
            while (i > 0) i = kVp8YModes4[2 * i + br.bit(prob[i])];
            ym = -i;
            intra_t[size_t(4 * mx + x)] = ym;
            imodes[4 * y + x] = ym;
          }
          intra_l[y] = ym;
        }
      }
      const int uvmode = !br.bit(142) ? DC_PRED
                         : !br.bit(114) ? V_PRED : (br.bit(183) ? TM_PRED : H_PRED);
      int16_t coeffs[24][16] = {};
      const Vp8Quant& q = quant[segment];
      bool nonzero = false;
      if (!skip) {
        const int tnz_all = nz_top[size_t(mx)].first, lnz_all = nz_left.first;
        int tdc = nz_top[size_t(mx)].second, ldc = nz_left.second, first;
        const uint8_t (*ac_p)[3][11];
        if (!is_i4) {
          int16_t dc[16] = {};
          const int nz = vp8_coeffs(tok, proba[1], tdc + ldc, q.y2, 0, dc);
          tdc = ldc = nz > 0;
          if (nz > 1) {
            vp8_wht(dc, coeffs);
          } else {
            for (int k = 0; k < 16; ++k) coeffs[k][0] = to16((dc[0] + 3) >> 3);
          }
          first = 1;
          ac_p = proba[0];
        } else {
          first = 0;
          ac_p = proba[3];
        }
        int tnz = tnz_all & 0x0F, lnz = lnz_all & 0x0F;
        for (int y = 0; y < 4; ++y) {
          int l = lnz & 1;
          for (int x = 0; x < 4; ++x) {
            int16_t* blk = coeffs[4 * y + x];
            const int nz = vp8_coeffs(tok, ac_p, l + (tnz & 1), q.y1, first, blk);
            l = nz > first;
            tnz = (tnz >> 1) | (l << 7);
            nonzero |= nz > 1 || blk[0] != 0;
          }
          tnz >>= 4;
          lnz = (lnz >> 1) | (l << 7);
        }
        int out_t = tnz, out_l = lnz >> 4;
        for (int ch = 0; ch < 4; ch += 2) {
          tnz = tnz_all >> (4 + ch);
          lnz = lnz_all >> (4 + ch);
          for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x) {
              int16_t* blk = coeffs[16 + 2 * ch + 2 * y + x];
              const int nz = vp8_coeffs(tok, proba[2], l + (tnz & 1), q.uv, 0, blk);
              l = nz > 0;
              tnz = (tnz >> 1) | (l << 3);
              nonzero |= nz > 1 || blk[0] != 0;
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (l << 5);
          }
          out_t |= (tnz << 4) << ch;
          out_l |= (lnz & 0xF0) << ch;
        }
        nz_top[size_t(mx)] = {out_t, tdc};
        nz_left = {out_l, ldc};
      } else {
        nz_top[size_t(mx)] = {0, is_i4 ? nz_top[size_t(mx)].second : 0};
        nz_left = {0, is_i4 ? nz_left.second : 0};
      }
      // reconstruction from the unfiltered frame with libwebp's borders
      for (int plane = 0; plane < 3; ++plane) {
        const int n = plane ? 8 : 16, s = plane ? cs : ys, bs = 21;
        std::vector<int>& img = plane == 0 ? fr.y : (plane == 1 ? fr.u : fr.v);
        const int x0 = mx * n, y0 = my * n;
        for (int i = 0; i < 17 * 21; ++i) buf[i] = 0;
        int* b = buf + bs + 1;  // b[0] is the block's first pixel
        if (my == 0) {
          for (int x = -1; x < n + 4; ++x) b[-bs + x] = 127;
        } else {
          for (int x = 0; x < n; ++x) b[-bs + x] = img[size_t(y0 - 1) * s + x0 + x];
          b[-bs - 1] = mx == 0 ? 129 : img[size_t(y0 - 1) * s + x0 - 1];
        }
        for (int y = 0; y < n; ++y)
          b[y * bs - 1] = mx == 0 ? 129 : img[size_t(y0 + y) * s + x0 - 1];
        if (plane == 0) {
          if (my > 0)
            for (int x = 0; x < 4; ++x)
              b[-bs + 16 + x] = mx >= fr.mbw - 1 ? img[size_t(y0 - 1) * s + x0 + 15]
                                                  : img[size_t(y0 - 1) * s + x0 + 16 + x];
          for (int r : {3, 7, 11})
            for (int x = 0; x < 4; ++x) b[r * bs + 16 + x] = b[-bs + 16 + x];
          if (!is_i4) vp8_pred_n(b, bs, 16, ymode, mx, my);
          for (int k = 0; k < 16; ++k) {
            int* blk = b + 4 * (k / 4) * bs + 4 * (k % 4);
            if (is_i4) vp8_pred4(blk, bs, imodes[k]);
            vp8_idct(coeffs[k], blk, bs);
          }
        } else {
          vp8_pred_n(b, bs, 8, uvmode, mx, my);
          for (int k = 0; k < 4; ++k)
            vp8_idct(coeffs[16 + 4 * (plane - 1) + k], b + 4 * (k / 2) * bs + 4 * (k % 2), bs);
        }
        for (int y = 0; y < n; ++y)
          for (int x = 0; x < n; ++x) img[size_t(y0 + y) * s + x0 + x] = b[y * bs + x];
      }
      Vp8Filter f = fstr[segment][is_i4];
      f.inner = f.inner || nonzero;
      finfo[size_t(my) * fr.mbw + mx] = f;
    }
  }
  if (filter_type)
    for (int my = 0; my < fr.mbh; ++my)
      for (int mx = 0; mx < fr.mbw; ++mx) {
        const Vp8Filter& f = finfo[size_t(my) * fr.mbw + mx];
        if (f.limit == 0) continue;
        int* yp = &fr.y[size_t(16 * my) * ys + 16 * mx];
        int* up = &fr.u[size_t(8 * my) * cs + 8 * mx];
        int* vp = &fr.v[size_t(8 * my) * cs + 8 * mx];
        const bool smp = filter_type == 1;
        if (mx > 0) {
          filter_edge(yp, 1, ys, 16, f.limit + 4, f.ilevel, f.hev, smp, true);
          if (!smp)
            for (int* c : {up, vp})
              filter_edge(c, 1, cs, 8, f.limit + 4, f.ilevel, f.hev, false, true);
        }
        if (f.inner) {
          for (int k : {4, 8, 12})
            filter_edge(yp + k, 1, ys, 16, f.limit, f.ilevel, f.hev, smp, false);
          if (!smp)
            for (int* c : {up, vp})
              filter_edge(c + 4, 1, cs, 8, f.limit, f.ilevel, f.hev, false, false);
        }
        if (my > 0) {
          filter_edge(yp, ys, 1, 16, f.limit + 4, f.ilevel, f.hev, smp, true);
          if (!smp)
            for (int* c : {up, vp})
              filter_edge(c, cs, 1, 8, f.limit + 4, f.ilevel, f.hev, false, true);
        }
        if (f.inner) {
          for (int k : {4, 8, 12})
            filter_edge(yp + k * ys, ys, 1, 16, f.limit, f.ilevel, f.hev, smp, false);
          if (!smp)
            for (int* c : {up, vp})
              filter_edge(c + 4 * cs, cs, 1, 8, f.limit, f.ilevel, f.hev, false, false);
        }
      }
  return fr;
}

// libwebp's VP8YUVToR / G / B
inline int clip8(int v) { return (v & ~16383) == 0 ? v >> 6 : (v < 0 ? 0 : 255); }
inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
  const int hy = (y * 19077) >> 8;
  rgb[0] = uint8_t(clip8(hy + ((v * 26149) >> 8) - 14234));
  rgb[1] = uint8_t(clip8(hy - ((u * 6419) >> 8) - ((v * 13320) >> 8) + 8708));
  rgb[2] = uint8_t(clip8(hy + ((u * 33050) >> 8) - 17685));
}

// libwebp's fancy upsampler for one row pair: the chroma of the top row from
// (near tu, far cu), of the bottom row from (near cu, far tu)
void upsample_pair(const int* ty, const int* by, const int* tu, const int* tv, const int* cu,
                   const int* cv, int w, uint8_t* top, uint8_t* bottom, int channels) {
  auto chroma = [&](const int* tc, const int* cc, std::vector<int>& t, std::vector<int>& b) {
    t.assign(size_t(w), 0);
    b.assign(size_t(w), 0);
    t[0] = (3 * tc[0] + cc[0] + 2) >> 2;
    b[0] = (3 * cc[0] + tc[0] + 2) >> 2;
    const int last = (w - 1) >> 1;
    for (int x = 1; x <= last; ++x) {
      const int a = tc[x - 1], bb = tc[x], c = cc[x - 1], d = cc[x], avg = a + bb + c + d + 8;
      const int d12 = (avg + 2 * (bb + c)) >> 3, d03 = (avg + 2 * (a + d)) >> 3;
      t[size_t(2 * x - 1)] = (d12 + a) >> 1;
      t[size_t(2 * x)] = (d03 + bb) >> 1;
      b[size_t(2 * x - 1)] = (d03 + c) >> 1;
      b[size_t(2 * x)] = (d12 + d) >> 1;
    }
    if (!(w & 1)) {
      t[size_t(w - 1)] = (3 * tc[last] + cc[last] + 2) >> 2;
      b[size_t(w - 1)] = (3 * cc[last] + tc[last] + 2) >> 2;
    }
  };
  std::vector<int> ut, ub, vt, vb;
  chroma(tu, cu, ut, ub);
  chroma(tv, cv, vt, vb);
  for (int x = 0; x < w; ++x) {
    yuv_to_rgb(ty[x], ut[size_t(x)], vt[size_t(x)], top + size_t(x) * channels);
    if (bottom) yuv_to_rgb(by[x], ub[size_t(x)], vb[size_t(x)], bottom + size_t(x) * channels);
  }
}

// an ALPH chunk -> alpha [h, w] (alpha_dec.c: VP8L's green channel or raw
// bytes, then the row filter undone)
std::vector<uint8_t> decode_alpha(const uint8_t* d, size_t n, int w, int h) {
  if (n < 1) throw Error("WebP: truncated alpha");
  const int method = d[0] & 3, filter = (d[0] >> 2) & 3;
  std::vector<uint8_t> a(size_t(w) * size_t(h));
  if (method == 0) {
    if (n - 1 < a.size()) throw Error("WebP: truncated alpha");
    std::memcpy(a.data(), d + 1, a.size());
  } else if (method == 1) {
    LsbBits br(d + 1, n - 1);
    std::vector<Transform> transforms;
    int coded_w = w;
    std::vector<uint32_t> px = vp8l_image(br, w, h, true, &transforms, &coded_w);
    px = inverse(std::move(px), transforms, h, coded_w);
    for (size_t i = 0; i < a.size(); ++i) a[i] = uint8_t(px[i] >> 8);
  } else {
    throw Error("WebP: unknown alpha compression");
  }
  std::vector<uint8_t> out(a.size());
  for (int y = 0; y < h; ++y) {
    const uint8_t* in = &a[size_t(y) * w];
    uint8_t* o = &out[size_t(y) * w];
    const uint8_t* prev = y > 0 ? o - w : nullptr;
    if (filter == 0) {
      std::memcpy(o, in, size_t(w));
    } else if (filter == 1 || !prev) {
      uint8_t pred = prev ? prev[0] : 0;
      for (int x = 0; x < w; ++x) o[x] = pred = uint8_t(pred + in[x]);
    } else if (filter == 2) {
      for (int x = 0; x < w; ++x) o[x] = uint8_t(prev[x] + in[x]);
    } else {
      int top_left = prev[0], left = prev[0];
      for (int x = 0; x < w; ++x) {
        const int top = prev[x], g = left + top - top_left;
        left = uint8_t(in[x] + (g < 0 ? 0 : (g > 255 ? 255 : g)));
        top_left = top;
        o[x] = uint8_t(left);
      }
    }
  }
  return out;
}

Image decode_vp8_image(const uint8_t* data, size_t size, const uint8_t* alph, size_t alph_size,
                       bool alpha) {
  const Vp8Frame fr = decode_vp8(data, size);
  const int w = fr.w, h = fr.h, ys = 16 * fr.mbw, cs = 8 * fr.mbw;
  Image img;
  img.w = w;
  img.h = h;
  img.channels = alpha ? 4 : 3;
  img.mode = alpha ? MODE_RGBA : MODE_RGB;
  img.data.assign(size_t(w) * size_t(h) * size_t(img.channels), 255);
  const size_t row = size_t(w) * size_t(img.channels);
  auto Y = [&](int y) { return &fr.y[size_t(y) * ys]; };
  auto U = [&](int k) { return &fr.u[size_t(k) * cs]; };
  auto V = [&](int k) { return &fr.v[size_t(k) * cs]; };
  upsample_pair(Y(0), nullptr, U(0), V(0), U(0), V(0), w, &img.data[0], nullptr, img.channels);
  int k = 0, y = 1;
  for (; y + 1 < h; y += 2, ++k)
    upsample_pair(Y(y), Y(y + 1), U(k), V(k), U(k + 1), V(k + 1), w, &img.data[size_t(y) * row],
                  &img.data[size_t(y + 1) * row], img.channels);
  if (!(h & 1))
    upsample_pair(Y(h - 1), nullptr, U(k), V(k), U(k), V(k), w, &img.data[size_t(h - 1) * row],
                  nullptr, img.channels);
  if (alpha && alph) {
    const std::vector<uint8_t> a = decode_alpha(alph, alph_size, w, h);
    for (size_t i = 0; i < a.size(); ++i) img.data[4 * i + 3] = a[i];
  }
  return img;
}

// a VP8L bitstream -> RGBA (``alpha``), else RGB
Image decode_vp8l_image(const uint8_t* body, size_t body_size, bool alpha) {
  const uint32_t head = le32(body + 1);
  const int w = int(head & 0x3FFF) + 1, h = int((head >> 14) & 0x3FFF) + 1;
  if (too_many_pixels(uint64_t(w), uint64_t(h))) throw Error("WebP: bad image size");
  LsbBits br(body + 5, body_size - 5);
  std::vector<Transform> transforms;
  int coded_w = w;
  std::vector<uint32_t> px = vp8l_image(br, w, h, true, &transforms, &coded_w);
  px = inverse(std::move(px), transforms, h, coded_w);
  Image img;
  img.w = w;
  img.h = h;
  img.mode = alpha ? MODE_RGBA : MODE_RGB;
  img.channels = alpha ? 4 : 3;
  img.data.resize(size_t(w) * size_t(h) * size_t(img.channels));
  for (size_t i = 0; i < size_t(w) * size_t(h); ++i) {
    uint8_t* d = &img.data[i * size_t(img.channels)];
    d[0] = uint8_t(channel(px[i], 16));
    d[1] = uint8_t(channel(px[i], 8));
    d[2] = uint8_t(channel(px[i], 0));
    if (alpha) d[3] = uint8_t(px[i] >> 24);
  }
  return img;
}

void check_lossless_header(const uint8_t* body, size_t body_size) {
  if (body_size < 5 || body[0] != 0x2F) throw Error("WebP: bad lossless signature");
  if (le32(body + 1) >> 29) throw Error("WebP: unknown lossless version");
}

uint32_t le24(const uint8_t* p) {
  return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16;
}

// One ANMF frame as libwebp's demuxer stores it.
struct AnimFrame {
  uint32_t x = 0, y = 0, w = 0, h = 0;
  const uint8_t *alph = nullptr, *image = nullptr;
  size_t alph_size = 0, image_size = 0;
  bool lossy = false, alph_last = false;  // alph_last: ALPH after the image chunk
};

// WebPGetFeatures on a frame's image chunk (VP8GetInfo / VP8LGetInfo in
// libwebp's dec/webp_dec.c, vp8_dec.c, vp8l_dec.c): its size, or a refusal.
// ``avail`` is the padded payload, ``size`` the chunk's own.
void frame_features(AnimFrame& fr, const uint8_t* d, size_t avail, size_t size) {
  if (fr.lossy) {
    if (avail < 10 || d[3] != 0x9D || d[4] != 0x01 || d[5] != 0x2A)
      throw Error("WebP: bad frame bitstream header");
    const uint32_t bits = le24(d);
    fr.w = le16(d + 6) & 0x3FFF;
    fr.h = le16(d + 8) & 0x3FFF;
    if ((bits & 1) || ((bits >> 1) & 7) > 3 || !((bits >> 4) & 1) || (bits >> 5) >= size ||
        !fr.w || !fr.h)
      throw Error("WebP: bad frame bitstream header");
  } else {
    if (avail < 5 || d[0] != 0x2F || (d[4] >> 5)) throw Error("WebP: bad frame bitstream header");
    const uint32_t head = le32(d + 1);
    fr.w = (head & 0x3FFF) + 1;
    fr.h = ((head >> 14) & 0x3FFF) + 1;
  }
}

// An animated WebP's first frame as PIL reads it through WebPAnimDecoder
// (libwebp src/demux/demux.c parses and validates, src/demux/anim_decode.c
// composites).  ``vp8x`` is the VP8X chunk's offset.
Image decode_webp_anim(const std::vector<uint8_t>& f, size_t vp8x) {
  // demux.c ReadHeader: the RIFF size bounds the data; a shorter file is
  // partial, which WebPDemux refuses
  const uint64_t riff_size = le32(&f[4]);
  if (riff_size < 8 || riff_size > 0xFFFFFFF6u || f.size() < riff_size + 8)
    throw Error("WebP: the RIFF size does not match the file");
  const size_t end = size_t(riff_size) + 8;
  // ParseVP8X: the flags, the canvas (width and height less one, so never
  // 0) below MAX_IMAGE_AREA
  if (end < vp8x + 8) throw Error("WebP: a chunk runs past the end of the RIFF data");
  const size_t vp8x_size = le32(&f[vp8x + 4]) + (le32(&f[vp8x + 4]) & 1);
  if (vp8x_size > end - vp8x - 8) throw Error("WebP: a chunk runs past the end of the RIFF data");
  const int flags = f[vp8x + 8];
  const uint64_t cw = 1 + uint64_t(le24(&f[vp8x + 12])), ch = 1 + uint64_t(le24(&f[vp8x + 15]));
  if (cw * ch >= (uint64_t(1) << 32)) throw Error("WebP: bad canvas size");
  size_t pos = vp8x + 8 + vp8x_size;
  // ParseVP8XChunks / ParseAnimationFrame / StoreFrame
  bool anim = false;
  std::vector<AnimFrame> frames;
  bool last_complete = true;
  auto header = [&](size_t at, uint32_t* fourcc_size) {  // a chunk's header, size-checked
    if (end - at < 8) throw Error("WebP: truncated chunk data");
    *fourcc_size = le32(&f[at + 4]);
    if (*fourcc_size > 0xFFFFFFF6u) throw Error("WebP: a chunk runs past the end of the RIFF data");
    const size_t padded = size_t(*fourcc_size) + (*fourcc_size & 1);
    if (padded > end - at - 8) throw Error("WebP: a chunk runs past the end of the RIFF data");
    return padded;
  };
  do {
    uint32_t size;
    const size_t padded = header(pos, &size);
    const uint8_t* tag = &f[pos];
    if (!std::memcmp(tag, "VP8X", 4)) throw Error("WebP: a second VP8X chunk");
    if (!std::memcmp(tag, "ALPH", 4) || !std::memcmp(tag, "VP8 ", 4) ||
        !std::memcmp(tag, "VP8L", 4))
      throw Error("WebP: an image chunk outside ANMF in an animated WebP");
    if (!std::memcmp(tag, "ANIM", 4)) {
      if (padded < 6) throw Error("WebP: short ANIM chunk");
      anim = true;  // the background colour and loop count: PIL's pixels ignore them
      pos += 8 + padded;
    } else if (!std::memcmp(tag, "ANMF", 4)) {
      if (!anim) throw Error("WebP: ANMF before ANIM");
      if (padded < 16) throw Error("WebP: short ANMF chunk");
      const uint8_t* d = &f[pos + 8];
      AnimFrame fr;
      fr.x = 2 * le24(d);
      fr.y = 2 * le24(d + 3);
      // the frame's size fields only bound its area: its bitstream's size counts
      if ((1 + uint64_t(le24(d + 6))) * (1 + uint64_t(le24(d + 9))) >= (uint64_t(1) << 32))
        throw Error("WebP: bad frame size");
      const size_t payload = padded - 16, start = pos + 8 + 16;
      if (end - start < 8 || end - start < payload) throw Error("WebP: truncated chunk data");
      size_t cur = start;
      bool has_frame = false, complete = false, done = false;
      while (!done) {
        uint32_t sub_size;
        const size_t sub_padded = header(cur, &sub_size);
        const uint8_t* sub = &f[cur];
        if (!std::memcmp(sub, "ALPH", 4) && !fr.alph) {
          fr.alph = sub + 8;
          fr.alph_size = sub_size;
          fr.alph_last = fr.image != nullptr;
          has_frame = true;
          cur += 8 + sub_padded;
        } else if ((!std::memcmp(sub, "VP8 ", 4) || !std::memcmp(sub, "VP8L", 4)) && !fr.image) {
          fr.lossy = sub[3] == ' ';
          if (!fr.lossy && fr.alph) throw Error("WebP: ALPH before VP8L in a frame");
          frame_features(fr, sub + 8, sub_padded, sub_size);
          fr.image = sub + 8;
          fr.image_size = sub_size;
          has_frame = complete = true;
          cur += 8 + sub_padded;
        } else {
          done = true;  // any other chunk ends the frame
        }
        if (cur == end) done = true;
        else if (end - cur < 8) throw Error("WebP: truncated chunk data");
      }
      if (cur - start > payload) throw Error("WebP: a frame's chunks run past its ANMF chunk");
      // AddFrame: a frame only when it has a chunk, none after an incomplete one
      if (has_frame) {
        if (!last_complete) throw Error("WebP: an ANMF with no image chunk");
        frames.push_back(fr);
        last_complete = complete;
      }
      pos = cur;  // the parse goes on after the frame's chunks
    } else {
      pos += 8 + padded;
    }
  } while (pos != end);
  // IsValidExtendedFormat
  if (frames.empty()) throw Error("WebP: an animated WebP with no frame");
  if (flags & ~0x3E) throw Error("WebP: reserved VP8X flags are set");
  for (const AnimFrame& fr : frames) {
    if (fr.alph_last) throw Error("WebP: ALPH after the image chunk of a frame");
    if (!fr.image) throw Error("WebP: an ANMF with no image chunk");
    if (fr.x + uint64_t(fr.w) > cw || fr.y + uint64_t(fr.h) > ch)
      throw Error("WebP: a frame lies outside the canvas");
  }
  if (too_many_pixels(cw, ch)) throw Error("WebP: bad image size");
  // WebPAnimDecoderGetNext, first frame: a key frame, so the canvas is
  // zeroed (transparent black) and the frame decoded into its rectangle
  const AnimFrame& fr = frames[0];
  Image frame;
  if (fr.lossy) {
    frame = decode_vp8_image(fr.image, fr.image_size, fr.alph, fr.alph_size, true);
  } else {
    check_lossless_header(fr.image, fr.image_size);
    frame = decode_vp8l_image(fr.image, fr.image_size, true);
  }
  const bool alpha = flags & 0x10;  // PIL: RGBA where VP8X has alpha, else RGBX -> RGB
  Image img;
  img.w = int(cw);
  img.h = int(ch);
  img.mode = alpha ? MODE_RGBA : MODE_RGB;
  img.channels = alpha ? 4 : 3;
  img.data.assign(size_t(cw) * size_t(ch) * size_t(img.channels), 0);
  for (int y = 0; y < frame.h; ++y)
    for (int x = 0; x < frame.w; ++x) {
      const uint8_t* s = &frame.data[(size_t(y) * frame.w + x) * 4];
      uint8_t* d = &img.data[((fr.y + y) * size_t(cw) + fr.x + x) * img.channels];
      for (int c = 0; c < img.channels; ++c) d[c] = s[c];
    }
  return img;
}

}  // namespace

Image decode_webp(const std::vector<uint8_t>& f) {
  if (f.size() < 20 || std::memcmp(f.data(), "RIFF", 4) || std::memcmp(&f[8], "WEBP", 4))
    throw Error("not a WebP file");
  size_t pos = 12;
  int alpha = -1;
  const uint8_t *body = nullptr, *alph = nullptr;
  size_t body_size = 0, alph_size = 0;
  bool lossy = false;
  while (pos + 8 <= f.size()) {
    const size_t size = le32(&f[pos + 4]);
    const size_t avail = std::min(size, f.size() - pos - 8);
    if (!std::memcmp(&f[pos], "VP8X", 4)) {
      if (avail < 10) throw Error("WebP: bad VP8X chunk");
      if (f[pos + 8] & 0x02) return decode_webp_anim(f, pos);
      alpha = (f[pos + 8] & 0x10) ? 1 : 0;
    } else if (!std::memcmp(&f[pos], "ALPH", 4)) {
      alph = &f[pos + 8];
      alph_size = avail;
    } else if (!std::memcmp(&f[pos], "VP8 ", 4) || !std::memcmp(&f[pos], "VP8L", 4)) {
      lossy = f[pos + 3] == ' ';
      body = &f[pos + 8];
      body_size = avail;
      break;
    }
    if (size > f.size()) break;
    pos += 8 + size + (size & 1);
  }
  if (!body) throw Error("WebP: no image chunk");
  if (lossy) return decode_vp8_image(body, body_size, alph, alph_size, alpha == 1);
  check_lossless_header(body, body_size);
  if (alpha < 0) alpha = int((le32(body + 1) >> 28) & 1);
  return decode_vp8l_image(body, body_size, alpha == 1);
}

}  // namespace pslx
