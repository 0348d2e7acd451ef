// DDS as PIL 12's DdsImagePlugin reads it: the first surface of a file
// with a 124-byte header; RGB / RGBA through bit masks (DdsRgbDecoder:
// each field / its maximum x 255 in double precision, truncated; a short
// read gives zeros), 8-bit luminance (L), 16-bit luminance + alpha (LA),
// 8-bit palette (P, a 1024-byte RGBA palette), DX10 R8G8B8A8, and the
// block formats BC1 / DXT1, BC2 / DXT3, BC3 / DXT5 (RGBA), BC4 / ATI1 (L),
// BC5 / ATI2 unsigned and signed (RGB, blue 0 or the signed zero 128),
// BC6H unsigned and signed (RGB; the reserved modes black) and BC7 (RGBA;
// the reserved mode 8 opaque black) as Pillow's BcnDecode.c decodes them
// (its integer interpolation, not the format document's float rule).
// Refused with a message: the other DXGI formats, other pixel format flags,
// truncated data.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstring>
#include <sstream>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

struct Rgba {
  int r = 0, g = 0, b = 0, a = 255;
};

Rgba rgb565(uint32_t x) {
  Rgba c;
  int r = int((x & 0xF800) >> 8), g = int((x & 0x7E0) >> 3), b = int((x & 0x1F) << 3);
  c.r = r | r >> 5;
  c.g = g | g >> 6;
  c.b = b | b >> 5;
  return c;
}

// BcnDecode.c decode_bc1_color (``four``: BC2 / BC3 always take the
// four-colour branch)
void bc1_colours(const uint8_t* s, bool four, Rgba* out) {
  uint32_t c0 = le16(s), c1 = le16(s + 2);
  Rgba p[4];
  p[0] = rgb565(c0);
  p[1] = rgb565(c1);
  if (c0 > c1 || four) {
    p[2] = {(2 * p[0].r + p[1].r) / 3, (2 * p[0].g + p[1].g) / 3, (2 * p[0].b + p[1].b) / 3,
            255};
    p[3] = {(p[0].r + 2 * p[1].r) / 3, (p[0].g + 2 * p[1].g) / 3, (p[0].b + 2 * p[1].b) / 3,
            255};
  } else {
    p[2] = {(p[0].r + p[1].r) / 2, (p[0].g + p[1].g) / 2, (p[0].b + p[1].b) / 2, 255};
    p[3] = {0, 0, 0, 0};
  }
  uint32_t lut = le32(s + 4);
  for (int n = 0; n < 16; ++n) out[n] = p[(lut >> (2 * n)) & 3];
}

// BcnDecode.c decode_bc3_alpha (``sign``: BC5 signed, a0 / a1 + 128)
void bc3_alpha(const uint8_t* s, bool sign, int* out) {
  int a0 = s[0], a1 = s[1];
  if (sign) {
    a0 = (int(int8_t(s[0])) + 128) & 0xFFFF;
    a1 = (int(int8_t(s[1])) + 128) & 0xFFFF;
  }
  int a[8] = {a0 & 0xFF, a1 & 0xFF};
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k) a[1 + k] = ((7 - k) * a0 + k * a1) / 7 & 0xFF;
  } else {
    for (int k = 1; k <= 4; ++k) a[1 + k] = ((5 - k) * a0 + k * a1) / 5 & 0xFF;
    a[6] = 0;
    a[7] = 255;
  }
  uint32_t lut1 = uint32_t(s[2]) | uint32_t(s[3]) << 8 | uint32_t(s[4]) << 16;
  uint32_t lut2 = uint32_t(s[5]) | uint32_t(s[6]) << 8 | uint32_t(s[7]) << 16;
  for (int n = 0; n < 8; ++n) out[n] = a[(lut1 >> (3 * n)) & 7];
  for (int n = 0; n < 8; ++n) out[8 + n] = a[(lut2 >> (3 * n)) & 7];
}

// ---- BC7 (BcnDecode.c decode_bc7_block) ----------------------------------

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
const Bc7Mode kBc7Modes[8] = {{3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0},
                              {3, 6, 0, 0, 5, 0, 0, 0, 2, 0}, {2, 6, 0, 0, 7, 0, 1, 0, 2, 0},
                              {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
                              {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
const uint16_t kBc7P2[64] = {
    0xCCCC, 0x8888, 0xEEEE, 0xECC8, 0xC880, 0xFEEC, 0xFEC8, 0xEC80, 0xC800, 0xFFEC, 0xFE80,
    0xE800, 0xFFE8, 0xFF00, 0xFFF0, 0xF000, 0xF710, 0x008E, 0x7100, 0x08CE, 0x008C, 0x7310,
    0x3100, 0x8CCE, 0x088C, 0x3110, 0x6666, 0x366C, 0x17E8, 0x0FF0, 0x718E, 0x399C, 0xAAAA,
    0xF0F0, 0x5A5A, 0x33CC, 0x3C3C, 0x55AA, 0x9696, 0xA55A, 0x73CE, 0x13C8, 0x324C, 0x3BDC,
    0x6996, 0xC33C, 0x9966, 0x0660, 0x0272, 0x04E4, 0x4E40, 0x2720, 0xC936, 0x936C, 0x39C6,
    0x639C, 0x9336, 0x9CC6, 0x817E, 0xE718, 0xCCF0, 0x0FCC, 0x7744, 0xEE22};
const char kBc7P3[] =
    "0011001102212222000100112211222100002001221122110222002200110111"
    "0000000011221122001100110022002200220022111111110011001122112211"
    "0000000011112222000011111111222200001111222222220012001200120012"
    "0112011201120112012201220122012200110112112212220011200122002220"
    "0001001101121122011100112001220000001122112211220022002200221111"
    "0111011102220222000100012221222100000011012201220000110022102210"
    "0122012200110000001200121122222201101221122101100000011012211221"
    "0022110211020022011001102002222200110122012200110000200022112221"
    "0000000211221222022200220012001100110012002202220120012001200120"
    "0000111122220000012012012012012001202012120101200011220011220011"
    "0011112222000011010101012222222200000000212121210022112200221122"
    "0022001100220011022012210220122101012222222201010000212121212121"
    "0101010101012222022201110222011100021112000211120000211221122112"
    "0222011101110222000211121112000201100110011022220000000021122112"
    "0110011022222222002200110011002200221122112200220000000000002112"
    "0002000100020001022212220222122201012222222222220111201122012220";
const uint8_t kBc7Anchor2[64] = {15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 15,
                                 15, 2,  8,  2,  2,  8,  8,  15, 2,  8,  2,  2,  8,  8,  2,  2,
                                 15, 15, 6,  8,  2,  8,  15, 15, 2,  8,  2,  2,  2,  15, 15, 6,
                                 6,  2,  6,  8,  15, 15, 2,  2,  15, 15, 15, 15, 15, 2,  2,  15};
const uint8_t kBc7Anchor3a[64] = {3,  3,  15, 15, 8,  3,  15, 15, 8,  8,  6,  6,  6,  5,  3,  3,
                                  3,  3,  8,  15, 3,  3,  6,  10, 5,  8,  8,  6,  8,  5,  15, 15,
                                  8,  15, 3,  5,  6,  10, 8,  15, 15, 3,  15, 5,  15, 15, 15, 15,
                                  3,  15, 5,  5,  5,  8,  5,  10, 5,  10, 8,  13, 15, 12, 3,  3};
const uint8_t kBc7Anchor3b[64] = {15, 8,  8,  3,  15, 15, 3,  8,  15, 15, 15, 15, 15, 15, 15, 8,
                                  15, 8,  15, 3,  15, 8,  15, 8,  3,  15, 6,  10, 15, 15, 10, 8,
                                  15, 3,  15, 10, 10, 8,  9,  10, 6,  15, 8,  15, 3,  6,  6,  8,
                                  15, 3,  15, 15, 15, 15, 15, 15, 15, 15, 15, 15, 3,  15, 15, 8};
const int kBc7W2[4] = {0, 21, 43, 64}, kBc7W3[8] = {0, 9, 18, 27, 37, 46, 55, 64},
          kBc7W4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};

int bc7_weight(int bits, int index) {
  return bits == 2 ? kBc7W2[index] : (bits == 3 ? kBc7W3[index] : kBc7W4[index]);
}

void bc7_block(const uint8_t* s, Rgba* out) {
  int mode = 0;
  while (mode < 8 && !((s[0] >> mode) & 1)) ++mode;
  if (mode == 8) {  // reserved: opaque black
    for (int k = 0; k < 16; ++k) out[k] = {0, 0, 0, 255};
    return;
  }
  const Bc7Mode& m = kBc7Modes[mode];
  int pos = mode + 1;
  auto take = [&](int n) {
    int v = 0;
    for (int i = 0; i < n; ++i, ++pos) v |= ((s[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  };
  const int partition = take(m.pb), rotation = take(m.rb), index_sel = take(m.isb);
  int ep[6][4] = {};
  const int ne = 2 * m.ns;
  for (int c = 0; c < 3; ++c)
    for (int j = 0; j < ne; ++j) ep[j][c] = take(m.cb);
  if (m.ab)
    for (int j = 0; j < ne; ++j) ep[j][3] = take(m.ab);
  int cb = m.cb, ab = m.ab;
  if (m.epb) {
    ++cb;
    if (ab) ++ab;
    for (int j = 0; j < ne; ++j) {
      int p = take(1);
      for (int c = 0; c < 3; ++c) ep[j][c] = ep[j][c] << 1 | p;
      if (ab) ep[j][3] = ep[j][3] << 1 | p;
    }
  }
  if (m.spb) {
    ++cb;
    if (ab) ++ab;
    for (int k = 0; k < m.ns; ++k) {
      int p = take(1);
      for (int j = 2 * k; j < 2 * k + 2; ++j) {
        for (int c = 0; c < 3; ++c) ep[j][c] = ep[j][c] << 1 | p;
        if (ab) ep[j][3] = ep[j][3] << 1 | p;
      }
    }
  }
  auto unquantize = [](int x, int bits) {
    x = (x << (8 - bits)) & 0xFF;
    return x | (x >> bits);
  };
  for (int j = 0; j < ne; ++j) {
    for (int c = 0; c < 3; ++c) ep[j][c] = unquantize(ep[j][c], cb);
    ep[j][3] = ab ? unquantize(ep[j][3], ab) : 255;
  }
  int subset[16], anchors[3] = {0, -1, -1};
  for (int i = 0; i < 16; ++i)
    subset[i] = m.ns == 1 ? 0
                : m.ns == 2 ? (kBc7P2[partition] >> i) & 1 : kBc7P3[16 * partition + i] - '0';
  if (m.ns == 2) anchors[1] = kBc7Anchor2[partition];
  if (m.ns == 3) {
    anchors[1] = kBc7Anchor3a[partition];
    anchors[2] = kBc7Anchor3b[partition];
  }
  int idx1[16], idx2[16];
  for (int i = 0; i < 16; ++i) {
    bool anchor = i == anchors[0] || i == anchors[1] || i == anchors[2];
    idx1[i] = take(m.ib - (anchor ? 1 : 0));
  }
  for (int i = 0; i < 16; ++i) idx2[i] = m.ib2 ? take(m.ib2 - (i == 0 ? 1 : 0)) : idx1[i];
  for (int i = 0; i < 16; ++i) {
    const int* e0 = ep[2 * subset[i]];
    const int* e1 = ep[2 * subset[i] + 1];
    int ci = idx1[i], ai = idx2[i], cbits = m.ib, abits = m.ib2 ? m.ib2 : m.ib;
    if (m.ib2 && index_sel) {
      ci = idx2[i];
      ai = idx1[i];
      cbits = m.ib2;
      abits = m.ib;
    }
    const int wc = bc7_weight(cbits, ci), wa = bc7_weight(abits, ai);
    int v[4];
    for (int c = 0; c < 3; ++c) v[c] = (e0[c] * (64 - wc) + e1[c] * wc + 32) >> 6;
    v[3] = (e0[3] * (64 - wa) + e1[3] * wa + 32) >> 6;
    if (rotation) std::swap(v[3], v[rotation - 1]);
    out[i] = {v[0], v[1], v[2], v[3]};
  }
}


// ---- BC6H (BcnDecode.c decode_bc6_block) -----------------------------------
// Each rule was found by random blocks of every mode against PIL 12.1.

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;  // subsets, transformed, partition / endpoint / delta bits
};
const Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5}, {2, 1, 5, 7, 6, 6, 6},   {2, 1, 5, 11, 5, 4, 4},
    {2, 1, 5, 11, 4, 5, 4}, {2, 1, 5, 11, 4, 4, 5},  {2, 1, 5, 9, 5, 5, 5},
    {2, 1, 5, 8, 6, 5, 5},  {2, 1, 5, 8, 5, 6, 5},   {2, 1, 5, 8, 5, 5, 6},
    {2, 0, 5, 6, 6, 6, 6},  {1, 0, 0, 10, 10, 10, 10}, {1, 1, 0, 11, 9, 9, 9},
    {1, 1, 0, 12, 8, 8, 8}, {1, 1, 0, 16, 4, 4, 4}};
// The endpoint bits of each mode as the BC6H format document lays them out,
// from the block's low bits up, after the mode bits; "r0[10:15]" stores the
// bits reversed (r0[15] first).  The endpoints are r0 g0 b0 r1 g1 b1 (subset
// 0) and r2 g2 b2 r3 g3 b3 (subset 1).  images_plain_more._BC6_LAYOUTS is
// the same table.
const char* const kBc6Layouts[14] = {
    "g2[4] b2[4] b3[4] r0[9:0] g0[9:0] b0[9:0] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "g2[5] g3[4] g3[5] r0[6:0] b3[0] b3[1] b2[4] g0[6:0] b2[5] b3[2] g2[4] b0[6:0] b3[3] b3[5] "
    "b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[4:0] r0[10] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] b1[3:0] "
    "b0[10] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] g3[4] g2[3:0] g1[4:0] g0[10] g3[3:0] b1[3:0] "
    "b0[10] b3[1] b2[3:0] r2[3:0] b3[0] b3[2] r3[3:0] g2[4] b3[3]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10] b2[4] g2[3:0] g1[3:0] g0[10] b3[0] g3[3:0] "
    "b1[4:0] b0[10] b2[3:0] r2[3:0] b3[1] b3[2] r3[3:0] b3[4] b3[3]",
    "r0[8:0] b2[4] g0[8:0] g2[4] b0[8:0] b3[4] r1[4:0] g3[4] g2[3:0] g1[4:0] b3[0] g3[3:0] "
    "b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] g3[4] b2[4] g0[7:0] b3[2] g2[4] b0[7:0] b3[3] b3[4] r1[5:0] g2[3:0] g1[4:0] "
    "b3[0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[5:0] r3[5:0]",
    "r0[7:0] b3[0] b2[4] g0[7:0] g2[5] g2[4] b0[7:0] g3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[5:0] g3[3:0] b1[4:0] b3[1] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[7:0] b3[1] b2[4] g0[7:0] b2[5] g2[4] b0[7:0] b3[5] b3[4] r1[4:0] g3[4] g2[3:0] "
    "g1[4:0] b3[0] g3[3:0] b1[5:0] b2[3:0] r2[4:0] b3[2] r3[4:0] b3[3]",
    "r0[5:0] g3[4] b3[0] b3[1] b2[4] g0[5:0] g2[5] b2[5] b3[2] g2[4] b0[5:0] g3[5] b3[3] "
    "b3[5] b3[4] r1[5:0] g2[3:0] g1[5:0] g3[3:0] b1[5:0] b2[3:0] r2[5:0] r3[5:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[9:0] g1[9:0] b1[9:0]",
    "r0[9:0] g0[9:0] b0[9:0] r1[8:0] r0[10] g1[8:0] g0[10] b1[8:0] b0[10]",
    "r0[9:0] g0[9:0] b0[9:0] r1[7:0] r0[10:11] g1[7:0] g0[10:11] b1[7:0] b0[10:11]",
    "r0[9:0] g0[9:0] b0[9:0] r1[3:0] r0[10:15] g1[3:0] g0[10:15] b1[3:0] b0[10:15]"};

// a layout -> one entry per stored bit: endpoint * 16 + bit
std::vector<uint8_t> bc6_packing(const char* layout) {
  std::vector<uint8_t> out;
  std::istringstream in(layout);
  std::string tok;
  while (in >> tok) {
    const int e = 3 * (tok[1] - '0') + int(std::string("rgb").find(tok[0]));
    const size_t colon = tok.find(':');
    const int a = std::stoi(tok.substr(3)), b = colon == std::string::npos ? a : std::stoi(
                                                   tok.substr(colon + 1));
    if (a >= b)
      for (int k = b; k <= a; ++k) out.push_back(uint8_t(e * 16 + k));
    else
      for (int k = b; k >= a; --k) out.push_back(uint8_t(e * 16 + k));
  }
  return out;
}

uint16_t bc6_sign_extend(uint16_t v, int prec) {
  int x = v;
  if (x & (1 << (prec - 1))) x |= -1 << prec;
  return uint16_t(x);
}

int bc6_unquantize(uint16_t v, int prec, bool sign) {
  if (!sign) {
    const int x = v;
    if (prec >= 15) return x;
    if (x == 0) return 0;
    if (x == (1 << prec) - 1) return 0xFFFF;
    return ((x << 15) + 0x4000) >> (prec - 1);
  }
  int x = int16_t(v);
  if (prec >= 16) return x;
  const bool negative = x < 0;
  if (negative) x = -x;
  if (x) x = x >= (1 << (prec - 1)) - 1 ? 0x7FFF : ((x << 15) + 0x4000) >> (prec - 1);
  return negative ? -x : x;
}

// BcnDecode.c half_to_float: the exponent rebased by a float multiply
float bc6_half(uint16_t h) {
  uint32_t u = uint32_t(h & 0x7FFF) << 13, mu = 0x77800000;
  float f, m;
  std::memcpy(&f, &u, 4);
  std::memcpy(&m, &mu, 4);
  f *= m;
  mu = 0x47800000;
  std::memcpy(&m, &mu, 4);
  std::memcpy(&u, &f, 4);
  if (f >= m) u |= 255u << 23;
  u |= uint32_t(h & 0x8000) << 16;
  std::memcpy(&f, &u, 4);
  return f;
}

// bc6_finalize (the 31/32 or 31/64 scale to a half) and bc6_clamp (x 255,
// truncated)
uint8_t bc6_channel(int v, bool sign) {
  float f;
  if (!sign) f = bc6_half(uint16_t((v * 31) / 64));
  else if (v < 0) f = bc6_half(uint16_t(0x8000 | ((-v) * 31) / 32));
  else f = bc6_half(uint16_t((v * 31) / 32));
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(const uint8_t* s, bool sign, Rgba* out) {
  static const std::array<std::vector<uint8_t>, 14> packings = [] {
    std::array<std::vector<uint8_t>, 14> p;
    for (int m = 0; m < 14; ++m) p[m] = bc6_packing(kBc6Layouts[m]);
    return p;
  }();
  int mode = s[0] & 0x1F, pos = 5, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    pos = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {  // reserved: black
    for (int k = 0; k < 16; ++k) out[k] = {0, 0, 0, 255};
    return;
  }
  auto take = [&](int n) {
    int v = 0;
    for (int i = 0; i < n; ++i, ++pos) v |= ((s[pos >> 3] >> (pos & 7)) & 1) << i;
    return v;
  };
  const Bc6Mode& m = kBc6Modes[mode];
  const int numep = m.ns == 2 ? 12 : 6, mask = (1 << m.epb) - 1;
  uint16_t ep[12] = {};
  for (uint8_t bit : packings[mode]) ep[bit >> 4] |= uint16_t(take(1) << (bit & 15));
  const int partition = take(m.pb);
  const int delta_bits[3] = {m.rb, m.gb, m.bb};
  if (sign)
    for (int i = 0; i < 3; ++i) ep[i] = bc6_sign_extend(ep[i], m.epb);
  if (sign || m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = bc6_sign_extend(ep[i], delta_bits[i % 3]);
  // the deltas are added and masked to the endpoint bits, and (unlike the
  // format document) not sign-extended again for the signed format
  if (m.tr)
    for (int i = 3; i < numep; ++i) ep[i] = uint16_t((ep[i] + ep[i % 3]) & mask);
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  for (int i = 0; i < 16; ++i) {
    const int subset = m.ns == 2 ? (kBc7P2[partition] >> i) & 1 : 0;
    const bool anchor = i == 0 || (m.ns == 2 && i == kBc7Anchor2[partition]);
    const int w = bc7_weight(ib, take(ib - (anchor ? 1 : 0)));
    const int* e0 = &u[6 * subset];
    int v[3];
    for (int c = 0; c < 3; ++c) v[c] = bc6_channel((e0[c] * (64 - w) + e0[3 + c] * w) >> 6, sign);
    out[i] = {v[0], v[1], v[2], 255};
  }
}

// n: 1-5 (BC1-BC5), -5 for signed BC5, 6 / -6 (BC6H unsigned / signed), 7 (BC7)
void decode_bcn(const std::vector<uint8_t>& f, size_t pos, int n, Image& img) {
  const int size = (n == 1 || n == 4) ? 8 : 16;
  const size_t bw = (size_t(img.w) + 3) / 4, bh = (size_t(img.h) + 3) / 4;
  if (pos > f.size() || bw * bh * size > f.size() - pos) throw Error("DDS: truncated image data");
  Rgba px[16];
  int ch[2][16];
  for (size_t by = 0; by < bh; ++by)
    for (size_t bx = 0; bx < bw; ++bx) {
      const uint8_t* s = &f[pos + (by * bw + bx) * size];
      if (n == 7) {
        bc7_block(s, px);
      } else if (n == 6 || n == -6) {
        bc6_block(s, n < 0, px);
      } else if (n == 1) {
        bc1_colours(s, false, px);
      } else if (n == 2 || n == 3) {
        bc1_colours(s + 8, true, px);
        if (n == 2) {
          for (int k = 0; k < 16; ++k) {
            int v = (s[k >> 1] >> ((k & 1) * 4)) & 15;
            px[k].a = v | v << 4;
          }
        } else {
          bc3_alpha(s, false, ch[0]);
          for (int k = 0; k < 16; ++k) px[k].a = ch[0][k];
        }
      } else if (n == 4) {
        bc3_alpha(s, false, ch[0]);
        for (int k = 0; k < 16; ++k) px[k].r = ch[0][k];
      } else {
        bc3_alpha(s, n < 0, ch[0]);
        bc3_alpha(s + 8, n < 0, ch[1]);
        for (int k = 0; k < 16; ++k) px[k] = {ch[0][k], ch[1][k], n < 0 ? 128 : 0, 255};
      }
      for (int k = 0; k < 16; ++k) {
        size_t x = bx * 4 + size_t(k & 3), y = by * 4 + size_t(k >> 2);
        if (x >= size_t(img.w) || y >= size_t(img.h)) continue;
        uint8_t* d = &img.data[(y * size_t(img.w) + x) * img.channels];
        const int v[4] = {px[k].r, px[k].g, px[k].b, px[k].a};
        for (int c = 0; c < img.channels; ++c) d[c] = uint8_t(v[c]);
      }
    }
}

}  // namespace

Image decode_dds(const std::vector<uint8_t>& f) {
  if (f.size() < 4 || std::memcmp(f.data(), "DDS ", 4)) throw Error("not a DDS file");
  if (f.size() < 128 || le32(&f[4]) != 124) throw Error("DDS: unsupported or incomplete header");
  Image img;
  img.h = int(le32(&f[12]));
  img.w = int(le32(&f[16]));
  if (le32(&f[12]) > kMaxPixels || le32(&f[16]) > kMaxPixels ||
      too_many_pixels(le32(&f[16]), le32(&f[12])))
    throw Error("DDS: bad image size");
  const uint32_t pfflags = le32(&f[80]), bitcount = le32(&f[88]);
  const uint8_t* fourcc = &f[84];
  size_t pos = 128;
  int n = 0;
  auto alloc = [&](int mode, int channels) {
    img.mode = mode;
    img.channels = channels;
    img.data.assign(size_t(img.w) * img.h * channels, 0);
  };
  if (pfflags & 0x40) {  // DdsRgbDecoder
    const int count = (pfflags & 0x1) ? 4 : 3;
    alloc(count == 4 ? MODE_RGBA : MODE_RGB, count);
    uint32_t mask[4], shift[4], total[4];
    for (int c = 0; c < count; ++c) {
      mask[c] = le32(&f[92 + 4 * size_t(c)]);
      shift[c] = 0;
      while (mask[c] && !((mask[c] >> shift[c]) & 1)) ++shift[c];
      total[c] = mask[c] >> shift[c];
    }
    const size_t nbytes = bitcount / 8, npx = size_t(img.w) * img.h;
    for (size_t i = 0; i < npx; ++i) {
      uint64_t value = 0;
      for (size_t k = 0; k < nbytes; ++k) {
        size_t at = pos + i * nbytes + k;
        if (at < f.size()) value |= uint64_t(f[at]) << (8 * k);
      }
      for (int c = 0; c < count; ++c)
        img.data[i * count + c] =
            total[c] ? uint8_t(int(double((value & mask[c]) >> shift[c]) / double(total[c]) * 255))
                     : 0;
    }
    return img;
  }
  if (pfflags & 0x20000) {
    if (bitcount == 8) alloc(MODE_L, 1);
    else if (bitcount == 16 && (pfflags & 0x1)) alloc(MODE_LA, 2);
    else throw Error("DDS: unsupported bitcount " + std::to_string(bitcount) + " for " +
                     std::to_string(pfflags));
  } else if (pfflags & 0x20) {
    alloc(MODE_P, 1);
    for (size_t i = 0; i + 4 <= 1024 && pos + i + 4 <= f.size(); i += 4)
      img.palette.insert(img.palette.end(), &f[pos + i], &f[pos + i + 3]);
    pos += 1024;
  } else if (pfflags & 0x4) {
    std::string fc(reinterpret_cast<const char*>(fourcc), 4);
    int mode = MODE_RGBA;
    if (fc == "DX10") {
      if (f.size() < 132) throw Error("DDS: truncated DX10 header");
      uint32_t dxgi = le32(&f[128]);
      pos += 20;
      if (dxgi == 70 || dxgi == 71) n = 1;
      else if (dxgi == 73 || dxgi == 74) n = 2;
      else if (dxgi == 76 || dxgi == 77) n = 3;
      else if (dxgi == 79 || dxgi == 80) n = 4;
      else if (dxgi == 82 || dxgi == 83) n = 5;
      else if (dxgi == 84) n = -5;
      else if (dxgi == 95) n = 6;
      else if (dxgi == 96) n = -6;
      else if (dxgi == 97 || dxgi == 98 || dxgi == 99) n = 7;
      else if (dxgi != 27 && dxgi != 28 && dxgi != 29)
        throw Error("DDS: DXGI format " + std::to_string(dxgi) + " is not supported");
    } else if (fc == "DXT1") {
      n = 1;
    } else if (fc == "DXT3") {
      n = 2;
    } else if (fc == "DXT5") {
      n = 3;
    } else if (fc == "BC4U" || fc == "ATI1") {
      n = 4;
    } else if (fc == "BC5S") {
      n = -5;
    } else if (fc == "BC5U" || fc == "ATI2") {
      n = 5;
    } else {
      throw Error("DDS: pixel format " + fc + " is not supported");
    }
    if (n == 4) mode = MODE_L;
    else if (n == 5 || n == -5 || n == 6 || n == -6) mode = MODE_RGB;
    alloc(mode, mode == MODE_L ? 1 : (mode == MODE_RGB ? 3 : 4));
  } else {
    throw Error("DDS: unknown pixel format flags " + std::to_string(pfflags));
  }
  if (n) {
    decode_bcn(f, pos, n, img);
    return img;
  }
  if (pos > f.size() || img.data.size() > f.size() - pos) throw Error("DDS: truncated image data");
  std::memcpy(img.data.data(), &f[pos], img.data.size());
  return img;
}

}  // namespace pslx
