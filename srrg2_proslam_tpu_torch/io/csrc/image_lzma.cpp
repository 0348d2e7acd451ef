// The .xz stream libtiff's LZMA codec (compression 34925) writes and reads
// with liblzma, decoded here: the stream header, each block's header (the
// delta filter libtiff puts first, then LZMA2; no other filter), LZMA2
// chunks (uncompressed, or LZMA with state / property / dictionary resets)
// and the LZMA range decoder itself; the index, the footer and the checks
// are not verified.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

struct RangeDecoder {
  const uint8_t* d;
  size_t n, pos;
  uint32_t range = 0xFFFFFFFFu, code = 0;
  RangeDecoder(const uint8_t* data, size_t size) : d(data), n(size), pos(0) {
    if (n < 5 || d[0] != 0) throw Error("TIFF: corrupt LZMA data");
    for (pos = 1; pos < 5; ++pos) code = code << 8 | d[pos];
  }
  uint8_t next() { return pos < n ? d[pos++] : (pos++, 0); }
  void normalize() {
    if (range < (1u << 24)) {
      range <<= 8;
      code = code << 8 | next();
    }
  }
  int bit(uint16_t& p) {
    const uint32_t bound = (range >> 11) * p;
    int b;
    if (code < bound) {
      range = bound;
      p = uint16_t(p + ((2048 - p) >> 5));
      b = 0;
    } else {
      range -= bound;
      code -= bound;
      p = uint16_t(p - (p >> 5));
      b = 1;
    }
    normalize();
    return b;
  }
  uint32_t direct(int count) {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i) {
      range >>= 1;
      const uint32_t t = (code - range) >> 31;  // 1 when code < range
      code -= range & (t - 1);
      v = v << 1 | (1 - t);
      normalize();
    }
    return v;
  }
};

struct BitTree {
  std::vector<uint16_t> p;
  int bits;
  explicit BitTree(int b = 0) : p(size_t(1) << b, 1024), bits(b) {}
  uint32_t decode(RangeDecoder& rc) {
    uint32_t m = 1;
    for (int i = 0; i < bits; ++i) m = m << 1 | uint32_t(rc.bit(p[m]));
    return m - (1u << bits);
  }
  uint32_t reverse(RangeDecoder& rc) {
    uint32_t m = 1, v = 0;
    for (int i = 0; i < bits; ++i) {
      const int b = rc.bit(p[m]);
      m = m << 1 | uint32_t(b);
      v |= uint32_t(b) << i;
    }
    return v;
  }
};

uint32_t reverse_bits(uint16_t* probs, int bits, RangeDecoder& rc) {
  uint32_t m = 1, v = 0;
  for (int i = 0; i < bits; ++i) {
    const int b = rc.bit(probs[m]);
    m = m << 1 | uint32_t(b);
    v |= uint32_t(b) << i;
  }
  return v;
}

struct LengthDecoder {
  uint16_t choice = 1024, choice2 = 1024;
  BitTree low[16], mid[16], high{8};
  LengthDecoder() {
    for (auto& t : low) t = BitTree(3);
    for (auto& t : mid) t = BitTree(3);
  }
  uint32_t decode(RangeDecoder& rc, uint32_t pos_state) {
    if (!rc.bit(choice)) return low[pos_state].decode(rc);
    if (!rc.bit(choice2)) return 8 + mid[pos_state].decode(rc);
    return 16 + high.decode(rc);
  }
};

// The LZMA decoder state LZMA2 keeps across chunks.
struct Lzma {
  int lc = 0, lp = 0, pb = 0;
  std::vector<uint16_t> literal, is_match, is_rep, is_rep0, is_rep1, is_rep2, is_rep0_long,
      dist_special;
  BitTree dist_slot[4], align{4};
  LengthDecoder len, rep_len;
  uint32_t state = 0, rep[4] = {0, 0, 0, 0};

  void set_props(int props) {
    if (props > 224) throw Error("TIFF: bad LZMA properties");
    lc = props % 9;
    lp = (props / 9) % 5;
    pb = props / 45;
    if (lc + lp > 4) throw Error("TIFF: bad LZMA2 properties");
  }
  void reset() {
    literal.assign(size_t(0x300) << (lc + lp), 1024);
    is_match.assign(16 * 12, 1024);
    is_rep.assign(12, 1024);
    is_rep0.assign(12, 1024);
    is_rep1.assign(12, 1024);
    is_rep2.assign(12, 1024);
    is_rep0_long.assign(16 * 12, 1024);
    dist_special.assign(115, 1024);
    for (auto& t : dist_slot) t = BitTree(6);
    align = BitTree(4);
    len = LengthDecoder();
    rep_len = LengthDecoder();
    state = 0;
    for (auto& r : rep) r = 0;
  }

  // one LZMA chunk of ``unpacked`` bytes appended to ``out`` (the dictionary
  // is ``out`` from ``dict_start``)
  void chunk(RangeDecoder& rc, std::vector<uint8_t>& out, size_t dict_start, size_t unpacked) {
    const size_t end = out.size() + unpacked;
    while (out.size() < end) {
      const uint32_t pos_state = uint32_t(out.size() - dict_start) & ((1u << pb) - 1);
      if (!rc.bit(is_match[state * 16 + pos_state])) {  // a literal
        const uint32_t prev = out.size() > dict_start ? out.back() : 0;
        const uint32_t pos = uint32_t(out.size() - dict_start);
        uint16_t* probs =
            &literal[0x300 * size_t(((pos & ((1u << lp) - 1)) << lc) + (prev >> (8 - lc)))];
        uint32_t sym = 1;
        if (state >= 7) {
          if (rep[0] + 1 > out.size() - dict_start) throw Error("TIFF: corrupt LZMA data");
          uint32_t match = out[out.size() - rep[0] - 1];
          while (sym < 0x100) {
            const uint32_t mbit = (match >> 7) & 1;
            match <<= 1;
            const int b = rc.bit(probs[((1 + mbit) << 8) + sym]);
            sym = sym << 1 | uint32_t(b);
            if (mbit != uint32_t(b)) break;
          }
        }
        while (sym < 0x100) sym = sym << 1 | uint32_t(rc.bit(probs[sym]));
        out.push_back(uint8_t(sym));
        state = state < 4 ? 0 : (state < 10 ? state - 3 : state - 6);
        continue;
      }
      uint32_t length;
      if (rc.bit(is_rep[state])) {
        if (out.size() == dict_start) throw Error("TIFF: corrupt LZMA data");
        if (!rc.bit(is_rep0[state])) {
          if (!rc.bit(is_rep0_long[state * 16 + pos_state])) {  // a short rep
            state = state < 7 ? 9 : 11;
            if (rep[0] + 1 > out.size() - dict_start) throw Error("TIFF: corrupt LZMA data");
            out.push_back(out[out.size() - rep[0] - 1]);
            continue;
          }
        } else {
          uint32_t dist;
          if (!rc.bit(is_rep1[state])) {
            dist = rep[1];
          } else {
            if (!rc.bit(is_rep2[state])) {
              dist = rep[2];
            } else {
              dist = rep[3];
              rep[3] = rep[2];
            }
            rep[2] = rep[1];
          }
          rep[1] = rep[0];
          rep[0] = dist;
        }
        length = rep_len.decode(rc, pos_state);
        state = state < 7 ? 8 : 11;
      } else {
        rep[3] = rep[2];
        rep[2] = rep[1];
        rep[1] = rep[0];
        length = len.decode(rc, pos_state);
        state = state < 7 ? 7 : 10;
        const uint32_t slot = dist_slot[std::min<uint32_t>(length, 3)].decode(rc);
        uint32_t dist;
        if (slot < 4) {
          dist = slot;
        } else {
          const int bits = int(slot >> 1) - 1;
          dist = (2 | (slot & 1)) << bits;
          if (slot < 14) {
            dist += reverse_bits(&dist_special[dist - slot], bits, rc);
          } else {
            dist += rc.direct(bits - 4) << 4;
            dist += align.reverse(rc);
          }
        }
        rep[0] = dist;
        if (dist == 0xFFFFFFFFu) throw Error("TIFF: an LZMA end marker inside LZMA2");
      }
      length += 2;
      if (rep[0] + 1 > out.size() - dict_start) throw Error("TIFF: corrupt LZMA data");
      if (out.size() + length > end) throw Error("TIFF: corrupt LZMA data");
      for (uint32_t k = 0; k < length; ++k) out.push_back(out[out.size() - rep[0] - 1]);
    }
  }
};

uint64_t varint(const uint8_t* d, size_t n, size_t& pos) {
  uint64_t v = 0;
  for (int shift = 0; shift < 63; shift += 7) {
    if (pos >= n) throw Error("TIFF: truncated xz header");
    const uint8_t b = d[pos++];
    v |= uint64_t(b & 0x7F) << shift;
    if (!(b & 0x80)) return v;
  }
  throw Error("TIFF: bad xz header");
}

}  // namespace

std::vector<uint8_t> decode_xz(const uint8_t* d, size_t n, size_t want) {
  static const uint8_t magic[6] = {0xFD, '7', 'z', 'X', 'Z', 0};
  if (n < 12 || std::memcmp(d, magic, 6)) throw Error("TIFF: LZMA data is not an xz stream");
  size_t pos = 12;
  std::vector<uint8_t> out;
  out.reserve(want);
  while (out.size() < want) {
    if (pos >= n) throw Error("TIFF: truncated xz stream");
    if (d[pos] == 0) break;  // the index: no more blocks
    const size_t header = (size_t(d[pos]) + 1) * 4, block = pos;
    if (header > n - pos) throw Error("TIFF: truncated xz block header");
    const uint8_t flags = d[pos + 1];
    pos += 2;
    if (flags & 0x40) varint(d, n, pos);  // compressed size
    if (flags & 0x80) varint(d, n, pos);  // uncompressed size
    const int filters = (flags & 3) + 1;
    size_t delta = 0;  // libtiff puts a delta filter ahead of LZMA2
    for (int f = 0; f < filters; ++f) {
      const uint64_t id = varint(d, n, pos), props = varint(d, n, pos);
      const bool last = f == filters - 1;
      if (props != 1 || pos >= n || !((last && id == 0x21) || (!last && id == 0x03 && f == 0)))
        throw Error("TIFF: xz filters other than delta and LZMA2 are not supported");
      if (id == 0x03) delta = size_t(d[pos]) + 1;
      ++pos;
    }
    pos = block + header;
    // LZMA2 chunks
    Lzma lz;
    const size_t dict_start = out.size();
    bool have_props = false;
    for (;;) {
      if (pos >= n) throw Error("TIFF: truncated LZMA2 data");
      const uint8_t control = d[pos++];
      if (control == 0) break;
      if (control == 1 || control == 2) {
        if (pos + 2 > n) throw Error("TIFF: truncated LZMA2 data");
        const size_t size = (size_t(d[pos]) << 8 | d[pos + 1]) + 1;
        pos += 2;
        if (size > n - pos) throw Error("TIFF: truncated LZMA2 data");
        out.insert(out.end(), d + pos, d + pos + size);
        pos += size;
        continue;
      }
      if (control < 0x80) throw Error("TIFF: bad LZMA2 control byte");
      if (pos + 4 > n) throw Error("TIFF: truncated LZMA2 data");
      const size_t unpacked =
          ((size_t(control & 0x1F) << 16) | size_t(d[pos]) << 8 | d[pos + 1]) + 1;
      const size_t packed = (size_t(d[pos + 2]) << 8 | d[pos + 3]) + 1;
      pos += 4;
      const int reset = (control >> 5) & 3;
      if (reset >= 2) {
        if (pos >= n) throw Error("TIFF: truncated LZMA2 data");
        lz.set_props(d[pos++]);
        have_props = true;
      }
      if (!have_props) throw Error("TIFF: LZMA2 data without properties");
      if (reset >= 1) lz.reset();
      if (packed > n - pos) throw Error("TIFF: truncated LZMA2 data");
      if (out.size() + unpacked > want + (size_t(1) << 21)) throw Error("TIFF: corrupt LZMA data");
      RangeDecoder rc(d + pos, packed);
      lz.chunk(rc, out, dict_start, unpacked);
      pos += packed;
    }
    for (size_t i = dict_start + delta; delta && i < out.size(); ++i)
      out[i] = uint8_t(out[i] + out[i - delta]);
    // block padding to 4 bytes, then the check (its size from the stream flags)
    while ((pos - block) % 4) ++pos;
    const int check = d[7] & 0x0F;
    pos += check == 0 ? 0 : (check == 1 ? 4 : (check == 4 ? 8 : (check == 10 ? 32 : 0)));
  }
  if (out.size() > want) out.resize(want);
  return out;
}

}  // namespace pslx
