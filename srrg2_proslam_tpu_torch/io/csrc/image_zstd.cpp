// Zstandard frames (RFC 8878), as libtiff's ZSTD codec (compression 50000)
// reads a strip or tile with ZSTD_decompressStream: the first frame only
// (libtiff stops at the end of a frame, so a skippable frame first leaves
// the strip short and is an error), raw / RLE / compressed blocks,
// literals raw, RLE or Huffman-coded (one or four streams, the tree described by direct or
// FSE-compressed weights, or repeated from the previous block), sequences
// with predefined, RLE, FSE-compressed or repeated tables and the three
// repeat offsets, and the optional content checksum (the low 32 bits of
// XXH64) verified.  Dictionaries are refused; libtiff never uses one.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

[[noreturn]] void corrupt(const char* what) {
  throw Error(std::string("TIFF: corrupt ZSTD data (") + what + ")");
}

int highbit(uint32_t v) {
  int n = -1;
  while (v) {
    v >>= 1;
    ++n;
  }
  return n;
}

// ---- XXH64 ------------------------------------------------------------------------------

constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                   P3 = 1609587929392839161ull, P4 = 9650029242287828579ull,
                   P5 = 2870177450012600261ull;
uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t le64(const uint8_t* p) { return uint64_t(le32(p)) | (uint64_t(le32(p + 4)) << 32); }
uint64_t xxround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }

uint64_t xxh64(const uint8_t* p, size_t n) {
  const uint8_t* end = p + n;
  uint64_t h;
  if (n >= 32) {
    uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
    while (end - p >= 32) {
      v1 = xxround(v1, le64(p));
      v2 = xxround(v2, le64(p + 8));
      v3 = xxround(v3, le64(p + 16));
      v4 = xxround(v4, le64(p + 24));
      p += 32;
    }
    h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
    for (uint64_t v : {v1, v2, v3, v4}) h = (h ^ xxround(0, v)) * P1 + P4;
  } else {
    h = P5;
  }
  h += uint64_t(n);
  while (end - p >= 8) {
    h = rotl(h ^ xxround(0, le64(p)), 27) * P1 + P4;
    p += 8;
  }
  if (end - p >= 4) {
    h = rotl(h ^ (uint64_t(le32(p)) * P1), 23) * P2 + P3;
    p += 4;
  }
  while (p < end) h = rotl(h ^ (uint64_t(*p++) * P5), 11) * P1;
  h ^= h >> 33;
  h *= P2;
  h ^= h >> 29;
  h *= P3;
  h ^= h >> 32;
  return h;
}

// ---- bit readers ---------------------------------------------------------------------------

// Forward, least significant bit first (FSE table descriptions).
struct ForwardBits {
  const uint8_t* d;
  size_t n, bit = 0;
  uint32_t read(int count) {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i, ++bit) {
      const size_t byte = bit >> 3;
      if (byte >= n) corrupt("a table description runs past the block");
      v |= uint32_t((d[byte] >> (bit & 7)) & 1) << i;
    }
    return v;
  }
  uint32_t peek(int count) {
    const size_t saved = bit;
    uint32_t v = 0;
    for (int i = 0; i < count; ++i, ++bit) {
      const size_t byte = bit >> 3;
      if (byte < n) v |= uint32_t((d[byte] >> (bit & 7)) & 1) << i;
    }
    bit = saved;
    return v;
  }
};

// Backward (Huffman streams, FSE bitstreams): from the last byte's highest
// set bit towards the first byte, most significant bit first; bits before
// the start read as zeros, and ``overflow`` tells when more were taken.
struct BackwardBits {
  const uint8_t* d;
  int64_t left;  // bits not yet read
  BackwardBits(const uint8_t* data, size_t n) : d(data) {
    if (n == 0 || d[n - 1] == 0) corrupt("a bitstream without its end mark");
    left = int64_t(n) * 8 - 8 + highbit(d[n - 1]);
  }
  uint32_t read(int count) {
    uint32_t v = 0;
    for (int i = 0; i < count; ++i) {
      --left;
      const int bit = left >= 0 ? (d[left >> 3] >> (left & 7)) & 1 : 0;
      v = (v << 1) | uint32_t(bit);
    }
    return v;
  }
  uint32_t peek(int count) {
    uint32_t v = 0;
    for (int64_t i = 1; i <= count; ++i) {
      const int64_t at = left - i;
      const int bit = at >= 0 ? (d[at >> 3] >> (at & 7)) & 1 : 0;
      v = (v << 1) | uint32_t(bit);
    }
    return v;
  }
  bool overflow() const { return left < 0; }
};

// ---- FSE ------------------------------------------------------------------------------------

struct FseTable {
  int log = 0;
  std::vector<uint16_t> symbol, base;
  std::vector<uint8_t> bits;

  void build(const std::vector<int>& counts, int accuracy) {
    log = accuracy;
    const size_t size = size_t(1) << accuracy;
    symbol.assign(size, 0);
    base.assign(size, 0);
    bits.assign(size, 0);
    std::vector<uint32_t> next(counts.size());
    size_t high = size - 1;
    for (size_t s = 0; s < counts.size(); ++s)
      if (counts[s] == -1) {
        symbol[high--] = uint16_t(s);
        next[s] = 1;
      } else {
        next[s] = uint32_t(std::max(counts[s], 0));
      }
    size_t pos = 0;
    const size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
    for (size_t s = 0; s < counts.size(); ++s)
      for (int i = 0; i < counts[s]; ++i) {
        symbol[pos] = uint16_t(s);
        do pos = (pos + step) & mask;
        while (pos > high);
      }
    if (pos != 0) corrupt("an FSE table that does not fill");
    for (size_t i = 0; i < size; ++i) {
      const uint32_t state = next[symbol[i]]++;
      const int nb = accuracy - highbit(state);
      bits[i] = uint8_t(nb);
      base[i] = uint16_t((state << nb) - size);
    }
  }
  void rle(int s) {
    log = 0;
    symbol.assign(1, uint16_t(s));
    base.assign(1, 0);
    bits.assign(1, 0);
  }
};

// An FSE table description; returns its length in bytes.
size_t read_fse(const uint8_t* d, size_t n, int max_log, int max_symbol, FseTable& out) {
  ForwardBits br{d, n};
  const int accuracy = int(br.read(4)) + 5;
  if (accuracy > max_log) corrupt("an FSE accuracy above the limit");
  int remaining = (1 << accuracy) + 1, threshold = 1 << accuracy, nb = accuracy + 1;
  std::vector<int> counts;
  while (remaining > 1) {
    if (int(counts.size()) > max_symbol) corrupt("too many FSE symbols");
    const int max = 2 * threshold - 1 - remaining;
    int value;
    const uint32_t low = br.peek(nb - 1);
    if (int(low & uint32_t(threshold - 1)) < max) {
      value = int(low & uint32_t(threshold - 1));
      br.read(nb - 1);
    } else {
      value = int(br.read(nb));
      if (value >= threshold) value -= max;
    }
    const int count = value - 1;
    remaining -= count < 0 ? -count : count;
    counts.push_back(count);
    if (count == 0) {
      while (true) {
        const uint32_t repeat = br.read(2);
        for (uint32_t i = 0; i < repeat; ++i) counts.push_back(0);
        if (repeat != 3) break;
      }
    }
    while (remaining < threshold) {
      --nb;
      threshold >>= 1;
    }
  }
  if (remaining != 1 || int(counts.size()) > max_symbol + 1)
    corrupt("a bad FSE table description");
  out.build(counts, accuracy);
  return (br.bit + 7) >> 3;
}

// ---- Huffman literals -----------------------------------------------------------------------

struct Huffman {
  int max_bits = 0;
  std::vector<uint8_t> symbol, length;  // by the next max_bits bits
  bool valid = false;

  void build(const std::vector<int>& weights) {
    uint32_t total = 0;
    for (int w : weights)
      if (w > 0) total += uint32_t(1) << (w - 1);
    if (total == 0) corrupt("a Huffman tree without weights");
    max_bits = highbit(total) + 1;
    const uint32_t rest = (uint32_t(1) << max_bits) - total;
    if (rest & (rest - 1)) corrupt("a Huffman tree that does not close");
    std::vector<int> w = weights;
    w.push_back(highbit(rest) + 1);
    if (max_bits > 11) corrupt("Huffman codes above 11 bits");
    const size_t size = size_t(1) << max_bits;
    symbol.assign(size, 0);
    length.assign(size, 0);
    size_t pos = 0;
    for (int weight = 1; weight <= max_bits; ++weight)
      for (size_t s = 0; s < w.size(); ++s)
        if (w[s] == weight) {
          const size_t span = size_t(1) << (weight - 1);
          for (size_t i = 0; i < span; ++i) {
            symbol[pos + i] = uint8_t(s);
            length[pos + i] = uint8_t(max_bits + 1 - weight);
          }
          pos += span;
        }
    valid = true;
  }

  void stream(const uint8_t* d, size_t n, uint8_t* out, size_t count) const {
    BackwardBits br(d, n);
    for (size_t i = 0; i < count; ++i) {
      const uint32_t idx = br.peek(max_bits);
      out[i] = symbol[idx];
      br.read(length[idx]);
    }
    if (br.left != 0) corrupt("a Huffman stream of the wrong length");
  }
};

// The tree description; returns its length in bytes.
size_t read_tree(const uint8_t* d, size_t n, Huffman& huf) {
  if (n < 1) corrupt("a truncated Huffman tree");
  const int head = d[0];
  std::vector<int> weights;
  size_t used;
  if (head >= 128) {
    const int count = head - 127;
    used = 1 + size_t((count + 1) / 2);
    if (used > n) corrupt("a truncated Huffman tree");
    for (int i = 0; i < count; ++i) weights.push_back((d[1 + i / 2] >> (i % 2 ? 0 : 4)) & 15);
  } else {
    used = 1 + size_t(head);
    if (used > n) corrupt("a truncated Huffman tree");
    FseTable table;
    const size_t desc = read_fse(d + 1, size_t(head), 6, 255, table);
    if (desc > size_t(head)) corrupt("a truncated Huffman tree");
    BackwardBits br(d + 1 + desc, size_t(head) - desc);
    uint32_t s1 = br.read(table.log), s2 = br.read(table.log);
    while (true) {
      if (weights.size() > 254) corrupt("too many Huffman weights");
      weights.push_back(table.symbol[s1]);
      s1 = table.base[s1] + br.read(table.bits[s1]);
      if (br.overflow()) {
        weights.push_back(table.symbol[s2]);
        break;
      }
      weights.push_back(table.symbol[s2]);
      s2 = table.base[s2] + br.read(table.bits[s2]);
      if (br.overflow()) {
        weights.push_back(table.symbol[s1]);
        break;
      }
    }
  }
  for (int w : weights)
    if (w > 11) corrupt("a Huffman weight above 11");
  huf.build(weights);
  return used;
}

// ---- sequences ------------------------------------------------------------------------------

const int kLlDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                            2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int kMlDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int kOfDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t kLlBase[36] = {0,  1,  2,  3,  4,  5,   6,   7,   8,    9,    10,   11,
                              12, 13, 14, 15, 16, 18,  20,  22,  24,   28,   32,   40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLlBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMlBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12, 13, 14, 15, 16,
                              17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30,
                              31, 32, 33, 34, 35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMlBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

struct FrameState {
  Huffman huf;
  FseTable ll, of, ml;
  bool have_ll = false, have_of = false, have_ml = false;
  uint32_t rep[3] = {1, 4, 8};
};

// One table of the sequences section by its mode; returns the bytes read.
size_t read_table(int mode, const uint8_t* d, size_t n, const int* defaults, int count,
                  int default_log, int max_log, int max_symbol, FseTable& t, bool& have) {
  if (mode == 0) {
    t.build(std::vector<int>(defaults, defaults + count), default_log);
    have = true;
    return 0;
  }
  if (mode == 1) {
    if (n < 1) corrupt("a truncated RLE table");
    if (d[0] > max_symbol) corrupt("a bad RLE symbol");
    t.rle(d[0]);
    have = true;
    return 1;
  }
  if (mode == 2) {
    const size_t used = read_fse(d, n, max_log, max_symbol, t);
    have = true;
    return used;
  }
  if (!have) corrupt("a repeated table before any");
  return 0;
}

// One compressed block appended to ``out``; it may regenerate at most
// ``block_max`` bytes, as libzstd's blockSizeMax (the window, at most 128 KiB).
void compressed_block(const uint8_t* d, size_t n, size_t block_max, FrameState& st,
                      std::vector<uint8_t>& out) {
  if (n < 1) corrupt("an empty compressed block");
  const size_t block_start = out.size();
  // literals
  const int ltype = d[0] & 3, fmt = (d[0] >> 2) & 3;
  size_t regen, csize = 0, head;
  std::vector<uint8_t> lit;
  if (ltype <= 1) {
    if (fmt == 0 || fmt == 2) {
      regen = d[0] >> 3;
      head = 1;
    } else if (fmt == 1) {
      if (n < 2) corrupt("a truncated literals header");
      regen = (d[0] >> 4) | (size_t(d[1]) << 4);
      head = 2;
    } else {
      if (n < 3) corrupt("a truncated literals header");
      regen = (d[0] >> 4) | (size_t(d[1]) << 4) | (size_t(d[2]) << 12);
      head = 3;
    }
    if (ltype == 0) {
      if (head + regen > n) corrupt("truncated raw literals");
      lit.assign(d + head, d + head + regen);
      head += regen;
    } else {
      if (head + 1 > n) corrupt("truncated RLE literals");
      lit.assign(regen, d[head]);
      head += 1;
    }
  } else {
    const int bits = fmt <= 1 ? 10 : (fmt == 2 ? 14 : 18);
    head = fmt <= 1 ? 3 : (fmt == 2 ? 4 : 5);
    if (n < head) corrupt("a truncated literals header");
    uint64_t h = 0;
    for (size_t i = 0; i < head; ++i) h |= uint64_t(d[i]) << (8 * i);
    regen = size_t((h >> 4) & ((uint64_t(1) << bits) - 1));
    csize = size_t((h >> (4 + bits)) & ((uint64_t(1) << bits) - 1));
    const bool four = fmt != 0;
    if (head + csize > n) corrupt("truncated Huffman literals");
    const uint8_t* p = d + head;
    size_t left = csize;
    if (ltype == 2) {
      const size_t tree = read_tree(p, left, st.huf);
      p += tree;
      left -= tree;
    } else if (!st.huf.valid) {
      corrupt("treeless literals before any tree");
    }
    lit.assign(regen, 0);
    if (!four) {
      st.huf.stream(p, left, lit.data(), regen);
    } else {
      if (left < 6) corrupt("a truncated jump table");
      const size_t s1 = le16(p), s2 = le16(p + 2), s3 = le16(p + 4);
      if (6 + s1 + s2 + s3 > left) corrupt("a bad jump table");
      const size_t s4 = left - 6 - s1 - s2 - s3, seg = (regen + 3) / 4;
      if (3 * seg > regen) corrupt("too few literals for four streams");
      const uint8_t* q = p + 6;
      st.huf.stream(q, s1, lit.data(), seg);
      st.huf.stream(q + s1, s2, lit.data() + seg, seg);
      st.huf.stream(q + s1 + s2, s3, lit.data() + 2 * seg, seg);
      st.huf.stream(q + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
    }
    head += csize;
  }
  if (lit.size() > block_max) corrupt("more literals than a block holds");
  // sequences
  size_t pos = head;
  if (pos >= n) corrupt("no sequences section");
  size_t nseq = d[pos];
  if (nseq == 0) {
    ++pos;
  } else if (nseq < 128) {
    ++pos;
  } else if (nseq < 255) {
    if (pos + 2 > n) corrupt("a truncated sequence count");
    nseq = ((nseq - 128) << 8) + d[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > n) corrupt("a truncated sequence count");
    nseq = d[pos + 1] + (size_t(d[pos + 2]) << 8) + 0x7F00;
    pos += 3;
  }
  size_t lit_pos = 0;
  if (nseq > 0) {
    if (pos >= n) corrupt("no compression modes");
    const int modes = d[pos++];
    if (modes & 3) corrupt("reserved bits in the compression modes");
    pos += read_table(modes >> 6, d + pos, n - pos, kLlDefault, 36, 6, 9, 35, st.ll, st.have_ll);
    pos += read_table((modes >> 4) & 3, d + pos, n - pos, kOfDefault, 29, 5, 8, 31, st.of,
                      st.have_of);
    pos += read_table((modes >> 2) & 3, d + pos, n - pos, kMlDefault, 53, 6, 9, 52, st.ml,
                      st.have_ml);
    if (pos > n) corrupt("truncated sequence tables");
    BackwardBits br(d + pos, n - pos);
    uint32_t sll = br.read(st.ll.log), sof = br.read(st.of.log), sml = br.read(st.ml.log);
    for (size_t i = 0; i < nseq; ++i) {
      const int ofc = st.of.symbol[sof], llc = st.ll.symbol[sll], mlc = st.ml.symbol[sml];
      if (ofc > 31 || llc > 35 || mlc > 52) corrupt("a bad sequence code");
      const uint64_t ofv = (uint64_t(1) << ofc) + br.read(ofc);
      const size_t ml = kMlBase[mlc] + br.read(kMlBits[mlc]);
      const size_t ll = kLlBase[llc] + br.read(kLlBits[llc]);
      uint64_t offset;
      if (ofv > 3) {
        offset = ofv - 3;
        st.rep[2] = st.rep[1];
        st.rep[1] = st.rep[0];
        st.rep[0] = uint32_t(offset);
      } else {
        const int idx = int(ofv) - 1 + (ll == 0 ? 1 : 0);
        if (idx == 0) {
          offset = st.rep[0];
        } else {
          offset = idx == 3 ? uint64_t(st.rep[0]) - 1 : st.rep[idx];
          if (idx >= 2) st.rep[2] = st.rep[1];
          st.rep[1] = st.rep[0];
          st.rep[0] = uint32_t(offset);
        }
      }
      if (i + 1 < nseq) {
        sll = st.ll.base[sll] + br.read(st.ll.bits[sll]);
        sml = st.ml.base[sml] + br.read(st.ml.bits[sml]);
        sof = st.of.base[sof] + br.read(st.of.bits[sof]);
      }
      if (lit_pos + ll > lit.size()) corrupt("a sequence past the literals");
      if (out.size() - block_start + ll + ml > block_max) corrupt("a block above its maximum");
      out.insert(out.end(), lit.begin() + lit_pos, lit.begin() + lit_pos + ll);
      lit_pos += ll;
      if (offset == 0 || offset > out.size()) corrupt("an offset before the frame");
      const size_t from = out.size() - size_t(offset);
      for (size_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
    }
    if (br.left != 0) corrupt("a sequence bitstream of the wrong length");
  }
  if (out.size() - block_start + lit.size() - lit_pos > block_max)
    corrupt("a block above its maximum");
  out.insert(out.end(), lit.begin() + lit_pos, lit.end());
}

}  // namespace

// The first frame of one strip or tile; the first ``want`` bytes of its
// content (an error when there are fewer, as libtiff reports).
std::vector<uint8_t> decode_zstd(const uint8_t* d, size_t n, size_t want) {
  std::vector<uint8_t> out;
  size_t pos = 0;
  if (n >= 4 && (le32(d) & 0xFFFFFFF0u) != 0x184D2A50u) {
    if (le32(d) != 0xFD2FB528u) corrupt("no frame magic");
    pos += 4;
    if (pos >= n) corrupt("a truncated frame header");
    const int desc = d[pos++];
    const int fcs_flag = desc >> 6, single = (desc >> 5) & 1, checksum = (desc >> 2) & 1;
    const int dict_flag = desc & 3;
    if (desc & 8) corrupt("a reserved frame header bit");
    uint64_t window = 0;
    if (!single) {
      if (pos >= n) corrupt("a truncated frame header");
      window = uint64_t(1) << (10 + (d[pos] >> 3));
      window += (window >> 3) * (d[pos] & 7);
      ++pos;
    }
    static const int kDictBytes[4] = {0, 1, 2, 4};
    uint32_t dict = 0;
    for (int i = 0; i < kDictBytes[dict_flag]; ++i)
      if (pos + i < n) dict |= uint32_t(d[pos + i]) << (8 * i);
    if (dict) throw Error("TIFF: a ZSTD frame with a dictionary is not supported");
    pos += size_t(kDictBytes[dict_flag]);
    static const int kFcsBytes[4] = {0, 2, 4, 8};
    const int fcs_bytes = fcs_flag == 0 && single ? 1 : kFcsBytes[fcs_flag];
    if (pos + size_t(fcs_bytes) > n) corrupt("a truncated frame header");
    uint64_t content = 0;  // the content size, when the frame gives it
    for (int i = 0; i < fcs_bytes; ++i) content |= uint64_t(d[pos + i]) << (8 * i);
    if (fcs_bytes == 2) content += 256;
    pos += size_t(fcs_bytes);
    // libzstd's limits: a window of at most 128 MiB + 1 (its default), the
    // content size in a single segment; a block regenerates at most the
    // window and at most 128 KiB; the frame exactly its content size
    if (single) window = content;
    if (window > (uint64_t(1) << 27) + 1) corrupt("a window above 128 MiB");
    const size_t block_max = size_t(std::min<uint64_t>(window, uint64_t(1) << 17));
    FrameState st;
    const size_t start = out.size();
    bool last = false;
    while (!last) {
      if (pos + 3 > n) corrupt("a truncated block header");
      const uint32_t bh = uint32_t(d[pos]) | (uint32_t(d[pos + 1]) << 8) |
                          (uint32_t(d[pos + 2]) << 16);
      pos += 3;
      last = bh & 1;
      const int type = (bh >> 1) & 3;
      const size_t size = bh >> 3;
      if (type == 3) corrupt("a reserved block type");
      if (size > block_max) corrupt("a block above its maximum");
      if (type == 1) {
        if (pos + 1 > n) corrupt("a truncated RLE block");
        out.insert(out.end(), size, d[pos]);
        pos += 1;
      } else {
        if (size > n - pos) corrupt("a truncated block");
        if (type == 0) out.insert(out.end(), d + pos, d + pos + size);
        else compressed_block(d + pos, size, block_max, st, out);
        pos += size;
      }
      if (out.size() > want + (size_t(1) << 17) * 2) corrupt("more data than the strip holds");
      if (fcs_bytes && out.size() - start > content) corrupt("more data than the content size");
    }
    if (fcs_bytes && out.size() - start != content) corrupt("less data than the content size");
    if (checksum) {
      if (pos + 4 > n) corrupt("a truncated checksum");
      const uint32_t sum = uint32_t(xxh64(out.data() + start, out.size() - start));
      if (sum != le32(d + pos)) throw Error("TIFF: ZSTD checksum mismatch");
      pos += 4;
    }
  }
  if (out.size() < want) throw Error("TIFF: not enough ZSTD data for the strip or tile");
  out.resize(want);
  return out;
}

}  // namespace pslx
