// CCITT bilevel coding inside TIFF, as libtiff 4.7's tif_fax3.c decodes it
// for PIL: Modified Huffman RLE (compression 2: 1-D rows, each starting on
// a byte), Group 3 (compression 3: an EOL code, any number of fill bits
// before it, ahead of every row; 1-D rows, or with T4Options bit 0 a tag
// bit per row choosing 1-D or 2-D coding) and Group 4 (compression 4: 2-D
// rows against the previous row, the first against an all-white row).
// Runs alternate white / black from white; a decoded pixel is 0 in a white
// run and 1 in a black run, as libtiff fills its rows, whatever the
// photometric interpretation (PIL's unpacker then maps them).  Uncompressed
// mode (T4Options bit 1, the 2-D extension code) and a premature end of the
// data are refused.

#include <cstdint>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

// T.4 code words: terminating codes for runs 0-63, then make-up codes for
// 64-1728 in steps of 64; the extended make-up codes 1792-2560 are shared.
const char* const kWhite[] = {
    "00110101", "000111", "0111", "1000", "1011", "1100", "1110", "1111", "10011", "10100",
    "00111", "01000", "001000", "000011", "110100", "110101", "101010", "101011", "0100111",
    "0001100", "0001000", "0010111", "0000011", "0000100", "0101000", "0101011", "0010011",
    "0100100", "0011000", "00000010", "00000011", "00011010", "00011011", "00010010",
    "00010011", "00010100", "00010101", "00010110", "00010111", "00101000", "00101001",
    "00101010", "00101011", "00101100", "00101101", "00000100", "00000101", "00001010",
    "00001011", "01010010", "01010011", "01010100", "01010101", "00100100", "00100101",
    "01011000", "01011001", "01011010", "01011011", "01001010", "01001011", "00110010",
    "00110011", "00110100",
    "11011", "10010", "010111", "0110111", "00110110", "00110111", "01100100", "01100101",
    "01101000", "01100111", "011001100", "011001101", "011010010", "011010011", "011010100",
    "011010101", "011010110", "011010111", "011011000", "011011001", "011011010",
    "011011011", "010011000", "010011001", "010011010", "011000", "010011011"};
const char* const kBlack[] = {
    "0000110111", "010", "11", "10", "011", "0011", "0010", "00011", "000101", "000100",
    "0000100", "0000101", "0000111", "00000100", "00000111", "000011000", "0000010111",
    "0000011000", "0000001000", "00001100111", "00001101000", "00001101100", "00000110111",
    "00000101000", "00000010111", "00000011000", "000011001010", "000011001011",
    "000011001100", "000011001101", "000001101000", "000001101001", "000001101010",
    "000001101011", "000011010010", "000011010011", "000011010100", "000011010101",
    "000011010110", "000011010111", "000001101100", "000001101101", "000011011010",
    "000011011011", "000001010100", "000001010101", "000001010110", "000001010111",
    "000001100100", "000001100101", "000001010010", "000001010011", "000000100100",
    "000000110111", "000000111000", "000000100111", "000000101000", "000001011000",
    "000001011001", "000000101011", "000000101100", "000001011010", "000001100110",
    "000001100111",
    "0000001111", "000011001000", "000011001001", "000001011011", "000000110011",
    "000000110100", "000000110101", "0000001101100", "0000001101101", "0000001001010",
    "0000001001011", "0000001001100", "0000001001101", "0000001110010", "0000001110011",
    "0000001110100", "0000001110101", "0000001110110", "0000001110111", "0000001010010",
    "0000001010011", "0000001010100", "0000001010101", "0000001011010", "0000001011011",
    "0000001100100", "0000001100101"};
const char* const kExtended[] = {"00000001000", "00000001100", "00000001101", "000000010010",
                                 "000000010011", "000000010100", "000000010101",
                                 "000000010110", "000000010111", "000000011100",
                                 "000000011101", "000000011110", "000000011111"};

constexpr int kEol = -2;

// code (with a leading 1 bit marking its length) -> run length, per colour
struct RunTable {
  std::vector<int> by_code;  // index (1 << len) | code, len <= 13
  explicit RunTable(const char* const* codes) : by_code(1 << 14, -1) {
    for (int i = 0; i < 64 + 27; ++i) add(codes[i], i < 64 ? i : (i - 63) * 64);
    for (int i = 0; i < 13; ++i) add(kExtended[i], 1792 + 64 * i);
    add("000000000001", kEol);
  }
  void add(const char* s, int run) {
    int key = 1;
    for (const char* p = s; *p; ++p) key = (key << 1) | (*p - '0');
    by_code[size_t(key)] = run;
  }
};

const RunTable& white_table() {
  static const RunTable t(kWhite);
  return t;
}
const RunTable& black_table() {
  static const RunTable t(kBlack);
  return t;
}

struct FaxBits {
  const uint8_t* d;
  size_t n, pos = 0;  // pos in bits
  FaxBits(const uint8_t* data, size_t size) : d(data), n(size * 8) {}
  int peek() const {
    if (pos >= n) throw Error("TIFF: CCITT data ends early");
    return (d[pos >> 3] >> (7 - (pos & 7))) & 1;
  }
  int bit() {
    int b = peek();
    ++pos;
    return b;
  }
  int run(const RunTable& t) {  // one code word
    int key = 1;
    for (int len = 1; len <= 13; ++len) {
      key = (key << 1) | bit();
      int v = t.by_code[size_t(key)];
      if (v != -1) return v;
    }
    throw Error("TIFF: bad CCITT run code");
  }
  int full_run(const RunTable& t) {  // make-up codes then a terminating code
    int total = 0;
    for (;;) {
      int v = run(t);
      if (v == kEol) throw Error("TIFF: unexpected CCITT EOL");
      total += v;
      if (v < 64) return total;
    }
  }
  void sync_eol() {  // tif_fax3.h SYNC_EOL: skip to past the next EOL
    for (;;) {
      if (pos + 11 > n) throw Error("TIFF: CCITT data ends early");
      bool zeros = true;
      for (size_t i = 0; i < 11 && zeros; ++i)
        zeros = !((d[(pos + i) >> 3] >> (7 - ((pos + i) & 7))) & 1);
      if (zeros) break;
      ++pos;
    }
    while (bit() == 0) {
    }
  }
};

// One row coded 1-D -> its changing elements (positions where the colour
// flips), ending at width.
void row_1d(FaxBits& br, int width, std::vector<int>& changes) {
  changes.clear();
  int a0 = 0;
  bool white = true;
  while (a0 < width) {
    a0 += br.full_run(white ? white_table() : black_table());
    changes.push_back(std::min(a0, width));
    white = !white;
  }
}

// One row coded 2-D against ``ref``'s changing elements.
void row_2d(FaxBits& br, int width, const std::vector<int>& ref, std::vector<int>& changes) {
  changes.clear();
  int a0 = -1;
  bool white = true;
  size_t ri = 0;
  auto b1_index = [&]() {  // first change on ref right of a0 of the opposite colour
    size_t i = ri;
    while (i < ref.size() && (ref[i] <= a0 || (i & 1) != (white ? 0u : 1u))) ++i;
    return i;
  };
  auto at = [&](size_t i) { return i < ref.size() ? ref[i] : width; };
  while (a0 < width) {
    size_t i1 = b1_index();
    ri = i1 > 0 ? i1 - 1 : 0;
    int b1 = at(i1), b2 = at(i1 + 1);
    int mode;  // 0 pass, 1 horizontal, 2 + (d + 3) vertical
    if (br.bit()) {
      mode = 5;  // V0
    } else if (br.bit()) {
      mode = br.bit() ? 6 : 4;  // VR1 / VL1
    } else if (br.bit()) {
      mode = 1;  // horizontal
    } else if (br.bit()) {
      mode = 0;  // pass
    } else if (br.bit()) {
      mode = br.bit() ? 7 : 3;  // VR2 / VL2
    } else if (br.bit()) {
      mode = br.bit() ? 8 : 2;  // VR3 / VL3
    } else {
      throw Error("TIFF: CCITT 2-D extension (uncompressed mode) is not supported");
    }
    if (mode == 0) {
      a0 = b2;
    } else if (mode == 1) {
      int start = a0 < 0 ? 0 : a0;
      int r1 = br.full_run(white ? white_table() : black_table());
      int r2 = br.full_run(white ? black_table() : white_table());
      int a1 = std::min(start + r1, width), a2 = std::min(a1 + r2, width);
      changes.push_back(a1);
      changes.push_back(a2);
      a0 = a2;
    } else {
      int a1 = b1 + (mode - 5);
      if (a1 < 0 || a1 > width || a1 < a0) throw Error("TIFF: bad CCITT vertical code");
      changes.push_back(a1);
      a0 = a1;
      white = !white;
    }
  }
}

}  // namespace

std::vector<uint8_t> decode_ccitt(const uint8_t* p, size_t n, int width, int rows,
                                  int compression, uint32_t t4_options) {
  if (compression == 3 && (t4_options & 2))
    throw Error("TIFF: CCITT uncompressed mode is not supported");
  FaxBits br(p, n);
  std::vector<uint8_t> out(size_t(width) * rows, 0);
  std::vector<int> ref{width, width}, cur;
  for (int r = 0; r < rows; ++r) {
    if (compression == 2) {
      row_1d(br, width, cur);
      br.pos = (br.pos + 7) & ~size_t(7);
    } else if (compression == 3) {
      br.sync_eol();
      bool one_d = (t4_options & 1) ? br.bit() == 1 : true;
      if (one_d) row_1d(br, width, cur);
      else row_2d(br, width, ref, cur);
    } else {
      row_2d(br, width, ref, cur);
    }
    uint8_t* o = &out[size_t(r) * width];
    int x = 0, colour = 0;
    for (int c : cur) {
      for (; x < c && x < width; ++x) o[x] = uint8_t(colour);
      colour ^= 1;
    }
    ref = cur;
    ref.push_back(width);
    ref.push_back(width);
  }
  return out;
}

}  // namespace pslx
