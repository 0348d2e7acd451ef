// JPEG 2000 codestreams and JP2 files, decoded bit for bit as PIL 12 reads
// them through OpenJPEG 2.5 (opj_read_tile_header / opj_decode_tile_data:
// the components as coded, no palette or channel-definition applied).
//
// The codestream's markers (SIZ, COD / COC, QCD / QCC, RGN, POC, PPM /
// PPT, tile-parts; TLM, PLM, PLT, CRG and COM skipped), tier-2 (tag trees,
// packet headers in the data or packed, SOP and EPH markers, the five
// progression orders and POC, precincts, layers), tier-1 (the MQ decoder
// and the three passes of EBCOT, code-block style 0, the ROI max-shift),
// the dequantisation, the 5/3 and 9/7 synthesis, the RCT / ICT, the DC
// shift and the clipping follow OpenJPEG's arithmetic where the standard
// leaves room: coefficients are held doubled and reconstructed at the
// middle of the last decoded interval, the reversible path halves them
// with C's truncating division, the irreversible one multiplies by half
// the band's step size in float; the 9/7 synthesis scales by K and
// 1.625732422 and lifts in OpenJPEG's order; the irreversible result is
// rounded with lrintf.  PIL's mode comes from the SIZ (codestream) or the
// ihdr / colr / pclr boxes (JP2), and its unpackers (Jpeg2KDecode.c) shift
// a precision other than 8 (16 for I;16), offset a signed one, truncate to
// the sample and convert sYCC with PIL's integer YCbCr tables; a JP2
// palette gives mode P (PIL's palette: each new colour once), a CMYK one
// mode CMYK; subsampled components are read at PIL's indices, and a
// colour space that is not enumerated (an ICC profile, a codestream) is
// guessed as PIL guesses it (sYCC for subsampled chroma).  Refused, naming
// the feature: code-block styles other than 0, RGN styles other than
// max-shift, HTJ2K, subsampled components outside RGB / RGBA / CMYK,
// precisions above 31 bits, palettes with alpha or of other than 3
// components and e-sYCC.
// Built with floating-point contraction off (io/native.py), as the plain
// twin io/images_plain_j2k.py computes in numpy float32.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <set>
#include <string>
#include <tuple>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

[[noreturn]] void refuse(const std::string& feature) {
  throw Error("JPEG 2000: " + feature + " is not supported");
}
[[noreturn]] void bad(const std::string& what) { throw Error("JPEG 2000: " + what); }

int64_t ceildiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceilpow2(int64_t a, int e) { return -((-a) >> e); }

// ---- the MQ decoder (T.800 Annex C, OpenJPEG's mqc.c) ----------------------------------

struct QeEntry {
  uint32_t qe;
  uint8_t nmps, nlps, sw;
};
const QeEntry kQe[47] = {
    {0x5601, 1, 1, 1},   {0x3401, 2, 6, 0},   {0x1801, 3, 9, 0},   {0x0AC1, 4, 12, 0},
    {0x0521, 5, 29, 0},  {0x0221, 38, 33, 0}, {0x5601, 7, 6, 1},   {0x5401, 8, 14, 0},
    {0x4801, 9, 14, 0},  {0x3801, 10, 14, 0}, {0x3001, 11, 17, 0}, {0x2401, 12, 18, 0},
    {0x1C01, 13, 20, 0}, {0x1601, 29, 21, 0}, {0x5601, 15, 14, 1}, {0x5401, 16, 14, 0},
    {0x5101, 17, 15, 0}, {0x4801, 18, 16, 0}, {0x3801, 19, 17, 0}, {0x3401, 20, 18, 0},
    {0x3001, 21, 19, 0}, {0x2801, 22, 19, 0}, {0x2401, 23, 20, 0}, {0x2201, 24, 21, 0},
    {0x1C01, 25, 22, 0}, {0x1801, 26, 23, 0}, {0x1601, 27, 24, 0}, {0x1401, 28, 25, 0},
    {0x1201, 29, 26, 0}, {0x1101, 30, 27, 0}, {0x0AC1, 31, 28, 0}, {0x09C1, 32, 29, 0},
    {0x08A1, 33, 30, 0}, {0x0521, 34, 31, 0}, {0x0441, 35, 32, 0}, {0x02A1, 36, 33, 0},
    {0x0221, 37, 34, 0}, {0x0141, 38, 35, 0}, {0x0111, 39, 36, 0}, {0x0085, 40, 37, 0},
    {0x0049, 41, 38, 0}, {0x0025, 42, 39, 0}, {0x0015, 43, 40, 0}, {0x0009, 44, 41, 0},
    {0x0005, 45, 42, 0}, {0x0001, 45, 43, 0}, {0x5601, 46, 46, 0}};

// contexts: 0-8 zero coding, 9-13 sign, 14-16 refinement, 17 run length, 18 uniform
constexpr int kCtxRl = 17, kCtxUni = 18;

struct MQ {
  std::vector<uint8_t> d;  // the segment, two 0xFF appended (opj_mqc_init_dec)
  size_t bp = 0;
  uint32_t c = 0, a = 0x8000;
  int ct = 0;
  uint8_t index[19] = {0}, mps[19] = {0};

  explicit MQ(const std::vector<uint8_t>& data) : d(data) {
    d.push_back(0xFF);
    d.push_back(0xFF);
    index[kCtxUni] = 46;
    index[kCtxRl] = 3;
    index[0] = 4;
    c = data.empty() ? 0xFFu << 16 : uint32_t(d[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void bytein() {
    if (d[bp] == 0xFF) {
      if (d[bp + 1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(d[bp]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(d[bp]) << 8;
      ct = 8;
    }
  }
  int decode(int cx) {
    const QeEntry& e = kQe[index[cx]];
    int out;
    a -= e.qe;
    if ((c >> 16) < e.qe) {
      if (a < e.qe) {
        out = mps[cx];
        index[cx] = e.nmps;
      } else {
        out = 1 - mps[cx];
        if (e.sw) mps[cx] = uint8_t(out);
        index[cx] = e.nlps;
      }
      a = e.qe;
    } else {
      c -= e.qe << 16;
      if (a & 0x8000) return mps[cx];
      if (a < e.qe) {
        out = 1 - mps[cx];
        if (e.sw) mps[cx] = uint8_t(out);
        index[cx] = e.nlps;
      } else {
        out = mps[cx];
        index[cx] = e.nmps;
      }
    }
    do {  // RENORMD
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (!(a & 0x8000));
    return out;
  }
};

// ---- tier-1 (EBCOT, T.800 Annex D) ------------------------------------------------------

// A coefficient's flags: which of its eight neighbours are significant,
// the signs of the four direct ones that are, and its own state.
enum : uint16_t {
  NB_N = 1, NB_S = 2, NB_W = 4, NB_E = 8, NB_NW = 16, NB_NE = 32, NB_SW = 64, NB_SE = 128,
  NB_ANY = 255, SIG = 1 << 8, VISITED = 1 << 9, REFINED = 1 << 10,
  NEG_N = 1 << 11, NEG_S = 1 << 12, NEG_W = 1 << 13, NEG_E = 1 << 14
};

struct T1Tables {
  uint8_t zc[4][256];  // zero-coding context by orientation and neighbour bits
  uint8_t sc[256];     // sign context by (N, S, W, E significant) | (their signs) << 4
  uint8_t sc_xor[256]; // the bit the decoded sign is XORed with
  T1Tables() {
    for (int o = 0; o < 4; ++o)
      for (int m = 0; m < 256; ++m) {
        const int h = !!(m & NB_W) + !!(m & NB_E), v = !!(m & NB_N) + !!(m & NB_S);
        const int d = !!(m & NB_NW) + !!(m & NB_NE) + !!(m & NB_SW) + !!(m & NB_SE);
        const int hh = o == 1 ? v : h, vv = o == 1 ? h : v;  // HL swaps h and v
        int n;
        if (o == 3) {
          const int hv = hh + vv;
          if (d >= 3) n = 8;
          else if (d == 2) n = hv >= 1 ? 7 : 6;
          else if (d == 1) n = hv >= 2 ? 5 : (hv == 1 ? 4 : 3);
          else n = hv >= 2 ? 2 : hv;
        } else if (hh == 2) {
          n = 8;
        } else if (hh == 1) {
          n = vv >= 1 ? 7 : (d >= 1 ? 6 : 5);
        } else if (vv == 2) {
          n = 4;
        } else if (vv == 1) {
          n = 3;
        } else {
          n = d >= 2 ? 2 : d;
        }
        zc[o][m] = uint8_t(n);
      }
    // sign context and XOR bit by clipped (H, V) contributions + 1
    static const int kSc[3][3] = {{13, 12, 11}, {10, 9, 10}, {11, 12, 13}};
    static const int kXor[3][3] = {{1, 1, 1}, {1, 0, 0}, {0, 0, 0}};
    for (int m = 0; m < 256; ++m) {
      auto contrib = [&](int sig_bit, int neg_bit) {
        return (m & sig_bit) ? ((m & (neg_bit << 4)) ? -1 : 1) : 0;
      };
      const int hc = std::clamp(contrib(NB_W, NB_W) + contrib(NB_E, NB_E), -1, 1) + 1;
      const int vc = std::clamp(contrib(NB_N, NB_N) + contrib(NB_S, NB_S), -1, 1) + 1;
      sc[m] = uint8_t(kSc[hc][vc]);
      sc_xor[m] = uint8_t(kXor[hc][vc]);
    }
  }
};
const T1Tables kT1;

// A code-block's state, reused from block to block.
struct T1Work {
  std::vector<uint16_t> flags;
  std::vector<int32_t> val;
};

// One code-block's coefficients, doubled as OpenJPEG holds them, row-major.
void t1_decode(const std::vector<uint8_t>& data, int passes, int numbps, int orient, int w,
               int h, int32_t* out, T1Work& work) {
  std::fill(out, out + size_t(w) * h, 0);
  if (passes == 0) return;
  const size_t stride = size_t(w) + 2;
  const size_t size = stride * (size_t(h) + 2);
  work.flags.assign(size, 0);
  work.val.assign(size, 0);
  uint16_t* f = work.flags.data();
  int32_t* val = work.val.data();
  MQ mq(data);
  const uint8_t* zc = kT1.zc[orient];
  // significance of coefficient i with sign s: its flags and its neighbours'
  auto set_sig = [&](size_t i, int s, int32_t oph) {
    f[i] |= SIG;
    val[i] = s ? -oph : oph;
    const uint16_t neg = s ? 0xFFFF : 0;
    f[i - stride] |= NB_S | (NEG_S & neg);
    f[i + stride] |= NB_N | (NEG_N & neg);
    f[i - 1] |= NB_E | (NEG_E & neg);
    f[i + 1] |= NB_W | (NEG_W & neg);
    f[i - stride - 1] |= NB_SE;
    f[i - stride + 1] |= NB_SW;
    f[i + stride - 1] |= NB_NE;
    f[i + stride + 1] |= NB_NW;
  };
  auto sign_decode = [&](size_t i, int32_t oph) {
    const int m = (f[i] & 15) | ((f[i] >> 7) & 0xF0);
    set_sig(i, mq.decode(kT1.sc[m]) ^ kT1.sc_xor[m], oph);
  };
  int bpno = numbps, kind = 2;
  for (int p = 0; p < passes; ++p) {
    const int32_t one = bpno >= 0 ? int32_t(1) << bpno : 0, half = one >> 1, oph = one | half;
    for (int k = 0; k < h; k += 4) {
      const int kend = std::min(k + 4, h);
      for (int x = 0; x < w; ++x) {
        const size_t base = stride * size_t(k + 1) + size_t(x) + 1;
        if (kind == 0) {  // significance propagation
          for (int y = k; y < kend; ++y) {
            const size_t i = base + stride * size_t(y - k);
            if (!(f[i] & SIG) && (f[i] & NB_ANY)) {
              if (mq.decode(zc[f[i] & NB_ANY])) sign_decode(i, oph);
              f[i] |= VISITED;
            }
          }
        } else if (kind == 1) {  // magnitude refinement
          for (int y = k; y < kend; ++y) {
            const size_t i = base + stride * size_t(y - k);
            if ((f[i] & (SIG | VISITED)) == SIG) {
              const int ctx = (f[i] & REFINED) ? 16 : ((f[i] & NB_ANY) ? 15 : 14);
              const int bit = mq.decode(ctx);
              val[i] += (bit ^ (val[i] < 0)) ? half : -half;
              f[i] |= REFINED;
            }
          }
        } else {  // cleanup
          int start = k;
          bool run = k + 4 <= h;
          for (int r = 0; run && r < 4; ++r)
            run = !(f[base + stride * size_t(r)] & (NB_ANY | SIG | VISITED));
          bool skip = false;
          if (run) {
            if (!mq.decode(kCtxRl)) {
              skip = true;
            } else {
              int r = mq.decode(kCtxUni) << 1;
              r |= mq.decode(kCtxUni);
              sign_decode(base + stride * size_t(r), oph);
              start = k + r + 1;
            }
          }
          if (!skip) {
            for (int y = start; y < kend; ++y) {
              const size_t i = base + stride * size_t(y - k);
              if (!(f[i] & (SIG | VISITED)) && mq.decode(zc[f[i] & NB_ANY])) sign_decode(i, oph);
            }
          }
          for (int y = k; y < kend; ++y) f[base + stride * size_t(y - k)] &= uint16_t(~VISITED);
        }
      }
    }
    if (++kind == 3) {
      kind = 0;
      --bpno;
    }
  }
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) out[size_t(y) * w + x] = val[stride * size_t(y + 1) + x + 1];
}

// ---- tier-2 (T.800 Annex B) -------------------------------------------------------------

struct Bits {  // opj_bio: a byte after 0xFF gives seven bits
  const uint8_t* d;
  size_t pos, end;
  uint32_t buf = 0;
  int ct = 0;
  Bits(const uint8_t* data, size_t p, size_t e) : d(data), pos(p), end(e) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (pos < end) buf |= d[pos++];
  }
  int bit() {
    if (ct == 0) bytein();
    --ct;
    return int((buf >> ct) & 1);
  }
  uint32_t bits(int n) {
    uint32_t v = 0;
    for (int i = 0; i < n; ++i) v = (v << 1) | uint32_t(bit());
    return v;
  }
  size_t align() {  // opj_bio_inalign
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
    return pos;
  }
};

struct TagTree {
  std::vector<int> parent, value, low;
  TagTree(int w, int h) {
    std::vector<std::pair<int, int>> levels;
    int lw = w, lh = h;
    while (true) {
      levels.push_back({lw, lh});
      if (int64_t(lw) * lh <= 1) break;
      lw = (lw + 1) / 2;
      lh = (lh + 1) / 2;
    }
    std::vector<int> starts{0};
    for (auto& l : levels) starts.push_back(starts.back() + l.first * l.second);
    parent.assign(starts.back(), -1);
    for (size_t li = 0; li + 1 < levels.size(); ++li) {
      const int pw = levels[li + 1].first;
      for (int y = 0; y < levels[li].second; ++y)
        for (int x = 0; x < levels[li].first; ++x)
          parent[starts[li] + y * levels[li].first + x] = starts[li + 1] + (y >> 1) * pw + (x >> 1);
    }
    value.assign(starts.back(), 999);
    low.assign(starts.back(), 0);
  }
  int decode(Bits& bits, int leaf, int threshold) {
    int stack[64], top = 0, node = leaf;
    while (parent[node] >= 0) {
      stack[top++] = node;
      node = parent[node];
    }
    int lo = 0;
    while (true) {
      if (lo > low[node]) low[node] = lo;
      else lo = low[node];
      while (lo < threshold && lo < value[node]) {
        if (bits.bit()) value[node] = lo;
        else ++lo;
      }
      low[node] = lo;
      if (top == 0) break;
      node = stack[--top];
    }
    return value[node] < threshold ? 1 : 0;
  }
};

struct Block {
  int64_t x0, y0, x1, y1;
  int numbps = 0, lenbits = 3, passes = 0;
  bool included = false;
  std::vector<uint8_t> data;
};

struct Precinct {
  int cw = 0, ch = 0;
  std::vector<Block> blocks;
  TagTree incl{0, 0}, imsb{0, 0};
};

struct Band {
  int orient;
  int64_t x0, y0, x1, y1;
  int numbps;
  float stepsize;
  std::vector<Precinct> precincts;
  bool empty() const { return x0 >= x1 || y0 >= y1; }
};

struct Res {
  int64_t x0, y0, x1, y1, px0, py0;
  int pdx, pdy, pw, ph;
  std::vector<Band> bands;
};

struct Style {
  int levels = 5, xcb = 6, ycb = 6, cblksty = 0, qmfbid = 1;
  bool has_precincts = false;
  std::vector<std::pair<int, int>> precincts;
  int qntsty = 0, guard = 2;
  std::vector<std::pair<int, int>> steps;  // (exponent, mantissa)
  int roishift = 0;
};

struct Segment {
  const uint8_t* p;
  size_t n;
};

struct Header {
  const uint8_t* cod = nullptr;
  size_t cod_n = 0;
  const uint8_t* qcd = nullptr;
  size_t qcd_n = 0;
  std::vector<std::pair<int, Segment>> coc, qcc, ppm, ppt;  // PPM / PPT: (Z index, bytes)
  std::vector<std::pair<int, int>> rgn;                     // (component, max-shift)
  std::vector<Segment> poc;
  bool seen = false;
};

// PPM / PPT segments in the order of their Z index, concatenated.
std::vector<uint8_t> packed_stream(std::vector<std::pair<int, Segment>> segs) {
  std::stable_sort(segs.begin(), segs.end(),
                   [](const auto& a, const auto& b) { return a.first < b.first; });
  std::vector<uint8_t> out;
  for (auto& e : segs) out.insert(out.end(), e.second.p, e.second.p + e.second.n);
  return out;
}

struct Packet {
  int layer, res, comp, prec;
};

class Codestream {
 public:
  int64_t xsiz, ysiz, xosiz, yosiz, xtsiz, ytsiz, xtosiz, ytosiz;
  int ncomp;
  std::vector<int> prec, sgnd, dx, dy;  // per component; dx, dy: XRsiz, YRsiz
  int64_t tiles_x, tiles_y;

  explicit Codestream(const uint8_t* cs, size_t n) : cs_(cs), n_(n) {
    if (n < 4 || be16(cs) != 0xFF4F || be16(cs + 2) != 0xFF51)
      bad("no SOC and SIZ at the codestream's start");
    size_t pos = 4;
    if (pos + 2 > n) bad("truncated SIZ");
    const size_t lsiz = be16(cs + pos);
    if (lsiz < 41 || pos + lsiz > n) bad("truncated SIZ");
    const uint8_t* siz = cs + pos;
    const uint32_t rsiz = be16(siz + 2);
    xsiz = be32(siz + 4);
    ysiz = be32(siz + 8);
    xosiz = be32(siz + 12);
    yosiz = be32(siz + 16);
    xtsiz = be32(siz + 20);
    ytsiz = be32(siz + 24);
    xtosiz = be32(siz + 28);
    ytosiz = be32(siz + 32);
    ncomp = int(be16(siz + 36));
    if (rsiz & 0x4000) refuse("HTJ2K (Part 15)");
    if (ncomp < 1 || ncomp > 4 || lsiz < size_t(38 + 3 * ncomp))
      bad(std::to_string(ncomp) + " components");
    for (int c = 0; c < ncomp; ++c) {
      const uint8_t* s = siz + 38 + 3 * c;
      if (!s[1] || !s[2]) bad("bad component subsampling");
      dx.push_back(s[1]);
      dy.push_back(s[2]);
      prec.push_back((s[0] & 0x7F) + 1);
      sgnd.push_back(s[0] >> 7);
    }
    for (int p : prec)
      if (p > 31) refuse("a precision above 31 bits");
    if (xsiz <= xosiz || ysiz <= yosiz || !xtsiz || !ytsiz || xtosiz > xosiz ||
        ytosiz > yosiz || xtosiz + xtsiz <= xosiz || ytosiz + ytsiz <= yosiz)
      bad("bad image or tile geometry");
    if (too_many_pixels(uint64_t(xsiz - xosiz), uint64_t(ysiz - yosiz))) bad("bad image size");
    tiles_x = ceildiv(xsiz - xtosiz, xtsiz);
    tiles_y = ceildiv(ysiz - ytosiz, ytsiz);
    if (tiles_x > 65535 / tiles_y)  // OpenJPEG's limit (opj_j2k_read_siz); Isot has 16 bits
      bad("a tile size giving " + std::to_string(tiles_x) + " x " + std::to_string(tiles_y) +
          " tiles, above 65535");
    pos += lsiz;
    pos = header(pos, false, main_);
    tile_head_.resize(size_t(tiles_x * tiles_y));
    tile_data_.resize(size_t(tiles_x * tiles_y));
    packed_.resize(size_t(tiles_x * tiles_y));
    has_packed_.assign(size_t(tiles_x * tiles_y), false);
    const std::vector<uint8_t> ppm = packed_stream(main_.ppm);
    size_t ppm_pos = 0;
    std::vector<std::vector<std::pair<int, Segment>>> ppt(size_t(tiles_x * tiles_y));
    while (pos + 2 <= n) {
      const uint32_t marker = be16(cs + pos);
      if (marker == 0xFFD9) break;
      if (marker != 0xFF90) bad("a marker where SOT belongs");
      if (pos + 12 > n) bad("truncated SOT");
      const size_t start = pos;
      const uint32_t isot = be16(cs + pos + 4), psot = be32(cs + pos + 6);
      if (isot >= tiles_x * tiles_y) bad("bad tile index");
      Header head;
      const size_t body = header(pos + 12, true, head);
      size_t end = psot == 0 ? n : start + psot;
      if (end > n) end = n;
      if (end < body) bad("bad tile-part length");
      Header& th = tile_head_[isot];
      if (!th.seen) {
        th = head;
        th.seen = true;
      } else {
        if (head.cod || head.qcd || !head.coc.empty() || !head.qcc.empty())
          bad("coding style in a later tile-part");
        th.poc.insert(th.poc.end(), head.poc.begin(), head.poc.end());
      }
      tile_data_[isot].insert(tile_data_[isot].end(), cs + body, cs + end);
      if (!main_.ppm.empty() && !head.ppt.empty()) bad("both PPM and PPT");
      if (!main_.ppm.empty()) {  // Nppm, then that many bytes of Ippm, for each tile-part
        if (ppm_pos + 4 > ppm.size()) bad("truncated PPM");
        const size_t k = be32(&ppm[ppm_pos]);
        if (k > ppm.size() - ppm_pos - 4) bad("truncated PPM");
        packed_[isot].insert(packed_[isot].end(), ppm.begin() + ppm_pos + 4,
                             ppm.begin() + ppm_pos + 4 + k);
        has_packed_[isot] = true;
        ppm_pos += 4 + k;
      }
      ppt[isot].insert(ppt[isot].end(), head.ppt.begin(), head.ppt.end());
      if (psot == 0) break;
      pos = end;
    }
    for (size_t t = 0; t < ppt.size(); ++t)
      if (!ppt[t].empty()) {
        packed_[t] = packed_stream(ppt[t]);
        has_packed_[t] = true;
      }
  }

  void tile_rect(int64_t t, int64_t* r) const {
    const int64_t p = t % tiles_x, q = t / tiles_x;
    r[0] = std::max(xtosiz + p * xtsiz, xosiz);
    r[1] = std::max(ytosiz + q * ytsiz, yosiz);
    r[2] = std::min(xtosiz + (p + 1) * xtsiz, xsiz);
    r[3] = std::min(ytosiz + (q + 1) * ytsiz, ysiz);
  }

  // The tile's components after the DC shift and clipping, row-major each.
  std::vector<std::vector<int32_t>> decode_tile(int64_t t) {
    std::vector<Style> styles;
    int scod, prog, layers, mct;
    std::vector<Segment> pocs;
    read_styles(t, styles, scod, prog, layers, mct, pocs);
    int64_t rect[4];
    tile_rect(t, rect);
    const int64_t tx0 = rect[0], ty0 = rect[1], tx1 = rect[2], ty1 = rect[3];
    std::vector<std::vector<Res>> comps(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      const Style& st = styles[c];
      const int nres = st.levels + 1;
      // the tile-component on its own grid
      const int64_t tcx0 = ceildiv(tx0, dx[c]), tcy0 = ceildiv(ty0, dy[c]);
      const int64_t tcx1 = ceildiv(tx1, dx[c]), tcy1 = ceildiv(ty1, dy[c]);
      for (int r = 0; r < nres; ++r) {
        const int lev = nres - 1 - r;
        Res res;
        res.x0 = ceilpow2(tcx0, lev);
        res.y0 = ceilpow2(tcy0, lev);
        res.x1 = ceilpow2(tcx1, lev);
        res.y1 = ceilpow2(tcy1, lev);
        res.pdx = st.has_precincts ? st.precincts[r].first : 15;
        res.pdy = st.has_precincts ? st.precincts[r].second : 15;
        res.px0 = (res.x0 >> res.pdx) << res.pdx;
        res.py0 = (res.y0 >> res.pdy) << res.pdy;
        const int64_t px1 = ceilpow2(res.x1, res.pdx) << res.pdx;
        const int64_t py1 = ceilpow2(res.y1, res.pdy) << res.pdy;
        res.pw = res.x0 == res.x1 ? 0 : int((px1 - res.px0) >> res.pdx);
        res.ph = res.y0 == res.y1 ? 0 : int((py1 - res.py0) >> res.pdy);
        if (int64_t(res.pw) * res.ph > (int64_t(1) << 24)) bad("too many precincts");
        int64_t cbgx, cbgy;
        int cbw, cbh;
        if (r == 0) {
          cbgx = res.px0;
          cbgy = res.py0;
          cbw = res.pdx;
          cbh = res.pdy;
        } else {
          cbgx = ceilpow2(res.px0, 1);
          cbgy = ceilpow2(res.py0, 1);
          cbw = res.pdx - 1;
          cbh = res.pdy - 1;
        }
        const int xcb = std::min(st.xcb, cbw), ycb = std::min(st.ycb, cbh);
        for (int b = (r == 0 ? 0 : 1); b <= (r == 0 ? 0 : 3); ++b) {
          Band band;
          band.orient = b;
          if (r == 0) {
            band.x0 = res.x0;
            band.y0 = res.y0;
            band.x1 = res.x1;
            band.y1 = res.y1;
          } else {
            const int xo = b & 1, yo = b >> 1;
            band.x0 = ceilpow2(tcx0 - (int64_t(xo) << lev), lev + 1);
            band.y0 = ceilpow2(tcy0 - (int64_t(yo) << lev), lev + 1);
            band.x1 = ceilpow2(tcx1 - (int64_t(xo) << lev), lev + 1);
            band.y1 = ceilpow2(tcy1 - (int64_t(yo) << lev), lev + 1);
          }
          const int step_i = r == 0 ? 0 : 3 * (r - 1) + b;
          const int expn = st.steps[step_i].first, mant = st.steps[step_i].second;
          const int gain = st.qmfbid == 0 ? 0 : (b == 0 ? 0 : (b == 3 ? 2 : 1));
          const int numbps_img = prec[c] + gain;
          band.stepsize =
              float((1.0 + mant / 2048.0) * std::pow(2.0, double(numbps_img - expn)));
          band.numbps = expn + st.guard - 1;
          band.precincts.resize(size_t(res.pw) * res.ph);
          for (int pno = 0; pno < res.pw * res.ph; ++pno) {
            Precinct& pr = band.precincts[pno];
            const int64_t gx0 = cbgx + int64_t(pno % res.pw) * (int64_t(1) << cbw);
            const int64_t gy0 = cbgy + int64_t(pno / res.pw) * (int64_t(1) << cbh);
            const int64_t px0 = std::max(gx0, band.x0), py0 = std::max(gy0, band.y0);
            const int64_t px1b = std::min(gx0 + (int64_t(1) << cbw), band.x1);
            const int64_t py1b = std::min(gy0 + (int64_t(1) << cbh), band.y1);
            const int64_t sx = (px0 >> xcb) << xcb, sy = (py0 >> ycb) << ycb;
            int64_t cw = std::max<int64_t>(0, ((ceilpow2(px1b, xcb) << xcb) - sx) >> xcb);
            int64_t ch = std::max<int64_t>(0, ((ceilpow2(py1b, ycb) << ycb) - sy) >> ycb);
            if (px0 >= px1b || py0 >= py1b) cw = ch = 0;
            pr.cw = int(cw);
            pr.ch = int(ch);
            pr.blocks.resize(size_t(cw * ch));
            for (int64_t k = 0; k < cw * ch; ++k) {
              const int64_t cx0 = sx + (k % cw) * (int64_t(1) << xcb);
              const int64_t cy0 = sy + (k / cw) * (int64_t(1) << ycb);
              Block& blk = pr.blocks[k];
              blk.x0 = std::max(cx0, px0);
              blk.y0 = std::max(cy0, py0);
              blk.x1 = std::min(cx0 + (int64_t(1) << xcb), px1b);
              blk.y1 = std::min(cy0 + (int64_t(1) << ycb), py1b);
            }
            pr.incl = TagTree(pr.cw, pr.ch);
            pr.imsb = TagTree(pr.cw, pr.ch);
          }
          res.bands.push_back(std::move(band));
        }
        comps[c].push_back(std::move(res));
      }
    }
    tier2(t, comps, scod, prog, layers, pocs, rect);
    return reconstruct(comps, styles, mct);
  }

 private:
  const uint8_t* cs_;
  size_t n_;
  Header main_;
  std::vector<Header> tile_head_;
  std::vector<std::vector<uint8_t>> tile_data_, packed_;  // packed: PPM / PPT headers
  std::vector<bool> has_packed_;

  // Markers from pos to SOD (a tile-part) or the first SOT; returns the
  // position of the tile-part's data or of the SOT.
  size_t header(size_t pos, bool tile, Header& out) {
    while (true) {
      if (pos + 2 > n_) bad("truncated header");
      const uint32_t marker = be16(cs_ + pos);
      if (!tile && marker == 0xFF90) return pos;
      if (tile && marker == 0xFF93) return pos + 2;
      if (marker < 0xFF30) bad("a bad marker");
      if (pos + 4 > n_) bad("truncated marker segment");
      const size_t length = be16(cs_ + pos + 2);
      if (length < 2 || pos + 2 + length > n_) bad("truncated marker segment");
      const Segment seg{cs_ + pos + 4, length - 2};
      switch (marker) {
        case 0xFF52: out.cod = seg.p; out.cod_n = seg.n; break;
        case 0xFF53:
          if (seg.n < 1) bad("truncated COC");
          out.coc.push_back({seg.p[0], seg});
          break;
        case 0xFF5C: out.qcd = seg.p; out.qcd_n = seg.n; break;
        case 0xFF5D:
          if (seg.n < 1) bad("truncated QCC");
          out.qcc.push_back({seg.p[0], {seg.p + 1, seg.n - 1}});
          break;
        case 0xFF5F: out.poc.push_back(seg); break;
        case 0xFF5E:  // RGN: Crgn, Srgn (0: max-shift), SPrgn
          if (seg.n < 3) bad("truncated RGN");
          if (seg.p[1] != 0) refuse("region of interest style " + std::to_string(seg.p[1]));
          out.rgn.push_back({seg.p[0], seg.p[2]});
          break;
        case 0xFF60: case 0xFF61:
          if (seg.n >= 1)
            (marker == 0xFF60 ? out.ppm : out.ppt).push_back({seg.p[0], {seg.p + 1, seg.n - 1}});
          break;
        case 0xFF50: case 0xFF59: refuse("HTJ2K (Part 15)");
        case 0xFF55: case 0xFF57: case 0xFF58: case 0xFF63: case 0xFF64: break;
        default: {
          char hex[8];
          std::snprintf(hex, sizeof(hex), "%04X", marker);
          throw Error(std::string("JPEG 2000: marker ") + hex + " is not supported");
        }
      }
      pos += 2 + length;
    }
  }

  static const Segment* find(const std::vector<std::pair<int, Segment>>& v, int c) {
    const Segment* hit = nullptr;
    for (auto& e : v)
      if (e.first == c) hit = &e.second;
    return hit;
  }

  static void read_spcod(Style& st, const uint8_t* sp, size_t n, bool prec_flag) {
    if (n < 5) bad("truncated coding style");
    st.levels = sp[0];
    if (st.levels > 32) bad("too many decomposition levels");
    st.xcb = sp[1] + 2;
    st.ycb = sp[2] + 2;
    st.cblksty = sp[3];
    st.qmfbid = sp[4];
    if (st.xcb > 10 || st.ycb > 10 || st.xcb + st.ycb > 12) bad("bad code-block size");
    if (st.cblksty & 0x40) refuse("HTJ2K (Part 15)");
    if (st.cblksty) {
      char hex[8];
      std::snprintf(hex, sizeof(hex), "%#04x", st.cblksty);
      refuse(std::string("code-block style ") + hex);
    }
    if (st.qmfbid > 1) bad("bad wavelet transform");
    st.has_precincts = prec_flag;
    st.precincts.clear();
    if (prec_flag) {
      if (n < size_t(5 + st.levels + 1)) bad("truncated precinct sizes");
      for (int r = 0; r <= st.levels; ++r) {
        const int ppx = sp[5 + r] & 15, ppy = sp[5 + r] >> 4;
        if (r && (ppx == 0 || ppy == 0)) bad("bad precinct size");
        st.precincts.push_back({ppx, ppy});
      }
    }
  }

  static void read_quant(Style& st, const uint8_t* q, size_t n) {
    if (n < 1) bad("truncated quantisation");
    st.qntsty = q[0] & 0x1F;
    st.guard = q[0] >> 5;
    st.steps.clear();
    if (st.qntsty == 0) {
      for (size_t k = 1; k < n; ++k) st.steps.push_back({q[k] >> 3, 0});
    } else if (st.qntsty == 1 || st.qntsty == 2) {
      for (size_t k = 0; k < (n - 1) / 2; ++k) {
        const uint32_t v = be16(q + 1 + 2 * k);
        st.steps.push_back({int(v >> 11), int(v & 0x7FF)});
      }
    } else {
      bad("bad quantisation style");
    }
    const int nbands = 3 * st.levels + 1;
    if (st.qntsty == 1) {
      if (st.steps.empty()) bad("no step size");
      const auto first = st.steps[0];
      st.steps.assign(1, first);
      for (int b = 1; b < nbands; ++b)
        st.steps.push_back({std::max(first.first - (b - 1) / 3, 0), first.second});
    }
    if (int(st.steps.size()) < nbands) bad("too few step sizes");
  }

  void read_styles(int64_t t, std::vector<Style>& styles, int& scod, int& prog, int& layers,
                   int& mct, std::vector<Segment>& pocs) {
    const Header& head = tile_head_[t];
    const uint8_t* cod = head.cod ? head.cod : main_.cod;
    const size_t cod_n = head.cod ? head.cod_n : main_.cod_n;
    if (!cod) bad("no COD");
    if (cod_n < 10) bad("truncated COD");
    const uint8_t* qcd = head.qcd ? head.qcd : main_.qcd;
    const size_t qcd_n = head.qcd ? head.qcd_n : main_.qcd_n;
    if (!qcd) bad("no QCD");
    scod = cod[0];
    prog = cod[1];
    layers = int(be16(cod + 2));
    mct = cod[4];
    styles.assign(ncomp, Style());
    for (int c = 0; c < ncomp; ++c) {
      Style& st = styles[c];
      const uint8_t* sp = cod + 5;
      size_t sp_n = cod_n - 5;
      bool pflag = scod & 1;
      const Segment* coc = head.cod ? nullptr : find(main_.coc, c);
      if (const Segment* tc = find(head.coc, c)) coc = tc;
      if (coc) {
        if (coc->n < 2) bad("truncated COC");
        pflag = coc->p[1] & 1;
        sp = coc->p + 2;
        sp_n = coc->n - 2;
      }
      read_spcod(st, sp, sp_n, pflag);
      const uint8_t* q = qcd;
      size_t q_n = qcd_n;
      const Segment* qcc = head.qcd ? nullptr : find(main_.qcc, c);
      if (const Segment* tq = find(head.qcc, c)) qcc = tq;
      if (qcc) {
        q = qcc->p;
        q_n = qcc->n;
      }
      read_quant(st, q, q_n);
      st.roishift = 0;
      for (auto& e : main_.rgn)
        if (e.first == c) st.roishift = e.second;
      for (auto& e : head.rgn)
        if (e.first == c) st.roishift = e.second;
    }
    if (scod & ~0x07) bad("bad coding style");
    pocs = head.poc.empty() ? main_.poc : head.poc;
  }

  // (layer, resolution, component, precinct) in opj_pi_next's order.
  std::vector<Packet> packets(const std::vector<std::vector<Res>>& comps, int prog, int layers,
                              const std::vector<Segment>& pocs, const int64_t* rect) {
    const int nc = int(comps.size());
    int max_res = 0;
    for (auto& rl : comps) max_res = std::max(max_res, int(rl.size()));
    struct Entry {
      int order, r0, r1, c0, c1, l1;
    };
    std::vector<Entry> entries;
    if (!pocs.empty()) {
      for (const Segment& seg : pocs)
        for (size_t off = 0; off + 7 <= seg.n; off += 7) {
          const uint8_t* e = seg.p + off;
          // RSpoc, CSpoc, LYEpoc (2 bytes), REpoc, CEpoc (0: 256), Ppoc
          int ce = e[5];
          if (ce == 0) ce = 256;
          entries.push_back({e[6], e[0], std::min<int>(e[4], max_res), e[1],
                             std::min(ce, nc), std::min<int>(int(be16(e + 2)), layers)});
        }
    } else {
      entries.push_back({prog, 0, max_res, 0, nc, layers});
    }
    std::set<std::tuple<int, int, int, int>> include;
    std::vector<Packet> out;
    auto emit = [&](int l, int r, int c, int p) {
      if (include.insert({l, r, c, p}).second) out.push_back({l, r, c, p});
    };
    const int64_t tx0 = rect[0], ty0 = rect[1], tx1 = rect[2], ty1 = rect[3];
    auto precinct_at = [&](int c, int r, int64_t x, int64_t y) -> int {
      if (r >= int(comps[c].size())) return -1;
      const Res& res = comps[c][r];
      const int lev = int(comps[c].size()) - 1 - r;
      const int64_t sx = int64_t(dx[c]) << lev, sy = int64_t(dy[c]) << lev;
      const int64_t trx0 = ceildiv(tx0, sx), try0 = ceildiv(ty0, sy);
      const int64_t trx1 = ceildiv(tx1, sx), try1 = ceildiv(ty1, sy);
      const int rpx = res.pdx + lev, rpy = res.pdy + lev;
      if (rpx >= 31 || rpy >= 31) return -1;
      if (!(y % (int64_t(dy[c]) << rpy) == 0 ||
            (y == ty0 && (try0 << lev) % (int64_t(1) << rpy))))
        return -1;
      if (!(x % (int64_t(dx[c]) << rpx) == 0 ||
            (x == tx0 && (trx0 << lev) % (int64_t(1) << rpx))))
        return -1;
      if (res.pw == 0 || res.ph == 0 || trx0 == trx1 || try0 == try1) return -1;
      const int64_t prci = (ceildiv(x, sx) >> res.pdx) - (trx0 >> res.pdx);
      const int64_t prcj = (ceildiv(y, sy) >> res.pdy) - (try0 >> res.pdy);
      return int(prci + prcj * res.pw);
    };
    auto steps = [&](int c0, int c1, int64_t& step_x, int64_t& step_y) {
      step_x = step_y = 0;
      for (int c = c0; c < c1; ++c)
        for (size_t r = 0; r < comps[c].size(); ++r) {
          const int lev = int(comps[c].size()) - 1 - int(r);
          const int64_t ddx = int64_t(dx[c]) << std::min(comps[c][r].pdx + lev, 40);
          const int64_t ddy = int64_t(dy[c]) << std::min(comps[c][r].pdy + lev, 40);
          step_x = step_x ? std::min(step_x, ddx) : ddx;
          step_y = step_y ? std::min(step_y, ddy) : ddy;
        }
    };
    for (const Entry& e : entries) {
      if (e.order > 4) bad("bad progression order");
      if (e.order == 0 || e.order == 1) {  // LRCP, RLCP
        const int outer_a = e.order == 0 ? e.l1 : e.r1 - e.r0;
        const int outer_b = e.order == 0 ? e.r1 - e.r0 : e.l1;
        for (int i = 0; i < outer_a; ++i)
          for (int j = 0; j < outer_b; ++j) {
            const int l = e.order == 0 ? i : j, r = e.r0 + (e.order == 0 ? j : i);
            for (int c = e.c0; c < e.c1; ++c) {
              if (r >= int(comps[c].size())) continue;
              const Res& res = comps[c][r];
              for (int p = 0; p < res.pw * res.ph; ++p) emit(l, r, c, p);
            }
          }
        continue;
      }
      auto positions = [&](int64_t step_x, int64_t step_y, auto&& body) {
        for (int64_t y = ty0; y < ty1; y += step_y - (y % step_y))
          for (int64_t x = tx0; x < tx1; x += step_x - (x % step_x)) body(x, y);
      };
      int64_t step_x, step_y;
      if (e.order == 2) {  // RPCL
        steps(0, nc, step_x, step_y);
        for (int r = e.r0; r < e.r1; ++r)
          positions(step_x, step_y, [&](int64_t x, int64_t y) {
            for (int c = e.c0; c < e.c1; ++c) {
              const int p = precinct_at(c, r, x, y);
              if (p < 0) continue;
              for (int l = 0; l < e.l1; ++l) emit(l, r, c, p);
            }
          });
      } else if (e.order == 3) {  // PCRL
        steps(0, nc, step_x, step_y);
        positions(step_x, step_y, [&](int64_t x, int64_t y) {
          for (int c = e.c0; c < e.c1; ++c)
            for (int r = e.r0; r < std::min(e.r1, int(comps[c].size())); ++r) {
              const int p = precinct_at(c, r, x, y);
              if (p < 0) continue;
              for (int l = 0; l < e.l1; ++l) emit(l, r, c, p);
            }
        });
      } else {  // CPRL
        for (int c = e.c0; c < e.c1; ++c) {
          steps(c, c + 1, step_x, step_y);
          positions(step_x, step_y, [&](int64_t x, int64_t y) {
            for (int r = e.r0; r < std::min(e.r1, int(comps[c].size())); ++r) {
              const int p = precinct_at(c, r, x, y);
              if (p < 0) continue;
              for (int l = 0; l < e.l1; ++l) emit(l, r, c, p);
            }
          });
        }
      }
    }
    return out;
  }

  static int numpasses(Bits& bits) {
    if (!bits.bit()) return 1;
    if (!bits.bit()) return 2;
    int n = int(bits.bits(2));
    if (n != 3) return 3 + n;
    n = int(bits.bits(5));
    if (n != 31) return 6 + n;
    return 37 + int(bits.bits(7));
  }

  void tier2(int64_t t, std::vector<std::vector<Res>>& comps, int scod, int prog, int layers,
             const std::vector<Segment>& pocs, const int64_t* rect) {
    const std::vector<uint8_t>& data = tile_data_[t];
    // the packet headers: in the data, or packed (PPM / PPT) apart from it
    const bool packed = has_packed_[t];
    const std::vector<uint8_t>& hdr = packed ? packed_[t] : data;
    size_t pos = 0, hpos = 0;
    const size_t end = data.size();
    struct Inc {
      Block* blk;
      int n;
      size_t len;
    };
    std::vector<Inc> included;
    for (const Packet& pk : packets(comps, prog, layers, pocs, rect)) {
      if (packed ? hpos >= hdr.size() : pos >= end) break;
      if ((scod & 2) && pos + 6 <= end && data[pos] == 0xFF && data[pos + 1] == 0x91) pos += 6;
      if (!packed) hpos = pos;
      Res& res = comps[pk.comp][pk.res];
      Bits bits(hdr.data(), hpos, hdr.size());
      included.clear();
      if (bits.bit()) {
        for (Band& band : res.bands) {
          if (band.empty()) continue;
          Precinct& pr = band.precincts[pk.prec];
          for (size_t k = 0; k < pr.blocks.size(); ++k) {
            Block& blk = pr.blocks[k];
            const int inc =
                blk.included ? bits.bit() : pr.incl.decode(bits, int(k), pk.layer + 1);
            if (!inc) continue;
            if (!blk.included) {
              int i = 0;
              while (!pr.imsb.decode(bits, int(k), i)) ++i;
              blk.numbps = band.numbps + 1 - i;
              blk.lenbits = 3;
              blk.included = true;
            }
            const int np = numpasses(bits);
            while (bits.bit()) ++blk.lenbits;
            int log2 = 0;
            while ((np >> (log2 + 1)) > 0) ++log2;
            if (blk.lenbits + log2 > 32) bad("bad code-block length");
            included.push_back({&blk, np, size_t(bits.bits(blk.lenbits + log2))});
          }
        }
      }
      hpos = bits.align();
      if ((scod & 4) && hpos + 2 <= hdr.size() && hdr[hpos] == 0xFF && hdr[hpos + 1] == 0x92)
        hpos += 2;  // EPH
      if (!packed) pos = hpos;
      for (Inc& inc : included) {
        const size_t len = std::min(inc.len, end - std::min(pos, end));
        inc.blk->data.insert(inc.blk->data.end(), data.begin() + pos, data.begin() + pos + len);
        inc.blk->passes += inc.n;
        pos += len;
      }
    }
  }

  std::vector<std::vector<int32_t>> reconstruct(std::vector<std::vector<Res>>& comps,
                                                const std::vector<Style>& styles, int mct) {
    std::vector<std::vector<float>> fplanes(ncomp);
    std::vector<std::vector<int32_t>> iplanes(ncomp);
    std::vector<int64_t> pw(ncomp), ph(ncomp);
    std::vector<int32_t> cblk;
    T1Work work;
    for (int c = 0; c < ncomp; ++c) {
      std::vector<Res>& rl = comps[c];
      const bool rev = styles[c].qmfbid == 1;
      const Res& top = rl.back();
      const int64_t w = top.x1 - top.x0, h = top.y1 - top.y0;
      pw[c] = w;
      ph[c] = h;
      // Mallat layout, as OpenJPEG keeps the tile-component: a band of
      // resolution r sits right of / below the resolution r - 1 image.
      if (rev) iplanes[c].assign(size_t(w * h), 0);
      else fplanes[c].assign(size_t(w * h), 0.f);
      for (size_t r = 0; r < rl.size(); ++r) {
        for (Band& band : rl[r].bands) {
          int64_t ox = 0, oy = 0;
          if (band.orient & 1) ox = rl[r - 1].x1 - rl[r - 1].x0;
          if (band.orient & 2) oy = rl[r - 1].y1 - rl[r - 1].y0;
          const float half = 0.5f * band.stepsize;
          for (Precinct& pr : band.precincts)
            for (Block& blk : pr.blocks) {
              const int bw = int(blk.x1 - blk.x0), bh = int(blk.y1 - blk.y0);
              if (bw <= 0 || bh <= 0) continue;
              const int shift = styles[c].roishift;
              if (blk.numbps + shift >= 31) bad("too many bit-planes");
              cblk.resize(size_t(bw) * bh);
              t1_decode(blk.data, blk.passes, blk.numbps + shift, band.orient, bw, bh,
                        cblk.data(), work);
              if (shift)  // max-shift: the region's magnitudes back down
                for (int32_t& v : cblk) {
                  const int32_t mag = v < 0 ? -v : v;
                  if (mag >= (int32_t(1) << shift)) v = v < 0 ? -(mag >> shift) : mag >> shift;
                }
              for (int y = 0; y < bh; ++y) {
                const size_t row = size_t(oy + blk.y0 - band.y0 + y) * w + (ox + blk.x0 - band.x0);
                for (int x = 0; x < bw; ++x) {
                  const int32_t v = cblk[size_t(y) * bw + x];
                  if (rev) iplanes[c][row + x] = v / 2;
                  else fplanes[c][row + x] = float(v) * half;
                }
              }
            }
        }
      }
      for (size_t r = 1; r < rl.size(); ++r) {
        const int64_t rw = rl[r].x1 - rl[r].x0, rh = rl[r].y1 - rl[r].y0;
        const int64_t sn_h = rl[r - 1].x1 - rl[r - 1].x0, sn_v = rl[r - 1].y1 - rl[r - 1].y0;
        const int cas_h = int(rl[r].x0 % 2), cas_v = int(rl[r].y0 % 2);
        if (rev) synth(iplanes[c].data(), w, rw, rh, sn_h, sn_v, cas_h, cas_v);
        else synth(fplanes[c].data(), w, rw, rh, sn_h, sn_v, cas_h, cas_v);
      }
    }
    if (mct && ncomp >= 3) {
      if (pw[0] != pw[1] || pw[0] != pw[2] || ph[0] != ph[1] || ph[0] != ph[2])
        bad("components of unequal size under a colour transform");
      const size_t n = size_t(pw[0] * ph[0]);
      if (styles[0].qmfbid == 1) {
        int32_t *y = iplanes[0].data(), *u = iplanes[1].data(), *v = iplanes[2].data();
        for (size_t i = 0; i < n; ++i) {
          const int32_t g = y[i] - ((u[i] + v[i]) >> 2);
          const int32_t r = v[i] + g, b = u[i] + g;
          y[i] = r;
          u[i] = g;
          v[i] = b;
        }
      } else {
        float *y = fplanes[0].data(), *u = fplanes[1].data(), *v = fplanes[2].data();
        for (size_t i = 0; i < n; ++i) {
          const float r = y[i] + v[i] * 1.402f;
          const float g = y[i] - u[i] * 0.34413f - v[i] * 0.71414f;
          const float b = y[i] + u[i] * 1.772f;
          y[i] = r;
          u[i] = g;
          v[i] = b;
        }
      }
    }
    std::vector<std::vector<int32_t>> out(ncomp);
    for (int c = 0; c < ncomp; ++c) {
      const int p = prec[c];
      const int64_t lo = sgnd[c] ? -(int64_t(1) << (p - 1)) : 0;
      const int64_t hi = sgnd[c] ? (int64_t(1) << (p - 1)) - 1 : (int64_t(1) << p) - 1;
      const int64_t shift = sgnd[c] ? 0 : int64_t(1) << (p - 1);
      const size_t n = size_t(pw[c] * ph[c]);
      out[c].resize(n);
      for (size_t i = 0; i < n; ++i) {
        int64_t v;
        if (styles[c].qmfbid == 1) {
          v = int64_t(iplanes[c][i]) + shift;
        } else {
          const float f = fplanes[c][i];
          if (f > float(INT32_MAX)) v = hi;
          else if (f < float(INT32_MIN)) v = lo;
          else v = int64_t(std::lrintf(f)) + shift;
        }
        out[c][i] = int32_t(std::clamp(v, lo, hi));
      }
    }
    return out;
  }

  // The synthesis works on n elements of ``lanes`` samples each, element k
  // at base + k * lanes: one line (lanes 1) for the rows, all the columns
  // at once (lanes rw, element k a row) for the columns; every lane does
  // the same operations as a single line.

  // The 5/3 synthesis (T.800 F.3, OpenJPEG's opj_idwt53_h / _v).
  static void line53(int32_t* x, const int32_t* y, int64_t sn, int64_t dn, int cas,
                     int64_t lanes) {
    const int64_t n = sn + dn;
    if (n == 1) {
      for (int64_t j = 0; j < lanes; ++j) x[j] = cas ? y[j] / 2 : y[j];
      return;
    }
    auto at = [&](int64_t k) { return (k < 0 ? -k : (k >= n ? 2 * (n - 1) - k : k)) * lanes; };
    for (int64_t p = cas; p < n; p += 2) {
      const int32_t *l = y + at(p - 1), *r = y + at(p + 1), *c = y + p * lanes;
      int32_t* o = x + p * lanes;
      for (int64_t j = 0; j < lanes; ++j) o[j] = c[j] - ((l[j] + r[j] + 2) >> 2);
    }
    for (int64_t q = 1 - cas; q < n; q += 2) {
      const int32_t *l = x + at(q - 1), *r = x + at(q + 1), *c = y + q * lanes;
      int32_t* o = x + q * lanes;
      for (int64_t j = 0; j < lanes; ++j) o[j] = c[j] + ((l[j] + r[j]) >> 1);
    }
  }

  // opj_v8dwt_decode_step2: element t + 2i += (left + right) * c for i < m,
  // the last target without a right neighbour += left * 2c.
  static void lift(float* x, int64_t t, int64_t cnt, int64_t m, float c, int64_t lanes) {
    auto step = [&](int64_t k, bool right, float cc) {
      const float* l = x + (k - 1 >= 0 ? k - 1 : 1 - t) * lanes;
      const float* r = x + (k + 1) * lanes;
      float* o = x + k * lanes;
      if (right)
        for (int64_t j = 0; j < lanes; ++j) o[j] = o[j] + (l[j] + r[j]) * cc;
      else
        for (int64_t j = 0; j < lanes; ++j) o[j] = o[j] + l[j] * cc;
    };
    const int64_t upto = std::min(cnt, m);
    for (int64_t i = 0; i < upto; ++i) step(t + 2 * i, true, c);
    if (m < cnt) step(t + 2 * m, false, c + c);
  }

  // The 9/7 synthesis, as each lane of opj_v8dwt_decode.
  static void line97(float* x, const float* y, int64_t sn, int64_t dn, int cas, int64_t lanes) {
    const int64_t n = sn + dn;
    std::copy(y, y + n * lanes, x);
    if ((cas == 0 && !(dn > 0 || sn > 1)) || (cas == 1 && !(sn > 0 || dn > 1))) return;
    const int64_t a = cas, b = 1 - cas;
    for (int64_t k = 0; k < n; ++k) {
      const float scale = (k - a) % 2 == 0 ? 1.230174105f : 1.625732422f;
      for (int64_t j = 0; j < lanes; ++j) x[k * lanes + j] = x[k * lanes + j] * scale;
    }
    lift(x, a, sn, std::min(sn, dn - a), -0.443506852f, lanes);
    lift(x, b, dn, std::min(dn, sn - b), -0.882911075f, lanes);
    lift(x, a, sn, std::min(sn, dn - a), 0.052980118f, lanes);
    lift(x, b, dn, std::min(dn, sn - b), 1.586134342f, lanes);
  }

  static void line(int32_t* x, const int32_t* y, int64_t sn, int64_t dn, int cas,
                   int64_t lanes) {
    line53(x, y, sn, dn, cas, lanes);
  }
  static void line(float* x, const float* y, int64_t sn, int64_t dn, int cas, int64_t lanes) {
    line97(x, y, sn, dn, cas, lanes);
  }

  // One level: every row of the rw x rh region (low half first, then the
  // high half, interleaved by cas), then every column.
  template <typename T>
  static void synth(T* plane, int64_t w, int64_t rw, int64_t rh, int64_t sn_h, int64_t sn_v,
                    int cas_h, int cas_v) {
    const size_t width = size_t(rw);
    std::vector<T> in(width), out(width);
    for (int64_t j = 0; j < rh; ++j) {
      T* row = plane + j * w;
      for (int64_t i = 0; i < rw; ++i) {
        const bool low = i < sn_h;
        const int64_t k = low ? i : i - sn_h;
        in[size_t(low ? cas_h + 2 * k : 1 - cas_h + 2 * k)] = row[i];
      }
      line(out.data(), in.data(), sn_h, rw - sn_h, cas_h, 1);
      std::copy(out.begin(), out.begin() + rw, row);
    }
    std::vector<T> rows_in(size_t(rw * rh)), rows_out(size_t(rw * rh));
    for (int64_t j = 0; j < rh; ++j) {
      const bool low = j < sn_v;
      const int64_t k = low ? j : j - sn_v;
      std::copy(plane + j * w, plane + j * w + rw,
                rows_in.begin() + (low ? cas_v + 2 * k : 1 - cas_v + 2 * k) * rw);
    }
    line(rows_out.data(), rows_in.data(), sn_v, rh - sn_v, cas_v, rw);
    for (int64_t j = 0; j < rh; ++j)
      std::copy(rows_out.begin() + j * rw, rows_out.begin() + (j + 1) * rw, plane + j * w);
  }
};

// ---- JP2 boxes and PIL's modes ---------------------------------------------------------

enum Space { SPACE_GRAY, SPACE_SRGB, SPACE_SYCC, SPACE_CMYK, SPACE_EYCC, SPACE_UNKNOWN };

// PIL's ConvertYCbCr.c tables: int(c * 64 * (i - 128) + 0.5), truncated.
struct YccTables {
  int r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      r_cr[i] = int(1.402 * 64 * (i - 128) + 0.5);
      g_cb[i] = int(-0.34414 * 64 * (i - 128) + 0.5);
      g_cr[i] = int(-0.71414 * 64 * (i - 128) + 0.5);
      b_cb[i] = int(1.772 * 64 * (i - 128) + 0.5);
    }
  }
};
const YccTables kYcc;

// PIL's ImagingConvertYCbCr2RGB on one pixel's first three bytes.
void sycc_to_rgb(uint8_t* px) {
  const int y = px[0], cb = px[1], cr = px[2];
  const int r = y + (kYcc.r_cr[cr] >> 6), g = y + ((kYcc.g_cb[cb] + kYcc.g_cr[cr]) >> 6);
  const int b = y + (kYcc.b_cb[cb] >> 6);
  px[0] = uint8_t(std::clamp(r, 0, 255));
  px[1] = uint8_t(std::clamp(g, 0, 255));
  px[2] = uint8_t(std::clamp(b, 0, 255));
}

struct Box {
  uint32_t kind;
  size_t start, end;
};

std::vector<Box> boxes(const uint8_t* p, size_t pos, size_t end) {
  std::vector<Box> out;
  while (pos + 8 <= end) {
    uint64_t length = be32(p + pos);
    const uint32_t kind = be32(p + pos + 4);
    size_t head = 8;
    if (length == 1) {
      if (pos + 16 > end) bad("bad JP2 box");
      length = (uint64_t(be32(p + pos + 8)) << 32) | be32(p + pos + 12);
      head = 16;
    } else if (length == 0) {
      length = end - pos;
    }
    if (length < head || length > end - pos) bad("bad JP2 box");
    out.push_back({kind, pos + head, pos + size_t(length)});
    pos += size_t(length);
  }
  return out;
}

constexpr uint32_t fourcc(const char* s) {
  return (uint32_t(uint8_t(s[0])) << 24) | (uint32_t(uint8_t(s[1])) << 16) |
         (uint32_t(uint8_t(s[2])) << 8) | uint32_t(uint8_t(s[3]));
}

}  // namespace

Image decode_j2k(const std::vector<uint8_t>& file) {
  const uint8_t* p = file.data();
  const size_t n = file.size();
  const uint8_t* cs = p;
  size_t cs_n = n;
  int mode;
  Space space;
  int64_t wid, hgt;
  std::vector<uint8_t> palette;
  const bool raw = n >= 4 && be16(p) == 0xFF4F && be16(p + 2) == 0xFF51;
  if (!raw) {
    const Box* header = nullptr;
    const Box* stream = nullptr;
    const std::vector<Box> top = boxes(p, 0, n);
    for (const Box& b : top) {
      if (b.kind == fourcc("jp2h") && !header) header = &b;
      else if (b.kind == fourcc("jp2c") && !stream) stream = &b;
    }
    if (!header || !stream) bad("no JP2 header or codestream box");
    cs = p + stream->start;
    cs_n = stream->end - stream->start;
    bool have_size = false;
    mode = -1;
    int nc = 0;
    uint32_t enumcs = 0;
    for (const Box& b : boxes(p, header->start, header->end)) {
      const size_t len = b.end - b.start;
      if (b.kind == fourcc("ihdr")) {
        if (len < 11) bad("truncated ihdr");
        hgt = be32(p + b.start);
        wid = be32(p + b.start + 4);
        nc = int(be16(p + b.start + 8));
        const int bpc = p[b.start + 10];
        have_size = true;
        mode = nc == 1 ? ((bpc & 0x7F) > 8 ? MODE_I16 : MODE_L)
                       : nc == 2 ? MODE_LA : nc == 3 ? MODE_RGB : nc == 4 ? MODE_RGBA : -1;
      } else if (b.kind == fourcc("colr") && !enumcs) {
        if (len < 3) bad("truncated colr");
        if (p[b.start] == 1) {
          if (len < 7) bad("truncated colr");
          enumcs = be32(p + b.start + 3);
          if (nc == 4 && enumcs == 12) mode = MODE_CMYK;
        }
      } else if (b.kind == fourcc("pclr") && (mode == MODE_L || mode == MODE_LA)) {
        // PIL: a palette when no bit depth byte exceeds 8, the entries one
        // byte a component, each new colour appended once (getcolor)
        if (len < 3) bad("truncated pclr");
        const size_t ne = be16(p + b.start), npc = p[b.start + 2];
        if (len < 3 + npc) bad("truncated pclr");
        uint8_t most = 0;
        for (size_t k = 0; k < npc; ++k) most = std::max(most, p[b.start + 3 + k]);
        if (most <= 8) {
          if (mode == MODE_LA) refuse("a palette with alpha (PA)");
          if (npc != 3) refuse("a palette of " + std::to_string(npc) + " components");
          if (len < 3 + npc + 3 * ne) bad("truncated pclr");
          palette.clear();
          for (size_t k = 0; k < ne; ++k) {
            const uint8_t* c = p + b.start + 3 + npc + 3 * k;
            bool seen = false;
            for (size_t j = 0; j < palette.size() && !seen; j += 3)
              seen = !std::memcmp(&palette[j], c, 3);
            if (!seen) palette.insert(palette.end(), c, c + 3);
          }
          if (palette.size() > 768) bad("a palette of more than 256 colours");
          mode = MODE_P;
        }
      }
    }
    if (!have_size || mode < 0) bad("malformed JP2 header");
    if (too_many_pixels(uint64_t(wid), uint64_t(hgt))) bad("bad image size");
    space = enumcs == 16   ? SPACE_SRGB
            : enumcs == 17 ? SPACE_GRAY
            : enumcs == 18 ? SPACE_SYCC
            : enumcs == 12 ? SPACE_CMYK
            : enumcs == 24 ? SPACE_EYCC
                           : SPACE_UNKNOWN;
  }
  Codestream code(cs, cs_n);
  if (raw) {
    const int nc = code.ncomp;
    mode = nc == 1 ? (code.prec[0] > 8 ? MODE_I16 : MODE_L)
                   : nc == 2 ? MODE_LA : nc == 3 ? MODE_RGB : MODE_RGBA;
    space = SPACE_UNKNOWN;
    wid = code.xsiz - code.xosiz;
    hgt = code.ysiz - code.yosiz;
  }
  const int nc = code.ncomp;
  bool subsampled = false, chroma = false;
  for (int c = 0; c < nc; ++c) {
    subsampled |= code.dx[c] != 1 || code.dy[c] != 1;
    chroma |= (c == 1 || c == 2) && (code.dx[c] != 1 || code.dy[c] != 1);
  }
  if (space == SPACE_UNKNOWN)  // PIL's guess: sYCC for subsampled chroma (components 1, 2)
    space = (nc == 3 || nc == 4) && chroma && code.dx[0] == 1 && code.dy[0] == 1 ? SPACE_SYCC
            : nc <= 2                                                        ? SPACE_GRAY
                                                                             : SPACE_SRGB;
  if (space == SPACE_EYCC) refuse("the e-sYCC colour space");
  const char* mode_name = mode == MODE_L ? "L" : mode == MODE_P ? "P" : mode == MODE_I16 ? "I;16"
                          : mode == MODE_LA ? "LA" : mode == MODE_RGB ? "RGB"
                          : mode == MODE_CMYK ? "CMYK" : "RGBA";
  if (subsampled && mode != MODE_RGB && mode != MODE_RGBA && mode != MODE_CMYK)
    refuse(std::string("a subsampled component in mode ") + mode_name);
  // PIL's unpackers: (mode, colour space, components)
  const bool ok = ((mode == MODE_L || mode == MODE_I16) && space == SPACE_GRAY && nc == 1) ||
                  (mode == MODE_P && space == SPACE_SRGB && nc == 1) ||
                  (mode == MODE_CMYK && space == SPACE_CMYK && nc == 4) ||
                  (mode == MODE_LA && space == SPACE_GRAY && nc == 2) ||
                  ((mode == MODE_RGB || mode == MODE_RGBA) &&
                   (space == SPACE_SRGB || space == SPACE_SYCC) && (nc == 3 || nc == 4));
  if (!ok)
    bad("PIL has no unpacker for " + std::to_string(nc) + " components as " + mode_name);
  Image img;
  img.w = int(wid);
  img.h = int(hgt);
  img.mode = mode;
  img.palette = palette;
  img.channels = mode == MODE_LA    ? 2
                 : mode == MODE_RGB ? 3
                 : (mode == MODE_RGBA || mode == MODE_CMYK) ? 4
                                    : 1;
  img.bitdepth = mode == MODE_I16 ? 16 : 8;
  const int bits = img.bitdepth;
  img.data.assign(size_t(wid) * hgt * img.channels * size_t(bits / 8), 0);
  const int used = std::min(nc, img.channels);
  std::vector<int> csiz(nc);
  int csiz_sum = 0;
  for (int c = 0; c < nc; ++c) {
    const int bytes = (code.prec[c] + 7) >> 3;
    csiz[c] = bytes == 3 ? 4 : bytes;
    csiz_sum += csiz[c];
  }
  std::vector<uint8_t> buf;
  for (int64_t t = 0; t < code.tiles_x * code.tiles_y; ++t) {
    int64_t r[4];
    code.tile_rect(t, r);
    const int64_t x0 = r[0] - code.xosiz, y0 = r[1] - code.yosiz;
    const int64_t tw = r[2] - r[0], th = r[3] - r[1];
    if (tw <= 0 || th <= 0 || x0 + tw > wid || y0 + th > hgt) bad("a tile outside the image");
    const std::vector<std::vector<int32_t>> planes = code.decode_tile(t);
    // PIL's tile buffer: OpenJPEG's tile data (each component's samples in
    // csiz bytes), then zeros up to w * h * (the sum of csiz) bytes
    // (Jpeg2KDecode.c zeroes that much for each tile).  PIL finds component
    // n at the sum of the earlier ones' csiz * (w / dx) * (h / dy) and
    // sample (x, y) of it at (y / dy) * (w / dx) + x / dx, in integer
    // division, which can reach past the data but not past the buffer.
    // Without subsampling that is the component's own sample (x, y),
    // truncated to csiz bytes.
    if (subsampled) {
      size_t data_n = 0;
      for (int c = 0; c < nc; ++c) data_n += planes[c].size() * size_t(csiz[c]);
      buf.assign(std::max(data_n, size_t(tw * th) * size_t(csiz_sum)), 0);
      size_t at = 0;
      for (int c = 0; c < nc; ++c)
        for (int32_t v : planes[c])
          for (int b = 0; b < csiz[c]; ++b) buf[at++] = uint8_t(uint32_t(v) >> (8 * b));
    }
    size_t start = 0;
    for (int k = 0; k < used; ++k) {
      const int prec = code.prec[k], width = csiz[k];
      const int64_t kdx = code.dx[k], kdy = code.dy[k];
      const int shift = bits - prec;
      uint32_t offset = code.sgnd[k] ? uint32_t(1) << (prec - 1) : 0;
      if (shift < 0) offset += uint32_t(1) << (-shift - 1);
      const uint32_t mask = width == 4 ? 0xFFFFFFFFu : (uint32_t(1) << (8 * width)) - 1;
      for (int64_t y = 0; y < th; ++y)
        for (int64_t x = 0; x < tw; ++x) {
          uint32_t word = 0;
          if (subsampled) {
            const size_t at = start + size_t(width) * size_t((y / kdy) * (tw / kdx) + x / kdx);
            for (int b = 0; b < width; ++b) word |= uint32_t(buf[at + b]) << (8 * b);
          } else {
            word = uint32_t(planes[k][size_t(y * tw + x)]) & mask;
          }
          uint32_t v = word + offset;
          v = shift < 0 ? v >> -shift : v << shift;
          const size_t px = (size_t(y0 + y) * wid + size_t(x0 + x)) * img.channels + k;
          if (bits == 16) {
            const uint16_t s16 = uint16_t(v);
            std::memcpy(&img.data[px * 2], &s16, 2);
          } else {
            img.data[px] = uint8_t(v);
          }
        }
      start += size_t(width) * size_t((tw / kdx) * (th / kdy));
    }
    if (mode == MODE_RGBA && nc == 3)
      for (int64_t y = 0; y < th; ++y)
        for (int64_t x = 0; x < tw; ++x)
          img.data[(size_t(y0 + y) * wid + size_t(x0 + x)) * 4 + 3] = 255;
    if (space == SPACE_SYCC)
      for (int64_t y = 0; y < th; ++y)
        for (int64_t x = 0; x < tw; ++x)
          sycc_to_rgb(&img.data[(size_t(y0 + y) * wid + size_t(x0 + x)) * img.channels]);
  }
  return img;
}

}  // namespace pslx
