// SGI and PCX as PIL 12 reads them.
//
// SGI (SgiImagePlugin): a 512-byte big-endian header, 1 or 2 bytes per
// sample, dimension 1-3 with 1, 3 or 4 channels (L, RGB, RGBA; 16-bit
// samples keep their high byte, as PIL's "L;16B" raw modes do), channel
// planes of rows bottom-up, raw or run-length encoded (SgiRleDecode.c: a
// start and a length table per row and channel; a count byte with bit 7 set
// copies that many samples, clear repeats the next sample, zero ends the
// row; a run past the row is refused).
//
// PCX (PcxImagePlugin): version, bits and planes as PIL maps them to "1"
// (1 bit, 1 plane), P (1 bit, 2 or 4 planes, the header's 16-colour
// palette), L or P (version 5, 8 bits, 1 plane; P unless the 769-byte
// trailing palette is the gray ramp) and RGB (version 5, 8 bits, 3
// planes); PcxDecode.c's run-length coding over rows of planes x stride
// bytes (the computed stride, rounded up to even unless the file gives
// that very stride), its band moves and its unpackers.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {

Image decode_sgi(const std::vector<uint8_t>& f) {
  if (f.size() < 512 || be16(f.data()) != 474) throw Error("not an SGI file");
  const int rle = f[2], bpc = f[3];
  const int dimension = int(be16(&f[4])), w = int(be16(&f[6])), h = int(be16(&f[8])),
            z = int(be16(&f[10]));
  Image img;
  const bool bpc_ok = bpc == 1 || bpc == 2;
  if (bpc_ok && (dimension == 1 || dimension == 2) && z == 1) img.mode = MODE_L;
  else if (bpc_ok && dimension == 3 && z == 3) img.mode = MODE_RGB;
  else if (bpc_ok && dimension == 3 && z == 4) img.mode = MODE_RGBA;
  else throw Error("SGI: unsupported SGI image mode");
  if (w == 0 || h == 0) throw Error("SGI: bad image size");
  if (rle != 0 && rle != 1) throw Error("SGI: unknown compression");
  img.w = w;
  img.h = h;
  img.channels = z;
  img.data.assign(size_t(w) * h * z, 0);
  // row r of channel c (bottom-up in the file) -> its samples, high bytes
  auto put = [&](int c, int r, const uint8_t* src) {  // src: w samples of bpc bytes
    uint8_t* d = &img.data[(size_t(h - 1 - r) * w) * z + c];
    for (int x = 0; x < w; ++x) d[size_t(x) * z] = src[size_t(x) * bpc];
  };
  const size_t row_bytes = size_t(w) * bpc;
  if (rle == 0) {
    if (512 + row_bytes * h * z > f.size()) throw Error("SGI: truncated image data");
    for (int c = 0; c < z; ++c)
      for (int r = 0; r < h; ++r) put(c, r, &f[512 + (size_t(c) * h + r) * row_bytes]);
    return img;
  }
  const size_t tables = 512 + size_t(h) * z * 8;
  if (tables > f.size()) throw Error("SGI: truncated RLE tables");
  std::vector<uint8_t> row(row_bytes);
  for (int c = 0; c < z; ++c)
    for (int r = 0; r < h; ++r) {
      size_t at = 512 + (size_t(c) * h + r) * 4;
      size_t start = be32(&f[at]), length = be32(&f[at + size_t(h) * z * 4]);
      if (start > f.size() || length > f.size() - start) throw Error("SGI: truncated RLE row");
      const uint8_t* p = &f[start];
      const uint8_t* end = p + length;
      int x = 0;
      for (;;) {  // SgiRleDecode.c expandrow / expandrow2
        if (p + bpc > end) throw Error("SGI: an RLE row ends early");
        uint32_t pixel = bpc == 2 ? be16(p) : *p;
        p += bpc;
        int count = int(pixel & 0x7F);
        if (!count) break;
        if (x + count > w) throw Error("SGI: an RLE run crosses the end of a row");
        if (pixel & 0x80) {
          if (p + size_t(count) * bpc > end) throw Error("SGI: an RLE row ends early");
          std::memcpy(&row[size_t(x) * bpc], p, size_t(count) * bpc);
          p += size_t(count) * bpc;
        } else {
          if (p + bpc > end) throw Error("SGI: an RLE row ends early");
          for (int i = 0; i < count; ++i)
            std::memcpy(&row[size_t(x + i) * bpc], p, size_t(bpc));
          p += bpc;
        }
        x += count;
      }
      if (x < w) std::memset(&row[size_t(x) * bpc], 0, size_t(w - x) * bpc);
      put(c, r, row.data());
    }
  return img;
}

Image decode_pcx(const std::vector<uint8_t>& f) {
  if (f.size() < 128 || f[0] != 10) throw Error("not a PCX file");
  const int version = f[1], bits = f[3], planes = f[65];
  const int x0 = int(le16(&f[4])), y0 = int(le16(&f[6]));
  const int x1 = int(le16(&f[8])) + 1, y1 = int(le16(&f[10])) + 1;
  if (x1 <= x0 || y1 <= y0) throw Error("PCX: bad image size");
  const int w = x1 - x0, h = y1 - y0;
  if (too_many_pixels(uint64_t(w), uint64_t(h))) throw Error("PCX: bad image size");
  Image img;
  img.w = w;
  img.h = h;
  enum { RAW_1, RAW_PLANES, RAW_L, RAW_RGB } raw;
  if (bits == 1 && planes == 1) {
    img.mode = MODE_1;
    raw = RAW_1;
  } else if (bits == 1 && (planes == 2 || planes == 4)) {
    img.mode = MODE_P;
    raw = RAW_PLANES;
    img.palette.assign(f.begin() + 16, f.begin() + 64);
  } else if (version == 5 && bits == 8 && planes == 1) {
    img.mode = MODE_L;
    raw = RAW_L;
    if (f.size() >= 769 + 128 && f[f.size() - 769] == 12) {
      const uint8_t* pal = &f[f.size() - 768];
      for (int i = 0; i < 256 && img.mode == MODE_L; ++i)
        if (pal[3 * i] != i || pal[3 * i + 1] != i || pal[3 * i + 2] != i) img.mode = MODE_P;
      if (img.mode == MODE_P) img.palette.assign(pal, pal + 768);
    }
  } else if (version == 5 && bits == 8 && planes == 3) {
    img.mode = MODE_RGB;
    raw = RAW_RGB;
  } else {
    throw Error("PCX: unknown PCX mode (version " + std::to_string(version) + ", " +
                std::to_string(bits) + " bits, " + std::to_string(planes) + " planes)");
  }
  img.channels = img.mode == MODE_RGB ? 3 : 1;
  img.data.assign(size_t(w) * h * img.channels, 0);
  size_t stride = (size_t(w) * bits + 7) / 8;
  if (le16(&f[66]) != stride) stride += stride % 2;
  const size_t line = stride * size_t(planes);
  std::vector<uint8_t> buf(line);
  size_t pos = 128, x = 0;
  int y = 0;
  while (y < h) {  // PcxDecode.c
    if (pos >= f.size()) throw Error("PCX: truncated image data");
    if ((f[pos] & 0xC0) == 0xC0) {
      if (pos + 1 >= f.size()) throw Error("PCX: truncated image data");
      size_t n = f[pos] & 0x3F;
      if (x + n > line) throw Error("PCX: a run crosses the end of a row");
      std::memset(&buf[x], f[pos + 1], n);
      x += n;
      pos += 2;
    } else {
      buf[x++] = f[pos++];
    }
    if (x < line) continue;
    // PcxDecode.c's band moves: each plane to its unpacker's place
    size_t bands, band = 0, unpacked = size_t(w);
    if (raw == RAW_PLANES) {
      unpacked = (size_t(w) + 7) / 8;
      bands = size_t(planes);
      band = line / bands;
    } else {
      bands = line / size_t(w);
      if (bands) band = line / bands;
    }
    if (band > unpacked)
      for (size_t i = 1; i < bands; ++i) std::memmove(&buf[i * unpacked], &buf[i * band], unpacked);
    uint8_t* d = &img.data[size_t(y) * w * img.channels];
    const size_t plane = (size_t(w) + 7) / 8;
    for (int px = 0; px < w; ++px) {
      if (raw == RAW_1) {
        d[px] = uint8_t((buf[size_t(px) >> 3] >> (7 - (px & 7))) & 1);
      } else if (raw == RAW_PLANES) {  // Unpack.c P;2L / P;4L: one bit from each plane
        int v = 0;
        for (int k = 0; k < planes; ++k)
          v |= ((buf[size_t(k) * plane + (size_t(px) >> 3)] >> (7 - (px & 7))) & 1) << k;
        d[px] = uint8_t(v);
      } else if (raw == RAW_L) {
        d[px] = buf[size_t(px)];
      } else {  // RGB;L: a line each of R, G and B
        for (int k = 0; k < 3; ++k) d[3 * px + k] = buf[size_t(k) * w + size_t(px)];
      }
    }
    x = 0;
    ++y;
  }
  return img;
}

}  // namespace pslx
