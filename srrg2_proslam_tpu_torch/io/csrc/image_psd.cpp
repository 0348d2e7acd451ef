// PSD as PIL 12's PsdImagePlugin reads it: the composite image after the
// colour mode data, image resources and layers, in PIL's modes for the
// colour mode and depth ("1" bitmap, L for gray / duotone / multichannel,
// P with the 768-byte planar colour table, RGB or RGBA (four channels),
// CMYK inverted as PIL's "C;I" raw modes do, LAB with a and b offset by
// 128 as its "A" / "B" band unpackers do), channel planes raw or
// PackBits (PackDecode.c from each channel's start, the byte-count table
// giving only where each channel starts; a run or literal past a row's end
// is cut there).  Refused with a message: 16- and 32-bit files, other
// compressions, truncated data.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {
namespace {

// PackDecode.c from ``at`` until ``rows`` rows of ``rowbytes`` are full
void packbits_rows(const std::vector<uint8_t>& f, size_t at, size_t rowbytes, size_t rows,
                   uint8_t* out) {
  size_t x = 0, y = 0;
  while (y < rows) {
    if (at >= f.size()) throw Error("PSD: truncated image data");
    int c = f[at];
    if (c == 0x80) {
      ++at;
      continue;
    }
    size_t n;
    if (c & 0x80) {
      if (at + 1 >= f.size()) throw Error("PSD: truncated image data");
      n = std::min<size_t>(size_t(257 - c), rowbytes - x);
      std::memset(out + y * rowbytes + x, f[at + 1], n);
      at += 2;
    } else {
      if (at + size_t(c) + 2 > f.size()) throw Error("PSD: truncated image data");
      n = std::min<size_t>(size_t(c) + 1, rowbytes - x);
      std::memcpy(out + y * rowbytes + x, &f[at + 1], n);
      at += size_t(c) + 2;
    }
    x += n;
    if (x >= rowbytes) {
      x = 0;
      ++y;
    }
  }
}

}  // namespace

Image decode_psd(const std::vector<uint8_t>& f) {
  if (f.size() < 26 || std::memcmp(f.data(), "8BPS", 4) || be16(&f[4]) != 1)
    throw Error("not a PSD file");
  const int channels_in = int(be16(&f[12])), bits = int(be16(&f[22])), psd_mode = int(be16(&f[24]));
  const uint32_t h = be32(&f[14]), w = be32(&f[18]);
  Image img;
  int channels;
  if (psd_mode == 0 && bits == 1) {
    img.mode = MODE_1;
    channels = 1;
  } else if (bits == 8 && (psd_mode == 0 || psd_mode == 1 || psd_mode == 7 || psd_mode == 8)) {
    img.mode = MODE_L;
    channels = 1;
  } else if (bits == 8 && psd_mode == 2) {
    img.mode = MODE_P;
    channels = 1;
  } else if (bits == 8 && psd_mode == 3) {
    img.mode = MODE_RGB;
    channels = 3;
  } else if (bits == 8 && psd_mode == 4) {
    img.mode = MODE_CMYK;
    channels = 4;
  } else if (bits == 8 && psd_mode == 9) {
    img.mode = MODE_LAB;
    channels = 3;
  } else {
    throw Error("PSD: colour mode " + std::to_string(psd_mode) + " at " + std::to_string(bits) +
                " bits is not supported");
  }
  if (channels > channels_in) throw Error("PSD: not enough channels");
  if (img.mode == MODE_RGB && channels_in == 4) {
    img.mode = MODE_RGBA;
    channels = 4;
  }
  if (too_many_pixels(w, h)) throw Error("PSD: bad image size");
  img.w = int(w);
  img.h = int(h);
  img.channels = channels;
  size_t pos = 26;
  auto section = [&]() {
    if (pos + 4 > f.size()) throw Error("PSD: truncated file");
    size_t size = be32(&f[pos]);
    pos += 4;
    return size;
  };
  size_t size = section();
  if (img.mode == MODE_P && size == 768) {
    if (pos + 768 > f.size()) throw Error("PSD: truncated file");
    for (int i = 0; i < 256; ++i)
      for (int k = 0; k < 3; ++k) img.palette.push_back(f[pos + size_t(k) * 256 + size_t(i)]);
  }
  pos += size;
  pos += section();  // image resources
  pos += section();  // layers and masks
  if (pos + 2 > f.size()) throw Error("PSD: truncated file");
  const uint32_t compression = be16(&f[pos]);
  pos += 2;
  const size_t rowbytes = img.mode == MODE_1 ? (size_t(w) + 7) / 8 : size_t(w);
  std::vector<uint8_t> planes(size_t(channels) * rowbytes * h);
  if (compression == 0) {
    for (int c = 0; c < channels; ++c) {
      size_t at = pos + size_t(c) * w * h;
      if (at > f.size() || rowbytes * h > f.size() - at) throw Error("PSD: truncated image data");
      std::memcpy(&planes[size_t(c) * rowbytes * h], &f[at], rowbytes * h);
    }
  } else if (compression == 1) {
    const size_t table = size_t(channels) * h * 2;
    if (pos > f.size() || table > f.size() - pos) throw Error("PSD: truncated file");
    size_t at = pos + table;
    for (int c = 0; c < channels; ++c) {
      packbits_rows(f, at, rowbytes, h, &planes[size_t(c) * rowbytes * h]);
      for (uint32_t y = 0; y < h; ++y) at += be16(&f[pos + (size_t(c) * h + y) * 2]);
    }
  } else {
    throw Error("PSD: compression " + std::to_string(compression) + " is not supported");
  }
  img.data.assign(size_t(w) * h * channels, 0);
  for (uint32_t y = 0; y < h; ++y)
    for (uint32_t x = 0; x < w; ++x)
      for (int c = 0; c < channels; ++c) {
        const uint8_t* row = &planes[(size_t(c) * h + y) * rowbytes];
        uint8_t v = img.mode == MODE_1 ? uint8_t((row[x >> 3] >> (7 - (x & 7))) & 1) : row[x];
        if (img.mode == MODE_CMYK) v = uint8_t(255 - v);
        if (img.mode == MODE_LAB && c > 0) v ^= 0x80;  // PIL's "A" / "B" band unpackers
        img.data[(size_t(y) * w + x) * channels + c] = v;
      }
  return img;
}

}  // namespace pslx
