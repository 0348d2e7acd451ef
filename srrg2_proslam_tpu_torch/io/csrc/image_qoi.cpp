// QOI as PIL 12's QoiImagePlugin decodes it (a Python decoder): RGB or RGBA
// by the channel byte; QOI_OP_RGB / RGBA / INDEX / DIFF / LUMA / RUN from
// the previous pixel (0, 0, 0, 255 at first) and the 64-entry index of
// seen pixels (missing entries 0, 0, 0, 0); a run repeats the previous
// pixel without touching the index; the end marker is not read.

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "image_common.h"

namespace pslx {

Image decode_qoi(const std::vector<uint8_t>& f) {
  if (f.size() < 14 || std::memcmp(f.data(), "qoif", 4)) throw Error("not a QOI file");
  const uint32_t w = be32(&f[4]), h = be32(&f[8]);
  if (too_many_pixels(w, h)) throw Error("QOI: bad image size");
  Image img;
  img.w = int(w);
  img.h = int(h);
  img.channels = f[12] == 3 ? 3 : 4;
  img.mode = img.channels == 3 ? MODE_RGB : MODE_RGBA;
  const size_t total = size_t(w) * h;
  img.data.assign(total * img.channels, 0);
  uint8_t prev[4] = {0, 0, 0, 255}, seen[64][4];
  bool known[64] = {};
  size_t pos = 14, px = 0;
  auto need = [&](size_t n) {
    if (pos + n > f.size()) throw Error("QOI: truncated image data");
  };
  auto put = [&](const uint8_t* v) {
    if (px < total) std::memcpy(&img.data[px * img.channels], v, size_t(img.channels));
    ++px;
  };
  while (px < total) {
    need(1);
    const int op = f[pos++];
    uint8_t v[4];
    if (op == 0xFE) {
      need(3);
      std::memcpy(v, &f[pos], 3);
      v[3] = prev[3];
      pos += 3;
    } else if (op == 0xFF) {
      need(4);
      std::memcpy(v, &f[pos], 4);
      pos += 4;
    } else if ((op >> 6) == 0) {
      if (known[op & 63]) std::memcpy(v, seen[op & 63], 4);
      else std::memset(v, 0, 4);
    } else if ((op >> 6) == 1) {
      v[0] = uint8_t(prev[0] + ((op >> 4) & 3) - 2);
      v[1] = uint8_t(prev[1] + ((op >> 2) & 3) - 2);
      v[2] = uint8_t(prev[2] + (op & 3) - 2);
      v[3] = prev[3];
    } else if ((op >> 6) == 2) {
      need(1);
      const int second = f[pos++], dg = (op & 63) - 32;
      v[0] = uint8_t(prev[0] + dg + ((second >> 4) & 15) - 8);
      v[1] = uint8_t(prev[1] + dg);
      v[2] = uint8_t(prev[2] + dg + (second & 15) - 8);
      v[3] = prev[3];
    } else {  // a run of the previous pixel
      for (int k = (op & 63) + 1; k > 0; --k) put(prev);
      continue;
    }
    std::memcpy(prev, v, 4);
    const int hash = (v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64;
    std::memcpy(seen[hash], v, 4);
    known[hash] = true;
    put(v);
  }
  return img;
}

}  // namespace pslx
