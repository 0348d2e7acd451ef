// Shared by the second image library's sources: the decoded image in the
// mode PIL opens the file in, the error every decoder throws, and byte
// readers.
#pragma once

#include <cstddef>
#include <cstdint>
#include <stdexcept>
#include <vector>

namespace pslx {

struct Error : std::runtime_error {
  using std::runtime_error::runtime_error;
};

// PIL's modes; the codes are the library's interface (io/images.py MODES).
enum Mode { MODE_1 = 0, MODE_L = 1, MODE_P = 2, MODE_I16 = 3, MODE_LA = 4, MODE_RGB = 5,
            MODE_RGBA = 6, MODE_I16B = 7, MODE_I = 8, MODE_F = 9, MODE_CMYK = 10,
            MODE_LAB = 11 };

struct Image {
  int w = 0, h = 0, channels = 1, bitdepth = 8, mode = MODE_L;
  std::vector<uint8_t> data;     // interleaved, host order (int32 for I, float32 for F)
  std::vector<uint8_t> palette;  // RGB triples (mode P)
};

// PIL raises DecompressionBombError above twice Image.MAX_IMAGE_PIXELS.
constexpr uint64_t kMaxPixels = 178956970;
inline bool too_many_pixels(uint64_t w, uint64_t h) {
  return w > kMaxPixels || h > kMaxPixels || w * h > kMaxPixels;
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) { return (be16(p) << 16) | be16(p + 2); }
inline uint32_t le16(const uint8_t* p) { return uint32_t(p[0]) | (uint32_t(p[1]) << 8); }
inline uint32_t le32(const uint8_t* p) { return le16(p) | (le16(p + 2) << 16); }

// decode_jpeg's colour handling: the JPEG's own (markers and component
// ids, as libjpeg guesses it), none (libtiff's JCS_UNKNOWN: the components
// as they are), or YCbCr -> RGB (libtiff's JPEGCOLORMODE_RGB).
enum JpegColor { JPEG_AS_MARKED = -1, JPEG_NO_CONVERSION = 0, JPEG_YCC = 1 };

std::vector<uint8_t> read_file(const char* path);
Image decode_jpeg(const std::vector<uint8_t>& file, int color = JPEG_AS_MARKED);
Image decode_tiff(const std::vector<uint8_t>& file);
std::vector<uint8_t> decode_ccitt(const uint8_t* p, size_t n, int width, int rows,
                                  int compression, uint32_t t4_options);
Image decode_tga(const std::vector<uint8_t>& file);
bool tga_header_valid(const std::vector<uint8_t>& file);
Image decode_sgi(const std::vector<uint8_t>& file);
Image decode_pcx(const std::vector<uint8_t>& file);
Image decode_dds(const std::vector<uint8_t>& file);
Image decode_psd(const std::vector<uint8_t>& file);
Image decode_ico(const std::vector<uint8_t>& file);
Image decode_cur(const std::vector<uint8_t>& file);
Image decode_qoi(const std::vector<uint8_t>& file);
bool im_header(const std::vector<uint8_t>& file);
Image decode_im(const std::vector<uint8_t>& file);
Image decode_sun(const std::vector<uint8_t>& file);
Image decode_msp(const std::vector<uint8_t>& file);
Image decode_xbm(const std::vector<uint8_t>& file);
Image decode_xpm(const std::vector<uint8_t>& file);
bool spider_header(const std::vector<uint8_t>& file);
Image decode_spider(const std::vector<uint8_t>& file);
Image decode_webp(const std::vector<uint8_t>& file);
std::vector<uint8_t> decode_xz(const uint8_t* d, size_t n, size_t want);
std::vector<uint8_t> decode_zstd(const uint8_t* d, size_t n, size_t want);
Image decode_j2k(const std::vector<uint8_t>& file);
Image decode_bmp_image(const std::vector<uint8_t>& file);
Image decode_png_image(const std::vector<uint8_t>& file);
Image decode_gif(const std::vector<uint8_t>& file);
Image decode_pnm(const std::vector<uint8_t>& file);
std::vector<uint8_t> encode_gif_gray(const uint8_t* px, int w, int h);

}  // namespace pslx
