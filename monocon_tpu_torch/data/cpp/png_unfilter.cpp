// Undo the PNG row filters (PNG specification, section 9) of an image with
// 8-bit samples. Host code for the port's PNG reader (data/png.py), built
// with g++ at its first use and called through ctypes.
//
// src holds `height` rows of 1 + `stride` bytes: a filter type byte, then
// the filtered row. dst receives `height` rows of `stride` bytes. `bpp` is
// the number of bytes per pixel (3 for RGB, 4 for RGBA).
//
// Returns 0, or 1 + the index of the first row whose filter type is not
// one of 0 (None), 1 (Sub), 2 (Up), 3 (Average), 4 (Paeth).

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

// The Paeth predictor of the specification, with its three distances
// written from a (left), b (up) and c (up-left) directly.
inline int paeth(int a, int b, int c) {
  const int pa = std::abs(b - c);
  const int pb = std::abs(a - c);
  const int pc = std::abs(a + b - 2 * c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

}  // namespace

extern "C" int64_t png_unfilter(const uint8_t* src, uint8_t* dst,
                                int64_t height, int64_t stride, int64_t bpp) {
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t filter = src[y * (stride + 1)];
    const uint8_t* in = src + y * (stride + 1) + 1;
    uint8_t* out = dst + y * stride;
    // The row above; the first row has a row of zeros above it, where Up
    // is None, and Average and Paeth predict from the left alone.
    const uint8_t* up = y > 0 ? out - stride : nullptr;
    const int64_t head = bpp < stride ? bpp : stride;  // no pixel to the left
    switch (filter) {
      case 0:
        std::memcpy(out, in, stride);
        break;
      case 1:
        for (int64_t i = 0; i < head; ++i) out[i] = in[i];
        for (int64_t i = bpp; i < stride; ++i)
          out[i] = static_cast<uint8_t>(in[i] + out[i - bpp]);
        break;
      case 2:
        if (up == nullptr) {
          std::memcpy(out, in, stride);
        } else {
          for (int64_t i = 0; i < stride; ++i)
            out[i] = static_cast<uint8_t>(in[i] + up[i]);
        }
        break;
      case 3:
        if (up == nullptr) {
          for (int64_t i = 0; i < head; ++i) out[i] = in[i];
          for (int64_t i = bpp; i < stride; ++i)
            out[i] = static_cast<uint8_t>(in[i] + (out[i - bpp] >> 1));
        } else {
          for (int64_t i = 0; i < head; ++i)
            out[i] = static_cast<uint8_t>(in[i] + (up[i] >> 1));
          for (int64_t i = bpp; i < stride; ++i)
            out[i] = static_cast<uint8_t>(in[i] + ((out[i - bpp] + up[i]) >> 1));
        }
        break;
      case 4:
        if (up == nullptr) {  // Paeth(a, 0, 0) = a: as Sub
          for (int64_t i = 0; i < head; ++i) out[i] = in[i];
          for (int64_t i = bpp; i < stride; ++i)
            out[i] = static_cast<uint8_t>(in[i] + out[i - bpp]);
        } else {  // Paeth(0, b, 0) = b at the left edge
          for (int64_t i = 0; i < head; ++i)
            out[i] = static_cast<uint8_t>(in[i] + up[i]);
          for (int64_t i = bpp; i < stride; ++i)
            out[i] = static_cast<uint8_t>(
                in[i] + paeth(out[i - bpp], up[i], up[i - bpp]));
        }
        break;
      default:
        return y + 1;
    }
  }
  return 0;
}
