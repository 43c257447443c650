// RGB <-> HSV on float32 pixels, in place, with OpenCV's formulas for
// cv::COLOR_RGB2HSV / cv::COLOR_HSV2RGB on float images (H in degrees).
// Host code for the port's PhotometricDistortion (data/color.py), built
// with g++ at its first use and called through ctypes.
//
// `img` holds `n` interleaved pixels of 3 floats. Built with
// -ffp-contract=off, every operation rounds as its numpy twin in
// data/color.py does, so the two give the same bits (tests hold them so).

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

// For each hue sector, which of tab = (v, v(1-s), v(1-sf), v(1-s(1-f)))
// is b, g and r (OpenCV's sector_data).
const int kSectorBgr[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1},
                              {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};

}  // namespace

extern "C" void rgb_to_hsv_f32(float* img, int64_t n) {
  for (int64_t i = 0; i < n; ++i, img += 3) {
    const float r = img[0], g = img[1], b = img[2];
    float v = r, vmin = r;
    if (v < g) v = g;
    if (v < b) v = b;
    if (vmin > g) vmin = g;
    if (vmin > b) vmin = b;
    const float diff = v - vmin;
    const float s = diff / (std::fabs(v) + FLT_EPSILON);
    const float scale = 60.f / (diff + FLT_EPSILON);
    float h;
    if (v == r)
      h = (g - b) * scale + 0.f;
    else if (v == g)
      h = (b - r) * scale + 120.f;
    else
      h = (r - g) * scale + 240.f;
    if (h < 0) h += 360.f;
    img[0] = h;
    img[1] = s;
    img[2] = v;
  }
}

extern "C" void hsv_to_rgb_f32(float* img, int64_t n) {
  const float hscale = 6.f / 360.f;
  for (int64_t i = 0; i < n; ++i, img += 3) {
    const float s = img[1], v = img[2];
    float h = std::fmod(img[0] * hscale, 6.f);
    if (h < 0) h += 6.f;
    const float floor_h = std::floor(h);
    int sector = static_cast<int>(floor_h);
    h -= floor_h;
    if (static_cast<unsigned>(sector) >= 6u) {
      sector = 0;
      h = 0.f;
    }
    const float tab[4] = {v, v * (1.f - s), v * (1.f - s * h),
                          v * (1.f - s * (1.f - h))};
    img[0] = tab[kSectorBgr[sector][2]];
    img[1] = tab[kSectorBgr[sector][1]];
    img[2] = tab[kSectorBgr[sector][0]];
  }
}
