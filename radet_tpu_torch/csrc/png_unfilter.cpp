// PNG row unfiltering on the host, for radet_tpu_torch/data/image_io.py
// (loaded with ctypes; built at first use with the host C++ compiler).
//
// The five filter types of the PNG specification (section 9.2): None, Sub,
// Up, Average, Paeth.  Average and Paeth predict each byte from the byte one
// pixel to its left, so a row is a sequential recurrence that numpy cannot
// vectorize; the plain twin, image_io.unfilter_plain, loops over pixels in
// Python and takes on the order of a second per 640x480 RGB image.  Here one
// pass over the bytes does it.
//
// radet_tpu/data/pipeline.py::imread_rgb reaches libpng through cv2.imread;
// this file replaces the unfiltering part of that decode.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline uint8_t paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return static_cast<uint8_t>(a);
  return static_cast<uint8_t>(pb <= pc ? b : c);
}

}  // namespace

extern "C" {

// `raw` holds `height` rows of one filter-type byte followed by `stride`
// filtered bytes; the unfiltered rows (height * stride bytes) go to `out`.
// `bpp` is the filter's byte distance: the bytes of one pixel, at least 1.
// Returns 0, or 1 + the index of the first row whose filter type is not 0-4.
int radet_png_unfilter(const uint8_t* raw, int64_t height, int64_t stride, int bpp,
                       uint8_t* out) {
  const int64_t lead = bpp < stride ? bpp : stride;  // bytes with no left neighbour
  for (int64_t y = 0; y < height; ++y) {
    const uint8_t* src = raw + y * (stride + 1) + 1;
    uint8_t* cur = out + y * stride;
    const uint8_t* up = y ? cur - stride : nullptr;  // the row above the first is zeros
    switch (raw[y * (stride + 1)]) {
      case 0:
        std::memcpy(cur, src, stride);
        break;
      case 1:
        for (int64_t x = 0; x < lead; ++x) cur[x] = src[x];
        for (int64_t x = lead; x < stride; ++x) cur[x] = src[x] + cur[x - bpp];
        break;
      case 2:
        if (up) {
          for (int64_t x = 0; x < stride; ++x) cur[x] = src[x] + up[x];
        } else {
          std::memcpy(cur, src, stride);
        }
        break;
      case 3:
        if (up) {
          for (int64_t x = 0; x < lead; ++x) cur[x] = src[x] + (up[x] >> 1);
          for (int64_t x = lead; x < stride; ++x) cur[x] = src[x] + ((cur[x - bpp] + up[x]) >> 1);
        } else {
          for (int64_t x = 0; x < lead; ++x) cur[x] = src[x];
          for (int64_t x = lead; x < stride; ++x) cur[x] = src[x] + (cur[x - bpp] >> 1);
        }
        break;
      case 4:
        if (up) {
          for (int64_t x = 0; x < lead; ++x) cur[x] = src[x] + up[x];  // paeth(0, b, 0) = b
          for (int64_t x = lead; x < stride; ++x)
            cur[x] = src[x] + paeth(cur[x - bpp], up[x], up[x - bpp]);
        } else {  // paeth(a, 0, 0) = a: Sub
          for (int64_t x = 0; x < lead; ++x) cur[x] = src[x];
          for (int64_t x = lead; x < stride; ++x) cur[x] = src[x] + cur[x - bpp];
        }
        break;
      default:
        return static_cast<int>(y + 1);
    }
  }
  return 0;
}

}  // extern "C"
