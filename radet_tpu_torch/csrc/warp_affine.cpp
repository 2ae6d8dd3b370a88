// Affine warps and the 3x3 dilation of uint8 images on the host, for
// radet_tpu_torch/data/warp.py (loaded with ctypes; built at first use with
// the host C++ compiler and -ffp-contract=off).
//
// radet_tpu/data/auto_augment.py and instaboost.py call cv2.warpAffine and
// cv2.dilate; each function here repeats cv2 5.0's arithmetic, so that its
// output is cv2's byte for byte:
//
// - radet_warp_affine: cv2.warpAffine(src, M, (w, h), flags, BORDER_CONSTANT,
//   fill) with INTER_LINEAR or INTER_NEAREST.  M is inverted in double as
//   cv2 inverts it and rounded to float; each row starts at
//   (y M1 + M2, y M4 + M5) in float (two roundings), and the source point
//   of column x is fmaf(M0, x, row x0), fmaf(M3, x, row y0) over the first
//   w - w % 16 columns (cv2's vector code, 16 pixels a step) and
//   fmaf(x, M0, y M1) + M2, fmaf(x, M3, y M4) + M5 over the rest (its
//   scalar code).  Bilinear:
//   the four neighbours at floor(point), each outside the image taking
//   the fill, blended as fmaf(a, p01 - p00, p00), fmaf(a, p11 - p10, p10),
//   fmaf(b, v1 - v0, v0) and rounded half to even.  Nearest: the point
//   rounded half to even, or the fill outside the image.  The fill is
//   rounded to uint8 first;
// - radet_dilate3x3: cv2.dilate(src, np.ones((3, 3))), the maximum over
//   each pixel's 3x3 neighbours inside the image.
//
// Images are contiguous HWC uint8.  ctypes releases the interpreter lock
// around each call, so loader threads run them in parallel.

#include <cmath>
#include <cstdint>

#if defined(__x86_64__) && defined(__GNUC__)
// fmaf is one instruction with FMA; without it, a call into libm per value.
// The warp is built twice, and the AVX2/FMA build is taken where the CPU
// has it; both builds compute the same floats.
#define RADET_FMA_TARGET __attribute__((target("avx2,fma")))
#define RADET_HAVE_FMA_CLONE 1
#endif

namespace {

#ifdef RADET_HAVE_FMA_CLONE
bool have_avx2_fma() {
  static const bool yes = __builtin_cpu_supports("avx2") && __builtin_cpu_supports("fma");
  return yes;
}
#endif

struct Warp {
  const uint8_t* src;
  uint8_t* dst;
  int64_t h, w, c;
  float m[6];  // the inverse map, dst -> src
  uint8_t fill[4];
};

template <bool nearest, int64_t kChannels>
inline __attribute__((always_inline)) void warp_rows(const Warp& p) {
  const int64_t h = p.h, w = p.w, c = kChannels ? kChannels : p.c;
  const float fw = static_cast<float>(w), fh = static_cast<float>(h);
  const int64_t vector_end = w - w % 16;
  for (int64_t y = 0; y < h; ++y) {
    const float fy = static_cast<float>(y);
    const float x0 = fy * p.m[1] + p.m[2], y0 = fy * p.m[4] + p.m[5];
    const float xy = fy * p.m[1], yy = fy * p.m[4];
    uint8_t* out = p.dst + y * w * c;
    for (int64_t x = 0; x < w; ++x, out += c) {
      const float fx = static_cast<float>(x);
      float sx, sy;
      if (x < vector_end) {
        sx = std::fmaf(p.m[0], fx, x0);
        sy = std::fmaf(p.m[3], fx, y0);
      } else {
        sx = std::fmaf(fx, p.m[0], xy) + p.m[2];
        sy = std::fmaf(fx, p.m[3], yy) + p.m[5];
      }
      if constexpr (nearest) {
        if (!(sx > -1.f && sx < fw + 1.f && sy > -1.f && sy < fh + 1.f)) {
          for (int64_t k = 0; k < c; ++k) out[k] = p.fill[k];
          continue;
        }
        const int64_t ix = static_cast<int64_t>(std::nearbyint(sx)), iy = static_cast<int64_t>(std::nearbyint(sy));
        const bool inside = ix >= 0 && ix < w && iy >= 0 && iy < h;
        for (int64_t k = 0; k < c; ++k) out[k] = inside ? p.src[(iy * w + ix) * c + k] : p.fill[k];
        continue;
      }
      if (!(sx >= -1.f && sx < fw && sy >= -1.f && sy < fh)) {  // all four neighbours outside
        for (int64_t k = 0; k < c; ++k) out[k] = p.fill[k];
        continue;
      }
      const float fx0 = std::floor(sx), fy0 = std::floor(sy);
      const int64_t ix = static_cast<int64_t>(fx0), iy = static_cast<int64_t>(fy0);
      const float a = sx - fx0, b = sy - fy0;
      const bool in_x0 = ix >= 0, in_x1 = ix + 1 < w, in_y0 = iy >= 0, in_y1 = iy + 1 < h;
      if (in_x0 && in_x1 && in_y0 && in_y1) {  // the four neighbours inside: no fill
        const uint8_t* r0 = p.src + (iy * w + ix) * c;
        const uint8_t* r1 = r0 + w * c;
        for (int64_t k = 0; k < c; ++k) {
          const float p00 = r0[k], p01 = r0[c + k], p10 = r1[k], p11 = r1[c + k];
          const float v0 = std::fmaf(a, p01 - p00, p00), v1 = std::fmaf(a, p11 - p10, p10);
          const float v = std::nearbyint(std::fmaf(b, v1 - v0, v0));
          out[k] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
        }
        continue;
      }
      for (int64_t k = 0; k < c; ++k) {
        const float fill = static_cast<float>(p.fill[k]);
        const float p00 = in_y0 && in_x0 ? p.src[(iy * w + ix) * c + k] : fill;
        const float p01 = in_y0 && in_x1 ? p.src[(iy * w + ix + 1) * c + k] : fill;
        const float p10 = in_y1 && in_x0 ? p.src[((iy + 1) * w + ix) * c + k] : fill;
        const float p11 = in_y1 && in_x1 ? p.src[((iy + 1) * w + ix + 1) * c + k] : fill;
        const float v0 = std::fmaf(a, p01 - p00, p00), v1 = std::fmaf(a, p11 - p10, p10);
        const float v = std::nearbyint(std::fmaf(b, v1 - v0, v0));
        out[k] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
    }
  }
}

// the loops specialised for RGB and for one channel, bilinear and nearest
inline __attribute__((always_inline)) void warp_any(const Warp& p, bool nearest) {
  if (nearest) {
    if (p.c == 3) return warp_rows<true, 3>(p);
    if (p.c == 1) return warp_rows<true, 1>(p);
    return warp_rows<true, 0>(p);
  }
  if (p.c == 3) return warp_rows<false, 3>(p);
  if (p.c == 1) return warp_rows<false, 1>(p);
  warp_rows<false, 0>(p);
}

void warp(const Warp& p, bool nearest) { warp_any(p, nearest); }

#ifdef RADET_HAVE_FMA_CLONE
RADET_FMA_TARGET
void warp_fma(const Warp& p, bool nearest) { warp_any(p, nearest); }
#endif

}  // namespace

extern "C" {

// cv2.warpAffine of the (h, w, c) uint8 image `src` into `dst` of the same
// shape: `m` the forward 2x3 matrix (row-major), `fill` c border values,
// `nearest` 1 for INTER_NEAREST, 0 for INTER_LINEAR.  Returns 0, or 1 when
// the arguments are out of range.
int radet_warp_affine(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w, int64_t c, const double* m,
                      const double* fill, int nearest) {
  if (h < 1 || w < 1 || c < 1 || c > 4) return 1;
  double inv[6] = {m[0], m[1], m[2], m[3], m[4], m[5]};
  double d = inv[0] * inv[4] - inv[1] * inv[3];
  d = d != 0 ? 1. / d : 0;
  const double a11 = inv[4] * d, a22 = inv[0] * d;
  inv[0] = a11;
  inv[1] *= -d;
  inv[3] *= -d;
  inv[4] = a22;
  const double b1 = -inv[0] * inv[2] - inv[1] * inv[5];
  const double b2 = -inv[3] * inv[2] - inv[4] * inv[5];
  inv[2] = b1;
  inv[5] = b2;
  Warp p{src, dst, h, w, c, {}, {}};
  for (int k = 0; k < 6; ++k) p.m[k] = static_cast<float>(inv[k]);
  for (int64_t k = 0; k < c; ++k) {
    const double v = std::nearbyint(fill[k]);
    p.fill[k] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) {
    warp_fma(p, nearest != 0);
    return 0;
  }
#endif
  warp(p, nearest != 0);
  return 0;
}

// cv2.dilate(src, np.ones((3, 3), np.uint8)) of an (h, w) uint8 image.
void radet_dilate3x3(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w) {
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x) {
      uint8_t v = 0;
      for (int64_t yy = y > 0 ? y - 1 : 0; yy <= y + 1 && yy < h; ++yy)
        for (int64_t xx = x > 0 ? x - 1 : 0; xx <= x + 1 && xx < w; ++xx)
          if (src[yy * w + xx] > v) v = src[yy * w + xx];
      dst[y * w + x] = v;
    }
}

}  // extern "C"
