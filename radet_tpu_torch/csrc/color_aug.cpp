// CosyPoseAug's image operations on the host, for
// radet_tpu_torch/data/color_aug.py (loaded with ctypes; built at first use
// with the host C++ compiler and -ffp-contract=off).
//
// radet_tpu/data/pipeline.py runs these through cv2 on uint8 images; each
// function here repeats cv2's integer or float32 arithmetic so that its
// output is cv2's, byte for byte:
//
// - radet_gaussian_blur: cv2.GaussianBlur on uint8 is a fixed-point
//   separable filter.  With integer taps kq summing to 256 (taken from cv2),
//   out = min(255, (sum_i kq[i] * sum_j kq[j] * x[y+i, x+j] + 2^15) >> 16),
//   exact in 32-bit integers, with BORDER_REFLECT_101 padding;
// - radet_smooth3x3: PIL's SMOOTH filter [[1,1,1],[1,5,1],[1,1,1]] / 13 on
//   the interior, rounded to nearest (a sum over 13 never ties), and the
//   1-px border copied from the source;
// - radet_add_weighted: cv2.addWeighted(a, alpha, b, beta, 0) on uint8,
//   rint(fmaf(a, alpha, b * beta)) in float32, rounded half to even and
//   saturated; `b` is either an image or a single channel broadcast over
//   the channels (the gray of PIL's Color);
// - radet_lut: cv2.LUT with one 256-entry table for every channel;
// - radet_pil_gray: PIL's mode-'L' conversion,
//   (R * 19595 + G * 38470 + B * 7471 + 2^15) >> 16;
// - radet_rgb_to_gray: cv2's fixed-point gray of RGB pixels at `shift`
//   fractional bits, (R * cR + G * cG + B * cB + 2^(shift-1)) >> shift with
//   cR = round(0.299 * 2^shift), cG = round(0.587 * 2^shift) and
//   cB = 2^shift - cR - cG: shift 15 is cv2.cvtColor(COLOR_RGB2GRAY) in
//   cv2 5.0, shift 14 the gray cv2.imread makes of a colour TIFF;
// - radet_rgb_to_hsv_f32, radet_hsv_to_rgb_f32: cv2.cvtColor(COLOR_RGB2HSV)
//   and (COLOR_HSV2RGB) on float32 images (PhotoMetricDistortion's), in
//   OpenCV's float arithmetic: its 8-pixel vector code over the first
//   w - w % 8 pixels of a row and its scalar code over the rest, with the
//   multiply-adds its build fuses taken as fmaf (see each function);
// - radet_rgb_to_hsv_u8, radet_hsv_to_rgb_u8: cv2.cvtColor(COLOR_RGB2HSV)
//   and (COLOR_HSV2RGB) on uint8 images, H in [0, 180) (RandomHSV's and
//   InstaBoost's): the forward conversion in cv2's fixed point (12-bit
//   division tables), the backward one in float32, 255 x truncated in
//   cv2's vector code and rounded in its scalar tail (see each function);
// - radet_box_blur: cv2.blur(img, (k, k)) on uint8, the k x k sum over a
//   BORDER_REFLECT_101 padding divided by k * k and rounded (k odd, so no
//   sum lies halfway).
//
// Images are contiguous HWC uint8.  ctypes releases the interpreter lock
// around each call, so loader threads run them in parallel.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__x86_64__) && defined(__GNUC__)
// fmaf is one instruction with FMA; without it, a call into libm per value.
// The blend and the blur are built twice, and the AVX2/FMA build is taken
// where the CPU has it; both builds compute the same integers and floats.
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

// BORDER_REFLECT_101 of index i into [0, n): ... 2 1 | 0 1 2 ... n-1 | n-2 ...
inline int64_t reflect101(int64_t i, int64_t n) {
  if (n == 1) return 0;
  const int64_t period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

inline __attribute__((always_inline)) void blur_rows(const uint8_t* src, uint16_t* tmp, int64_t h, int64_t w, int64_t c, const int32_t* taps,
               int ntaps) {
  // horizontal pass into tmp: sum_j kq[j] * x <= 255 * 256, exact in 16 bits
  const int64_t r = ntaps / 2;
  const int64_t row = w * c;
  std::vector<uint16_t> padded((w + 2 * r) * c);
  std::vector<int64_t> col(w + 2 * r);
  for (int64_t x = 0; x < w + 2 * r; ++x) col[x] = reflect101(x - r, w);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * row;
    for (int64_t x = 0; x < w + 2 * r; ++x)
      for (int64_t k = 0; k < c; ++k) padded[x * c + k] = s[col[x] * c + k];
    uint16_t* out = tmp + y * row;
    for (int64_t i = 0; i < row; ++i) out[i] = 0;
    for (int j = 0; j < ntaps; ++j) {
      const uint16_t kq = static_cast<uint16_t>(taps[j]);
      if (!kq) continue;
      const uint16_t* p = padded.data() + j * c;
      for (int64_t i = 0; i < row; ++i) out[i] = static_cast<uint16_t>(out[i] + kq * p[i]);
    }
  }
}

inline __attribute__((always_inline)) void blur_cols(const uint16_t* tmp, uint8_t* dst, int64_t h, int64_t w, int64_t c, const int32_t* taps,
               int ntaps) {
  // vertical pass: sum_i kq[i] * tmp <= 255 * 256 * 256, exact in 32 bits
  const int64_t r = ntaps / 2;
  const int64_t row = w * c;
  std::vector<uint32_t> acc(row);
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t i = 0; i < row; ++i) acc[i] = 0;
    for (int k = 0; k < ntaps; ++k) {
      const uint32_t kq = static_cast<uint32_t>(taps[k]);
      if (!kq) continue;
      const uint16_t* t = tmp + reflect101(y + k - r, h) * row;
      for (int64_t i = 0; i < row; ++i) acc[i] += kq * t[i];
    }
    uint8_t* out = dst + y * row;
    for (int64_t i = 0; i < row; ++i) {
      const uint32_t v = (acc[i] + (1u << 15)) >> 16;
      out[i] = static_cast<uint8_t>(v > 255 ? 255 : v);
    }
  }
}

void blur(const uint8_t* src, uint16_t* tmp, uint8_t* dst, int64_t h, int64_t w, int64_t c, const int32_t* taps,
          int ntaps) {
  blur_rows(src, tmp, h, w, c, taps, ntaps);
  blur_cols(tmp, dst, h, w, c, taps, ntaps);
}

#ifdef RADET_HAVE_FMA_CLONE
RADET_FMA_TARGET
void blur_avx2(const uint8_t* src, uint16_t* tmp, uint8_t* dst, int64_t h, int64_t w, int64_t c,
               const int32_t* taps, int ntaps) {
  blur_rows(src, tmp, h, w, c, taps, ntaps);
  blur_cols(tmp, dst, h, w, c, taps, ntaps);
}
#endif

// a and b of n values each
inline __attribute__((always_inline)) void add_weighted_body(const uint8_t* a, const uint8_t* b, uint8_t* dst,
                                                             int64_t n, float alpha, float beta) {
  for (int64_t i = 0; i < n; ++i) {
    const float v = std::rint(std::fmaf(static_cast<float>(a[i]), alpha, static_cast<float>(b[i]) * beta));
    dst[i] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
  }
}

void add_weighted(const uint8_t* a, const uint8_t* b, uint8_t* dst, int64_t n, float alpha, float beta) {
  add_weighted_body(a, b, dst, n, alpha, beta);
}

#ifdef RADET_HAVE_FMA_CLONE
RADET_FMA_TARGET
void add_weighted_fma(const uint8_t* a, const uint8_t* b, uint8_t* dst, int64_t n, float alpha, float beta) {
  add_weighted_body(a, b, dst, n, alpha, beta);
}
#endif

// RGB -> HSV of one row of w pixels: V = max, S = (V - min) / (|V| + eps),
// H = fmaf(d, 60 / (V - min + eps), base) with d and base by the maximum's
// channel (R: g - b and 0, or 360 in the vector code where g < b; G: b - r
// and 120; B: r - g and 240), the scalar tail adding 360 to a negative H.
inline __attribute__((always_inline)) void rgb_to_hsv_row(const float* src, float* dst, int64_t w) {
  const int64_t vector_end = w - w % 8;
  for (int64_t x = 0; x < w; ++x) {
    const float r = src[3 * x], g = src[3 * x + 1], b = src[3 * x + 2];
    float v = r, lo = r;
    if (v < g) v = g;
    if (v < b) v = b;
    if (lo > g) lo = g;
    if (lo > b) lo = b;
    const float diff = v - lo;
    const bool r_max = r == v, g_max = !r_max && g == v, vector = x < vector_end;
    const float d = r_max ? g - b : (g_max ? b - r : r - g);
    const float base = r_max ? (vector && g < b ? 360.f : 0.f) : (g_max ? 120.f : 240.f);
    float hue = std::fmaf(d, 60.f / (diff + FLT_EPSILON), base);
    if (!vector && hue < 0.f) hue += 360.f;
    dst[3 * x] = hue;
    dst[3 * x + 1] = diff / (std::fabs(v) + FLT_EPSILON);
    dst[3 * x + 2] = v;
  }
}

// HSV (H in degrees) -> RGB of n pixels: h = H * (6 / 360), sector
// trunc(h) mod 6, f = h - trunc(h), and the tab v, v (1 - s),
// v fmaf(-s, f, 1), v fmaf(-s, 1 - f, 1) picked by sector.
inline __attribute__((always_inline)) void hsv_to_rgb_body(const float* src, float* dst, int64_t n) {
  // (b, g, r) entries of the tab per sector, OpenCV's table
  static const int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 360.f, sixth = 1.f / 6.f;
  for (int64_t i = 0; i < n; ++i) {
    const float h = src[3 * i] * hscale, s = src[3 * i + 1], v = src[3 * i + 2];
    const float whole = std::trunc(h), f = h - whole;
    const float tab[4] = {v, v * (1.f - s), v * std::fmaf(-s, f, 1.f), v * std::fmaf(-s, 1.f - f, 1.f)};
    int sector = static_cast<int>(whole - std::trunc(whole * sixth) * 6.f);
    if (sector < 0 || sector >= 6) sector = 0;
    dst[3 * i] = tab[kSectors[sector][2]];
    dst[3 * i + 1] = tab[kSectors[sector][1]];
    dst[3 * i + 2] = tab[kSectors[sector][0]];
  }
}

void rgb_to_hsv(const float* src, float* dst, int64_t h, int64_t w) {
  for (int64_t y = 0; y < h; ++y) rgb_to_hsv_row(src + 3 * y * w, dst + 3 * y * w, w);
}

void hsv_to_rgb(const float* src, float* dst, int64_t n) { hsv_to_rgb_body(src, dst, n); }

#ifdef RADET_HAVE_FMA_CLONE
RADET_FMA_TARGET
void rgb_to_hsv_fma(const float* src, float* dst, int64_t h, int64_t w) {
  for (int64_t y = 0; y < h; ++y) rgb_to_hsv_row(src + 3 * y * w, dst + 3 * y * w, w);
}

RADET_FMA_TARGET
void hsv_to_rgb_fma(const float* src, float* dst, int64_t n) { hsv_to_rgb_body(src, dst, n); }
#endif

// HSV (uint8, H in [0, 180)) -> RGB of one row of w pixels: s and v
// scaled by float(1 / 255), h = H * (6 / 180), sector floor(h) mod 6,
// f = h - floor(h), the tab v, v (1 - s), v fmaf(-s, f, 1),
// v fmaf(-s, 1 - f, 1) picked by sector, and each channel 255 x truncated
// over the first w - w % 32 pixels (cv2's vector code, 32 pixels a step)
// and rounded over the rest (its scalar code).
inline __attribute__((always_inline)) void hsv_to_rgb_u8_row(const uint8_t* src, uint8_t* dst, int64_t w) {
  static const int kSectors[6][3] = {{1, 3, 0}, {1, 0, 2}, {3, 0, 1}, {0, 2, 1}, {0, 1, 3}, {2, 1, 0}};
  const float hscale = 6.f / 180.f, inv255 = 1.f / 255.f;
  const int64_t vector_end = w - w % 32;
  for (int64_t i = 0; i < w; ++i) {
    const float h = static_cast<float>(src[3 * i]) * hscale;
    const float s = static_cast<float>(src[3 * i + 1]) * inv255, v = static_cast<float>(src[3 * i + 2]) * inv255;
    const float whole = std::floor(h), f = h - whole;
    const float tab[4] = {v, v * (1.f - s), v * std::fmaf(-s, f, 1.f), v * std::fmaf(-s, 1.f - f, 1.f)};
    const int sector = static_cast<int>(whole) % 6;
    for (int k = 0; k < 3; ++k) {
      float x = tab[kSectors[sector][2 - k]] * 255.f;
      x = i < vector_end ? std::trunc(x) : std::nearbyint(x);
      dst[3 * i + k] = static_cast<uint8_t>(x > 255.f ? 255.f : x);
    }
  }
}

void hsv_to_rgb_u8(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w) {
  for (int64_t y = 0; y < h; ++y) hsv_to_rgb_u8_row(src + 3 * y * w, dst + 3 * y * w, w);
}

#ifdef RADET_HAVE_FMA_CLONE
RADET_FMA_TARGET
void hsv_to_rgb_u8_fma(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w) {
  for (int64_t y = 0; y < h; ++y) hsv_to_rgb_u8_row(src + 3 * y * w, dst + 3 * y * w, w);
}
#endif

}  // namespace

extern "C" {

// `src` and `dst` (h, w, c) uint8, distinct; `taps` the ntaps (odd)
// integer taps summing to 256, each below 256.  Returns 0, or 1 when the
// arguments are out of range.
int radet_gaussian_blur(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w, int64_t c,
                        const int32_t* taps, int ntaps) {
  if (h < 1 || w < 1 || c < 1 || ntaps < 1 || !(ntaps & 1)) return 1;
  for (int j = 0; j < ntaps; ++j)
    if (taps[j] < 0 || taps[j] > 255) return 1;
  std::vector<uint16_t> tmp(h * w * c);
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) {
    blur_avx2(src, tmp.data(), dst, h, w, c, taps, ntaps);
    return 0;
  }
#endif
  blur(src, tmp.data(), dst, h, w, c, taps, ntaps);
  return 0;
}

// PIL's SMOOTH on the interior of (h, w, c) `src` into `dst`, the 1-px
// border copied: (sum of the 8 neighbours + 5 * centre) / 13, to nearest.
void radet_smooth3x3(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w, int64_t c) {
  const int64_t row = w * c;
  std::memcpy(dst, src, static_cast<size_t>(h * row));
  for (int64_t y = 1; y + 1 < h; ++y) {
    const uint8_t* up = src + (y - 1) * row;
    const uint8_t* mid = src + y * row;
    const uint8_t* down = src + (y + 1) * row;
    uint8_t* out = dst + y * row;
    for (int64_t i = c; i < row - c; ++i) {
      const int s = up[i - c] + up[i] + up[i + c] + mid[i - c] + 5 * mid[i] + mid[i + c] + down[i - c] +
                    down[i] + down[i + c];
      out[i] = static_cast<uint8_t>((2 * s + 13) / 26);
    }
  }
}

// cv2.addWeighted(a, alpha, b, beta, 0) on `pixels` pixels of `c` channels;
// `b_step` is c (b an image like a) or 1 (b one channel, used for every
// channel of a pixel).
void radet_add_weighted(const uint8_t* a, const uint8_t* b, uint8_t* dst, int64_t pixels, int64_t c,
                        int64_t b_step, float alpha, float beta) {
  const int64_t n = pixels * c;
  std::vector<uint8_t> spread;
  if (b_step == 1 && c > 1) {  // one channel: repeat it over the channels
    spread.resize(n);
    for (int64_t p = 0; p < pixels; ++p)
      for (int64_t k = 0; k < c; ++k) spread[p * c + k] = b[p];
    b = spread.data();
  }
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) return add_weighted_fma(a, b, dst, n, alpha, beta);
#endif
  add_weighted(a, b, dst, n, alpha, beta);
}

void radet_lut(const uint8_t* src, uint8_t* dst, int64_t n, const uint8_t* lut) {
  for (int64_t i = 0; i < n; ++i) dst[i] = lut[src[i]];
}

// PIL's mode-'L' of `pixels` RGB pixels.
void radet_pil_gray(const uint8_t* rgb, uint8_t* gray, int64_t pixels) {
  for (int64_t p = 0; p < pixels; ++p) {
    const uint32_t v = rgb[3 * p] * 19595u + rgb[3 * p + 1] * 38470u + rgb[3 * p + 2] * 7471u + 0x8000u;
    gray[p] = static_cast<uint8_t>(v >> 16);
  }
}

// cv2's gray of `pixels` pixels of `step` bytes each (R, G, B first).
void radet_rgb_to_gray(const uint8_t* rgb, uint8_t* gray, int64_t pixels, int64_t step, int shift) {
  const double one = static_cast<double>(1 << shift);
  const uint32_t cr = static_cast<uint32_t>(0.299 * one + 0.5);
  const uint32_t cg = static_cast<uint32_t>(0.587 * one + 0.5);
  const uint32_t cb = (1u << shift) - cr - cg;
  const uint32_t half = 1u << (shift - 1);
  for (int64_t p = 0; p < pixels; ++p) {
    const uint8_t* px = rgb + p * step;
    gray[p] = static_cast<uint8_t>((px[0] * cr + px[1] * cg + px[2] * cb + half) >> shift);
  }
}

// cv2.cvtColor(src, COLOR_RGB2HSV) of an (h, w, 3) float32 image.
void radet_rgb_to_hsv_f32(const float* src, float* dst, int64_t h, int64_t w) {
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) return rgb_to_hsv_fma(src, dst, h, w);
#endif
  rgb_to_hsv(src, dst, h, w);
}

// cv2.cvtColor(src, COLOR_HSV2RGB) of `pixels` float32 HSV pixels.
void radet_hsv_to_rgb_f32(const float* src, float* dst, int64_t pixels) {
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) return hsv_to_rgb_fma(src, dst, pixels);
#endif
  hsv_to_rgb(src, dst, pixels);
}

// cv2.cvtColor(src, COLOR_RGB2HSV) of `pixels` uint8 RGB pixels: V = max,
// S = (diff * sdiv[V] + 2^11) >> 12 and H = (h * hdiv[diff] + 2^11) >> 12
// (+180 when negative) with diff = V - min, h = g - b, b - r + 2 diff or
// r - g + 4 diff by the maximum's channel (R, then G, then B), and the
// tables sdiv[x] = round(255 * 2^12 / x), hdiv[x] = round(180 * 2^12 / (6 x)).
void radet_rgb_to_hsv_u8(const uint8_t* src, uint8_t* dst, int64_t pixels) {
  constexpr int kShift = 12;
  static const struct Tables {
    int sdiv[256], hdiv[256];
    Tables() {
      sdiv[0] = hdiv[0] = 0;
      for (int i = 1; i < 256; ++i) {
        sdiv[i] = static_cast<int>(std::nearbyint((255 << kShift) / (1. * i)));
        hdiv[i] = static_cast<int>(std::nearbyint((180 << kShift) / (6. * i)));
      }
    }
  } tables;
  for (int64_t p = 0; p < pixels; ++p) {
    const int r = src[3 * p], g = src[3 * p + 1], b = src[3 * p + 2];
    int v = b, lo = b;
    if (v < g) v = g;
    if (v < r) v = r;
    if (lo > g) lo = g;
    if (lo > r) lo = r;
    const int diff = v - lo;
    const int s = (diff * tables.sdiv[v] + (1 << (kShift - 1))) >> kShift;
    int h = v == r ? g - b : (v == g ? b - r + 2 * diff : r - g + 4 * diff);
    h = (h * tables.hdiv[diff] + (1 << (kShift - 1))) >> kShift;
    if (h < 0) h += 180;
    dst[3 * p] = static_cast<uint8_t>(h > 255 ? 255 : h);
    dst[3 * p + 1] = static_cast<uint8_t>(s);
    dst[3 * p + 2] = static_cast<uint8_t>(v);
  }
}

// cv2.cvtColor(src, COLOR_HSV2RGB) of an (h, w, 3) uint8 HSV image.
void radet_hsv_to_rgb_u8(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w) {
#ifdef RADET_HAVE_FMA_CLONE
  if (have_avx2_fma()) return hsv_to_rgb_u8_fma(src, dst, h, w);
#endif
  hsv_to_rgb_u8(src, dst, h, w);
}

// cv2.blur(src, (k, k)) of an (h, w, c) uint8 image, k odd: the k x k sum
// over a BORDER_REFLECT_101 padding, (sum + k^2 / 2) / k^2.  Returns 0, or
// 1 when the arguments are out of range.
int radet_box_blur(const uint8_t* src, uint8_t* dst, int64_t h, int64_t w, int64_t c, int k) {
  if (h < 1 || w < 1 || c < 1 || k < 1 || !(k & 1)) return 1;
  const int64_t r = k / 2, row = w * c;
  const uint32_t area = static_cast<uint32_t>(k) * k;
  std::vector<uint32_t> rows(h * row);  // horizontal sums, each window slid one pixel at a time
  std::vector<uint8_t> padded((w + 2 * r) * c);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* s = src + y * row;
    for (int64_t x = 0; x < w + 2 * r; ++x)
      for (int64_t ch = 0; ch < c; ++ch) padded[x * c + ch] = s[reflect101(x - r, w) * c + ch];
    uint32_t* out = rows.data() + y * row;
    for (int64_t ch = 0; ch < c; ++ch) {
      uint32_t acc = 0;
      for (int64_t j = 0; j < k; ++j) acc += padded[j * c + ch];
      out[ch] = acc;
      for (int64_t x = 1; x < w; ++x) {
        acc += padded[(x + k - 1) * c + ch];
        acc -= padded[(x - 1) * c + ch];
        out[x * c + ch] = acc;
      }
    }
  }
  std::vector<uint32_t> acc(row, 0);  // vertical sums, slid one row at a time
  for (int64_t j = -r; j <= r; ++j) {
    const uint32_t* t = rows.data() + reflect101(j, h) * row;
    for (int64_t i = 0; i < row; ++i) acc[i] += t[i];
  }
  for (int64_t y = 0; y < h; ++y) {
    if (y) {
      const uint32_t* in = rows.data() + reflect101(y + r, h) * row;
      const uint32_t* out_row = rows.data() + reflect101(y - r - 1, h) * row;
      for (int64_t i = 0; i < row; ++i) acc[i] = acc[i] + in[i] - out_row[i];
    }
    uint8_t* out = dst + y * row;
    for (int64_t i = 0; i < row; ++i) out[i] = static_cast<uint8_t>((acc[i] + area / 2) / area);
  }
  return 0;
}

}  // extern "C"
