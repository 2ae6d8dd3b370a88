// Baseline JPEG decode on the host, for radet_tpu_torch/data/image_io.py
// (loaded with ctypes; built at first use with the host C++ compiler).
//
// radet_tpu/data/pipeline.py::imread_rgb reads JPEG through cv2.imread, which
// decodes with libjpeg-turbo at its defaults: the integer "islow" IDCT,
// "fancy" (triangle) upsampling of subsampled chroma, and fixed-point
// YCbCr->RGB.  Each of those is integer arithmetic, fully determined, and is
// reproduced here step for step, so the output equals cv2's byte for byte:
//
// - the IDCT of jidctint.c (jpeg_idct_islow): CONST_BITS 13, PASS1_BITS 2,
//   results through the range-limit table centred on CENTERJSAMPLE (128),
//   in the 32-bit lanes of libjpeg-turbo's SIMD version (jidctint-avx2), so
//   that the compiler vectorises each pass;
// - the upsamplers of jdsample.c: h2v1 (3/4, 1/4 weights, +1/+2 biases) and
//   h2v2 (a 3:1 column sum, then (3a + b + 8) >> 4 and (3a + c + 7) >> 4),
//   with the first and last columns as special cases, the rows above the
//   first and below the last real row replicated (jdmainct.c), and plain
//   replication where a component is at most 2 samples wide;
// - the colour tables of jdcolor.c: SCALEBITS 16, Cr_r, Cb_b, Cr_g, Cb_g
//   built with FIX() and ONE_HALF, then a range limit.
//
// Decoded: SOF0 and SOF1 at 8-bit precision, Huffman coding, interleaved and
// single-component scans, 8- and 16-bit DQT, DRI and RSTn, byte stuffing;
// components sampled 1:1, 2:1 or 2:2 against the largest factors (4:4:4,
// 4:2:2, 4:2:0) and gray.  Everything else is refused with kUnsupported.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kOk = 0, kCorrupt = 1, kUnsupported = 2;

struct Failure {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Failure{kCorrupt, msg}; }
[[noreturn]] void unsupported(const std::string& msg) { throw Failure{kUnsupported, msg}; }

// zigzag position -> natural (row-major) position, with 16 entries past the
// end that map to 63, as jpeg_natural_order has for corrupt run lengths
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool defined = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};  // largest code of each length, -1 if none
  int32_t valoffset[17] = {};
  uint16_t look[1 << kLookBits] = {};  // (length << 8) | value; 0: longer code

  void build(const uint8_t counts[17], const uint8_t* values, int n) {
    std::memcpy(vals, values, n);
    int sizes[257], codes[256], p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < counts[l]; ++i) sizes[p++] = l;
    sizes[p] = 0;
    int code = 0, si = sizes[0];
    p = 0;
    while (sizes[p]) {
      while (sizes[p] == si) codes[p++] = code++;
      if (code >= (1 << si)) corrupt("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (counts[l]) {
        valoffset[l] = p - codes[p];
        p += counts[l];
        maxcode[l] = codes[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0xFFFFF;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++p) {
        const int first = codes[p] << (kLookBits - l);
        for (int j = 0; j < (1 << (kLookBits - l)); ++j)
          look[first + j] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    defined = true;
  }
};

// Entropy-coded bits, MSB first; 0xFF00 is a stuffed 0xFF.  At a marker (or
// the end of the data) it supplies zero bits, as libjpeg does.
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          const uint8_t next = p + 1 < end ? p[1] : 0xD9;
          if (next == 0x00) {
            b = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          b = *p++;
        }
      }
      buf |= b << (56 - nbits);
      nbits += 8;
    }
  }
  int peek(int n) {
    if (nbits < n) fill();
    return static_cast<int>(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    const int v = peek(n);
    skip(n);
    return v;
  }
  int decode(const Huffman& h) {
    const int look = h.look[peek(kLookBits)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int code = peek(16);
    int l = kLookBits + 1;
    code >>= 16 - l;
    while (code > h.maxcode[l]) {
      ++l;
      if (l > 16) corrupt("bad Huffman code");
      code = peek(l);
    }
    skip(l);
    return h.vals[(code + h.valoffset[l]) & 0xFF];
  }
  // drop the buffered bits; the data resumes at the next marker
  void reset() {
    buf = 0;
    nbits = 0;
    while (!at_marker && p < end) {
      if (p[0] == 0xFF && p + 1 < end && p[1] != 0x00 && p[1] != 0xFF) break;
      ++p;
    }
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

struct Component {
  int id, h, v, tq;
  int dw, dh;          // downsampled_width / _height: the real samples
  int plane_w, plane_h;  // the plane of whole blocks, in the interleaved MCU layout
  std::vector<uint8_t> plane;
};

// jidctint.c's constants: FIX(x) = round(x * 2^CONST_BITS), CONST_BITS 13
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;
constexpr int CONST_BITS = 13, PASS1_BITS = 2;

// One 1-D pass of jpeg_idct_islow over the 8 values IN(0..7), results
// DESCALEd by `shift` into OUT(0..7, value).  A macro, so that a loop over 8
// lanes around it is straight-line code the compiler vectorises.
#define RADET_IDCT_1D(IN, OUT, shift)                                                  \
  {                                                                                    \
    const int32_t z2 = IN(2), z3 = IN(6);                                              \
    const int32_t z1 = (z2 + z3) * FIX_0_541196100;                                    \
    const int32_t t2 = z1 - z3 * FIX_1_847759065, t3 = z1 + z2 * FIX_0_765366865;      \
    const int32_t t0 = (IN(0) + IN(4)) * (1 << CONST_BITS);                            \
    const int32_t t1 = (IN(0) - IN(4)) * (1 << CONST_BITS);                            \
    const int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;          \
    int32_t o0 = IN(7), o1 = IN(5), o2 = IN(3), o3 = IN(1);                            \
    int32_t y1 = o0 + o3, y2 = o1 + o2, y3 = o0 + o2, y4 = o1 + o3;                    \
    const int32_t y5 = (y3 + y4) * FIX_1_175875602;                                    \
    o0 *= FIX_0_298631336;                                                             \
    o1 *= FIX_2_053119869;                                                             \
    o2 *= FIX_3_072711026;                                                             \
    o3 *= FIX_1_501321110;                                                             \
    y1 *= -FIX_0_899976223;                                                            \
    y2 *= -FIX_2_562915447;                                                            \
    y3 = y3 * -FIX_1_961570560 + y5;                                                   \
    y4 = y4 * -FIX_0_390180644 + y5;                                                   \
    o0 += y1 + y3;                                                                     \
    o1 += y2 + y4;                                                                     \
    o2 += y2 + y3;                                                                     \
    o3 += y1 + y4;                                                                     \
    const int32_t half = 1 << ((shift) - 1);                                           \
    OUT(0, (t10 + o3 + half) >> (shift));                                              \
    OUT(7, (t10 - o3 + half) >> (shift));                                              \
    OUT(1, (t11 + o2 + half) >> (shift));                                              \
    OUT(6, (t11 - o2 + half) >> (shift));                                              \
    OUT(2, (t12 + o1 + half) >> (shift));                                              \
    OUT(5, (t12 - o1 + half) >> (shift));                                              \
    OUT(3, (t13 + o0 + half) >> (shift));                                              \
    OUT(4, (t13 - o0 + half) >> (shift));                                              \
  }

// jpeg_idct_islow on one block: `coef` in natural order, dequantised by `qt`,
// into `out` (row stride `stride`) through the post-IDCT range limit.  The
// arithmetic is 32-bit, as in libjpeg-turbo's SIMD version
// (jidctint-avx2.asm); its shortcuts for all-zero AC columns and rows give
// the same values as the full pass, so none is taken.
void idct_islow(const int16_t* coef, const uint16_t* qt, uint8_t* out, int stride,
                const uint8_t* range_limit) {
  int32_t d[64], cols[64], rows_in[64], res[64];
  for (int i = 0; i < 64; ++i) d[i] = coef[i] * qt[i];
  for (int c = 0; c < 8; ++c) {  // pass 1: lane c is column c
#define IN(k) d[8 * (k) + c]
#define OUT(k, v) cols[8 * (k) + c] = (v)
    RADET_IDCT_1D(IN, OUT, CONST_BITS - PASS1_BITS)
#undef IN
#undef OUT
  }
  for (int k = 0; k < 8; ++k)  // transposed, so that pass 2's lanes are contiguous
    for (int c = 0; c < 8; ++c) rows_in[8 * c + k] = cols[8 * k + c];
  for (int r = 0; r < 8; ++r) {  // pass 2: lane r is row r
#define IN(k) rows_in[8 * (k) + r]
#define OUT(k, v) res[8 * (k) + r] = (v)
    RADET_IDCT_1D(IN, OUT, CONST_BITS + PASS1_BITS + 3)
#undef IN
#undef OUT
  }
  for (int r = 0; r < 8; ++r)
    for (int k = 0; k < 8; ++k) out[r * stride + k] = range_limit[res[8 * k + r] & 1023];
}
#undef RADET_IDCT_1D

// jdcolor.c's build_ycc_rgb_table, with G's two terms summed and shifted
// per (Cb, Cr) pair: (Cb_g[cb] + Cr_g[cr]) >> SCALEBITS; and
// sample_range_limit, x in [-256, 511] at clamp[x + 256].
struct ColorTables {
  int cr_r[256], cb_b[256], cb_cr_g[256 * 256];
  uint8_t clamp[768];
  ColorTables() {
    constexpr int SCALEBITS = 16;
    constexpr int64_t ONE_HALF = int64_t{1} << (SCALEBITS - 1);
    auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
    }
    for (int b = 0, xb = -128; b < 256; ++b, ++xb)
      for (int r = 0, xr = -128; r < 256; ++r, ++xr)
        cb_cr_g[b * 256 + r] =
            static_cast<int>((-fix(0.34414) * xb + ONE_HALF + -fix(0.71414) * xr) >> SCALEBITS);
    for (int i = 0; i < 768; ++i) clamp[i] = static_cast<uint8_t>(i < 256 ? 0 : (i > 511 ? 255 : i - 256));
  }
};

class Decoder {
 public:
  Decoder(const uint8_t* data, int64_t size) : p_(data), end_(data + size) {
    // jdmaster.c's post-IDCT range limit, indexed by (x & 1023): x in
    // [-128, 127] -> x + 128, [128, 511] -> 255, [-512, -129] -> 0
    for (int j = 0; j < 1024; ++j) {
      if (j < 128) range_limit_[j] = static_cast<uint8_t>(j + 128);
      else if (j < 512) range_limit_[j] = 255;
      else if (j < 896) range_limit_[j] = 0;
      else range_limit_[j] = static_cast<uint8_t>(j - 896);
    }
  }

  int width = 0, height = 0, orientation = 0;
  int ncomp() const { return static_cast<int>(comps_.size()); }

  // Reads the markers up to the first scan (headers_only) or to the end.
  void run(bool headers_only) {
    if (end_ - p_ < 2 || p_[0] != 0xFF || p_[1] != 0xD8) corrupt("no SOI marker");
    p_ += 2;
    for (;;) {
      const int m = next_marker();
      if (m < 0) {
        if (!headers_only && scans_ > 0) return;  // truncated after a scan: as libjpeg, keep what was read
        corrupt("no image data before the end of the file");
      }
      if (m == 0xD9) {  // EOI
        if (scans_ == 0) corrupt("no scan before EOI");
        return;
      }
      if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn outside a scan: skip, as libjpeg does
      if (m == 0x01) continue;               // TEM
      const int len = segment_length();
      const uint8_t* seg = p_;
      p_ += len;
      switch (m) {
        case 0xC0:
        case 0xC1:
          frame(seg, len);
          break;
        case 0xC2:
          unsupported("progressive JPEG (SOF2) is not decoded");
        case 0xC3:
          unsupported("lossless JPEG (SOF3) is not decoded");
        case 0xC5: case 0xC6: case 0xC7:
          unsupported("hierarchical JPEG is not decoded");
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF: case 0xCC:
          unsupported("arithmetic-coded JPEG is not decoded");
        case 0xC4:
          huffman_tables(seg, len);
          break;
        case 0xDB:
          quant_tables(seg, len);
          break;
        case 0xDD:
          if (len < 2) corrupt("short DRI segment");
          restart_interval_ = (seg[0] << 8) | seg[1];
          break;
        case 0xDA:
          if (comps_.empty()) corrupt("SOS before SOF");
          if (headers_only) return;
          scan(seg, len);
          break;
        case 0xE0:
          if (len >= 5 && !std::memcmp(seg, "JFIF\0", 5)) jfif_ = true;
          break;
        case 0xE1:
          if (len >= 6 && !std::memcmp(seg, "Exif\0\0", 6) && orientation == 0)
            orientation = exif_orientation(seg + 6, len - 6);
          break;
        case 0xEE:
          if (len >= 12 && !std::memcmp(seg, "Adobe", 5)) {
            adobe_ = true;
            adobe_transform_ = seg[11];
          }
          break;
        case 0xDC:
          unsupported("a DNL marker is not decoded");
        default:
          break;  // other APPn, COM, JPG extensions: skipped
      }
    }
  }

  // The frame's colour space, as jdapimin.c's default_decompress_parms guesses it.
  bool rgb_components() const {
    if (comps_.size() != 3 || jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;  // 'R', 'G', 'B'
  }

  // The decoded image: (H, W) gray when `gray`, else (H, W, 3) RGB.
  void output(bool gray, uint8_t* out) {
    const int64_t n = int64_t{width} * height;
    if (gray) {
      if (rgb_components()) unsupported("an RGB JPEG read as grayscale is not converted");
      upsample(comps_[0], out);
      return;
    }
    std::vector<uint8_t> planes(size_t(n) * comps_.size());
    for (size_t c = 0; c < comps_.size(); ++c) upsample(comps_[c], planes.data() + c * n);
    const uint8_t* y = planes.data();
    if (comps_.size() == 1) {
      for (int64_t i = 0; i < n; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
      return;
    }
    const uint8_t *cb = y + n, *cr = y + 2 * n;
    if (rgb_components()) {
      for (int64_t i = 0; i < n; ++i) {
        out[3 * i] = y[i];
        out[3 * i + 1] = cb[i];
        out[3 * i + 2] = cr[i];
      }
      return;
    }
    static const ColorTables t;  // built once, thread-safe
    for (int64_t i = 0; i < n; ++i) {
      const int yy = y[i] + 256, b = cb[i], r = cr[i];
      out[3 * i] = t.clamp[yy + t.cr_r[r]];
      out[3 * i + 1] = t.clamp[yy + t.cb_cr_g[b * 256 + r]];
      out[3 * i + 2] = t.clamp[yy + t.cb_b[b]];
    }
  }

 private:
  const uint8_t* p_;
  const uint8_t* end_;
  uint8_t range_limit_[1024];
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_defined_[4] = {};
  Huffman dc_[4], ac_[4];
  int restart_interval_ = 0;
  int hmax_ = 1, vmax_ = 1, mcus_x_ = 0, mcus_y_ = 0, scans_ = 0;
  bool jfif_ = false, adobe_ = false;
  int adobe_transform_ = 0;

  // The next marker code, skipping fill bytes and stray data; -1 at the end.
  int next_marker() {
    for (;;) {
      while (p_ < end_ && *p_ != 0xFF) ++p_;
      while (p_ < end_ && *p_ == 0xFF) ++p_;
      if (p_ >= end_) return -1;
      const int m = *p_++;
      if (m != 0x00) return m;
    }
  }

  int segment_length() {
    if (end_ - p_ < 2) corrupt("truncated marker segment");
    const int len = ((p_[0] << 8) | p_[1]) - 2;
    p_ += 2;
    if (len < 0 || len > end_ - p_) corrupt("truncated marker segment");
    return len;
  }

  // IFD0's Orientation (tag 0x0112) of a TIFF-structured EXIF block; 0 if absent.
  static int exif_orientation(const uint8_t* t, int n) {
    if (n < 8) return 0;
    const bool le = t[0] == 'I' && t[1] == 'I';
    if (!le && !(t[0] == 'M' && t[1] == 'M')) return 0;
    auto u16 = [&](int o) { return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1]; };
    auto u32 = [&](int o) {
      return le ? uint32_t(t[o]) | uint32_t(t[o + 1]) << 8 | uint32_t(t[o + 2]) << 16 | uint32_t(t[o + 3]) << 24
                : uint32_t(t[o]) << 24 | uint32_t(t[o + 1]) << 16 | uint32_t(t[o + 2]) << 8 | uint32_t(t[o + 3]);
    };
    const uint32_t ifd = u32(4);
    if (ifd > static_cast<uint32_t>(n - 2)) return 0;
    const int count = u16(ifd);
    for (int i = 0; i < count; ++i) {
      const int e = static_cast<int>(ifd) + 2 + 12 * i;
      if (e + 12 > n) return 0;
      if (u16(e) == 0x0112) return u16(e + 8);
    }
    return 0;
  }

  void frame(const uint8_t* s, int len) {
    if (!comps_.empty()) corrupt("a second SOF marker");
    if (len < 6) corrupt("short SOF segment");
    if (s[0] != 8) unsupported(std::to_string(s[0]) + "-bit JPEG is not decoded");
    height = (s[1] << 8) | s[2];
    width = (s[3] << 8) | s[4];
    const int n = s[5];
    if (height == 0) unsupported("a JPEG whose height comes in a DNL marker is not decoded");
    if (width == 0) corrupt("zero image width");
    if (n == 4) unsupported("4-component (CMYK or YCCK) JPEG is not decoded");
    if (n != 1 && n != 3) unsupported(std::to_string(n) + "-component JPEG is not decoded");
    if (len < 6 + 3 * n) corrupt("short SOF segment");
    for (int i = 0; i < n; ++i) {
      Component c{};
      c.id = s[6 + 3 * i];
      c.h = s[7 + 3 * i] >> 4;
      c.v = s[7 + 3 * i] & 15;
      c.tq = s[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad component parameters");
      hmax_ = c.h > hmax_ ? c.h : hmax_;
      vmax_ = c.v > vmax_ ? c.v : vmax_;
      comps_.push_back(c);
    }
    mcus_x_ = (width + 8 * hmax_ - 1) / (8 * hmax_);
    mcus_y_ = (height + 8 * vmax_ - 1) / (8 * vmax_);
    for (Component& c : comps_) {
      const bool same_h = c.h == hmax_, same_v = c.v == vmax_;
      const bool half_h = 2 * c.h == hmax_, half_v = 2 * c.v == vmax_;
      if (!((same_h && same_v) || (half_h && same_v) || (half_h && half_v))) {
        char buf[160];
        std::snprintf(buf, sizeof(buf),
                      "JPEG sampling %dx%d of a component against %dx%d (only 4:4:4, 4:2:2, 4:2:0 and "
                      "gray are decoded)", c.h, c.v, hmax_, vmax_);
        unsupported(buf);
      }
      c.dw = static_cast<int>((int64_t{width} * c.h + hmax_ - 1) / hmax_);
      c.dh = static_cast<int>((int64_t{height} * c.v + vmax_ - 1) / vmax_);
      c.plane_w = mcus_x_ * c.h * 8;
      c.plane_h = mcus_y_ * c.v * 8;
    }
  }

  void quant_tables(const uint8_t* s, int len) {
    int i = 0;
    while (i < len) {
      const int pq = s[i] >> 4, tq = s[i] & 15;
      if (tq > 3 || pq > 1) corrupt("bad DQT segment");
      const int nbytes = pq ? 128 : 64;
      if (i + 1 + nbytes > len) corrupt("short DQT segment");
      for (int k = 0; k < 64; ++k) {
        const int v = pq ? (s[i + 1 + 2 * k] << 8) | s[i + 2 + 2 * k] : s[i + 1 + k];
        qt_[tq][kNatural[k]] = static_cast<uint16_t>(v);
      }
      qt_defined_[tq] = true;
      i += 1 + nbytes;
    }
  }

  void huffman_tables(const uint8_t* s, int len) {
    int i = 0;
    while (i < len) {
      if (i + 17 > len) corrupt("short DHT segment");
      const int tc = s[i] >> 4, th = s[i] & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT segment");
      uint8_t counts[17] = {};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += counts[l] = s[i + l];
      if (total > 256 || i + 17 + total > len) corrupt("bad DHT segment");
      (tc ? ac_ : dc_)[th].build(counts, s + i + 17, total);
      i += 17 + total;
    }
  }

  void decode_block(BitReader& br, const Huffman& dc, const Huffman& ac, int& pred, const uint16_t* qt,
                    uint8_t* out, int stride) {
    int16_t coef[64] = {};
    const int s = br.decode(dc);
    if (s > 16) corrupt("bad DC difference size");
    if (s) pred += extend(br.get(s), s);
    coef[0] = static_cast<int16_t>(pred);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        coef[kNatural[k > 79 ? 79 : k]] = static_cast<int16_t>(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt, out, stride, range_limit_);
  }

  void scan(const uint8_t* s, int len) {
    if (len < 1) corrupt("short SOS segment");
    const int ns = s[0];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) corrupt("bad SOS segment");
    std::vector<Component*> in_scan;
    std::vector<int> td, ta;
    for (int i = 0; i < ns; ++i) {
      Component* c = nullptr;
      for (Component& k : comps_)
        if (k.id == s[1 + 2 * i]) c = &k;
      if (!c) corrupt("SOS names an unknown component");
      const int d = s[2 + 2 * i] >> 4, a = s[2 + 2 * i] & 15;
      if (d > 3 || a > 3 || !dc_[d].defined || !ac_[a].defined) corrupt("SOS names an undefined Huffman table");
      if (!qt_defined_[c->tq]) corrupt("a component's quantization table is undefined");
      if (c->plane.empty()) c->plane.assign(size_t(c->plane_w) * c->plane_h, 0);
      in_scan.push_back(c);
      td.push_back(d);
      ta.push_back(a);
    }
    const uint8_t* t = s + 1 + 2 * ns;
    if (t[0] != 0 || t[1] != 63 || t[2] != 0) corrupt("a sequential scan with Ss, Se, Ah/Al != 0, 63, 0");
    ++scans_;

    BitReader br{p_, end_};
    std::vector<int> pred(ns, 0);
    int64_t units_x, units_y;
    if (ns == 1) {  // non-interleaved: one block per MCU, the component's own grid
      units_x = (in_scan[0]->dw + 7) / 8;
      units_y = (in_scan[0]->dh + 7) / 8;
    } else {
      units_x = mcus_x_;
      units_y = mcus_y_;
    }
    int64_t todo = restart_interval_;
    for (int64_t my = 0; my < units_y; ++my) {
      for (int64_t mx = 0; mx < units_x; ++mx) {
        if (restart_interval_) {
          if (todo == 0) {
            br.reset();  // the restart marker: byte-aligned, DC predictors at 0
            if (!(br.p + 1 < end_ && br.p[0] == 0xFF && br.p[1] >= 0xD0 && br.p[1] <= 0xD7))
              corrupt("a restart marker is missing");
            br.p += 2;
            std::fill(pred.begin(), pred.end(), 0);
            todo = restart_interval_;
          }
          --todo;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *in_scan[i];
          const uint16_t* qt = qt_[c.tq];
          const int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
          for (int by = 0; by < bv; ++by) {
            for (int bx = 0; bx < bh; ++bx) {
              const int64_t row = (my * bv + by) * 8, col = (mx * bh + bx) * 8;
              decode_block(br, dc_[td[i]], ac_[ta[i]], pred[i], qt, &c.plane[row * c.plane_w + col],
                           c.plane_w);
            }
          }
        }
      }
    }
    br.reset();
    p_ = br.p;
  }

  // A component at full resolution (jdsample.c), as a (height, width) plane.
  void upsample(const Component& c, uint8_t* out) {
    if (c.plane.empty()) corrupt("a component has no scan");
    const uint8_t* P = c.plane.data();
    const int pw = c.plane_w, W = width, H = height;
    const int rx = hmax_ / c.h, ry = vmax_ / c.v;
    std::vector<uint8_t> row(size_t(2) * c.dw + 2);
    for (int y = 0; y < H; ++y) {
      uint8_t* o = out + int64_t{y} * W;
      if (rx == 1) {
        std::memcpy(o, P + int64_t{y} * pw, W);
        continue;
      }
      const int r = ry == 2 ? y / 2 : y;
      const uint8_t* in0 = P + int64_t{r} * pw;
      uint8_t* u = row.data();
      if (c.dw <= 2) {  // h2v1_upsample / h2v2_upsample: replication
        for (int x = 0; x < c.dw; ++x) u[2 * x] = u[2 * x + 1] = in0[x];
      } else if (ry == 1) {  // h2v1_fancy_upsample
        int v = in0[0];
        u[0] = static_cast<uint8_t>(v);
        u[1] = static_cast<uint8_t>((v * 3 + in0[1] + 2) >> 2);
        for (int x = 1; x < c.dw - 1; ++x) {
          v = in0[x] * 3;
          u[2 * x] = static_cast<uint8_t>((v + in0[x - 1] + 1) >> 2);
          u[2 * x + 1] = static_cast<uint8_t>((v + in0[x + 1] + 2) >> 2);
        }
        const int last = c.dw - 1;
        v = in0[last];
        u[2 * last] = static_cast<uint8_t>((v * 3 + in0[last - 1] + 1) >> 2);
        u[2 * last + 1] = static_cast<uint8_t>(v);
      } else {  // h2v2_fancy_upsample: the nearer row 3/4, the row above (even y) or below (odd y) 1/4
        int other = (y & 1) ? r + 1 : r - 1;
        other = other < 0 ? 0 : (other > c.dh - 1 ? c.dh - 1 : other);
        const uint8_t* in1 = P + int64_t{other} * pw;
        int thiscol = in0[0] * 3 + in1[0];
        int nextcol = in0[1] * 3 + in1[1];
        u[0] = static_cast<uint8_t>((thiscol * 4 + 8) >> 4);
        u[1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
        int lastcol = thiscol;
        thiscol = nextcol;
        for (int x = 1; x < c.dw - 1; ++x) {
          nextcol = in0[x + 1] * 3 + in1[x + 1];
          u[2 * x] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
          u[2 * x + 1] = static_cast<uint8_t>((thiscol * 3 + nextcol + 7) >> 4);
          lastcol = thiscol;
          thiscol = nextcol;
        }
        const int last = c.dw - 1;
        u[2 * last] = static_cast<uint8_t>((thiscol * 3 + lastcol + 8) >> 4);
        u[2 * last + 1] = static_cast<uint8_t>((thiscol * 4 + 7) >> 4);
      }
      std::memcpy(o, u, W);
    }
  }
};

int report(const Failure& f, char* msg, int msg_len) {
  if (msg && msg_len > 0) std::snprintf(msg, msg_len, "%s", f.msg.c_str());
  return f.code;
}

}  // namespace

extern "C" {

// The header of a JPEG file: width, height, components (1 or 3) and the EXIF
// orientation (0 when there is none).  Returns 0, 1 (corrupt) or 2 (not
// decoded), with a message in `msg` on failure.
int radet_jpeg_info(const uint8_t* data, int64_t size, int* width, int* height, int* components,
                    int* orientation, char* msg, int msg_len) {
  try {
    Decoder d(data, size);
    d.run(true);
    *width = d.width;
    *height = d.height;
    *components = d.ncomp();
    *orientation = d.orientation;
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, msg, msg_len);
  }
}

// Decodes a JPEG file into `out`: (height, width) uint8 when `gray`, else
// (height, width, 3) RGB; `out_size` must be that many bytes.  Returns as
// radet_jpeg_info.
int radet_jpeg_decode(const uint8_t* data, int64_t size, int gray, uint8_t* out, int64_t out_size,
                      char* msg, int msg_len) {
  try {
    Decoder d(data, size);
    d.run(false);
    if (out_size != int64_t{d.width} * d.height * (gray ? 1 : 3))
      throw Failure{kCorrupt, "output buffer size does not match the image"};
    d.output(gray != 0, out);
    return kOk;
  } catch (const Failure& f) {
    return report(f, msg, msg_len);
  } catch (const std::bad_alloc&) {
    return report(Failure{kCorrupt, "out of memory"}, msg, msg_len);
  }
}

}  // extern "C"
