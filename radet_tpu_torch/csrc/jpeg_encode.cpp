// Baseline JPEG encode on the host, for radet_tpu_torch/utils/image_write.py
// (loaded with ctypes; built at first use with the host C++ compiler).
//
// cv2.imwrite(".jpg") encodes with libjpeg-turbo at OpenCV's defaults:
// quality 95 (tables limited to baseline), JFIF 1.01 APP0, 4:2:0 for colour
// (1x1 for gray), the standard Huffman tables of Annex K (no optimised
// coding), no restart interval.  Each stage below is integer arithmetic,
// fully determined, and repeats libjpeg-turbo's step for step, so the file
// equals cv2's byte for byte:
//
// - jccolor.c: BGR -> YCbCr with SCALEBITS 16 tables (FIX(), ONE_HALF, the
//   0.5 - epsilon rounding of Cb and Cr);
// - jcsample.c / jcprepct.c: the last column replicated to the padded width,
//   an odd last row replicated to the 2-row group, then h2v2 downsampling
//   ((a + b + c + d + bias) >> 2, bias 1, 2, 1, 2, ... along a row), then the
//   last downsampled row of each component replicated to the iMCU height;
// - jfdctint.c: the islow forward DCT (CONST_BITS 13, PASS1_BITS 2) on
//   samples less 128, results scaled by 8;
// - jcdctmgr.c: quantisation by reciprocal (compute_reciprocal of q * 8,
//   ((|x| + corr) * recip) >> r, the sign restored), as its 16-bit SIMD
//   version computes it;
// - jccoefct.c: dummy blocks where the MCU grid passes the image's blocks,
//   AC zero and DC that of the block before it in the MCU;
// - jchuff.c: Huffman coding with the standard tables, 0xFF stuffed with a
//   0x00, the last byte padded with 1 bits;
// - jcmarker.c: SOI, APP0, DQT per table, SOF0, DHT (DC then AC per table
//   in component order), SOS, EOI.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kOk = 0, kBadArgs = 1, kTooSmall = 2;

const int kNaturalOrder[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33, 40, 48,
    41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23,
    30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const int kStdLuminance[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};

const int kStdChrominance[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3: counts of codes of length 1..16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct HuffTable {
  const uint8_t* bits;
  const uint8_t* vals;
  int nvals;
  uint16_t code[256];
  uint8_t size[256];

  HuffTable(const uint8_t* b, const uint8_t* v, int n) : bits(b), vals(v), nvals(n) {
    std::memset(code, 0, sizeof(code));
    std::memset(size, 0, sizeof(size));
    int k = 0, c = 0;  // jchuff.c: codes of each length in order, then shift
    for (int len = 1; len <= 16; ++len) {
      for (int i = 0; i < bits[len - 1]; ++i, ++k) {
        code[vals[k]] = static_cast<uint16_t>(c++);
        size[vals[k]] = static_cast<uint8_t>(len);
      }
      c <<= 1;
    }
  }
};

// jcparam.c: jpeg_quality_scaling then jpeg_add_quant_table with baseline limits
void ScaledTable(const int* base, int quality, int* out) {
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = (static_cast<long>(base[i]) * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    out[i] = static_cast<int>(t);
  }
}

struct Divisor {
  uint32_t recip, corr;
  int shift;  // r
};

// jcdctmgr.c: compute_reciprocal (16-bit DCTELEM, as in the SIMD build)
Divisor Reciprocal(int divisor) {
  int b = 31 - __builtin_clz(static_cast<unsigned>(divisor));  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (1u << r) / divisor, fr = (1u << r) % divisor;
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= static_cast<uint32_t>(divisor) / 2u) {
    ++c;
  } else {
    ++fq;
  }
  return {fq, c, r};
}

// jfdctint.c: jpeg_fdct_islow, in place, natural order
void FdctIslow(int32_t* d) {
  constexpr int kConstBits = 13, kPass1 = 2;
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  auto descale = [](int32_t x, int n) { return (x + (1 << (n - 1))) >> n; };
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, stride = pass == 0 ? 8 : 1;
    const int even_shift = pass == 0 ? 0 : kPass1, odd_shift = pass == 0 ? kConstBits - kPass1 : kConstBits + kPass1;
    for (int i = 0; i < 8; ++i) {
      int32_t* p = d + i * stride;
      int32_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int32_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int32_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int32_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (tmp10 + tmp11) * (1 << kPass1);
        p[4 * step] = (tmp10 - tmp11) * (1 << kPass1);
      } else {
        p[0] = descale(tmp10 + tmp11, even_shift);
        p[4 * step] = descale(tmp10 - tmp11, even_shift);
      }
      int32_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      p[6 * step] = descale(z1 - tmp12 * F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int32_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 = z3 * -F1961 + z5;
      z4 = z4 * -F0390 + z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

// One 8x8 block of a padded plane -> quantised coefficients (natural order).
void EncodeBlock(const uint8_t* plane, int stride, int y0, int x0, const Divisor* div, int16_t* out) {
  int32_t d[64];
  for (int y = 0; y < 8; ++y)
    for (int x = 0; x < 8; ++x) d[y * 8 + x] = static_cast<int32_t>(plane[(y0 + y) * stride + x0 + x]) - 128;
  FdctIslow(d);
  for (int i = 0; i < 64; ++i) {
    int32_t t = d[i];
    uint32_t a = static_cast<uint32_t>(t < 0 ? -t : t);
    uint32_t q = static_cast<uint32_t>((static_cast<uint64_t>(a + div[i].corr) * div[i].recip) >> div[i].shift);
    out[i] = static_cast<int16_t>(t < 0 ? -static_cast<int32_t>(q) : static_cast<int32_t>(q));
  }
}

class Writer {
 public:
  std::vector<uint8_t> out;

  void Byte(int b) { out.push_back(static_cast<uint8_t>(b)); }
  void Word(int w) {
    Byte(w >> 8);
    Byte(w & 255);
  }
  void Bits(uint32_t code, int size) {  // MSB first, 0xFF stuffed
    for (int i = size - 1; i >= 0; --i) {
      acc_ = (acc_ << 1) | ((code >> i) & 1u);
      if (++nacc_ == 8) {
        Byte(static_cast<int>(acc_));
        if (acc_ == 0xFF) Byte(0);
        acc_ = 0;
        nacc_ = 0;
      }
    }
  }
  void Flush() {  // jchuff.c flush_bits: pad with 1 bits
    if (nacc_) Bits(0x7F, 8 - nacc_);
  }

 private:
  uint32_t acc_ = 0;
  int nacc_ = 0;
};

void EncodeHuffman(Writer& w, const int16_t* block, int* last_dc, const HuffTable& dc, const HuffTable& ac) {
  auto magnitude = [](int v, int* bits) {  // (nbits, bits of v or v - 1 when negative)
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    *bits = (v < 0 ? v - 1 : v) & ((1 << n) - 1);
    return n;
  };
  int bits;
  int n = magnitude(block[0] - *last_dc, &bits);
  *last_dc = block[0];
  w.Bits(dc.code[n], dc.size[n]);
  if (n) w.Bits(static_cast<uint32_t>(bits), n);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = block[kNaturalOrder[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.Bits(ac.code[0xF0], ac.size[0xF0]);
      run -= 16;
    }
    n = magnitude(v, &bits);
    int sym = (run << 4) + n;
    w.Bits(ac.code[sym], ac.size[sym]);
    w.Bits(static_cast<uint32_t>(bits), n);
    run = 0;
  }
  if (run > 0) w.Bits(ac.code[0], ac.size[0]);
}

void WriteDqt(Writer& w, int id, const int* table) {
  w.Word(0xFFDB);
  w.Word(67);
  w.Byte(id);
  for (int i = 0; i < 64; ++i) w.Byte(table[kNaturalOrder[i]]);
}

void WriteDht(Writer& w, int cls_id, const HuffTable& t) {
  w.Word(0xFFC4);
  w.Word(2 + 1 + 16 + t.nvals);
  w.Byte(cls_id);
  for (int i = 0; i < 16; ++i) w.Byte(t.bits[i]);
  for (int i = 0; i < t.nvals; ++i) w.Byte(t.vals[i]);
}

// A (rows x cols) plane whose columns past `w` repeat column w - 1 and whose
// rows past `h` repeat row h - 1.
std::vector<uint8_t> Pad(const std::vector<uint8_t>& src, int h, int w, int rows, int cols) {
  std::vector<uint8_t> out(static_cast<size_t>(rows) * cols);
  for (int y = 0; y < rows; ++y) {
    const uint8_t* s = src.data() + static_cast<size_t>(y < h ? y : h - 1) * w;
    uint8_t* o = out.data() + static_cast<size_t>(y) * cols;
    std::memcpy(o, s, w);
    std::memset(o + w, s[w - 1], cols - w);
  }
  return out;
}

}  // namespace

extern "C" {

// Encode a uint8 image (rows of `stride` bytes; channels 3 as BGR or 1 as
// gray) as cv2.imwrite(".jpg") does at its defaults into `out` (capacity
// `cap`).  Returns the file's length, or -kBadArgs / -kTooSmall.
int64_t radet_jpeg_encode(const uint8_t* img, int h, int w, int channels, int64_t stride, uint8_t* out,
                          int64_t cap) {
  if (h <= 0 || w <= 0 || h > 65535 || w > 65535 || (channels != 1 && channels != 3) || stride < static_cast<int64_t>(w) * channels)
    return -kBadArgs;
  const int quality = 95;
  int qt[2][64];
  ScaledTable(kStdLuminance, quality, qt[0]);
  ScaledTable(kStdChrominance, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = Reciprocal(qt[t][i] * 8);
  const HuffTable dc_lum(kDcLumBits, kDcVals, 12), ac_lum(kAcLumBits, kAcLumVals, 162);
  const HuffTable dc_chrom(kDcChromBits, kDcVals, 12), ac_chrom(kAcChromBits, kAcChromVals, 162);
  const int ncomp = channels;

  Writer wr;
  wr.out.reserve(static_cast<size_t>(h) * w * channels / 2 + 1024);
  wr.Word(0xFFD8);
  const uint8_t app0[] = {0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  for (uint8_t b : app0) wr.Byte(b);
  WriteDqt(wr, 0, qt[0]);
  if (ncomp == 3) WriteDqt(wr, 1, qt[1]);
  wr.Word(0xFFC0);
  wr.Word(8 + 3 * ncomp);
  wr.Byte(8);
  wr.Word(h);
  wr.Word(w);
  wr.Byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    wr.Byte(c + 1);
    wr.Byte(ncomp == 3 && c == 0 ? 0x22 : 0x11);
    wr.Byte(c == 0 ? 0 : 1);
  }
  WriteDht(wr, 0x00, dc_lum);
  WriteDht(wr, 0x10, ac_lum);
  if (ncomp == 3) {
    WriteDht(wr, 0x01, dc_chrom);
    WriteDht(wr, 0x11, ac_chrom);
  }
  wr.Word(0xFFDA);
  wr.Word(6 + 2 * ncomp);
  wr.Byte(ncomp);
  for (int c = 0; c < ncomp; ++c) {
    wr.Byte(c + 1);
    wr.Byte(c == 0 ? 0x00 : 0x11);
  }
  wr.Byte(0);
  wr.Byte(63);
  wr.Byte(0);

  int16_t block[64];
  if (ncomp == 1) {
    const int bw = (w + 7) / 8, bh = (h + 7) / 8;
    std::vector<uint8_t> gray(static_cast<size_t>(h) * w);
    for (int y = 0; y < h; ++y) std::memcpy(gray.data() + static_cast<size_t>(y) * w, img + y * stride, w);
    const std::vector<uint8_t> plane = Pad(gray, h, w, bh * 8, bw * 8);
    int last_dc = 0;
    for (int by = 0; by < bh; ++by)
      for (int bx = 0; bx < bw; ++bx) {
        EncodeBlock(plane.data(), bw * 8, by * 8, bx * 8, div[0], block);
        EncodeHuffman(wr, block, &last_dc, dc_lum, ac_lum);
      }
  } else {
    // jccolor.c: fixed-point tables, SCALEBITS 16
    constexpr int32_t kHalf = 1 << 15, kOffset = 128 << 16;
    const int mcux = (w + 15) / 16, mcuy = (h + 15) / 16;
    const int ybw = (w + 7) / 8, ybh = (h + 7) / 8;
    const int cw = (w + 1) / 2, ch = (h + 1) / 2;  // downsampled size
    std::vector<uint8_t> Y(static_cast<size_t>(h) * w), Cb(Y.size()), Cr(Y.size());
    for (int y = 0; y < h; ++y) {
      const uint8_t* p = img + y * stride;
      for (int x = 0; x < w; ++x, p += 3) {
        const int32_t b = p[0], g = p[1], r = p[2];
        const size_t i = static_cast<size_t>(y) * w + x;
        Y[i] = static_cast<uint8_t>((19595 * r + 38470 * g + 7471 * b + kHalf) >> 16);
        Cb[i] = static_cast<uint8_t>((-11059 * r - 21709 * g + 32768 * b + kOffset + kHalf - 1) >> 16);
        Cr[i] = static_cast<uint8_t>((32768 * r - 27439 * g - 5329 * b + kOffset + kHalf - 1) >> 16);
      }
    }
    const std::vector<uint8_t> yplane = Pad(Y, h, w, mcuy * 16, ybw * 8);
    // h2v2: input padded to 2 cw' columns (cw' = chroma blocks * 8) and an
    // even row count, then the downsampled rows padded to the iMCU height
    const int cbw = mcux, cbh = mcuy;
    std::vector<uint8_t> cplane[2];
    const std::vector<uint8_t>* src[2] = {&Cb, &Cr};
    for (int c = 0; c < 2; ++c) {
      const std::vector<uint8_t> full = Pad(*src[c], h, w, 2 * ch, cbw * 16);
      std::vector<uint8_t> down(static_cast<size_t>(ch) * cbw * 8);
      for (int y = 0; y < ch; ++y) {
        const uint8_t* r0 = full.data() + static_cast<size_t>(2 * y) * cbw * 16;
        const uint8_t* r1 = r0 + cbw * 16;
        int bias = 1;
        for (int x = 0; x < cbw * 8; ++x) {
          down[static_cast<size_t>(y) * cbw * 8 + x] =
              static_cast<uint8_t>((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      cplane[c] = Pad(down, ch, cbw * 8, cbh * 8, cbw * 8);
    }
    (void)cw;
    int last_dc[3] = {0, 0, 0};
    int16_t ymcu[4][64];
    for (int my = 0; my < mcuy; ++my)
      for (int mx = 0; mx < mcux; ++mx) {
        for (int yi = 0; yi < 2; ++yi)
          for (int xi = 0; xi < 2; ++xi) {
            const int by = 2 * my + yi, bx = 2 * mx + xi, k = 2 * yi + xi;
            if (by < ybh && bx < ybw) {
              EncodeBlock(yplane.data(), ybw * 8, by * 8, bx * 8, div[0], ymcu[k]);
            } else {
              std::memset(ymcu[k], 0, sizeof(ymcu[k]));
              ymcu[k][0] = by < ybh ? ymcu[k - 1][0] : ymcu[1][0];
            }
          }
        for (int k = 0; k < 4; ++k) EncodeHuffman(wr, ymcu[k], &last_dc[0], dc_lum, ac_lum);
        for (int c = 0; c < 2; ++c) {
          EncodeBlock(cplane[c].data(), cbw * 8, my * 8, mx * 8, div[1], block);
          EncodeHuffman(wr, block, &last_dc[1 + c], dc_chrom, ac_chrom);
        }
      }
  }
  wr.Flush();
  wr.Word(0xFFD9);
  if (static_cast<int64_t>(wr.out.size()) > cap) return -kTooSmall;
  std::memcpy(out, wr.out.data(), wr.out.size());
  return static_cast<int64_t>(wr.out.size());
}

}  // extern "C"
