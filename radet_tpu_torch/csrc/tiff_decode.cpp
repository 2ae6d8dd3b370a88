// TIFF strip and tile decompression on the host, for
// radet_tpu_torch/data/tiff.py (loaded with ctypes; built at first use with
// the host C++ compiler).
//
// - radet_tiff_lzw: TIFF's LZW (compression 5): codes packed MSB first,
//   9 to 12 bits wide, Clear 256, EOI 257, the code width growing one code
//   early (after 510, 1022 and 2046 entries, as libtiff decodes);
// - radet_tiff_packbits: PackBits (compression 32773): a header byte n,
//   0..127 copies n + 1 bytes, -1..-127 repeats the next byte 1 - n times,
//   -128 is skipped.
//
// Each writes at most `dst_n` bytes and returns how many it wrote, or -1 on
// a corrupt stream.  Deflate goes through Python's zlib, and the horizontal
// predictor through numpy.  radet_tpu/data/pipeline.py::imread_rgb reaches
// libtiff through cv2.imread; this file replaces its decompression.  The
// plain twins are tiff.lzw_plain and tiff.packbits_plain.

#include <cstdint>
#include <cstring>

extern "C" {

int64_t radet_tiff_lzw(const uint8_t* src, int64_t n, uint8_t* dst, int64_t dst_n) {
  constexpr int kClear = 256, kEoi = 257, kMaxCodes = 4096;
  static thread_local uint16_t prefix[kMaxCodes];
  static thread_local uint8_t suffix[kMaxCodes], first[kMaxCodes];
  static thread_local uint16_t length[kMaxCodes];
  for (int c = 0; c < 256; ++c) {
    prefix[c] = 0;
    suffix[c] = first[c] = static_cast<uint8_t>(c);
    length[c] = 1;
  }
  int64_t bitpos = 0, out = 0;
  int width = 9, next = 258, old = -1;
  const int64_t nbits = n * 8;
  while (bitpos + width <= nbits) {
    int code = 0;
    for (int b = 0; b < width; ++b, ++bitpos)
      code = (code << 1) | ((src[bitpos >> 3] >> (7 - (bitpos & 7))) & 1);
    if (code == kEoi) break;
    if (code == kClear) {
      width = 9;
      next = 258;
      old = -1;
      continue;
    }
    if (old < 0) {  // the first code after a Clear is a literal
      if (code > 255) return -1;
      if (out < dst_n) dst[out] = static_cast<uint8_t>(code);
      ++out;
      old = code;
      continue;
    }
    int entry;  // the string this code stands for
    if (code < next) {
      entry = code;
      if (next < kMaxCodes) {  // old + the first byte of code's string
        prefix[next] = static_cast<uint16_t>(old);
        suffix[next] = first[code];
        first[next] = first[old];
        length[next] = static_cast<uint16_t>(length[old] + 1);
      }
    } else if (code == next && next < kMaxCodes) {  // old + its own first byte
      prefix[next] = static_cast<uint16_t>(old);
      suffix[next] = first[old];
      first[next] = first[old];
      length[next] = static_cast<uint16_t>(length[old] + 1);
      entry = code;
    } else {
      return -1;
    }
    if (next < kMaxCodes) ++next;
    // write the entry's string backwards from its end
    const int64_t len = length[entry];
    int64_t pos = out + len - 1;
    for (int e = entry;; e = prefix[e], --pos) {
      if (pos < dst_n) dst[pos] = suffix[e];
      if (length[e] == 1) break;
    }
    out += len;
    old = code;
    if (next >= (1 << width) - 1 && width < 12) ++width;
  }
  return out < dst_n ? out : dst_n;
}

int64_t radet_tiff_packbits(const uint8_t* src, int64_t n, uint8_t* dst, int64_t dst_n) {
  int64_t i = 0, out = 0;
  while (i < n && out < dst_n) {
    const int h = static_cast<int8_t>(src[i++]);
    if (h >= 0) {
      const int64_t k = h + 1;
      if (i + k > n) return -1;
      const int64_t m = out + k <= dst_n ? k : dst_n - out;
      std::memcpy(dst + out, src + i, static_cast<size_t>(m));
      i += k;
      out += m;
    } else if (h != -128) {
      if (i >= n) return -1;
      const int64_t k = 1 - h;
      const int64_t m = out + k <= dst_n ? k : dst_n - out;
      std::memset(dst + out, src[i++], static_cast<size_t>(m));
      out += m;
    }
  }
  return out;
}

}  // extern "C"
