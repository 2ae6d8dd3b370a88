// Telea inpainting of uint8 RGB images on the host, for
// radet_tpu_torch/data/inpaint.py (loaded with ctypes; built at first use
// with the host C++ compiler and -ffp-contract=off).
//
// radet_tpu/data/instaboost.py fills the holes it leaves with
// cv2.inpaint(img, hole, 3, cv2.INPAINT_TELEA); this file repeats OpenCV's
// fast-marching code (imgproc/src/inpaint.cpp) step for step, so that the
// result is cv2's byte for byte:
//
// - the image is framed by a 1-pixel border: f (KNOWN 0, BAND 1, INSIDE 2)
//   and T (1e6 outside the band, 0 on it);
// - the narrow band is the hole dilated by a 3x3 cross, less the hole;
// - a first march runs outward from the band over the ring within
//   `range` of the hole (the hole dilated by a (2 range + 1) square), and
//   its times are negated;
// - the second march runs into the hole; each pixel, when the band reaches
//   it, takes the Telea estimate of its 3 channels from the known pixels
//   within `range`, weighted by direction, distance and level set;
// - both queues pop the least T first and, among equal T, the pixel pushed
//   first (OpenCV's sorted list);
// - arithmetic is OpenCV's: float where it stores floats, double where it
//   divides 1. by a value or takes fabs or sqrt of a double (the level-set
//   weight's |dT| is widened before 1 is added), rounded by cvRound at the
//   end; the intensity gradient reads its neighbours at OpenCV's clamped
//   (km, lm) indices, with the factor 2 where a central difference would
//   halve, and the intensity itself at (k - 1, l - 1).

#include <cmath>
#include <cstdint>
#include <queue>
#include <vector>

namespace {

constexpr uint8_t KNOWN = 0, BAND = 1, INSIDE = 2, CHANGE = 3;

struct Item {
  float t;
  int64_t seq;
  int i, j;
};

struct Later {
  bool operator()(const Item& a, const Item& b) const { return a.t != b.t ? a.t > b.t : a.seq > b.seq; }
};

// OpenCV's CvPriorityQueueFloat: least T first, ties in push order.
class Queue {
 public:
  void push(int i, int j, float t) { heap_.push(Item{t, seq_++, i, j}); }
  bool pop(int* i, int* j) {
    if (heap_.empty()) return false;
    *i = heap_.top().i;
    *j = heap_.top().j;
    heap_.pop();
    return true;
  }

 private:
  std::priority_queue<Item, std::vector<Item>, Later> heap_;
  int64_t seq_ = 0;
};

struct Grid {
  int rows, cols;
  std::vector<uint8_t> f;
  std::vector<float> t;
  uint8_t& F(int i, int j) { return f[static_cast<size_t>(i) * cols + j]; }
  float& T(int i, int j) { return t[static_cast<size_t>(i) * cols + j]; }
};

float solve(int i1, int j1, int i2, int j2, const std::vector<uint8_t>& f, Grid& g) {
  const double a11 = g.T(i1, j1), a22 = g.T(i2, j2);
  const double m12 = a11 < a22 ? a11 : a22;
  const bool in1 = f[static_cast<size_t>(i1) * g.cols + j1] == INSIDE;
  const bool in2 = f[static_cast<size_t>(i2) * g.cols + j2] == INSIDE;
  double sol;
  if (!in1) {
    if (!in2) {
      if (std::fabs(a11 - a22) >= 1.0)
        sol = 1 + m12;
      else
        sol = (a11 + a22 + std::sqrt(2 - (a11 - a22) * (a11 - a22))) * 0.5;
    } else {
      sol = 1 + a11;
    }
  } else if (!in2) {
    sol = 1 + a22;
  } else {
    sol = 1 + m12;
  }
  return static_cast<float>(sol);
}

inline float min4(float a, float b, float c, float d) {
  const float ab = a < b ? a : b, cd = c < d ? c : d;
  return ab < cd ? ab : cd;
}

float arrival(int i, int j, const std::vector<uint8_t>& f, Grid& g) {
  return min4(solve(i - 1, j, i, j - 1, f, g), solve(i + 1, j, i, j - 1, f, g), solve(i - 1, j, i, j + 1, f, g),
              solve(i + 1, j, i, j + 1, f, g));
}

const int kDi[4] = {-1, 0, 1, 0}, kDj[4] = {0, -1, 0, 1};

// the outward march over `ring` (INSIDE where it is still to be reached);
// its times end negated
void march_out(std::vector<uint8_t>& ring, Grid& g, Queue& q) {
  int ii, jj;
  while (q.pop(&ii, &jj)) {
    ring[static_cast<size_t>(ii) * g.cols + jj] = CHANGE;
    for (int n = 0; n < 4; ++n) {
      const int i = ii + kDi[n], j = jj + kDj[n];
      if (i <= 0 || j <= 0 || i > g.rows || j > g.cols) continue;
      uint8_t& r = ring[static_cast<size_t>(i) * g.cols + j];
      if (r == INSIDE) {
        const float dist = arrival(i, j, ring, g);
        g.T(i, j) = dist;
        r = BAND;
        q.push(i, j, dist);
      }
    }
  }
  for (size_t k = 0; k < ring.size(); ++k)
    if (ring[k] == CHANGE) g.t[k] = -g.t[k];
}

void telea(Grid& g, uint8_t* out, int64_t w, int range, Queue& q) {
  const int rows = g.rows, cols = g.cols;
  auto px = [&](int y, int x, int c) -> float { return static_cast<float>(out[(static_cast<int64_t>(y) * w + x) * 3 + c]); };
  int ii, jj;
  while (q.pop(&ii, &jj)) {
    g.F(ii, jj) = KNOWN;
    for (int n = 0; n < 4; ++n) {
      const int i = ii + kDi[n], j = jj + kDj[n];
      if (i <= 0 || j <= 0 || i > rows - 1 || j > cols - 1) continue;
      if (g.F(i, j) != INSIDE) continue;
      const float dist = arrival(i, j, g.f, g);
      g.T(i, j) = dist;
      float gx, gy;  // grad T
      if (g.F(i, j + 1) != INSIDE)
        gx = g.F(i, j - 1) != INSIDE ? (g.T(i, j + 1) - g.T(i, j - 1)) * 0.5f : g.T(i, j + 1) - g.T(i, j);
      else
        gx = g.F(i, j - 1) != INSIDE ? g.T(i, j) - g.T(i, j - 1) : 0.f;
      if (g.F(i + 1, j) != INSIDE)
        gy = g.F(i - 1, j) != INSIDE ? (g.T(i + 1, j) - g.T(i - 1, j)) * 0.5f : g.T(i + 1, j) - g.T(i, j);
      else
        gy = g.F(i - 1, j) != INSIDE ? g.T(i, j) - g.T(i - 1, j) : 0.f;
      float jx[3] = {0, 0, 0}, jy[3] = {0, 0, 0}, ia[3] = {0, 0, 0};
      float s[3] = {1.0e-20f, 1.0e-20f, 1.0e-20f};
      for (int k = i - range; k <= i + range; ++k) {
        const int km = k - 1 + (k == 1), kp = k - 1 - (k == rows - 2);
        for (int l = j - range; l <= j + range; ++l) {
          const int lm = l - 1 + (l == 1), lp = l - 1 - (l == cols - 2);
          if (!(k > 0 && l > 0 && k < rows - 1 && l < cols - 1)) continue;
          if (g.F(k, l) == INSIDE || (l - j) * (l - j) + (k - i) * (k - i) > range * range) continue;
          const float ry = static_cast<float>(i - k), rx = static_cast<float>(j - l);
          const float len2 = rx * rx + ry * ry;
          const float dst = static_cast<float>(1. / (len2 * std::sqrt(static_cast<double>(len2))));
          const float lev = static_cast<float>(1. / (1 + std::fabs(static_cast<double>(g.T(k, l) - g.T(i, j)))));
          float dir = rx * gx + ry * gy;
          if (std::fabs(dir) <= 0.01) dir = 0.000001f;
          const float wgt = std::fabs(dst * lev * dir);
          const bool right = g.F(k, l + 1) != INSIDE, left = g.F(k, l - 1) != INSIDE;
          const bool down = g.F(k + 1, l) != INSIDE, up = g.F(k - 1, l) != INSIDE;
          for (int c = 0; c < 3; ++c) {
            float ix, iy;  // grad I, as OpenCV takes it
            if (right)
              ix = left ? (px(km, lp + 1, c) - px(km, lm - 1, c)) * 2.0f : px(km, lp + 1, c) - px(km, lm, c);
            else
              ix = left ? px(km, lp, c) - px(km, lm - 1, c) : 0.f;
            if (down)
              iy = up ? (px(kp + 1, lm, c) - px(km - 1, lm, c)) * 2.0f : px(kp + 1, lm, c) - px(km, lm, c);
            else
              iy = up ? px(kp, lm, c) - px(km - 1, lm, c) : 0.f;
            ia[c] += wgt * px(k - 1, l - 1, c);
            jx[c] -= wgt * (ix * rx);
            jy[c] -= wgt * (iy * ry);
            s[c] += wgt;
          }
        }
      }
      for (int c = 0; c < 3; ++c) {
        const float sat = ia[c] / s[c] + (jx[c] + jy[c]) / (std::sqrt(jx[c] * jx[c] + jy[c] * jy[c]) + 1.0e-20f) + 0.5f;
        const float v = std::nearbyint(sat);
        out[(static_cast<int64_t>(i - 1) * w + (j - 1)) * 3 + c] = static_cast<uint8_t>(v < 0.f ? 0.f : (v > 255.f ? 255.f : v));
      }
      g.F(i, j) = BAND;
      q.push(i, j, dist);
    }
  }
}

// the (rows, cols) framed map of `mask` (h, w) dilated by a (2 r + 1)
// square (r 1 with `cross`: the 3x3 cross), 0 on the frame's border
std::vector<uint8_t> dilated(const std::vector<uint8_t>& hole, int rows, int cols, int r, bool cross) {
  std::vector<uint8_t> out(hole.size(), 0);
  for (int i = 0; i < rows; ++i)
    for (int j = 0; j < cols; ++j) {
      if (!hole[static_cast<size_t>(i) * cols + j]) continue;
      for (int di = -r; di <= r; ++di)
        for (int dj = -r; dj <= r; ++dj) {
          if (cross && di && dj) continue;
          const int y = i + di, x = j + dj;
          if (y >= 0 && y < rows && x >= 0 && x < cols) out[static_cast<size_t>(y) * cols + x] = 1;
        }
    }
  return out;
}

}  // namespace

extern "C" {

// cv2.inpaint(src, mask, radius, INPAINT_TELEA) of an (h, w, 3) uint8
// image `src` and an (h, w) uint8 `mask` (nonzero: the hole) into `dst`.
void radet_inpaint_telea(const uint8_t* src, const uint8_t* mask, uint8_t* dst, int64_t h, int64_t w, double radius) {
  const int64_t n = h * w * 3;
  for (int64_t k = 0; k < n; ++k) dst[k] = src[k];
  int range = static_cast<int>(std::nearbyint(radius));
  range = range < 1 ? 1 : (range > 100 ? 100 : range);
  Grid g;
  g.rows = static_cast<int>(h) + 2;
  g.cols = static_cast<int>(w) + 2;
  const size_t cells = static_cast<size_t>(g.rows) * g.cols;
  std::vector<uint8_t> hole(cells, 0);
  for (int64_t y = 0; y < h; ++y)
    for (int64_t x = 0; x < w; ++x)
      if (mask[y * w + x]) hole[static_cast<size_t>(y + 1) * g.cols + (x + 1)] = 1;
  auto border = [&](std::vector<uint8_t>& m) {
    for (int j = 0; j < g.cols; ++j) m[j] = m[static_cast<size_t>(g.rows - 1) * g.cols + j] = 0;
    for (int i = 0; i < g.rows; ++i) m[static_cast<size_t>(i) * g.cols] = m[static_cast<size_t>(i) * g.cols + g.cols - 1] = 0;
  };
  border(hole);
  std::vector<uint8_t> band = dilated(hole, g.rows, g.cols, 1, true);
  for (size_t k = 0; k < cells; ++k) band[k] = band[k] && !hole[k];
  border(band);
  g.f.assign(cells, KNOWN);
  g.t.assign(cells, 1.0e6f);
  Queue heap, outq;
  for (int i = 0; i < g.rows; ++i)
    for (int j = 0; j < g.cols; ++j) {
      const size_t k = static_cast<size_t>(i) * g.cols + j;
      if (band[k]) {
        heap.push(i, j, 0.f);
        outq.push(i, j, 0.f);
        g.f[k] = BAND;
        g.t[k] = 0.f;
      } else if (hole[k]) {
        g.f[k] = INSIDE;
      }
    }
  std::vector<uint8_t> ring = dilated(hole, g.rows, g.cols, range, false);
  for (size_t k = 0; k < cells; ++k) ring[k] = ring[k] && !hole[k] && !band[k] ? INSIDE : KNOWN;
  border(ring);
  march_out(ring, g, outq);
  telea(g, dst, w, range, heap);
}

}  // extern "C"
