// Mask-free distance maps on the host, for radet_tpu_torch/ops/distance_transform.py
// (loaded with ctypes; built at first use with the host C++ compiler and
// -ffp-contract=off, so that no multiply and add are fused into one
// rounding and each function equals its numpy twin bit for bit).
//
// - radet_mbd_transform: raster-scan Minimum Barrier Distance from seed
//   points over an (h, w, 3) uint8 image (FastMBD: Zhang et al., "Minimum
//   Barrier Salient Object Detection at 80 FPS"), with the spatial penalty
//   alpha^2 / size_factor * d^2 to the seed; double arithmetic;
// - radet_gdt_transform: two-pass chamfer geodesic distance over an (h, w)
//   float32 edge-cost map, weights 1/2 and sqrt(2)/2; float arithmetic;
// - radet_sobel_cost: |0.5 * dx + 0.5 * dy| of an (h, w) uint8 gray image,
//   dx and dy cv2.Sobel(gray, CV_32F, ., ., ksize=3) with BORDER_REFLECT_101
//   (exact integer sums, exact in float32, as is the half-sum).
//
// These are the arithmetic of radet_tpu/ops/native/src/radet_native.cpp
// (mbd_transform, gdt_transform) and of radet_tpu/ops/distance_transform.py
// (sobel_edges).  ctypes releases the interpreter lock around each call, so
// loader threads run them in parallel.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// `image` (h, w, 3) uint8; `seeds_x`, `seeds_y` n_seeds pixel coordinates;
// `dmap` (h, w) float64 out.  Unreached pixels keep 255.
void radet_mbd_transform(const uint8_t* image, int h, int w, const int64_t* seeds_x, const int64_t* seeds_y,
                         int n_seeds, float alpha, int niter, int base_size, double* dmap) {
  const int n = h * w;
  double size_factor = 400.0;
  if ((double)h * w >= (double)base_size * base_size)
    size_factor = 400.0 * ((double)(w * h) / ((double)base_size * base_size));
  const double factor = (double)alpha * alpha / size_factor;

  std::vector<int32_t> label(n, -1);
  std::vector<uint8_t> hi(image, image + 3 * n);  // running barrier max
  std::vector<uint8_t> lo(image, image + 3 * n);  // running barrier min
  std::fill(dmap, dmap + n, 255.0);
  for (int s = 0; s < n_seeds; s++) {
    const int idx = (int)seeds_y[s] * w + (int)seeds_x[s];
    label[idx] = s;
    dmap[idx] = 0.0;
  }

  for (int it = 0; it < niter; it++) {
    const bool fwd = (it % 2 == 0);
    const int y0 = fwd ? 0 : h - 1, y1 = fwd ? h : -1;
    const int x0 = fwd ? 0 : w - 1, x1 = fwd ? w : -1;
    const int step = fwd ? 1 : -1;
    // the forward pass looks at (x-1, y) and (x, y-1); the backward at (x+1, y), (x, y+1)
    const int offs[2][2] = {{fwd ? -1 : 1, 0}, {0, fwd ? -1 : 1}};  // (dx, dy)
    for (int y = y0; y != y1; y += step) {
      for (int x = x0; x != x1; x += step) {
        const int ci = y * w + x;
        const uint8_t* cur = image + 3 * ci;
        for (int k = 0; k < 2; k++) {
          const int nx = x + offs[k][0];
          const int ny = y + offs[k][1];
          if (nx < 0 || nx >= w || ny < 0 || ny >= h) continue;
          const int nbr = ny * w + nx;
          const int32_t nlabel = label[nbr];
          if (nlabel < 0) continue;
          uint8_t maxc[3], minc[3];
          int barrier = 0;
          for (int c = 0; c < 3; c++) {
            maxc[c] = std::max(hi[3 * nbr + c], cur[c]);
            minc[c] = std::min(lo[3 * nbr + c], cur[c]);
            barrier = std::max(barrier, (int)maxc[c] - (int)minc[c]);
          }
          double cost = barrier / 255.0;
          cost *= cost;
          const double dy = (double)seeds_y[nlabel] - y;
          const double dx = (double)seeds_x[nlabel] - x;
          cost += factor * (dy * dy + dx * dx);
          if (cost < dmap[ci]) {
            dmap[ci] = cost;
            label[ci] = nlabel;
            std::memcpy(&hi[3 * ci], maxc, 3);
            std::memcpy(&lo[3 * ci], minc, 3);
          }
        }
      }
    }
  }
}

// `cost` (h, w) float32; `dist` (h, w) float32 out, 255 where unreached.
void radet_gdt_transform(const float* cost, int h, int w, const int64_t* seeds_x, const int64_t* seeds_y,
                         int n_seeds, float* dist) {
  const float C1 = 0.5f;
  const float C2 = std::sqrt(2.0f) / 2.0f;
  const int n = h * w;
  std::fill(dist, dist + n, 255.0f);
  for (int s = 0; s < n_seeds; s++) {
    const int idx = (int)seeds_y[s] * w + (int)seeds_x[s];
    dist[idx] = cost[idx];
  }
  auto relax = [&](int cur, int prev, float coef) {
    const float d = dist[prev] + coef * (cost[cur] + cost[prev]);
    if (dist[cur] > d) dist[cur] = d;
  };
  // forward: left to right, top to bottom
  for (int j = 1; j < w; j++) relax(j, j - 1, C1);
  for (int i = 1; i < h; i++) {
    const int r = i * w, p = (i - 1) * w;
    relax(r, p, C1);
    if (w > 1) relax(r, p + 1, C2);
    for (int j = 1; j < w - 1; j++) {
      relax(r + j, r + j - 1, C1);
      relax(r + j, p + j - 1, C2);
      relax(r + j, p + j, C1);
      relax(r + j, p + j + 1, C2);
    }
    if (w > 1) {
      const int j = w - 1;
      relax(r + j, r + j - 1, C1);
      relax(r + j, p + j - 1, C2);
      relax(r + j, p + j, C1);
    }
  }
  // backward: right to left, bottom to top
  {
    const int r = (h - 1) * w;
    for (int j = w - 2; j >= 0; j--) relax(r + j, r + j + 1, C1);
  }
  for (int i = h - 2; i >= 0; i--) {
    const int r = i * w, p = (i + 1) * w;
    const int jl = w - 1;
    relax(r + jl, p + jl, C1);
    if (w > 1) relax(r + jl, p + jl - 1, C2);
    for (int j = w - 2; j > 0; j--) {
      relax(r + j, r + j + 1, C1);
      relax(r + j, p + j + 1, C2);
      relax(r + j, p + j, C1);
      relax(r + j, p + j - 1, C2);
    }
    if (w > 1) {
      relax(r, r + 1, C1);
      relax(r, p + 1, C2);
      relax(r, p, C1);
    }
  }
}

// `gray` (h, w) uint8, h and w at least 2; `out` (h, w) float32.
void radet_sobel_cost(const uint8_t* gray, int64_t h, int64_t w, float* out) {
  auto at = [&](int64_t y, int64_t x) -> int {
    // BORDER_REFLECT_101 one pixel past an edge
    y = y < 0 ? 1 : (y >= h ? h - 2 : y);
    x = x < 0 ? 1 : (x >= w ? w - 2 : x);
    return gray[y * w + x];
  };
  for (int64_t y = 0; y < h; ++y) {
    for (int64_t x = 0; x < w; ++x) {
      const int dx = (at(y - 1, x + 1) - at(y - 1, x - 1)) + 2 * (at(y, x + 1) - at(y, x - 1)) +
                     (at(y + 1, x + 1) - at(y + 1, x - 1));
      const int dy = (at(y + 1, x - 1) - at(y - 1, x - 1)) + 2 * (at(y + 1, x) - at(y - 1, x)) +
                     (at(y + 1, x + 1) - at(y - 1, x + 1));
      out[y * w + x] = std::fabs(0.5f * static_cast<float>(dx) + 0.5f * static_cast<float>(dy));
    }
  }
}

}  // extern "C"
