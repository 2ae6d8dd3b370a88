"""Mask-free distance maps (port of ``radet_tpu/ops/distance_transform.py``):
the no-mask branch of ``GenerateDistanceMap``, which estimates from each GT
box how likely each of its pixels is to lie on the object.

For each GT box: a crop padded by ``pad_ratio`` (the area outside the image
filled with a random colour), gated by ``small_object_size`` (a small box
gets a uniform map); resized so its short edge is 150 px and blurred
(``cv2.GaussianBlur((9, 9), 0)``); then the Minimum-Barrier (``'mbd'``) or
Geodesic (``'gdt'``, over Sobel edges) distance from seeds on the crop's
border; resized back, cropped to the box and scaled to a maximum of 1.
Higher is farther from the background; the label assignment samples
anchors in proportion to it (``SampleDistanceAtAnchors``).

Both transforms are host C++ (``csrc/distance_transform.cpp``, built at
first use into ``radet_tpu_torch/_build/`` with ``-ffp-contract=off``, a
failed build raises), each with its numpy twin here (``mbd_plain``,
``gdt_plain``), which the tests hold equal to it bit for bit.  cv2's
operations on the path are the port's own, each cv2's arithmetic: the
uint8 and float32 INTER_LINEAR resizes (``data/pipeline.py``), the
fixed-point blur and gray (``data/color_aug.py``) and the Sobel cost (the
C++ ``radet_sobel_cost``; :func:`sobel_cost_plain` its twin).

The fill colours are three ``randint(0, 255)`` per large box, in the JAX
package's order, from the caller's generator (Python's ``random`` when it
passes none).
"""

from __future__ import annotations

import ctypes
import math
import random
from typing import Optional

import numpy as np

from ..data import color_aug
from ..data.pipeline import resize_linear, resize_linear_f32
from ..utils.native import CSRC, load_library

SOURCE = CSRC / "distance_transform.cpp"
# -ffp-contract=off: each sum and product rounded on its own, as in the numpy twins
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
METHODS = ("mbd", "gdt")
RESIZE_SHORT = 150  # the crop's short edge before the transform

_P = ctypes.c_void_p
_INT = ctypes.c_int
_API = {
    "radet_mbd_transform": ([_P, _INT, _INT, _P, _P, _INT, ctypes.c_float, _INT, _INT, _P], None),
    "radet_gdt_transform": ([_P, _INT, _INT, _P, _P, _INT, _P], None),
    "radet_sobel_cost": ([_P, ctypes.c_int64, ctypes.c_int64, _P], None),
}


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the library."""
    return load_library(SOURCE, CXX_FLAGS, _API)


def _seeds(seeds_x, seeds_y, h: int, w: int):
    sx = np.ascontiguousarray(seeds_x, np.int64)
    sy = np.ascontiguousarray(seeds_y, np.int64)
    if sx.shape != sy.shape or sx.ndim != 1 or not len(sx) or (sx < 0).any() or (sx >= w).any() \
            or (sy < 0).any() or (sy >= h).any():
        raise ValueError(f"seeds must be matching 1-d coordinates inside the {h}x{w} image")
    return sx, sy


# ------------------------------------------------------------ C++ functions


def mbd(image: np.ndarray, seeds_x, seeds_y, alpha: float = 0.1, niter: int = 4,
        base_size: int = 300) -> np.ndarray:
    """Minimum Barrier Distance of each pixel of the (H, W, 3) uint8
    ``image`` from the seeds, (H, W) float64 (see the module docstring)."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    sx, sy = _seeds(seeds_x, seeds_y, h, w)
    out = np.empty((h, w), np.float64)
    build().radet_mbd_transform(image.ctypes.data, h, w, sx.ctypes.data, sy.ctypes.data, len(sx), float(alpha),
                                int(niter), int(base_size), out.ctypes.data)
    return out


def gdt(cost: np.ndarray, seeds_x, seeds_y) -> np.ndarray:
    """Geodesic distance of each pixel of the (H, W) float32 edge ``cost``
    from the seeds, (H, W) float32."""
    cost = np.ascontiguousarray(cost, np.float32)
    if cost.ndim != 2:
        raise ValueError(f"expected an (H, W) cost map, got {cost.shape}")
    h, w = cost.shape
    sx, sy = _seeds(seeds_x, seeds_y, h, w)
    out = np.empty((h, w), np.float32)
    build().radet_gdt_transform(cost.ctypes.data, h, w, sx.ctypes.data, sy.ctypes.data, len(sx), out.ctypes.data)
    return out


def sobel_cost(gray: np.ndarray) -> np.ndarray:
    """|cv2.addWeighted(Sobel_x, 0.5, Sobel_y, 0.5, 0)| of an (H, W) uint8
    image (``cv2.Sobel(gray, cv2.CV_32F, ., ., ksize=3)``), float32."""
    gray = np.ascontiguousarray(gray)
    if gray.dtype != np.uint8 or gray.ndim != 2 or min(gray.shape) < 2:
        raise ValueError(f"expected an (H, W) uint8 image of at least 2x2, got {gray.dtype} {gray.shape}")
    out = np.empty(gray.shape, np.float32)
    build().radet_sobel_cost(gray.ctypes.data, *gray.shape, out.ctypes.data)
    return out


# -------------------------------------------------------------- numpy twins


def mbd_plain(image: np.ndarray, seeds_x, seeds_y, alpha: float = 0.1, niter: int = 4,
              base_size: int = 300) -> np.ndarray:
    """numpy twin of :func:`mbd`: the same raster scans in Python loops."""
    h, w = image.shape[:2]
    sx_i, sy_i = _seeds(seeds_x, seeds_y, h, w)
    size_factor = 400.0 if h * w < base_size ** 2 else 400.0 * (w * h / (base_size ** 2))
    a = float(np.float32(alpha))  # the C++ takes alpha as a float
    factor = a * a / size_factor
    img = image.astype(np.int32)
    label = np.full((h, w), -1, np.int32)
    dmap = np.full((h, w), 255.0, np.float64)
    hi, lo = img.copy(), img.copy()
    label[sy_i, sx_i] = np.arange(len(sx_i))
    dmap[sy_i, sx_i] = 0.0
    sx, sy = sx_i.astype(np.float64), sy_i.astype(np.float64)
    for it in range(niter):
        fwd = it % 2 == 0
        ys = range(h) if fwd else range(h - 1, -1, -1)
        xs = range(w) if fwd else range(w - 1, -1, -1)
        offs = ((-1, 0), (0, -1)) if fwd else ((1, 0), (0, 1))
        for y in ys:
            for x in xs:
                for dx, dy in offs:
                    nx, ny = x + dx, y + dy
                    if not (0 <= nx < w and 0 <= ny < h) or label[ny, nx] < 0:
                        continue
                    nl = label[ny, nx]
                    mx = np.maximum(hi[ny, nx], img[y, x])
                    mn = np.minimum(lo[ny, nx], img[y, x])
                    cost = float((mx - mn).max()) / 255.0
                    cost = cost * cost + factor * ((sy[nl] - y) ** 2 + (sx[nl] - x) ** 2)
                    if cost < dmap[y, x]:
                        dmap[y, x], label[y, x], hi[y, x], lo[y, x] = cost, nl, mx, mn
    return dmap


def gdt_plain(cost: np.ndarray, seeds_x, seeds_y) -> np.ndarray:
    """numpy twin of :func:`gdt`: the same two chamfer passes in Python
    loops, in float32."""
    cost = np.asarray(cost, np.float32)
    h, w = cost.shape
    sx, sy = _seeds(seeds_x, seeds_y, h, w)
    c1, c2 = np.float32(0.5), np.float32(np.sqrt(np.float32(2))) / np.float32(2)
    dist = np.full((h, w), 255.0, np.float32)
    dist[sy, sx] = cost[sy, sx]

    def relax(cy, cx, py, px, coef):
        d = dist[py, px] + coef * (cost[cy, cx] + cost[py, px])
        if dist[cy, cx] > d:
            dist[cy, cx] = d

    for j in range(1, w):
        relax(0, j, 0, j - 1, c1)
    for i in range(1, h):
        relax(i, 0, i - 1, 0, c1)
        if w > 1:
            relax(i, 0, i - 1, 1, c2)
        for j in range(1, w - 1):
            relax(i, j, i, j - 1, c1)
            relax(i, j, i - 1, j - 1, c2)
            relax(i, j, i - 1, j, c1)
            relax(i, j, i - 1, j + 1, c2)
        if w > 1:
            relax(i, w - 1, i, w - 2, c1)
            relax(i, w - 1, i - 1, w - 2, c2)
            relax(i, w - 1, i - 1, w - 1, c1)
    for j in range(w - 2, -1, -1):
        relax(h - 1, j, h - 1, j + 1, c1)
    for i in range(h - 2, -1, -1):
        relax(i, w - 1, i + 1, w - 1, c1)
        if w > 1:
            relax(i, w - 1, i + 1, w - 2, c2)
        for j in range(w - 2, 0, -1):
            relax(i, j, i, j + 1, c1)
            relax(i, j, i + 1, j + 1, c2)
            relax(i, j, i + 1, j, c1)
            relax(i, j, i + 1, j - 1, c2)
        if w > 1:
            relax(i, 0, i, 1, c1)
            relax(i, 0, i + 1, 1, c2)
            relax(i, 0, i + 1, 0, c1)
    return dist


def sobel_cost_plain(gray: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`sobel_cost`."""
    x = np.pad(gray.astype(np.int32), 1, mode="reflect")
    dx = (x[:-2, 2:] - x[:-2, :-2]) + 2 * (x[1:-1, 2:] - x[1:-1, :-2]) + (x[2:, 2:] - x[2:, :-2])
    dy = (x[2:, :-2] - x[:-2, :-2]) + 2 * (x[2:, 1:-1] - x[:-2, 1:-1]) + (x[2:, 2:] - x[:-2, 2:])
    half = np.float32(0.5)
    return np.abs(half * dx.astype(np.float32) + half * dy.astype(np.float32))


# ------------------------------------------------------------- the maps


def border_seeds(h: int, w: int, interval: int = 3):
    """Seeds every ``interval`` pixels along the top and bottom rows (the
    last column always) and the left and right columns: (seeds_x, seeds_y)
    int64."""
    hx = list(range(0, w, interval))
    if hx[-1] != w - 1:
        hx.append(w - 1)
    hx = np.asarray(hx, np.int64)
    vy = np.arange(1, h - 1, interval, dtype=np.int64)
    seeds_x = np.concatenate([hx, hx, np.zeros_like(vy), np.full_like(vy, w - 1)])
    seeds_y = np.concatenate([np.zeros_like(hx), np.full_like(hx, h - 1), vy, vy])
    return seeds_x, seeds_y


def sobel_edges(image: np.ndarray) -> np.ndarray:
    """The GDT's edge cost of an (H, W, 3) uint8 RGB image: a 3x3 Gaussian
    blur, cv2's gray, the Sobel cost, scaled to a maximum of 1."""
    edge = sobel_cost(color_aug.rgb_to_gray(color_aug.gaussian_blur(image, ksize=3)))
    m = edge.max()
    return edge / m if m > 0 else edge


def shrink(box_image: np.ndarray) -> np.ndarray:
    """A padded crop resized to a short edge of RESIZE_SHORT (each side at
    least 2 px) and blurred: the transforms' input."""
    h, w = box_image.shape[:2]
    ratio = RESIZE_SHORT / max(1, min(h, w))
    nw, nh = max(2, int(w * ratio)), max(2, int(h * ratio))
    small = box_image if (nw, nh) == (w, h) else resize_linear(box_image, (nw, nh))
    return color_aug.gaussian_blur(small, ksize=9)


def estimate_map(box_image: np.ndarray, method: str, alpha: float = 0.1, niter: int = 4, base_size: int = 300,
                 interval: int = 3) -> np.ndarray:
    """The distance map of a padded crop at the crop's size, float32: the
    transform of :func:`shrink`'s image from its border seeds, resized
    back."""
    if method not in METHODS:
        raise ValueError(f"unknown distance transform {method!r}")
    small = shrink(box_image)
    sx, sy = border_seeds(*small.shape[:2], interval)
    if method == "mbd":
        dmap = mbd(small, sx, sy, alpha, niter, base_size).astype(np.float32)
    else:
        dmap = gdt(sobel_edges(small), sx, sy)
    return resize_linear_f32(dmap, box_image.shape[1::-1])


def padded_crop(img: np.ndarray, box, pad_ratio: float, fill) -> tuple:
    """The crop of integer ``box`` (x1, y1, x2, y2, inside the image) padded
    by ``ceil(side * pad_ratio)`` on each side, the area outside the image
    ``fill`` (an RGB colour): (crop, pad_x, pad_y)."""
    img_h, img_w = img.shape[:2]
    x1, y1, x2, y2 = box
    px, py = math.ceil((x2 - x1) * pad_ratio), math.ceil((y2 - y1) * pad_ratio)
    crop = np.empty((y2 - y1 + 2 * py, x2 - x1 + 2 * px, 3), np.uint8)
    crop[:] = fill
    sx1, sy1 = max(0, x1 - px), max(0, y1 - py)
    sx2, sy2 = min(img_w, x2 + px), min(img_h, y2 + py)
    dx1, dy1 = sx1 - (x1 - px), sy1 - (y1 - py)
    crop[dy1:dy1 + (sy2 - sy1), dx1:dx1 + (sx2 - sx1)] = img[sy1:sy2, sx1:sx2]
    return crop, px, py


def boxes_to_distance_maps(img: np.ndarray, gt_bboxes: np.ndarray, method: str = "gdt",
                           small_object_size: float = 32 ** 2, pad_ratio: float = 0.05, alpha: float = 0.1,
                           niter: int = 4, base_size: int = 300, interval: int = 3,
                           rng: Optional[random.Random] = None) -> np.ndarray:
    """Per-GT distance maps in the frame of ``img``, (H, W, 3) uint8 RGB:
    (G, H, W) float32, zero outside each GT's (clipped, integer) box; a box
    of a side of at most 1 px gets none, a box with (w + 1)(h + 1) at most
    ``small_object_size`` a uniform 1 inside.  ``rng`` draws the fill
    colours (None: Python's ``random``).  An unknown ``method`` raises
    ``ValueError`` where the first large box reaches it, as JAX's does."""
    rng = rng or random
    img_h, img_w = img.shape[:2]
    out = np.zeros((len(gt_bboxes), img_h, img_w), np.float32)
    for g, bbox in enumerate(gt_bboxes):
        x1, y1, x2, y2 = [int(v) for v in bbox]
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(img_w, x2), min(img_h, y2)
        bw, bh = x2 - x1, y2 - y1
        if bw <= 1 or bh <= 1:
            continue
        if (bw + 1) * (bh + 1) <= small_object_size:
            out[g, y1:y2, x1:x2] = 1.0
            continue
        crop, px, py = padded_crop(img, (x1, y1, x2, y2), pad_ratio, [rng.randint(0, 255) for _ in range(3)])
        inner = estimate_map(crop, method, alpha, niter, base_size, interval)[py:py + bh, px:px + bw]
        m = inner.max()
        out[g, y1:y2, x1:x2] = inner / m if m > 0 else inner
    return out
