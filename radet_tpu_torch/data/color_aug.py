"""CosyPose colour augmentation without cv2 or PIL (port of the CosyPose ops
of ``radet_tpu/data/pipeline.py``: ``_pil_gray``, ``_NpEnhance``,
``PillowBlur``, the ``Pillow*`` factories and ``CosyPoseAug``).

The JAX package runs these ops on uint8 RGB images through cv2; here
``csrc/color_aug.cpp`` repeats cv2's arithmetic, so that every output is
cv2's byte for byte:

- Brightness and Contrast: a 256-entry table, computed here in float32 as
  the JAX package computes it (Contrast's mean is ``int(gray.mean() +
  0.5)`` of PIL's gray, in float64), applied by ``radet_lut``;
- Color: ``cv2.addWeighted(img, f, gray, 1 - f, 0)`` with the gray
  broadcast over the channels (``radet_pil_gray``, ``radet_add_weighted``:
  fmaf in float32, rounded half to even, saturated);
- Sharpness: the same blend with PIL's SMOOTH of the image
  (``radet_smooth3x3``: the 3x3 kernel [[1,1,1],[1,5,1],[1,1,1]] / 13 on
  the interior, the 1-px border copied);
- Blur: ``cv2.GaussianBlur(img, (0, 0), sigma)`` at an integer sigma, cv2's
  fixed-point separable filter with its integer taps (``GAUSSIAN_TAPS``,
  sigma 1 to 10, taken from cv2 by ``tests/data/color_aug/make_fixtures.py``);
  another sigma raises.  The same filter at a kernel size with sigma 0,
  ``cv2.GaussianBlur(img, (k, k), 0)`` (``GAUSSIAN_KSIZE_TAPS``, k 3 and 9),
  blurs the mask-free distance maps' crops (``ops/distance_transform.py``).

Beside the CosyPose ops, ``rgb_to_gray`` is cv2's fixed-point gray: of
``cv2.cvtColor(img, COLOR_RGB2GRAY)`` (15 fractional bits in cv2 5.0; the
mask-free maps' Sobel cost) and of ``cv2.imread`` reading a colour TIFF as
gray (14 bits; ``data/image_io.py``); ``rgb_to_hsv_f32`` and
``hsv_to_rgb_f32`` are ``cv2.cvtColor``'s float32 RGB<->HSV
(``PhotoMetricDistortion``'s), in OpenCV's arithmetic: its AVX2 code takes
8 pixels a vector and fuses the multiply-adds named in the twins'
docstrings, its scalar code the last W % 8 pixels of a row.
``rgb_to_hsv_u8`` and ``hsv_to_rgb_u8`` are its uint8 pair (H in [0, 180);
``RandomHSV``'s and InstaBoost's): the forward one in cv2's 12-bit fixed
point, the backward one in float32, each channel's product with 255
truncated in cv2 5.0's vector code (32 pixels a step) and rounded in its
scalar code (the last W % 32 pixels of a row).  ``box_blur`` is ``cv2.blur(img, (k, k))``
(``RandomSmooth``'s).

The ``*_plain`` functions are the numpy twins of the C++ functions, which
the tests hold equal to them and to cv2; the training path calls the C++
ones.  The library is built at first use into ``radet_tpu_torch/_build/``
with the host C++ compiler (a failed build raises) and called through
``ctypes``, which releases the interpreter lock, so loader threads run the
ops in parallel.

The random draws are the JAX package's, in its order: ``CosyPoseAug``'s
``random() > p``, then for each op ``random() <= p`` and its
``uniform(*factor_interval)`` (``randint`` for the blur's sigma), from
Python's ``random`` or from the chain's own ``random.Random(seed)``.
"""

from __future__ import annotations

import ctypes
import random
from types import SimpleNamespace
from typing import Any, Dict, Optional, Sequence

import numpy as np

from ..utils.native import CSRC, load_library
from .gaussian_taps import GAUSSIAN_KSIZE_TAPS, GAUSSIAN_TAPS

SOURCE = CSRC / "color_aug.cpp"
# -ffp-contract=off: no fused multiply-add beyond the explicit fmaf
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
_SIGMA = "ROADMAP.md Queue 1 item 12, Gaussian blur at a sigma outside 1-10"

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_API = {
    "radet_gaussian_blur": ([_P, _P, _I64, _I64, _I64, _P, ctypes.c_int], ctypes.c_int),
    "radet_smooth3x3": ([_P, _P, _I64, _I64, _I64], None),
    "radet_add_weighted": ([_P, _P, _P, _I64, _I64, _I64, ctypes.c_float, ctypes.c_float], None),
    "radet_lut": ([_P, _P, _I64, _P], None),
    "radet_pil_gray": ([_P, _P, _I64], None),
    "radet_rgb_to_gray": ([_P, _P, _I64, _I64, ctypes.c_int], None),
    "radet_rgb_to_hsv_f32": ([_P, _P, _I64, _I64], None),
    "radet_hsv_to_rgb_f32": ([_P, _P, _I64], None),
    "radet_rgb_to_hsv_u8": ([_P, _P, _I64], None),
    "radet_hsv_to_rgb_u8": ([_P, _P, _I64, _I64], None),
    "radet_box_blur": ([_P, _P, _I64, _I64, _I64, ctypes.c_int], ctypes.c_int),
}
GRAY_SHIFTS = (14, 15)  # imread's gray of a colour TIFF, cvtColor's COLOR_RGB2GRAY

_F32 = np.float32
_FLT_EPSILON = np.finfo(np.float32).eps
# cv2's float colour conversions run 8 pixels a vector (its AVX2 code); the
# last W % 8 pixels of a row take its scalar code
_HSV_LANES = 8
# its uint8 HSV -> RGB code takes 32 pixels a step
_HSV_U8_PIXELS = 32


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the library."""
    return load_library(SOURCE, CXX_FLAGS, _API)


def _hwc(img: np.ndarray) -> np.ndarray:
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"expected an (H, W, C) uint8 image, got {img.dtype} {img.shape}")
    return np.ascontiguousarray(img)


def _taps(sigma: int, ksize: int = 0) -> np.ndarray:
    """The integer taps of sigma ``sigma``, or of kernel size ``ksize`` at
    sigma 0."""
    if ksize:
        if sigma or ksize not in GAUSSIAN_KSIZE_TAPS:
            raise NotImplementedError(f"Gaussian blur at kernel size {ksize!r} and sigma {sigma!r} ({_SIGMA})")
        return np.asarray(GAUSSIAN_KSIZE_TAPS[ksize], np.int32)
    if sigma not in GAUSSIAN_TAPS:
        raise NotImplementedError(f"Gaussian blur at sigma {sigma!r} ({_SIGMA})")
    return np.asarray(GAUSSIAN_TAPS[sigma], np.int32)


def _gray_coefficients(shift: int):
    if shift not in GRAY_SHIFTS:
        raise ValueError(f"gray at {shift} fractional bits: cv2 uses {GRAY_SHIFTS}")
    one = 1 << shift
    cr, cg = int(0.299 * one + 0.5), int(0.587 * one + 0.5)
    return cr, cg, one - cr - cg


# ------------------------------------------------------------ C++ functions


def gaussian_blur(img: np.ndarray, sigma: int = 0, ksize: int = 0) -> np.ndarray:
    """``cv2.GaussianBlur(img, (0, 0), sigmaX=sigma)`` on uint8 (H, W, C);
    with ``ksize``, ``cv2.GaussianBlur(img, (ksize, ksize), 0)``."""
    img = _hwc(img)
    taps = _taps(sigma, ksize)
    out = np.empty_like(img)
    h, w, c = img.shape
    if build().radet_gaussian_blur(img.ctypes.data, out.ctypes.data, h, w, c, taps.ctypes.data, len(taps)):
        raise ValueError(f"Gaussian blur of a {img.shape} image with taps {taps.tolist()}")
    return out


def smooth(img: np.ndarray) -> np.ndarray:
    """PIL's SMOOTH filter on the interior, the 1-px border kept."""
    img = _hwc(img)
    out = np.empty_like(img)
    build().radet_smooth3x3(img.ctypes.data, out.ctypes.data, *img.shape)
    return out


def add_weighted(a: np.ndarray, b: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """``cv2.addWeighted(a, alpha, b, beta, 0)``; ``b`` is an image of
    ``a``'s shape or an (H, W) channel used for every channel of ``a``."""
    a = _hwc(a)
    b = np.ascontiguousarray(b)
    if b.dtype != np.uint8 or b.shape not in (a.shape, a.shape[:2]):
        raise ValueError(f"cannot blend a {b.dtype} {b.shape} image into {a.shape}")
    out = np.empty_like(a)
    h, w, c = a.shape
    b_step = c if b.ndim == 3 else 1
    build().radet_add_weighted(a.ctypes.data, b.ctypes.data, out.ctypes.data, h * w, c, b_step, alpha, beta)
    return out


def apply_lut(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """``cv2.LUT(img, lut)`` with one uint8 table of 256 entries."""
    img = np.ascontiguousarray(img)
    lut = np.ascontiguousarray(lut, np.uint8)
    if img.dtype != np.uint8 or lut.shape != (256,):
        raise ValueError(f"LUT of a {img.dtype} image with a {lut.shape} table")
    out = np.empty_like(img)
    build().radet_lut(img.ctypes.data, out.ctypes.data, img.size, lut.ctypes.data)
    return out


def pil_gray(img: np.ndarray) -> np.ndarray:
    """PIL's mode-'L' conversion of an RGB image, (H, W) uint8."""
    img = _hwc(img)
    if img.shape[2] != 3:
        raise ValueError(f"expected an RGB image, got {img.shape}")
    out = np.empty(img.shape[:2], np.uint8)
    build().radet_pil_gray(img.ctypes.data, out.ctypes.data, img.shape[0] * img.shape[1])
    return out


def rgb_to_gray(img: np.ndarray, shift: int = 15) -> np.ndarray:
    """cv2's gray of (H, W, C >= 3) uint8 ``img`` (R, G, B first), (H, W)
    uint8: ``shift`` 15 is ``cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)``, 14 the
    gray ``cv2.imread`` makes of a colour TIFF (see the module docstring)."""
    img = _hwc(img)
    if img.shape[2] < 3:
        raise ValueError(f"expected RGB pixels, got {img.shape}")
    _gray_coefficients(shift)
    out = np.empty(img.shape[:2], np.uint8)
    build().radet_rgb_to_gray(img.ctypes.data, out.ctypes.data, img.shape[0] * img.shape[1], img.shape[2], shift)
    return out


def _hwc3_f32(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return np.ascontiguousarray(img, np.float32)


def rgb_to_hsv_f32(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of an (H, W, 3) float32
    image, bit for bit: H in degrees, S in [0, 1], V the input's max."""
    img = _hwc3_f32(img)
    out = np.empty_like(img)
    build().radet_rgb_to_hsv_f32(img.ctypes.data, out.ctypes.data, img.shape[0], img.shape[1])
    return out


def hsv_to_rgb_f32(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of an (H, W, 3) float32
    image (H in degrees), bit for bit."""
    hsv = _hwc3_f32(hsv)
    out = np.empty_like(hsv)
    build().radet_hsv_to_rgb_f32(hsv.ctypes.data, out.ctypes.data, hsv.shape[0] * hsv.shape[1])
    return out


def _hwc3_u8(img: np.ndarray) -> np.ndarray:
    img = _hwc(img)
    if img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    return img


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` of an (H, W, 3) uint8 image,
    byte for byte: H in [0, 180), S and V in [0, 255]."""
    img = _hwc3_u8(img)
    out = np.empty_like(img)
    build().radet_rgb_to_hsv_u8(img.ctypes.data, out.ctypes.data, img.shape[0] * img.shape[1])
    return out


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` of an (H, W, 3) uint8 image
    (H in [0, 180)), byte for byte."""
    hsv = _hwc3_u8(hsv)
    out = np.empty_like(hsv)
    build().radet_hsv_to_rgb_u8(hsv.ctypes.data, out.ctypes.data, hsv.shape[0], hsv.shape[1])
    return out


def box_blur(img: np.ndarray, ksize: int) -> np.ndarray:
    """``cv2.blur(img, (ksize, ksize))`` of an (H, W, C) uint8 image, ksize
    odd (1 gives a copy), byte for byte."""
    img = _hwc(img)
    out = np.empty_like(img)
    if build().radet_box_blur(img.ctypes.data, out.ctypes.data, *img.shape, int(ksize)):
        raise ValueError(f"box blur of a {img.shape} image at kernel size {ksize!r} (odd, >= 1)")
    return out


# -------------------------------------------------------------- numpy twins


def gaussian_blur_plain(img: np.ndarray, sigma: int = 0, ksize: int = 0) -> np.ndarray:
    """numpy twin of :func:`gaussian_blur`: int64 sums over a
    BORDER_REFLECT_101 padding."""
    taps = _taps(sigma, ksize).astype(np.int64)
    r = len(taps) // 2
    h, w = img.shape[:2]
    x = np.pad(img.astype(np.int64), ((r, r), (r, r), (0, 0)), mode="reflect")
    rows = sum(k * x[:, j:j + w] for j, k in enumerate(taps))
    out = sum(k * rows[i:i + h] for i, k in enumerate(taps))
    return np.minimum(255, (out + (1 << 15)) >> 16).astype(np.uint8)


def smooth_plain(img: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`smooth`."""
    x = img.astype(np.int32)
    s = 4 * x[1:-1, 1:-1] + sum(x[1 + dy:x.shape[0] - 1 + dy, 1 + dx:x.shape[1] - 1 + dx]
                                for dy in (-1, 0, 1) for dx in (-1, 0, 1))
    out = img.copy()
    out[1:-1, 1:-1] = (2 * s + 13) // 26
    return out


def add_weighted_plain(a: np.ndarray, b: np.ndarray, alpha: float, beta: float) -> np.ndarray:
    """numpy twin of :func:`add_weighted`: a * alpha is exact in float64,
    and adding float32(b * beta) there and rounding once to float32 is
    fmaf's result for these operands."""
    if b.ndim == 2:
        b = b[..., None]
    bb = b.astype(np.float32) * np.float32(beta)
    v = (a.astype(np.float64) * np.float64(np.float32(alpha)) + bb.astype(np.float64)).astype(np.float32)
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def apply_lut_plain(img: np.ndarray, lut: np.ndarray) -> np.ndarray:
    return np.asarray(lut, np.uint8)[img]


def pil_gray_plain(img: np.ndarray) -> np.ndarray:
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def rgb_to_gray_plain(img: np.ndarray, shift: int = 15) -> np.ndarray:
    """numpy twin of :func:`rgb_to_gray`."""
    cr, cg, cb = _gray_coefficients(shift)
    r, g, b = (img[..., i].astype(np.uint32) for i in range(3))
    return ((r * cr + g * cg + b * cb + (1 << (shift - 1))) >> shift).astype(np.uint8)


NATIVE = SimpleNamespace(blur=gaussian_blur, smooth=smooth, add_weighted=add_weighted, lut=apply_lut,
                         gray=pil_gray)


def _fma32(a, b, c) -> np.ndarray:
    """float32 ``fma(a, b, c)``, rounded once: the product is exact in
    float64; where the float64 sum lies on a tie between two float32s, its
    rounding error (TwoSum) sends it to the side of the exact value."""
    a, b, c = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    out = s.astype(np.float32)
    # a tie: the 29 bits that float32 drops are 1 << 28
    tie = np.flatnonzero((s.view(np.uint64) & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28))
    if tie.size:
        pt, ct, st = (np.broadcast_to(x, s.shape).ravel()[tie] for x in (p, c, s))
        v = st - pt
        err = (pt - (st - v)) + (ct - v)
        fixed = np.where(err != 0, np.nextafter(st, np.where(err > 0, np.inf, -np.inf)), st)
        out.ravel()[tie] = fixed.astype(np.float32)
    return out


def rgb_to_hsv_f32_plain(img: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`rgb_to_hsv_f32`: V = max, S = (V - min) / (|V|
    + FLT_EPSILON), and H = fma(d, 60 / (V - min + FLT_EPSILON), base), d
    and base by the maximum's channel (R: g - b and 0, or 360 in cv2's
    vector code where g < b; G: b - r and 120; B: r - g and 240), cv2's
    scalar tail adding 360 after a negative result."""
    r, g, b = (np.ascontiguousarray(img[..., i], np.float32) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    s = diff / (np.abs(v) + _FLT_EPSILON)
    r_max = r == v
    g_max = (g == v) & ~r_max
    d = np.where(r_max, g - b, np.where(g_max, b - r, r - g))
    base = np.where(g_max, _F32(120), _F32(240))
    base[r_max] = 0
    vector = np.arange(img.shape[1]) < img.shape[1] // _HSV_LANES * _HSV_LANES
    base[vector & r_max & (g < b)] = 360
    h = _fma32(d, _F32(60) / (diff + _FLT_EPSILON), base)
    h[~vector & (h < 0)] += _F32(360)
    return np.stack([h, s, v], -1)


# (b, g, r) entries of the tab per sector, OpenCV's HSV2RGB table
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_f32_plain(hsv: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`hsv_to_rgb_f32`: h = H * float32(6 / 360), sector
    trunc(h) mod 6, f = h - trunc(h), and the tab v, v(1 - s), v * fma(-s,
    f, 1), v * fma(-s, 1 - f, 1) picked by sector (cv2's build contracts
    ``1 - s * f`` into a fused multiply-add)."""
    h = hsv[..., 0].astype(np.float32) * (_F32(6) / _F32(360))
    s, v = hsv[..., 1].astype(np.float32), hsv[..., 2].astype(np.float32)
    whole = np.trunc(h)
    f = h - whole
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    sector = (whole - np.trunc(whole * (_F32(1) / _F32(6))) * _F32(6)).astype(np.int64)
    sector[(sector < 0) | (sector >= 6)] = 0
    return np.take_along_axis(tab, _HSV_SECTORS[sector][..., ::-1], -1)


def _hsv_tables():
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.concatenate([[0], np.rint((255 << 12) / i)]).astype(np.int64)
    hdiv = np.concatenate([[0], np.rint((180 << 12) / (6 * i))]).astype(np.int64)
    return sdiv, hdiv


def rgb_to_hsv_u8_plain(img: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`rgb_to_hsv_u8`: V = max, diff = V - min, S =
    (diff * sdiv[V] + 2^11) >> 12, H = (h * hdiv[diff] + 2^11) >> 12 (+180
    when negative), h = g - b, b - r + 2 diff or r - g + 4 diff as R, G or B
    is the maximum (in that order), sdiv[x] = round(255 * 2^12 / x), hdiv[x] =
    round(180 * 2^12 / (6 x))."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    sdiv, hdiv = _hsv_tables()
    s = (diff * sdiv[v] + (1 << 11)) >> 12
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * hdiv[diff] + (1 << 11)) >> 12
    h = np.where(h < 0, h + 180, h)
    return np.stack([np.minimum(h, 255), s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8_plain(hsv: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`hsv_to_rgb_u8`: s, v = S, V times float32(1 /
    255), h = H * float32(6 / 180), sector floor(h) mod 6, f = h - floor(h),
    the tab v, v(1 - s), v * fma(-s, f, 1), v * fma(-s, 1 - f, 1) picked by
    sector, each channel 255 x truncated, or rounded in the last W % 32
    pixels of a row."""
    h = hsv[..., 0].astype(np.float32) * (_F32(6) / _F32(180))
    s = hsv[..., 1].astype(np.float32) * (_F32(1) / _F32(255))
    v = hsv[..., 2].astype(np.float32) * (_F32(1) / _F32(255))
    whole = np.floor(h)
    f = h - whole
    one = _F32(1)
    tab = np.stack([v, v * (one - s), v * _fma32(-s, f, one), v * _fma32(-s, one - f, one)], -1)
    sector = whole.astype(np.int64) % 6
    rgb = np.take_along_axis(tab, _HSV_SECTORS[sector][..., ::-1], -1) * _F32(255)
    vector = np.arange(hsv.shape[1]) < hsv.shape[1] // _HSV_U8_PIXELS * _HSV_U8_PIXELS
    rgb = np.where(vector[:, None], np.trunc(rgb), np.rint(rgb))
    return np.minimum(rgb, 255).astype(np.uint8)


def box_blur_plain(img: np.ndarray, ksize: int) -> np.ndarray:
    """numpy twin of :func:`box_blur`: int64 sums over a BORDER_REFLECT_101
    padding, (sum + k^2 // 2) // k^2."""
    if ksize < 1 or not ksize % 2:
        raise ValueError(f"box blur at kernel size {ksize!r} (odd, >= 1)")
    r = ksize // 2
    h, w = img.shape[:2]
    x = np.pad(img.astype(np.int64), ((r, r), (r, r), (0, 0)), mode="reflect")
    rows = sum(x[:, j:j + w] for j in range(ksize))
    total = sum(rows[i:i + h] for i in range(ksize))
    return ((total + ksize * ksize // 2) // (ksize * ksize)).astype(np.uint8)


PLAIN = SimpleNamespace(blur=gaussian_blur_plain, smooth=smooth_plain, add_weighted=add_weighted_plain,
                        lut=apply_lut_plain, gray=pil_gray_plain)


# -------------------------------------------------------------------- ops


def enhance(name: str, img: np.ndarray, factor: float, ops=NATIVE) -> np.ndarray:
    """PIL's ImageEnhance ``name`` (Brightness, Contrast, Color, Sharpness)
    at ``factor``, as the JAX package's ``_NpEnhance._apply``; ``ops`` is
    :data:`NATIVE` or the twins, :data:`PLAIN`."""
    i = np.arange(256, dtype=np.float32)
    if name == "Brightness":
        return ops.lut(img, np.clip(np.floor(i * factor + 0.5), 0, 255).astype(np.uint8))
    if name == "Contrast":
        mean = int(ops.gray(img).mean() + 0.5)  # float64 mean: a 1/2 tie decides the table
        return ops.lut(img, np.clip(np.floor(mean + factor * (i - mean) + 0.5), 0, 255).astype(np.uint8))
    if name == "Color":
        return ops.add_weighted(img, ops.gray(img), factor, 1.0 - factor)
    if name == "Sharpness":
        return ops.add_weighted(img, ops.smooth(img), factor, 1.0 - factor)
    raise ValueError(f"unknown enhancement {name!r}")


class _Enhance:
    """With probability ``p`` (``random() <= p``), ``name`` at a factor
    drawn by ``uniform(*factor_interval)``."""

    def __init__(self, name: str, p: float, factor_interval):
        self.name = name
        self.p = p
        self.factor_interval = tuple(factor_interval)
        self.rng: Optional[random.Random] = None  # None: Python's random

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng or random
        if rng.random() <= self.p:
            img = enhance(self.name, img, rng.uniform(*self.factor_interval))
        return img


class PillowBlur:
    """With probability ``p``, a Gaussian blur at sigma
    ``randint(*factor_interval)`` (the JAX package honours ``p``)."""

    def __init__(self, p: float = 0.4, factor_interval=(1, 3)):
        self.p = p
        self.factor_interval = tuple(factor_interval)
        self.rng: Optional[random.Random] = None

    def __call__(self, img: np.ndarray) -> np.ndarray:
        rng = self.rng or random
        if rng.random() <= self.p:
            img = gaussian_blur(img, rng.randint(*self.factor_interval))
        return img


def PillowSharpness(p=0.3, factor_interval=(0.0, 50.0)):
    return _Enhance("Sharpness", p, factor_interval)


def PillowContrast(p=0.3, factor_interval=(0.2, 50.0)):
    return _Enhance("Contrast", p, factor_interval)


def PillowBrightness(p=0.5, factor_interval=(0.1, 6.0)):
    return _Enhance("Brightness", p, factor_interval)


def PillowColor(p=0.3, factor_interval=(0.0, 20.0)):
    return _Enhance("Color", p, factor_interval)


OPS = {
    "PillowBlur": PillowBlur,
    "PillowSharpness": PillowSharpness,
    "PillowContrast": PillowContrast,
    "PillowBrightness": PillowBrightness,
    "PillowColor": PillowColor,
}


class CosyPoseAug:
    """With probability ``p`` (``random() > p`` skips), the ``pipelines``
    ops in turn on ``results['img']``; each op draws its own decision and
    factor.  ``seed`` gives the chain one generator of its own, shared by
    its ops."""

    def __init__(self, p: float = 0.8, pipelines: Sequence[dict] = (), seed: Optional[int] = None):
        self.p = p
        self.rng = None if seed is None else random.Random(seed)
        self.ops = []
        for op_cfg in pipelines:
            op_cfg = dict(op_cfg)
            op = OPS[op_cfg.pop("type")](**op_cfg)
            op.rng = self.rng
            self.ops.append(op)

    def __call__(self, results: Dict[str, Any]) -> Dict[str, Any]:
        if (self.rng or random).random() > self.p:
            return results
        img = results["img"]
        for op in self.ops:
            img = op(img)
        results["img"] = img
        return results
