"""Affine warps without cv2 (the geometry of ``data/auto_augment.py`` and
``data/instaboost.py``).

The JAX package warps images and masks with ``cv2.warpAffine``, builds
rotations with ``cv2.getRotationMatrix2D`` and grows InstaBoost's hole with
``cv2.dilate``; here ``csrc/warp_affine.cpp`` repeats cv2 5.0's arithmetic,
so that every output is cv2's byte for byte:

- :func:`warp_affine`: the matrix inverted in float64 and rounded to
  float32, each point by fused multiply-adds in the order of cv2's vector
  code (16 pixels a step) or, over the last W % 16 columns of a row, of its
  scalar code, then bilinear (fused blends, rounded half to even) or
  nearest (the point rounded half to even) sampling, with a constant fill
  outside the image (the function's docstring has the rest);
- :func:`dilate3x3`: the 3x3 maximum within the image;
- :func:`rotation_matrix_2d`: ``getRotationMatrix2D`` in float64, the
  centre taken as float32 (cv2's ``Point2f``); plain Python.

The ``*_plain`` functions are the numpy twins of the C++ functions, which
the tests hold equal to them and to cv2; the pipelines call the C++ ones.
The library is built at first use into ``radet_tpu_torch/_build/`` (a
failed build raises) and called through ``ctypes``, which releases the
interpreter lock, so loader threads run the warps in parallel.
"""

from __future__ import annotations

import ctypes
import math
from typing import Sequence, Union

import numpy as np

from ..utils.native import CSRC, load_library
from .color_aug import _fma32

SOURCE = CSRC / "warp_affine.cpp"
# -ffp-contract=off: no fused multiply-add beyond the explicit fmaf
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-ffp-contract=off"]
INTERPOLATIONS = ("bilinear", "nearest")
# cv2's warp takes 16 pixels a step; the last W % 16 of a row take its scalar code
_WARP_PIXELS = 16

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_API = {
    "radet_warp_affine": ([_P, _P, _I64, _I64, _I64, _P, _P, ctypes.c_int], ctypes.c_int),
    "radet_dilate3x3": ([_P, _P, _I64, _I64], None),
}

Fill = Union[float, Sequence[float]]


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the library."""
    return load_library(SOURCE, CXX_FLAGS, _API)


def _fill_values(fill: Fill, channels: int) -> np.ndarray:
    """cv2's border value for ``channels`` channels: a sequence gives one
    value a channel, a scalar ``s`` is ``cv2.Scalar(s)`` = (s, 0, 0, 0)."""
    vals = [float(v) for v in fill] if isinstance(fill, (tuple, list, np.ndarray)) else [float(fill)]
    vals = (vals + [0.0] * 4)[:4]
    return np.asarray(vals[:channels], np.float64)


def _check(img: np.ndarray, mat, interpolation: str):
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and not 1 <= img.shape[2] <= 4):
        raise ValueError(f"expected an (H, W) or (H, W, C <= 4) uint8 image, got {img.dtype} {img.shape}")
    if interpolation not in INTERPOLATIONS:
        raise ValueError(f"interpolation must be one of {INTERPOLATIONS}, got {interpolation!r}")
    mat = np.asarray(mat, np.float64)
    if mat.shape not in ((2, 3), (3, 3)):
        raise ValueError(f"expected a 2x3 affine matrix, got shape {mat.shape}")
    return np.ascontiguousarray(img), np.ascontiguousarray(mat[:2])


def warp_affine(img: np.ndarray, mat, fill: Fill = 0, interpolation: str = "bilinear") -> np.ndarray:
    """``cv2.warpAffine(img, mat, (W, H), flags=INTER_LINEAR or
    INTER_NEAREST, borderMode=BORDER_CONSTANT, borderValue=fill)`` of an
    (H, W) or (H, W, C) uint8 image, byte for byte; ``mat`` is the forward
    2x3 matrix (taken as float64)."""
    img, mat = _check(img, mat, interpolation)
    c = img.shape[2] if img.ndim == 3 else 1
    fill_vals = _fill_values(fill, c)
    out = np.empty_like(img)
    if build().radet_warp_affine(img.ctypes.data, out.ctypes.data, img.shape[0], img.shape[1], c, mat.ctypes.data,
                                 fill_vals.ctypes.data, int(interpolation == "nearest")):
        raise ValueError(f"warp of a {img.shape} image")
    return out


def dilate3x3(mask: np.ndarray) -> np.ndarray:
    """``cv2.dilate(mask, np.ones((3, 3), np.uint8))`` of an (H, W) uint8
    image."""
    if mask.dtype != np.uint8 or mask.ndim != 2:
        raise ValueError(f"expected an (H, W) uint8 image, got {mask.dtype} {mask.shape}")
    mask = np.ascontiguousarray(mask)
    out = np.empty_like(mask)
    build().radet_dilate3x3(mask.ctypes.data, out.ctypes.data, *mask.shape)
    return out


def rotation_matrix_2d(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: the (2, 3) float64
    matrix rotating by ``angle`` degrees (counter-clockwise on screen) about
    ``center``, rounded to float32 first, and scaling by ``scale``."""
    cx, cy = (float(np.float32(v)) for v in center)
    rad = angle * (math.pi / 180)
    alpha = math.cos(rad) * scale
    beta = math.sin(rad) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]], np.float64)


# -------------------------------------------------------------- numpy twins


def _inverse_f32(mat: np.ndarray) -> np.ndarray:
    """cv2's inverse of the 2x3 ``mat`` in float64, rounded to float32."""
    m = [float(v) for v in mat.ravel()]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    m[2], m[5] = -m[0] * m[2] - m[1] * m[5], -m[3] * m[2] - m[4] * m[5]
    return np.asarray(m, np.float64).astype(np.float32)


def warp_affine_plain(img: np.ndarray, mat, fill: Fill = 0, interpolation: str = "bilinear") -> np.ndarray:
    """numpy twin of :func:`warp_affine`."""
    img, mat = _check(img, mat, interpolation)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    src = img.reshape(h, w, c)
    fill_vals = np.clip(np.rint(_fill_values(fill, c)), 0, 255).astype(np.uint8)
    m = _inverse_f32(mat)
    ys = np.arange(h, dtype=np.float32)[:, None]
    xs = np.arange(w, dtype=np.float32)[None, :]
    vector = np.arange(w) < w - w % _WARP_PIXELS
    sx = np.where(vector, _fma32(m[0], xs, ys * m[1] + m[2]), _fma32(xs, m[0], ys * m[1]) + m[2])
    sy = np.where(vector, _fma32(m[3], xs, ys * m[4] + m[5]), _fma32(xs, m[3], ys * m[4]) + m[5])

    def sample(iy, ix):
        inside = (ix >= 0) & (ix < w) & (iy >= 0) & (iy < h)
        vals = src[np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)]
        return np.where(inside[..., None], vals, fill_vals)

    with np.errstate(invalid="ignore"):
        far = ~((sx > -2) & (sx < w + 1) & (sy > -2) & (sy < h + 1))  # outside however it rounds
    sx, sy = np.where(far, -2, sx), np.where(far, -2, sy)
    if interpolation == "nearest":
        out = sample(np.rint(sy).astype(np.int64), np.rint(sx).astype(np.int64))
        return out.reshape(img.shape)
    fx, fy = np.floor(sx), np.floor(sy)
    ix, iy = fx.astype(np.int64), fy.astype(np.int64)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    p00, p01 = sample(iy, ix).astype(np.float32), sample(iy, ix + 1).astype(np.float32)
    p10, p11 = sample(iy + 1, ix).astype(np.float32), sample(iy + 1, ix + 1).astype(np.float32)
    v0, v1 = _fma32(a, p01 - p00, p00), _fma32(a, p11 - p10, p10)
    out = np.clip(np.rint(_fma32(b, v1 - v0, v0)), 0, 255).astype(np.uint8)
    return out.reshape(img.shape)


def dilate3x3_plain(mask: np.ndarray) -> np.ndarray:
    """numpy twin of :func:`dilate3x3`."""
    h, w = mask.shape
    x = np.pad(mask, 1)
    return np.max([x[i:i + h, j:j + w] for i in range(3) for j in range(3)], axis=0).astype(np.uint8)
