"""Image files written without cv2: :func:`imwrite` is ``cv2.imwrite`` for
the formats the drawing tools write (port of the ``cv2.imwrite`` calls of
``radet_tpu/utils/visualization.py``, ``tools/browse_dataset.py`` and
``tools/show_bop_detbbox.py``).

- PNG (``.png``): :func:`write_png`, 8-bit, rows cycled through all five
  filters and deflated by ``zlib``.  It decodes to the pixels cv2's PNG
  decodes to; the bytes differ, as cv2's zlib and filter choice are not
  these.
- JPEG (``.jpg``, ``.jpeg``, ``.jpe``): ``csrc/jpeg_encode.cpp``, byte for
  byte the file ``cv2.imwrite`` writes at its defaults (quality 95,
  baseline, 4:2:0, the standard Huffman tables; see the source).  It is
  built at first use into ``radet_tpu_torch/_build/`` with the host C++
  compiler and loaded with ``ctypes``; a missing compiler raises.

Images are uint8 BGR (H, W, 3) or gray (H, W), as cv2 takes them; PNG also
takes BGRA (H, W, 4).  Another extension raises ``NotImplementedError``
naming its ROADMAP item: there is no silent fallback to another format.
"""

from __future__ import annotations

import ctypes
import os.path as osp
import struct
import zlib

import numpy as np

from .native import CSRC, load_library

JPEG_SOURCE = CSRC / "jpeg_encode.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
JPEG_EXTENSIONS = (".jpg", ".jpeg", ".jpe")
_TIFF = "ROADMAP.md Queue 1 item 20b, TIFF writing"
_FORMATS = "ROADMAP.md Queue 1 item 15c's remainder, other image formats"
_JPEG_API = {
    "radet_jpeg_encode": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                           ctypes.c_void_p, ctypes.c_int64], ctypes.c_int64),
}


def build_jpeg_encoder() -> ctypes.CDLL:
    """Compile (when the source changed) and load the JPEG encoder."""
    return load_library(JPEG_SOURCE, CXX_FLAGS, _JPEG_API)


def write_png(path: str, img: np.ndarray, level: int = 1) -> None:
    """A uint8 (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA image as an
    8-bit PNG whose row y uses filter type y % 5 (None, Sub, Up, Average,
    Paeth), so that a decoder of these files meets every filter."""
    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    x = img.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(x)
    left[:, ch:] = x[:, :-ch]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    upleft = np.zeros_like(x)
    upleft[1:, ch:] = x[:-1, :-ch]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    predictions = (0, left, up, (left + up) >> 1, paeth)
    kind = np.arange(h) % 5
    rows = np.empty((h, w * ch + 1), np.uint8)
    rows[:, 0] = kind
    for f, pred in enumerate(predictions):
        rows[kind == f, 1:] = ((x - pred) & 255)[kind == f]

    def chunk(tag: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    header = struct.pack(">IIBBBBB", w, h, 8, {1: 0, 3: 2, 4: 6}[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def _image(img: np.ndarray, channels) -> np.ndarray:
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or ch not in channels or 0 in img.shape:
        raise ValueError(f"expected a non-empty uint8 image of {channels} channels, got {img.dtype} {img.shape}")
    return img


def encode_jpeg(img_bgr: np.ndarray) -> bytes:
    """``cv2.imencode(".jpg", img)[1]`` of a uint8 BGR (H, W, 3) or gray
    (H, W) image, as bytes."""
    img = np.ascontiguousarray(_image(img_bgr, (1, 3)))
    h, w = img.shape[:2]
    channels = 1 if img.ndim == 2 else 3
    padded = ((h + 15) // 16) * ((w + 15) // 16) * 256 * (3 if channels == 3 else 1)
    cap = 7 * padded + 4096  # at most 415 bytes of a stuffed block per 64 samples
    out = np.empty(cap, np.uint8)
    n = build_jpeg_encoder().radet_jpeg_encode(img.ctypes.data, h, w, channels, img.strides[0],
                                               out.ctypes.data, cap)
    if n < 0:
        raise RuntimeError(f"JPEG encoder failed with code {-n} on a {img.shape} image")
    return out[:n].tobytes()


def imwrite(path: str, img_bgr: np.ndarray) -> bool:
    """``cv2.imwrite(path, img)``: the format from the extension, PNG or
    JPEG; returns True as cv2 does."""
    ext = osp.splitext(path)[1].lower()
    if ext == ".png":
        img = _image(img_bgr, (1, 3, 4))
        write_png(path, img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]])
    elif ext in JPEG_EXTENSIONS:
        data = encode_jpeg(img_bgr)
        with open(path, "wb") as f:
            f.write(data)
    elif ext in (".tif", ".tiff"):
        raise NotImplementedError(f"{path}: TIFF is not written ({_TIFF})")
    else:
        raise NotImplementedError(f"{path}: extension {ext!r} is not written ({_FORMATS})")
    return True
