"""Image files without cv2: PNG decoded with ``zlib`` and a host C++ unfilter
(port of ``radet_tpu/data/pipeline.py::imread_rgb`` and of the pipeline's
``cv2.imread`` calls on masks).

:func:`imread` returns what ``cv2.imread(path, flags)`` returns for a PNG
file, with one change: ``IMREAD_COLOR`` gives RGB (cv2's BGR swapped, as
``imread_rgb`` does).

- ``IMREAD_COLOR``: (H, W, 3) uint8 RGB; gray is replicated to 3 channels,
  alpha is dropped, and 16-bit samples keep their high byte (libpng's
  ``strip_16``, which cv2 applies);
- ``IMREAD_GRAYSCALE``: (H, W) uint8, for gray PNGs (alpha dropped);
- ``IMREAD_UNCHANGED``: the file's depth (uint8 or uint16) and cv2's
  channel layout: gray (H, W), gray + alpha as BGRA (H, W, 4), RGB as BGR,
  RGBA as BGRA.

The decode: chunks are parsed and their CRCs checked, the IDAT stream is
inflated by ``zlib``, and the rows are unfiltered by ``csrc/png_unfilter.cpp``
(built at first use into ``radet_tpu_torch/_build/`` with the host C++
compiler, loaded with ``ctypes``).  :func:`unfilter_plain` is its numpy
twin, which the tests hold equal to it.  Both ``zlib`` and the ``ctypes``
call release the interpreter lock, so loader threads decode in parallel.

A missing file raises ``FileNotFoundError``; what is not decoded yet raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from ..utils.native import CSRC, build_library, find_tool

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1  # cv2's values

SOURCE = CSRC / "png_unfilter.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel
_JPEG = "ROADMAP.md Queue 1 item 7, training from files: JPEG decode"
_PNG_VARIANTS = "ROADMAP.md Queue 1 item 19, Adam7 and other PNG variants"
_TIFF = "ROADMAP.md Queue 1 item 20, TIFF images (the ITODD test set)"

_lib = None
_lib_lock = threading.Lock()


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the unfilter library."""
    global _lib
    with _lib_lock:
        if _lib is None:
            path, _ = build_library(SOURCE, find_tool(["c++", "g++"]), CXX_FLAGS)
            lib = ctypes.CDLL(str(path))
            lib.radet_png_unfilter.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
            ]
            lib.radet_png_unfilter.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_raw(raw: np.ndarray, height: int, stride: int, bpp: int) -> None:
    if raw.dtype != np.uint8 or raw.size < height * (stride + 1) or bpp < 1:
        raise ValueError(
            f"unfilter needs >= {height} x {stride + 1} uint8 bytes and bpp >= 1, "
            f"got {raw.size} {raw.dtype} bytes and bpp {bpp}"
        )


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters with the host C++ routine: ``raw`` holds
    ``height`` rows of a filter-type byte and ``stride`` bytes; returns the
    (height, stride) uint8 rows.  ``bpp``: bytes per pixel (at least 1)."""
    raw = np.ascontiguousarray(raw).reshape(-1)
    _check_raw(raw, height, stride, bpp)
    out = np.empty((height, stride), np.uint8)
    err = build().radet_png_unfilter(raw.ctypes.data, height, stride, bpp, out.ctypes.data)
    if err:
        raise ValueError(f"corrupt PNG: row {err - 1} has filter type {raw[(err - 1) * (stride + 1)]}")
    return out


def unfilter_plain(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """numpy twin of :func:`unfilter`: None, Sub and Up run on whole rows;
    Average and Paeth loop over the pixels of a row in Python."""
    raw = np.ascontiguousarray(raw).reshape(-1)
    _check_raw(raw, height, stride, bpp)
    rows = raw[: height * (stride + 1)].reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    up = np.zeros(stride, np.int32)  # the row above the first is zeros
    for y in range(height):
        ft, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if ft == 0:
            cur = src
        elif ft == 1:
            cur = np.cumsum(src.reshape(-1, bpp), axis=0).reshape(-1) & 255
        elif ft == 2:
            cur = (src + up) & 255
        elif ft in (3, 4):
            s, b = src.reshape(-1, bpp), up.reshape(-1, bpp)
            cur = np.empty_like(s)
            a = c = np.zeros(bpp, np.int32)  # left and upper-left of the first pixel
            for x in range(s.shape[0]):
                if ft == 3:
                    pred = (a + b[x]) >> 1
                else:
                    p = a + b[x] - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b[x]), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b[x], c))
                a, c = (s[x] + pred) & 255, b[x]
                cur[x] = a
            cur = cur.reshape(-1)
        else:
            raise ValueError(f"corrupt PNG: row {y} has filter type {ft}")
        out[y] = cur
        up = cur.astype(np.int32)
    return out


def _chunks(data: bytes):
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body, crc = data[pos + 8:pos + 8 + n], data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError("corrupt PNG: truncated chunk")
        if zlib.crc32(body, zlib.crc32(kind)) != int.from_bytes(crc, "big"):
            raise ValueError(f"corrupt PNG: CRC mismatch in {kind.decode(errors='replace')}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("corrupt PNG: no IEND chunk")


def decode_png(data: bytes, unfilter_fn=unfilter) -> np.ndarray:
    """The samples of a PNG file as stored: (H, W, C) uint8 or uint16, C
    the color type's samples per pixel (gray, gray + alpha, RGB, RGBA)."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("corrupt PNG: no IHDR chunk")
    width, height, depth, color_type, compression, filter_method, interlace = header
    if compression != 0 or filter_method != 0:
        raise ValueError(f"corrupt PNG: compression {compression}, filter method {filter_method}")
    if interlace:
        raise NotImplementedError(f"interlaced (Adam7) PNG is not decoded ({_PNG_VARIANTS})")
    if color_type == 3:
        raise NotImplementedError(f"palette PNG is not decoded ({_PNG_VARIANTS})")
    if color_type not in _CHANNELS:
        raise ValueError(f"corrupt PNG: color type {color_type}")
    if depth not in (8, 16):
        raise NotImplementedError(f"{depth}-bit PNG is not decoded ({_PNG_VARIANTS})")
    channels, nbytes = _CHANNELS[color_type], depth // 8
    stride = width * channels * nbytes
    raw = zlib.decompress(b"".join(idat), bufsize=height * (stride + 1))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"corrupt PNG: {len(raw)} image bytes, expected {height * (stride + 1)}")
    rows = unfilter_fn(np.frombuffer(raw, np.uint8), height, stride, channels * nbytes)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    return rows.reshape(height, width, channels)


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flags)`` for PNG files, RGB for ``IMREAD_COLOR``
    (see the module docstring)."""
    with open(path, "rb") as f:  # a missing file raises FileNotFoundError
        data = f.read()
    if data.startswith(b"\xff\xd8\xff"):
        raise NotImplementedError(f"{path}: JPEG is not decoded ({_JPEG})")
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        raise NotImplementedError(f"{path}: TIFF is not decoded ({_TIFF})")
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    samples = decode_png(data)
    channels = samples.shape[2]
    if flags == IMREAD_UNCHANGED:
        if channels == 1:
            return samples[..., 0]
        if channels == 2:
            g = samples[..., 0]
            return np.stack([g, g, g, samples[..., 1]], -1)
        return np.ascontiguousarray(samples[..., [2, 1, 0, 3][:channels]])
    if samples.dtype == np.uint16:
        samples = (samples >> 8).astype(np.uint8)
    if flags == IMREAD_GRAYSCALE:
        if channels > 2:
            raise NotImplementedError(
                f"{path}: a color PNG read as grayscale is not converted ({_PNG_VARIANTS})"
            )
        return np.ascontiguousarray(samples[..., 0])
    if flags != IMREAD_COLOR:
        raise ValueError(f"flags must be IMREAD_COLOR, IMREAD_GRAYSCALE or IMREAD_UNCHANGED, got {flags}")
    if channels <= 2:
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def imread_rgb(path: str) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an image file (``radet_tpu``'s ``imread_rgb``)."""
    return imread(path, IMREAD_COLOR)
