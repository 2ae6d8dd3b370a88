"""Image files without cv2: PNG decoded with ``zlib`` and a host C++ unfilter,
baseline JPEG with a host C++ decoder, TIFF with ``data/tiff.py`` (port of
``radet_tpu/data/pipeline.py::imread_rgb`` and of the pipeline's
``cv2.imread`` calls on masks).

:func:`imread` returns what ``cv2.imread(path, flags)`` returns for a PNG,
JPEG or TIFF file, and :func:`imdecode` what ``cv2.imdecode(data, flags)``
returns for its bytes, with one change: ``IMREAD_COLOR`` gives RGB (cv2's
BGR swapped, as ``imread_rgb`` does).

- ``IMREAD_COLOR``: (H, W, 3) uint8 RGB; gray is replicated to 3 channels,
  alpha is dropped, and 16-bit samples keep their high byte (libpng's
  ``strip_16``, which cv2 applies);
- ``IMREAD_GRAYSCALE``: (H, W) uint8, for gray PNGs (alpha dropped) and for
  JPEG (its luma);
- ``IMREAD_UNCHANGED``: the file's depth (uint8 or uint16) and cv2's
  channel layout: gray (H, W), gray + alpha as BGRA (H, W, 4), RGB as BGR,
  RGBA as BGRA.

PNG: chunks are parsed and their CRCs checked, the IDAT stream is inflated
by ``zlib``, and the rows are unfiltered by ``csrc/png_unfilter.cpp``.
:func:`unfilter_plain` is its numpy twin, which the tests hold equal to it.

JPEG: ``csrc/jpeg_decode.cpp`` decodes baseline and extended-sequential
Huffman files (SOF0, SOF1) of 8-bit gray or 4:4:4, 4:2:2 and 4:2:0 YCbCr
with libjpeg-turbo's default arithmetic (islow IDCT, fancy upsampling,
fixed-point colour), so its output equals ``cv2.imread``'s byte for byte.
``cv2.imread`` turns an image by its EXIF orientation tag (except for
``IMREAD_UNCHANGED``); an orientation other than 1 raises here rather than
give another image.  Its reference is cv2 itself (the tests here, and the
committed fixtures' hashes on a machine without cv2); it has no numpy twin.

Both libraries are built at first use into ``radet_tpu_torch/_build/`` with
the host C++ compiler and loaded with ``ctypes``; a missing compiler
raises.  ``zlib`` and the ``ctypes`` calls release the interpreter lock, so
loader threads decode in parallel.

TIFF (``data/tiff.py``): cv2 reads an 8-bit file, and a 16-bit one under
``IMREAD_COLOR`` or ``IMREAD_GRAYSCALE``, through libtiff's RGBA interface,
whose arithmetic :func:`_imread_tiff` repeats: 16-bit gray keeps its high
byte, 16-bit colour samples become (v + 128) // 257, an unassociated alpha
(``ExtraSamples`` 2) premultiplies the colours as (c * a + 127) // 255,
and gray under ``IMREAD_GRAYSCALE`` is ``color_aug.rgb_to_gray`` at 14
fractional bits (cv2's own conversion of those RGBA rows).  A 16-bit file
under ``IMREAD_UNCHANGED`` keeps its samples (gray + alpha excepted: cv2
reads it as 8-bit gray).

A missing file raises ``FileNotFoundError``, a corrupt one ``ValueError``;
what is not decoded yet raises ``NotImplementedError`` naming its ROADMAP
item.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from ..utils.native import CSRC, load_library
from . import color_aug, tiff

IMREAD_UNCHANGED, IMREAD_GRAYSCALE, IMREAD_COLOR = -1, 0, 1  # cv2's values

SOURCE = CSRC / "png_unfilter.cpp"
JPEG_SOURCE = CSRC / "jpeg_decode.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # color type -> samples per pixel
_VARIANTS = "ROADMAP.md Queue 1 item 19, Adam7 and other PNG and JPEG variants"

_INT = ctypes.POINTER(ctypes.c_int)
# each library's functions: (argtypes, restype)
_UNFILTER_API = {
    "radet_png_unfilter": ([ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p],
                           ctypes.c_int),
}
_JPEG_API = {
    "radet_jpeg_info": ([ctypes.c_char_p, ctypes.c_int64, _INT, _INT, _INT, _INT, ctypes.c_char_p, ctypes.c_int],
                        ctypes.c_int),
    "radet_jpeg_decode": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                           ctypes.c_char_p, ctypes.c_int], ctypes.c_int),
}


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the unfilter library."""
    return load_library(SOURCE, CXX_FLAGS, _UNFILTER_API)


def build_jpeg() -> ctypes.CDLL:
    """Compile (when the source changed) and load the JPEG decoder."""
    return load_library(JPEG_SOURCE, CXX_FLAGS, _JPEG_API)


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
        raise NotImplementedError(f"interlaced (Adam7) PNG is not decoded ({_VARIANTS})")
    if color_type == 3:
        raise NotImplementedError(f"palette PNG is not decoded ({_VARIANTS})")
    if color_type not in _CHANNELS:
        raise ValueError(f"corrupt PNG: color type {color_type}")
    if depth not in (8, 16):
        raise NotImplementedError(f"{depth}-bit PNG is not decoded ({_VARIANTS})")
    channels, nbytes = _CHANNELS[color_type], depth // 8
    stride = width * channels * nbytes
    raw = zlib.decompress(b"".join(idat), bufsize=height * (stride + 1))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"corrupt PNG: {len(raw)} image bytes, expected {height * (stride + 1)}")
    rows = unfilter_fn(np.frombuffer(raw, np.uint8), height, stride, channels * nbytes)
    if depth == 16:
        return rows.view(">u2").astype(np.uint16).reshape(height, width, channels)
    return rows.reshape(height, width, channels)


def _jpeg_check(code: int, msg) -> None:
    if code == 1:
        raise ValueError(f"corrupt JPEG: {msg.value.decode()}")
    if code:
        raise NotImplementedError(f"{msg.value.decode()} ({_VARIANTS})")


def jpeg_info(data: bytes):
    """(width, height, components, EXIF orientation or 0) of a JPEG file's
    header; raises as :func:`decode_jpeg`."""
    out = [ctypes.c_int() for _ in range(4)]
    msg = ctypes.create_string_buffer(256)
    _jpeg_check(build_jpeg().radet_jpeg_info(data, len(data), *out, msg, len(msg)), msg)
    return tuple(v.value for v in out)


def decode_jpeg(data: bytes, gray: bool = False) -> np.ndarray:
    """A JPEG file's pixels as ``cv2.imread`` decodes them, without the EXIF
    turn: (H, W) uint8 luma (or gray) when ``gray``, else (H, W, 3) RGB.
    Raises ``ValueError`` on a corrupt file and ``NotImplementedError`` on a
    variant that is not decoded."""
    width, height, _, _ = jpeg_info(data)
    out = np.empty((height, width) if gray else (height, width, 3), np.uint8)
    msg = ctypes.create_string_buffer(256)
    code = build_jpeg().radet_jpeg_decode(data, len(data), int(gray), out.ctypes.data, out.size, msg, len(msg))
    _jpeg_check(code, msg)
    return out


def _imread_jpeg(where: str, data: bytes, flags: int) -> np.ndarray:
    _, _, components, orientation = jpeg_info(data)
    if flags == IMREAD_UNCHANGED:
        if components == 1:
            return decode_jpeg(data, gray=True)
        return np.ascontiguousarray(decode_jpeg(data)[..., ::-1])
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"flags must be IMREAD_COLOR, IMREAD_GRAYSCALE or IMREAD_UNCHANGED, got {flags}")
    if 2 <= orientation <= 8:
        raise NotImplementedError(
            f"{where}: EXIF orientation {orientation} (cv2.imread turns the image by it) is not applied "
            f"({_VARIANTS})"
        )
    return decode_jpeg(data, gray=flags == IMREAD_GRAYSCALE)


def _rgba8(samples: np.ndarray, info) -> np.ndarray:
    """libtiff's RGBA rows (``TIFFReadRGBAStrip``) of a colour TIFF's
    samples: (H, W, 4) uint8."""
    h, w, spp = samples.shape
    rgba = ((samples.astype(np.uint32) + 128) // 257).astype(np.uint8) if samples.dtype == np.uint16 else samples
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rgba[..., :3]
    out[..., 3] = rgba[..., 3] if spp == 4 else 255
    if spp == 4 and info["extra_samples"][:1] == (tiff.UNASSOCIATED_ALPHA,):
        out[..., :3] = (out[..., :3] * out[..., 3:].astype(np.uint32) + 127) // 255
    return out


def _imread_tiff(data: bytes, flags: int) -> np.ndarray:
    samples, info = tiff.decode(data)
    gray = info["photometric"] == tiff.MINISBLACK
    wide = samples.dtype == np.uint16
    if flags == IMREAD_UNCHANGED and wide and samples.shape[2] != 2:
        if gray:
            return samples[..., 0]
        return np.ascontiguousarray(samples[..., [2, 1, 0, 3][:samples.shape[2]]])
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE, IMREAD_UNCHANGED):
        raise ValueError(f"flags must be IMREAD_COLOR, IMREAD_GRAYSCALE or IMREAD_UNCHANGED, got {flags}")
    if gray:  # libtiff's RGBA rows repeat the gray value; its 14-bit gray is the value
        if (wide or samples.shape[2] == 2) and info["clipped_tiles"]:
            raise tiff.unsupported("gray with 16-bit samples or alpha in tiles past the right edge (libtiff's "
                                   "RGBA reader, which cv2.imread takes here, leaves all but the first row of "
                                   "those tiles unread)")
        v = (samples[..., 0] >> 8).astype(np.uint8) if wide else samples[..., 0]
        return np.stack([v, v, v], -1) if flags == IMREAD_COLOR else np.ascontiguousarray(v)
    rgba = _rgba8(samples, info)
    if flags == IMREAD_COLOR:
        return np.ascontiguousarray(rgba[..., :3])
    if flags == IMREAD_GRAYSCALE:
        return color_aug.rgb_to_gray(rgba, shift=14)
    return np.ascontiguousarray(rgba[..., [2, 1, 0, 3][:samples.shape[2]]])


def imread(path: str, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imread(path, flags)`` for PNG, JPEG and TIFF files, RGB for
    ``IMREAD_COLOR`` (see the module docstring)."""
    with open(path, "rb") as f:  # a missing file raises FileNotFoundError
        data = f.read()
    return _decode(data, flags, path)


def imdecode(data, flags: int = IMREAD_COLOR) -> np.ndarray:
    """``cv2.imdecode(data, flags)`` for the bytes of a PNG, JPEG or TIFF file
    (anything ``bytes()`` takes: bytes, a buffer, a uint8 array), RGB for
    ``IMREAD_COLOR``, as :func:`imread`.  Where ``cv2.imdecode`` returns
    None this raises ``ValueError``; a variant that is not decoded raises
    ``NotImplementedError``."""
    return _decode(bytes(data), flags, "image bytes")


def _decode(data: bytes, flags: int, where: str) -> np.ndarray:
    """The pixels of ``data``, a file's bytes; ``where`` (the path) names
    it in errors."""
    if data.startswith(b"\xff\xd8\xff"):
        return _imread_jpeg(where, data, flags)
    if data[:2] in (b"II", b"MM"):
        try:
            return _imread_tiff(data, flags)
        except (ValueError, NotImplementedError) as e:
            raise type(e)(f"{where}: {e}") from None
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{where}: not a PNG, JPEG or TIFF file")
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
                f"{where}: a color PNG read as grayscale is not converted ({_VARIANTS})"
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
