"""TIFF files without libtiff (the ITODD test images; port of what
``cv2.imread`` reads through libtiff for ``radet_tpu/data/pipeline.py``).

:func:`decode` returns the samples of a file's first image as stored, with
the tags that ``data/image_io.py`` needs to give ``cv2.imread``'s pixels
for each flag.  It reads baseline TIFF and the common extensions:

- little- and big-endian files (``II*\\0``, ``MM\\0*``), strips or tiles;
- uncompressed (1), LZW (5) and PackBits (32773) data through host C++
  (``csrc/tiff_decode.cpp``, built at first use into
  ``radet_tpu_torch/_build/``; :func:`lzw_plain` and
  :func:`packbits_plain` are its twins), Deflate (8 and 32946) through
  ``zlib``, the last two with or without the horizontal predictor (2);
- 8- and 16-bit unsigned samples, ``PlanarConfiguration`` 1: gray
  (``Photometric`` 1, MinIsBlack), gray + alpha, RGB (2) and RGBA.

Anything else raises ``NotImplementedError`` naming ROADMAP item 19: JPEG
and CCITT compression and the rest, MinIsWhite, palette, CMYK and YCbCr
photometrics, float or signed samples, depths other than 8 and 16, planar
2, a fill order or orientation other than 1 and BigTIFF.  Of a
multi-page file only the first page is read, as ``cv2.imread`` reads it.
A corrupt file raises ``ValueError``.
"""

from __future__ import annotations

import ctypes
import struct
import zlib
from typing import Dict, Tuple

import numpy as np

from ..utils.native import CSRC, load_library

SOURCE = CSRC / "tiff_decode.cpp"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
_VARIANTS = "ROADMAP.md Queue 1 item 19, other TIFF variants"

_API = {
    "radet_tiff_lzw": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64], ctypes.c_int64),
    "radet_tiff_packbits": ([ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64], ctypes.c_int64),
}
# field type -> (struct code, bytes); the integer types only, with RATIONAL read as two LONGs
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 5: ("I", 4), 6: ("b", 1), 7: ("B", 1), 8: ("h", 2),
          9: ("i", 4), 10: ("i", 4), 11: ("f", 4), 12: ("d", 8), 13: ("I", 4)}
_COUNT = {5: 2, 10: 2}  # RATIONAL, SRATIONAL: two values each
COMPRESSIONS = {1: "none", 5: "LZW", 8: "Deflate", 32946: "Deflate", 32773: "PackBits"}
PREDICTED = (5, 8, 32946)  # the codecs that apply the Predictor tag (libtiff ignores it elsewhere)
MINISBLACK, RGB = 1, 2
UNASSOCIATED_ALPHA = 2  # ExtraSamples value


def build() -> ctypes.CDLL:
    """Compile (when the source changed) and load the decompressors."""
    return load_library(SOURCE, CXX_FLAGS, _API)


def unsupported(what: str):
    return NotImplementedError(f"TIFF {what} is not decoded ({_VARIANTS})")


# ------------------------------------------------------- decompression


def lzw(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes of an LZW strip or tile (C++)."""
    out = np.empty(size, np.uint8)
    n = build().radet_tiff_lzw(data, len(data), out.ctypes.data, size)
    if n < 0:
        raise ValueError("corrupt TIFF: bad LZW code")
    return out[:n].tobytes()


def packbits(data: bytes, size: int) -> bytes:
    """The first ``size`` bytes of a PackBits strip or tile (C++)."""
    out = np.empty(size, np.uint8)
    n = build().radet_tiff_packbits(data, len(data), out.ctypes.data, size)
    if n < 0:
        raise ValueError("corrupt TIFF: truncated PackBits run")
    return out[:n].tobytes()


def lzw_plain(data: bytes, size: int) -> bytes:
    """Python twin of :func:`lzw`."""
    table = [bytes([i]) for i in range(256)] + [b"", b""]
    out = bytearray()
    pos, width, old = 0, 9, None
    while pos + width <= 8 * len(data) and len(out) < size:
        code = int.from_bytes(data[pos // 8:pos // 8 + 3].ljust(3, b"\0"), "big")
        code = (code >> (24 - width - pos % 8)) & ((1 << width) - 1)
        pos += width
        if code == 257:
            break
        if code == 256:
            table, width, old = table[:258], 9, None
            continue
        if old is None:
            if code > 255:
                raise ValueError("corrupt TIFF: bad LZW code")
            out += table[code]
            old = code
            continue
        if code < len(table):
            entry = table[code]
            new = table[old] + entry[:1]
        elif code == len(table):
            entry = new = table[old] + table[old][:1]
        else:
            raise ValueError("corrupt TIFF: bad LZW code")
        if len(table) < 4096:
            table.append(new)
        out += entry
        old = code
        if len(table) >= (1 << width) - 1 and width < 12:
            width += 1
    return bytes(out[:size])


def packbits_plain(data: bytes, size: int) -> bytes:
    """Python twin of :func:`packbits`."""
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < size:
        h = struct.unpack("b", data[i:i + 1])[0]
        i += 1
        if h >= 0:
            if i + h + 1 > len(data):
                raise ValueError("corrupt TIFF: truncated PackBits run")
            out += data[i:i + h + 1]
            i += h + 1
        elif h != -128:
            if i >= len(data):
                raise ValueError("corrupt TIFF: truncated PackBits run")
            out += data[i:i + 1] * (1 - h)
            i += 1
    return bytes(out[:size])


def _inflate(data: bytes, size: int) -> bytes:
    try:
        return zlib.decompressobj().decompress(data, size)
    except zlib.error as e:
        raise ValueError(f"corrupt TIFF: {e}") from None


# ----------------------------------------------------------------- tags


def _ifd(data: bytes, order: str, offset: int) -> Tuple[Dict[int, tuple], int]:
    """The tags of the IFD at ``offset`` ({tag: values}) and the offset of
    the next IFD."""
    if offset + 2 > len(data):
        raise ValueError("corrupt TIFF: IFD offset past the end")
    (n,) = struct.unpack(order + "H", data[offset:offset + 2])
    tags = {}
    for i in range(n):
        at = offset + 2 + 12 * i
        entry = data[at:at + 12]
        if len(entry) < 12:
            raise ValueError("corrupt TIFF: truncated IFD")
        tag, typ, count = struct.unpack(order + "HHI", entry[:8])
        if typ not in _TYPES:
            continue  # a type this reader never needs (LONG8 and the like)
        code, size = _TYPES[typ]
        values = count * _COUNT.get(typ, 1)
        nbytes = values * size
        if nbytes <= 4:
            raw = entry[8:8 + nbytes]
        else:
            (where,) = struct.unpack(order + "I", entry[8:12])
            raw = data[where:where + nbytes]
            if len(raw) < nbytes:
                raise ValueError(f"corrupt TIFF: tag {tag}'s values past the end")
        tags[tag] = struct.unpack(f"{order}{values}{code}", raw)
    nxt = data[offset + 2 + 12 * n:offset + 6 + 12 * n]
    return tags, (struct.unpack(order + "I", nxt)[0] if len(nxt) == 4 else 0)


def _one(tags, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError(f"corrupt TIFF: no tag {tag}")
        return default
    return v[0]


# --------------------------------------------------------------- decode


def decode(data: bytes):
    """The samples of the first page of a TIFF file as stored: (H, W, C)
    uint8 or uint16 in native byte order, and what
    ``cv2.imread``'s reading of them depends on: {'photometric',
    'extra_samples' (a tuple), 'clipped_tiles' (tiles past the right
    edge)}."""
    if data[:4] == b"II*\x00":
        order = "<"
    elif data[:4] == b"MM\x00*":
        order = ">"
    elif data[:2] in (b"II", b"MM") and data[2:4] in (b"+\x00", b"\x00+"):
        raise unsupported("BigTIFF")
    else:
        raise ValueError("not a TIFF file")
    (offset,) = struct.unpack(order + "I", data[4:8])
    tags, _ = _ifd(data, order, offset)

    width, height = _one(tags, 256), _one(tags, 257)
    spp = _one(tags, 277, 1)
    bits = set(tags.get(258, (1,)))
    compression = _one(tags, 259, 1)
    photometric = _one(tags, 262)
    planar = _one(tags, 284, 1)
    predictor = _one(tags, 317, 1)
    extra = tuple(tags.get(338, ()))
    if compression not in COMPRESSIONS:
        raise unsupported(f"compression {compression}")
    if photometric not in (MINISBLACK, RGB):
        raise unsupported(f"photometric interpretation {photometric}")
    if len(bits) != 1 or not bits <= {8, 16}:
        raise unsupported(f"bits per sample {sorted(bits)}")
    if set(tags.get(339, (1,))) != {1}:
        raise unsupported(f"sample format {tags[339]} (not unsigned integers)")
    if planar != 1:
        raise unsupported(f"planar configuration {planar}")
    if predictor not in (1, 2):
        raise unsupported(f"predictor {predictor}")
    for tag, what in ((266, "fill order"), (274, "orientation")):
        if _one(tags, tag, 1) != 1:
            raise unsupported(f"{what} {_one(tags, tag)}")
    base = 1 if photometric == MINISBLACK else 3
    if spp not in (base, base + 1):
        raise unsupported(f"{spp} samples per pixel with photometric interpretation {photometric}")
    depth = bits.pop() // 8
    dtype = np.dtype(np.uint8) if depth == 1 else np.dtype(order + "u2")

    tiled = 322 in tags
    if tiled:
        tw, th = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
        grid = [(ty * th, tx * tw, th, tw) for ty in range(-(-height // th)) for tx in range(-(-width // tw))]
    else:
        rps = min(_one(tags, 278, 2 ** 32 - 1), height)
        offsets, counts = tags.get(273), tags.get(279)
        grid = [(y, 0, min(rps, height - y), width) for y in range(0, height, rps)]
    if offsets is None or counts is None or len(offsets) < len(grid) or len(counts) < len(grid):
        raise ValueError(f"corrupt TIFF: {len(grid)} {'tiles' if tiled else 'strips'} but "
                         f"{len(offsets or ())} offsets and {len(counts or ())} byte counts")

    out = np.empty((height, width, spp), np.uint16 if depth == 2 else np.uint8)
    for (y, x, rows, cols), off, cnt in zip(grid, offsets, counts):
        size = rows * cols * spp * depth
        raw = data[off:off + cnt]
        if compression == 1:
            chunk = raw
        elif compression == 5:
            chunk = lzw(raw, size)
        elif compression == 32773:
            chunk = packbits(raw, size)
        else:
            chunk = _inflate(raw, size)
        if len(chunk) < size:
            raise ValueError(f"corrupt TIFF: a {'tile' if tiled else 'strip'} holds {len(chunk)} bytes, "
                             f"expected {size}")
        block = np.frombuffer(chunk, dtype, rows * cols * spp).reshape(rows, cols, spp)
        block = block.astype(out.dtype, copy=False)  # native byte order
        if predictor == 2 and compression in PREDICTED:  # differences along the row, per sample
            block = np.cumsum(block, axis=1, dtype=out.dtype)
        h, w = min(rows, height - y), min(cols, width - x)
        out[y:y + h, x:x + w] = block[:h, :w]
    return out, dict(photometric=photometric, extra_samples=extra, clipped_tiles=tiled and width % grid[0][3] != 0)
