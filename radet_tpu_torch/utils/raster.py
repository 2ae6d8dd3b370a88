"""OpenCV's drawing without cv2: lines, rectangles, circles and text on a
uint8 (H, W) or (H, W, C) image, in place, each bit for bit what cv2 5.0's
``cv2.line``, ``cv2.rectangle``, ``cv2.circle`` and ``cv2.putText`` draw
with ``LINE_8`` (the only line type here).

The shapes follow cv2's fixed-point arithmetic (``imgproc/src/drawing.cpp``):

- points carry ``XY_SHIFT`` = 16 fraction bits.  A line of thickness <= 1
  is the 8-connected ``Line`` (``data/poly.py``'s ``line_pixels``) between
  its end points rounded to pixels, at any shift (cv2 5.0; its ``Line2``
  is left to outlines);
- a thicker line is ``FillConvexPoly`` of the quad that offsets the
  segment by half the thickness (rounded to even in fixed point), plus a
  filled ``Circle`` of radius round(thickness / 2) at each capped end;
- ``FillConvexPoly`` draws the outline with ``Line`` at shift 0, else with
  ``Line2``, which steps the major axis one pixel at a time and the minor
  one by a truncated 16.16 slope from the half-pixel-shifted start, after
  ``clipLine`` on the image scaled to fixed point; then it fills
  each row from its two active edges, each edge's x starting at its upper
  vertex and stepping by a rounded 16.16 slope per row;
- ``Circle`` is the midpoint circle, filled by spans; a thicker circle is
  ``EllipseEx``'s polygon of thick lines.

Every pixel is clipped to the image as cv2 clips it.  A shape gathers its
pixels and writes them at once: each call paints one color.  Text is
cv2's TrueType rendering replayed from its glyph bitmaps (``put_text``).
"""

from __future__ import annotations

import base64
import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..data.poly import XY_ONE, XY_SHIFT, _tdiv, clip_line, line_pixels
from .text_glyphs import GLYPHS

FONT_HERSHEY_SIMPLEX = 0
FILLED = -1
MAX_THICKNESS = 32767
_FONTS = "ROADMAP.md Queue 1 item 15c's remainder, other fonts, scales and characters"
_HALF = XY_ONE >> 1


def cv_round(v: float) -> int:
    """``cvRound``: to the nearest integer, halves to even."""
    return int(np.rint(v))


class _Pixels:
    """The pixels one drawing call paints, clipped to a (h, w) image:
    point arrays and (y, x1, x2) spans."""

    def __init__(self, h: int, w: int):
        self.h, self.w = h, w
        self.xs: List[np.ndarray] = []
        self.ys: List[np.ndarray] = []
        self.spans: List[Tuple[int, int, int]] = []

    def points(self, xs, ys) -> None:
        xs, ys = np.asarray(xs, np.int64), np.asarray(ys, np.int64)
        keep = (xs >= 0) & (xs < self.w) & (ys >= 0) & (ys < self.h)
        self.xs.append(xs[keep])
        self.ys.append(ys[keep])

    def hline(self, y: int, x1: int, x2: int) -> None:
        """``ICV_HLINE`` from x1 to x2 inclusive, clipped."""
        x1, x2 = max(x1, 0), min(x2, self.w - 1)
        if 0 <= y < self.h and x1 <= x2:
            self.spans.append((y, x1, x2))

    def hlines(self, y: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> None:
        """:meth:`hline` of each row of three arrays."""
        x1, x2 = np.maximum(x1, 0), np.minimum(x2, self.w - 1)
        keep = (y >= 0) & (y < self.h) & (x1 <= x2)
        self.spans.extend(zip(y[keep].tolist(), x1[keep].tolist(), x2[keep].tolist()))

    def paint(self, img: np.ndarray, color) -> None:
        if self.spans:
            y, x1, x2 = np.asarray(self.spans, np.int64).reshape(-1, 3).T
            n = x2 - x1 + 1
            start = np.repeat(np.cumsum(n) - n, n)
            self.ys.append(np.repeat(y, n))
            self.xs.append(np.repeat(x1, n) + np.arange(int(n.sum())) - start)
        if self.xs:
            img[np.concatenate(self.ys), np.concatenate(self.xs)] = color


def _color(img: np.ndarray, color) -> np.ndarray:
    """``scalarToRawData`` for uint8: each channel rounded and saturated."""
    ch = 1 if img.ndim == 2 else img.shape[2]
    vals = list(color) if isinstance(color, (tuple, list, np.ndarray)) else [color]
    vals = (vals + [0] * ch)[:ch]
    raw = np.array([min(255, max(0, cv_round(float(v)))) for v in vals], np.uint8)
    return raw[0] if img.ndim == 2 else raw


def _check(img: np.ndarray) -> None:
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError("drawing takes a uint8 (H, W) or (H, W, C) numpy image")


def _line(px: _Pixels, x1: int, y1: int, x2: int, y2: int) -> None:
    """``Line``: 8-connected, integer end points."""
    xs, ys = line_pixels(px.w, px.h, x1, y1, x2, y2)
    px.points(xs, ys)


def _line2(px: _Pixels, x1: int, y1: int, x2: int, y2: int) -> None:
    """``Line2``: one pixel wide, 16.16 fixed-point end points."""
    inside, x1, y1, x2, y2 = clip_line(px.w << XY_SHIFT, px.h << XY_SHIFT, x1, y1, x2, y2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:  # walk from the left end
            x1, y1, x2, y2, dy = x2, y2, x1, y1, -dy
        step = _tdiv(dy * XY_ONE, ax | 1)
        count = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:  # walk from the top end
            x1, y1, x2, y2, dx = x2, y2, x1, y1, -dx
        step = _tdiv(dx * XY_ONE, ay | 1)
        count = (y2 - y1) >> XY_SHIFT
    x1 += _HALF
    y1 += _HALF
    k = np.arange(count + 1, dtype=np.int64)
    if ax > ay:
        xs, ys = (x1 >> XY_SHIFT) + k, (y1 + k * step) >> XY_SHIFT
    else:
        xs, ys = (x1 + k * step) >> XY_SHIFT, (y1 >> XY_SHIFT) + k
    px.points(np.append(xs, (x2 + _HALF) >> XY_SHIFT), np.append(ys, (y2 + _HALF) >> XY_SHIFT))


def _circle(px: _Pixels, cx: int, cy: int, radius: int, fill: bool) -> None:
    """``Circle``: the midpoint circle (8 points or 4 spans per step)."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    xs, ys = [], []
    while dx >= dy:
        for a, b in ((dx, dy), (dy, dx)):  # x half-width a on rows cy -+ b
            for y in (cy - b, cy + b):
                if fill:
                    px.hline(y, cx - a, cx + a)
                else:
                    xs += [cx - a, cx + a]
                    ys += [y, y]
        dy += 1
        err += plus
        plus += 2
        if err > 0:
            err -= minus
            dx -= 1
            minus -= 2
    if xs:
        px.points(xs, ys)


def _sin_table(degrees: int) -> float:
    """cv2's ``SinTable`` entry: sin of whole degrees to 7 decimals, as a
    float."""
    return float(np.float32(f"{math.sin(math.radians(degrees)):.7f}"))


def _thick_circle(px: _Pixels, cx: int, cy: int, radius: int, thickness: int) -> None:
    """``EllipseEx`` of a circle: ``ellipse2Poly``'s points every ``delta``
    degrees (90, 30, 18 or 5 by radius) in 16.16 fixed point, consecutive
    duplicates dropped, as an open polyline of ``ThickLine``s."""
    cx, cy, r = cx << XY_SHIFT, cy << XY_SHIFT, radius << XY_SHIFT
    rad = (r + _HALF) >> XY_SHIFT
    delta = 90 if rad < 3 else 30 if rad < 10 else 18 if rad < 15 else 5
    def fixed(c: float) -> int:  # the point's double -> 16.16: whole pixels, then the rest
        whole = cv_round(c / XY_ONE) << XY_SHIFT
        return whole + cv_round(c - whole)

    pts: List[Tuple[int, int]] = []
    for a in range(0, 360 + delta, delta):
        a = min(a, 360)
        p = (fixed(cx + r * _sin_table(450 - a)), fixed(cy + r * _sin_table(a)))
        if not pts or p != pts[-1]:
            pts.append(p)
    if len(pts) == 1:
        pts = [(cx, cy)] * 2
    flags = 3  # an open polyline caps both ends of its first segment, then each far end
    for p0, p1 in zip(pts[:-1], pts[1:]):
        _thick_line(px, p0, p1, thickness, flags, XY_SHIFT)
        flags = 2


def _fill_convex_poly(px: _Pixels, v: Sequence[Tuple[int, int]], shift: int) -> None:
    """``FillConvexPoly``: the outline, then each row's span between its two
    active edges."""
    npts = len(v)
    delta = (1 << shift) >> 1
    up = XY_SHIFT - shift
    x0, y0 = v[-1][0] << up, v[-1][1] << up
    for x, y in v:  # the outline
        x, y = x << up, y << up
        if shift == 0:
            _line(px, x0 >> XY_SHIFT, y0 >> XY_SHIFT, x >> XY_SHIFT, y >> XY_SHIFT)
        else:
            _line2(px, x0, y0, x, y)
        x0, y0 = x, y
    xs, ys = [p[0] for p in v], [p[1] for p in v]
    imin = ys.index(min(ys))
    xmin, xmax = (min(xs) + delta) >> shift, (max(xs) + delta) >> shift
    ymin, ymax = (min(ys) + delta) >> shift, (max(ys) + delta) >> shift
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= px.w or ymin >= px.h:
        return
    ymax = min(ymax, px.h - 1)
    # per edge: [vertex index, direction, x, dx, bottom row]
    edge = [[imin, 1, -XY_ONE, 0, ymin], [imin, npts - 1, -XY_ONE, 0, ymin]]
    edges = npts
    y = ymin
    while True:
        for e in edge:
            if y < e[4]:
                continue
            idx0 = e[0]
            idx = (idx0 + e[1]) % npts
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = (v[idx][1] + delta) >> shift
                if ty > y:
                    xs0, xe = v[idx0][0] << up, v[idx][0] << up
                    e[:] = [idx, e[1], xs0, _tdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + e[1]) % npts
        if edges < 0:
            return
        # the rows up to the next edge change, at once
        n = min(edge[0][4], edge[1][4], ymax + 1) - y
        k = np.arange(max(n, 1), dtype=np.int64)
        xa, xb = edge[0][2] + k * edge[0][3], edge[1][2] + k * edge[1][3]
        x1 = (np.minimum(xa, xb) + _HALF) >> XY_SHIFT
        x2 = (np.maximum(xa, xb) + _HALF) >> XY_SHIFT
        rows = y + k
        ok = (x2 >= 0) & (x1 < px.w)
        px.hlines(rows[ok], x1[ok], x2[ok])
        edge[0][2] += len(k) * edge[0][3]
        edge[1][2] += len(k) * edge[1][3]
        y += len(k)
        if y > ymax:
            return


def _thick_line(px: _Pixels, p0, p1, thickness: int, flags: int, shift: int) -> None:
    """``ThickLine``: ``flags`` bit 0 caps p0, bit 1 caps p1."""
    up = XY_SHIFT - shift
    x0, y0, x1, y1 = p0[0] << up, p0[1] << up, p1[0] << up, p1[1] << up
    if thickness <= 1:
        _line(px, *[(v + _HALF) >> XY_SHIFT for v in (x0, y0, x1, y1)])
        return
    dx, dy = (x0 - x1) / XY_ONE, (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    half = thickness << (XY_SHIFT - 1)
    if abs(r) > np.finfo(np.float64).eps:
        r = (half + odd * XY_ONE * 0.5) / np.sqrt(r)
        ox, oy = cv_round(dy * r), cv_round(dx * r)
        quad = [(x0 + ox, y0 + oy), (x0 - ox, y0 - oy), (x1 - ox, y1 - oy), (x1 + ox, y1 + oy)]
        _fill_convex_poly(px, quad, XY_SHIFT)
    for bit, (x, y) in ((1, (x0, y0)), (2, (x1, y1))):
        if flags & bit:
            _circle(px, (x + _HALF) >> XY_SHIFT, (y + _HALF) >> XY_SHIFT, (half + _HALF) >> XY_SHIFT, True)


def _point(p) -> Tuple[int, int]:
    """A cv2 ``Point`` argument: two integers."""
    x, y = p
    if isinstance(x, (float, np.floating)) or isinstance(y, (float, np.floating)):
        raise TypeError(f"point {p!r}: cv2 takes integer coordinates")
    return int(x), int(y)


def line(img: np.ndarray, pt1, pt2, color, thickness: int = 1, shift: int = 0) -> np.ndarray:
    """``cv2.line(img, pt1, pt2, color, thickness, LINE_8, shift)``, both
    ends capped."""
    _check(img)
    if not 0 < thickness <= MAX_THICKNESS:
        raise ValueError(f"line thickness {thickness} is outside (0, {MAX_THICKNESS}]")
    px = _Pixels(*img.shape[:2])
    _thick_line(px, _point(pt1), _point(pt2), thickness, 3, shift)
    px.paint(img, _color(img, color))
    return img


def rectangle(img: np.ndarray, pt1, pt2, color, thickness: int = 1) -> np.ndarray:
    """``cv2.rectangle``: the closed polyline pt1, (x2, y1), pt2, (x1, y2),
    or that quad filled when ``thickness`` < 0."""
    _check(img)
    (x1, y1), (x2, y2) = _point(pt1), _point(pt2)
    quad = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    px = _Pixels(*img.shape[:2])
    if thickness >= 0:  # cv2's closed PolyLine: each side caps its far end
        for p0, p1 in zip(quad[-1:] + quad[:-1], quad):
            _thick_line(px, p0, p1, thickness, 2, 0)
    else:
        _fill_convex_poly(px, quad, 0)
    px.paint(img, _color(img, color))
    return img


def circle(img: np.ndarray, center, radius: int, color, thickness: int = 1) -> np.ndarray:
    """``cv2.circle``: ``Circle`` at thickness 1 or filled (< 0), else
    ``EllipseEx``."""
    _check(img)
    if not isinstance(radius, (int, np.integer)) or radius < 0:
        raise ValueError(f"radius {radius!r}: cv2 takes an integer >= 0")
    if thickness > MAX_THICKNESS:
        raise ValueError(f"thickness {thickness} is above {MAX_THICKNESS}")
    px = _Pixels(*img.shape[:2])
    if thickness > 1:
        _thick_circle(px, *_point(center), int(radius), thickness)
    else:
        _circle(px, *_point(center), int(radius), thickness < 0)
    px.paint(img, _color(img, color))
    return img


@functools.lru_cache(maxsize=None)
def _glyphs(style) -> Dict[str, Tuple[int, int, int, np.ndarray]]:
    """{char: (advance, dx, dy, coverage as int64)} of a (scale, thickness)."""
    return {c: (adv, dx, dy, np.frombuffer(base64.b64decode(data), np.uint8).reshape(h, w).astype(np.int64))
            for c, (adv, dx, dy, h, w, data) in GLYPHS[style].items()}


def put_text(img: np.ndarray, text: str, org, font_face: int, font_scale: float, color,
             thickness: int = 1) -> np.ndarray:
    """``cv2.putText`` as OpenCV 5 draws it: each character's coverage
    bitmap blended into the image in turn, ``(dst * (255 - a) + color * a
    + 127) // 255`` per channel, the pen advancing a whole number of pixels
    per character.  The bitmaps are cv2's (``text_glyphs.py``), for the
    printable ASCII characters at the (scale, thickness) pairs there; any
    other raises."""
    _check(img)
    style = (float(font_scale), int(thickness))
    if font_face != FONT_HERSHEY_SIMPLEX or style not in GLYPHS:
        raise NotImplementedError(f"text in font {font_face} at (scale, thickness) {style} is not ported ({_FONTS})")
    bad = sorted({c for c in text if not " " <= c <= "~"})
    if bad:
        raise NotImplementedError(f"characters {bad!r} outside printable ASCII are not ported ({_FONTS})")
    glyphs = _glyphs(style)
    col = _color(img, color).astype(np.int64)
    h, w = img.shape[:2]
    x, y = _point(org)
    for c in text:
        adv, dx, dy, a = glyphs[c]
        x0, y0 = x + dx, y + dy
        x1, y1 = max(x0, 0), max(y0, 0)
        x2, y2 = min(x0 + a.shape[1], w), min(y0 + a.shape[0], h)
        if x1 < x2 and y1 < y2:
            a_ = a[y1 - y0:y2 - y0, x1 - x0:x2 - x0]
            if img.ndim == 3:
                a_ = a_[..., None]
            dst = img[y1:y2, x1:x2]
            dst[...] = (dst * (255 - a_) + col * a_ + 127) // 255
        x += adv
    return img
